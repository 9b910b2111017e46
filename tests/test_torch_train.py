"""The port's training path held against the JAX package on the tiny
``conformer_ctc_aed`` in fp32 on the CPU, every dropout rate 0: the
losses (label smoothing, CTC), the bidirectional decoder, the whole
``ASRModel`` loss and every parameter gradient, and three optimizer steps
of ``parallel/train.py`` including the non-finite skip. The weight bridge
maps both supported models whole.

Both packages get the same weights: seeded numpy values in the JAX
package's parameter tree, carried to the port by the weight bridge.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import _fill
from wenet_celoss_tpu.configs import conformer_ctc_aed as jax_ctc_aed
from wenet_celoss_tpu.configs import conformer_rnnt_bias as jax_rnnt_bias
from wenet_celoss_tpu.models.factory import init_example
from wenet_celoss_tpu.models.factory import init_model as jax_init_model
from wenet_celoss_tpu.models.label_smoothing import \
    label_smoothing_loss as jax_lsm
from wenet_celoss_tpu.ops.ctc_loss import ctc_loss as jax_ctc
from wenet_celoss_tpu.parallel import train as jax_train
from wenet_celoss_tpu.utils.scheduler import warmup_lr as jax_warmup_lr
from wenet_celoss_tpu_torch.models.factory import init_model
from wenet_celoss_tpu_torch.models.label_smoothing import \
    label_smoothing_loss
from wenet_celoss_tpu_torch.ops.ctc_loss import ctc_loss
from wenet_celoss_tpu_torch.models.transducer import Transducer
from wenet_celoss_tpu_torch.parallel import train
from wenet_celoss_tpu_torch.utils.convert import params_from_jax
from wenet_celoss_tpu_torch.utils.scheduler import warmup_lr

TOL = dict(rtol=1e-4, atol=1e-4)
VOCAB = 30


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tiny_cfg():
    """Tiny conformer_ctc_aed with the right-to-left decoder on
    (r_num_blocks 1, reverse_weight 0.3), every dropout rate 0 and a
    2-step warmup so that three steps move the weights."""
    cfg = jax_ctc_aed(tiny=True, vocab_size=VOCAB)
    cfg["decoder_conf"].update(r_num_blocks=1, dropout_rate=0.0,
                               positional_dropout_rate=0.0)
    cfg["model_conf"]["reverse_weight"] = 0.3
    cfg["scheduler_conf"]["warmup_steps"] = 2
    for k in ("dropout_rate", "positional_dropout_rate",
              "attention_dropout_rate"):
        cfg["encoder_conf"][k] = 0.0
    return cfg


@functools.lru_cache(maxsize=None)
def _pair():
    """(cfg, jax model, jax variables, torch model) sharing weights."""
    cfg = _tiny_cfg()
    jm = jax_init_model(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *init_example(cfg, frames=16, labels=2))
    variables = _fill(shapes, seed=0)
    tm = init_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(variables), strict=True)
    return cfg, jm, variables, tm


def _batch(nan: bool = False, feat_seed: int = 0):
    """4 utterances, ragged frames and labels, one with no labels; labels
    padded with -1. ``feat_seed`` > 0 draws the features anew."""
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((4, 64, 80)).astype(np.float32)
    if feat_seed:
        feats = np.random.default_rng(feat_seed).standard_normal(
            feats.shape).astype(np.float32)
    if nan:
        feats[0, 0, 0] = np.nan
    lens = np.array([64, 50, 33, 20], np.int32)
    llen = np.array([6, 3, 0, 5], np.int32)
    labels = rng.integers(1, VOCAB - 2, (4, 6)).astype(np.int32)
    labels[np.arange(6)[None, :] >= llen[:, None]] = -1
    return {"feats": feats, "feat_lengths": lens, "labels": labels,
            "label_lengths": llen}


def _torch_batch(batch):
    return {k: torch.as_tensor(v) if v.dtype == np.float32
            else torch.as_tensor(v, dtype=torch.long)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_grad_fn():
    cfg, jm, _, _ = _pair()
    tx, _ = jax_train.make_optimizer(cfg)
    return jax_train.make_grad_fn(jm), jax_train.make_apply_fn(tx), tx


def _logits_and_targets(seed=3):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((4, 7, VOCAB))).astype(np.float32)
    lens = np.array([7, 4, 0, 2])
    targets = rng.integers(0, VOCAB, (4, 7)).astype(np.int32)
    targets[np.arange(7)[None, :] >= lens[:, None]] = -1
    return logits, targets, lens


@pytest.mark.parametrize("normalize_length", [False, True])
def test_label_smoothing_matches_jax(normalize_length):
    """Value (entropy term included) and gradient w.r.t. the logits, with
    ragged targets and a row of padding only."""
    logits, targets, _ = _logits_and_targets()
    want, want_g = jax.value_and_grad(
        lambda lg: jax_lsm(lg, jnp.asarray(targets), 0.1,
                           normalize_length))(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = label_smoothing_loss(lg, torch.as_tensor(targets, dtype=torch.long),
                               0.1, normalize_length)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_g), **TOL)


def test_ctc_loss_matches_jax():
    """Per-utterance values and the gradient of their sum w.r.t. the
    logits: ragged frames and labels, a zero-length label row, a
    repeated label, and one row with more labels than frames (an
    impossible alignment: a large finite loss, as in the JAX package)."""
    logits, targets, llen = _logits_and_targets()
    logits = np.concatenate([logits, logits[:1]], 0)
    targets = np.concatenate([targets, targets[:1]], 0)
    targets[1, 1] = targets[1, 0]                 # repeat needs a blank
    llen = np.concatenate([llen, [7]])
    tlen = np.array([7, 6, 3, 5, 4])              # row 4: T'=4 < U=7

    def jax_fn(lg):
        return jax_ctc(jax.nn.log_softmax(lg, -1), jnp.asarray(targets),
                       jnp.asarray(tlen), jnp.asarray(llen))
    want = jax_fn(jnp.asarray(logits))
    want_g = jax.grad(lambda lg: jnp.sum(jax_fn(lg)))(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = ctc_loss(torch.log_softmax(lg, -1),
                   torch.as_tensor(targets, dtype=torch.long),
                   torch.as_tensor(tlen), torch.as_tensor(llen))
    got.sum().backward()
    assert 1e5 < float(got[4]) < np.inf
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5)
    # The impossible row's loss sits near -LOG_ZERO = 1e6, where fp32's
    # spacing is 0.0625: its gradient is finite but rounding noise in
    # both packages, so only the possible rows' gradients are compared.
    assert np.isfinite(lg.grad.numpy()[4]).all()
    np.testing.assert_allclose(lg.grad.numpy()[:4], np.asarray(want_g)[:4],
                               **TOL)


def test_bidirectional_decoder_logits_match_jax():
    """Left and right teacher-forced logits (reverse_weight 0.3) over a
    ragged memory and ragged label lengths."""
    _, jm, v, tm = _pair()
    rng = np.random.default_rng(4)
    memory = rng.standard_normal((3, 9, 64)).astype(np.float32)
    mem_mask = np.arange(9)[None, :] < np.array([9, 5, 2])[:, None]
    ys_in = rng.integers(0, VOCAB, (3, 5)).astype(np.int32)
    r_ys_in = rng.integers(0, VOCAB, (3, 5)).astype(np.int32)
    ys_lens = np.array([5, 3, 1], np.int32)
    want = jm.apply(v, memory, mem_mask, ys_in, ys_lens, r_ys_in, 0.3,
                    method=lambda m, *a: m.decoder(*a))
    with torch.no_grad():
        got = tm.decoder(torch.from_numpy(memory),
                         torch.from_numpy(mem_mask),
                         torch.as_tensor(ys_in, dtype=torch.long),
                         torch.as_tensor(ys_lens, dtype=torch.long),
                         torch.as_tensor(r_ys_in, dtype=torch.long), 0.3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_asr_model_loss_and_every_gradient_match_jax():
    """The loss dict and the gradient of every parameter against
    ``jax.value_and_grad`` (the JAX package's make_grad_fn), each tensor
    to 1e-4 of its largest element. The key projections' biases have a
    zero gradient in exact arithmetic (softmax ignores a shift shared by
    all keys), so their scale is floored at 1e-3."""
    _, _, v, tm = _pair()
    grad_fn = _jax_grad_fn()[0]
    batch = _batch()
    state = jax_train.TrainState(step=jnp.zeros((), jnp.int32),
                                 params=v["params"], opt_state=None)
    j_grads, j_metrics, _ = grad_fn(state, batch, jax.random.PRNGKey(0))
    want = params_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, j_grads)})
    t_state = train.TrainState(0, tm, None)
    grads, metrics = train.make_grad_fn(tm)(t_state, _torch_batch(batch),
                                            torch.Generator())
    for k in ("loss", "loss_att", "loss_ctc", "acc"):
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   rtol=1e-5, err_msg=k)
    names = [n for n, _ in tm.named_parameters()]
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-3)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * scale, (name, err, scale)


NOISE_GRAD = 1e-6   # |gradient| at which Adam's update stops saturating


def noise_level(grads):
    """{name: bool mask} of the nonzero gradient elements below
    NOISE_GRAD, from a JAX gradient tree (mapped through the weight
    bridge). An exactly zero gradient (a tensor the loss does not reach)
    leaves the element in place in both packages."""
    return {k: (v.numpy() != 0) & (np.abs(v.numpy()) < NOISE_GRAD)
            for k, v in params_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, grads)}).items()}


def assert_params_match(model, j_params, step, noise=None, lr=0.0,
                        rtol=1e-4):
    """Every parameter of ``model`` against the JAX tree ``j_params``
    (mapped through the weight bridge), each element to ``rtol`` of the
    tensor's largest element.

    Adam moves an element by about lr * g / (|g| + 1e-8): by lr whatever
    the size of g, until |g| nears 1e-8. Where the step's gradient element
    was at the two packages' rounding noise (``noise``: below NOISE_GRAD,
    a small share of the elements), its update depends on that rounding,
    so those elements are held to twice the step's learning rate ``lr``
    instead. The key projections' biases have a zero gradient
    in exact arithmetic (softmax ignores a shift shared by all keys), so
    Adam moves them by rounding noise alone: they are held to 1e-2 of
    their largest element."""
    want = params_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, j_params)})
    bad = []
    for name, p in model.named_parameters():
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        limit = np.full(w.shape, (1e-2 if name.endswith("linear_k.bias")
                                  else rtol) * scale)
        if noise is not None:
            limit = np.where(noise[name], max(2 * lr, rtol * scale),
                             limit)
        err = np.abs(p.detach().numpy() - w)
        if not (err <= limit).all():
            bad.append((name, float((err - limit).max())))
    assert not bad, (step, bad)
    if noise is not None:
        share = np.mean(np.concatenate([m.ravel() for m in noise.values()]))
        assert share < 0.05, share


def _named(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _assert_updates_match(before, after, j_before, j_after, step):
    """Each tensor's update of one step against the JAX package's.

    Adam's first steps move an element by about lr * g / |g| whatever the
    size of g, so an element whose gradient is near the two packages'
    rounding difference can move by different amounts: the updates are
    held to 5e-2 relative Frobenius per tensor, which a wrong bias
    correction, learning rate or clip on any tensor exceeds by far (a
    tensor the JAX package leaves unmoved must not move at all). The
    key projections' biases have a zero gradient in exact arithmetic
    (softmax ignores a shift shared by all keys), so Adam moves them by
    rounding noise alone; their values are held to 1e-2 of their largest
    element instead."""
    bad = []
    for name, p in after.items():
        w = j_after[name]
        if name.endswith("linear_k.bias"):
            err = float(np.abs(p - w).max()) / float(np.abs(w).max())
            limit = 1e-2
        else:
            want = w - j_before[name]
            err = float(np.linalg.norm(p - before[name] - want))
            if np.any(want):
                err /= float(np.linalg.norm(want))
            limit = 5e-2
        if not err <= limit:
            bad.append((name, err))
    assert not bad, (step, bad)


def _bridge(tree):
    return params_from_jax({"params": jax.tree_util.tree_map(np.asarray,
                                                             tree)})


def sync_from_jax(model, state, j_state):
    """Load the JAX package's parameters and Adam moments into the port's
    model and optimizer state."""
    params, adam = _bridge(j_state.params), j_state.opt_state[1]
    mu, nu = _bridge(adam.mu), _bridge(adam.nu)
    with torch.no_grad():
        for i, (name, p) in enumerate(model.named_parameters()):
            p.copy_(params[name])
            state.opt_state.mu[i].copy_(mu[name])
            state.opt_state.nu[i].copy_(nu[name])


def check_train_steps(cfg, model, j_params, grad_fn, apply_fn, tx, batch,
                      t_batch, loss_keys, steps=3):
    """``steps`` steps of the port's make_train_step against the JAX
    package's grad and apply functions. Each step starts both packages
    from the same parameters and Adam moments (the port takes over the
    JAX state after each comparison, so rounding noise does not compound
    through the random model's ReLU kinks from step to step). Per step:
    the losses and the pre-clip gnorm to 1e-4 relative, every parameter
    after the step (see assert_params_match) and every tensor's update
    (see _assert_updates_match)."""
    params = jax.tree_util.tree_map(jnp.asarray, j_params)
    j_state = jax_train.TrainState(step=jnp.zeros((), jnp.int32),
                                   params=params, opt_state=tx.init(params))
    t_tx, schedule = train.make_optimizer(cfg)
    t_state = train.create_train_state(model, t_tx)
    step = train.make_train_step(model, t_tx)
    gen = torch.Generator().manual_seed(0)
    gnorms = []
    for i in range(steps):
        sync_from_jax(model, t_state, j_state)
        before = _named(model)
        j_grads, j_metrics, _ = grad_fn(j_state, batch,
                                        jax.random.PRNGKey(i))
        j_before = {k: t.numpy() for k, t in _bridge(j_state.params).items()}
        j_state, j_gnorm = apply_fn(j_state, j_grads)
        t_state, metrics, gnorm = step(t_state, t_batch, gen)
        assert t_state.opt_state.count == i + 1
        after = _named(model)
        j_after = {k: t.numpy() for k, t in _bridge(j_state.params).items()}
        _assert_updates_match(before, after, j_before, j_after, i)
        assert_params_match(model, j_state.params, i, noise_level(j_grads),
                            schedule(i))
        for k in loss_keys:
            np.testing.assert_allclose(float(metrics[k]),
                                       float(j_metrics[k]), rtol=1e-4,
                                       err_msg=k)
        np.testing.assert_allclose(float(gnorm), float(j_gnorm), rtol=1e-4)
        gnorms.append(float(j_gnorm))
    assert t_state.step == steps
    return gnorms


def test_train_steps_match_jax():
    """Three steps of make_train_step against the JAX package's grad and
    apply functions (see check_train_steps); the first gnorm is above the
    clip of 5, so the clip acts.

    The features are drawn anew (seed 2): with the other tests' batch, one
    pre-activation of the subsampling's ReLU convolutions lies within
    rounding of 0 at the second step, the two packages take different
    sides of relu' there, and the subsampling's gradients differ by 5e-3
    of their largest element (every other gradient by under 1e-5)."""
    cfg, _, v, tm = _pair()
    grad_fn, apply_fn, tx = _jax_grad_fn()
    batch = _batch(feat_seed=2)
    gnorms = check_train_steps(cfg, copy.deepcopy(tm), v["params"], grad_fn,
                               apply_fn, tx, batch, _torch_batch(batch),
                               ("loss", "loss_att", "loss_ctc"))
    assert gnorms[0] > cfg["grad_clip"]


def test_nonfinite_step_keeps_params_and_optimizer_state():
    """A NaN in the batch gives a non-finite gnorm: parameters and the
    whole optimizer state (moments and count, hence the schedule) stay,
    only ``step`` advances — as the JAX package's apply does."""
    cfg, _, v, tm = _pair()
    _, apply_fn, tx = _jax_grad_fn()
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    j_state = jax_train.TrainState(step=jnp.zeros((), jnp.int32),
                                   params=params, opt_state=tx.init(params))
    nan_grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, jnp.nan),
                                       params)
    j_new, j_gnorm = apply_fn(j_state, nan_grads)
    assert not np.isfinite(float(j_gnorm)) and int(j_new.step) == 1
    assert int(j_new.opt_state[1].count) == 0

    model = copy.deepcopy(tm)
    t_tx, _ = train.make_optimizer(cfg)
    state = train.create_train_state(model, t_tx)
    step = train.make_train_step(model, t_tx)
    before = [p.detach().clone() for p in model.parameters()]
    state, _, gnorm = step(state, _torch_batch(_batch(nan=True)),
                           torch.Generator())
    assert not np.isfinite(float(gnorm)) and state.step == 1
    assert state.opt_state.count == 0
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))
    assert all(not m.any() for m in state.opt_state.mu + state.opt_state.nu)
    state, _, gnorm = step(state, _torch_batch(_batch()), torch.Generator())
    assert np.isfinite(float(gnorm)) and state.opt_state.count == 1
    assert not all(torch.equal(a, b)
                   for a, b in zip(before, model.parameters()))


def test_eval_fn_and_accumulate():
    """make_eval_fn gives the loss dict of the gradient pass (no dropout,
    no gradients, no update); accumulate sums gradient lists."""
    _, _, _, tm = _pair()
    state = train.TrainState(0, tm, None)
    batch = _torch_batch(_batch())
    grads, metrics = train.make_grad_fn(tm, accum_grad=2)(state, batch,
                                                          None)
    before = [p.detach().clone() for p in tm.parameters()]
    out = train.make_eval_fn(tm)(state, batch)
    assert not out["loss"].requires_grad
    for k in metrics:
        assert float(out[k]) == float(metrics[k])
    assert all(torch.equal(a, b) for a, b in zip(before, tm.parameters()))
    assert train.accumulate(None, grads) is grads
    total = train.accumulate(grads, grads)
    assert all(torch.equal(t, 2 * g) for t, g in zip(total, grads))


@pytest.mark.parametrize("warmup", [2, 25000])
def test_warmup_lr_matches_jax(warmup):
    steps = [0, 1, 2, 3, 10, 24999, 25000, 100000]
    got = [warmup_lr(0.002, warmup)(s) for s in steps]
    want = [float(jax_warmup_lr(0.002, warmup)(s)) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == got[1]


@pytest.mark.parametrize("name", ["conformer_ctc_aed", "conformer_rnnt_bias"])
def test_bridge_maps_both_models_whole(name):
    """Every leaf of the tiny JAX tree maps (nothing is skipped) onto the
    port's model of the same config, which takes it strictly."""
    cfg = {"conformer_ctc_aed": jax_ctc_aed,
           "conformer_rnnt_bias": jax_rnnt_bias}[name](tiny=True,
                                                       vocab_size=VOCAB)
    jm = jax_init_model(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *init_example(cfg, frames=16, labels=2))
    variables = _fill(shapes, seed=5)
    sd = params_from_jax(variables)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    tm = init_model(cfg, device="cpu")
    assert isinstance(tm, Transducer) == (name == "conformer_rnnt_bias")
    assert set(sd) == set(tm.state_dict())
    assert n_leaves >= len(sd)     # LSTM gates merge several leaves
    tm.load_state_dict(sd, strict=True)
