"""The batch_norm conv module in training mode, held against the JAX
package (flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``) in fp32 on
the CPU:

- the conv module alone, with a ragged pad mask: the training output,
  the input gradient and the running statistics it leaves, and the
  evaluation output on them;
- the tiny flagship with ``cnn_module_norm: batch_norm`` and ragged
  lengths (padded frames enter the statistics, as in flax), over three
  ``make_train_step`` steps against the JAX package's train step: losses
  and gnorm to 1e-5, every gradient and parameter to 1e-4 of its largest
  element, every running mean and variance to 1e-5 after each step; once
  without a dropout generator and once under ``LNMM_PALLAS=conv`` (K7's
  plain version; the JAX model's conv switch forced on, ``ln_matmul`` in
  interpret mode); then ``make_eval_fn`` on the running statistics.

Every dropout rate is 0. The JAX step is taken as its grad function, its
apply function and the batch_stats it returns, which is what its
``make_train_step`` composes, so that its gradients can be compared.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_transducer as ttrans
from test_torch_models import _fill
from test_torch_train import assert_params_match, noise_level, sync_from_jax
from wenet_celoss_tpu.models.convolution import \
    ConvolutionModule as JaxConv
from wenet_celoss_tpu.models.factory import init_example
from wenet_celoss_tpu.models.factory import init_model as jax_init_model
from wenet_celoss_tpu.ops import ffn_pallas
from wenet_celoss_tpu.parallel import train as jax_train
from wenet_celoss_tpu_torch.models.convolution import (BatchNorm,
                                                       ConvolutionModule)
from wenet_celoss_tpu_torch.models.factory import init_model
from wenet_celoss_tpu_torch.ops import ln_matmul as lnmm
from wenet_celoss_tpu_torch.parallel import train
from wenet_celoss_tpu_torch.utils.convert import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
C, K = 16, 5


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _module_pair():
    """A JAX conv module (batch_norm) with seeded variables, and the
    port's module carrying them through the weight bridge."""
    jm = JaxConv(channels=C, kernel_size=K, norm="batch_norm")
    x = jnp.zeros((2, 9, C))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    v = _fill(shapes, seed=4)
    prefix = "encoder.layers.0.conv_module."
    wrapped = {col: {"encoder": {"layer_0": {"conv_module": sub}}}
               for col, sub in v.items()}
    sd = {k[len(prefix):]: t for k, t in params_from_jax(wrapped).items()}
    tm = ConvolutionModule(C, K, "batch_norm")
    tm.load_state_dict(sd, strict=True)
    return jm, v, tm


def test_conv_module_training_matches_flax():
    """Output, input gradient and updated running statistics of one
    training call (pad frames in the statistics), then the evaluation
    output on the updated statistics."""
    jm, v, tm = _module_pair()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 11, C)).astype(np.float32)
    mask = np.arange(11)[None, :] < np.array([11, 6, 3])[:, None]
    ct = rng.standard_normal((3, 11, C)).astype(np.float32)

    def f(xx):
        return jm.apply(v, xx, jnp.asarray(mask), train=True,
                        mutable=["batch_stats"])

    j_y, j_upd = f(jnp.asarray(x))
    j_dx = jax.grad(lambda xx: jnp.sum(f(xx)[0] * ct))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tm.train()
    y = tm(xt, torch.as_tensor(mask))
    (dx,) = torch.autograd.grad((y * torch.as_tensor(ct)).sum(), xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(j_y), **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(j_dx), **TOL)
    stats = j_upd["batch_stats"]["norm_layer"]
    bn = tm.norm_layer
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), **TOL)
    j_eval = jm.apply(dict(v, batch_stats=j_upd["batch_stats"]),
                      jnp.asarray(x), jnp.asarray(mask), train=False)
    tm.eval()
    with torch.no_grad():
        t_eval = tm(torch.as_tensor(x), torch.as_tensor(mask))
    np.testing.assert_allclose(t_eval.numpy(), np.asarray(j_eval), **TOL)


def test_batch_norm_update_is_biased_and_flax_weighted():
    """The running update takes the biased variance with weight 0.1 (not
    BatchNorm1d's unbiased one), and an eval call leaves the statistics."""
    bn = BatchNorm(3)
    x = torch.tensor([[1.0, 0.0, 2.0], [3.0, 0.0, 2.0]])
    bn.train()
    bn(x)
    np.testing.assert_allclose(bn.running_mean.numpy(), [0.2, 0.0, 0.2],
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), [1.0, 0.9, 0.9],
                               rtol=1e-6)
    before = bn.running_var.clone()
    bn.eval()
    bn(x)
    assert torch.equal(bn.running_var, before)


@functools.lru_cache(maxsize=None)
def _pair():
    """(cfg, jax model, jax variables, torch model): the tiny flagship of
    tests/test_torch_transducer.py with the batch_norm conv module."""
    cfg = ttrans._cfg()
    cfg["encoder_conf"]["cnn_module_norm"] = "batch_norm"
    jm = jax_init_model(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *init_example(cfg, frames=16, labels=2))
    variables = _fill(shapes, seed=0)
    tm = init_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(variables), strict=True)
    return cfg, jm, variables, tm


def _load_stats(model, bs):
    with torch.no_grad():
        for name, t in params_from_jax({"batch_stats": bs}).items():
            model.get_buffer(name).copy_(t)


def _assert_stats_match(model, bs, step):
    want = params_from_jax({"batch_stats": jax.tree_util.tree_map(
        np.asarray, bs)})
    assert len(want) == 4   # mean and var of 2 layers
    for name, w in want.items():
        np.testing.assert_allclose(model.get_buffer(name).numpy(),
                                   w.numpy(), err_msg=f"{name} step {step}",
                                   **TOL)


def _assert_grads_match(model, grads, j_grads):
    """Each gradient to 1e-4 of its largest element (floored at 1e-3, as
    for the key projections' biases, whose gradient is 0 in exact
    arithmetic). The depthwise convolution's bias feeds the batch norm,
    whose mean subtraction cancels it: its gradient is 0 in exact
    arithmetic too, and both packages' must be rounding noise (< 1e-5)."""
    want = params_from_jax({"params": jax.tree_util.tree_map(np.asarray,
                                                             j_grads)})
    bad = []
    for (name, _), g in zip(model.named_parameters(), grads):
        w = want[name].numpy()
        if name.endswith("depthwise_conv.bias"):
            err = max(float(np.abs(g.numpy()).max()),
                      float(np.abs(w).max()))
            if not err < 1e-5:
                bad.append((name, err))
            continue
        scale = max(float(np.abs(w).max()), 1e-3)
        err = float(np.abs(g.numpy() - w).max())
        if not err <= 1e-4 * scale:
            bad.append((name, err, scale))
    assert not bad


@pytest.fixture
def _conv_lnmm(monkeypatch):
    """LNMM_PALLAS=conv in the port (pointwise conv1 through K7's plain
    version, counted); in the JAX package the conv module's switch
    forced on and ``ln_matmul`` in interpret mode."""
    monkeypatch.setenv("LNMM_PALLAS", "conv")
    calls = []
    fn = lnmm.ln_matmul
    monkeypatch.setattr(lnmm, "ln_matmul",
                        lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    monkeypatch.setattr(JaxConv, "_use_ln_mm", lambda self: True)
    monkeypatch.setattr(ffn_pallas, "ln_matmul",
                        functools.partial(ffn_pallas.ln_matmul,
                                          interpret=True))
    return calls


@pytest.mark.parametrize("route", ["gen_none", "lnmm_conv"])
def test_train_steps_match_jax(route, request):
    """Three steps, then make_eval_fn on the running statistics."""
    calls = request.getfixturevalue("_conv_lnmm") \
        if route == "lnmm_conv" else None
    cfg, jm, v, tm0 = _pair()
    model = copy.deepcopy(tm0)
    tx, _ = jax_train.make_optimizer(cfg)
    grad_fn = jax_train.make_grad_fn(jm)      # traced under the route
    apply_fn = jax_train.make_apply_fn(tx)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    j_state = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]))
    t_tx, schedule = train.make_optimizer(cfg)
    t_state = train.create_train_state(model, t_tx)
    step = train.make_train_step(model, t_tx)
    gen = None if route == "gen_none" else torch.Generator().manual_seed(0)
    batch = ttrans._batch()
    t_batch = ttrans._torch_batch(batch)
    for i in range(3):
        sync_from_jax(model, t_state, j_state)
        _load_stats(model, j_state.batch_stats)
        j_grads, j_metrics, j_bs = grad_fn(j_state, batch,
                                           jax.random.PRNGKey(i))
        j_state, j_gnorm = apply_fn(j_state, j_grads)
        j_state = j_state.replace(batch_stats=j_bs)
        # The gradients through make_grad_fn on a copy (its forward
        # advances the copy's statistics, not the model's).
        probe = copy.deepcopy(model)
        grads, _ = train.make_grad_fn(probe)(
            train.TrainState(0, probe, None), t_batch, gen)
        _assert_grads_match(probe, grads, j_grads)
        t_state, metrics, gnorm = step(t_state, t_batch, gen)
        for k in ttrans.LOSSES:
            np.testing.assert_allclose(float(metrics[k]),
                                       float(j_metrics[k]), rtol=1e-5,
                                       err_msg=f"{k} step {i}")
        np.testing.assert_allclose(float(gnorm), float(j_gnorm), rtol=1e-5)
        # The depthwise biases' gradients are rounding noise (see
        # _assert_grads_match): Adam moves them by up to the learning
        # rate in either direction, so they are held as noise elements.
        noise = noise_level(j_grads)
        for name in noise:
            if name.endswith("depthwise_conv.bias"):
                noise[name][:] = True
        assert_params_match(model, j_state.params, i, noise, schedule(i))
        _assert_stats_match(model, j_state.batch_stats, i)
    assert t_state.step == 3 and model.training
    if calls is not None:
        assert len(calls) == 2 * 3 * 2   # 2 conv sites, 3 steps, 2 calls

    want = jax_train.make_eval_fn(jm)(j_state, batch)
    got = train.make_eval_fn(model)(t_state, t_batch)
    assert not model.training
    for k in ttrans.LOSSES:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_eval_fn_needs_running_statistics():
    """make_eval_fn normalises with the running statistics (a forward in
    training mode gives another loss) and leaves them as they were."""
    _, _, _, tm0 = _pair()
    model = copy.deepcopy(tm0)
    t_batch = ttrans._torch_batch(ttrans._batch())
    state = train.TrainState(0, model, None)
    before = {n: b.clone() for n, b in model.named_buffers()}
    got = train.make_eval_fn(model)(state, t_batch)
    for n, b in model.named_buffers():
        assert torch.equal(b, before[n]), n
    model.train()
    with torch.no_grad():
        trained = train._forward(model, t_batch, None)
    assert abs(float(trained["loss"]) - float(got["loss"])) > 1e-3
