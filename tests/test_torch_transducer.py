"""The flagship's training step, the third slice of the port, held against
the JAX package on the tiny ``conformer_rnnt_bias`` in fp32 on the CPU,
every dropout rate 0, ``rnnt_impl: "streaming"``.

The batch carries hotwords and per-token hotword labels built from its
labels by ``data/context.py`` (the port's copy of the JAX package's
``context_generate``/``hw_label_generate``), padded with two empty phrase
slots so that ``context_n_valid`` is below N and the cross-attentions'
key mask acts. Both packages get the same weights: seeded numpy values in
the JAX parameter tree, carried to the port by the weight bridge.

- every loss term (rnnt, ctc, attention, hotword CE and their mix) to
  1e-5 relative and every parameter gradient to 1e-4 of its largest
  element (``loss_mode: both``);
- three optimizer steps, every parameter compared after each step (the
  helper of ``tests/test_torch_train.py``);
- the loss terms in ``loss_mode`` ``pred`` and ``sep``, and with every
  phrase slot valid (no ``context_n_valid``);
- the weight bridge maps each mode's tree whole;
- the loss terms with ``rnnt_impl`` scan, fused and pallas (the
  materialised joint; the JAX pallas loss in interpret mode) and pruned
  to 1e-5 relative, and every gradient through the pallas loss (K9's
  plain version and the closed-form gradient) as above.
"""

import copy
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import _fill
from test_torch_train import check_train_steps
from wenet_celoss_tpu.configs import conformer_rnnt_bias
from wenet_celoss_tpu.data import processor
from wenet_celoss_tpu.models.factory import init_example
from wenet_celoss_tpu.models.factory import init_model as jax_init_model
from wenet_celoss_tpu.ops import rnnt_pallas as jax_rp
from wenet_celoss_tpu.parallel import train as jax_train
from wenet_celoss_tpu_torch.data.context import context_batch, \
    context_generate, hw_label_generate
from wenet_celoss_tpu_torch.models.factory import init_model
from wenet_celoss_tpu_torch.parallel import train
from wenet_celoss_tpu_torch.utils.convert import params_from_jax

VOCAB = 30
LOSSES = ("loss", "loss_rnnt", "loss_ctc", "loss_att", "hw_loss")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg(loss_mode="both", rnnt_impl="streaming"):
    """The tiny flagship with every dropout rate 0 and a 2-step warmup."""
    cfg = conformer_rnnt_bias(tiny=True, vocab_size=VOCAB)
    for conf in (cfg["encoder_conf"], cfg["decoder_conf"]):
        for k in conf:
            if k.endswith("dropout_rate"):
                conf[k] = 0.0
    cfg["predictor_conf"].update(embed_dropout=0.0, dropout=0.0)
    cfg["model_conf"]["loss_mode"] = loss_mode
    cfg["model_conf"]["rnnt_impl"] = rnnt_impl
    cfg["scheduler_conf"]["warmup_steps"] = 2
    return cfg


@functools.lru_cache(maxsize=None)
def _pair(loss_mode="both", rnnt_impl="streaming"):
    """(cfg, jax model, jax variables, torch model) sharing weights (the
    loss implementation changes no weight)."""
    cfg = _cfg(loss_mode, rnnt_impl)
    jm = jax_init_model(cfg)
    if rnnt_impl in ("streaming", "pruned"):   # pruned adds two layers
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                *init_example(cfg, frames=16, labels=2))
        variables = _fill(shapes, seed=0)
    else:
        variables = _pair(loss_mode)[2]
    tm = init_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(variables), strict=True)
    return cfg, jm, variables, tm


@pytest.fixture
def _jax_pallas_interpret(monkeypatch):
    """The JAX package's pallas loss in interpret mode (the CPU has no
    TPU lowering); the transducer imports it at trace time."""
    orig = jax_rp.rnnt_loss_pallas
    monkeypatch.setattr(jax_rp, "rnnt_loss_pallas",
                        lambda lg, lab, il, ll, blank=0: orig(lg, lab, il, ll,
                                                              blank, True))


def _batch(n_valid=True):
    """4 utterances with ragged frames and labels (one with none), the
    hotwords sampled from the labels (words start at ids 1-9) and the hw
    labels; two empty phrase slots past ``context_n_valid``."""
    rng = np.random.default_rng(11)
    feats = rng.standard_normal((4, 64, 80)).astype(np.float32)
    lens = np.array([64, 50, 33, 20], np.int32)
    llen = np.array([6, 3, 0, 5], np.int32)
    seqs = [[int(t) for t in rng.integers(1, VOCAB - 2, n)] for n in llen]
    labels = np.full((4, 6), -1, np.int32)
    for i, y in enumerate(seqs):
        labels[i, :len(y)] = y
    ctx = context_generate(seqs, bpe_start_ids=set(range(1, 10)),
                           rng=random.Random(0))
    extra = context_batch(seqs, ctx, max_phrases=len(ctx) + 2)
    batch = {"feats": feats, "feat_lengths": lens, "labels": labels,
             "label_lengths": llen,
             **{k: np.asarray(v, np.int32) for k, v in extra.items()}}
    if not n_valid:
        batch.pop("context_n_valid")
    return batch


def _torch_batch(batch):
    return {k: torch.as_tensor(v) if v.dtype == np.float32
            else torch.as_tensor(v, dtype=torch.long)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_fns(loss_mode="both", rnnt_impl="streaming"):
    cfg, jm, _, _ = _pair(loss_mode, rnnt_impl)
    tx, _ = jax_train.make_optimizer(cfg)
    return (jax_train.make_grad_fn(jm), jax_train.make_apply_fn(tx), tx,
            jax_train.make_eval_fn(jm))


def test_batch_has_hotwords_labels_and_masked_slots():
    batch = _batch()
    n = batch["context_list"].shape[0]
    assert int(batch["context_n_valid"]) == n - 2 >= 2
    assert (batch["context_lengths"][-2:] == 0).all()
    assert (batch["hw_labels"] == 1).any()


def test_context_generation_matches_jax():
    """The port's hotword sampling (mode 1) and binary hw labels against
    the JAX package's processor: the same lists and labels from the same
    label sequences and random stream."""
    rng = np.random.default_rng(5)
    seqs = [[int(t) for t in rng.integers(1, 20, n)]
            for n in (0, 3, 9, 17, 25, 40)]
    starts = set(range(1, 8))
    for seed in range(4):
        want = processor.context_generate(seqs, context_mode=1,
                                          bpe_start_ids=starts,
                                          rng=random.Random(seed))
        got = context_generate(seqs, starts, rng=random.Random(seed))
        assert got == want and len(got) > 3
        assert hw_label_generate(seqs, got) == \
            processor.hw_label_generate(seqs, want)[0]


def test_losses_and_every_gradient_match_jax():
    """The loss dict and every parameter gradient against the JAX
    package's make_grad_fn, each gradient to 1e-4 of its largest element.
    The key projections' biases have a zero gradient in exact arithmetic
    (softmax ignores a shift shared by all keys), so their scale is
    floored at 1e-3."""
    check_grads_match_jax("streaming")


def test_pallas_loss_every_gradient_matches_jax(_jax_pallas_interpret):
    """As above with ``rnnt_impl: "pallas"``: K9's plain version and the
    closed-form logits gradient through the materialised joint."""
    check_grads_match_jax("pallas")


def check_grads_match_jax(rnnt_impl, grad_fn=None):
    """``grad_fn``: a JAX grad function to use in place of the cached one
    (a fresh trace, for a test that patches the JAX package's routes)."""
    _, _, v, tm = _pair("both", rnnt_impl)
    grad_fn = grad_fn or _jax_fns("both", rnnt_impl)[0]
    batch = _batch()
    state = jax_train.TrainState(step=jnp.zeros((), jnp.int32),
                                 params=v["params"], opt_state=None)
    j_grads, j_metrics, _ = grad_fn(state, batch, jax.random.PRNGKey(0))
    want = params_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, j_grads)})
    grads, metrics = train.make_grad_fn(tm)(
        train.TrainState(0, tm, None), _torch_batch(batch),
        torch.Generator())
    for k in LOSSES:
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(metrics["hw_loss"]) > 0
    names = [n for n, _ in tm.named_parameters()]
    assert set(names) == set(want)
    bad = []
    for name, g in zip(names, grads):
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-3)
        err = float(np.abs(g.numpy() - w).max())
        if not err <= 1e-4 * scale:
            bad.append((name, err, scale))
    assert not bad


def test_train_steps_match_jax():
    """Three steps of make_train_step, every parameter after each step."""
    cfg, _, v, tm = _pair()
    grad_fn, apply_fn, tx, _ = _jax_fns()
    batch = _batch()
    check_train_steps(cfg, copy.deepcopy(tm), v["params"], grad_fn,
                      apply_fn, tx, batch, _torch_batch(batch), LOSSES)


@pytest.mark.parametrize("loss_mode,n_valid,rnnt_impl", [
    pytest.param("pred", True, "streaming", id="pred-True"),
    pytest.param("sep", True, "streaming", id="sep-True"),
    pytest.param("both", False, "streaming", id="both-False"),
    ("both", True, "scan"), ("both", True, "fused"),
    ("both", True, "pallas")])
def test_loss_terms_match_jax(loss_mode, n_valid, rnnt_impl,
                              _jax_pallas_interpret):
    """The loss dict through make_eval_fn in the ``pred`` mode (the
    unbiased predictor stream attends over the phrases through
    hw_pred_proj) and the ``sep`` mode (the dec head, targets with a
    prepended 0), with every phrase slot valid, and with the losses of
    ``rnnt_impl`` scan, fused and pallas on the materialised joint."""
    _, _, v, tm = _pair(loss_mode, rnnt_impl)
    eval_fn = _jax_fns(loss_mode, rnnt_impl)[3]
    batch = _batch(n_valid)
    j_state = jax_train.TrainState(step=jnp.zeros((), jnp.int32),
                                   params=v["params"], opt_state=None)
    want = eval_fn(j_state, batch)
    got = train.make_eval_fn(tm)(train.TrainState(0, tm, None),
                                 _torch_batch(batch))
    for k in LOSSES:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("loss_mode", ["both", "pred", "sep"])
def test_bridge_maps_every_loss_mode_tree(loss_mode):
    """Each mode's JAX tree (its hotword heads differ) maps leaf for leaf
    onto the port's model of the same config."""
    _, _, v, tm = _pair(loss_mode)
    sd = params_from_jax(v)
    assert set(sd) == set(tm.state_dict())
    heads = {k.split(".")[1] for k in sd if k.startswith("context_bias.hw")}
    assert ("hw_pred_proj" in heads) == (loss_mode == "pred")
    assert ("hw_bias" in heads) == (loss_mode != "sep")


def test_pruned_rnnt_impl_builds_and_matches_jax():
    """``rnnt_impl: "pruned"`` builds (with the simple loss's two
    projections, which the weight bridge maps) and its loss terms match
    the JAX package's through make_eval_fn (the simple loss's lattice
    through K9's plain version, the pruned lattice in plain torch)."""
    _, _, v, tm = _pair("both", "pruned")
    assert tm.rnnt_impl == "pruned" and tm.prune_range == 5
    assert {"simple_am_proj.weight", "simple_lm_proj.weight"} <= \
        set(params_from_jax(v))
    eval_fn = _jax_fns("both", "pruned")[3]
    batch = _batch()
    j_state = jax_train.TrainState(step=jnp.zeros((), jnp.int32),
                                   params=v["params"], opt_state=None)
    want = eval_fn(j_state, batch)
    got = train.make_eval_fn(tm)(train.TrainState(0, tm, None),
                                 _torch_batch(batch))
    for k in LOSSES:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_fused_rnnt_loss_alias_selects_fused():
    """``fused_rnnt_loss: true`` selects "fused" whatever ``rnnt_impl``
    says, as in the JAX package's transducer."""
    cfg = _cfg(rnnt_impl="streaming")
    cfg["model_conf"]["fused_rnnt_loss"] = True
    assert init_model(cfg, device="cpu").rnnt_impl == "fused"
    assert init_model(_cfg(), device="cpu").rnnt_impl == "streaming"
