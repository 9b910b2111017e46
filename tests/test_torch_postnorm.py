"""K6's path, the post-norm transformer CTC/AED, held against the JAX
package on the CPU in fp32, every dropout rate 0.

The model is ``conformer_ctc_aed`` with a ``transformer`` encoder, the
absolute positional encoding and post-norm layers in the encoder and the
decoder (the layout of Vaswani et al. 2017 and Speech-Transformer), built
as a config dict here: no config file of the repo names it. Every FFN of it
runs without a pre-norm, i.e. through ``ffn_fused`` (K6; its plain version
here). Both packages get the same weights: seeded numpy values in the JAX
parameter tree, carried to the port by the weight bridge.

- the loss terms (1e-5 relative) and every parameter gradient (1e-4 of
  its largest element), and three optimizer steps (the helper of
  ``tests/test_torch_train.py``), with 2 + 1 + 1 K6 calls a forward;
- the bridge maps the post-norm tree whole: no ``after_norm`` in the
  encoder or the decoders, and layer parameters ``self_attn``, ``norm1``,
  ``feed_forward``, ``norm2`` only;
- the encoder outputs of the pre-norm transformer and of the conformer
  with ``normalize_before: false`` (pre-norm layers, no after_norm);
- the float64 reference: the port's CPU path in float64 for one step, and
  the fp32 gradients of the port and of the JAX package held to it.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import _fill
from test_torch_kernels import (float64_step, grad_errors,
                                zero_in_exact_arithmetic)
from test_torch_train import check_train_steps
from wenet_celoss_tpu.configs import conformer_ctc_aed
from wenet_celoss_tpu.models.factory import init_example
from wenet_celoss_tpu.models.factory import init_model as jax_init_model
from wenet_celoss_tpu.parallel import train as jax_train
from wenet_celoss_tpu_torch.models import encoder_layer
from wenet_celoss_tpu_torch.models.factory import init_model
from wenet_celoss_tpu_torch.ops import ffn
from wenet_celoss_tpu_torch.parallel import train
from wenet_celoss_tpu_torch.utils.convert import params_from_jax

VOCAB = 30
LOSSES = ("loss", "loss_att", "loss_ctc")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def postnorm_cfg(tiny: bool = True, vocab: int = VOCAB):
    """conformer_ctc_aed with a post-norm transformer encoder and post-norm
    decoders (r_num_blocks 1, reverse_weight 0.3 in the tiny one), every
    dropout rate 0 and a 2-step warmup when tiny."""
    cfg = conformer_ctc_aed(tiny=tiny, vocab_size=vocab)
    cfg["encoder"] = "transformer"
    cfg["encoder_conf"].update(normalize_before=False,
                               pos_enc_layer_type="abs_pos")
    cfg["decoder_conf"]["normalize_before"] = False
    if tiny:
        cfg["decoder_conf"].update(r_num_blocks=1)
        cfg["model_conf"]["reverse_weight"] = 0.3
        cfg["scheduler_conf"]["warmup_steps"] = 2
        for conf in (cfg["encoder_conf"], cfg["decoder_conf"]):
            for k in list(conf) + ["positional_dropout_rate"]:
                if k.endswith("dropout_rate"):
                    conf[k] = 0.0
    return cfg


def _tree(cfg, seed=0):
    jm = jax_init_model(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *init_example(cfg, frames=16, labels=2))
    return jm, _fill(shapes, seed=seed)


@functools.lru_cache(maxsize=None)
def _pair():
    """(cfg, jax model, jax variables, torch model) sharing weights."""
    cfg = postnorm_cfg()
    jm, variables = _tree(cfg)
    tm = init_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(variables), strict=True)
    return cfg, jm, variables, tm


def _batch():
    """4 utterances, ragged frames and labels, one with no labels."""
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((4, 64, 80)).astype(np.float32)
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


class _Counting:
    """ffn_fused, counting its calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return ffn.ffn_fused(*args, **kwargs)


@pytest.fixture
def _k6_calls(monkeypatch):
    counting = _Counting()
    monkeypatch.setattr(encoder_layer, "ffn_fused", counting)
    return counting


def test_losses_and_every_gradient_match_jax(_k6_calls):
    """The loss dict (1e-5 relative) and the gradient of every parameter
    (1e-4 of its largest element; the key projections' biases, whose exact
    gradient is 0, floored at 1e-3) against the JAX package's
    make_grad_fn; every FFN through K6 (2 encoder, 1 + 1 decoder) and none
    through K1."""
    cfg, jm, v, tm = _pair()
    batch = _batch()
    state = jax_train.TrainState(step=jnp.zeros((), jnp.int32),
                                 params=v["params"], opt_state=None)
    j_grads, j_metrics, _ = jax_train.make_grad_fn(jm)(
        state, batch, jax.random.PRNGKey(0))
    want = params_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, j_grads)})
    k1 = ffn.ln_ffn_residual
    before = k1.launches
    grads, metrics = train.make_grad_fn(tm)(
        train.TrainState(0, tm, None), _torch_batch(batch),
        torch.Generator())
    assert _k6_calls.calls == 4
    for k in LOSSES:
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   rtol=1e-5, err_msg=k)
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
    assert k1.launches == before   # the CPU path counts no launch


def test_train_steps_match_jax():
    """Three steps of make_train_step, every parameter after each step."""
    cfg, jm, v, tm = _pair()
    tx, _ = jax_train.make_optimizer(cfg)
    batch = _batch()
    check_train_steps(cfg, copy.deepcopy(tm), v["params"],
                      jax_train.make_grad_fn(jm),
                      jax_train.make_apply_fn(tx), tx, batch,
                      _torch_batch(batch), LOSSES)


def test_bridge_maps_the_postnorm_tree_whole():
    """No after_norm in the post-norm tree; each encoder layer holds
    self_attn, norm1, feed_forward and norm2; the port builds exactly the
    mapped parameters and takes them strictly."""
    cfg = postnorm_cfg()
    _, variables = _tree(cfg, seed=5)
    params = variables["params"]
    assert set(params["encoder"]) == {"embed", "layer_0", "layer_1"}
    assert set(params["encoder"]["layer_0"]) == {
        "self_attn", "norm1", "feed_forward", "norm2"}
    assert "after_norm" not in params["decoder"]["left"]
    sd = params_from_jax(variables)
    tm = init_model(cfg, device="cpu")
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("encoder,normalize_before", [
    ("transformer", True), ("conformer", False)])
def test_encoder_matches_jax(encoder, normalize_before):
    """The pre-norm transformer encoder (after_norm present), and the
    conformer with normalize_before false, which the JAX package builds
    with pre-norm layers and no after_norm: outputs to 1e-4 over the valid
    frames, the tree mapped whole."""
    cfg = conformer_ctc_aed(tiny=True, vocab_size=VOCAB)
    cfg["encoder"] = encoder
    cfg["encoder_conf"]["normalize_before"] = normalize_before
    if encoder == "transformer":
        cfg["encoder_conf"]["pos_enc_layer_type"] = "abs_pos"
    jm, v = _tree(cfg, seed=3)
    assert ("after_norm" in v["params"]["encoder"]) == normalize_before
    tm = init_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(v), strict=True)
    batch = _batch()
    want, want_mask = jm.apply(v, batch["feats"], batch["feat_lengths"],
                               method=lambda m, x, n: m.encoder(x, n))
    with torch.no_grad():
        got, mask = tm.encoder(torch.from_numpy(batch["feats"]),
                               torch.as_tensor(batch["feat_lengths"]))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    valid = mask.numpy()
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               rtol=1e-4, atol=1e-4)


def test_float64_reference_holds_fp32_gradients():
    """The tiny post-norm model, dropout 0: the port's CPU path in float64
    is the reference. The fp32 loss terms of the port (CPU) lie within
    1e-6 relative of it, and every fp32 gradient of the port and of the
    JAX package within 1e-5 (relative Frobenius); the key projections'
    biases, whose exact gradient is 0 (softmax ignores a shift shared by
    all keys), within 1e-6 of the global norm (their fp32 rounding noise
    is 1e-9 of it here). The card's fp32 gradients are held to the same
    reference by tests/test_torch_kernels.py and chip_smoke.py."""
    cfg, jm, v, tm = _pair()
    batch = _batch()
    state = jax_train.TrainState(step=jnp.zeros((), jnp.int32),
                                 params=v["params"], opt_state=None)
    j_grads, _, _ = jax_train.make_grad_fn(jm)(state, batch,
                                               jax.random.PRNGKey(0))
    j_named = params_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, j_grads)})
    names = [n for n, _ in tm.named_parameters()]
    tb = _torch_batch(batch)
    grads, metrics = train.make_grad_fn(tm)(train.TrainState(0, tm, None),
                                            tb, torch.Generator())
    ref, ref_metrics = float64_step(tm, tb)
    assert all(r.dtype == torch.float64 for r in ref)
    for k in LOSSES:
        assert abs(float(metrics[k]) - float(ref_metrics[k])) <= \
            1e-6 * abs(float(ref_metrics[k])), k
    for who, got in (("port", grads), ("jax", [j_named[n] for n in names])):
        errs = grad_errors(got, ref, names)
        for n, e in errs.items():
            assert e <= (1.0 if zero_in_exact_arithmetic(n) else 1e-5), \
                (who, n, e)
