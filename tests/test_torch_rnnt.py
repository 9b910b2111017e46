"""The port's streaming RNN-T loss (``ops/rnnt_loss.py``) held against the
JAX package on the CPU in fp32: K2's plain version (the planes) and the
whole loss with all four gradients, K3's plain version included, against
``rnnt_loss_streaming`` both through its XLA chunk scan and through the
Pallas kernels ``streaming_joint_planes_fwd``/``_bwd`` in interpret mode.

Ragged input and label lengths (one utterance with no labels), T not a
multiple of the chunk or of the Pallas frame tile, tanh and swish.
Tolerances: 1e-5 on the planes and the loss, 1e-4 on the gradients
(fp32 sums in another order).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wenet_celoss_tpu.ops import rnnt_loss as jax_rl
from wenet_celoss_tpu.ops import rnnt_pallas as jax_rp
from wenet_celoss_tpu_torch.ops import rnnt_loss

B, T, U, H, V, CHUNK = 3, 19, 4, 16, 24, 4


def _inputs(seed=41):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((B, T, H)).astype(np.float32)
    pred = rng.standard_normal((B, U + 1, H)).astype(np.float32)
    w = (0.5 * rng.standard_normal((H, V))).astype(np.float32)   # JAX [H, V]
    bias = (0.1 * rng.standard_normal(V)).astype(np.float32)
    labels = rng.integers(1, V, (B, U)).astype(np.int32)
    labels[2, :] = 0                  # padding maps to 0 (no labels)
    ilens = np.array([19, 11, 5], np.int32)
    llens = np.array([4, 2, 0], np.int32)
    return enc, pred, w, bias, labels, ilens, llens


def _t(x):
    return torch.as_tensor(x) if x.dtype == np.float32 else \
        torch.as_tensor(x, dtype=torch.long)


@pytest.mark.parametrize("activation", ["tanh", "swish"])
def test_planes_match_jax(activation):
    """K2's plain version against the JAX chunk scan and the Pallas
    forward kernel (interpret mode, 8-frame tiles): blank, label (rows
    below U) and normaliser planes."""
    enc, pred, w, bias, labels, _, _ = _inputs()
    want = jax_rl._streaming_chunked_planes(
        jnp.asarray(enc), jnp.asarray(pred), jnp.asarray(w),
        jnp.asarray(bias), jnp.asarray(labels), 0, activation, CHUNK)[:3]
    onehot = jax_rl._label_onehot(jnp.asarray(labels), U + 1, V,
                                  jnp.float32)
    pallas = jax_rp.streaming_joint_planes_fwd(
        jnp.asarray(enc), jnp.asarray(pred), jnp.asarray(w),
        jnp.asarray(bias), onehot, activation, 0, tt=8, interpret=True)
    got = rnnt_loss.joint_planes_ref(_t(enc), _t(pred), _t(w.T.copy()),
                                     _t(bias), _t(labels), 0, activation,
                                     CHUNK)
    for g, a, p in zip(got, want, pallas):
        g = g.numpy()[..., :U]     # row U has no label (overwritten)
        np.testing.assert_allclose(g, np.asarray(a)[:, :T, :U], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g, np.asarray(p)[..., :U], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("activation", ["tanh", "swish"])
def test_loss_and_gradients_match_jax(activation, route, monkeypatch):
    """A weighted sum of per-utterance losses and its gradients w.r.t.
    enc_j, pred_j, W and b: the port's autograd Function (K2's and K3's
    plain versions, the torch lattice) against the JAX custom VJP."""
    enc, pred, w, bias, labels, ilens, llens = _inputs()
    weights = np.array([0.7, 1.3, 0.2], np.float32)
    if route == "pallas":
        monkeypatch.setattr(jax_rl, "_use_streaming_pallas", lambda: True)
        for name in ("streaming_joint_planes_fwd",
                     "streaming_joint_planes_bwd"):
            monkeypatch.setattr(jax_rp, name, partial(
                getattr(jax_rp, name), tt=8, interpret=True))

    def jax_loss(e, p, w_, b_):
        return jnp.sum(weights * jax_rl.rnnt_loss_streaming(
            e, p, w_, b_, jnp.asarray(labels), jnp.asarray(ilens),
            jnp.asarray(llens), 0, activation, CHUNK))

    args = tuple(jnp.asarray(a) for a in (enc, pred, w, bias))
    want, want_g = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3))(*args)
    ins = [_t(a).requires_grad_(True) for a in (enc, pred, w.T.copy(), bias)]
    losses = rnnt_loss.rnnt_loss_streaming(
        *ins, _t(labels), _t(ilens), _t(llens), 0, activation, CHUNK)
    got = (losses * torch.as_tensor(weights)).sum()
    grads = torch.autograd.grad(got, ins)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert np.isfinite(losses.detach().numpy()).all()
    for name, g, r in zip(("denc", "dpred", "dw", "db"), grads, want_g):
        g = g.numpy().T if name == "dw" else g.numpy()
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_lattice_matches_jax():
    """alpha, beta and the occupancies against the JAX scans."""
    rng = np.random.default_rng(3)
    lp = np.log(rng.dirichlet(np.ones(3), (B, T, U + 1))).astype(np.float32)
    blank, emit = lp[..., 0], lp[..., 1]
    ilens, llens = np.array([19, 11, 5]), np.array([4, 2, 0])
    j_alpha = jax_rl._alpha_scan(jnp.asarray(blank), jnp.asarray(emit))
    j_occ = jax_rl._occupancies(jnp.asarray(blank), jnp.asarray(emit),
                                j_alpha, jnp.asarray(ilens),
                                jnp.asarray(llens))
    j_beta = jax_rl._beta_scan(jnp.asarray(blank), jnp.asarray(emit),
                               jnp.asarray(ilens), jnp.asarray(llens))
    tb, te = torch.as_tensor(blank), torch.as_tensor(emit)
    il, ll = torch.as_tensor(ilens), torch.as_tensor(llens)
    alpha = rnnt_loss.alpha_scan(tb, te)
    beta = rnnt_loss.beta_scan(tb, te, il, ll)
    occ = rnnt_loss.occupancies(tb, te, alpha, beta, il, ll)
    for got, want in ((alpha, j_alpha), (beta, j_beta), *zip(occ, j_occ)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_kernel_wrappers_refuse_what_they_do_not_take():
    """The kernel wrappers check before building anything: a dtype, a
    width or a shape the kernels do not take raises."""
    enc, pred, w, bias, labels, _, _ = _inputs()
    args = [_t(enc), _t(pred), _t(w.T.copy()), _t(bias), _t(labels)]
    bad_dtype = [a.double() if a.is_floating_point() else a for a in args]
    with pytest.raises(TypeError):
        rnnt_loss.joint_planes_kernel(*bad_dtype, 0, "tanh")
    with pytest.raises(ValueError, match="multiple of 16"):
        rnnt_loss.joint_planes_kernel(args[0][..., :8], args[1][..., :8],
                                      args[2][:, :8], *args[3:], 0, "tanh")
    with pytest.raises(ValueError, match="labels"):
        rnnt_loss.joint_planes_kernel(*args[:4], args[4][:, :2], 0, "tanh")
    with pytest.raises(ValueError, match="activation"):
        rnnt_loss.rnnt_loss_streaming(*args, _t(np.ones(3, np.int32)),
                                      _t(np.ones(3, np.int32)),
                                      activation="gelu")


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize("h", [64, 256])
def test_check_refuses_bf16_joint_widths_the_kernels_do_not_take(h, kernel):
    """The bf16 joint kernels (K2, K3) take H in {128, 512}: _check, run
    before every launch, raises on any other bf16 width before it reaches
    "the kernels take CUDA tensors"; the taken widths, and the refused
    width in fp32, get as far as that."""
    b, t, u1, v = 2, 3, 4, 10

    def call(width, dt):
        g = torch.Generator().manual_seed(0)
        enc = torch.randn(b, t, width, generator=g).to(dt)
        pred = torch.randn(b, u1, width, generator=g).to(dt)
        w = torch.randn(v, width, generator=g).to(dt)
        bias, labels = torch.zeros(v), torch.ones(b, u1 - 1, dtype=torch.int32)
        if kernel == "fwd":
            return rnnt_loss.joint_planes_kernel(enc, pred, w, bias, labels,
                                                 0, "tanh")
        planes = torch.zeros(b, t, u1)
        return rnnt_loss.joint_planes_bwd_kernel(enc, pred, w, bias, labels,
                                                 planes, planes, planes, 0,
                                                 "tanh")
    with pytest.raises(ValueError, match="bf16 kernels"):
        call(h, torch.bfloat16)
    for width, dt in ((h, torch.float32),
                      *((x, torch.bfloat16) for x in rnnt_loss.BF16_WIDTHS)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call(width, dt)
