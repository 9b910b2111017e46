"""The RNN-T lattice (K9) and the losses on materialised logits of the
port (``ops/rnnt_loss.py``) held against the JAX package on the CPU in
fp32:

- K9's plain version (``alpha_scan`` + ``beta_scan``) against
  ``alpha_beta_pallas`` in interpret mode on a ragged batch, to 1e-5, with
  every invalid cell exactly LOG_ZERO in both, and against the JAX
  package's ``_alpha_scan`` / ``_beta_scan`` at U1 = 300, wider than a
  warp of the kernel;
- ``gather_planes`` against ``_gather_planes``, to 1e-5;
- the ``scan``, ``fused`` and ``pallas`` losses and their logits gradients
  against ``rnnt_loss``, ``rnnt_loss_fused`` and ``rnnt_loss_pallas``
  (interpret mode): losses to 1e-5 relative, gradients to 1e-4;
- the streaming loss, now through the K9 wrapper, against the composition
  it replaced (K2's plain version, ``alpha_scan``, then ``beta_scan``, the
  occupancies and K3's plain version): the same values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wenet_celoss_tpu.ops import rnnt_loss as jax_rl
from wenet_celoss_tpu.ops import rnnt_pallas as jax_rp
from wenet_celoss_tpu_torch.ops import rnnt_loss
from wenet_celoss_tpu_torch.utils.common import LOG_ZERO

B, T, U, V = 4, 11, 5, 9
ILENS = np.array([11, 7, 3, 9], np.int32)
LLENS = np.array([5, 2, 0, 4], np.int32)


def _logits(seed=7):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, U + 1, V)).astype(np.float32)
    labels = rng.integers(1, V, (B, U)).astype(np.int32)
    for i, n in enumerate(LLENS):
        labels[i, n:] = 0               # padding maps to 0
    return logits, labels


def _lens():
    return torch.as_tensor(ILENS).long(), torch.as_tensor(LLENS).long()


def test_lattice_plain_version_matches_pallas_kernel():
    """alpha and beta (tolerance 1e-5 abs + rel) on planes from a ragged
    batch; cells off each lattice (alpha: t >= T; beta: t >= T_b or
    u > U_b) are exactly LOG_ZERO in both; beta[0, 0] equals the terminal
    alpha + blank (1e-5 relative)."""
    logits, labels = _logits()
    j_blank, j_emit = jax_rl._gather_planes(jnp.asarray(logits),
                                            jnp.asarray(labels), 0)
    want = jax_rp.alpha_beta_pallas(j_blank, j_emit, jnp.asarray(ILENS),
                                    jnp.asarray(LLENS), interpret=True)
    blank, emit = (torch.as_tensor(np.array(a)) for a in (j_blank, j_emit))
    got = rnnt_loss.alpha_beta(blank, emit, *_lens())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg="tolerance 1e-5")
    alpha, beta = got
    t_idx = np.arange(T)[None, :, None]
    u_idx = np.arange(U + 1)[None, None, :]
    off = (t_idx >= ILENS[:, None, None]) | (u_idx > LLENS[:, None, None])
    assert (beta.numpy()[off] == LOG_ZERO).all()
    assert (np.asarray(want[1])[off] == LOG_ZERO).all()
    term = np.array([float(alpha[i, n - 1, m] + blank[i, n - 1, m])
                     for i, (n, m) in enumerate(zip(ILENS, LLENS))])
    np.testing.assert_allclose(beta[:, 0, 0].numpy(), term, rtol=1e-5,
                               err_msg="tolerance 1e-5 relative")


def test_lattice_plain_version_matches_jax_scan_above_256_columns():
    """At U1 = 300 (the kernel's multi-warp rows) the plain lattice
    against the JAX package's non-Pallas lattice (``_alpha_scan``,
    ``_beta_scan``) on ragged planes: valid cells to 1e-4 + 1e-5*|ref|
    (fp32 logaddexp chains of up to T' + U1 steps), every invalid cell
    exactly LOG_ZERO in both."""
    rng = np.random.default_rng(300)
    b, t, u1 = 3, 20, 300
    lp = rng.standard_normal((b, t, u1, 3)).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    blank = np.ascontiguousarray(lp[..., 0])
    emit = np.ascontiguousarray(lp[..., 1])
    emit[..., -1] = LOG_ZERO
    il = np.array([20, 13, 1], np.int32)
    ll = np.array([u1 - 1, 170, 0], np.int32)
    want = (jax_rl._alpha_scan(jnp.asarray(blank), jnp.asarray(emit)),
            jax_rl._beta_scan(jnp.asarray(blank), jnp.asarray(emit),
                              jnp.asarray(il), jnp.asarray(ll)))
    got = rnnt_loss.alpha_beta(torch.as_tensor(blank), torch.as_tensor(emit),
                               torch.as_tensor(il).long(),
                               torch.as_tensor(ll).long())
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        off = w == LOG_ZERO
        assert (g[off] == LOG_ZERO).all()
        assert (np.abs(g - w)[~off] <= 1e-4 + 1e-5 * np.abs(w[~off])).all()


def test_gather_planes_matches_jax():
    """Blank and label log-prob planes (tolerance 1e-5); row U of the
    emit plane is LOG_ZERO."""
    logits, labels = _logits(3)
    want = jax_rl._gather_planes(jnp.asarray(logits), jnp.asarray(labels), 0)
    got = rnnt_loss.gather_planes(torch.as_tensor(logits),
                                  torch.as_tensor(labels).long(), 0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg="tolerance 1e-5")
    assert (got[1][..., U] == LOG_ZERO).all()


def _jax_loss(impl):
    if impl == "scan":
        return jax_rl.rnnt_loss
    if impl == "fused":
        return jax_rl.rnnt_loss_fused
    return lambda *a: jax_rp.rnnt_loss_pallas(*a, 0, True)


@pytest.mark.parametrize("impl", ["scan", "fused", "pallas"])
def test_losses_and_logits_gradient_match_jax(impl):
    """A weighted sum of the per-utterance losses (1e-5 relative) and its
    gradient with respect to the logits (1e-4 abs + rel) against the JAX
    package's loss of the same ``rnnt_impl``."""
    import jax
    logits, labels = _logits(11)
    weights = np.array([0.7, 1.3, 0.2, 1.0], np.float32)
    fn = _jax_loss(impl)

    def jax_sum(x):
        return jnp.sum(weights * fn(x, jnp.asarray(labels),
                                    jnp.asarray(ILENS), jnp.asarray(LLENS)))
    want, want_g = jax.value_and_grad(jax_sum)(jnp.asarray(logits))
    x = torch.as_tensor(logits).requires_grad_(True)
    losses = rnnt_loss.LOSSES[impl](x, torch.as_tensor(labels).long(),
                                    *_lens(), 0)
    got = (losses * torch.as_tensor(weights)).sum()
    (grad,) = torch.autograd.grad(got, [x])
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                               err_msg="tolerance 1e-5 relative")
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-4, err_msg="tolerance 1e-4")


def test_streaming_loss_through_k9_keeps_its_values():
    """rnnt_loss_streaming (K2's plain version, then ``alpha_beta``) against
    the composition it replaced: alpha_scan for the loss, beta_scan and the
    occupancies for the gradient planes, K3's plain version. The CPU runs
    the same plain versions, so loss and gradients agree to 1e-6."""
    rng = np.random.default_rng(5)
    h, v = 16, 12
    enc = torch.as_tensor(rng.standard_normal((B, T, h)), dtype=torch.float32)
    pred = torch.as_tensor(rng.standard_normal((B, U + 1, h)),
                           dtype=torch.float32)
    w = torch.as_tensor(0.5 * rng.standard_normal((v, h)), dtype=torch.float32)
    bias = torch.as_tensor(0.1 * rng.standard_normal(v), dtype=torch.float32)
    labels = torch.as_tensor(_logits()[1]).long() % v
    il, ll = _lens()
    ins = [t.clone().requires_grad_(True) for t in (enc, pred, w, bias)]
    loss = rnnt_loss.rnnt_loss_streaming(*ins, labels, il, ll).sum()
    grads = torch.autograd.grad(loss, ins)

    blank_lp, emit_lp, lse = rnnt_loss.joint_planes_ref(enc, pred, w, bias,
                                                        labels, 0, "tanh")
    emit_lp[..., U] = LOG_ZERO
    alpha = rnnt_loss.alpha_scan(blank_lp, emit_lp)
    beta = rnnt_loss.beta_scan(blank_lp, emit_lp, il, ll)
    want = -(rnnt_loss._final(alpha, il, ll)
             + rnnt_loss._final(blank_lp, il, ll)).sum()
    occ_b, occ_e = rnnt_loss.occupancies(blank_lp, emit_lp, alpha, beta, il,
                                         ll)
    want_g = rnnt_loss.joint_planes_bwd_ref(enc, pred, w, bias, labels,
                                            occ_b, occ_e, lse, 0, "tanh")
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6,
                               err_msg="tolerance 1e-6 relative")
    for g, r in zip(grads, want_g):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg="tolerance 1e-6")


def test_lattice_kernel_wrapper_refuses_shapes_it_does_not_take():
    """The K9 wrapper checks the planes' shapes before anything else:
    planes that are not [B, T, U1] alike, and rows above the kernel's
    8192 columns, raise on any device."""
    lens = torch.ones(2, dtype=torch.long)
    with pytest.raises(ValueError, match="alike"):
        rnnt_loss.alpha_beta_kernel(torch.zeros(2, 5, 3),
                                    torch.zeros(2, 5, 4), lens, lens)
    with pytest.raises(ValueError, match="alike"):
        rnnt_loss.alpha_beta_kernel(torch.zeros(10, 3), torch.zeros(10, 3),
                                    lens, lens)
    wide = torch.zeros(2, 1, rnnt_loss.MAX_U1 + 1)
    with pytest.raises(ValueError, match="8192"):
        rnnt_loss.alpha_beta_kernel(wide, wide, lens, lens)


def test_lattice_kernel_wrapper_refuses_what_it_does_not_take():
    """The K9 wrapper checks before building anything: a non-fp32 plane
    or planes off the card raise."""
    blank = torch.zeros(2, 5, 3)
    lens = torch.ones(2, dtype=torch.long)
    with pytest.raises(ValueError, match="fp32"):
        rnnt_loss.alpha_beta_kernel(blank.double(), blank.double(), lens,
                                    lens)
    with pytest.raises(ValueError, match="CUDA"):
        rnnt_loss.alpha_beta_kernel(blank, blank, lens, lens)
