"""K7 (``ops/ln_matmul.py``) and K6 (``ops/ffn.py::ffn_fused``) of the
port held against the JAX package on the CPU in fp32:

- each plain version, forward and backward through the port's autograd
  Function, against the Pallas kernel and its VJP in interpret mode, with
  a row block that does not divide N (the tolerances of the JAX package's
  own tests of these kernels: 2e-5 on the output, 2e-4 on the gradients);
- K6's forward and backward draw the plain mask function's hidden mask,
  and its keep rate holds;
- the tiny flagship under ``LNMM_PALLAS=1`` (K7 at the attention and conv
  sites, through its plain version) against the JAX model with its
  ``_use_ln_mm`` switches forced on and ``ln_matmul`` in interpret mode:
  every loss term and parameter gradient of a training step, and the
  plain and gated greedy decodes (hyps and gates);
- the routing switch's values and the wrappers' checks.

The CUDA kernels themselves are tested in test_torch_kernels.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_models as tmod
import test_torch_transducer as ttrans
from wenet_celoss_tpu.decode.api import Decoder as JaxDecoder
from wenet_celoss_tpu.models.attention import \
    MultiHeadedAttention as JaxMHA
from wenet_celoss_tpu.models.convolution import \
    ConvolutionModule as JaxConv
from wenet_celoss_tpu.ops import ffn_pallas
from wenet_celoss_tpu.parallel import train as jax_train
from wenet_celoss_tpu_torch.decode.api import Decoder
from wenet_celoss_tpu_torch.ops import dropout, ffn, ln_matmul as lnmm

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
N, D, K, F = 37, 32, 64, 64


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _lnmm_args(seed=3):
    """x, g, bl, w [D, K], b (the JAX layout), a 0/1 row mask [N] and an
    upstream gradient [N, K]."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, D)).astype(np.float32),
            (1.0 + 0.2 * rng.standard_normal(D)).astype(np.float32),
            (0.1 * rng.standard_normal(D)).astype(np.float32),
            (0.1 * rng.standard_normal((D, K))).astype(np.float32),
            (0.1 * rng.standard_normal(K)).astype(np.float32),
            rng.integers(0, 2, N).astype(np.float32),
            rng.standard_normal((N, K)).astype(np.float32))


@pytest.mark.parametrize("masked", [True, False])
def test_ln_matmul_plain_version_matches_pallas_interpret(masked):
    """y and the gradients of sum(y * gy) with respect to x, g, bl, w and
    b, against ln_matmul in interpret mode with 8-row blocks (N = 37)."""
    x, g, bl, w, b, mask, gy = _lnmm_args()
    jmask = jnp.asarray(mask[:, None]) if masked else None

    def jax_loss(*a):
        y = ffn_pallas.ln_matmul(*a, jmask, 1e-5, 8, True)
        return jnp.sum(y * gy), y
    (_, want), want_g = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *[jnp.asarray(a) for a in (x, g, bl, w, b)])
    ins = [torch.from_numpy(a).requires_grad_(True)
           for a in (x, g, bl, np.ascontiguousarray(w.T), b)]
    y = lnmm.ln_matmul(*ins, torch.from_numpy(mask) if masked else None)
    got = torch.autograd.grad(y, ins, torch.from_numpy(gy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    for i, (a, c) in enumerate(zip(got, want_g)):
        a = a.numpy().T if i == 3 else a.numpy()      # w: Linear layout
        np.testing.assert_allclose(a, np.asarray(c), **GRAD_TOL,
                                   err_msg=f"gradient {i}")
    if masked:
        off = mask == 0
        np.testing.assert_array_equal(y.detach().numpy()[off],
                                      np.broadcast_to(b, (off.sum(), K)))


def test_ln_matmul_gradcheck_float64():
    """The autograd Function on the CPU is differentiable through the row
    mask in float64 (gradcheck against finite differences)."""
    x, g, bl, w, b, mask, _ = _lnmm_args(4)
    ins = tuple(torch.from_numpy(a).double().requires_grad_(True)
                for a in (x[:9, :16], g[:16], bl[:16],
                          np.ascontiguousarray(w[:16].T), b))
    m = torch.from_numpy(mask[:9]).double()
    assert torch.autograd.gradcheck(
        lambda *a: lnmm.ln_matmul(*a, m, 1e-5), ins)


def _ffn_args(seed=5):
    """x, w1 [D, F], b1, w2 [F, D], b2 (the JAX layout) and gy [N, D]."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, D)).astype(np.float32),
            (0.2 * rng.standard_normal((D, F))).astype(np.float32),
            (0.1 * rng.standard_normal(F)).astype(np.float32),
            (0.2 * rng.standard_normal((F, D))).astype(np.float32),
            (0.1 * rng.standard_normal(D)).astype(np.float32),
            rng.standard_normal((N, D)).astype(np.float32))


@pytest.mark.parametrize("activation", ["relu", "swish"])
def test_ffn_fused_plain_version_matches_pallas_interpret(activation):
    """y and the gradients of sum(y * gy) with respect to x, w1, b1, w2
    and b2 at rate 0, against ffn_fused in interpret mode with 16-row
    blocks (N = 37)."""
    x, w1, b1, w2, b2, gy = _ffn_args()

    def jax_loss(*a):
        y = ffn_pallas.ffn_fused(*a, jnp.zeros((), jnp.int32), activation,
                                 0.0, 16, True)
        return jnp.sum(y * gy), y
    (_, want), want_g = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *[jnp.asarray(a) for a in (x, w1, b1, w2, b2)])
    ins = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
           for a in (x, w1.T, b1, w2.T, b2)]
    y = ffn.ffn_fused(*ins, activation)
    got = torch.autograd.grad(y, ins, torch.from_numpy(gy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    for i, (a, c) in enumerate(zip(got, want_g)):
        a = a.numpy().T if i in (1, 3) else a.numpy()
        np.testing.assert_allclose(a, np.asarray(c), **GRAD_TOL,
                                   err_msg=f"gradient {i}")


def test_ffn_fused_forward_and_backward_draw_the_same_mask():
    """With w1 = 0, b1 = 2 (relu) and w2 = [I | 0] the output is
    drop(2) + b2 on the first D hidden columns, so y != b2 exactly where
    the forward kept; with dy = 1, db1 and dw2 are the kept counts of each
    hidden column, so the backward's mask is read from them. Both equal
    the plain mask function's (stream STREAM_FFN_HIDDEN, index
    row * F + col), whose keep rate is within 5 sigma of 0.9."""
    n, d, f, rate, seed = 512, 32, 64, 0.1, 4321
    thresh, scale = dropout.threshold(rate)
    w1 = torch.zeros(f, d, requires_grad=True)
    b1 = torch.full((f,), 2.0, requires_grad=True)
    w2 = torch.zeros(d, f)
    w2[:, :d] = torch.eye(d)
    w2.requires_grad_(True)
    b2 = torch.zeros(d, requires_grad=True)
    x = torch.randn(n, d, generator=torch.Generator().manual_seed(0))
    y = ffn.ffn_fused(x, w1, b1, w2, b2, "relu", rate, seed)
    index = torch.arange(n)[:, None] * f + torch.arange(f)[None, :]
    keep = dropout.keep_mask(seed, dropout.STREAM_FFN_HIDDEN, index, thresh)
    assert torch.equal((y != 0).detach(), keep[:, :d])
    _, db1, dw2, _ = torch.autograd.grad(y, (w1, b1, w2, b2),
                                         torch.ones(n, d))
    # The counts times 1/keep, against fp32 sums of 512 such terms.
    kept = keep.sum(0).float() * scale
    torch.testing.assert_close(db1[:d], kept[:d], rtol=1e-5, atol=0)
    assert not db1[d:].any()
    torch.testing.assert_close(dw2, 2.0 * kept[None, :].expand(d, f),
                               rtol=1e-5, atol=0)
    sigma = (0.9 * 0.1 / keep.numel()) ** 0.5
    assert abs(keep.double().mean().item() - 0.9) < 5 * sigma


class _Counting:
    """ln_matmul, counting its calls."""

    def __init__(self):
        self.calls = 0
        self.fn = lnmm.ln_matmul

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.fixture
def _lnmm_route(monkeypatch):
    """LNMM_PALLAS=1 in the port, counted; in the JAX package the two
    ``_use_ln_mm`` switches forced on (they also ask for a TPU) and
    ``ln_matmul`` in interpret mode."""
    monkeypatch.setenv("LNMM_PALLAS", "1")
    counting = _Counting()
    monkeypatch.setattr(lnmm, "ln_matmul", counting)
    monkeypatch.setattr(JaxMHA, "_use_ln_mm", lambda self: True)
    monkeypatch.setattr(JaxConv, "_use_ln_mm", lambda self: True)
    monkeypatch.setattr(ffn_pallas, "ln_matmul",
                        functools.partial(ffn_pallas.ln_matmul,
                                          interpret=True))
    return counting


def test_flagship_step_through_ln_matmul_matches_jax(_lnmm_route):
    """Every loss term (1e-5 relative) and every gradient (1e-4 of its
    largest element) of the tiny flagship with K7 at every self-attention
    (2 encoder, 1 + 1 decoder) and conv site (2), against the JAX
    package's grad function traced anew under its ln_matmul route."""
    _, jm, _, _ = ttrans._pair()
    ttrans.check_grads_match_jax("streaming", jax_train.make_grad_fn(jm))
    assert _lnmm_route.calls == 6


@pytest.mark.parametrize("context", ["none", "on"])
def test_flagship_decode_through_ln_matmul_matches_jax(_lnmm_route,
                                                        context):
    """Identical hyps (and gates) to a JAX Decoder built under the same
    route: 4 K7 calls an encoder pass (2 QKV + 2 conv), 2 passes gated."""
    _, jm, v, tm = tmod._pair()
    feats, lens, ctx, ctx_lens = tmod._inputs()
    kw = {} if context == "none" else dict(
        context_list=ctx, context_lengths=ctx_lens,
        context_filter_state=context)
    jd, td = JaxDecoder(jm, v), Decoder(tm, device="cpu")
    want = jd.rnnt_greedy_search(feats, lens, n_steps=3, **kw)
    got = td.rnnt_greedy_search(feats, lens, n_steps=3, **kw)
    assert got == want and sum(map(len, got)) >= 4
    if context != "none":
        np.testing.assert_array_equal(td.last_gates[0].numpy(),
                                      np.asarray(jd.last_gates[0]))
    assert _lnmm_route.calls == (4 if context == "none" else 8)


@pytest.mark.parametrize("value,attn,conv", [
    ("0", False, False), ("1", True, True), ("attn", True, False),
    ("conv", False, True)])
def test_switch_values(monkeypatch, value, attn, conv):
    monkeypatch.setenv("LNMM_PALLAS", value)
    assert (lnmm.enabled("attn"), lnmm.enabled("conv")) == (attn, conv)


@pytest.mark.parametrize("d", [32, 96, 512])
def test_check_args_refuses_bf16_widths_the_kernels_do_not_take(d):
    """The bf16 kernels, forward and backward, take D in {64, 128, 256}:
    check_args (run before every launch) raises on any other bf16 width and
    takes those three; fp32 takes the refused width."""
    def args(width, dt, k=128):
        return (torch.zeros(4, width, dtype=dt), torch.ones(width),
                torch.zeros(width), torch.zeros(k, width, dtype=dt),
                torch.zeros(k), torch.ones(4))
    with pytest.raises(ValueError, match="bf16 kernels"):
        lnmm.check_args(*args(d, torch.bfloat16))
    lnmm.check_args(*args(d, torch.float32))
    for width in lnmm.BF16_WIDTHS:
        lnmm.check_args(*args(width, torch.bfloat16))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x, g, bl, w, b, mask, _ = (torch.from_numpy(a) for a in _lnmm_args())
    w = w.t().contiguous()
    with pytest.raises(ValueError, match="multiple of 16"):
        lnmm.check_args(x[:, :24].contiguous(), g[:24], bl[:24],
                        w[:, :24].contiguous(), b, mask)
    with pytest.raises(ValueError, match="multiple of 64"):
        lnmm.check_args(x, g, bl, w[:48].contiguous(), b[:48], mask)
    with pytest.raises(TypeError, match="float32"):
        lnmm.check_args(x, g, bl, w, b, mask.double())
    with pytest.raises(ValueError, match="CUDA"):
        lnmm.forward_kernel(x, g, bl, w, b, mask, 1e-5)
    xf, w1, b1, w2, b2, _ = (torch.from_numpy(np.ascontiguousarray(a))
                             for a in _ffn_args())
    with pytest.raises(ValueError, match="activation"):
        ffn.check_args(xf, None, None, w1.t().contiguous(), b1,
                       w2.t().contiguous(), b2, "gelu")
    with pytest.raises(ValueError, match="dropout rate"):
        ffn.ffn_fused(xf, w1.t(), b1, w2.t(), b2, "relu", rate=1.0)
