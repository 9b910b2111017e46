"""``ln_ffn_residual`` of the port (ops/ffn.py) against the JAX package:
the plain PyTorch version, forward and backward through the port's
autograd Function, against the Pallas kernel and its VJP run in interpret
mode and against the XLA ``PositionwiseFeedForward(ln=)`` block; the
counter-based dropout masks (ops/dropout.py); the wrapper's checks. The
CUDA kernels themselves are tested in test_torch_kernels.py."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wenet_celoss_tpu.models.encoder_layer import \
    PositionwiseFeedForward as JaxFFN
from wenet_celoss_tpu.ops.ffn_pallas import ln_ffn_residual as jax_ln_ffn
from wenet_celoss_tpu_torch.models.encoder_layer import \
    PositionwiseFeedForward
from wenet_celoss_tpu_torch.models.layers import LayerNorm
from wenet_celoss_tpu_torch.ops import dropout, ffn

TOL = dict(rtol=1e-4, atol=1e-4)
CASES = [("swish", 0.5, 37), ("relu", 1.0, 300), ("swish", 1.0, 130)]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _args(n, d=32, f=64, seed=3):
    """x, g, bl, w1 [D, F], b1, w2 [F, D], b2 in the JAX package's layout."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32),
            (0.1 * rng.standard_normal((d, f))).astype(np.float32),
            (0.1 * rng.standard_normal(f)).astype(np.float32),
            (0.1 * rng.standard_normal((f, d))).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32))


def _torch_args(x, g, bl, w1, b1, w2, b2):
    """The same arrays in the port's layout (Linear weights [out, in])."""
    t = torch.from_numpy
    return (t(x), t(g), t(bl), t(np.ascontiguousarray(w1.T)), t(b1),
            t(np.ascontiguousarray(w2.T)), t(b2))


@pytest.mark.parametrize("activation,ff_scale,n", CASES)
def test_plain_version_matches_pallas_interpret(activation, ff_scale, n):
    args = _args(n)
    want = jax_ln_ffn(*[jnp.asarray(a) for a in args],
                      jnp.zeros((), jnp.int32), activation, 0.0, 0.0,
                      ff_scale, interpret=True)
    got = ffn.ln_ffn_residual(*_torch_args(*args), activation, ff_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("activation,ff_scale,n", CASES)
def test_backward_matches_pallas_vjp_interpret(activation, ff_scale, n):
    """All seven gradients of the port's autograd Function on the CPU
    (the plain version's VJP) against ``jax.vjp`` of the Pallas kernel,
    whose backward also runs in interpret mode; rates 0."""
    args = _args(n)
    dy = np.random.default_rng(9).standard_normal(args[0].shape).astype(
        np.float32)

    def fn(*a):
        return jax_ln_ffn(*a, jnp.zeros((), jnp.int32), activation, 0.0, 0.0,
                          ff_scale, interpret=True)
    _, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    want = vjp(jnp.asarray(dy))
    ins = [t.requires_grad_(True) for t in _torch_args(*args)]
    y = ffn.ln_ffn_residual(*ins, activation, ff_scale)
    got = torch.autograd.grad(y, ins, torch.from_numpy(dy))
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.numpy()
        if i in (3, 5):                      # w1, w2: Linear layout
            a = a.T
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_dropout_gradcheck_float64():
    """With both rates 0.3 the mask depends only on seed and position, so
    gradcheck's repeated forwards see one mask: the plain version and the
    autograd Function on the CPU are differentiable through it."""
    x, g, bl, w1, b1, w2, b2 = (t.double() for t in _torch_args(
        *_args(6, d=16, f=32)))
    ins = tuple(t.requires_grad_(True) for t in (x, g, bl, w1, b1, w2, b2))
    for fn in (ffn.ln_ffn_residual_ref, ffn.ln_ffn_residual):
        assert torch.autograd.gradcheck(
            lambda *a: fn(*a, "swish", 0.5, 1e-5, 0.3, 0.3, 77), ins)


def test_dropout_masks_keep_rate_and_seeds():
    """Keep rate within 5 sigma of 1 - rate over 2^17 draws per stream,
    the 1/2^16 threshold of the JAX package, and independent masks for two
    seeds and two streams (agreement p^2 + (1-p)^2)."""
    n, rate = 1 << 17, 0.1
    keep = 1.0 - rate
    thresh, scale = dropout.threshold(rate)
    assert (thresh, scale) == (round(keep * 65536), 1.0 / keep)
    idx = torch.arange(n)
    masks = {(s, st): dropout.keep_mask(s, st, idx, thresh)
             for s in (11, 12) for st in (1, 2)}
    sigma = (keep * rate / n) ** 0.5
    for m in masks.values():
        assert abs(m.double().mean().item() - keep) < 5 * sigma
    agree = keep ** 2 + rate ** 2
    for a, b in (((11, 1), (12, 1)), ((11, 1), (11, 2))):
        same = (masks[a] == masks[b]).double().mean().item()
        assert abs(same - agree) < 0.01, (a, b, same)
    x = torch.ones(64, 32)
    y = dropout.apply_mask(x, 11, 1, rate)
    assert set(y.unique().tolist()) <= {0.0, float(torch.tensor(scale))}
    assert torch.equal(y != 0, masks[(11, 1)][:64 * 32].reshape(64, 32))
    assert dropout.dropout(x, rate, None) is x
    assert dropout.hash32(12345) == int(dropout.hash32(torch.tensor(12345)))


class _JaxBlock(fnn.Module):
    """LayerNorm + FFN block through the JAX package's XLA path."""
    activation: str
    ff_scale: float
    hidden: int

    @fnn.compact
    def __call__(self, x):
        ln = fnn.LayerNorm(epsilon=1e-5, name="ln")
        return JaxFFN(self.hidden, 0.0, self.activation, name="ffn")(
            x, ln=ln, ff_scale=self.ff_scale)


@pytest.mark.parametrize("activation,ff_scale,n", CASES)
def test_ffn_block_matches_jax_xla_path(activation, ff_scale, n):
    x, g, bl, w1, b1, w2, b2 = _args(n)
    params = {"ln": {"scale": g, "bias": bl},
              "ffn": {"Dense_0": {"kernel": w1, "bias": b1},
                      "Dense_1": {"kernel": w2, "bias": b2}}}
    want = _JaxBlock(activation, ff_scale, w1.shape[1]).apply(
        {"params": params}, x[None])[0]
    block = PositionwiseFeedForward(x.shape[1], w1.shape[1], activation)
    ln = LayerNorm(x.shape[1])
    with torch.no_grad():
        _, tg, tbl, tw1, tb1, tw2, tb2 = _torch_args(x, g, bl, w1, b1, w2,
                                                     b2)
        ln.weight.copy_(tg)
        ln.bias.copy_(tbl)
        block.w_1.weight.copy_(tw1)
        block.w_1.bias.copy_(tb1)
        block.w_2.weight.copy_(tw2)
        block.w_2.bias.copy_(tb2)
        got = block(torch.from_numpy(x)[None], ln=ln, ff_scale=ff_scale)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    args = _torch_args(*_args(8))
    with pytest.raises(ValueError, match="dropout rate"):
        ffn.ln_ffn_residual(*args, "swish", 0.5, rate1=1.0)
    with pytest.raises(ValueError, match="dropout rate"):
        ffn.ln_ffn_residual(*args, "swish", 0.5, rate2=-0.1)
    x, g, bl, w1, b1, w2, b2 = args
    with pytest.raises(ValueError, match="multiple of 16"):
        ffn.check_args(x[:, :24].contiguous(), g[:24], bl[:24],
                       w1[:, :24].contiguous(), b1, w2[:24].contiguous(),
                       b2[:24], "swish")
    with pytest.raises(ValueError, match="multiple of"):
        ffn.check_args(x, g, bl, w1[:48].contiguous(), b1[:48],
                       w2[:, :48].contiguous(), b2, "swish")
    with pytest.raises(ValueError, match="activation"):
        ffn.check_args(x, g, bl, w1, b1, w2, b2, "gelu")
    with pytest.raises(TypeError, match="float32"):
        ffn.check_args(x, g.double(), bl, w1, b1, w2, b2, "swish")
    with pytest.raises(ValueError, match="contiguous"):
        ffn.check_args(x, g, bl, w1, b1, w2.t().contiguous().t(), b2,
                       "swish")


@pytest.mark.parametrize("with_ln", [True, False])
@pytest.mark.parametrize("d", [96, 320])
def test_check_args_refuses_bf16_widths_the_kernels_do_not_take(d, with_ln):
    """The bf16 kernels, forward and backward, take D in {64, 128, 256}:
    check_args (run before every launch) raises on any other bf16 width,
    for ln_ffn_residual and ffn_fused alike, and takes those three; fp32
    takes the refused width."""
    def args(width, dt):
        f = 128
        g = torch.ones(width) if with_ln else None
        bl = torch.zeros(width) if with_ln else None
        return (torch.zeros(4, width, dtype=dt), g, bl,
                torch.zeros(f, width, dtype=dt), torch.zeros(f),
                torch.zeros(width, f, dtype=dt), torch.zeros(width))
    with pytest.raises(ValueError, match="bf16 kernels"):
        ffn.check_args(*args(d, torch.bfloat16), "relu")
    ffn.check_args(*args(d, torch.float32), "relu")
    for width in ffn.BF16_WIDTHS:
        ffn.check_args(*args(width, torch.bfloat16), "relu")


def test_kernel_bound_at_main_path_shape():
    """Forward 4·N·D·F operations at the bf16 peak: 17.05 GFLOP, 17.2 us
    at the decode shape, 68.2 GFLOP, 0.0689 ms at the training shape (K1
    and K6 alike, both listed); backward 10·N·D·F at the training shape:
    170.4 GFLOP, 0.172 ms."""
    from wenet_celoss_tpu_torch.ops import bounds
    flops, nbytes = bounds.ln_ffn_residual(64 * 127, 256, 2048, "bf16")
    assert flops == 4 * 64 * 127 * 256 * 2048
    ms, by = bounds.bound_ms(flops, nbytes, "bf16")
    assert by == "operations" and abs(ms - flops / 989e12 * 1e3) < 1e-12
    flops, nbytes = bounds.ln_ffn_residual_bwd(256 * 127, 256, 2048, "bf16")
    assert flops == 10 * 256 * 127 * 256 * 2048
    ms, by = bounds.bound_ms(flops, nbytes, "bf16")
    assert by == "operations" and abs(ms - 0.1723) < 1e-3
    assert {r["kernel"].split()[0] for r in bounds.flagship()} == {
        "K1", "K2", "K3", "K4", "K6", "K7", "K8", "K9"}
    rows = {r["kernel"]: r for r in bounds.flagship()}
    for name in ("K1 ln_ffn_residual (training)", "K6 ffn_fused (training)"):
        r = rows[name]
        assert r["shape"] == "N=32512 D=256 F=2048" and r["dtype"] == "bf16"
        assert r["flops"] == 4 * 256 * 127 * 256 * 2048
        assert r["bound_by"] == "operations"
        assert abs(r["bound_ms"] - 0.06894) < 1e-4
