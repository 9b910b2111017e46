"""``ln_ffn_residual`` of the port (ops/ffn.py) against the JAX package:
the plain PyTorch version against the Pallas kernel run in interpret mode
and against the XLA ``PositionwiseFeedForward(ln=)`` block; the wrapper's
checks. The CUDA kernel itself is tested in test_torch_kernels.py."""

import flax.linen as fnn
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
from wenet_celoss_tpu_torch.ops import ffn

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
    with pytest.raises(NotImplementedError, match="dropout"):
        ffn.ln_ffn_residual(*args, "swish", 0.5, rate1=0.1)
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


def test_kernel_bound_at_main_path_shape():
    """4·N·D·F operations at the bf16 peak: 17.05 GFLOP, 17.2 us."""
    from wenet_celoss_tpu_torch.ops import bounds
    flops, nbytes = bounds.ln_ffn_residual(64 * 127, 256, 2048, "bf16")
    assert flops == 4 * 64 * 127 * 256 * 2048
    ms, by = bounds.bound_ms(flops, nbytes, "bf16")
    assert by == "operations" and abs(ms - flops / 989e12 * 1e3) < 1e-12
    assert {r["kernel"].split()[0] for r in bounds.flagship()} == {
        "K1", "K2", "K3", "K4", "K6", "K7", "K8", "K9"}
