"""K4 (``ops/lstm.py``) and the predictor's whole-sequence forward held
against the JAX package on the CPU in fp32, and the inter-layer dropout
against an independent step-by-step LSTM with the same mask.

- the plain ``lstm2_seq`` (the CPU path; its backward by autograd) against
  the Pallas ``lstm2_seq`` in interpret mode (rate 0, 4-row blocks) at
  B=4, U=7, H=256: the output and all five gradients, to 1e-5 and 1e-4;
- the port's ``RNNPredictor.forward`` (embedding, hoisted projection, K4's
  plain version, projection) against the JAX ``RNNPredictor`` on its scan
  path, on the tiny flagship, to 1e-4;
- dropout: output and gradients against autograd through a plain LSTM
  stepped cell by cell with the mask of ``ops/dropout.py`` applied by
  hand, to 1e-5; and the mask's keep rate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import _pair
from wenet_celoss_tpu.ops.lstm_pallas import lstm2_seq as jax_lstm2_seq
from wenet_celoss_tpu_torch.ops import dropout
from wenet_celoss_tpu_torch.ops import lstm as lstm_ops
from wenet_celoss_tpu_torch.ops.lstm import lstm2_seq

B, U, H = 4, 7, 256


def _args(seed=0, b=B, u=U, h=H):
    """xw1 [B, U, 4H] and the JAX-layout weights [H, 4H], bh2 [4H]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, u, h)) * 0.5
    wi1 = rng.standard_normal((h, 4 * h)) * 0.05
    bh1 = rng.standard_normal(4 * h) * 0.05
    ws = [rng.standard_normal((h, 4 * h)) * 0.05 for _ in range(3)]
    bh2 = rng.standard_normal(4 * h) * 0.05
    dy = rng.standard_normal((b, u, h))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f32(x @ wi1 + bh1), f32(ws[0]), f32(ws[1]), f32(bh2),
            f32(ws[2])), f32(dy)


def _torch_args(jax_args):
    """Port layout: weights [4H, H]."""
    xw1, wh1, wi2, bh2, wh2 = jax_args
    return [torch.as_tensor(a).requires_grad_(True)
            for a in (xw1, wh1.T.copy(), wi2.T.copy(), bh2, wh2.T.copy())]


def test_lstm2_seq_matches_jax_kernel():
    args, dy = _args()
    seed = jnp.zeros((), jnp.int32)

    def loss(*a):
        return jnp.sum(jax_lstm2_seq(*a, seed, 0.0, 4, True) * dy)

    want_y = jax_lstm2_seq(*map(jnp.asarray, args), seed, 0.0, 4, True)
    want_g = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    ins = _torch_args(args)
    y = lstm2_seq(*ins)
    grads = torch.autograd.grad(y, ins, torch.as_tensor(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-5)
    for name, g, w in zip(("dxw1", "dwh1", "dwi2", "dbh2", "dwh2"), grads,
                          want_g):
        g = g.numpy().T if name in ("dwh1", "dwi2", "dwh2") else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_predictor_forward_matches_jax():
    """The whole-sequence forward (routed through K4's plain version) on
    the tiny flagship against the JAX predictor's scan path, on
    blank-prepended label sequences."""
    _, jm, v, tm = _pair()
    rng = np.random.default_rng(6)
    ys_in = rng.integers(0, 30, (4, 6)).astype(np.int32)
    ys_in[:, 0] = 0
    want = jm.apply(v, ys_in, method="predictor_forward")
    with torch.no_grad():
        got = tm.predictor(torch.as_tensor(ys_in, dtype=torch.long))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def _stepwise(xw1, wh1, wi2, bh2, wh2, rate, seed):
    """An independent plain LSTM: cell by cell, the inter-layer mask built
    from ``keep_mask`` at index (t * B + b) * H + j."""
    b, u, g4 = xw1.shape
    h = g4 // 4
    thresh, scale = dropout.threshold(rate)

    def cell(x, hh, c, w_h, w_i=None, bias=None):
        z = x + hh @ w_h.t()
        if w_i is not None:
            z = z + bias
        i, f, g, o = z.split(h, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    h1 = c1 = h2 = c2 = torch.zeros(b, h)
    rows = torch.arange(b)[:, None] * h + torch.arange(h)[None, :]
    outs = []
    for t in range(u):
        h1, c1 = cell(xw1[:, t], h1, c1, wh1)
        keep = dropout.keep_mask(seed, dropout.STREAM_LSTM_INTER,
                                 t * b * h + rows, thresh)
        d = torch.where(keep, h1 * scale, torch.zeros(()))
        h2, c2 = cell(d @ wi2.t(), h2, c2, wh2, wi2, bh2)
        outs.append(h2)
    return torch.stack(outs, 1)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_inter_layer_dropout_matches_stepwise_lstm(rate):
    args, dy = _args(seed=2, b=3, u=5, h=32)
    ins = _torch_args(args)
    y = lstm2_seq(*ins, rate=rate, seed=77)
    grads = torch.autograd.grad(y, ins, torch.as_tensor(dy))
    ref_ins = _torch_args(args)
    ref = _stepwise(*ref_ins, rate, 77)
    ref_grads = torch.autograd.grad(ref, ref_ins, torch.as_tensor(dy))
    np.testing.assert_allclose(y.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5)
    if rate:
        no_drop = lstm2_seq(*_torch_args(args), rate=0.0)
        assert not torch.allclose(y, no_drop)


def test_inter_layer_mask_keep_rate_and_offset():
    """Stream 3's mask keeps 1 - rate of the units (within 5 sigma over
    2^20 draws) and ``apply_mask``'s offset indexes it as
    (t * B + b) * H + j."""
    rate, seed, n = 0.1, 5, 1 << 20
    thresh, scale = dropout.threshold(rate)
    keep = dropout.keep_mask(seed, dropout.STREAM_LSTM_INTER,
                             torch.arange(n), thresh)
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(float(keep.double().mean()) - (1 - rate)) < 5 * sigma
    x = torch.ones(4, 64)
    got = dropout.apply_mask(x, seed, dropout.STREAM_LSTM_INTER, rate,
                             offset=3 * 256)
    np.testing.assert_array_equal(
        (got != 0).reshape(-1).numpy(), keep[768:768 + 256].numpy())
    assert float(got.max()) == pytest.approx(scale)


@pytest.mark.parametrize("h", [32, 48, 96, 192, 320])
def test_check_args_refuses_bf16_widths_the_kernels_do_not_take(h):
    """A bf16 width outside H in {64, 128, 256} raises in check_args,
    before any launch and with no card or built library (CPU tensors);
    the same width in fp32, and the taken bf16 widths, pass it."""
    def args(h, dtype):
        return (torch.zeros(2, 3, 4 * h, dtype=dtype),
                *(torch.zeros(4 * h, h) for _ in range(2)),
                torch.zeros(4 * h), torch.zeros(4 * h, h))
    with pytest.raises(ValueError, match="bf16"):
        lstm_ops.check_args(*args(h, torch.bfloat16))
    lstm_ops.check_args(*args(h, torch.float32))
    for ok in lstm_ops.BF16_WIDTHS:
        lstm_ops.check_args(*args(ok, torch.bfloat16))


def test_k4_bounds_count_what_the_function_needs():
    """K4's bounds count the function's own bytes (forward: xw1, the
    weights and bh2 in, y out; backward: dy and the saved states in,
    dxw1, the weight gradients and dbh2 out); the port's extra traffic
    (saved states written, xw2, T(dz2), gd) is reported apart and is
    larger."""
    from wenet_celoss_tpu_torch.ops import bounds
    b, u, h, e = 256, 33, 256, 2
    flops, nbytes = bounds.lstm2_seq(b, u, h, "bf16")
    assert flops == 3 * 2 * b * h * 4 * h * u
    assert nbytes == (b * u * 4 * h * e + 3 * 4 * h * h * e + 4 * 4 * h
                      + b * u * h * e)
    flops_b, nbytes_b = bounds.lstm2_seq_bwd(b, u, h, "bf16")
    assert flops_b == 2 * flops
    saved = b * u * (2 * 4 * h * 4 + 2 * h * 4 + 3 * h * e)
    assert nbytes_b == (b * u * h * e + 3 * 4 * h * h * e + saved
                        + b * u * 4 * h * e + 3 * 4 * h * h * 4 + 4 * 4 * h)
    port_f, port_b = bounds.lstm2_seq_port_bytes(b, u, h, "bf16")
    assert port_f > nbytes and port_b > nbytes_b
