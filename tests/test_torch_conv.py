"""The fused conformer conv block (K8, ``ops/conv.py``) held against the
JAX package on the CPU in fp32:

- K8's plain version, forward and all eleven outputs of its backward (dx
  and the ten parameter gradients), against ``conv_block_residual`` in
  interpret mode, causal and non-causal, on a padded batch at rate 0
  (the shapes and tolerances of ``tests/test_models.py``'s test of the
  Pallas kernel: 2e-5 on the output, 2e-4 on the gradients);
- the tiny flagship's encoder layers with ``CONV_PALLAS=1`` (K8's route,
  one call a layer): every loss term and gradient against the JAX
  package's training step, whose layers run the unfused module;
- at rate 0.1 the forward and the backward draw the same mask, the plain
  mask function's;
- ``check_args`` refuses, before any launch, every bf16 width and kernel
  size but the one the bf16 kernels take (D = 256, K = 15).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_transducer as ttrans
from wenet_celoss_tpu.ops.conv_pallas import \
    conv_block_residual as jax_conv_block
from wenet_celoss_tpu_torch.models import encoder_layer
from wenet_celoss_tpu_torch.ops import conv, dropout

B, T, D, K = 3, 21, 16, 7
LENS = np.array([21, 13, 5])
NAMES = ("x", "g1", "b1", "w1", "bw1", "w_dw", "b_dw", "g2", "b2", "w2",
         "bw2")


def _inputs(seed=11, d=D):
    """x, the float mask and the ten parameters (JAX layout), seeded."""
    rng = np.random.default_rng(seed)

    def arr(*shape, std=1.0, mean=0.0):
        return (mean + std * rng.standard_normal(shape)).astype(np.float32)
    x = arr(B, T, d)
    mask = (np.arange(T)[None, :] < LENS[:, None]).astype(np.float32)
    params = (arr(d, std=0.1, mean=1.0), arr(d, std=0.1),
              arr(d, 2 * d, std=d ** -0.5), arr(2 * d, std=0.1),
              arr(K, d, std=K ** -0.5), arr(d, std=0.1),
              arr(d, std=0.1, mean=1.0), arr(d, std=0.1),
              arr(d, d, std=d ** -0.5), arr(d, std=0.1))
    return x, mask, params


@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_matches_pallas_kernel(causal):
    """y (2e-5) and the gradients of mean(y^2) with respect to x and every
    parameter (2e-4) against the Pallas kernel in interpret mode."""
    x, mask, params = _inputs()

    def jax_loss(x_, *p):
        y = jax_conv_block(x_, jnp.asarray(mask), *p,
                           jnp.zeros((), jnp.int32), causal, 0.0, 1e-5, 1,
                           True)
        return jnp.mean(jnp.square(y)), y
    (_, want_y), want_g = jax.value_and_grad(
        jax_loss, argnums=tuple(range(11)), has_aux=True)(
            jnp.asarray(x), *(jnp.asarray(p) for p in params))
    ins = [torch.as_tensor(a).requires_grad_(True) for a in (x, *params)]
    y = conv.conv_block_residual(ins[0], torch.as_tensor(mask), *ins[1:],
                                 causal=causal)
    got_g = torch.autograd.grad(torch.mean(y * y), ins)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=2e-5, atol=2e-5, err_msg="tolerance 2e-5")
    for name, g, w in zip(NAMES, got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4, err_msg=f"d{name}, tolerance "
                                                      f"2e-4")


class _Counting:
    """conv_block_residual, counting its calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return conv.conv_block_residual(*args, **kwargs)


@pytest.fixture
def _conv_route(monkeypatch):
    monkeypatch.setenv("CONV_PALLAS", "1")
    counting = _Counting()
    monkeypatch.setattr(encoder_layer, "conv_block_residual", counting)
    return counting


def test_flagship_gradients_through_conv_block_match_jax(_conv_route):
    """The tiny flagship's loss terms (1e-5 relative) and every gradient
    (1e-4 of its largest element) with every ConformerEncoderLayer's conv
    block through K8's plain version (one call a layer) and its autograd
    backward, against the JAX layers' unfused path."""
    ttrans.check_grads_match_jax("streaming")
    assert _conv_route.calls == ttrans._cfg()["encoder_conf"]["num_blocks"]


def test_forward_and_backward_draw_the_same_mask():
    """At rate 0.1 the output differs from x exactly where the plain mask
    function keeps, and dbw2 (the column sums of the kept, rescaled,
    row-masked upstream gradient) is the same mask's."""
    x, mask, params = _inputs(5, d=64)
    seed, rate = 1234, 0.1
    thresh, scale = dropout.threshold(rate)
    index = torch.arange(B * T * 64).reshape(B, T, 64)
    keep = dropout.keep_mask(seed, dropout.STREAM_CONV_OUT, index, thresh)
    ins = [torch.as_tensor(a).requires_grad_(True) for a in (x, *params)]
    tmask = torch.as_tensor(mask)
    y = conv.conv_block_residual(ins[0], tmask, *ins[1:], seed=seed,
                                 rate=rate)
    valid = tmask.bool()[..., None].expand_as(keep)
    moved = (y != ins[0]).detach()
    assert torch.equal(moved[valid], keep[valid])
    assert not moved[~valid].any()
    (dbw2,) = torch.autograd.grad(y.sum(), [ins[-1]])
    want = (keep.float() * scale * tmask[..., None]).sum((0, 1))
    np.testing.assert_allclose(dbw2.numpy(), want.numpy(), rtol=1e-6,
                               err_msg="tolerance 1e-6")


def test_kernel_wrapper_refuses_what_it_does_not_take():
    """The K8 wrappers check before building anything: a width that is not
    a multiple of 64, an even non-causal kernel, CPU tensors."""
    x, mask, params = _inputs(d=64)
    args = [torch.as_tensor(a) for a in (x, mask, *params)]
    with pytest.raises(ValueError, match="multiple of 64"):
        conv.check_args(*[torch.as_tensor(a) for a in
                          (_inputs()[0], mask, *_inputs()[2])],
                        causal=False)
    even = list(args)
    even[6] = torch.zeros(6, 64)
    with pytest.raises(ValueError, match="odd"):
        conv.check_args(*even, causal=False)
    with pytest.raises(ValueError, match="CUDA"):
        conv.forward_kernel(*args, 0, False, 0.0, 1e-5)


@pytest.mark.parametrize("d,k,causal", [(128, 15, False), (64, 15, True),
                                        (512, 15, False), (256, 7, False),
                                        (256, 31, True), (256, 14, True)])
def test_bf16_kernels_refuse_shapes_they_do_not_take(d, k, causal):
    """check_args refuses, before any launch, a bf16 width or kernel size
    the conv16 kernels do not take (they take D = 256 with K = 15); the
    same shape in fp32 passes the shape checks and stops only at the
    device check."""
    x, mask, params = _inputs(3, d=d)
    params = list(params)
    params[4] = np.zeros((k, d), np.float32)
    args = [torch.as_tensor(a) for a in (x, mask, *params)]
    bf16 = list(args)
    for i in (0, 4, 10):   # x, w1, w2 in the compute dtype
        bf16[i] = args[i].to(torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 kernels take"):
        conv.check_args(*bf16, causal=causal)
    with pytest.raises(ValueError, match="bf16 kernels take"):
        conv.forward_kernel(*bf16, 0, causal, 0.0, 1e-5)
    dy = bf16[0].clone()
    with pytest.raises(ValueError, match="bf16 kernels take"):
        conv.backward_kernel(*bf16, dy, 0, causal, 0.0, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        conv.check_args(*args, causal=causal)


def test_bf16_kernels_take_the_configs_shape():
    """D = 256 with K = 15, causal and not (every layer_norm conv module
    of the repo's configs), passes the bf16 shape checks and stops only
    at the device check on CPU tensors."""
    x, mask, params = _inputs(3, d=256)
    params = list(params)
    params[4] = np.zeros((15, 256), np.float32)
    args = [torch.as_tensor(a) for a in (x, mask, *params)]
    for i in (0, 4, 10):
        args[i] = args[i].to(torch.bfloat16)
    for causal in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            conv.check_args(*args, causal=causal)
