"""Fused conformer convolution block (K8): the port of
``wenet_celoss_tpu/ops/conv_pallas.py::conv_block_residual``, forward and
backward, with its output dropout.

    y = x + drop(PW2(silu(LN2(DW(GLU(PW1(mask * LN1(x)))))))) * mask

It is a ``torch.autograd.Function`` that saves only its inputs, as the
Pallas VJP does; the backward recomputes the block. On CUDA tensors its
forward and backward launch the hand-written kernels of
``csrc/conv_block.cu`` (bf16: the wgmma/TMA kernels of namespace
``conv16``, D = 256 and K = 15 only; fp32: the plain-FMA kernels); on CPU
tensors they run ``conv_block_residual_ref``, the plain PyTorch version
with the kernel's rounding points (the backward by autograd through it).
Without a gradient to take, the wrapper calls the registered forward
operator ``wenet_torch::conv_block_fwd`` (what an exported program holds).

Padding is the module's (``models/convolution.py``): a causal block
left-pads K - 1 frames in the raw domain before PW1 (those frames carry
GLU(bw1), not zero), a non-causal one zero-pads (K - 1) / 2 frames on each
side after the GLU. LN1's output is zeroed at pad frames, the block's
output again before the residual, and the residual adds the unmasked x.
The dropout mask is stream ``STREAM_CONV_OUT`` of ``ops/dropout.py`` at
index ((row_base + b) * T + t) * D + c: ``row_base`` is the first global
row of x when a step's batch is split over processes (0 otherwise).

Layouts are the JAX package's: x [B, T, D] in the compute dtype, mask
[B, T], w1 [D, 2D] and w2 [D, D] in the compute dtype, w_dw [K, D], the
norm parameters and biases fp32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from wenet_celoss_tpu_torch.ops import dropout as drop
from wenet_celoss_tpu_torch.ops._build import load_library, wants_autograd

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Channel counts the fp32 kernels take: a multiple of 64 (the
# weight-gradient tiles) whose tiles fit shared memory (the library says
# which).
D_MULTIPLE = 64
MAX_K = 31
# (D, K) the bf16 kernels take (namespace conv16): every layer_norm conv
# module of the repo's configs.
BF16_SHAPES = ((256, 15),)


def _ln(x, g, b, eps):
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * g + b


def conv_block_residual_ref(x, mask, g1, b1, w1, bw1, w_dw, b_dw, g2, b2,
                            w2, bw2, seed: int = 0, causal: bool = False,
                            rate: float = 0.0, eps: float = 1e-5,
                            row_base: int = 0):
    """Plain version. LN1 in fp32, masked, cast to x's dtype; PW1 with the
    cast operands, fp32 accumulation and the fp32 bias; GLU, the depthwise
    taps (summed in tap order), LN2 and silu in fp32; silu's output cast
    to x's dtype before PW2; the mask, the dropout and the residual in fp32,
    cast once. Differentiable by autograd."""
    cdt = x.dtype
    af = torch.promote_types(cdt, torch.float32)    # fp64 stays fp64
    t, d = x.shape[1], x.shape[2]
    k = w_dw.shape[0]
    lp_raw, hp_pad = (k - 1, 0) if causal else (0, (k - 1) // 2)
    xf = x.to(af)
    m = mask.to(af)[..., None]
    xn = (_ln(xf, g1, b1, eps) * m).to(cdt)
    xe = F.pad(xn, (0, 0, lp_raw, 0))
    u = xe.to(af) @ w1.to(af) + bw1
    h = u[..., :d] * torch.sigmoid(u[..., d:])
    hp = F.pad(h, (0, 0, hp_pad, hp_pad))
    w_dw = w_dw.to(af)
    y0 = hp[:, 0:t] * w_dw[0]
    for i in range(1, k):
        y0 = y0 + hp[:, i:i + t] * w_dw[i]
    y1 = _ln(y0 + b_dw, g2, b2, eps)
    z = (y1 * torch.sigmoid(y1)).to(cdt)
    v = (z.to(af) @ w2.to(af) + bw2) * m
    return (xf + drop.apply_mask(v, seed, drop.STREAM_CONV_OUT, rate,
                                 offset=row_base * t * d)).to(cdt)


_PARAMS = ("g1", "b1", "w1", "bw1", "w_dw", "b_dw", "g2", "b2", "w2", "bw2")


def check_args(x, mask, *params, causal: bool):
    """Raise on what the kernels do not take: device, dtype, layout,
    alignment and shapes."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, D], got {tuple(x.shape)}")
    bsz, t, d = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not supported (float32, "
                        f"bfloat16)")
    k = params[4].shape[0]
    if d % D_MULTIPLE:
        raise ValueError(f"D={d} must be a multiple of {D_MULTIPLE}")
    if not 1 <= k <= MAX_K or (not causal and k % 2 == 0):
        raise ValueError(f"K={k} must be in [1, {MAX_K}] and odd unless "
                         f"causal")
    if x.dtype == torch.bfloat16 and (d, k) not in BF16_SHAPES:
        raise ValueError(f"D={d}, K={k} is not a shape the bf16 kernels "
                         f"take {BF16_SHAPES}")
    shapes = dict(zip(_PARAMS, ((d,), (d,), (d, 2 * d), (2 * d,), (k, d),
                                (d,), (d,), (d,), (d, d), (d,))))
    for name, p in zip(_PARAMS, params):
        if tuple(p.shape) != shapes[name]:
            raise ValueError(f"{name} shape {tuple(p.shape)} != "
                             f"{shapes[name]}")
        want = x.dtype if name in ("w1", "w2") else torch.float32
        if p.dtype != want:
            raise TypeError(f"{name} dtype {p.dtype} != {want}")
    if tuple(mask.shape) != (bsz, t) or mask.dtype != torch.float32:
        raise ValueError("mask must be a float32 [B, T] tensor")
    for name, p in (("x", x), ("mask", mask), *zip(_PARAMS, params)):
        if p.device != x.device or p.device.type != "cuda":
            raise ValueError(f"{name} is on {p.device}: the kernels take "
                             f"CUDA tensors on one device")
        if not p.is_contiguous() or p.data_ptr() % 32:
            raise ValueError(f"{name} must be contiguous and 32-byte "
                             f"aligned")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _masks(seed: int, rate: float, row_base: int):
    """(key, threshold, scale, first global row) for the kernels."""
    if row_base < 0:
        raise ValueError(f"row_base {row_base} < 0")
    thresh, scale = drop.threshold(rate)
    return [drop.stream_key(seed, drop.STREAM_CONV_OUT), thresh, scale,
            int(row_base) & drop.M32]


def forward_kernel(x, mask, g1, b1, w1, bw1, w_dw, b_dw, g2, b2, w2, bw2,
                   seed, causal, rate, eps, row_base=0):
    """Launch the forward kernel on CUDA tensors (no autograd)."""
    params = (g1, b1, w1, bw1, w_dw, b_dw, g2, b2, w2, bw2)
    check_args(x, mask, *params, causal=causal)
    bsz, t, d = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    rc = _lib().conv_block_fwd(
        _DTYPES[x.dtype], x.data_ptr(), mask.data_ptr(),
        *(p.data_ptr() for p in params), y.data_ptr(), bsz, t, d,
        w_dw.shape[0], int(causal), float(eps), *_masks(seed, rate, row_base),
        _stream(x))
    if rc != 0:
        raise RuntimeError(f"conv_block kernel launch failed: cudaError {rc}"
                           f" (D={d}, K={w_dw.shape[0]} may not fit shared "
                           f"memory)")
    conv_block_residual.launches += 1
    return y


def backward_kernel(x, mask, g1, b1, w1, bw1, w_dw, b_dw, g2, b2, w2, bw2,
                    dy, seed, causal, rate, eps, row_base=0):
    """Launch the backward kernels on CUDA tensors → (dx in x's dtype, and
    dg1, db1, dw1, dbw1, dw_dw, db_dw, dg2, db2, dw2, dbw2 in fp32, views
    of one buffer in that order)."""
    params = (g1, b1, w1, bw1, w_dw, b_dw, g2, b2, w2, bw2)
    check_args(x, mask, *params, causal=causal)
    if dy.shape != x.shape or dy.dtype != x.dtype or \
            not dy.is_contiguous() or dy.device != x.device:
        raise ValueError("dy must be a contiguous tensor like x")
    bsz, t, d = x.shape
    k = w_dw.shape[0]
    flat = torch.zeros(sum(p.numel() for p in params), dtype=torch.float32,
                       device=x.device)
    grads = [g.view(p.shape) for g, p in
             zip(flat.split([p.numel() for p in params]), params)]
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return (dx, *grads)
    lib = _lib()
    code = _DTYPES[x.dtype]
    nbytes = lib.conv_block_bwd_workspace(code, bsz, t, d, k, int(causal))
    if nbytes <= 0:
        raise ValueError(f"D={d}, K={k} do not fit the backward kernels' "
                         f"shared memory")
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    rc = lib.conv_block_bwd(
        code, x.data_ptr(), mask.data_ptr(),
        *(p.data_ptr() for p in params), dy.data_ptr(), dx.data_ptr(),
        *(g.data_ptr() for g in grads), ws.data_ptr(), bsz, t, d, k,
        int(causal), float(eps), *_masks(seed, rate, row_base), _stream(x))
    if rc != 0:
        raise RuntimeError(f"conv_block backward kernel launch failed: "
                           f"cudaError {rc}")
    conv_block_residual.bwd_launches += 1
    return (dx, *grads)


def backward_ref(x, mask, g1, b1, w1, bw1, w_dw, b_dw, g2, b2, w2, bw2, dy,
                 seed, causal, rate, eps, row_base=0):
    """The plain backward: the plain forward's vector-Jacobian product by
    autograd → (dx, the ten parameter gradients)."""
    with torch.enable_grad():
        ins = [p.detach().requires_grad_(True)
               for p in (x, g1, b1, w1, bw1, w_dw, b_dw, g2, b2, w2, bw2)]
        y = conv_block_residual_ref(ins[0], mask, *ins[1:], seed, causal,
                                    rate, eps, row_base)
        return torch.autograd.grad(y, ins, dy)


class _ConvBlockResidual(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mask, g1, b1, w1, bw1, w_dw, b_dw, g2, b2, w2, bw2,
                seed, causal, rate, eps, row_base):
        ctx.cfg = (seed, causal, rate, eps, row_base)
        ctx.save_for_backward(x, mask, g1, b1, w1, bw1, w_dw, b_dw, g2, b2,
                              w2, bw2)
        fn = conv_block_residual_ref if x.device.type == "cpu" \
            else forward_kernel
        return fn(x, mask, g1, b1, w1, bw1, w_dw, b_dw, g2, b2, w2, bw2,
                  seed, causal, rate, eps, row_base)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        x = saved[0]
        dy = dy.to(x.dtype).contiguous()
        if x.device.type == "cpu":
            grads = backward_ref(*saved, dy, *ctx.cfg)
        else:
            grads = backward_kernel(*saved, dy, *ctx.cfg)
            # Each gradient in its input's dtype, as the Pallas VJP returns.
            grads = [g.to(t.dtype) for g, t in
                     zip(grads, (x,) + saved[2:])]
        return (grads[0], None, *grads[1:], None, None, None, None, None)


def conv_block_residual(x, mask, g1, b1, w1, bw1, w_dw, b_dw, g2, b2, w2,
                        bw2, seed: int = 0, causal: bool = False,
                        rate: float = 0.0, eps: float = 1e-5,
                        row_base: int = 0):
    """x + drop(PW2(silu(LN2(DW(GLU(PW1(mask * LN1(x)))))))) * mask, with
    the output dropout ``rate`` in [0, 1) drawn from ``seed`` at x's rows
    counted from ``row_base`` (the module docstring). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (and, under
    autograd, the backward kernels) or raises. Without a gradient to take
    it runs the operator ``wenet_torch::conv_block_fwd``."""
    drop.threshold(rate)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    args = (x, mask, g1, b1, w1, bw1, w_dw, b_dw, g2, b2, w2, bw2,
            int(seed), bool(causal), float(rate), float(eps), int(row_base))
    if wants_autograd(x, g1, b1, w1, bw1, w_dw, b_dw, g2, b2, w2, bw2):
        return _ConvBlockResidual.apply(*args)
    return conv_block_fwd(*args)


@torch.library.custom_op("wenet_torch::conv_block_fwd", mutates_args=(),
                         device_types="cpu")
def conv_block_fwd(x: torch.Tensor, mask: torch.Tensor, g1: torch.Tensor,
                   b1: torch.Tensor, w1: torch.Tensor, bw1: torch.Tensor,
                   w_dw: torch.Tensor, b_dw: torch.Tensor, g2: torch.Tensor,
                   b2: torch.Tensor, w2: torch.Tensor, bw2: torch.Tensor,
                   seed: int, causal: bool, rate: float, eps: float,
                   row_base: int = 0) -> torch.Tensor:
    """K8's forward as a registered operator: the plain version on the
    CPU, the kernel on the card."""
    return conv_block_residual_ref(x, mask, g1, b1, w1, bw1, w_dw, b_dw, g2,
                                   b2, w2, bw2, seed, causal, rate, eps,
                                   row_base)


# row_base keeps its default here: the dispatcher leaves out an argument
# that equals the schema's default.
@conv_block_fwd.register_kernel("cuda")
def _(x, mask, g1, b1, w1, bw1, w_dw, b_dw, g2, b2, w2, bw2, seed, causal,
      rate, eps, row_base=0):
    return forward_kernel(x, mask, g1, b1, w1, bw1, w_dw, b_dw, g2, b2, w2,
                          bw2, seed, causal, rate, eps, row_base)


@conv_block_fwd.register_fake
def _(x, *args):
    return torch.empty_like(x)


conv_block_residual.launches = 0
conv_block_residual.bwd_launches = 0


def _lib() -> ctypes.CDLL:
    lib = load_library("conv_block")
    if lib.conv_block_fwd.argtypes is None:
        p, i, u, fl = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                       ctypes.c_float)
        lib.conv_block_fwd.argtypes = (
            [i] + [p] * 13 + [i] * 5 + [fl, u, i, fl, u, p])
        lib.conv_block_fwd.restype = i
        lib.conv_block_bwd_workspace.argtypes = [i] * 6
        lib.conv_block_bwd_workspace.restype = ctypes.c_longlong
        lib.conv_block_bwd.argtypes = (
            [i] + [p] * 25 + [i] * 5 + [fl, u, i, fl, u, p])
        lib.conv_block_bwd.restype = i
    return lib
