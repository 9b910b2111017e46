"""LayerNorm fused into a matmul (K7): the port of
``wenet_celoss_tpu/ops/ffn_pallas.py::ln_matmul``, forward and backward.

    y = (LN(x) * rowmask) @ w^T + b

It serves the conformer layer's LN → merged QKV projection and LN →
row-masked pointwise conv1, and the decoder's self-attention projection,
when ``LNMM_PALLAS`` routes them (:func:`enabled`). It is a
``torch.autograd.Function`` that saves only its inputs, as the Pallas VJP
does; the backward recomputes the LayerNorm. On CUDA tensors its forward
and backward launch the hand-written kernels of ``csrc/ln_matmul.cu``; on
CPU tensors they run ``ln_matmul_ref``, the plain PyTorch version with the
kernel's rounding points (the backward by autograd through it). Without a
gradient to take, the wrapper calls the registered forward operator
``wenet_torch::ln_matmul_fwd`` (what an exported program holds).

x [N, D] in the compute dtype; w [K, D] (``torch.nn.Linear`` layout) in
x's dtype; g, bl [D], b [K] and the row mask [N] (or None) fp32. The mask
multiplies after the LayerNorm, so a masked row contributes nothing to the
product and comes out as the bias.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from wenet_celoss_tpu_torch.ops._build import load_library, wants_autograd

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
D_MULTIPLE, K_MULTIPLE, MAX_D = 16, 64, 512
BF16_WIDTHS = (64, 128, 256)   # the widths the bf16 kernels take


def enabled(site: str) -> bool:
    """Whether ``LNMM_PALLAS`` routes K7 at ``site`` ("attn": the merged
    QKV projections, "conv": pointwise conv1): "1" routes both, "attn" or
    "conv" that site alone; off by default. Read at each forward, as the
    JAX package reads it."""
    return os.environ.get("LNMM_PALLAS", "0") in ("1", site)


def ln_matmul_ref(x, g, bl, w, b, mask: Optional[torch.Tensor] = None,
                  eps: float = 1e-5):
    """Plain version. LayerNorm in fp32, times the row mask, cast to x's
    dtype; the matmul takes the cast operands and accumulates in fp32 (the
    products of two bf16 values are exact in fp32); the fp32 bias is added
    before the output's one cast. Differentiable by autograd."""
    cdt = x.dtype
    af = torch.promote_types(cdt, torch.float32)    # fp64 stays fp64
    xf = x.to(af)
    mu = xf.mean(dim=1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=1, keepdim=True)
    xn = xc * torch.rsqrt(var + eps) * g + bl
    if mask is not None:
        xn = xn * mask.to(af)[:, None]
    return (xn.to(cdt).to(af) @ w.to(af).t() + b).to(cdt)


def check_args(x, g, bl, w, b, mask):
    """Raise on what the kernels do not take: dtype, widths, layout,
    alignment, shapes and devices that differ (``on_card`` adds that the
    device is a card)."""
    if x.dim() != 2:
        raise ValueError(f"x must be [N, D], got {tuple(x.shape)}")
    n, d = x.shape
    k = w.shape[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not supported (float32, "
                        f"bfloat16)")
    if d % D_MULTIPLE or d > MAX_D:
        raise ValueError(f"D={d} must be a multiple of {D_MULTIPLE} up to "
                         f"{MAX_D}")
    if x.dtype == torch.bfloat16 and d not in BF16_WIDTHS:
        raise ValueError(f"D={d} is not a width the bf16 kernels take "
                         f"{BF16_WIDTHS}")
    if k % K_MULTIPLE:
        raise ValueError(f"K={k} must be a multiple of {K_MULTIPLE}")
    shapes = {"w": (w, (k, d)), "g": (g, (d,)), "bl": (bl, (d,)),
              "b": (b, (k,)), "mask": (mask, (n,))}
    for name, (t, shape) in shapes.items():
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        want = x.dtype if name == "w" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} dtype {t.dtype} != {want}")
    for name, t in (("x", x), *((k_, v[0]) for k_, v in shapes.items())):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}: "
                             f"the kernels take tensors on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")


def on_card(x, g, bl, w, b, mask):
    """check_args, and that the tensors lie on a card: what every launch
    runs first."""
    check_args(x, g, bl, w, b, mask)
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}: the kernels take CUDA "
                         f"tensors")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def forward_kernel(x, g, bl, w, b, mask, eps):
    """Launch the forward kernel on CUDA tensors (no autograd)."""
    on_card(x, g, bl, w, b, mask)
    n, d = x.shape
    k = w.shape[0]
    y = torch.empty(n, k, dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    rc = _lib().ln_matmul_fwd(
        _DTYPES[x.dtype], x.data_ptr(), g.data_ptr(), bl.data_ptr(),
        w.data_ptr(), b.data_ptr(), _ptr(mask), y.data_ptr(), n, d, k,
        float(eps), _stream(x))
    if rc != 0:
        raise RuntimeError(f"ln_matmul kernel launch failed: cudaError {rc}"
                           f" (fp32 D={d} may not fit shared memory)")
    ln_matmul.launches += 1
    return y


def backward_kernel(x, g, bl, w, b, mask, dy, eps):
    """Launch the backward kernels on CUDA tensors → (dx in x's dtype, and
    dg, dbl, dw [K, D], db in fp32; b is checked, not read)."""
    on_card(x, g, bl, w, b, mask)
    n, d = x.shape
    k = w.shape[0]
    if tuple(dy.shape) != (n, k) or dy.dtype != x.dtype or \
            not dy.is_contiguous() or dy.device != x.device:
        raise ValueError("dy must be a contiguous [N, K] tensor in x's "
                         "dtype on x's device")
    f32 = dict(dtype=torch.float32, device=x.device)
    new = torch.zeros if n == 0 else torch.empty    # the kernels write all
    dx = torch.empty_like(x)
    dg, dbl, dw, db = new(d, **f32), new(d, **f32), new(k, d, **f32), \
        new(k, **f32)
    if n == 0:
        return dx, dg, dbl, dw, db
    lib = _lib()
    dtype = _DTYPES[x.dtype]
    words = lib.ln_matmul_bwd_workspace(dtype, n, d, k)
    if words <= 0:
        raise RuntimeError(f"ln_matmul backward: the kernels do not take "
                           f"D={d}, or a CUDA error ({words})")
    ws = torch.empty(words, **f32)
    xn = torch.empty_like(x)
    rc = lib.ln_matmul_bwd(
        dtype, x.data_ptr(), dy.data_ptr(), g.data_ptr(), bl.data_ptr(),
        w.data_ptr(), _ptr(mask), dx.data_ptr(), dg.data_ptr(),
        dbl.data_ptr(), dw.data_ptr(), db.data_ptr(), ws.data_ptr(),
        xn.data_ptr(), n, d, k, float(eps), _stream(x))
    if rc != 0:
        raise RuntimeError(f"ln_matmul backward kernel launch failed: "
                           f"cudaError {rc}")
    ln_matmul.bwd_launches += 1
    return dx, dg, dbl, dw, db


def backward_ref(x, g, bl, w, b, mask, dy, eps):
    """The plain backward: the plain forward's vector-Jacobian product by
    autograd → (dx, dg, dbl, dw, db)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, g, bl, w, b)]
        y = ln_matmul_ref(*ins, mask, eps)
        return torch.autograd.grad(y, ins, dy)


class _LnMatmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, g, bl, w, b, mask, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, g, bl, w, b, mask)
        fn = ln_matmul_ref if x.device.type == "cpu" else forward_kernel
        return fn(x, g, bl, w, b, mask, eps)

    @staticmethod
    def backward(ctx, dy):
        x, g, bl, w, b, mask = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        if x.device.type == "cpu":
            grads = backward_ref(x, g, bl, w, b, mask, dy, ctx.eps)
        else:
            grads = backward_kernel(x, g, bl, w, b, mask, dy, ctx.eps)
            # Each gradient in its input's dtype, as the Pallas VJP returns.
            grads = [gr.to(t.dtype) for gr, t in zip(grads, (x, g, bl, w, b))]
        return (*grads, None, None)


@torch.library.custom_op("wenet_torch::ln_matmul_fwd", mutates_args=(),
                         device_types="cpu")
def ln_matmul_fwd(x: torch.Tensor, g: torch.Tensor, bl: torch.Tensor,
                  w: torch.Tensor, b: torch.Tensor,
                  mask: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """K7's forward as a registered operator: the plain version on the
    CPU, the kernel on the card."""
    return ln_matmul_ref(x, g, bl, w, b, mask, eps)


@ln_matmul_fwd.register_kernel("cuda")
def _(x, g, bl, w, b, mask, eps):
    return forward_kernel(x, g, bl, w, b, mask, eps)


@ln_matmul_fwd.register_fake
def _(x, g, bl, w, b, mask, eps):
    return x.new_empty(x.shape[0], w.shape[0])


def ln_matmul(x, g, bl, w, b, mask: Optional[torch.Tensor] = None,
              eps: float = 1e-5):
    """(LN(x) * mask) @ w^T + b, [N, K] in x's dtype. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (and, under
    autograd, the backward kernels) or raises. Without a gradient to take
    it runs the operator ``wenet_torch::ln_matmul_fwd``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if wants_autograd(x, g, bl, w, b):
        return _LnMatmul.apply(x, g, bl, w, b, mask, float(eps))
    return ln_matmul_fwd(x, g, bl, w, b, mask, float(eps))


ln_matmul.launches = 0
ln_matmul.bwd_launches = 0


def fwd_schedule(n: int, k: int, force: int = -1) -> int:
    """The bf16 forward's column groups at ``n`` rows and ``k`` outputs:
    each block of 128 rows takes K / (64 groups) output tiles. ``force``
    > 0 forces that many groups (where it divides K / 64) until it is set
    back to -1 (chosen from N and K); for timing the schedules."""
    return _lib().ln_matmul_fwd_schedule(int(force), int(n), int(k))


def _lib() -> ctypes.CDLL:
    lib = load_library("ln_matmul")
    if lib.ln_matmul_fwd.argtypes is None:
        p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ln_matmul_fwd.argtypes = [i] + [p] * 7 + [i] * 3 + [fl, p]
        lib.ln_matmul_fwd.restype = i
        lib.ln_matmul_bwd_workspace.argtypes = [i] * 4
        lib.ln_matmul_bwd_workspace.restype = ctypes.c_longlong
        lib.ln_matmul_bwd.argtypes = [i] + [p] * 13 + [i] * 3 + [fl, p]
        lib.ln_matmul_bwd.restype = i
        lib.ln_matmul_fwd_schedule.argtypes = [i] * 3
        lib.ln_matmul_fwd_schedule.restype = i
    return lib
