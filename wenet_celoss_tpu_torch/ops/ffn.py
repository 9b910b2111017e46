"""Fused conformer FFN block: LayerNorm -> FFN -> scaled residual.

``ln_ffn_residual`` is the port of ``wenet_celoss_tpu/ops/ffn_pallas.py::
ln_ffn_residual`` (forward, dropout rates 0). On a CUDA tensor it launches
the hand-written kernel in ``csrc/ln_ffn_residual.cu``; on a CPU tensor it
runs ``ln_ffn_residual_ref``, the plain PyTorch version with the same
rounding points. Weights are in ``torch.nn.Linear`` layout: w1 [F, D],
w2 [D, F].
"""

from __future__ import annotations

import ctypes

import torch

from wenet_celoss_tpu_torch.ops._build import load_library

_ACTS = {"relu": 0, "swish": 1}
# F-tile of the kernel per compute dtype (F must be a multiple of it).
F_TILE = {torch.float32: 32, torch.bfloat16: 64}
MAX_D = 512


def _act(name: str, z: torch.Tensor) -> torch.Tensor:
    if name == "relu":
        return torch.clamp_min(z, 0.0)
    if name == "swish":
        return z * torch.sigmoid(z)
    raise ValueError(f"unsupported activation {name!r}")


def ln_ffn_residual_ref(x2, g, bl, w1, b1, w2, b2, activation: str,
                        ff_scale: float = 1.0, eps: float = 1e-5):
    """Plain version: x2 + ff_scale * (act(LN(x2) @ w1^T + b1) @ w2^T + b2).

    LN in fp32 then cast to x2's dtype; each matmul takes the cast
    operands and accumulates in fp32 (products of two bf16 values are
    exact in fp32); the activation runs in fp32 and is cast; the residual
    is summed in fp32 and cast once."""
    cdt = x2.dtype
    xf = x2.float()
    mu = xf.mean(dim=1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=1, keepdim=True)
    xn = (xc * torch.rsqrt(var + eps) * g + bl).to(cdt)
    z1 = xn.float() @ w1.to(cdt).float().t() + b1
    h = _act(activation, z1).to(cdt)
    y2 = h.float() @ w2.to(cdt).float().t() + b2
    return (xf + ff_scale * y2).to(cdt)


def check_args(x2, g, bl, w1, b1, w2, b2, activation):
    """Raise on what the kernel does not take: device, dtype, layout,
    alignment and shapes."""
    if x2.dim() != 2:
        raise ValueError(f"x2 must be [N, D], got {tuple(x2.shape)}")
    n, d = x2.shape
    f = w1.shape[0]
    cdt = x2.dtype
    if cdt not in F_TILE:
        raise TypeError(f"x2 dtype {cdt} not supported (float32, bfloat16)")
    if activation not in _ACTS:
        raise ValueError(f"unsupported activation {activation!r}")
    if d % 16 or d > MAX_D:
        raise ValueError(f"D={d} must be a multiple of 16 up to {MAX_D}")
    if f % F_TILE[cdt]:
        raise ValueError(f"F={f} must be a multiple of {F_TILE[cdt]} "
                         f"for {cdt}")
    shapes = {"w1": (w1, (f, d)), "w2": (w2, (d, f)), "g": (g, (d,)),
              "bl": (bl, (d,)), "b1": (b1, (f,)), "b2": (b2, (d,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    for name, t in (("x2", x2), ("w1", w1), ("w2", w2), ("g", g),
                    ("bl", bl), ("b1", b1), ("b2", b2)):
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x2 on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in (("w1", w1), ("w2", w2)):
        if t.dtype != cdt:
            raise TypeError(f"{name} dtype {t.dtype} != x2 dtype {cdt}")
    for name, t in (("g", g), ("bl", bl), ("b1", b1), ("b2", b2)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def ln_ffn_residual(x2, g, bl, w1, b1, w2, b2, activation: str,
                    ff_scale: float = 1.0, eps: float = 1e-5,
                    rate1: float = 0.0, rate2: float = 0.0):
    """x2 + ff_scale * (act(LN(x2) @ w1^T + b1) @ w2^T + b2).

    x2 [N, D] float32 or bfloat16; g, bl, b1, b2 float32; w1 [F, D] and
    w2 [D, F] in x2's dtype. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises. Dropout (rate1 inside the FFN,
    rate2 on its output) comes with the training slice: any rate above 0
    raises."""
    if rate1 > 0.0 or rate2 > 0.0:
        raise NotImplementedError("ln_ffn_residual dropout is not ported")
    if x2.device.type == "cpu":
        return ln_ffn_residual_ref(x2, g, bl, w1, b1, w2, b2, activation,
                                   ff_scale, eps)
    if x2.device.type != "cuda":
        raise ValueError(f"unsupported device {x2.device}")
    check_args(x2, g, bl, w1, b1, w2, b2, activation)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x2, g, bl, w1, b1, w2, b2)):
        raise NotImplementedError(
            "ln_ffn_residual backward is not ported; call under no_grad")
    y = torch.empty_like(x2)
    n, d = x2.shape
    if n == 0:
        return y
    lib = _lib()
    rc = lib.ln_ffn_residual_fwd(
        1 if x2.dtype == torch.bfloat16 else 0, x2.data_ptr(), g.data_ptr(),
        bl.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), y.data_ptr(), n, d, w1.shape[0], float(ff_scale),
        float(eps), _ACTS[activation],
        torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ln_ffn_residual kernel launch failed: "
                           f"cudaError {rc}")
    ln_ffn_residual.launches += 1
    return y


ln_ffn_residual.launches = 0


def _lib() -> ctypes.CDLL:
    lib = load_library("ln_ffn_residual")
    fn = lib.ln_ffn_residual_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
