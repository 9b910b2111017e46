"""Fused FFN kernels: the conformer FFN block (K1, LayerNorm -> FFN ->
dropout -> scaled residual) and the bare post-norm FFN (K6).

``ln_ffn_residual`` is the port of ``wenet_celoss_tpu/ops/ffn_pallas.py::
ln_ffn_residual``, forward and backward, with both dropout masks (rate1 on
the hidden, rate2 on the FFN output; masks from ``ops/dropout.py``).
``ffn_fused`` is the port of ``ffn_pallas.py::ffn_fused``,
``drop(act(x @ w1^T + b1)) @ w2^T + b2`` with the hidden mask only (the
same stream and index as K1's), which every post-norm FFN runs. Each is a
``torch.autograd.Function`` that saves only its input, the parameters and
the seed, as the Pallas VJPs do. On CUDA tensors their forwards and
backwards launch the hand-written kernels in ``csrc/ln_ffn_residual.cu``
(K6 is those kernels with no LayerNorm and no residual); on CPU tensors
they run ``ln_ffn_residual_ref`` and ``ffn_fused_ref``, the plain PyTorch
versions with the same rounding points and masks (the backwards by
autograd through them). Where no gradient will be taken (decoding, an
exported program) the wrappers call the registered forward operators
``wenet_torch::ln_ffn_residual_fwd`` and ``wenet_torch::ffn_fused_fwd``
instead: the plain version on the CPU, the same forward launch on the
card, and a fake implementation that ``torch.export`` traces. Weights are
in ``torch.nn.Linear`` layout: w1 [F, D], w2 [D, F]. ``row_base`` is the
first global row of x2's rows when a step's batch is split over
processes (``ops/dropout.py batch_part``): the masks are drawn at
``(row_base + row) * ncols + col``, the rows' part of the whole batch's.
"""

from __future__ import annotations

import ctypes

import torch

from wenet_celoss_tpu_torch.ops import dropout as drop
from wenet_celoss_tpu_torch.ops._build import load_library, wants_autograd

_ACTS = {"relu": 0, "swish": 1}
# F-tile of the kernel per compute dtype (F must be a multiple of it).
F_TILE = {torch.float32: 32, torch.bfloat16: 64}
MAX_D = 512
BF16_WIDTHS = (64, 128, 256)   # the widths the bf16 kernels take


def _act(name: str, z: torch.Tensor) -> torch.Tensor:
    if name == "relu":
        return torch.clamp_min(z, 0.0)
    if name == "swish":
        return z * torch.sigmoid(z)
    raise ValueError(f"unsupported activation {name!r}")


def ln_ffn_residual_ref(x2, g, bl, w1, b1, w2, b2, activation: str,
                        ff_scale: float = 1.0, eps: float = 1e-5,
                        rate1: float = 0.0, rate2: float = 0.0,
                        seed: int = 0, row_base: int = 0):
    """Plain version:
    x2 + ff_scale * drop2(drop1(act(LN(x2) @ w1^T + b1)) @ w2^T + b2).

    LN in fp32 then cast to x2's dtype; each matmul takes the cast
    operands and accumulates in fp32 (products of two bf16 values are
    exact in fp32); the activation and dropout run in fp32 and are cast;
    the residual is summed in fp32 and cast once. Differentiable by
    autograd, which reproduces the Pallas backward's rounding points up to
    fp32 summation order."""
    cdt = x2.dtype
    af = torch.promote_types(cdt, torch.float32)   # fp64 stays fp64
    xf = x2.to(af)
    mu = xf.mean(dim=1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=1, keepdim=True)
    xn = (xc * torch.rsqrt(var + eps) * g + bl).to(cdt)
    z1 = xn.to(af) @ w1.to(cdt).to(af).t() + b1
    h = drop.apply_mask(_act(activation, z1), seed,
                        drop.STREAM_FFN_HIDDEN, rate1,
                        offset=row_base * w1.shape[0]).to(cdt)
    y2 = drop.apply_mask(h.to(af) @ w2.to(cdt).to(af).t() + b2, seed,
                         drop.STREAM_FFN_OUT, rate2,
                         offset=row_base * x2.shape[1])
    return (xf + ff_scale * y2).to(cdt)


def ffn_fused_ref(x2, w1, b1, w2, b2, activation: str, rate: float = 0.0,
                  seed: int = 0, row_base: int = 0):
    """Plain version: drop(act(x2 @ w1^T + b1)) @ w2^T + b2.

    Each matmul takes operands in x2's dtype and accumulates in fp32; the
    activation and the dropout run in fp32 and the hidden is cast to x2's
    dtype before the second matmul, as the Pallas kernel does; the output
    is cast once. The mask is stream ``STREAM_FFN_HIDDEN`` at index
    ``(row_base + row) * F + col``, K1's hidden mask."""
    cdt = x2.dtype
    af = torch.promote_types(cdt, torch.float32)   # fp64 stays fp64
    z1 = x2.to(af) @ w1.to(cdt).to(af).t() + b1
    h = drop.apply_mask(_act(activation, z1), seed,
                        drop.STREAM_FFN_HIDDEN, rate,
                        offset=row_base * w1.shape[0]).to(cdt)
    return (h.to(af) @ w2.to(cdt).to(af).t() + b2).to(cdt)


def check_args(x2, g, bl, w1, b1, w2, b2, activation):
    """Raise on what the kernel does not take: device, dtype, layout,
    alignment and shapes. ``g`` and ``bl`` are None for ffn_fused."""
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
    if cdt == torch.bfloat16 and d not in BF16_WIDTHS:
        raise ValueError(f"D={d} is not a width the bf16 kernels take "
                         f"{BF16_WIDTHS}")
    if f % F_TILE[cdt]:
        raise ValueError(f"F={f} must be a multiple of {F_TILE[cdt]} "
                         f"for {cdt}")
    shapes = {"w1": (w1, (f, d)), "w2": (w2, (d, f)), "g": (g, (d,)),
              "bl": (bl, (d,)), "b1": (b1, (f,)), "b2": (b2, (d,))}
    shapes = {k: v for k, v in shapes.items() if v[0] is not None}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    for name, t in (("x2", x2), ("w1", w1), ("w2", w2), ("g", g),
                    ("bl", bl), ("b1", b1), ("b2", b2)):
        if t is None:
            continue
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
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def _masks(seed: int, rate1: float, rate2: float):
    """The kernel's dropout arguments: (key, threshold, scale) per
    stream."""
    out = []
    for stream, rate in ((drop.STREAM_FFN_HIDDEN, rate1),
                         (drop.STREAM_FFN_OUT, rate2)):
        thresh, scale = drop.threshold(rate)
        out += [drop.stream_key(seed, stream), thresh, scale]
    return out


def _row_base(row_base: int) -> int:
    """The first global row as the kernels' 32-bit argument (their
    indices wrap mod 2^32, as the plain versions' do)."""
    if row_base < 0:
        raise ValueError(f"row_base {row_base} < 0")
    return int(row_base) & drop.M32


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def forward_kernel(x2, g, bl, w1, b1, w2, b2, activation, ff_scale, eps,
                   rate1, rate2, seed, row_base=0):
    """Launch the forward kernel on CUDA tensors (no autograd)."""
    check_args(x2, g, bl, w1, b1, w2, b2, activation)
    y = torch.empty_like(x2)
    n, d = x2.shape
    if n == 0:
        return y
    rc = _lib().ln_ffn_residual_fwd(
        1 if x2.dtype == torch.bfloat16 else 0, x2.data_ptr(), g.data_ptr(),
        bl.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), y.data_ptr(), n, d, w1.shape[0], float(ff_scale),
        float(eps), _ACTS[activation], *_masks(seed, rate1, rate2),
        _row_base(row_base), _stream(x2))
    if rc != 0:
        raise RuntimeError(f"ln_ffn_residual kernel launch failed: "
                           f"cudaError {rc}")
    ln_ffn_residual.launches += 1
    return y


def backward_kernel(x2, dy, g, bl, w1, b1, w2, b2, activation, ff_scale,
                    eps, rate1, rate2, seed, row_base=0):
    """Launch the backward kernels on CUDA tensors → (dx, dg, dbl, dw1,
    db1, dw2, db2): dx in x2's dtype, the weight gradients in fp32 (b2 is
    checked, not read)."""
    check_args(x2, g, bl, w1, b1, w2, b2, activation)
    if dy.shape != x2.shape or dy.dtype != x2.dtype or \
            not dy.is_contiguous() or dy.device != x2.device:
        raise ValueError("dy must be a contiguous tensor like x2")
    n, d = x2.shape
    f = w1.shape[0]
    dtype = 1 if x2.dtype == torch.bfloat16 else 0
    f32 = dict(dtype=torch.float32, device=x2.device)
    new = torch.zeros if n == 0 else torch.empty   # the kernels write all
    dx = torch.empty_like(x2)
    dg, dbl, db2 = (new(d, **f32) for _ in range(3))
    dw1, dw2, db1 = new(f, d, **f32), new(d, f, **f32), new(f, **f32)
    if n == 0:
        return dx, dg, dbl, dw1, db1, dw2, db2
    lib = _lib()
    words = lib.ln_ffn_residual_bwd_workspace(dtype, n, d, f)
    if words == 0:
        raise ValueError(f"D={d} is not a width the backward kernel "
                         f"takes (bf16: 64, 128, 256)")
    ws = torch.empty(words, **f32)
    rows = torch.empty(2, n, d, dtype=x2.dtype, device=x2.device)
    rc = lib.ln_ffn_residual_bwd(
        dtype, x2.data_ptr(), dy.data_ptr(), g.data_ptr(), bl.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dx.data_ptr(),
        dg.data_ptr(), dbl.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
        dw2.data_ptr(), db2.data_ptr(), ws.data_ptr(), rows.data_ptr(),
        n, d, f,
        float(ff_scale), float(eps), _ACTS[activation],
        *_masks(seed, rate1, rate2), _row_base(row_base), _stream(x2))
    if rc != 0:
        raise RuntimeError(f"ln_ffn_residual backward kernel launch "
                           f"failed: cudaError {rc}")
    ln_ffn_residual.bwd_launches += 1
    return dx, dg, dbl, dw1, db1, dw2, db2


def backward_ref(x2, dy, g, bl, w1, b1, w2, b2, activation, ff_scale, eps,
                 rate1, rate2, seed, row_base=0):
    """The plain backward: recompute the plain forward from x2 and take
    its vector-Jacobian product by autograd (what the CPU path runs)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (x2, g, bl, w1, b1, w2, b2)]
        y = ln_ffn_residual_ref(*ins, activation, ff_scale, eps, rate1,
                                rate2, seed, row_base)
        return torch.autograd.grad(y, ins, dy)


class _LnFfnResidual(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2, g, bl, w1, b1, w2, b2, activation, ff_scale, eps,
                rate1, rate2, seed, row_base):
        cfg = (activation, ff_scale, eps, rate1, rate2, seed, row_base)
        ctx.cfg = cfg
        ctx.save_for_backward(x2, g, bl, w1, b1, w2, b2)
        if x2.device.type == "cpu":
            return ln_ffn_residual_ref(x2, g, bl, w1, b1, w2, b2, *cfg)
        return forward_kernel(x2, g, bl, w1, b1, w2, b2, *cfg)

    @staticmethod
    def backward(ctx, dy):
        x2, g, bl, w1, b1, w2, b2 = ctx.saved_tensors
        dy = dy.to(x2.dtype).contiguous()
        if x2.device.type == "cpu":
            grads = backward_ref(x2, dy, g, bl, w1, b1, w2, b2, *ctx.cfg)
        else:
            grads = backward_kernel(x2, dy, g, bl, w1, b1, w2, b2,
                                    *ctx.cfg)
            # Each gradient in its input's dtype, as the Pallas VJP returns.
            grads = [gr.to(t.dtype) for gr, t in
                     zip(grads, (x2, g, bl, w1, b1, w2, b2))]
        return (*grads, None, None, None, None, None, None, None)


@torch.library.custom_op("wenet_torch::ln_ffn_residual_fwd", mutates_args=(),
                         device_types="cpu")
def ln_ffn_residual_fwd(x2: torch.Tensor, g: torch.Tensor, bl: torch.Tensor,
                        w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                        b2: torch.Tensor, activation: str, ff_scale: float,
                        eps: float, rate1: float, rate2: float,
                        seed: int, row_base: int = 0) -> torch.Tensor:
    """K1's forward as a registered operator (what an exported graph
    holds): the plain version on the CPU, the kernel on the card."""
    return ln_ffn_residual_ref(x2, g, bl, w1, b1, w2, b2, activation,
                               ff_scale, eps, rate1, rate2, seed, row_base)


# row_base keeps its default here (and in ffn_fused_fwd's): the
# dispatcher leaves out an argument that equals the schema's default.
@ln_ffn_residual_fwd.register_kernel("cuda")
def _(x2, g, bl, w1, b1, w2, b2, activation, ff_scale, eps, rate1, rate2,
      seed, row_base=0):
    return forward_kernel(x2, g, bl, w1, b1, w2, b2, activation, ff_scale,
                          eps, rate1, rate2, seed, row_base)


@ln_ffn_residual_fwd.register_fake
def _(x2, *args):
    return torch.empty_like(x2)


def ln_ffn_residual(x2, g, bl, w1, b1, w2, b2, activation: str,
                    ff_scale: float = 1.0, eps: float = 1e-5,
                    rate1: float = 0.0, rate2: float = 0.0, seed: int = 0,
                    row_base: int = 0):
    """x2 + ff_scale * drop2(drop1(act(LN(x2) @ w1^T + b1)) @ w2^T + b2).

    x2 [N, D] float32 or bfloat16; g, bl, b1, b2 float32; w1 [F, D] and
    w2 [D, F] in x2's dtype; rate1 on the hidden and rate2 on the FFN
    output, both in [0, 1), masks drawn from ``seed`` at x2's rows counted
    from ``row_base`` (the module docstring). A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (and, under
    autograd, the backward kernels) or raises. Without a gradient to take
    it runs the operator ``wenet_torch::ln_ffn_residual_fwd``."""
    drop.threshold(rate1)
    drop.threshold(rate2)
    if x2.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x2.device}")
    args = (x2, g, bl, w1, b1, w2, b2, activation, float(ff_scale),
            float(eps), float(rate1), float(rate2), int(seed), int(row_base))
    if wants_autograd(x2, g, bl, w1, b1, w2, b2):
        return _LnFfnResidual.apply(*args)
    return ln_ffn_residual_fwd(*args)


ln_ffn_residual.launches = 0
ln_ffn_residual.bwd_launches = 0


def ffn_forward_kernel(x2, w1, b1, w2, b2, activation, rate, seed,
                       row_base=0):
    """Launch ffn_fused's forward kernel on CUDA tensors (no autograd)."""
    check_args(x2, None, None, w1, b1, w2, b2, activation)
    y = torch.empty_like(x2)
    n, d = x2.shape
    if n == 0:
        return y
    rc = _lib().ffn_fused_fwd(
        1 if x2.dtype == torch.bfloat16 else 0, x2.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        y.data_ptr(), n, d, w1.shape[0], _ACTS[activation],
        *_masks(seed, rate, 0.0)[:3], _row_base(row_base), _stream(x2))
    if rc != 0:
        raise RuntimeError(f"ffn_fused kernel launch failed: cudaError {rc}")
    ffn_fused.launches += 1
    return y


def ffn_backward_kernel(x2, dy, w1, b1, w2, b2, activation, rate, seed,
                        row_base=0):
    """Launch ffn_fused's backward kernels on CUDA tensors → (dx, dw1,
    db1, dw2, db2): dx in x2's dtype, the weight gradients in fp32 (b2 is
    checked, not read)."""
    check_args(x2, None, None, w1, b1, w2, b2, activation)
    if dy.shape != x2.shape or dy.dtype != x2.dtype or \
            not dy.is_contiguous() or dy.device != x2.device:
        raise ValueError("dy must be a contiguous tensor like x2")
    n, d = x2.shape
    f = w1.shape[0]
    dtype = 1 if x2.dtype == torch.bfloat16 else 0
    f32 = dict(dtype=torch.float32, device=x2.device)
    new = torch.zeros if n == 0 else torch.empty   # the kernels write all
    dx = torch.empty_like(x2)
    dw1, dw2 = new(f, d, **f32), new(d, f, **f32)
    db1, db2 = new(f, **f32), new(d, **f32)
    if n == 0:
        return dx, dw1, db1, dw2, db2
    lib = _lib()
    words = lib.ffn_fused_bwd_workspace(dtype, n, d, f)
    if words == 0:
        raise ValueError(f"D={d} is not a width the backward kernel "
                         f"takes (bf16: 64, 128, 256)")
    ws = torch.empty(words, **f32)
    rc = lib.ffn_fused_bwd(
        dtype, x2.data_ptr(), dy.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
        dw2.data_ptr(), db2.data_ptr(), ws.data_ptr(), n, d, f,
        _ACTS[activation], *_masks(seed, rate, 0.0)[:3],
        _row_base(row_base), _stream(x2))
    if rc != 0:
        raise RuntimeError(f"ffn_fused backward kernel launch failed: "
                           f"cudaError {rc}")
    ffn_fused.bwd_launches += 1
    return dx, dw1, db1, dw2, db2


def ffn_backward_ref(x2, dy, w1, b1, w2, b2, activation, rate, seed,
                     row_base=0):
    """ffn_fused's plain backward: the plain forward's vector-Jacobian
    product by autograd (what the CPU path runs)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (x2, w1, b1, w2, b2)]
        y = ffn_fused_ref(*ins, activation, rate, seed, row_base)
        return torch.autograd.grad(y, ins, dy)


class _FfnFused(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, activation, rate, seed, row_base):
        ctx.cfg = (activation, rate, seed, row_base)
        ctx.save_for_backward(x2, w1, b1, w2, b2)
        if x2.device.type == "cpu":
            return ffn_fused_ref(x2, w1, b1, w2, b2, *ctx.cfg)
        return ffn_forward_kernel(x2, w1, b1, w2, b2, *ctx.cfg)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        dy = dy.to(saved[0].dtype).contiguous()
        if saved[0].device.type == "cpu":
            grads = ffn_backward_ref(saved[0], dy, *saved[1:], *ctx.cfg)
        else:
            grads = ffn_backward_kernel(saved[0], dy, *saved[1:], *ctx.cfg)
            grads = [gr.to(t.dtype) for gr, t in zip(grads, saved)]
        return (*grads, None, None, None, None)


@torch.library.custom_op("wenet_torch::ffn_fused_fwd", mutates_args=(),
                         device_types="cpu")
def ffn_fused_fwd(x2: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor, activation: str,
                  rate: float, seed: int, row_base: int = 0) -> torch.Tensor:
    """K6's forward as a registered operator: the plain version on the
    CPU, the kernel on the card."""
    return ffn_fused_ref(x2, w1, b1, w2, b2, activation, rate, seed,
                         row_base)


@ffn_fused_fwd.register_kernel("cuda")
def _(x2, w1, b1, w2, b2, activation, rate, seed, row_base=0):
    return ffn_forward_kernel(x2, w1, b1, w2, b2, activation, rate, seed,
                              row_base)


@ffn_fused_fwd.register_fake
def _(x2, *args):
    return torch.empty_like(x2)


def ffn_fused(x2, w1, b1, w2, b2, activation: str, rate: float = 0.0,
              seed: int = 0, row_base: int = 0):
    """drop(act(x2 @ w1^T + b1)) @ w2^T + b2.

    x2 [N, D] float32 or bfloat16; w1 [F, D] and w2 [D, F] in x2's dtype;
    b1, b2 float32; ``rate`` in [0, 1) on the hidden, its mask drawn from
    ``seed`` at x2's rows counted from ``row_base``. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (and, under
    autograd, the backward kernels) or raises.
    Without a gradient to take it runs the operator
    ``wenet_torch::ffn_fused_fwd``."""
    drop.threshold(rate)
    if x2.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x2.device}")
    args = (x2, w1, b1, w2, b2, activation, float(rate), int(seed),
            int(row_base))
    if wants_autograd(x2, w1, b1, w2, b2):
        return _FfnFused.apply(*args)
    return ffn_fused_fwd(*args)


ffn_fused.launches = 0
ffn_fused.bwd_launches = 0


def fwd_schedule(n: int, force: int = -1) -> int:
    """The bf16 forward's schedule at ``n`` rows: 1 when a block's two
    warpgroups share 64 rows, 0 when each takes 64 of 128. ``force`` 0 or
    1 imposes it on every later launch (to time both), -1 restores the
    choice from N."""
    return _lib().ln_ffn_residual_fwd_schedule(int(force), int(n))


def _lib() -> ctypes.CDLL:
    lib = load_library("ln_ffn_residual")
    if lib.ln_ffn_residual_fwd.argtypes is None:
        p, i, u, fl = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                       ctypes.c_float)
        masks = [u, i, fl, u, i, fl, u]   # two streams and the row base
        lib.ln_ffn_residual_fwd.argtypes = (
            [i] + [p] * 8 + [i] * 3 + [fl] * 2 + [i] + masks + [p])
        lib.ln_ffn_residual_fwd.restype = i
        lib.ln_ffn_residual_fwd_schedule.argtypes = [i, i]
        lib.ln_ffn_residual_fwd_schedule.restype = i
        lib.ln_ffn_residual_bwd_workspace.argtypes = [i] * 4
        lib.ln_ffn_residual_bwd_workspace.restype = ctypes.c_longlong
        lib.ln_ffn_residual_bwd.argtypes = (
            [i] + [p] * 16 + [i] * 3 + [fl] * 2 + [i] + masks + [p])
        lib.ln_ffn_residual_bwd.restype = i
        lib.ffn_fused_fwd.argtypes = ([i] + [p] * 6 + [i] * 4 + masks[:3]
                                      + [u, p])
        lib.ffn_fused_fwd.restype = i
        lib.ffn_fused_bwd_workspace.argtypes = [i] * 4
        lib.ffn_fused_bwd_workspace.restype = ctypes.c_longlong
        lib.ffn_fused_bwd.argtypes = (
            [i] + [p] * 11 + [i] * 4 + masks[:3] + [u, p])
        lib.ffn_fused_bwd.restype = i
    return lib
