"""Two stacked LSTM layers over a whole label sequence (K4).

``lstm2_seq`` is the port of ``wenet_celoss_tpu/ops/lstm_pallas.py::
lstm2_seq``, forward and backward, with the inter-layer dropout (mask
stream ``STREAM_LSTM_INTER`` of ``ops/dropout.py``, drawn at index
``(t * B + b) * H + j``; when a step's batch is split over processes, B
is the whole batch, ``global_b``, and b counts from the process's first
global row, ``row_base``). It is a ``torch.autograd.Function``: on CUDA
tensors its forward and backward launch the hand-written kernels in
``csrc/lstm2_seq.cu``; on CPU tensors they run ``lstm2_seq_ref``, the
plain PyTorch version with the same rounding points and mask (the
backward by autograd through it).

Gate order i, f, g, o, zero initial state, the layer-1 input projection
hoisted out (``xw1 = x @ Wi1^T + bh1``, the caller's). Weights are in
``torch.nn.Linear`` layout [4H, H] (the JAX kernel takes [H, 4H]); they
may be fp32 parameters and are cast to ``xw1``'s dtype inside, so their
gradients come back in fp32 (the JAX wrapper casts before the kernel and
so rounds them to bf16). Unlike the TPU kernel, which recomputes the
states into bf16 scratch, the card's forward saves the gate
pre-activations and cell states in fp32 for the backward.

The bf16 kernels take H in ``BF16_WIDTHS`` (a cluster of 8 CTAs splits
the hidden units, each wgmma-sized); ``check_args`` refuses any other
bf16 width before a launch, on any device. fp32 takes a multiple of 16
whose states fit a block's shared memory (asked of the library at
launch).
"""

from __future__ import annotations

import ctypes

import torch

from wenet_celoss_tpu_torch.ops import dropout as drop
from wenet_celoss_tpu_torch.ops._build import load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BF16_WIDTHS = (64, 128, 256)   # the widths the bf16 kernels take


def lstm2_seq_ref(xw1, wh1, wi2, bh2, wh2, rate: float = 0.0,
                  seed: int = 0, row_base: int = 0,
                  global_b: int = 0) -> torch.Tensor:
    """Plain version: [B, U, 4H] → layer 2's h [B, U, H] in xw1's dtype.

    h is carried in the compute dtype, c and the gates in fp32; each
    matmul takes compute-dtype operands and accumulates in fp32; the
    inter-layer dropout applies to layer 1's fp32 h before the cast.
    Differentiable by autograd."""
    cdt = xw1.dtype
    af = torch.promote_types(cdt, torch.float32)
    b, u, g4 = xw1.shape
    h = g4 // 4
    gb = global_b or b
    w1, w2i, w2h = (w.to(cdt).to(af).t() for w in (wh1, wi2, wh2))
    h1 = h2 = torch.zeros(b, h, dtype=cdt, device=xw1.device)
    c1 = c2 = torch.zeros(b, h, dtype=af, device=xw1.device)
    outs = []
    for t in range(u):
        z1 = xw1[:, t].to(af) + h1.to(af) @ w1
        c1, h1n = _cell(z1, c1)
        h1 = h1n.to(cdt)
        d = drop.apply_mask(h1n, seed, drop.STREAM_LSTM_INTER, rate,
                            offset=(t * gb + row_base) * h).to(cdt)
        z2 = bh2.to(af) + d.to(af) @ w2i + h2.to(af) @ w2h
        c2, h2n = _cell(z2, c2)
        h2 = h2n.to(cdt)
        outs.append(h2)
    return torch.stack(outs, dim=1)


def _cell(z, c):
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


def check_args(xw1, wh1, wi2, bh2, wh2):
    """Raise on what the kernels do not take: layout, dtype, a bf16 width
    outside ``BF16_WIDTHS``, shapes and devices that differ (``on_card``
    adds that the device is a card and asks the library about fp32
    widths)."""
    if xw1.dim() != 3 or xw1.shape[2] % 4:
        raise ValueError(f"xw1 must be [B, U, 4H], got {tuple(xw1.shape)}")
    if xw1.dtype not in _DTYPES:
        raise TypeError(f"xw1 dtype {xw1.dtype} not supported")
    h = xw1.shape[2] // 4
    if xw1.dtype == torch.bfloat16 and h not in BF16_WIDTHS:
        raise ValueError(f"H={h} is not a width the bf16 kernels take "
                         f"{BF16_WIDTHS}")
    for name, t, shape in (("wh1", wh1, (4 * h, h)), ("wi2", wi2, (4 * h, h)),
                           ("wh2", wh2, (4 * h, h)), ("bh2", bh2, (4 * h,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if t.device != xw1.device:
            raise ValueError(f"{name} is on {t.device}, xw1 on {xw1.device}")


def on_card(xw1, wh1, wi2, bh2, wh2):
    """check_args, that the tensors lie on a card, and that the library
    takes the width: what every launch runs first."""
    check_args(xw1, wh1, wi2, bh2, wh2)
    if xw1.device.type != "cuda":
        raise ValueError("the kernels take CUDA tensors")
    h = xw1.shape[2] // 4
    if not _lib().lstm2_seq_fits(_DTYPES[xw1.dtype], h):
        raise ValueError(f"H={h} is not taken by the kernels (a multiple "
                         f"of 16 whose states fit shared memory)")


def _operands(xw1, wh1, wi2, bh2, wh2):
    cdt = xw1.dtype
    ws = [w.to(cdt).contiguous() for w in (wh1, wi2, wh2)]
    for w in [xw1] + ws:
        if not w.is_contiguous() or w.data_ptr() % 32:
            raise ValueError("operands must be contiguous and 32-byte "
                             "aligned")
    return xw1, ws, bh2.float().contiguous()


def _mask_args(rate: float, seed: int, row_base: int, global_b: int, b: int):
    """(key, threshold, scale, first global row, whole batch) for the
    kernels; global_b 0 is the local batch."""
    if row_base < 0 or (global_b and global_b < row_base + b):
        raise ValueError(f"rows [{row_base}, {row_base + b}) are not rows "
                         f"of a {global_b}-row batch")
    thresh, scale = drop.threshold(rate)
    return [drop.stream_key(seed, drop.STREAM_LSTM_INTER), thresh, scale,
            int(row_base) & drop.M32, int(global_b)]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def forward_kernel(xw1, wh1, wi2, bh2, wh2, rate=0.0, seed=0,
                   save: bool = False, row_base: int = 0, global_b: int = 0):
    """Launch the forward kernels → (y, saved states or None).

    The saved states are zs [2, B, U, 4H] and cs [2, B, U, H] in fp32,
    hs [2, B, U, H] (slot t: the h that step t read, h[t - 1]; slot 0
    zero) and ds [B, U, H] in the compute dtype."""
    on_card(xw1, wh1, wi2, bh2, wh2)
    xw1, (w1, w2i, w2h), bh2 = _operands(xw1, wh1, wi2, bh2, wh2)
    b, u, g4 = xw1.shape
    h = g4 // 4
    dt, dev = xw1.dtype, xw1.device
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty(b, u, h, dtype=dt, device=dev)
    ds = torch.empty(b, u, h, dtype=dt, device=dev)
    saved = None
    ptrs = [None] * 3
    if save:
        saved = (torch.empty(2, b, u, g4, **f32),
                 torch.empty(2, b, u, h, **f32),
                 torch.empty(2, b, u, h, dtype=dt, device=dev), ds)
        ptrs = [s.data_ptr() for s in saved[:3]]
    if b and u:
        lib = _lib()
        ws = torch.empty(lib.lstm2_seq_fwd_workspace(_DTYPES[dt], b, u, h),
                         **f32)
        rc = lib.lstm2_seq_fwd(
            _DTYPES[dt], xw1.data_ptr(), w1.data_ptr(), w2i.data_ptr(),
            bh2.data_ptr(), w2h.data_ptr(), y.data_ptr(), *ptrs,
            ds.data_ptr(), ws.data_ptr() if ws.numel() else None, b, u, h,
            *_mask_args(rate, seed, row_base, global_b, b), _stream(xw1))
        if rc != 0:
            raise RuntimeError(f"lstm2_seq kernel launch failed: "
                               f"cudaError {rc}")
        lstm2_seq.launches += 1
    return y, saved


def backward_kernel(dy, xw1, wh1, wi2, bh2, wh2, saved, rate=0.0, seed=0,
                    row_base: int = 0, global_b: int = 0):
    """Launch the backward kernels → (dxw1 in xw1's dtype, dwh1, dwi2,
    dbh2, dwh2 in fp32)."""
    on_card(xw1, wh1, wi2, bh2, wh2)
    xw1, (w1, w2i, w2h), _ = _operands(xw1, wh1, wi2, bh2, wh2)
    b, u, g4 = xw1.shape
    h = g4 // 4
    if dy.shape != (b, u, h) or dy.dtype != xw1.dtype or \
            not dy.is_contiguous() or dy.device != xw1.device:
        raise ValueError("dy must be a contiguous [B, U, H] tensor in "
                         "xw1's dtype")
    f32 = dict(dtype=torch.float32, device=xw1.device)
    dxw1 = torch.zeros_like(xw1)
    dw = torch.zeros(3, g4, h, **f32)
    dbh2 = torch.zeros(g4, **f32)
    if b and u:
        lib = _lib()
        ws = torch.empty(lib.lstm2_seq_bwd_workspace(_DTYPES[xw1.dtype], b,
                                                     u, h), **f32)
        dz2c = torch.empty_like(xw1)
        zs, cs, hs, ds = saved
        rc = lib.lstm2_seq_bwd(
            _DTYPES[xw1.dtype], dy.data_ptr(), w1.data_ptr(), w2i.data_ptr(),
            w2h.data_ptr(), zs.data_ptr(), cs.data_ptr(), hs.data_ptr(),
            ds.data_ptr(), dxw1.data_ptr(), dw.data_ptr(), dbh2.data_ptr(),
            ws.data_ptr(), dz2c.data_ptr(), b, u, h,
            *_mask_args(rate, seed, row_base, global_b, b), _stream(xw1))
        if rc != 0:
            raise RuntimeError(f"lstm2_seq backward kernel launch failed: "
                               f"cudaError {rc}")
        lstm2_seq.bwd_launches += 1
    return dxw1, dw[0], dw[1], dbh2, dw[2]


def backward_ref(dy, xw1, wh1, wi2, bh2, wh2, rate=0.0, seed=0, row_base=0,
                 global_b=0):
    """The plain backward: autograd through the plain forward."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (xw1, wh1, wi2, bh2, wh2)]
        y = lstm2_seq_ref(*ins, rate=rate, seed=seed, row_base=row_base,
                          global_b=global_b)
        return torch.autograd.grad(y, ins, dy)


class _Lstm2Seq(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xw1, wh1, wi2, bh2, wh2, rate, seed, row_base,
                global_b):
        ctx.cfg = (rate, seed, row_base, global_b)
        if xw1.device.type == "cpu":
            ctx.save_for_backward(xw1, wh1, wi2, bh2, wh2)
            return lstm2_seq_ref(xw1, wh1, wi2, bh2, wh2, rate, seed,
                                 row_base, global_b)
        y, saved = forward_kernel(xw1, wh1, wi2, bh2, wh2, rate, seed,
                                  save=any(ctx.needs_input_grad),
                                  row_base=row_base, global_b=global_b)
        ctx.save_for_backward(xw1, wh1, wi2, bh2, wh2,
                              *(saved if saved is not None else ()))
        return y

    @staticmethod
    def backward(ctx, dy):
        xw1, wh1, wi2, bh2, wh2, *saved = ctx.saved_tensors
        dy = dy.to(xw1.dtype).contiguous()
        if xw1.device.type == "cpu":
            grads = backward_ref(dy, xw1, wh1, wi2, bh2, wh2, *ctx.cfg)
        else:
            grads = backward_kernel(dy, xw1, wh1, wi2, bh2, wh2, saved,
                                    *ctx.cfg)
            grads = [g.to(t.dtype) for g, t in
                     zip(grads, (xw1, wh1, wi2, bh2, wh2))]
        return (*grads, None, None, None, None)


def lstm2_seq(xw1, wh1, wi2, bh2, wh2, rate: float = 0.0, seed: int = 0,
              row_base: int = 0, global_b: int = 0):
    """Two stacked LSTM layers from a zero state → layer 2's h [B, U, H].

    xw1 [B, U, 4H] (float32 or bfloat16, the compute dtype); wh1, wi2,
    wh2 [4H, H] and bh2 [4H] (any float dtype; cast inside); inter-layer
    dropout ``rate`` in [0, 1) with masks drawn from ``seed`` at rows
    ``row_base`` onward of a ``global_b``-row batch (0: xw1's own batch;
    the module docstring). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (and,
    under autograd, the backward kernels) or raises."""
    drop.threshold(rate)
    if xw1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xw1.device}")
    return _Lstm2Seq.apply(xw1, wh1, wi2, bh2, wh2, float(rate), int(seed),
                           int(row_base), int(global_b))


lstm2_seq.launches = 0
lstm2_seq.bwd_launches = 0


def _lib() -> ctypes.CDLL:
    lib = load_library("lstm2_seq")
    if lib.lstm2_seq_fwd.argtypes is None:
        p, i, u, fl = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                       ctypes.c_float)
        lib.lstm2_seq_fits.argtypes = [i, i]
        lib.lstm2_seq_fits.restype = i
        lib.lstm2_seq_fwd_workspace.argtypes = [i] * 4
        lib.lstm2_seq_fwd_workspace.restype = ctypes.c_longlong
        lib.lstm2_seq_fwd.argtypes = ([i] + [p] * 11 + [i] * 3
                                      + [u, i, fl, u, i, p])
        lib.lstm2_seq_fwd.restype = i
        lib.lstm2_seq_bwd_workspace.argtypes = [i] * 4
        lib.lstm2_seq_bwd_workspace.restype = ctypes.c_longlong
        lib.lstm2_seq_bwd.argtypes = ([i] + [p] * 13 + [i] * 3
                                      + [u, i, fl, u, i, p])
        lib.lstm2_seq_bwd.restype = i
    return lib
