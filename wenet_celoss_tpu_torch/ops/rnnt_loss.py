"""RNN-T losses (port of ``wenet_celoss_tpu/ops/rnnt_loss.py`` and of the
lattice kernel of ``ops/rnnt_pallas.py``).

The streaming loss (``rnnt_loss_streaming``, the flagship's): the
[B, T, U+1, V] joint never exists. The joint's output layer is applied to
the projected streams ``enc_j`` [B, T, H] and ``pred_j`` [B, U+1, H] and
reduced at once to three [B, T, U+1] fp32 planes, the blank and label
log-probs and the log-normaliser:

- K2 (``joint_planes``, the port of ``ops/rnnt_pallas.py::
  streaming_joint_planes_fwd``): on CUDA tensors the kernel of
  ``csrc/rnnt_joint.cu``; on CPU tensors ``joint_planes_ref``, the chunked
  plain version (the JAX package's ``_streaming_chunked_planes``);
- K3 (``joint_planes_bwd``, the port of ``streaming_joint_planes_bwd``):
  the analytic backward from the transition occupancies, the kernel or
  ``joint_planes_bwd_ref`` (the JAX package's chunked backward);
- K9 (``alpha_beta``, the port of ``ops/rnnt_pallas.py::
  alpha_beta_pallas``): alpha and beta over the lattice in one launch of
  ``csrc/rnnt_lattice.cu``; on CPU tensors ``alpha_scan`` and
  ``beta_scan``, the plain wavefronts over the T + U anti-diagonals.

``rnnt_loss_streaming`` is one ``torch.autograd.Function``: forward = K2,
then K9; backward = the occupancies from the saved alpha and beta
(elementwise), then K3.

The losses on materialised logits [B, T, U+1, V] (``rnnt_impl`` scan,
fused and pallas): ``rnnt_loss`` (gradient by autograd through the plain
lattice) and ``rnnt_loss_pallas`` (K9, loss -beta[0, 0], the closed-form
occupancy gradient), which serves both "fused" and "pallas".

K9 runs alpha and beta side by side, each on a chain of warps (64 lattice
columns a warp, more on a row's 32 warps above U1 = 2048, U1 up to 8192),
from the row's planes staged in shared memory where they fit and from
per-lane rings of diagonals where they do not (the kernel chooses by
the row's size).

The pruned loss (``rnnt_impl: "pruned"``, the k2 formulation):
``rnnt_loss_simple`` over the factored joint am[t, v] + lm[u, v]
(``factored_planes``; its log-normaliser is one matmul) runs its lattice
through K9 (``_RnntLossSimple``: the loss from alpha, the gradient of the
planes minus the occupancies); ``get_rnnt_prune_ranges`` picks each
frame's window of ``s_range`` label positions from the simple lattice's
emit occupancies; ``rnnt_loss_pruned`` runs the exact lattice over the
[B, T, S, V] joint of those windows. The pruned lattice is plain torch
(autograd through a frame loop with the S window positions unrolled), as
the JAX package composes it in XLA outside any Pallas kernel.
``rnnt_loss_simple_and_ranges`` gives the loss and the ranges from one K9
launch.

The output layer's weight is in ``torch.nn.Linear`` layout [V, H] (the JAX
package's kernel is [H, V]); labels are [B, U] ids (0 where padded), not
the TPU kernels' one-hot. Activations: tanh, relu, swish.
"""

from __future__ import annotations

import ctypes

import torch

from wenet_celoss_tpu_torch.ops._build import load_library
from wenet_celoss_tpu_torch.utils.common import LOG_ZERO

ACTS = {"tanh": 0, "relu": 1, "swish": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Joint widths H the bf16 kernels take (wgmma tiles of H/2 a warpgroup):
# the flagship's 2 * 256 and the tiny configs' 2 * 64.
BF16_WIDTHS = (128, 512)


def _act(name: str, pre: torch.Tensor) -> torch.Tensor:
    """The activation in pre's dtype (swish as two rounded steps,
    ``pre * sigmoid(pre)``, as the JAX package writes it)."""
    if name == "tanh":
        return torch.tanh(pre)
    if name == "relu":
        return torch.clamp_min(pre, 0.0)
    if name == "swish":
        return pre * torch.sigmoid(pre)
    raise ValueError(f"unsupported joint activation: {name}")


def _act_grad(name: str, pre: torch.Tensor, h: torch.Tensor):
    """d act / d pre in the compute dtype, every step rounded there as in
    the JAX package: tanh' = 1 - h*h from the activation h; relu' = pre > 0;
    swish' = s * (1 + pre * (1 - s)), s = sigmoid(pre)."""
    if name == "tanh":
        return 1.0 - h * h
    if name == "relu":
        return (pre > 0).to(h.dtype)
    s = torch.sigmoid(pre)
    return s * (1.0 + pre * (1.0 - s))


def _chunk_logits(enc_c, pred_j, w, b, activation):
    """pre, hidden [B, Tc, U1, H] in the compute dtype and the fp32 logits
    [B, Tc, U1, V] (compute-dtype operands, fp32 accumulation)."""
    af = torch.promote_types(enc_c.dtype, torch.float32)
    pre = enc_c[:, :, None, :] + pred_j[:, None, :, :]
    hidden = _act(activation, pre)
    logits = hidden.to(af) @ w.to(af).t() + b.to(af)
    return pre, hidden, logits


def joint_planes_ref(enc_j, pred_j, w, b, labels, blank: int,
                     activation: str, chunk: int = 16):
    """K2's plain version: (blank_lp, emit_lp, lse) [B, T, U1] fp32 from
    enc_j [B, T, H], pred_j [B, U1, H], w [V, H] (all in the compute
    dtype), b [V] fp32 and labels [B, U1 - 1], chunked over T. emit_lp's
    row U is the blank column's (the caller overwrites it)."""
    bsz, t_max, _ = enc_j.shape
    u1 = pred_j.shape[1]
    lab = torch.cat([labels.long(), torch.full((bsz, 1), blank,
                                               dtype=torch.long,
                                               device=labels.device)], 1)
    out = [[], [], []]
    for t0 in range(0, t_max, chunk):
        _, _, logits = _chunk_logits(enc_j[:, t0:t0 + chunk], pred_j, w, b,
                                     activation)
        m = logits.max(dim=-1, keepdim=True).values
        lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
        idx = lab[:, None, :, None].expand(-1, logits.shape[1], -1, 1)
        out[0].append(logits[..., blank] - lse)
        out[1].append(torch.gather(logits, -1, idx)[..., 0] - lse)
        out[2].append(lse)
    return tuple(torch.cat(o, dim=1).float() for o in out)


def joint_planes_bwd_ref(enc_j, pred_j, w, b, labels, gb, ge, lse,
                         blank: int, activation: str, chunk: int = 16):
    """K3's plain version: (denc [B,T,H], dpred [B,U1,H], dw [V,H],
    db [V]) fp32 from K2's inputs, the saved lse and the plane gradients
    gb, ge [B, T, U1] (0 on invalid cells), chunked over T:

        dlogits = (gb + ge) exp(logits - lse) - gb 1[blank] - ge 1[label]
        dpre = (cdt(dlogits) @ w) * act'(pre)   (act' in the compute dtype)

    with denc, dpred the sums of dpre over U and T, dw the sum of
    cdt(dlogits)^T hidden and db of dlogits, all in fp32."""
    bsz, t_max, h = enc_j.shape
    u1 = pred_j.shape[1]
    v = w.shape[0]
    cdt = enc_j.dtype
    af = torch.promote_types(cdt, torch.float32)
    lab = torch.cat([labels.long(), torch.zeros(bsz, 1, dtype=torch.long,
                                                device=labels.device)], 1)
    ge_lab = ge.clone()
    ge_lab[..., u1 - 1] = 0.0          # row U has no label
    denc = []
    dpred = torch.zeros(bsz, u1, h, dtype=af, device=enc_j.device)
    dw = torch.zeros(v, h, dtype=af, device=enc_j.device)
    db = torch.zeros(v, dtype=af, device=enc_j.device)
    for t0 in range(0, t_max, chunk):
        sl = slice(t0, t0 + chunk)
        pre, hidden, logits = _chunk_logits(enc_j[:, sl], pred_j, w, b,
                                            activation)
        gbc, gec = gb[:, sl].to(af), ge[:, sl].to(af)
        dl = (gbc + gec)[..., None] * torch.exp(logits
                                                 - lse[:, sl, :, None])
        dl[..., blank] -= gbc
        idx = lab[:, None, :, None].expand(-1, dl.shape[1], -1, 1)
        dl.scatter_add_(-1, idx, -ge_lab[:, sl].to(af)[..., None])
        dlc = dl.to(cdt)
        dpre = (dlc.to(af) @ w.to(af)) * _act_grad(activation, pre,
                                                   hidden).to(af)
        denc.append(dpre.sum(2))
        dpred += dpre.sum(1)
        dw += torch.einsum("btuv,btuh->vh", dlc.to(af), hidden.to(af))
        db += dl.sum((0, 1, 2))
    return torch.cat(denc, 1).float(), dpred.float(), dw.float(), db.float()


def _check(enc_j, pred_j, w, b, labels, activation):
    if enc_j.dim() != 3 or pred_j.dim() != 3 or w.dim() != 2:
        raise ValueError("enc_j [B, T, H], pred_j [B, U1, H], w [V, H]")
    bsz, _, h = enc_j.shape
    u1 = pred_j.shape[1]
    if enc_j.dtype not in _DTYPES:
        raise TypeError(f"dtype {enc_j.dtype} not supported")
    if activation not in ACTS:
        raise ValueError(f"unsupported joint activation: {activation}")
    if h % 16:
        raise ValueError(f"H={h} must be a multiple of 16")
    if enc_j.dtype == torch.bfloat16 and h not in BF16_WIDTHS:
        raise ValueError(f"H={h} is not a width the bf16 kernels take "
                         f"{BF16_WIDTHS}")
    shapes = {"pred_j": (pred_j, (bsz, u1, h)), "w": (w, (w.shape[0], h)),
              "b": (b, (w.shape[0],)), "labels": (labels, (bsz, u1 - 1))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    for name, t in (("pred_j", pred_j), ("w", w)):
        if t.dtype != enc_j.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != {enc_j.dtype}")
    if b.dtype != torch.float32:
        raise TypeError("b must be float32")
    for name, t in (("enc_j", enc_j), ("pred_j", pred_j), ("w", w), ("b", b),
                    ("labels", labels)):
        if t.device != enc_j.device:
            raise ValueError(f"{name} is on {t.device}, enc_j on "
                             f"{enc_j.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    if enc_j.device.type != "cuda":
        raise ValueError("the kernels take CUDA tensors")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def joint_planes_kernel(enc_j, pred_j, w, b, labels, blank: int,
                        activation: str):
    """Launch K2 on CUDA tensors → (blank_lp, emit_lp, lse) [B, T, U1]."""
    labels = labels.to(torch.int32).contiguous()
    _check(enc_j, pred_j, w, b, labels, activation)
    bsz, t_max, h = enc_j.shape
    u1, v = pred_j.shape[1], w.shape[0]
    planes = torch.empty(3, bsz, t_max, u1, dtype=torch.float32,
                         device=enc_j.device)
    if planes.numel():
        rc = _lib().rnnt_joint_fwd(
            _DTYPES[enc_j.dtype], ACTS[activation], enc_j.data_ptr(),
            pred_j.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
            planes[0].data_ptr(), planes[1].data_ptr(), planes[2].data_ptr(),
            bsz, t_max, u1, h, v, blank, _stream(enc_j))
        if rc != 0:
            raise RuntimeError(f"rnnt_joint kernel launch failed: "
                               f"cudaError {rc}")
        joint_planes.launches += 1
    return planes[0], planes[1], planes[2]


def joint_planes_bwd_kernel(enc_j, pred_j, w, b, labels, gb, ge, lse,
                            blank: int, activation: str):
    """Launch K3 on CUDA tensors → (denc, dpred, dw, db) fp32."""
    labels = labels.to(torch.int32).contiguous()
    _check(enc_j, pred_j, w, b, labels, activation)
    bsz, t_max, h = enc_j.shape
    u1, v = pred_j.shape[1], w.shape[0]
    for name, t in (("gb", gb), ("ge", ge), ("lse", lse)):
        if tuple(t.shape) != (bsz, t_max, u1) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != enc_j.device:
            raise ValueError(f"{name} must be a contiguous fp32 "
                             f"[B, T, U1] tensor on {enc_j.device}")
    f32 = dict(dtype=torch.float32, device=enc_j.device)
    denc = torch.zeros(bsz, t_max, h, **f32)
    dpred = torch.zeros(bsz, u1, h, **f32)
    dw, db = torch.zeros(v, h, **f32), torch.zeros(v, **f32)
    if gb.numel():
        lib = _lib()
        words = lib.rnnt_joint_bwd_workspace(_DTYPES[enc_j.dtype], bsz,
                                             t_max, u1, h, v)
        if words == 0:
            raise ValueError(f"H={h} is not taken by the backward kernel "
                             f"(its fp32 tiles must fit shared memory)")
        if words < 0:
            raise RuntimeError("rnnt_joint backward: a CUDA query failed "
                               "while sizing its workspace")
        ws = torch.empty(words, **f32)
        rc = lib.rnnt_joint_bwd(
            _DTYPES[enc_j.dtype], ACTS[activation], enc_j.data_ptr(),
            pred_j.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
            gb.data_ptr(), ge.data_ptr(), lse.data_ptr(), denc.data_ptr(),
            dpred.data_ptr(), dw.data_ptr(), db.data_ptr(), ws.data_ptr(),
            bsz, t_max, u1, h, v, blank, _stream(enc_j))
        if rc != 0:
            raise RuntimeError(f"rnnt_joint backward kernel launch failed: "
                               f"cudaError {rc}")
        joint_planes_bwd.launches += 1
    return denc, dpred, dw, db


def joint_planes(enc_j, pred_j, w, b, labels, blank: int, activation: str,
                 chunk: int = 16):
    """K2: the kernel for a CUDA tensor, the plain version for a CPU one."""
    if enc_j.device.type == "cpu":
        return joint_planes_ref(enc_j, pred_j, w, b, labels, blank,
                                activation, chunk)
    return joint_planes_kernel(enc_j, pred_j, w, b, labels, blank,
                               activation)


def joint_planes_bwd(enc_j, pred_j, w, b, labels, gb, ge, lse, blank: int,
                     activation: str, chunk: int = 16):
    """K3: the kernel for a CUDA tensor, the plain version for a CPU one."""
    if enc_j.device.type == "cpu":
        return joint_planes_bwd_ref(enc_j, pred_j, w, b, labels, gb, ge,
                                    lse, blank, activation, chunk)
    return joint_planes_bwd_kernel(enc_j, pred_j, w, b, labels, gb, ge, lse,
                                   blank, activation)


joint_planes.launches = 0
joint_planes_bwd.launches = 0


# ------------------------------------------------------------- lattice ---

def _diag_index(t_max: int, u1: int, device, shift: int):
    """For diagonal d and column u: t = d - u + shift, clamped, and
    whether d - u lies in [0, T)."""
    d = torch.arange(t_max + u1 - 1, device=device)[:, None]
    u = torch.arange(u1, device=device)[None, :]
    t_of = d - u
    return (t_of + shift).clamp(0, t_max - 1), (t_of >= 0) & (t_of < t_max)


def alpha_scan(blank_lp, emit_lp):
    """Forward wavefront over the T + U anti-diagonals: alpha [B, T, U1],
    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
    alpha[t, u-1] + emit[t, u-1]); invalid cells LOG_ZERO."""
    b, t_max, u1 = blank_lp.shape
    dev = blank_lp.device
    t_prev, valid = _diag_index(t_max, u1, dev, -1)
    t_here, _ = _diag_index(t_max, u1, dev, 0)
    uu = torch.arange(u1, device=dev)
    blank_d = blank_lp[:, t_prev, uu]                    # [B, D, U1]
    emit_d = torch.full_like(blank_d, LOG_ZERO)
    if u1 > 1:
        emit_d[:, :, 1:] = emit_lp[:, t_here[:, 1:], uu[:-1]]
    zero_col = torch.full((b, 1), LOG_ZERO, device=dev)
    prev = torch.full((b, u1), LOG_ZERO, device=dev)
    prev[:, 0] = 0.0
    diags = [prev]
    for d in range(1, t_max + u1 - 1):
        new = torch.logaddexp(prev + blank_d[:, d],
                              torch.cat([zero_col, prev[:, :-1]], 1)
                              + emit_d[:, d])
        prev = torch.where(valid[d], new, LOG_ZERO)
        diags.append(prev)
    diags = torch.stack(diags, 1)                        # [B, D, U1]
    tt = torch.arange(t_max, device=dev)[:, None] + uu[None, :]
    return diags[:, tt, uu]


def beta_scan(blank_lp, emit_lp, input_lengths, label_lengths):
    """Reverse wavefront: beta[t, u] = log P(reach the final blank | t, u);
    beta(T_b-1, U_b) = blank(T_b-1, U_b); invalid cells LOG_ZERO."""
    b, t_max, u1 = blank_lp.shape
    dev = blank_lp.device
    t_here, _ = _diag_index(t_max, u1, dev, 0)
    uu = torch.arange(u1, device=dev)
    d_all = torch.arange(t_max + u1 - 1, device=dev)
    blank_d = blank_lp[:, t_here, uu]                    # [B, D, U1]
    emit_d = emit_lp[:, t_here, uu]
    t_last = (input_lengths - 1)[:, None]
    u_last = label_lengths[:, None]
    last_col = torch.full((b, 1), LOG_ZERO, device=dev)
    prev = torch.full((b, u1), LOG_ZERO, device=dev)
    diags = [None] * (t_max + u1 - 1)
    for d in range(t_max + u1 - 2, -1, -1):
        t_of = d_all[d] - uu[None, :]
        blank_here = blank_d[:, d]
        blank_term = blank_here + torch.where(t_of + 1 <= t_last, prev,
                                              LOG_ZERO)
        is_term = (t_of == t_last) & (uu[None, :] == u_last)
        blank_term = torch.where(is_term, blank_here, blank_term)
        prev_up = torch.cat([prev[:, 1:], last_col], 1)
        emit_term = emit_d[:, d] + torch.where(uu[None, :] + 1 <= u_last,
                                               prev_up, LOG_ZERO)
        new = torch.logaddexp(blank_term, emit_term)
        valid = (t_of >= 0) & (t_of <= t_last) & (uu[None, :] <= u_last)
        prev = torch.where(valid, new, LOG_ZERO)
        diags[d] = prev
    diags = torch.stack(diags, 1)
    tt = torch.arange(t_max, device=dev)[:, None] + uu[None, :]
    return diags[:, tt, uu]


def occupancies(blank_lp, emit_lp, alpha, beta, input_lengths,
                label_lengths):
    """Blank and emit transition occupancies [B, T, U1] (posterior
    expected counts of each lattice edge) from the planes and the given
    alpha and beta (elementwise)."""
    b, t_max, u1 = blank_lp.shape
    dev = blank_lp.device
    log_z = beta[:, 0, 0][:, None, None]
    t_idx = torch.arange(t_max, device=dev)[None, :, None]
    u_idx = torch.arange(u1, device=dev)[None, None, :]
    t_last = (input_lengths - 1)[:, None, None]
    u_last = label_lengths[:, None, None]
    in_lattice = (t_idx <= t_last) & (u_idx <= u_last)
    beta_down = torch.cat([beta[:, 1:], torch.full((b, 1, u1), LOG_ZERO,
                                                   device=dev)], 1)
    beta_down = torch.where((t_idx == t_last) & (u_idx == u_last), 0.0,
                            torch.where(t_idx < t_last, beta_down, LOG_ZERO))
    occ_b = torch.exp(torch.where(in_lattice,
                                  alpha + blank_lp + beta_down - log_z,
                                  LOG_ZERO))
    beta_right = torch.cat([beta[:, :, 1:], torch.full(
        (b, t_max, 1), LOG_ZERO, device=dev)], 2)
    occ_e = torch.exp(torch.where(in_lattice & (u_idx < u_last),
                                  alpha + emit_lp + beta_right - log_z,
                                  LOG_ZERO))
    return occ_b, occ_e


# Columns the lattice kernel takes: 8 a lane, 32 warps of a block.
MAX_U1 = 8192


def alpha_beta_ref(blank_lp, emit_lp, input_lengths, label_lengths):
    """K9's plain version: (alpha_scan, beta_scan)."""
    return (alpha_scan(blank_lp, emit_lp),
            beta_scan(blank_lp, emit_lp, input_lengths, label_lengths))


def alpha_beta_kernel(blank_lp, emit_lp, input_lengths, label_lengths):
    """Launch K9 on CUDA tensors → (alpha, beta) [B, T, U1] fp32."""
    if blank_lp.dim() != 3 or emit_lp.shape != blank_lp.shape:
        raise ValueError("blank_lp and emit_lp must be [B, T, U1] alike")
    bsz, t_max, u1 = blank_lp.shape
    if u1 > MAX_U1:
        raise ValueError(f"U1={u1} is above the lattice kernel's {MAX_U1}")
    lens = [input_lengths.to(torch.int32).contiguous(),
            label_lengths.to(torch.int32).contiguous()]
    for name, t in (("blank_lp", blank_lp), ("emit_lp", emit_lp)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 tensor")
    for name, t in (("blank_lp", blank_lp), ("emit_lp", emit_lp),
                    ("input_lengths", lens[0]), ("label_lengths", lens[1])):
        if t.device.type != "cuda" or t.device != blank_lp.device:
            raise ValueError(f"{name} must lie on {blank_lp.device} (CUDA)")
    for name, t in zip(("input_lengths", "label_lengths"), lens):
        if tuple(t.shape) != (bsz,):
            raise ValueError(f"{name} shape {tuple(t.shape)} != ({bsz},)")
    alpha, beta = torch.empty_like(blank_lp), torch.empty_like(blank_lp)
    if blank_lp.numel():
        rc = _lattice_lib().rnnt_lattice(
            blank_lp.data_ptr(), emit_lp.data_ptr(), lens[0].data_ptr(),
            lens[1].data_ptr(), alpha.data_ptr(), beta.data_ptr(), bsz,
            t_max, u1, _stream(blank_lp))
        if rc != 0:
            raise RuntimeError(f"rnnt_lattice kernel launch failed: "
                               f"cudaError {rc}")
        alpha_beta.launches += 1
    return alpha, beta


def alpha_beta(blank_lp, emit_lp, input_lengths, label_lengths):
    """K9: alpha (masked by t < T only) and beta (masked by t < T_b and
    u <= U_b, terminal cell the final blank) [B, T, U1] fp32 from the
    planes and the lengths; invalid cells LOG_ZERO. The kernel for a CUDA
    tensor, ``alpha_beta_ref`` for a CPU one."""
    if blank_lp.device.type == "cpu":
        return alpha_beta_ref(blank_lp, emit_lp, input_lengths,
                              label_lengths)
    return alpha_beta_kernel(blank_lp, emit_lp, input_lengths,
                             label_lengths)


alpha_beta.launches = 0


def _final(plane, input_lengths, label_lengths):
    b = plane.shape[0]
    t_last = (input_lengths - 1).clamp_min(0)
    return plane[torch.arange(b, device=plane.device), t_last, label_lengths]


class _RnntLossStreaming(torch.autograd.Function):

    @staticmethod
    def forward(ctx, enc_j, pred_j, w, b, labels, input_lengths,
                label_lengths, blank, activation, chunk):
        cdt = enc_j.dtype
        pred_c = pred_j.to(cdt).contiguous()
        w_c = w.to(cdt).contiguous()
        b_f = b.float().contiguous()
        u1 = pred_j.shape[1]
        labels = labels[:, :u1 - 1]
        blank_lp, emit_lp, lse = joint_planes(enc_j, pred_c, w_c, b_f,
                                              labels, blank, activation,
                                              chunk)
        emit_lp[..., u1 - 1] = LOG_ZERO
        alpha, beta = alpha_beta(blank_lp, emit_lp, input_lengths,
                                 label_lengths)
        loss = -(_final(alpha, input_lengths, label_lengths)
                 + _final(blank_lp, input_lengths, label_lengths))
        ctx.cfg = (blank, activation, chunk, pred_j.dtype, w.dtype, b.dtype)
        ctx.save_for_backward(enc_j, pred_c, w_c, b_f, labels, input_lengths,
                              label_lengths, blank_lp, emit_lp, lse, alpha,
                              beta)
        return loss

    @staticmethod
    def backward(ctx, g):
        (enc_j, pred_c, w_c, b_f, labels, input_lengths, label_lengths,
         blank_lp, emit_lp, lse, alpha, beta) = ctx.saved_tensors
        blank, activation, chunk, pred_dt, w_dt, b_dt = ctx.cfg
        occ_b, occ_e = occupancies(blank_lp, emit_lp, alpha, beta,
                                   input_lengths, label_lengths)
        # dL/dlogits = (gb + ge) p - gb 1[blank] - ge 1[label] with
        # gb = occ_b g, ge = occ_e g (L is a negative log-likelihood).
        gc = g.float()[:, None, None]
        denc, dpred, dw, db = joint_planes_bwd(
            enc_j, pred_c, w_c, b_f, labels, (occ_b * gc).contiguous(),
            (occ_e * gc).contiguous(), lse, blank, activation, chunk)
        return (denc.to(enc_j.dtype), dpred.to(pred_dt), dw.to(w_dt),
                db.to(b_dt), None, None, None, None, None, None)


def rnnt_loss_streaming(enc_j, pred_j, w, b, labels, input_lengths,
                        label_lengths, blank: int = 0,
                        activation: str = "tanh", chunk: int = 16):
    """Per-utterance transducer loss [B] from the projected streams.

    enc_j [B, T, H] in the compute dtype; pred_j [B, U+1, H]; w [V, H],
    b [V] (the joint's output layer; fp32 parameters are cast to the
    compute dtype inside, and their gradients come back in fp32); labels
    [B, >= U] (0 where padded); lengths [B]. ``chunk`` is the T-chunk of
    the CPU's plain versions (memory only; the kernels do not chunk)."""
    if activation not in ACTS:
        raise ValueError(f"unsupported joint activation: {activation}")
    return _RnntLossStreaming.apply(enc_j.contiguous(), pred_j, w, b,
                                    labels, input_lengths, label_lengths,
                                    int(blank), activation, int(chunk))


# ---------------------------------------- losses on materialised logits ---

def _label_index(labels, b: int, t: int, u1: int):
    """[B, T, U1, 1] gather index of each row's label (row U takes 0)."""
    lab = torch.cat([labels[:, :u1 - 1].long(),
                     torch.zeros(b, 1, dtype=torch.long,
                                 device=labels.device)], 1)
    return lab[:, None, :, None].expand(b, t, u1, 1)


def gather_planes(logits, labels, blank: int):
    """logits [B, T, U1, V], labels [B, >= U1 - 1] → (blank_lp, emit_lp)
    [B, T, U1] fp32 (port of ``_gather_planes``): the log-softmax over V,
    taken in fp32, at the blank column and at each row's label; row U of
    emit_lp is LOG_ZERO."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    b, t, u1, _ = lp.shape
    blank_lp = lp[..., blank].contiguous()
    last = torch.full((b, t, 1), LOG_ZERO, device=lp.device)
    if u1 == 1:
        return blank_lp, last
    emit = torch.gather(lp, -1, _label_index(labels, b, t, u1))[..., 0]
    return blank_lp, torch.cat([emit[..., :-1], last], -1)


def rnnt_loss(logits, labels, input_lengths, label_lengths,
              blank: int = 0):
    """``rnnt_impl: "scan"``: per-utterance loss [B] from the plain
    lattice; its gradient comes by autograd through it (as JAX's comes by
    autodiff through the scan)."""
    blank_lp, emit_lp = gather_planes(logits, labels, blank)
    alpha = alpha_scan(blank_lp, emit_lp)
    return -(_final(alpha, input_lengths, label_lengths)
             + _final(blank_lp, input_lengths, label_lengths))


def _logits_grad(logits, labels, occ_b, occ_e, blank: int, g):
    """dL/dlogits = g·(softmax·(occ_b + occ_e) − occ_b·1[blank] −
    occ_e·1[label]) in fp32, returned in the logits' dtype."""
    b, t, u1, _ = logits.shape
    grad = torch.softmax(logits.float(), dim=-1)
    grad.mul_((occ_b + occ_e)[..., None])
    grad[..., blank] -= occ_b
    grad.scatter_add_(-1, _label_index(labels, b, t, u1), -occ_e[..., None])
    grad.mul_(g.float()[:, None, None, None])
    return grad.to(logits.dtype)


class _RnntLossPallas(torch.autograd.Function):
    """``rnnt_impl: "pallas"`` (port of ``rnnt_pallas.rnnt_loss_pallas``):
    K9 in the forward, loss −beta[:, 0, 0], the closed-form occupancy
    gradient from the saved alpha and beta."""

    @staticmethod
    def forward(ctx, logits, labels, input_lengths, label_lengths, blank):
        blank_lp, emit_lp = gather_planes(logits, labels, blank)
        alpha, beta = alpha_beta(blank_lp, emit_lp, input_lengths,
                                 label_lengths)
        ctx.blank = blank
        ctx.save_for_backward(logits, labels, input_lengths, label_lengths,
                              blank_lp, emit_lp, alpha, beta)
        return -beta[:, 0, 0]

    @staticmethod
    def backward(ctx, g):
        (logits, labels, input_lengths, label_lengths, blank_lp, emit_lp,
         alpha, beta) = ctx.saved_tensors
        occ_b, occ_e = occupancies(blank_lp, emit_lp, alpha, beta,
                                   input_lengths, label_lengths)
        return (_logits_grad(logits, labels, occ_b, occ_e, ctx.blank, g),
                None, None, None, None)


def rnnt_loss_pallas(logits, labels, input_lengths, label_lengths,
                     blank: int = 0):
    """Per-utterance loss [B] through K9 (the kernel on the card, the
    plain lattice on the CPU) with the closed-form gradient."""
    return _RnntLossPallas.apply(logits, labels, input_lengths,
                                 label_lengths, int(blank))


# ------------------------------------------------------- pruned loss ---

def factored_planes(am, lm, labels, blank: int):
    """(blank_lp, emit_lp) [B, T, U1] fp32 of the factored joint
    logit(v | t, u) = am[t, v] + lm[u, v] (port of ``_factored_planes``):
    the log-normaliser logsumexp_v is log(exp(am - max) @ exp(lm - max)^T)
    plus both maxima; row U of emit_lp is LOG_ZERO. am [B, T, V],
    lm [B, U1, V], labels [B, >= U1 - 1]."""
    am, lm = am.float(), lm.float()
    b, t_max, v = am.shape
    u1 = lm.shape[1]
    am_max = am.max(dim=-1, keepdim=True).values
    lm_max = lm.max(dim=-1, keepdim=True).values
    inner = torch.exp(am - am_max) @ torch.exp(lm - lm_max).transpose(1, 2)
    denom = (torch.log(inner.clamp_min(torch.finfo(torch.float32).tiny))
             + am_max + lm_max.transpose(1, 2))
    blank_lp = am[:, :, None, blank] + lm[:, None, :, blank] - denom
    if u1 == 1:
        return blank_lp, torch.full_like(blank_lp, LOG_ZERO)
    lab = labels[:, :u1 - 1].long()
    am_y = torch.gather(am, 2, lab[:, None, :].expand(b, t_max, u1 - 1))
    lm_y = torch.gather(lm[:, :u1 - 1], 2, lab[..., None])[..., 0]
    emit = am_y + lm_y[:, None, :] - denom[..., :u1 - 1]
    last = torch.full((b, t_max, 1), LOG_ZERO, device=am.device)
    return blank_lp, torch.cat([emit, last], dim=-1)


class _RnntLossSimple(torch.autograd.Function):
    """The lattice of the simple loss through K9: loss −(alpha at the
    terminal cell + its blank), gradient −occupancy on each plane (the
    planes' own gradient comes by autograd through factored_planes). Also
    returns alpha and beta, which take no gradient."""

    @staticmethod
    def forward(ctx, blank_lp, emit_lp, input_lengths, label_lengths):
        blank_lp = blank_lp.contiguous()
        emit_lp = emit_lp.contiguous()
        alpha, beta = alpha_beta(blank_lp, emit_lp, input_lengths,
                                 label_lengths)
        ctx.save_for_backward(blank_lp, emit_lp, alpha, beta, input_lengths,
                              label_lengths)
        ctx.mark_non_differentiable(alpha, beta)
        loss = -(_final(alpha, input_lengths, label_lengths)
                 + _final(blank_lp, input_lengths, label_lengths))
        return loss, alpha, beta

    @staticmethod
    def backward(ctx, g, _ga, _gb):
        blank_lp, emit_lp, alpha, beta, input_lengths, label_lengths = \
            ctx.saved_tensors
        occ_b, occ_e = occupancies(blank_lp, emit_lp, alpha, beta,
                                   input_lengths, label_lengths)
        gc = g.float()[:, None, None]
        return -occ_b * gc, -occ_e * gc, None, None


def prune_ranges(emit_lp, alpha, beta, input_lengths, label_lengths,
                 s_range: int):
    """Window starts [B, T] from the simple lattice (see
    get_rnnt_prune_ranges): each frame's argmax of the emit occupancy
    summed over ``s_range`` consecutive label positions, then k2's
    feasibility rules (start 0 at frame 0, non-decreasing, steps of at
    most ``s_range``, the last frame's window covering U_b, no window past
    U_b + 1)."""
    b, t_max, u1 = emit_lp.shape
    dev = emit_lp.device
    log_z = beta[:, 0, 0][:, None, None]
    beta_right = torch.cat([beta[:, :, 1:], torch.full(
        (b, t_max, 1), LOG_ZERO, device=dev)], 2)
    t_idx = torch.arange(t_max, device=dev)[None, :, None]
    u_idx = torch.arange(u1, device=dev)[None, None, :]
    in_lat = ((t_idx <= (input_lengths - 1)[:, None, None])
              & (u_idx < label_lengths[:, None, None]))
    occ_e = torch.exp(torch.where(in_lat, alpha + emit_lp + beta_right
                                  - log_z, LOG_ZERO))
    csum = torch.cat([torch.zeros(b, t_max, 1, device=dev),
                      torch.cumsum(occ_e, dim=2)], dim=2)      # [B, T, U1+1]
    k = torch.arange(max(u1 - s_range + 1, 1), device=dev)
    win = csum[:, :, (k + s_range).clamp(max=u1)] - csum[:, :, k]
    start = torch.argmax(win, dim=2)                           # [B, T]
    u_hi = (label_lengths[:, None] - s_range + 1).clamp_min(0)
    start = torch.minimum(start, u_hi)
    end = torch.arange(t_max, device=dev)[None, :] >= \
        (input_lengths - 1)[:, None]
    start = torch.where(end, u_hi, start)
    # start[t] >= start[t'] - s_range (t' - t) for every t' > t.
    sr_t = s_range * torch.arange(t_max, device=dev)[None, :]
    y = torch.flip(torch.cummax(torch.flip(start - sr_t, [1]), 1).values,
                   [1])
    start = torch.cummax(y + sr_t, dim=1).values
    start = torch.minimum(start.clamp_min(0), u_hi)
    start[:, 0] = 0
    return start


def rnnt_loss_simple_and_ranges(am, lm, labels, input_lengths,
                                label_lengths, s_range: int,
                                blank: int = 0):
    """(rnnt_loss_simple [B], get_rnnt_prune_ranges [B, T]) from one K9
    launch; the ranges take no gradient."""
    blank_lp, emit_lp = factored_planes(am, lm, labels, blank)
    loss, alpha, beta = _RnntLossSimple.apply(blank_lp, emit_lp,
                                              input_lengths, label_lengths)
    return loss, prune_ranges(emit_lp.detach(), alpha, beta, input_lengths,
                              label_lengths, s_range)


def rnnt_loss_simple(am, lm, labels, input_lengths, label_lengths,
                     blank: int = 0):
    """k2's "simple" transducer loss [B] over the factored joint
    am [B, T, V] + lm [B, U+1, V] (no joint network)."""
    blank_lp, emit_lp = factored_planes(am, lm, labels, blank)
    return _RnntLossSimple.apply(blank_lp, emit_lp, input_lengths,
                                 label_lengths)[0]


@torch.no_grad()
def get_rnnt_prune_ranges(am, lm, labels, input_lengths, label_lengths,
                          s_range: int, blank: int = 0):
    """Window starts [B, T] (int64) for the pruned loss from the simple
    lattice's emit occupancies (see prune_ranges)."""
    blank_lp, emit_lp = factored_planes(am, lm, labels, blank)
    alpha, beta = alpha_beta(blank_lp, emit_lp, input_lengths,
                             label_lengths)
    return prune_ranges(emit_lp, alpha, beta, input_lengths, label_lengths,
                        s_range)


def rnnt_loss_pruned(logits, ranges, labels, input_lengths, label_lengths,
                     blank: int = 0):
    """Transducer loss [B] over the pruned joint logits [B, T, S, V]
    (``logits[b, t, k]`` is cell (t, ranges[b, t] + k)), plain torch with
    its gradient by autograd: a loop over frames, the blank move a gather
    of the previous frame's window shifted by the range's step, the emit
    chain unrolled over the S positions."""
    b, t_max, s, _ = logits.shape
    dev = logits.device
    lp = torch.log_softmax(logits.float(), dim=-1)
    blank_w = lp[..., blank]                                   # [B, T, S]
    k_idx = torch.arange(s, device=dev)
    abs_u = ranges[:, :, None] + k_idx                         # [B, T, S]
    lab = torch.cat([labels.long(), torch.zeros(b, 1, dtype=torch.long,
                                                device=dev)], 1)
    u = labels.shape[1]
    lab = torch.gather(lab, 1, abs_u.clamp(max=u).reshape(b, -1)
                       ).reshape(b, t_max, s)
    emit_w = torch.gather(lp, 3, lab[..., None])[..., 0]
    lens = label_lengths[:, None, None]
    emit_w = torch.where(abs_u < lens, emit_w, LOG_ZERO)
    cell_valid = abs_u <= lens
    neg = torch.full((b,), LOG_ZERO, device=dev)

    def emit_chain(from_below, emit_row):
        row = [from_below[:, 0]]
        for kk in range(1, s):
            row.append(torch.logaddexp(from_below[:, kk],
                                       row[-1] + emit_row[:, kk - 1]))
        return torch.stack(row, dim=1)

    below = torch.stack([torch.zeros(b, device=dev)]
                        + [neg] * (s - 1), dim=1)
    alpha = torch.where(cell_valid[:, 0], emit_chain(below, emit_w[:, 0]),
                        LOG_ZERO)
    alphas = [alpha]
    for t in range(1, t_max):
        src = k_idx[None, :] + (ranges[:, t] - ranges[:, t - 1])[:, None]
        src_c = src.clamp(max=s - 1)
        gathered = (torch.gather(alpha, 1, src_c)
                    + torch.gather(blank_w[:, t - 1], 1, src_c))
        below = torch.where(src < s, gathered, LOG_ZERO)
        alpha = torch.where(cell_valid[:, t],
                            emit_chain(below, emit_w[:, t]), LOG_ZERO)
        alphas.append(alpha)
    alphas = torch.stack(alphas, dim=1)                        # [B, T, S]
    bi = torch.arange(b, device=dev)
    t_fin = (input_lengths - 1).clamp_min(0)
    k_fin = (label_lengths - ranges[bi, t_fin]).clamp(0, s - 1)
    return -(alphas[bi, t_fin, k_fin] + blank_w[bi, t_fin, k_fin])


# rnnt_impl → loss on materialised logits. The JAX package's "fused" and
# "pallas" differ only in how they run the lattice (XLA scans, the Pallas
# kernel); both give the loss and the closed-form gradient, which
# rnnt_loss_pallas computes through K9.
LOSSES = {"scan": rnnt_loss, "fused": rnnt_loss_pallas,
          "pallas": rnnt_loss_pallas}


def _lattice_lib() -> ctypes.CDLL:
    lib = load_library("rnnt_lattice")
    if lib.rnnt_lattice.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rnnt_lattice.argtypes = [p] * 6 + [i] * 3 + [p]
        lib.rnnt_lattice.restype = i
    return lib


def _lib() -> ctypes.CDLL:
    lib = load_library("rnnt_joint")
    if lib.rnnt_joint_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rnnt_joint_fwd.argtypes = [i, i] + [p] * 8 + [i] * 6 + [p]
        lib.rnnt_joint_fwd.restype = i
        lib.rnnt_joint_bwd_workspace.argtypes = [i] * 6
        lib.rnnt_joint_bwd_workspace.restype = ctypes.c_longlong
        lib.rnnt_joint_bwd.argtypes = [i, i] + [p] * 13 + [i] * 6 + [p]
        lib.rnnt_joint_bwd.restype = i
    return lib
