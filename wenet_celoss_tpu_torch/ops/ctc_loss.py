"""CTC loss: the log-domain forward recursion over time, and the forced
alignment: its max-plus Viterbi with backpointers (port of
``wenet_celoss_tpu/ops/ctc_loss.py``: ``ctc_loss``, ``ctc_forced_align``).

The JAX package runs this as an XLA scan, not a Pallas kernel, so the port
keeps it as plain torch ops differentiated by autograd. It uses the finite
``LOG_ZERO`` of the JAX package, so an impossible alignment (T' < U, or a
repeat with no room for a blank) gives a large finite loss where
``torch.nn.functional.ctc_loss`` would give inf.
"""

from __future__ import annotations

import torch

from wenet_celoss_tpu_torch.utils.common import LOG_ZERO, acc_dtype


def _shift(a: torch.Tensor, k: int) -> torch.Tensor:
    """a [B, S] shifted right by k states, LOG_ZERO filled."""
    return torch.cat([torch.full_like(a[:, :k], LOG_ZERO), a[:, :-k]], dim=1)


def _topology(labels: torch.Tensor, label_lengths: torch.Tensor,
              blank: int):
    """The blank-interleaved states of each utterance → (ext [B, S]: the
    state's symbol (blank, y1, blank, y2, ..., yU, blank), can_skip [B, S]:
    the state may be entered from two states back, in_range [B, S]: the
    state lies within 2 * label_length + 1)."""
    b, u_max = labels.shape
    s = 2 * u_max + 1
    k = torch.arange(s, device=labels.device)
    if u_max > 0:
        # Padding (e.g. -1) only lands in states past 2 * label_length + 1,
        # which stay LOG_ZERO; read the blank there.
        lab = labels.clamp_min(0)[:, torch.clamp(k // 2, max=u_max - 1)]
        ext = torch.where(k % 2 == 1, lab, torch.full_like(lab, blank))
    else:
        ext = torch.full((b, s), blank, dtype=labels.dtype,
                         device=labels.device)
    ext_m2 = torch.cat([torch.full_like(ext[:, :2], blank), ext[:, :-2]],
                       dim=1)[:, :s]
    can_skip = (ext != blank) & (ext != ext_m2)
    in_range = k[None, :] < (2 * label_lengths[:, None] + 1)
    return ext, can_skip, in_range


def ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor,
             input_lengths: torch.Tensor, label_lengths: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """Per-utterance CTC negative log-likelihood [B].

    log_probs [B, T, V] log-softmax outputs; labels [B, U] (padding
    ignored past label_lengths); input_lengths, label_lengths [B]."""
    b, t_max, _ = log_probs.shape
    u_max = labels.shape[1]
    s = 2 * u_max + 1
    dev = log_probs.device
    ext, can_skip, in_range = _topology(labels, label_lengths, blank)

    emit = torch.gather(log_probs.to(acc_dtype(log_probs.dtype)), 2,
                        ext[:, None, :].expand(b, t_max, s))   # [B, T, S]
    zero = torch.full((b, s), LOG_ZERO, device=dev)
    first = torch.zeros((b, s), dtype=torch.bool, device=dev)
    first[:, 0] = True
    if u_max > 0:
        first[:, 1] = label_lengths > 0
    alpha = torch.where(first & in_range, emit[:, 0], zero)
    alphas = [alpha]
    for t in range(1, t_max):
        prev2 = torch.where(can_skip, _shift(alpha, 2)[:, :s], zero)
        new = torch.logaddexp(torch.logaddexp(alpha, _shift(alpha, 1)),
                              prev2) + emit[:, t]
        alpha = torch.where(in_range, new, zero)
        alphas.append(alpha)
    alphas = torch.stack(alphas, dim=0)                        # [T, B, S]

    t_idx = torch.clamp(input_lengths - 1, min=0)
    alpha_t = alphas[t_idx, torch.arange(b, device=dev)]       # [B, S]
    last = 2 * label_lengths
    a_end = torch.gather(alpha_t, 1, last[:, None])[:, 0]
    a_end2 = torch.gather(alpha_t, 1, torch.clamp(last - 1, min=0)[:, None]
                          )[:, 0]
    a_end2 = torch.where(label_lengths > 0, a_end2,
                         torch.full_like(a_end2, LOG_ZERO))
    return -torch.logaddexp(a_end, a_end2)


def ctc_forced_align(log_probs: torch.Tensor, labels: torch.Tensor,
                     input_lengths: torch.Tensor,
                     label_lengths: torch.Tensor,
                     blank: int = 0) -> torch.Tensor:
    """Batched Viterbi alignment over the CTC topology → [B, T] state
    symbols: the most likely blank-interleaved path of each utterance,
    blank past its input length.

    The JAX package's max-plus scan, step for step on the tensors' device:
    the predecessors stacked as [stay, one back, two back] with the first
    maximum winning, LOG_ZERO (finite) in every state past 2 * U + 1 and
    every state the path cannot reach, the terminal state 2U unless 2U - 1
    scores higher. Backpointers are int8 [T, B, S]."""
    b, t_max, _ = log_probs.shape
    s = 2 * labels.shape[1] + 1
    dev = log_probs.device
    ext, can_skip, in_range = _topology(labels, label_lengths, blank)
    emit = torch.gather(log_probs, 2, ext[:, None, :].expand(b, t_max, s))
    emit = emit.transpose(0, 1)                                # [T, B, S]
    zero = torch.full((b, s), LOG_ZERO, dtype=emit.dtype, device=dev)
    first = torch.zeros((b, s), dtype=torch.bool, device=dev)
    first[:, 0] = True
    if s > 1:
        first[:, 1] = label_lengths > 0
    alpha = torch.where(first & in_range, emit[0], zero)
    alphas = [alpha]
    bps = [torch.zeros((b, s), dtype=torch.int8, device=dev)]
    for t in range(1, t_max):
        prev2 = torch.where(can_skip, _shift(alpha, 2)[:, :s], zero)
        stacked = torch.stack([alpha, _shift(alpha, 1), prev2], dim=0)
        best, arg = torch.max(stacked, dim=0)
        alpha = torch.where(in_range, best + emit[t], zero)
        alphas.append(alpha)
        bps.append(arg.to(torch.int8))
    alphas = torch.stack(alphas, dim=0)                        # [T, B, S]
    bps = torch.stack(bps, dim=0)

    rows = torch.arange(b, device=dev)
    t_idx = torch.clamp(input_lengths - 1, min=0)
    alpha_t = alphas[t_idx, rows]
    last = 2 * label_lengths
    a_end = torch.gather(alpha_t, 1, last[:, None])[:, 0]
    a_end2 = torch.gather(alpha_t, 1, torch.clamp(last - 1, min=0)[:, None]
                          )[:, 0]
    a_end2 = torch.where(label_lengths > 0, a_end2,
                         torch.full_like(a_end2, LOG_ZERO))
    state = torch.where(a_end >= a_end2, last, torch.clamp(last - 1, min=0))
    path = torch.full((b, t_max), blank, dtype=ext.dtype, device=dev)
    for t in range(t_max - 1, -1, -1):
        active = t <= t_idx
        sym = torch.gather(ext, 1, state[:, None])[:, 0]
        path[:, t] = torch.where(active, sym, torch.full_like(sym, blank))
        if t > 0:
            delta = torch.gather(bps[t], 1, state[:, None])[:, 0]
            state = torch.where(active, state - delta.to(state.dtype), state)
    return path
