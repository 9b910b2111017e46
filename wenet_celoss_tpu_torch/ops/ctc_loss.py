"""CTC loss: the log-domain forward recursion over time (port of
``wenet_celoss_tpu/ops/ctc_loss.py::ctc_loss``; the Viterbi alignment
comes with the decode slices).

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
    k = torch.arange(s, device=dev)
    # (blank, y1, blank, y2, ..., yU, blank)
    if u_max > 0:
        # Padding (e.g. -1) only lands in states past 2 * label_length + 1,
        # which stay LOG_ZERO; read the blank there.
        lab = labels.clamp_min(0)[:, torch.clamp(k // 2, max=u_max - 1)]
        ext = torch.where(k % 2 == 1, lab, torch.full_like(lab, blank))
    else:
        ext = torch.full((b, s), blank, dtype=labels.dtype, device=dev)
    ext_m2 = torch.cat([torch.full_like(ext[:, :2], blank), ext[:, :-2]],
                       dim=1)[:, :s]
    can_skip = (ext != blank) & (ext != ext_m2)
    in_range = k[None, :] < (2 * label_lengths[:, None] + 1)

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
