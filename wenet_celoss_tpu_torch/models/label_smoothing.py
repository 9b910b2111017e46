"""Label-smoothed cross entropy (port of
``wenet_celoss_tpu/models/label_smoothing.py``): the KL divergence from the
smoothed target distribution, INCLUDING its constant entropy term, as the
reference's ``KLDivLoss`` computes it."""

from __future__ import annotations

import math

import torch

from wenet_celoss_tpu_torch.parallel.dist import token_denominator
from wenet_celoss_tpu_torch.utils.common import IGNORE_ID, acc_dtype


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         smoothing: float = 0.1,
                         normalize_length: bool = False,
                         ignore_id: int = IGNORE_ID) -> torch.Tensor:
    """logits [B, U, V]; targets [B, U] padded with ``ignore_id`` → scalar
    sum over tokens of KL(p || softmax(logits)), divided by the batch size
    (default) or the token count (in a step split over processes, the
    whole batch's count over the ranks: ``parallel/dist.py``)."""
    v = logits.shape[-1]
    confidence = 1.0 - smoothing
    low = smoothing / (v - 1)
    logq = torch.log_softmax(logits.to(acc_dtype(logits.dtype)), dim=-1)
    mask = targets != ignore_id
    tgt = torch.where(mask, targets, torch.zeros_like(targets))
    p_logp = (confidence * math.log(confidence + 1e-20)
              + (v - 1) * low * math.log(low + 1e-20))
    logq_tgt = torch.gather(logq, -1, tgt[..., None])[..., 0]
    ce = -(confidence * logq_tgt + low * (logq.sum(-1) - logq_tgt))
    kl = (ce + p_logp) * mask
    if normalize_length:
        return kl.sum() / token_denominator(mask.sum())
    return kl.sum() / max(int(targets.shape[0]), 1)
