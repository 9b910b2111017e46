"""Sequence/label helpers (port of ``wenet_celoss_tpu/utils/common.py``)."""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

IGNORE_ID = -1
# Log-domain "zero" of the CTC recursion (finite, as in the JAX package:
# an impossible alignment gives a large finite loss, not inf).
LOG_ZERO = -1.0e6


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type normalisations, softmaxes and losses run in: fp32 for bf16
    and fp32 inputs, fp64 for fp64 ones (the CPU's float64 reference)."""
    return torch.promote_types(dtype, torch.float32)


def add_sos_eos(ys_pad: torch.Tensor, ys_lens: torch.Tensor, sos: int,
                eos: int, ignore_id: int = IGNORE_ID):
    """[B, U] labels padded with ``ignore_id`` → (ys_in [B, U+1] = sos +
    labels, pad eos; ys_out [B, U+1] = labels + eos, pad ignore_id)."""
    b, u = ys_pad.shape
    valid = torch.arange(u, device=ys_pad.device)[None, :] < ys_lens[:, None]
    ys = torch.where(valid, ys_pad, torch.zeros_like(ys_pad))
    ys_in = torch.cat([torch.full_like(ys_pad[:, :1], sos),
                       torch.where(valid, ys, torch.full_like(ys, eos))],
                      dim=1)
    pos = torch.arange(u + 1, device=ys_pad.device)[None, :]
    ys_ext = torch.cat([ys, torch.zeros_like(ys_pad[:, :1])], dim=1)
    lens = ys_lens[:, None]
    ys_out = torch.where(pos < lens, ys_ext,
                         torch.where(pos == lens, torch.full_like(ys_ext, eos),
                                     torch.full_like(ys_ext, ignore_id)))
    return ys_in, ys_out


def add_blank(ys_pad: torch.Tensor, ys_lens: torch.Tensor, blank: int,
              ignore_id: int = IGNORE_ID) -> torch.Tensor:
    """Prepend the RNN-T blank: [B, U] → [B, U+1] = [blank, y_1..y_U,
    pad...] with pad = blank."""
    b, u = ys_pad.shape
    valid = torch.arange(u, device=ys_pad.device)[None, :] < ys_lens[:, None]
    ys = torch.where(valid, ys_pad, torch.full_like(ys_pad, blank))
    return torch.cat([torch.full_like(ys_pad[:, :1], blank), ys], dim=1)


def reverse_pad_list(ys_pad: torch.Tensor, ys_lens: torch.Tensor,
                     pad_value: float = float(IGNORE_ID)) -> torch.Tensor:
    """Reverse each padded sequence in time; positions past its length
    take ``pad_value``."""
    b, u = ys_pad.shape
    idx = (ys_lens[:, None] - 1
           - torch.arange(u, device=ys_pad.device)[None, :])
    gathered = torch.gather(ys_pad, 1, idx.clamp_min(0))
    return torch.where(idx >= 0, gathered,
                       torch.full_like(ys_pad, pad_value))


def accuracy(logits: torch.Tensor, targets: torch.Tensor,
             ignore_id: int = IGNORE_ID) -> torch.Tensor:
    """Token accuracy over the positions that are not ``ignore_id``."""
    pred = torch.argmax(logits, dim=-1)
    mask = targets != ignore_id
    correct = ((pred == targets) & mask).sum()
    return correct.float() / mask.sum().clamp_min(1).float()


def stable_topk(x: torch.Tensor, k: int, dim: int = -1):
    """The ``k`` largest values along ``dim`` and their indices, largest
    first and, among equal values, the lowest index first (the order of
    ``jax.lax.top_k``; ``torch.topk`` on a card leaves ties unordered, and
    dead beams at LOG_ZERO tie exactly)."""
    values, indices = torch.sort(x, dim=dim, descending=True, stable=True)
    return values.narrow(dim, 0, k), indices.narrow(dim, 0, k)


def remove_duplicates_and_blank(hyp: Sequence[int],
                                blank: int = 0) -> List[int]:
    """Host-side CTC collapse: drop repeats, then blanks."""
    out: List[int] = []
    prev = -1
    for t in hyp:
        t = int(t)
        if t != blank and t != prev:
            out.append(t)
        prev = t
    return out


def get_activation(name: str):
    """Activation registry (``gelu`` is the tanh approximation, as
    ``jax.nn.gelu`` is by default)."""
    acts = {
        "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
        "tanh": torch.tanh,
        "relu": F.relu,
        "selu": F.selu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "swish": F.silu,
    }
    if name not in acts:
        raise ValueError(f"unknown activation: {name}")
    return acts[name]
