"""Sequence/label helpers (port of ``wenet_celoss_tpu/utils/common.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

IGNORE_ID = -1


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
