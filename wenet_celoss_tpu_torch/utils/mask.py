"""Padding masks (port of ``wenet_celoss_tpu/utils/mask.py``, full context).

Convention: masks are boolean, True = attend / valid. Chunk masks for
streaming come with the streaming slice.
"""

from __future__ import annotations

import torch


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, T] True at PADDED positions."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            >= lengths[:, None])


def make_non_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, T] True at VALID positions."""
    return ~make_pad_mask(lengths, max_len)
