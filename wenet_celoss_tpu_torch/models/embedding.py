"""Relative positional encoding (port of
``wenet_celoss_tpu/models/embedding.py``)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn


def sinusoid_table(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """positions [...] → [..., d_model] interleaved sin/cos table (fp32)."""
    inv = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32,
                     device=positions.device)
        * -(math.log(10000.0) / d_model))
    ang = positions[..., None].to(torch.float32) * inv
    pe = torch.zeros(positions.shape + (d_model,), dtype=torch.float32,
                     device=positions.device)
    pe[..., 0::2] = torch.sin(ang)
    pe[..., 1::2] = torch.cos(ang)
    return pe


class RelPositionalEncoding(nn.Module):
    """Scales x by sqrt(d) and returns the position table separately,
    [1, T, d] in x's dtype (dropout is an identity at decode time). The
    streaming offset comes with the streaming slice."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model

    def forward(self, x: torch.Tensor):
        pos = torch.arange(x.shape[1], device=x.device)
        pe = sinusoid_table(pos[None, :], self.d_model).to(x.dtype)
        x = x * torch.tensor(self.d_model ** 0.5, dtype=x.dtype)
        return x, pe
