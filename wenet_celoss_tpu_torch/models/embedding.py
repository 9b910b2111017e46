"""Positional encodings (port of ``wenet_celoss_tpu/models/embedding.py``:
relative, absolute and none), with their dropout when the caller passes a
generator (training), and the streaming ``offset``: a chunk's table
continues from the frames before it (``pos_emb(offset, size)``)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from wenet_celoss_tpu_torch.ops.dropout import dropout


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
    """Scales x by sqrt(d), then dropout, and returns the position table
    separately, [1, T, d] in x's dtype, from position ``offset`` on."""

    def __init__(self, d_model: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.dropout_rate = dropout_rate

    def pos_emb(self, offset: int, size: int, device=None) -> torch.Tensor:
        """[1, size, d] fp32 table of positions offset .. offset+size-1
        (negative positions too: a streaming chunk's rel-pos table starts
        at offset - cache). ``offset`` may be a 0-d tensor (an exported
        chunk step takes it as an input)."""
        pos = torch.arange(size, device=device) + offset
        return sinusoid_table(pos[None, :], self.d_model)

    def forward(self, x: torch.Tensor, gen=None, offset: int = 0):
        pe = self.pos_emb(offset, x.shape[1], x.device).to(x.dtype)
        x = x * torch.tensor(self.d_model ** 0.5, dtype=x.dtype)
        return dropout(x, self.dropout_rate, gen), pe


class PositionalEncoding(RelPositionalEncoding):
    """Absolute encoding: ``dropout(x * sqrt(d) + pe)``, and the table."""

    def forward(self, x: torch.Tensor, gen=None, offset: int = 0):
        pe = self.pos_emb(offset, x.shape[1], x.device).to(x.dtype)
        x = x * torch.tensor(self.d_model ** 0.5, dtype=x.dtype) + pe
        return dropout(x, self.dropout_rate, gen), pe


class NoPositionalEncoding(RelPositionalEncoding):
    """No encoding: ``dropout(x)`` (no sqrt(d) scale) and a zero table."""

    def pos_emb(self, offset: int, size: int, device=None) -> torch.Tensor:
        return torch.zeros(1, size, self.d_model, device=device)

    def forward(self, x: torch.Tensor, gen=None, offset: int = 0):
        pe = self.pos_emb(offset, x.shape[1], x.device).to(x.dtype)
        return dropout(x, self.dropout_rate, gen), pe


POS_ENC_CLASSES = {"abs_pos": PositionalEncoding,
                   "rel_pos": RelPositionalEncoding,
                   "no_pos": NoPositionalEncoding}
