"""Linear and LayerNorm with the JAX package's compute-dtype rule.

Params stay fp32. A layer built with ``dtype`` (the model's compute dtype,
e.g. ``torch.bfloat16``) casts its input and params to it, as a flax
``nn.Dense(dtype=...)`` does; a layer without one computes in the
promoted type of its input and its fp32 params. LayerNorm statistics are
always taken in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class Dense(nn.Linear):
    """``nn.Linear`` (weight [out, in]) with an optional compute dtype."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype or torch.promote_types(x.dtype,
                                                        self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(cdt)
        return F.linear(x.to(cdt), self.weight.to(cdt), bias)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, stats in fp32, output in the compute
    dtype (or the input's type promoted with fp32)."""

    def __init__(self, size: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))
        self.eps = eps
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.compute_dtype or torch.promote_types(x.dtype,
                                                        torch.float32)
        y = F.layer_norm(x.float(), self.weight.shape, self.weight,
                         self.bias, self.eps)
        return y.to(out)


class LSTMCellParams(nn.Module):
    """One LSTM layer as two plain matmuls, gate order i, f, g, o.

    ``wi`` [4H, E] has no bias; ``wh`` [4H, H] carries the single bias,
    as flax's ``OptimizedLSTMCell`` puts it on the hidden-side kernels
    ``hi..ho``. (``nn.LSTM`` is avoided: on CUDA it is cuDNN, and its two
    biases hide this mapping.)"""

    def __init__(self, in_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.wi = nn.Linear(in_size, 4 * hidden, bias=False)
        self.wh = nn.Linear(hidden, 4 * hidden, bias=True)

    def input_proj(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., E] → x @ wi^T + bias [..., 4H], hoisted out of the
        recurrence."""
        return self.wi(x) + self.wh.bias

    def step(self, xw: torch.Tensor, c: torch.Tensor, h: torch.Tensor):
        """One recurrence step from the hoisted ``xw`` → new (c, h)."""
        z = xw + F.linear(h, self.wh.weight)
        i, f, g, o = torch.split(z, self.hidden, dim=-1)
        c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h2 = torch.sigmoid(o) * torch.tanh(c2)
        return c2, h2
