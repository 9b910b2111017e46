"""Conformer convolution module, non-causal, full context (port of
``wenet_celoss_tpu/models/convolution.py``; the causal cache comes with
the streaming slice).

pointwise conv1 → GLU → depthwise conv → norm (batch or layer) → swish →
pointwise conv2, with the reference's masking: the RAW input is zeroed at
pad frames (so after the biased pointwise1 + GLU those frames carry
GLU(bias), not zero), the depthwise window pads with zeros in the
post-GLU domain, and the OUTPUT is re-zeroed at pad frames.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from wenet_celoss_tpu_torch.models.layers import Dense, LayerNorm


class BatchNormEval(nn.Module):
    """Inference BatchNorm over the last axis with running statistics:
    (x - mean) * (weight * rsqrt(var + eps)) + bias, in fp32 (flax's
    order of operations)."""

    def __init__(self, size: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))
        self.register_buffer("running_mean", torch.zeros(size))
        self.register_buffer("running_var", torch.ones(size))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x.float() - self.running_mean) * mul + self.bias


class ConvolutionModule(nn.Module):

    def __init__(self, channels: int, kernel_size: int = 15,
                 norm: str = "batch_norm", causal: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if causal:
            raise NotImplementedError(
                "the causal conv module comes with the streaming slice")
        if norm not in ("batch_norm", "layer_norm"):
            raise ValueError(f"unknown conv norm {norm!r}")
        self.kernel_size = kernel_size
        self.norm = norm
        self.compute_dtype = dtype
        self.pointwise_conv1 = Dense(channels, 2 * channels, dtype=dtype)
        # Depthwise conv over time, torch layout [C, 1, K].
        self.depthwise_conv = nn.Conv1d(channels, channels, kernel_size,
                                        groups=channels)
        self.norm_layer = (BatchNormEval(channels) if norm == "batch_norm"
                           else LayerNorm(channels, dtype=dtype))
        self.pointwise_conv2 = Dense(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, C] (already pre-normed); pad_mask [B, T] True = valid."""
        if pad_mask is not None:
            x = torch.where(pad_mask[..., None], x, torch.zeros_like(x))
        h = F.glu(self.pointwise_conv1(x), dim=-1)           # [B, T, C]
        cdt = self.compute_dtype or h.dtype
        pad = (self.kernel_size - 1) // 2
        w = self.depthwise_conv
        y = F.conv1d(h.to(cdt).transpose(1, 2), w.weight.to(cdt),
                     w.bias.to(cdt), padding=pad,
                     groups=w.groups).transpose(1, 2)
        y = F.silu(self.norm_layer(y))
        y = self.pointwise_conv2(y)
        if pad_mask is not None:
            y = torch.where(pad_mask[..., None], y, torch.zeros_like(y))
        return y
