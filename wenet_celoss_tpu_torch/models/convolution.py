"""Conformer convolution module, non-causal, full context (port of
``wenet_celoss_tpu/models/convolution.py``; the causal cache comes with
the streaming slice).

pointwise conv1 → GLU → depthwise conv → norm (batch or layer) → swish →
pointwise conv2, with the reference's masking: the RAW input is zeroed at
pad frames (so after the biased pointwise1 + GLU those frames carry
GLU(bias), not zero), the depthwise window pads with zeros in the
post-GLU domain, and the OUTPUT is re-zeroed at pad frames. A caller
passes its pre-norm as ``ln``: with ``LNMM_PALLAS`` at "1" or "conv" the
LayerNorm, the input mask and pointwise conv1 are one K7 launch
(``ops/ln_matmul.py``; a masked frame comes out as the bias, as above).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from wenet_celoss_tpu_torch.models.layers import Dense, LayerNorm
from wenet_celoss_tpu_torch.ops import ln_matmul as lnmm


class BatchNorm(nn.Module):
    """BatchNorm over the last axis with flax's semantics
    (``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``), in fp32 whatever the
    input's dtype, normalising as ``(x - mean) * (weight * rsqrt(var +
    eps)) + bias``.

    Training (the module's training mode, ``nn.Module.train()``): the
    statistics of this batch over every
    leading position (the caller passes no mask, so padded frames count,
    as in the JAX package), the variance taken as E[x²] - E[x]² clipped at
    0, the gradient flowing through both; then, once per call and outside
    autograd, ``running = momentum * running + (1 - momentum) * batch``
    with the biased variance (``nn.BatchNorm1d`` keeps an unbiased one and
    weights the other way). Evaluation: the running statistics."""

    def __init__(self, size: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))
        self.register_buffer("running_mean", torch.zeros(size))
        self.register_buffer("running_var", torch.ones(size))
        self.momentum = momentum
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dims)
            var = torch.clamp_min((xf * xf).mean(dims) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


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
        self.norm_layer = (BatchNorm(channels) if norm == "batch_norm"
                           else LayerNorm(channels, dtype=dtype))
        self.pointwise_conv2 = Dense(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                ln: Optional[LayerNorm] = None) -> torch.Tensor:
        """x [B, T, C], pre-normed by ``ln`` here when given; pad_mask
        [B, T] True = valid; a batch_norm follows the module's training
        mode (batch statistics, running statistics advanced)."""
        if ln is not None and lnmm.enabled("conv"):
            bsz, t, c = x.shape
            cdt = self.compute_dtype or torch.promote_types(x.dtype,
                                                            torch.float32)
            p1 = self.pointwise_conv1
            mask = (None if pad_mask is None
                    else pad_mask.reshape(bsz * t).float())
            h = lnmm.ln_matmul(x.reshape(bsz * t, c).to(cdt).contiguous(),
                               ln.weight, ln.bias, p1.weight.to(cdt),
                               p1.bias, mask, ln.eps).reshape(bsz, t, 2 * c)
        else:
            if ln is not None:
                x = ln(x)
            if pad_mask is not None:
                x = torch.where(pad_mask[..., None], x, torch.zeros_like(x))
            h = self.pointwise_conv1(x)
        h = F.glu(h, dim=-1)                                 # [B, T, C]
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
