"""Conformer convolution module (port of
``wenet_celoss_tpu/models/convolution.py``): non-causal or causal, full
context, and a causal module's streaming step over a cache of its last
``kernel_size - 1`` input frames.

pointwise conv1 → GLU → depthwise conv → norm (batch or layer) → swish →
pointwise conv2, with the reference's masking: the RAW input is zeroed at
pad frames (so after the biased pointwise1 + GLU those frames carry
GLU(bias), not zero), the depthwise window pads with zeros in the
post-GLU domain, and the OUTPUT is re-zeroed at pad frames. A caller
passes its pre-norm as ``ln``: with ``LNMM_PALLAS`` at "1" or "conv" the
LayerNorm, the input mask and pointwise conv1 are one K7 launch
(``ops/ln_matmul.py``; a masked frame comes out as the bias, as above,
and a causal module's left pad enters as rows of the bias).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from wenet_celoss_tpu_torch.models.layers import Dense, LayerNorm
from wenet_celoss_tpu_torch.ops import ln_matmul as lnmm
from wenet_celoss_tpu_torch.parallel import dist


class _SyncStats(torch.autograd.Function):
    """(mean, E[x²]) over every leading position of every rank's x: one
    all-reduce of [Σx, Σx², count] forward, and one of the two
    statistics' gradients backward (each rank's loss reads the shared
    statistics, so x's gradient takes every rank's)."""

    @staticmethod
    def forward(ctx, xf, group):
        dims = tuple(range(xf.dim() - 1))
        c = xf.shape[-1]
        local = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                           xf.new_full((1,), xf.numel() // c)])
        tot = dist.all_reduce_sum(local, group)
        n = tot[-1]
        ctx.save_for_backward(xf, n)
        ctx.group = group
        return tot[:c] / n, tot[c:2 * c] / n

    @staticmethod
    def backward(ctx, g_mean, g_msq):
        xf, n = ctx.saved_tensors
        g_mean = torch.zeros_like(n.expand(xf.shape[-1])) if g_mean is None \
            else g_mean
        g_msq = torch.zeros_like(g_mean) if g_msq is None else g_msq
        g = dist.all_reduce_sum(torch.cat([g_mean, g_msq]), ctx.group)
        c = xf.shape[-1]
        return (g[:c] + 2.0 * xf * g[c:]) / n, None


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
    weights the other way). Evaluation: the running statistics.

    Inside ``parallel/dist.py step_shard`` the statistics are the whole
    step batch's, over every rank's positions (``_SyncStats``), so every
    rank normalises alike and keeps equal running statistics; this is
    not ``nn.SyncBatchNorm``, whose running variance and momentum are
    torch's."""

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
            group = dist.active()
            if group is None:
                dims = tuple(range(x.dim() - 1))
                mean, msq = xf.mean(dims), (xf * xf).mean(dims)
            else:
                mean, msq = _SyncStats.apply(xf, group)
            var = torch.clamp_min(msq - mean * mean, 0.0)
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
    """``causal``: the depthwise conv sees the ``lorder = K - 1`` frames
    before each frame and none after it, the left pad made of zero frames
    in the RAW domain (after the input mask, before pointwise conv1); a
    causal module streams through :meth:`forward_with_cache`. It needs
    ``layer_norm``: a causal ``batch_norm`` module raises, as in the JAX
    package."""

    def __init__(self, channels: int, kernel_size: int = 15,
                 norm: str = "batch_norm", causal: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if norm not in ("batch_norm", "layer_norm"):
            raise ValueError(f"unknown conv norm {norm!r}")
        if causal and norm == "batch_norm":
            raise ValueError("a causal conv module needs layer_norm, not "
                             "batch_norm")
        self.kernel_size = kernel_size
        self.norm = norm
        self.causal = causal
        self.lorder = kernel_size - 1 if causal else 0
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
            if self.lorder:
                # pointwise_conv1 of a zero frame is its bias, so the
                # causal pad moves to the projection's output as bias rows.
                pad = p1.bias.to(h.dtype).expand(bsz, self.lorder, 2 * c)
                h = torch.cat([pad, h], dim=1)
        else:
            if ln is not None:
                x = ln(x)
            if pad_mask is not None:
                x = torch.where(pad_mask[..., None], x, torch.zeros_like(x))
            if self.lorder:
                x = F.pad(x, (0, 0, self.lorder, 0))
            h = self.pointwise_conv1(x)
        y = self._body(h, 0 if self.causal else (self.kernel_size - 1) // 2)
        if pad_mask is not None:
            y = torch.where(pad_mask[..., None], y, torch.zeros_like(y))
        return y

    def _body(self, h: torch.Tensor, pad: int) -> torch.Tensor:
        """GLU → depthwise conv (``pad`` zero frames each side, post-GLU)
        → norm → swish → pointwise conv2."""
        h = F.glu(h, dim=-1)                                 # [B, T, C]
        cdt = self.compute_dtype or h.dtype
        w = self.depthwise_conv
        y = F.conv1d(h.to(cdt).transpose(1, 2), w.weight.to(cdt),
                     w.bias.to(cdt), padding=pad,
                     groups=w.groups).transpose(1, 2)
        y = F.silu(self.norm_layer(y))
        return self.pointwise_conv2(y)

    def forward_with_cache(self, x: torch.Tensor, cnn_cache: torch.Tensor):
        """One streaming step of a causal module, no pad mask.

        x [B, T, C] (already pre-normed); cnn_cache [B, lorder, C]: the
        last ``lorder`` RAW input frames before x (zeros at the start, the
        full forward's left pad). → (out [B, T, C], the new cache)."""
        if not self.causal:
            raise ValueError("only a causal conv module streams")
        x_ext = torch.cat([cnn_cache.to(x.dtype), x], dim=1)
        new_cache = x_ext[:, x_ext.shape[1] - self.lorder:]
        return self._body(self.pointwise_conv1(x_ext), 0), new_cache
