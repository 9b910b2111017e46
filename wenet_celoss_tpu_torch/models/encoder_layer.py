"""Conformer encoder layer (port of
``wenet_celoss_tpu/models/encoder_layer.py``, full context).

½-FFN → MHSA → conv → ½-FFN → final LN (macaron), all pre-norm with
residuals. Each FFN block (pre-LN + FFN + scaled residual) is ONE launch
of the hand-written ``ln_ffn_residual`` kernel on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from wenet_celoss_tpu_torch.models.attention import \
    RelPositionMultiHeadedAttention
from wenet_celoss_tpu_torch.models.convolution import ConvolutionModule
from wenet_celoss_tpu_torch.models.layers import Dense, LayerNorm
from wenet_celoss_tpu_torch.ops.ffn import ln_ffn_residual


class PositionwiseFeedForward(nn.Module):
    """The whole pre-norm FFN block ``x + ff_scale * w_2(act(w_1(ln(x))))``
    with the LayerNorm ``ln`` passed in, dispatched to
    ``ops.ffn.ln_ffn_residual`` (the kernel on the card). The post-norm
    FFN without ``ln`` is not ported."""

    def __init__(self, idim: int, hidden_units: int,
                 activation: str = "relu",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.activation = activation
        self.compute_dtype = dtype
        self.w_1 = Dense(idim, hidden_units, dtype=dtype)
        self.w_2 = Dense(hidden_units, idim, dtype=dtype)

    def forward(self, x: torch.Tensor, ln: LayerNorm,
                ff_scale: float = 1.0) -> torch.Tensor:
        b, t, d = x.shape
        cdt = self.compute_dtype or x.dtype
        y = ln_ffn_residual(
            x.reshape(b * t, d).to(cdt).contiguous(), ln.weight, ln.bias,
            self.w_1.weight.to(cdt), self.w_1.bias, self.w_2.weight.to(cdt),
            self.w_2.bias, self.activation, ff_scale, ln.eps)
        return y.reshape(b, t, d)


class ConformerEncoderLayer(nn.Module):

    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 macaron_style: bool = True, use_cnn_module: bool = True,
                 cnn_module_kernel: int = 15,
                 cnn_module_norm: str = "batch_norm", causal: bool = False,
                 activation: str = "swish",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.self_attn = RelPositionMultiHeadedAttention(
            attention_heads, size, dtype=dtype)
        self.feed_forward = PositionwiseFeedForward(
            size, linear_units, activation, dtype=dtype)
        self.feed_forward_macaron = None
        if macaron_style:
            self.feed_forward_macaron = PositionwiseFeedForward(
                size, linear_units, activation, dtype=dtype)
            self.norm_ff_macaron = LayerNorm(size, dtype=dtype)
        self.conv_module = None
        if use_cnn_module:
            self.conv_module = ConvolutionModule(
                size, cnn_module_kernel, cnn_module_norm, causal,
                dtype=dtype)
            self.norm_conv = LayerNorm(size, dtype=dtype)
            self.norm_final = LayerNorm(size, dtype=dtype)
        self.norm_ff = LayerNorm(size, dtype=dtype)
        self.norm_mha = LayerNorm(size, dtype=dtype)
        self.ff_scale = 0.5 if macaron_style else 1.0

    def forward(self, x: torch.Tensor, att_bias: torch.Tensor,
                pos_emb: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, D]; att_bias [B, T, T] additive; pos_emb [1, T, D];
        pad_mask [B, T] True = valid."""
        if self.feed_forward_macaron is not None:
            x = self.feed_forward_macaron(x, ln=self.norm_ff_macaron,
                                          ff_scale=self.ff_scale)
        xn = self.norm_mha(x)
        x = x + self.self_attn(xn, xn, xn, att_bias, pos_emb)
        if self.conv_module is not None:
            x = x + self.conv_module(self.norm_conv(x), pad_mask)
        x = self.feed_forward(x, ln=self.norm_ff, ff_scale=self.ff_scale)
        if self.conv_module is not None:
            x = self.norm_final(x)
        return x
