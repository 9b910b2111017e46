"""Transformer and conformer encoder layers (port of
``wenet_celoss_tpu/models/encoder_layer.py``): the full-context forward,
and ``forward_with_cache``, one streaming chunk over the attention ring
and the causal conv module's frame cache.

Conformer: ½-FFN → MHSA → conv → ½-FFN → final LN (macaron), all
pre-norm with residuals (the layer has no post-norm form). Transformer:
self-attention → FFN, pre-norm or post-norm (``normalize_before``). Each
pre-norm FFN block (pre-LN + FFN + dropout + scaled residual) is ONE launch
of the hand-written ``ln_ffn_residual`` kernel (K1) on the card, each
post-norm FFN one launch of ``ffn_fused`` (K6), and one launch of the
backward kernel under autograd. With ``CONV_PALLAS=1`` in the environment
(the JAX package's switch, read where it reads it; off by default) and a
``layer_norm`` conv module, the whole conv block (pre-LN, module, dropout,
residual) is one launch of ``conv_block_residual`` (K8, causal when the
module is) and one of its backward; else, with ``LNMM_PALLAS`` at "1" or "conv", its pre-LN and
pointwise conv1 are one launch of ``ln_matmul`` (K7), as are the
self-attention's pre-LN and QKV projection with "1" or "attn". Dropout
runs when the caller passes a generator; without one every layer is
deterministic. A batch_norm conv module normalises with the batch's
statistics while the layer is in training mode (``nn.Module.train()``,
which the training entry points set, whatever the generator), else with
its running statistics.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn as nn

from wenet_celoss_tpu_torch.models.attention import (
    MultiHeadedAttention, RelPositionMultiHeadedAttention)
from wenet_celoss_tpu_torch.models.convolution import ConvolutionModule
from wenet_celoss_tpu_torch.models.layers import Dense, LayerNorm
from wenet_celoss_tpu_torch.ops.conv import conv_block_residual
from wenet_celoss_tpu_torch.ops.dropout import draw_seed, dropout, row_base
from wenet_celoss_tpu_torch.ops.ffn import ffn_fused, ln_ffn_residual


def use_conv_block() -> bool:
    """The fused conv block's switch, ``CONV_PALLAS=1`` (default off)."""
    return os.environ.get("CONV_PALLAS", "0") == "1"


class PositionwiseFeedForward(nn.Module):
    """With the LayerNorm ``ln`` passed in, the whole pre-norm FFN block
    ``x + ff_scale * drop(w_2(drop(act(w_1(ln(x))))))``, dispatched to
    ``ops.ffn.ln_ffn_residual`` (K1 on the card), both dropout rates
    (hidden and output) ``dropout_rate``. Without ``ln``, the bare FFN
    ``w_2(drop(act(w_1(x))))`` of a post-norm layer, dispatched to
    ``ops.ffn.ffn_fused`` (K6). Every rate is 0 without a generator."""

    def __init__(self, idim: int, hidden_units: int,
                 activation: str = "relu", dropout_rate: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.compute_dtype = dtype
        self.w_1 = Dense(idim, hidden_units, dtype=dtype)
        self.w_2 = Dense(hidden_units, idim, dtype=dtype)

    def forward(self, x: torch.Tensor, ln: Optional[LayerNorm] = None,
                ff_scale: float = 1.0,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        b, t, d = x.shape
        cdt = self.compute_dtype or x.dtype
        rate = self.dropout_rate if gen is not None else 0.0
        seed = draw_seed(gen) if rate > 0.0 else 0
        if ln is None:
            y = ffn_fused(x.reshape(b * t, d).to(cdt).contiguous(),
                          self.w_1.weight.to(cdt), self.w_1.bias,
                          self.w_2.weight.to(cdt), self.w_2.bias,
                          self.activation, rate, seed, row_base(b * t))
            return y.reshape(b, t, d)
        y = ln_ffn_residual(
            x.reshape(b * t, d).to(cdt).contiguous(), ln.weight, ln.bias,
            self.w_1.weight.to(cdt), self.w_1.bias, self.w_2.weight.to(cdt),
            self.w_2.bias, self.activation, ff_scale, ln.eps, rate, rate,
            seed, row_base(b * t))
        return y.reshape(b, t, d)


class TransformerEncoderLayer(nn.Module):
    """Self-attention → FFN (relu) with residuals. Pre-norm
    (``normalize_before``): LN → attention, and the FFN block as one K1
    call. Post-norm: the residual sums are normalised after each sublayer,
    and the FFN is one K6 call with the outer dropout (stream 0) after
    it. With ``concat_after`` the attention's output is
    ``concat_linear([x, att])`` (x the attention's input), a linear
    without a compute dtype, as in the JAX package; its streaming step
    adds the attention's output alone, as the JAX package's does."""

    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 normalize_before: bool = True, concat_after: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadedAttention(
            attention_heads, size, attention_dropout_rate, dtype=dtype)
        self.feed_forward = PositionwiseFeedForward(
            size, linear_units, "relu", dropout_rate, dtype=dtype)
        self.norm1 = LayerNorm(size, dtype=dtype)
        self.norm2 = LayerNorm(size, dtype=dtype)
        self.concat_linear = (Dense(2 * size, size) if concat_after
                              else None)

    def forward(self, x: torch.Tensor, att_bias: torch.Tensor,
                pos_emb: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """As ConformerEncoderLayer.forward; pos_emb and pad_mask are not
        read (the absolute encoding is added before the first layer)."""
        def drop(h):
            return dropout(h, self.dropout_rate, gen)
        xn = self.norm1(x) if self.normalize_before else x
        att = self.self_attn(xn, xn, xn, att_bias, gen=gen)
        if self.concat_linear is not None:
            att = self.concat_linear(torch.cat([xn, att], dim=-1))
        x = x + drop(att)
        if self.normalize_before:
            return self.feed_forward(x, ln=self.norm2, gen=gen)
        x = self.norm1(x)
        return self.norm2(x + drop(self.feed_forward(x, gen=gen)))

    def forward_with_cache(self, x: torch.Tensor, att_cache: torch.Tensor,
                           att_cache_len: int,
                           att_mask: Optional[torch.Tensor] = None,
                           pos_emb: Optional[torch.Tensor] = None):
        """One streaming chunk, no dropout → (x, new att cache, its
        valid length); see ``MultiHeadedAttention.forward_with_cache``."""
        xn = self.norm1(x) if self.normalize_before else x
        att, new_cache, new_len = self.self_attn.forward_with_cache(
            xn, xn, xn, att_cache, att_cache_len, att_mask, pos_emb)
        x = x + att
        if self.normalize_before:
            x = self.feed_forward(x, ln=self.norm2)
        else:
            x = self.norm1(x)
            x = self.norm2(x + self.feed_forward(x))
        return x, new_cache, new_len


class ConformerEncoderLayer(nn.Module):

    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 macaron_style: bool = True, use_cnn_module: bool = True,
                 cnn_module_kernel: int = 15,
                 cnn_module_norm: str = "batch_norm", causal: bool = False,
                 activation: str = "swish", dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 pos_enc_layer_type: str = "rel_pos",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        # The rel-pos attention under rel_pos, plain MHA otherwise.
        attn = (RelPositionMultiHeadedAttention
                if pos_enc_layer_type == "rel_pos" else MultiHeadedAttention)
        self.self_attn = attn(attention_heads, size, attention_dropout_rate,
                              dtype=dtype)
        self.feed_forward = PositionwiseFeedForward(
            size, linear_units, activation, dropout_rate, dtype=dtype)
        self.feed_forward_macaron = None
        if macaron_style:
            self.feed_forward_macaron = PositionwiseFeedForward(
                size, linear_units, activation, dropout_rate, dtype=dtype)
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
                pad_mask: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, T, D]; att_bias [B, T, T] additive; pos_emb [1, T, D];
        pad_mask [B, T] True = valid; ``gen`` drives dropout; training
        mode (``self.training``) puts a batch_norm conv module on the
        batch's statistics."""
        def drop(h):
            return dropout(h, self.dropout_rate, gen)
        if self.feed_forward_macaron is not None:
            x = self.feed_forward_macaron(x, ln=self.norm_ff_macaron,
                                          ff_scale=self.ff_scale, gen=gen)
        x = x + drop(self.self_attn(x, x, x, att_bias, pos_emb, gen,
                                    ln=self.norm_mha))
        if self.conv_module is not None:
            # K8 takes the whole block first; else the module fuses its
            # pre-norm into pointwise conv1 when LNMM_PALLAS routes "conv".
            if self.conv_module.norm == "layer_norm" and use_conv_block():
                x = self._fused_conv_block(x, pad_mask, gen)
            else:
                x = x + drop(self.conv_module(x, pad_mask,
                                              ln=self.norm_conv))
        x = self.feed_forward(x, ln=self.norm_ff, ff_scale=self.ff_scale,
                              gen=gen)
        if self.conv_module is not None:
            x = self.norm_final(x)
        return x

    def _fused_conv_block(self, x, pad_mask, gen):
        """x + drop(conv_module(norm_conv(x))) as one K8 call (weights in
        the JAX layout: w1 [D, 2D], w2 [D, D], taps [K, D])."""
        cm = self.conv_module
        cdt = cm.compute_dtype or x.dtype
        b, t, _ = x.shape
        rate = self.dropout_rate if gen is not None else 0.0
        seed = draw_seed(gen) if rate > 0.0 else 0
        mask = (torch.ones(b, t, device=x.device) if pad_mask is None
                else pad_mask.float())
        p1, p2 = cm.pointwise_conv1, cm.pointwise_conv2
        return conv_block_residual(
            x.to(cdt).contiguous(), mask, self.norm_conv.weight,
            self.norm_conv.bias, p1.weight.t().contiguous().to(cdt), p1.bias,
            cm.depthwise_conv.weight[:, 0, :].t().contiguous(),
            cm.depthwise_conv.bias, cm.norm_layer.weight, cm.norm_layer.bias,
            p2.weight.t().contiguous().to(cdt), p2.bias, seed, cm.causal,
            rate, self.norm_conv.eps, row_base(b))

    def forward_with_cache(self, x: torch.Tensor, att_cache: torch.Tensor,
                           att_cache_len: int, cnn_cache: torch.Tensor,
                           att_mask: Optional[torch.Tensor] = None,
                           pos_emb: Optional[torch.Tensor] = None):
        """One streaming chunk, no dropout: the FFN blocks at rate 0 (K1
        on the card), the attention over the cache ring (no K7), the
        causal conv module on ``norm_conv(x)`` with its frame cache (no
        K8) → (x, new att cache, its valid length, new cnn cache)."""
        if self.feed_forward_macaron is not None:
            x = self.feed_forward_macaron(x, ln=self.norm_ff_macaron,
                                          ff_scale=self.ff_scale)
        xn = self.norm_mha(x)
        att, new_att, new_len = self.self_attn.forward_with_cache(
            xn, xn, xn, att_cache, att_cache_len, att_mask, pos_emb)
        x = x + att
        new_cnn = cnn_cache
        if self.conv_module is not None:
            conv_out, new_cnn = self.conv_module.forward_with_cache(
                self.norm_conv(x), cnn_cache)
            x = x + conv_out
        x = self.feed_forward(x, ln=self.norm_ff, ff_scale=self.ff_scale)
        if self.conv_module is not None:
            x = self.norm_final(x)
        return x, new_att, new_len, new_cnn
