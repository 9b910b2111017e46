"""Conformer encoder, full context (port of
``wenet_celoss_tpu/models/encoder.py``: cmvn → subsampling + rel-pos
encoding → N conformer layers → LayerNorm; chunked and streaming
forwards come with the streaming slice)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from wenet_celoss_tpu_torch.models.attention import NEG_INF
from wenet_celoss_tpu_torch.models.cmvn import apply_cmvn
from wenet_celoss_tpu_torch.models.embedding import RelPositionalEncoding
from wenet_celoss_tpu_torch.models.encoder_layer import ConformerEncoderLayer
from wenet_celoss_tpu_torch.models.layers import LayerNorm
from wenet_celoss_tpu_torch.models.subsampling import Conv2dSubsampling4
from wenet_celoss_tpu_torch.utils.mask import make_non_pad_mask


class ConformerEncoder(nn.Module):

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, input_layer: str = "conv2d",
                 pos_enc_layer_type: str = "rel_pos",
                 normalize_before: bool = True, macaron_style: bool = True,
                 activation_type: str = "swish", use_cnn_module: bool = True,
                 cnn_module_kernel: int = 15, causal: bool = False,
                 cnn_module_norm: str = "batch_norm",
                 cmvn: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 dtype: Optional[torch.dtype] = None,
                 dropout_rate: float = 0.0,
                 positional_dropout_rate: float = 0.0,
                 attention_dropout_rate: float = 0.0):
        # The dropout rates are accepted for config compatibility; every
        # dropout is an identity at decode time.
        super().__init__()
        if input_layer != "conv2d" or pos_enc_layer_type != "rel_pos":
            raise NotImplementedError(
                f"input_layer={input_layer!r}, pos_enc_layer_type="
                f"{pos_enc_layer_type!r}: only conv2d + rel_pos are ported")
        if not normalize_before:
            raise NotImplementedError("post-norm layers are not ported")
        self.input_layer = input_layer
        self.compute_dtype = dtype
        self.embed = Conv2dSubsampling4(
            input_size, output_size, RelPositionalEncoding(output_size),
            dtype=dtype)
        self.layers = nn.ModuleList([
            ConformerEncoderLayer(
                output_size, attention_heads, linear_units,
                macaron_style=macaron_style, use_cnn_module=use_cnn_module,
                cnn_module_kernel=cnn_module_kernel,
                cnn_module_norm=cnn_module_norm, causal=causal,
                activation=activation_type, dtype=dtype)
            for _ in range(num_blocks)])
        self.after_norm = LayerNorm(output_size, dtype=dtype)
        if cmvn is not None:
            self.register_buffer(
                "cmvn_mean", torch.as_tensor(cmvn[0], dtype=torch.float32))
            self.register_buffer(
                "cmvn_istd", torch.as_tensor(cmvn[1], dtype=torch.float32))
        else:
            self.cmvn_mean = self.cmvn_istd = None

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor):
        """xs [B, T, F] features, xs_lens [B] → (ys [B, T', D],
        pad_mask [B, T'] True = valid)."""
        if self.cmvn_mean is not None:
            xs = apply_cmvn(xs, self.cmvn_mean, self.cmvn_istd)
        xs, pos_emb, xs_lens = self.embed(xs, xs_lens)
        pad_mask = make_non_pad_mask(xs_lens, xs.shape[1])
        att_mask = pad_mask[:, None, :] & pad_mask[:, :, None]
        # The mask as an ADDITIVE bias, built once and shared by all layers.
        att_bias = torch.where(
            att_mask, 0.0, NEG_INF).to(self.compute_dtype or torch.float32)
        for layer in self.layers:
            xs = layer(xs, att_bias, pos_emb, pad_mask)
        return self.after_norm(xs), pad_mask
