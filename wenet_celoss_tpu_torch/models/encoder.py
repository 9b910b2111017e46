"""Transformer and conformer encoders, full context (port of
``wenet_celoss_tpu/models/encoder.py``: cmvn → subsampling + positional
encoding → N layers → LayerNorm with ``normalize_before``; chunked and
streaming forwards come with the streaming slice)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from wenet_celoss_tpu_torch.models.attention import NEG_INF
from wenet_celoss_tpu_torch.models.cmvn import apply_cmvn
from wenet_celoss_tpu_torch.models.embedding import (PositionalEncoding,
                                                     RelPositionalEncoding)
from wenet_celoss_tpu_torch.models.encoder_layer import (
    ConformerEncoderLayer, TransformerEncoderLayer)
from wenet_celoss_tpu_torch.models.layers import LayerNorm
from wenet_celoss_tpu_torch.models.subsampling import Conv2dSubsampling4
from wenet_celoss_tpu_torch.utils.mask import make_non_pad_mask


class TransformerEncoder(nn.Module):
    """conv2d subsampling with the absolute positional encoding, then
    ``num_blocks`` transformer layers. ``after_norm`` exists and runs only
    with ``normalize_before``, as in the JAX package, whose post-norm tree
    has no after_norm parameters."""
    pos_enc_layer_type = "abs_pos"

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, input_layer: str = "conv2d",
                 pos_enc_layer_type: Optional[str] = None,
                 normalize_before: bool = True,
                 cmvn: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 dtype: Optional[torch.dtype] = None,
                 dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0, **layer_conf):
        super().__init__()
        pos_enc = pos_enc_layer_type or self.pos_enc_layer_type
        if input_layer != "conv2d" or pos_enc != self.pos_enc_layer_type:
            raise NotImplementedError(
                f"input_layer={input_layer!r}, pos_enc_layer_type="
                f"{pos_enc!r}: only conv2d + {self.pos_enc_layer_type} are "
                f"ported for {type(self).__name__}")
        self.input_layer = input_layer
        self.compute_dtype = dtype
        enc = (RelPositionalEncoding if pos_enc == "rel_pos"
               else PositionalEncoding)
        self.embed = Conv2dSubsampling4(
            input_size, output_size, enc(output_size,
                                         positional_dropout_rate),
            dtype=dtype)
        self.layers = nn.ModuleList([
            self._layer(output_size, attention_heads, linear_units,
                        dropout_rate=dropout_rate,
                        attention_dropout_rate=attention_dropout_rate,
                        normalize_before=normalize_before, dtype=dtype,
                        **layer_conf)
            for _ in range(num_blocks)])
        self.after_norm = (LayerNorm(output_size, dtype=dtype)
                           if normalize_before else None)
        if cmvn is not None:
            self.register_buffer(
                "cmvn_mean", torch.as_tensor(cmvn[0], dtype=torch.float32))
            self.register_buffer(
                "cmvn_istd", torch.as_tensor(cmvn[1], dtype=torch.float32))
        else:
            self.cmvn_mean = self.cmvn_istd = None

    @staticmethod
    def _layer(*args, **kw) -> nn.Module:
        return TransformerEncoderLayer(*args, **kw)

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor,
                gen: Optional[torch.Generator] = None):
        """xs [B, T, F] features, xs_lens [B] → (ys [B, T', D],
        pad_mask [B, T'] True = valid). With ``gen`` (training) every
        dropout runs, drawing its seed from it."""
        if self.cmvn_mean is not None:
            xs = apply_cmvn(xs, self.cmvn_mean, self.cmvn_istd)
        xs, pos_emb, xs_lens = self.embed(xs, xs_lens, gen)
        pad_mask = make_non_pad_mask(xs_lens, xs.shape[1])
        att_mask = pad_mask[:, None, :] & pad_mask[:, :, None]
        # The mask as an ADDITIVE bias, built once and shared by all layers.
        att_bias = torch.where(
            att_mask, 0.0, NEG_INF).to(self.compute_dtype or torch.float32)
        for layer in self.layers:
            xs = layer(xs, att_bias, pos_emb, pad_mask, gen)
        if self.after_norm is not None:
            xs = self.after_norm(xs)
        return xs, pad_mask


class ConformerEncoder(TransformerEncoder):
    """conv2d subsampling with the rel-pos encoding, then ``num_blocks``
    conformer layers. The layers are pre-norm whatever
    ``normalize_before`` says (the JAX package's conformer layer does not
    read it); it decides only whether ``after_norm`` exists and runs."""
    pos_enc_layer_type = "rel_pos"

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, macaron_style: bool = True,
                 activation_type: str = "swish", use_cnn_module: bool = True,
                 cnn_module_kernel: int = 15, causal: bool = False,
                 cnn_module_norm: str = "batch_norm", **kw):
        super().__init__(
            input_size, output_size, attention_heads, linear_units,
            num_blocks, macaron_style=macaron_style,
            activation=activation_type, use_cnn_module=use_cnn_module,
            cnn_module_kernel=cnn_module_kernel, causal=causal,
            cnn_module_norm=cnn_module_norm, **kw)

    @staticmethod
    def _layer(*args, normalize_before: bool, **kw) -> nn.Module:
        return ConformerEncoderLayer(*args, **kw)
