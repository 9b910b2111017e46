"""Transformer and conformer encoders (port of
``wenet_celoss_tpu/models/encoder.py``): cmvn → subsampling + positional
encoding → chunk mask → N layers → LayerNorm with ``normalize_before``.

The self-attention mask is the full context, a static or decode-time
chunk, or (``use_dynamic_chunk`` while the module trains) a chunk drawn
from the step's generator (``utils/mask.py``). ``forward_chunk`` streams
one chunk of features through fixed-size caches (``init_cache``): per
layer a [B, H, C, 2·dk] key/value ring with its valid length and the
causal conv module's last ``lorder`` input frames, and the position
offset. U2's contract ties the two: the streamed output equals the
chunk-masked full forward on the valid frames.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from wenet_celoss_tpu_torch.models.attention import NEG_INF
from wenet_celoss_tpu_torch.models.cmvn import apply_cmvn
from wenet_celoss_tpu_torch.models.embedding import POS_ENC_CLASSES
from wenet_celoss_tpu_torch.models.encoder_layer import (
    ConformerEncoderLayer, TransformerEncoderLayer)
from wenet_celoss_tpu_torch.models.layers import LayerNorm
from wenet_celoss_tpu_torch.models.subsampling import SUBSAMPLE_CLASSES
from wenet_celoss_tpu_torch.utils.mask import (add_optional_chunk_mask,
                                               make_non_pad_mask)


class TransformerEncoder(nn.Module):
    """A subsampling front end (``input_layer``: linear, conv2d, conv2d6
    or conv2d8) with its positional encoding (``pos_enc_layer_type``:
    abs_pos, rel_pos or no_pos; abs_pos by default, as in the JAX
    package, whichever the encoder), then ``num_blocks`` transformer
    layers. ``after_norm`` exists and runs only with ``normalize_before``,
    as in the JAX package, whose post-norm tree has no after_norm
    parameters."""

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, input_layer: str = "conv2d",
                 pos_enc_layer_type: str = "abs_pos",
                 normalize_before: bool = True, concat_after: bool = False,
                 cmvn: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 dtype: Optional[torch.dtype] = None,
                 dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 static_chunk_size: int = 0,
                 use_dynamic_chunk: bool = False,
                 use_dynamic_left_chunk: bool = False, **layer_conf):
        super().__init__()
        if input_layer not in SUBSAMPLE_CLASSES:
            raise ValueError(f"unknown input_layer {input_layer!r}")
        if pos_enc_layer_type not in POS_ENC_CLASSES:
            raise ValueError(f"unknown pos_enc_layer_type "
                             f"{pos_enc_layer_type!r}")
        self.input_layer = input_layer
        self.compute_dtype = dtype
        self.output_size = output_size
        self.attention_heads = attention_heads
        self.num_blocks = num_blocks
        self.static_chunk_size = static_chunk_size
        self.use_dynamic_chunk = use_dynamic_chunk
        self.use_dynamic_left_chunk = use_dynamic_left_chunk
        self.embed = SUBSAMPLE_CLASSES[input_layer](
            input_size, output_size,
            POS_ENC_CLASSES[pos_enc_layer_type](output_size,
                                                positional_dropout_rate),
            dropout_rate, dtype=dtype)
        self.layers = nn.ModuleList([
            self._layer(output_size, attention_heads, linear_units,
                        dropout_rate=dropout_rate,
                        attention_dropout_rate=attention_dropout_rate,
                        normalize_before=normalize_before,
                        concat_after=concat_after,
                        pos_enc_layer_type=pos_enc_layer_type, dtype=dtype,
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
    def _layer(*args, pos_enc_layer_type: str, **kw) -> nn.Module:
        # The transformer layer's attention is plain MHA whatever the
        # encoding, as in the JAX package.
        return TransformerEncoderLayer(*args, **kw)

    @property
    def subsampling_rate(self) -> int:
        return self.embed.subsampling_rate

    @property
    def right_context(self) -> int:
        return self.embed.right_context

    @property
    def streamable(self) -> bool:
        """Whether ``forward_chunk`` can serve this encoder (a non-causal
        conv module has no cache form)."""
        return True

    def _conv_lorder(self) -> int:
        return 0

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor,
                gen: Optional[torch.Generator] = None,
                decoding_chunk_size: int = 0,
                num_decoding_left_chunks: int = -1):
        """xs [B, T, F] features, xs_lens [B] → (ys [B, T', D],
        pad_mask [B, T'] True = valid). With ``gen`` (training) every
        dropout runs, drawing its seed from it. ``decoding_chunk_size``:
        < 0 full context, > 0 a fixed chunk with
        ``num_decoding_left_chunks``, 0 the model's own (a chunk drawn
        from ``gen`` first when ``use_dynamic_chunk`` and the module
        trains; else ``static_chunk_size``)."""
        if self.cmvn_mean is not None:
            xs = apply_cmvn(xs, self.cmvn_mean, self.cmvn_istd)
        xs, pos_emb, xs_lens = self.embed(xs, xs_lens, gen)
        pad_mask = make_non_pad_mask(xs_lens, xs.shape[1])
        att_mask = add_optional_chunk_mask(
            pad_mask, use_dynamic_chunk=self.use_dynamic_chunk
            and self.training,
            use_dynamic_left_chunk=self.use_dynamic_left_chunk,
            decoding_chunk_size=decoding_chunk_size,
            static_chunk_size=self.static_chunk_size,
            num_decoding_left_chunks=num_decoding_left_chunks, gen=gen)
        # The mask as an ADDITIVE bias, built once and shared by all layers.
        att_bias = torch.where(
            att_mask, 0.0, NEG_INF).to(self.compute_dtype or torch.float32)
        for layer in self.layers:
            xs = layer(xs, att_bias, pos_emb, pad_mask, gen)
        if self.after_norm is not None:
            xs = self.after_norm(xs)
        return xs, pad_mask

    # ---------------------------------------------------- streaming ---
    def init_cache(self, batch_size: int, required_cache_size: int) -> dict:
        """Zero caches for ``forward_chunk``, in the compute dtype: "att"
        [L, B, H, C, 2·dk] with C = ``required_cache_size`` (clipped at 0)
        and "att_len" 0 valid slots, "cnn" [L, B, lorder, D], "offset" 0
        frames."""
        dt = self.compute_dtype or torch.float32
        dev = self.embed.out.weight.device
        h = self.attention_heads
        c = max(required_cache_size, 0)
        return {
            "att": torch.zeros(self.num_blocks, batch_size, h, c,
                               2 * (self.output_size // h), dtype=dt,
                               device=dev),
            "att_len": 0,
            "cnn": torch.zeros(self.num_blocks, batch_size,
                               self._conv_lorder(), self.output_size,
                               dtype=dt, device=dev),
            "offset": 0,
        }

    @torch.no_grad()
    def forward_chunk(self, xs: torch.Tensor, cache: dict,
                      chunk_valid: Optional[torch.Tensor] = None):
        """One streaming chunk: xs [B, window, F] raw features (with the
        subsampling's right context) → (ys [B, chunk, D], new cache).

        ``chunk_valid`` [B]: the valid output frames of this chunk per
        utterance; keys past them are masked, so an utterance that ends
        inside the chunk does not attend to the frames after its end."""
        if self.cmvn_mean is not None:
            xs = apply_cmvn(xs, self.cmvn_mean, self.cmvn_istd)
        offset = cache["offset"]
        b = xs.shape[0]
        xs, _, _ = self.embed(
            xs, torch.full((b,), xs.shape[1], device=xs.device), None,
            offset)
        t = xs.shape[1]
        c = cache["att"].shape[3]
        att_mask = None
        if chunk_valid is not None:
            cur_ok = (torch.arange(t, device=xs.device)[None, :]
                      < chunk_valid[:, None])
            att_mask = torch.cat([torch.ones(b, c, dtype=torch.bool,
                                             device=xs.device), cur_ok],
                                 dim=1)[:, None, :]   # [B, 1(q), C + T]
        # The rel-pos table over (cache ++ chunk) keys.
        pos_emb = self.embed.pos_enc.pos_emb(offset - c, c + t,
                                             xs.device).to(xs.dtype)
        new_att, new_cnn = [], []
        new_len = att_len = cache["att_len"]
        for i, layer in enumerate(self.layers):
            xs, a, new_len, cnn = self._layer_with_cache(
                layer, xs, cache["att"][i], att_len, cache["cnn"][i],
                pos_emb, att_mask)
            new_att.append(a)
            new_cnn.append(cnn)
        if self.after_norm is not None:
            xs = self.after_norm(xs)
        return xs, {"att": torch.stack(new_att), "att_len": new_len,
                    "cnn": torch.stack(new_cnn), "offset": offset + t}

    def _layer_with_cache(self, layer, xs, att_cache, att_len, cnn_cache,
                          pos_emb, att_mask):
        out, a, new_len = layer.forward_with_cache(xs, att_cache, att_len,
                                                   att_mask, pos_emb)
        return out, a, new_len, cnn_cache


class ConformerEncoder(TransformerEncoder):
    """A front end and encoding as the transformer's, then
    ``num_blocks`` conformer layers, whose self-attention is the rel-pos
    one under ``rel_pos`` and plain MHA otherwise. The layers are
    pre-norm whatever ``normalize_before`` says (the JAX package's
    conformer layer does not read it); it decides only whether
    ``after_norm`` exists and runs. ``concat_after``,
    ``selfattention_layer_type`` and ``positionwise_conv_kernel_size``
    are accepted and not read, as in the JAX package."""

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, macaron_style: bool = True,
                 activation_type: str = "swish", use_cnn_module: bool = True,
                 cnn_module_kernel: int = 15, causal: bool = False,
                 cnn_module_norm: str = "batch_norm",
                 selfattention_layer_type: str = "rel_selfattn",
                 positionwise_conv_kernel_size: int = 1, **kw):
        super().__init__(
            input_size, output_size, attention_heads, linear_units,
            num_blocks, macaron_style=macaron_style,
            activation=activation_type, use_cnn_module=use_cnn_module,
            cnn_module_kernel=cnn_module_kernel, causal=causal,
            cnn_module_norm=cnn_module_norm, **kw)
        self.use_cnn_module = use_cnn_module
        self.causal = causal
        self.cnn_module_kernel = cnn_module_kernel

    @staticmethod
    def _layer(*args, normalize_before: bool, concat_after: bool,
               **kw) -> nn.Module:
        return ConformerEncoderLayer(*args, **kw)

    @property
    def streamable(self) -> bool:
        return self.causal or not self.use_cnn_module

    def _conv_lorder(self) -> int:
        return (self.cnn_module_kernel - 1
                if self.use_cnn_module and self.causal else 0)

    def _layer_with_cache(self, layer, xs, att_cache, att_len, cnn_cache,
                          pos_emb, att_mask):
        if not self.streamable:
            raise NotImplementedError(
                "streaming a conformer with a CNN module requires "
                "causal=True")
        return layer.forward_with_cache(xs, att_cache, att_len, cnn_cache,
                                        att_mask, pos_emb)
