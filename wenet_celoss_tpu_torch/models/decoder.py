"""Attention decoders, teacher-forced (port of
``wenet_celoss_tpu/models/decoder.py``): the left-to-right transformer
decoder and the bidirectional (U2++) wrapper with its right-to-left
decoder. Pre-norm layers (``normalize_before``): each FFN block is one
launch of the K1 kernel (relu, ff_scale 1), and the self-attention's
pre-norm and QKV projection one launch of K7 when ``LNMM_PALLAS`` routes
"attn" (never under ``concat_after``, as in the JAX package). Post-norm
layers: each FFN is one launch of K6, and no ``after_norm`` exists.
Without ``use_output_layer`` a decoder returns its normalised hidden
states. ``forward_one_step`` is the attention beam
search's step. Dropout runs when the caller passes a generator
(training).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from wenet_celoss_tpu_torch.models.attention import MultiHeadedAttention
from wenet_celoss_tpu_torch.models.embedding import PositionalEncoding
from wenet_celoss_tpu_torch.models.encoder_layer import \
    PositionwiseFeedForward
from wenet_celoss_tpu_torch.models.layers import Dense, LayerNorm
from wenet_celoss_tpu_torch.ops.dropout import dropout
from wenet_celoss_tpu_torch.utils.common import acc_dtype
from wenet_celoss_tpu_torch.utils.mask import (make_non_pad_mask,
                                               subsequent_mask)


class DecoderLayer(nn.Module):
    """Self-attention → cross-attention → FFN, each with a residual, pre-norm
    or post-norm (``normalize_before``). With ``concat_after`` each
    attention's output is ``concat_linear{1,2}([x, att])`` (x the
    attention's input; linears without a compute dtype, as in the JAX
    package), and the self-attention's pre-norm is never fused into its
    projection (K7), as the JAX package fuses it only without
    concat_after."""

    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0,
                 normalize_before: bool = True, concat_after: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadedAttention(
            attention_heads, size, self_attention_dropout_rate, dtype=dtype)
        self.src_attn = MultiHeadedAttention(
            attention_heads, size, src_attention_dropout_rate, dtype=dtype)
        self.feed_forward = PositionwiseFeedForward(
            size, linear_units, "relu", dropout_rate, dtype=dtype)
        self.norm1 = LayerNorm(size, dtype=dtype)
        self.norm2 = LayerNorm(size, dtype=dtype)
        self.norm3 = LayerNorm(size, dtype=dtype)
        self.concat_linear1 = self.concat_linear2 = None
        if concat_after:
            self.concat_linear1 = Dense(2 * size, size)
            self.concat_linear2 = Dense(2 * size, size)

    def forward(self, tgt, tgt_mask, memory, memory_mask, gen=None):
        """tgt [B, U, D]; tgt_mask [B, U, U] bool; memory [B, T, D];
        memory_mask [B, 1, T] bool."""
        def drop(h):
            return dropout(h, self.dropout_rate, gen)
        pre = self.normalize_before
        if pre and self.concat_linear1 is None:
            x = tgt + drop(self.self_attn(tgt, tgt, tgt, tgt_mask, gen=gen,
                                          ln=self.norm1))
        else:
            xn = self.norm1(tgt) if pre else tgt
            sa = self.self_attn(xn, xn, xn, tgt_mask, gen=gen)
            if self.concat_linear1 is not None:
                sa = self.concat_linear1(torch.cat([xn, sa], dim=-1))
            x = tgt + drop(sa)
            if not pre:
                x = self.norm1(x)
        xn = self.norm2(x) if pre else x
        ca = self.src_attn(xn, memory, memory, memory_mask, gen=gen)
        if self.concat_linear2 is not None:
            ca = self.concat_linear2(torch.cat([xn, ca], dim=-1))
        x = x + drop(ca)
        if pre:
            return self.feed_forward(x, ln=self.norm3, ff_scale=1.0, gen=gen)
        x = self.norm2(x)
        return self.norm3(x + drop(self.feed_forward(x, gen=gen)))


class TransformerDecoder(nn.Module):

    def __init__(self, vocab_size: int, encoder_output_size: int,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0,
                 use_output_layer: bool = True,
                 normalize_before: bool = True, concat_after: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        d = encoder_output_size
        self.embed_tokens = nn.Embedding(vocab_size, d)
        self.pos_enc = PositionalEncoding(d, positional_dropout_rate)
        self.decoders = nn.ModuleList([DecoderLayer(
            d, attention_heads, linear_units, dropout_rate,
            self_attention_dropout_rate, src_attention_dropout_rate,
            normalize_before, concat_after, dtype=dtype)
            for _ in range(num_blocks)])
        self.after_norm = (LayerNorm(d, dtype=dtype) if normalize_before
                           else None)
        self.output_layer = (Dense(d, vocab_size, dtype=dtype)
                             if use_output_layer else None)

    def _output(self, x: torch.Tensor) -> torch.Tensor:
        if self.after_norm is not None:
            x = self.after_norm(x)
        return x if self.output_layer is None else self.output_layer(x)

    def forward(self, memory, memory_pad_mask, ys_in_pad, ys_in_lens,
                gen=None):
        """memory [B, T, D], memory_pad_mask [B, T] True = valid,
        ys_in_pad [B, U] (<sos> + tokens), ys_in_lens [B] → logits
        [B, U, V]."""
        u = ys_in_pad.shape[1]
        tgt_mask = (make_non_pad_mask(ys_in_lens, u)[:, None, :]
                    & subsequent_mask(u, ys_in_pad.device)[None])
        x, _ = self.pos_enc(self.embed_tokens(ys_in_pad), gen)
        mem_mask = memory_pad_mask[:, None, :]
        for layer in self.decoders:
            x = layer(x, tgt_mask, memory, mem_mask, gen)
        return self._output(x)

    def forward_one_step(self, memory, memory_pad_mask, ys_buffer,
                         pos: int) -> torch.Tensor:
        """One beam-search step over a fixed-size token buffer: the causal
        decoder over the whole buffer ys_buffer [B, L] with the positions
        after ``pos`` masked, then ``after_norm`` and the output layer on
        row ``pos`` alone → fp32 log-probs of the next token [B, V].
        Every step reruns the whole buffer, as the JAX package does (a
        search is quadratic in L; a KV cache is a later optimisation).
        memory [B, T, D], memory_pad_mask [B, T] True = valid."""
        l_max = ys_buffer.shape[1]
        dev = ys_buffer.device
        valid = torch.arange(l_max, device=dev) <= pos
        tgt_mask = valid[None, None, :] & subsequent_mask(l_max, dev)[None]
        x, _ = self.pos_enc(self.embed_tokens(ys_buffer))
        mem_mask = memory_pad_mask[:, None, :]
        for layer in self.decoders:
            x = layer(x, tgt_mask, memory, mem_mask)
        logits = self._output(x[:, pos])
        return torch.log_softmax(logits.to(acc_dtype(logits.dtype)), dim=-1)


class BiTransformerDecoder(nn.Module):
    """Left-to-right decoder plus, with ``r_num_blocks > 0``, a
    right-to-left one over the reversed labels (U2++)."""

    def __init__(self, vocab_size: int, encoder_output_size: int,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, r_num_blocks: int = 0,
                 dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0,
                 use_output_layer: bool = True,
                 normalize_before: bool = True, concat_after: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(vocab_size=vocab_size,
                  encoder_output_size=encoder_output_size,
                  attention_heads=attention_heads,
                  linear_units=linear_units, dropout_rate=dropout_rate,
                  positional_dropout_rate=positional_dropout_rate,
                  self_attention_dropout_rate=self_attention_dropout_rate,
                  src_attention_dropout_rate=src_attention_dropout_rate,
                  use_output_layer=use_output_layer,
                  normalize_before=normalize_before,
                  concat_after=concat_after, dtype=dtype)
        self.left_decoder = TransformerDecoder(num_blocks=num_blocks, **kw)
        self.right_decoder = (TransformerDecoder(num_blocks=r_num_blocks,
                                                 **kw)
                              if r_num_blocks > 0 else None)

    def forward(self, memory, memory_pad_mask, ys_in_pad, ys_in_lens,
                r_ys_in_pad=None, reverse_weight: float = 0.0, gen=None):
        """→ (left logits, right logits or zeros like them)."""
        l_x = self.left_decoder(memory, memory_pad_mask, ys_in_pad,
                                ys_in_lens, gen)
        if self.right_decoder is None or reverse_weight <= 0.0:
            return l_x, torch.zeros_like(l_x)
        r_x = self.right_decoder(memory, memory_pad_mask, r_ys_in_pad,
                                 ys_in_lens, gen)
        return l_x, r_x

    def forward_one_step(self, memory, memory_pad_mask, ys_buffer,
                         pos: int) -> torch.Tensor:
        """The left-to-right decoder's step (see TransformerDecoder)."""
        return self.left_decoder.forward_one_step(memory, memory_pad_mask,
                                                  ys_buffer, pos)
