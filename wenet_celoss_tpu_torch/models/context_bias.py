"""Contextual biasing (hotwords), decode path (port of
``wenet_celoss_tpu/models/context_bias.py``: the BLSTM phrase extractor,
the ``linear`` context encoder, the encoder/predictor bias branches and
the ``both``-mode hotword-gate head).

The whole module runs in fp32 whatever the model's compute dtype, as the
JAX package's does (its layers carry no dtype).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from wenet_celoss_tpu_torch.models.attention import MultiHeadedAttention
from wenet_celoss_tpu_torch.models.layers import (Dense, LayerNorm,
                                                  LSTMCellParams)
from wenet_celoss_tpu_torch.utils.common import reverse_pad_list


class MaskedLSTM(nn.Module):
    """Stacked LSTM whose state freezes past each sequence's length
    (the effect of pack_padded_sequence); returns the last layer's final
    (h, c)."""

    def __init__(self, hidden: int, num_layers: int):
        super().__init__()
        self.hidden = hidden
        self.cells = nn.ModuleList([LSTMCellParams(hidden, hidden)
                                    for _ in range(num_layers)])

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        """x [N, L, E], lengths [N] → (h [N, H], c [N, H])."""
        n, steps = x.shape[0], x.shape[1]
        h = c = None
        for cell in self.cells:
            c = torch.zeros(n, self.hidden, dtype=x.dtype, device=x.device)
            h = torch.zeros_like(c)
            xw = cell.input_proj(x)
            outs = []
            for t in range(steps):
                new_c, new_h = cell.step(xw[:, t], c, h)
                active = (t < lengths)[:, None]
                c = torch.where(active, new_c, c)
                h = torch.where(active, new_h, h)
                outs.append(h)
            x = torch.stack(outs, dim=1)
        return h, c


class BLSTMExtractor(nn.Module):
    """[N, L] phrases → [N, 4e] = [h_fwd, h_bwd, c_fwd, c_bwd]."""

    def __init__(self, vocab_size: int, hidden_dim: int, num_layers: int):
        super().__init__()
        self.embed = nn.Embedding(vocab_size, hidden_dim)
        self.fwd = MaskedLSTM(hidden_dim, num_layers)
        self.bwd = MaskedLSTM(hidden_dim, num_layers)

    def forward(self, phrases: torch.Tensor, lengths: torch.Tensor):
        toks = phrases.clamp_min(0)
        h_f, c_f = self.fwd(self.embed(toks), lengths)
        rev = reverse_pad_list(toks, lengths, 0)
        h_b, c_b = self.bwd(self.embed(rev), lengths)
        return torch.cat([h_f, h_b, c_f, c_b], dim=-1)


class ContextBias(nn.Module):

    def __init__(self, output_size: int, vocab_size: int,
                 embedding_size: int, num_layers: int = 2,
                 attention_heads: int = 4, linear_units: int = 512,
                 num_block: int = 4, dropout_rate: float = 0.0,
                 bias_encoder_type: str = "linear",
                 context_extractor: str = "BLSTM", num_labels: int = 2,
                 unified_hw_odim: int = 100, unified_hw_heads: int = 4):
        # linear_units / num_block / dropout_rate configure the
        # transformer context encoder, which is not ported.
        super().__init__()
        if context_extractor != "BLSTM" or bias_encoder_type != "linear":
            raise NotImplementedError(
                f"context_extractor={context_extractor!r}, "
                f"bias_encoder_type={bias_encoder_type!r}: only BLSTM + "
                "linear are ported")
        e = embedding_size
        self.extractor = BLSTMExtractor(vocab_size, e, num_layers)
        self.context_proj = Dense(4 * e, e)
        self.context_norm = LayerNorm(e)
        self.encoder_bias = MultiHeadedAttention(attention_heads, e)
        self.predictor_bias = MultiHeadedAttention(attention_heads, e)
        self.hw_bias = MultiHeadedAttention(unified_hw_heads,
                                            unified_hw_odim)
        self.encoder_bias_combine = Dense(2 * e, e)
        self.encoder_bias_bias_norm = LayerNorm(e)
        self.encoder_bias_out_norm = LayerNorm(e)
        self.predictor_bias_combine = Dense(2 * e, e)
        self.predictor_bias_bias_norm = LayerNorm(e)
        self.predictor_bias_out_norm = LayerNorm(e)
        self.hw_bias_norm = LayerNorm(unified_hw_odim)
        self.hw_output_layer = Dense(unified_hw_odim, num_labels)
        self.hw_output_layer_enc = Dense(e, unified_hw_odim)
        self.hw_output_layer_dec = Dense(e, unified_hw_odim)

    def forward_bias_hidden(self, context_list: torch.Tensor,
                            context_lengths: torch.Tensor) -> torch.Tensor:
        """[N, L] phrase ids (-1 padded) + [N] lengths → [1, N, e]."""
        vec = self.extractor(context_list, context_lengths)
        return self.context_norm(self.context_proj(vec))[None]

    def _cross_bias(self, attn, stream, bias_hidden):
        bias_kv = bias_hidden.expand((stream.shape[0],)
                                     + bias_hidden.shape[1:])
        return attn(stream.float(), bias_kv, bias_kv)

    def forward_encoder_bias(self, bias_hidden: torch.Tensor,
                             encoder_out: torch.Tensor):
        """→ (combined encoder_out, encoder bias branch), fp32."""
        enc_bias = self.encoder_bias_bias_norm(
            self._cross_bias(self.encoder_bias, encoder_out, bias_hidden))
        cat = torch.cat([encoder_out.float(), enc_bias], dim=-1)
        return self.encoder_bias_out_norm(self.encoder_bias_combine(cat)), \
            enc_bias

    def forward_predictor_bias(self, bias_hidden: torch.Tensor,
                               predictor_out: torch.Tensor):
        pred_bias = self.predictor_bias_bias_norm(
            self._cross_bias(self.predictor_bias, predictor_out,
                             bias_hidden))
        cat = torch.cat([predictor_out.float(), pred_bias], dim=-1)
        return (self.predictor_bias_out_norm(
            self.predictor_bias_combine(cat)), pred_bias)

    def forward_hw_pred_both(self, enc_bias: torch.Tensor,
                             pred_bias: torch.Tensor) -> torch.Tensor:
        """``both`` mode: dec-hw queries attend over enc-hw keys →
        [B, U, num_labels]."""
        enc_hw = self.hw_output_layer_enc(enc_bias)
        dec_hw = self.hw_output_layer_dec(pred_bias)
        h = self.hw_bias(dec_hw, enc_hw, enc_hw)
        return self.hw_output_layer(self.hw_bias_norm(h))
