"""Contextual biasing (hotwords) (port of
``wenet_celoss_tpu/models/context_bias.py``: the BLSTM, LSTM and
transformer phrase extractors, the ``linear`` and ``transformer`` context
(bias) encoders, the encoder/predictor bias branches with the optional
``n_valid`` key mask, and the hotword-presence heads of the three loss
modes).

The transformer extractor and the transformer bias encoder are the
port's ``TransformerEncoder`` with a ``linear`` front end (absolute and no
positional encoding), so each pre-norm FFN block of theirs is one K1
launch on the card; both run without dropout, as the JAX package calls
them (deterministic) whatever the step.

The whole module runs in fp32 whatever the model's compute dtype, as the
JAX package's does (its layers carry no dtype). The heads it holds depend
on ``loss_mode``, as the JAX package's parameter tree does (flax creates a
head's parameters only where the mode calls it): ``both`` the enc/dec
projections and the unified-space attention, ``pred`` the predictor
projection ``hw_pred_proj`` and the attention, ``sep`` the enc/dec
projections alone.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from wenet_celoss_tpu_torch.models.attention import MultiHeadedAttention
from wenet_celoss_tpu_torch.models.encoder import TransformerEncoder
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


class LSTMExtractor(nn.Module):
    """[N, L] phrases → [N, 4e]: linear([h, c]) of a masked LSTM's last
    layer."""

    def __init__(self, vocab_size: int, hidden_dim: int, num_layers: int):
        super().__init__()
        self.embed = nn.Embedding(vocab_size, hidden_dim)
        self.rnn = MaskedLSTM(hidden_dim, num_layers)
        self.linear = Dense(2 * hidden_dim, 4 * hidden_dim)

    def forward(self, phrases: torch.Tensor, lengths: torch.Tensor):
        h, c = self.rnn(self.embed(phrases.clamp_min(0)), lengths)
        return self.linear(torch.cat([h, c], dim=-1))


class TransformerExtractor(nn.Module):
    """[N, L] phrases → [N, 4e]: a CLS token (id 1) prepended, the -1
    padding clamped to 0, a 3-block pre-norm transformer encoder (linear
    front end, absolute encoding, 8 heads, F = 4e) over ``lengths + 1``
    frames, and ``linear`` of the CLS position."""

    def __init__(self, vocab_size: int, hidden_dim: int,
                 num_layers: int = 3, attention_heads: int = 8):
        super().__init__()
        self.embed = nn.Embedding(vocab_size, hidden_dim)
        self.encoder = TransformerEncoder(
            hidden_dim, hidden_dim, attention_heads, 4 * hidden_dim,
            num_layers, input_layer="linear", pos_enc_layer_type="abs_pos",
            dropout_rate=0.1)
        self.linear = Dense(hidden_dim, 4 * hidden_dim)

    def forward(self, phrases: torch.Tensor, lengths: torch.Tensor):
        cls = torch.ones_like(phrases[:, :1])
        toks = torch.cat([cls, phrases.clamp_min(0)], dim=1)
        out, _ = self.encoder(self.embed(toks), lengths + 1)
        return self.linear(out[:, 0])


class ContextBias(nn.Module):

    def __init__(self, output_size: int, vocab_size: int,
                 embedding_size: int, num_layers: int = 2,
                 attention_heads: int = 4, linear_units: int = 512,
                 num_block: int = 4, dropout_rate: float = 0.0,
                 bias_encoder_type: str = "linear",
                 context_extractor: str = "BLSTM", num_labels: int = 2,
                 unified_hw_odim: int = 100, unified_hw_heads: int = 4,
                 loss_mode: str = "both"):
        # linear_units / num_block / dropout_rate configure the
        # transformer bias encoder (its dropout never runs: the JAX
        # package calls it deterministic).
        super().__init__()
        if context_extractor not in ("BLSTM", "LSTM", "transformer"):
            raise ValueError(f"unknown context_extractor "
                             f"{context_extractor!r}")
        if bias_encoder_type not in ("linear", "transformer"):
            raise ValueError(f"unknown bias_encoder_type "
                             f"{bias_encoder_type!r}")
        if loss_mode not in ("both", "pred", "sep"):
            raise ValueError(f"unknown loss_mode {loss_mode!r}")
        # Registration order is the order in which the factory draws the
        # seeded weights; ``both`` keeps the decode model's order.
        e = embedding_size
        if context_extractor == "transformer":
            self.extractor = TransformerExtractor(vocab_size, e)
        elif context_extractor == "LSTM":
            self.extractor = LSTMExtractor(vocab_size, e, num_layers)
        else:
            self.extractor = BLSTMExtractor(vocab_size, e, num_layers)
        if bias_encoder_type == "transformer":
            self.context_encoder = TransformerEncoder(
                4 * e, e, attention_heads, linear_units, num_block,
                input_layer="linear", pos_enc_layer_type="no_pos",
                dropout_rate=dropout_rate, positional_dropout_rate=0.0,
                attention_dropout_rate=0.0)
        else:
            self.context_encoder = None
            self.context_proj = Dense(4 * e, e)
            self.context_norm = LayerNorm(e)
        self.encoder_bias = MultiHeadedAttention(attention_heads, e)
        self.predictor_bias = MultiHeadedAttention(attention_heads, e)
        if loss_mode != "sep":
            self.hw_bias = MultiHeadedAttention(unified_hw_heads,
                                                unified_hw_odim)
        self.encoder_bias_combine = Dense(2 * e, e)
        self.encoder_bias_bias_norm = LayerNorm(e)
        self.encoder_bias_out_norm = LayerNorm(e)
        self.predictor_bias_combine = Dense(2 * e, e)
        self.predictor_bias_bias_norm = LayerNorm(e)
        self.predictor_bias_out_norm = LayerNorm(e)
        if loss_mode != "sep":
            self.hw_bias_norm = LayerNorm(unified_hw_odim)
            self.hw_output_layer = Dense(unified_hw_odim, num_labels)
        if loss_mode != "pred":
            self.hw_output_layer_enc = Dense(e, unified_hw_odim)
            self.hw_output_layer_dec = Dense(e, unified_hw_odim)
        else:
            # The reference feeds embedding_size activations into a
            # unified_hw_odim attention; the JAX package makes the
            # projection explicit.
            self.hw_pred_proj = Dense(e, unified_hw_odim)

    def forward_bias_hidden(self, context_list: torch.Tensor,
                            context_lengths: torch.Tensor,
                            n_valid=None) -> torch.Tensor:
        """[N, L] phrase ids (-1 padded) + [N] lengths → [1, N, e]. The
        transformer bias encoder attends over the first ``n_valid``
        phrases (all N without it); the linear one reads each alone."""
        vec = self.extractor(context_list, context_lengths)
        if self.context_encoder is None:
            return self.context_norm(self.context_proj(vec))[None]
        n = context_list.shape[0]
        lens = (torch.as_tensor(n_valid, device=vec.device).reshape(1)
                if n_valid is not None
                else torch.full((1,), n, device=vec.device))
        return self.context_encoder(vec[None], lens)[0]

    def _cross_bias(self, attn, stream, bias_hidden, n_valid=None):
        """Cross-attention of ``stream`` over the phrases; with ``n_valid``
        the phrase slots from n_valid on are masked out."""
        b, n = stream.shape[0], bias_hidden.shape[1]
        bias_kv = bias_hidden.expand((b,) + bias_hidden.shape[1:])
        mask = None
        if n_valid is not None:
            keep = torch.arange(n, device=stream.device) < n_valid
            mask = keep[None, None, :].expand(b, 1, n)
        return attn(stream.float(), bias_kv, bias_kv, mask)

    def forward_encoder_bias(self, bias_hidden: torch.Tensor,
                             encoder_out: torch.Tensor, n_valid=None):
        """→ (combined encoder_out, encoder bias branch), fp32."""
        enc_bias = self.encoder_bias_bias_norm(
            self._cross_bias(self.encoder_bias, encoder_out, bias_hidden,
                             n_valid))
        cat = torch.cat([encoder_out.float(), enc_bias], dim=-1)
        return self.encoder_bias_out_norm(self.encoder_bias_combine(cat)), \
            enc_bias

    def forward_predictor_bias(self, bias_hidden: torch.Tensor,
                               predictor_out: torch.Tensor, n_valid=None):
        pred_bias = self.predictor_bias_bias_norm(
            self._cross_bias(self.predictor_bias, predictor_out,
                             bias_hidden, n_valid))
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

    def forward_hw_pred(self, bias_hidden: torch.Tensor,
                        predictor_out: torch.Tensor) -> torch.Tensor:
        """``pred`` mode: the (unbiased) predictor stream attends over the
        hotword list → [B, U, num_labels]."""
        b = predictor_out.shape[0]
        q = self.hw_pred_proj(predictor_out.float())
        kv = self.hw_pred_proj(bias_hidden.expand(
            (b,) + bias_hidden.shape[1:]))
        h = self.hw_bias(q, kv, kv)
        return self.hw_output_layer(self.hw_bias_norm(h))

    def forward_hw_pred_both_sep(self, enc_bias: torch.Tensor,
                                 pred_bias: torch.Tensor):
        """``sep`` mode: independent enc/dec projections into the hw
        space → ([B, T, odim], [B, U, odim])."""
        return (self.hw_output_layer_enc(enc_bias),
                self.hw_output_layer_dec(pred_bias))
