"""Transducer predictors (port of ``wenet_celoss_tpu/models/predictor.py``):
the RNN predictor (LSTM or GRU layers), and the stateless
``EmbeddingPredictor`` and ``ConvPredictor`` over a window of the last
``history_size`` labels. Each has ``init_state``, the whole-sequence
training forward, ``forward_step`` with the padding freeze (a padded row
keeps its old state) and ``gather_state``, which reorders a state's rows
(the beam search's parents): the RNN's state is [L, B, H] (rows on dim
1), the stateless predictors' ``history`` [B, C - 1, E] (rows on dim 0).

The RNN's whole-sequence forward is routed as the JAX package routes it:
with a zero state, an LSTM and 2 layers it runs the hoisted layer-1 input
projection as one plain matmul and then K4 (``ops/lstm.py``), which holds
both layers and the inter-layer dropout; otherwise the plain layers.
Differences from the JAX package's fused route: it runs in the model's
compute dtype (the TPU path hard-codes bf16), the embedding is a gather
(the TPU path's one-hot matmul gives the same values), and there is no
``fused_rows_for`` limit on the sequence length (that is the TPU's VMEM
budget; the kernel keeps its states in device memory). A GRU runs the
plain cell loop (flax's ``GRUCell`` through ``nn.scan``; K4 is an LSTM
kernel), as do the stateless predictors their plain torch ops.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from wenet_celoss_tpu_torch.models.layers import (Dense, GRUCellParams,
                                                  LayerNorm, LSTMCellParams)
from wenet_celoss_tpu_torch.ops import dropout as drop
from wenet_celoss_tpu_torch.ops.lstm import lstm2_seq
from wenet_celoss_tpu_torch.utils.common import get_activation


class RNNPredictor(nn.Module):

    def __init__(self, voca_size: int, embed_size: int, output_size: int,
                 hidden_size: int = 256, num_layers: int = 2,
                 bias: bool = True, rnn_type: str = "lstm",
                 embed_dropout: float = 0.1, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if rnn_type not in ("lstm", "gru"):
            raise ValueError(f"unknown rnn_type {rnn_type!r}")
        self.rnn_type = rnn_type
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.embed_dropout = embed_dropout
        self.dropout = dropout
        self.compute_dtype = dtype
        self.embed = nn.Embedding(voca_size, embed_size)
        cell = LSTMCellParams if rnn_type == "lstm" else GRUCellParams
        self.rnn = nn.ModuleList([
            cell(embed_size if i == 0 else hidden_size, hidden_size)
            for i in range(num_layers)])
        self.projection = Dense(hidden_size, output_size, bias=bias)

    def init_state(self, batch_size: int,
                   device: torch.device) -> Dict[str, torch.Tensor]:
        shape = (self.num_layers, batch_size, self.hidden_size)
        state = {"h": torch.zeros(shape, device=device)}
        if self.rnn_type == "lstm":
            state["c"] = torch.zeros(shape, device=device)
        return state

    @staticmethod
    def gather_state(state: Dict[str, torch.Tensor],
                     idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The state of rows ``idx`` (rows on dim 1)."""
        return {k: x[:, idx] for k, x in state.items()}

    def forward(self, tokens: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Training forward from a zero state: tokens [B, U] → [B, U,
        output_size] (fp32). With ``gen`` the embedding and inter-layer
        dropouts run."""
        x = drop.dropout(self.embed(tokens), self.embed_dropout, gen)
        if (self.rnn_type != "lstm" or self.num_layers != 2
                or self.hidden_size % 16):
            state = self.init_state(tokens.shape[0], tokens.device)
            return self.projection(self._run_layers(x, state, gen)[0])
        return self.projection(self._fused_seq(x, gen))

    def _fused_seq(self, x: torch.Tensor,
                   gen: Optional[torch.Generator]) -> torch.Tensor:
        """Both layers through K4: x [B, U, E] → layer 2's h [B, U, H] in
        the compute dtype."""
        l1, l2 = self.rnn
        cdt = self.compute_dtype or torch.float32
        # Compute-dtype operands, fp32 accumulation and bias, one rounding.
        xw1 = F.linear(x.to(cdt).float(), l1.wi.weight.to(cdt).float(),
                       l1.wh.bias).to(cdt)
        rate = self.dropout if gen is not None else 0.0
        seed = drop.draw_seed(gen) if rate > 0.0 else 0
        b = xw1.shape[0]
        part, parts = drop.current_part()
        return lstm2_seq(xw1, l1.wh.weight, l2.wi.weight, l2.wh.bias,
                         l2.wh.weight, rate, seed, part * b, parts * b)

    def _run_layers(self, x: torch.Tensor, state: Dict[str, torch.Tensor],
                    gen: Optional[torch.Generator] = None):
        """x [B, U, E] → (out [B, U, H], new_state); the input-side gate
        projections of all U steps run as one matmul per layer, with the
        inter-layer dropout between layers when ``gen`` is given."""
        lstm = self.rnn_type == "lstm"
        new_h, new_c = [], []
        for i, cell in enumerate(self.rnn):
            if i:
                x = drop.dropout(x, self.dropout, gen)
            h = state["h"][i]
            c = state["c"][i] if lstm else None
            xw = cell.input_proj(x)                      # [B, U, 4H | 3H]
            outs = []
            for u in range(x.shape[1]):
                if lstm:
                    c, h = cell.step(xw[:, u], c, h)
                else:
                    h = cell.step(xw[:, u], h)
                outs.append(h)
            new_c.append(c)
            new_h.append(h)
            x = torch.stack(outs, dim=1)
        new_state = {"h": torch.stack(new_h)}
        if lstm:
            new_state["c"] = torch.stack(new_c)
        return x, new_state

    def forward_step(self, token: torch.Tensor, state: Dict[str, torch.Tensor],
                     padding: Optional[torch.Tensor] = None):
        """token [B] int; padding [B] 1 = frozen (keep the old state).
        Returns (out [B, output_size], new_state)."""
        x = self.embed(token[:, None])
        out, new_state = self._run_layers(x, state)
        out = self.projection(out)[:, 0]
        if padding is not None:
            freeze = padding[None, :, None].to(torch.float32)
            new_state = {k: new_state[k] * (1 - freeze) + state[k] * freeze
                         for k in new_state}
        return out, new_state


class _HistoryPredictor(nn.Module):
    """A stateless predictor's shared parts: the embedding with its
    dropout, and the state, the last C - 1 = ``history_size`` embedded
    labels (zeros before the first)."""

    def __init__(self, voca_size: int, embed_size: int,
                 embed_dropout: float, history_size: int, activation: str):
        super().__init__()
        self.embed_size = embed_size
        self.embed_dropout = embed_dropout
        self.context_size = history_size + 1
        self.activation = activation
        self.embed = nn.Embedding(voca_size, embed_size)

    def init_state(self, batch_size: int,
                   device: torch.device) -> Dict[str, torch.Tensor]:
        return {"history": torch.zeros(batch_size, self.context_size - 1,
                                       self.embed_size, device=device)}

    @staticmethod
    def gather_state(state: Dict[str, torch.Tensor],
                     idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The state of rows ``idx`` (rows on dim 0)."""
        return {k: x[idx] for k, x in state.items()}

    def _out(self, ctx: torch.Tensor) -> torch.Tensor:
        """ctx [B, U + C - 1, E] (history ++ embedded labels) →
        [B, U, E]."""
        raise NotImplementedError

    def forward(self, tokens: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Training forward from a zero history: tokens [B, U] →
        [B, U, embed_size] (fp32); with ``gen`` the embedding dropout
        runs."""
        x = drop.dropout(self.embed(tokens), self.embed_dropout, gen)
        hist = self.init_state(tokens.shape[0], tokens.device)["history"]
        return self._out(torch.cat([hist, x], dim=1))

    def forward_step(self, token: torch.Tensor,
                     state: Dict[str, torch.Tensor],
                     padding: Optional[torch.Tensor] = None):
        """token [B] int; padding [B] 1 = frozen (keep the old history).
        Returns (out [B, embed_size], new_state)."""
        ctx = torch.cat([state["history"], self.embed(token[:, None])],
                        dim=1)
        out = self._out(ctx)[:, 0]
        new_hist = ctx[:, 1:]
        if padding is not None:
            freeze = padding[:, None, None].to(torch.float32)
            new_hist = new_hist * (1 - freeze) + state["history"] * freeze
        return out, {"history": new_hist}


class EmbeddingPredictor(_HistoryPredictor):
    """Stateless multi-head positional predictor (arXiv 2109.07513): each
    head weights the window's C embeddings by their dot products with its
    position embeddings ``pos_embed`` [n_head, C, E]; the heads' weighted
    sums, averaged over n_head · C, go through ``ffn``, LayerNorm and the
    activation. ``bias`` is accepted and not read, as in the JAX
    package."""

    def __init__(self, voca_size: int, embed_size: int,
                 embed_dropout: float = 0.1, n_head: int = 2,
                 history_size: int = 2, activation: str = "swish",
                 bias: bool = False):
        super().__init__(voca_size, embed_size, embed_dropout, history_size,
                         activation)
        self.n_head = n_head
        self.pos_embed = nn.Parameter(
            torch.zeros(n_head, self.context_size, embed_size))
        self.ffn = Dense(embed_size, embed_size)
        self.norm = LayerNorm(embed_size)

    def _out(self, ctx: torch.Tensor) -> torch.Tensor:
        windows = ctx.unfold(1, self.context_size, 1).transpose(2, 3)
        weight = torch.einsum("buce,hce->buhc", windows, self.pos_embed)
        out = torch.einsum("buhc,buce->buhe", weight, windows)
        out = out.sum(dim=2) / (self.n_head * self.context_size)
        return get_activation(self.activation)(self.norm(self.ffn(out)))


class ConvPredictor(_HistoryPredictor):
    """Depthwise convolution (kernel C, one filter a channel) over the
    window, then LayerNorm and the activation; the conv has a bias only
    with ``bias``."""

    def __init__(self, voca_size: int, embed_size: int,
                 embed_dropout: float = 0.1, history_size: int = 2,
                 activation: str = "relu", bias: bool = False):
        super().__init__(voca_size, embed_size, embed_dropout, history_size,
                         activation)
        self.conv = nn.Conv1d(embed_size, embed_size, self.context_size,
                              groups=embed_size, bias=bias)
        self.norm = LayerNorm(embed_size)

    def _out(self, ctx: torch.Tensor) -> torch.Tensor:
        out = F.conv1d(ctx.transpose(1, 2), self.conv.weight,
                       self.conv.bias, groups=self.embed_size)
        return get_activation(self.activation)(
            self.norm(out.transpose(1, 2)))


PREDICTOR_CLASSES = {"rnn": RNNPredictor, "embedding": EmbeddingPredictor,
                     "conv": ConvPredictor}
