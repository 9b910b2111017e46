"""RNN predictor (port of ``wenet_celoss_tpu/models/predictor.py``:
``RNNPredictor.init_state``, ``forward_step`` with the padding freeze, the
plain ``_run_layers``, and the whole-sequence training forward).

The whole-sequence forward is routed as the JAX package routes it: with a
zero state, an LSTM and 2 layers it runs the hoisted layer-1 input
projection as one plain matmul and then K4 (``ops/lstm.py``), which holds
both layers and the inter-layer dropout; otherwise the plain layers.
Differences from the JAX package's fused route: it runs in the model's
compute dtype (the TPU path hard-codes bf16), the embedding is a gather
(the TPU path's one-hot matmul gives the same values), and there is no
``fused_rows_for`` limit on the sequence length (that is the TPU's VMEM
budget; the kernel keeps its states in device memory).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from wenet_celoss_tpu_torch.models.layers import Dense, LSTMCellParams
from wenet_celoss_tpu_torch.ops import dropout as drop
from wenet_celoss_tpu_torch.ops.lstm import lstm2_seq


class RNNPredictor(nn.Module):

    def __init__(self, voca_size: int, embed_size: int, output_size: int,
                 hidden_size: int = 256, num_layers: int = 2,
                 bias: bool = True, rnn_type: str = "lstm",
                 embed_dropout: float = 0.1, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if rnn_type != "lstm":
            raise NotImplementedError(f"rnn_type={rnn_type!r} is not ported")
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.embed_dropout = embed_dropout
        self.dropout = dropout
        self.compute_dtype = dtype
        self.embed = nn.Embedding(voca_size, embed_size)
        self.rnn = nn.ModuleList([
            LSTMCellParams(embed_size if i == 0 else hidden_size,
                           hidden_size) for i in range(num_layers)])
        self.projection = Dense(hidden_size, output_size, bias=bias)

    def init_state(self, batch_size: int,
                   device: torch.device) -> Dict[str, torch.Tensor]:
        shape = (self.num_layers, batch_size, self.hidden_size)
        return {"h": torch.zeros(shape, device=device),
                "c": torch.zeros(shape, device=device)}

    def forward(self, tokens: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Training forward from a zero state: tokens [B, U] → [B, U,
        output_size] (fp32). With ``gen`` the embedding and inter-layer
        dropouts run."""
        x = drop.dropout(self.embed(tokens), self.embed_dropout, gen)
        if self.num_layers != 2 or self.hidden_size % 16:
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
        new_h, new_c = [], []
        for i, cell in enumerate(self.rnn):
            if i:
                x = drop.dropout(x, self.dropout, gen)
            c, h = state["c"][i], state["h"][i]
            xw = cell.input_proj(x)                          # [B, U, 4H]
            outs = []
            for u in range(x.shape[1]):
                c, h = cell.step(xw[:, u], c, h)
                outs.append(h)
            new_c.append(c)
            new_h.append(h)
            x = torch.stack(outs, dim=1)
        return x, {"h": torch.stack(new_h), "c": torch.stack(new_c)}

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
