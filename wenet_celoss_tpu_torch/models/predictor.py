"""RNN predictor, decode path (port of
``wenet_celoss_tpu/models/predictor.py``: ``RNNPredictor.init_state``,
``forward_step`` with the padding freeze, and the plain ``_run_layers``).

The whole-sequence forward for training comes with the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from wenet_celoss_tpu_torch.models.layers import Dense, LSTMCellParams


class RNNPredictor(nn.Module):

    def __init__(self, voca_size: int, embed_size: int, output_size: int,
                 hidden_size: int = 256, num_layers: int = 2,
                 bias: bool = True, rnn_type: str = "lstm",
                 embed_dropout: float = 0.0, dropout: float = 0.0):
        # Dropout rates are accepted for config compatibility; identities
        # at decode time.
        super().__init__()
        if rnn_type != "lstm":
            raise NotImplementedError(f"rnn_type={rnn_type!r} is not ported")
        self.hidden_size = hidden_size
        self.num_layers = num_layers
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

    def _run_layers(self, x: torch.Tensor, state: Dict[str, torch.Tensor]):
        """x [B, U, E] → (out [B, U, H], new_state); the input-side gate
        projections of all U steps run as one matmul per layer."""
        new_h, new_c = [], []
        for i, cell in enumerate(self.rnn):
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
