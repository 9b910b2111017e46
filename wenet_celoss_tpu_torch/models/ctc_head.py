"""CTC head: projection and batch-mean loss (port of
``wenet_celoss_tpu/models/ctc_head.py``)."""

from __future__ import annotations

import torch
import torch.nn as nn

from wenet_celoss_tpu_torch.models.layers import Dense
from wenet_celoss_tpu_torch.ops.ctc_loss import ctc_loss
from wenet_celoss_tpu_torch.utils.common import acc_dtype


class CTC(nn.Module):
    """``ctc_lo`` in fp32 (the JAX head has no compute dtype, so a bf16
    encoder output is promoted); dropout rate 0, as configured there."""

    def __init__(self, vocab_size: int, encoder_output_size: int):
        super().__init__()
        self.ctc_lo = Dense(encoder_output_size, vocab_size)

    def forward(self, hs_pad, hlens, ys_pad, ys_lens) -> torch.Tensor:
        """The summed CTC loss over the batch divided by its size."""
        losses = ctc_loss(self.log_softmax(hs_pad), ys_pad, hlens, ys_lens)
        return losses.sum() / hs_pad.shape[0]

    def log_softmax(self, hs_pad) -> torch.Tensor:
        logits = self.ctc_lo(hs_pad)
        return torch.log_softmax(logits.to(acc_dtype(logits.dtype)), dim=-1)
