"""Conv2d ×4 subsampling front end (port of
``wenet_celoss_tpu/models/subsampling.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from wenet_celoss_tpu_torch.models.layers import Dense


def _ref_mask_len(n, stride: int):
    """Valid length after one stride of the pad mask: (n - 1) // stride + 1.

    Output lengths come from STRIDING THE PAD MASK, as the reference does;
    this counts slightly more frames than the conv-output formula for
    partially padded rows. Callers clip to the actual frame count."""
    return (n - 1) // stride + 1


def subsampled_length(input_layer: str, lengths):
    """Output frame count of the given subsampling front end."""
    if input_layer == "linear":
        return lengths
    if input_layer == "conv2d":
        return _ref_mask_len(_ref_mask_len(lengths, 2), 2)
    if input_layer == "conv2d6":
        return _ref_mask_len(_ref_mask_len(lengths, 2), 3)
    if input_layer == "conv2d8":
        return _ref_mask_len(_ref_mask_len(_ref_mask_len(lengths, 2), 2), 2)
    raise ValueError(input_layer)


class Conv2dSubsampling4(nn.Module):
    """Two stride-2 3x3 convs: rate 4, right context 6."""
    subsampling_rate = 4
    right_context = 6

    def __init__(self, idim: int, odim: int, pos_enc: nn.Module,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(1, odim, 3, stride=2)
        self.conv2 = nn.Conv2d(odim, odim, 3, stride=2)
        f = ((idim - 1) // 2 - 1) // 2
        self.out = Dense(odim * f, odim, dtype=dtype)
        self.pos_enc = pos_enc
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, gen=None,
                offset: int = 0):
        """x [B, T, F] → (h [B, T', odim], pos_emb [1, T', odim],
        lengths [B]); ``gen`` drives the positional dropout; ``offset``
        is the position of the first output frame (a streaming chunk's)."""
        cdt = self.compute_dtype or x.dtype
        h = x.to(cdt)[:, None]                               # [B, 1, T, F]
        h = F.relu(F.conv2d(h, self.conv1.weight.to(cdt),
                            self.conv1.bias.to(cdt), stride=2))
        h = F.relu(F.conv2d(h, self.conv2.weight.to(cdt),
                            self.conv2.bias.to(cdt), stride=2))
        b, c, t, f = h.shape
        # Flatten in (f, c) order, as the JAX package's NHWC layout does.
        h = self.out(h.permute(0, 2, 3, 1).reshape(b, t, f * c))
        h, pos_emb = self.pos_enc(h, gen, offset)
        new_len = torch.clamp(subsampled_length("conv2d", lengths), max=t)
        return h, pos_emb, new_len
