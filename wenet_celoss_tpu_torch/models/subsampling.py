"""Subsampling front ends (port of
``wenet_celoss_tpu/models/subsampling.py``): ``linear`` (no subsampling),
``conv2d`` (×4), ``conv2d6`` and ``conv2d8``, each with its
``subsampling_rate`` and ``right_context`` for streaming chunk
arithmetic."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from wenet_celoss_tpu_torch.models.layers import Dense, LayerNorm
from wenet_celoss_tpu_torch.ops.dropout import dropout


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


class LinearNoSubsampling(nn.Module):
    """Dense → LayerNorm → dropout, then the positional encoding: rate 1,
    right context 0, lengths unchanged."""
    subsampling_rate = 1
    right_context = 0

    def __init__(self, idim: int, odim: int, pos_enc: nn.Module,
                 dropout_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.out = Dense(idim, odim, dtype=dtype)
        self.norm = LayerNorm(odim, dtype=dtype)
        self.dropout_rate = dropout_rate
        self.pos_enc = pos_enc

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, gen=None,
                offset: int = 0):
        """As Conv2dSubsampling4.forward, T' = T."""
        x = dropout(self.norm(self.out(x)), self.dropout_rate, gen)
        x, pos_emb = self.pos_enc(x, gen, offset)
        return x, pos_emb, lengths


class Conv2dSubsampling4(nn.Module):
    """Two stride-2 3x3 convs: rate 4, right context 6."""
    subsampling_rate = 4
    right_context = 6
    input_layer = "conv2d"
    convs = ((3, 2), (3, 2))     # (kernel, stride) of conv1, conv2, ...

    def __init__(self, idim: int, odim: int, pos_enc: nn.Module,
                 dropout_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        # dropout_rate is unused: the conv front ends drop nothing outside
        # the positional encoding, as in the JAX package.
        super().__init__()
        f = idim
        for i, (k, s) in enumerate(self.convs):
            setattr(self, f"conv{i + 1}",
                    nn.Conv2d(1 if i == 0 else odim, odim, k, stride=s))
            f = (f - k) // s + 1
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
        for i, (_, s) in enumerate(self.convs):
            conv = getattr(self, f"conv{i + 1}")
            h = F.relu(F.conv2d(h, conv.weight.to(cdt), conv.bias.to(cdt),
                                stride=s))
        b, c, t, f = h.shape
        # Flatten in (f, c) order, as the JAX package's NHWC layout does.
        h = self.out(h.permute(0, 2, 3, 1).reshape(b, t, f * c))
        h, pos_emb = self.pos_enc(h, gen, offset)
        new_len = torch.clamp(subsampled_length(self.input_layer, lengths),
                              max=t)
        return h, pos_emb, new_len


class Conv2dSubsampling6(Conv2dSubsampling4):
    """3x3/2 then 5x5/3 convs: rate 6, right context 10."""
    subsampling_rate = 6
    right_context = 10
    input_layer = "conv2d6"
    convs = ((3, 2), (5, 3))


class Conv2dSubsampling8(Conv2dSubsampling4):
    """Three stride-2 3x3 convs: rate 8, right context 14."""
    subsampling_rate = 8
    right_context = 14
    input_layer = "conv2d8"
    convs = ((3, 2), (3, 2), (3, 2))


SUBSAMPLE_CLASSES = {
    "linear": LinearNoSubsampling,
    "conv2d": Conv2dSubsampling4,
    "conv2d6": Conv2dSubsampling6,
    "conv2d8": Conv2dSubsampling8,
}
