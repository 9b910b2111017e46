"""Multi-head attention, full context (port of
``wenet_celoss_tpu/models/attention.py``; the streaming KV cache comes
with the streaming slice).

The rel-pos variant follows the reference's simplification: matrix_bd is
computed from the sinusoid pos_emb WITHOUT rel_shift. That is deliberate
and must not be "fixed".
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from wenet_celoss_tpu_torch.models.layers import Dense

# Additive mask value (an attention bias of 0 keeps a key, NEG_INF drops
# it). exp(NEG_INF - max) underflows to exactly 0 in the fp32 softmax.
NEG_INF = -1.0e9


class MultiHeadedAttention(nn.Module):

    def __init__(self, n_head: int, n_feat: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if n_feat % n_head:
            raise ValueError(f"n_feat {n_feat} not divisible by {n_head}")
        self.n_head, self.n_feat = n_head, n_feat
        self.d_k = n_feat // n_head
        self.compute_dtype = dtype
        self.linear_q = Dense(n_feat, n_feat, dtype=dtype)
        self.linear_k = Dense(n_feat, n_feat, dtype=dtype)
        self.linear_v = Dense(n_feat, n_feat, dtype=dtype)
        self.linear_out = Dense(n_feat, n_feat, dtype=dtype)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, self.n_head, self.d_k).transpose(1, 2)

    def _merged(self, x: torch.Tensor, layers) -> torch.Tensor:
        """One matmul against the concatenated weights of ``layers``."""
        cdt = self.compute_dtype or torch.promote_types(x.dtype,
                                                        torch.float32)
        w = torch.cat([lin.weight for lin in layers]).to(cdt)
        b = torch.cat([lin.bias for lin in layers]).to(cdt)
        return F.linear(x.to(cdt), w, b)

    def qkv(self, query, key, value):
        """Merged projections: q=k=v for self-attention (one matmul),
        k=v for cross-attention (q alone, then one k|v matmul); every
        caller in this port is one of the two."""
        if key is not value:
            raise ValueError("key and value must be the same tensor")
        if query is key:
            y = self._merged(query, (self.linear_q, self.linear_k,
                                     self.linear_v))
            q, k, v = torch.chunk(y, 3, dim=-1)
            return self._split(q), self._split(k), self._split(v)
        k, v = torch.chunk(self._merged(key, (self.linear_k,
                                              self.linear_v)), 2, dim=-1)
        return (self._split(self.linear_q(query)), self._split(k),
                self._split(v))

    def _softmax_out(self, scores: torch.Tensor, mask, v: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
        """Mask, fp32 softmax, weighted sum of v, output projection.

        ``mask``: [B, 1|Tq, Tk] additive float bias (fully masked pad query
        rows get uniform attention; every consumer masks pad frames by
        length), a boolean keep-mask, or None."""
        additive = mask is not None and mask.dtype != torch.bool
        if additive:
            scores = scores + mask[:, None].to(scores.dtype)
        elif mask is not None:
            scores = scores.masked_fill(~mask[:, None], NEG_INF)
        attn = torch.softmax(scores.float(), dim=-1).to(dtype)
        if mask is not None and not additive:
            attn = attn.masked_fill(~mask[:, None], 0.0)
        x = torch.matmul(attn, v)
        b = x.shape[0]
        return self.linear_out(x.transpose(1, 2).reshape(b, -1, self.n_feat))

    def forward(self, query, key, value, mask=None, pos_emb=None):
        q, k, v = self.qkv(query, key, value)
        scores = torch.matmul(q, k.transpose(-2, -1)) / torch.sqrt(
            torch.tensor(float(self.d_k), dtype=q.dtype))
        return self._softmax_out(scores, mask, v, q.dtype)


class RelPositionMultiHeadedAttention(MultiHeadedAttention):
    """Rel-pos MHA with the Transformer-XL u/v biases and no rel_shift."""

    def __init__(self, n_head: int, n_feat: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(n_head, n_feat, dtype)
        self.linear_pos = Dense(n_feat, n_feat, bias=False, dtype=dtype)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_head, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_head, self.d_k))

    def forward(self, query, key, value, mask=None, pos_emb=None):
        """pos_emb [1|B, Tk, n_feat] (a batch-1 table broadcasts)."""
        q, k, v = self.qkv(query, key, value)
        p = self.linear_pos(pos_emb)
        pb, pt = p.shape[0], p.shape[1]
        p = p.reshape(pb, pt, self.n_head, self.d_k).transpose(1, 2)
        q_u = q + self.pos_bias_u[None, :, None, :].to(q.dtype)
        q_v = q + self.pos_bias_v[None, :, None, :].to(q.dtype)
        matrix_ac = torch.matmul(q_u, k.transpose(-2, -1))
        matrix_bd = torch.matmul(q_v, p.transpose(-2, -1))
        scores = (matrix_ac + matrix_bd) / torch.sqrt(
            torch.tensor(float(self.d_k), dtype=q.dtype))
        return self._softmax_out(scores, mask, v, q.dtype)
