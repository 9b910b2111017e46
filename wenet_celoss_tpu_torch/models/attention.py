"""Multi-head attention (port of ``wenet_celoss_tpu/models/attention.py``):
full context, and the streaming step ``forward_with_cache`` over a
fixed-size key/value ring. Dropout on the attention probabilities runs
when the caller passes a generator (training). A pre-norm caller passes
its LayerNorm as ``ln``: with ``LNMM_PALLAS`` at "1" or "attn" a
self-attention's LayerNorm and merged QKV projection are one K7 launch
(``ops/ln_matmul.py``), else the LayerNorm runs alone first.

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
from wenet_celoss_tpu_torch.ops import ln_matmul as lnmm
from wenet_celoss_tpu_torch.ops.dropout import dropout
from wenet_celoss_tpu_torch.utils.common import acc_dtype

# Additive mask value (an attention bias of 0 keeps a key, NEG_INF drops
# it). exp(NEG_INF - max) underflows to exactly 0 in the fp32 softmax.
NEG_INF = -1.0e9


class MultiHeadedAttention(nn.Module):

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if n_feat % n_head:
            raise ValueError(f"n_feat {n_feat} not divisible by {n_head}")
        self.n_head, self.n_feat = n_head, n_feat
        self.d_k = n_feat // n_head
        self.dropout_rate = dropout_rate
        self.compute_dtype = dtype
        self.linear_q = Dense(n_feat, n_feat, dtype=dtype)
        self.linear_k = Dense(n_feat, n_feat, dtype=dtype)
        self.linear_v = Dense(n_feat, n_feat, dtype=dtype)
        self.linear_out = Dense(n_feat, n_feat, dtype=dtype)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, self.n_head, self.d_k).transpose(1, 2)

    def _merged(self, x: torch.Tensor, layers, ln=None) -> torch.Tensor:
        """One matmul against the concatenated weights of ``layers``; with
        ``ln``, K7 computes ln(x) and the matmul in one launch (the bias
        cast to the compute dtype first, as the JAX package does)."""
        cdt = self.compute_dtype or torch.promote_types(x.dtype,
                                                        torch.float32)
        w = torch.cat([lin.weight for lin in layers]).to(cdt)
        b = torch.cat([lin.bias for lin in layers]).to(cdt)
        if ln is None:
            return F.linear(x.to(cdt), w, b)
        bsz, t, d = x.shape
        y = lnmm.ln_matmul(x.reshape(bsz * t, d).to(cdt).contiguous(),
                           ln.weight, ln.bias, w, b.float(), None, ln.eps)
        return y.reshape(bsz, t, -1)

    def qkv(self, query, key, value, ln=None):
        """Merged projections: q=k=v for self-attention (one matmul),
        k=v for cross-attention (q alone, then one k|v matmul); every
        caller in this port is one of the two. ``ln`` is the caller's
        pre-norm: fused into the self-attention projection by K7 when
        ``LNMM_PALLAS`` routes "attn", else applied to the query and its
        aliases first."""
        if key is not value:
            raise ValueError("key and value must be the same tensor")
        fused = ln is not None and query is key and lnmm.enabled("attn")
        if ln is not None and not fused:
            qn = ln(query)
            if key is query:
                key = value = qn
            query = qn
        if query is key:
            y = self._merged(query, (self.linear_q, self.linear_k,
                                     self.linear_v), ln if fused else None)
            q, k, v = torch.chunk(y, 3, dim=-1)
            return self._split(q), self._split(k), self._split(v)
        k, v = torch.chunk(self._merged(key, (self.linear_k,
                                              self.linear_v)), 2, dim=-1)
        return (self._split(self.linear_q(query)), self._split(k),
                self._split(v))

    def _softmax_out(self, scores: torch.Tensor, mask, v: torch.Tensor,
                     dtype: torch.dtype, gen=None) -> torch.Tensor:
        """Mask, fp32 softmax, dropout, weighted sum of v, output
        projection.

        ``mask``: [B, 1|Tq, Tk] additive float bias (fully masked pad query
        rows get uniform attention; every consumer masks pad frames by
        length), a boolean keep-mask, or None."""
        additive = mask is not None and mask.dtype != torch.bool
        if additive:
            scores = scores + mask[:, None].to(scores.dtype)
        elif mask is not None:
            scores = scores.masked_fill(~mask[:, None], NEG_INF)
        attn = torch.softmax(scores.to(acc_dtype(scores.dtype)),
                             dim=-1).to(dtype)
        if mask is not None and not additive:
            attn = attn.masked_fill(~mask[:, None], 0.0)
        attn = dropout(attn, self.dropout_rate, gen)
        x = torch.matmul(attn, v)
        b = x.shape[0]
        return self.linear_out(x.transpose(1, 2).reshape(b, -1, self.n_feat))

    def _scores(self, q, k, pos_emb):
        """[B, H, Tq, Tk] scores of q [B, H, Tq, dk] against k."""
        return torch.matmul(q, k.transpose(-2, -1)) / torch.sqrt(
            torch.tensor(float(self.d_k), dtype=q.dtype))

    def forward(self, query, key, value, mask=None, pos_emb=None, gen=None,
                ln=None):
        q, k, v = self.qkv(query, key, value, ln)
        return self._softmax_out(self._scores(q, k, pos_emb), mask, v,
                                 q.dtype, gen)

    def forward_with_cache(self, query, key, value, cache_kv, cache_len,
                           mask=None, pos_emb=None):
        """One streaming step, no dropout, no fused pre-norm.

        cache_kv [B, H, C, 2·dk]: the ring of past (k | v), oldest first;
        slot i is valid iff i >= C - cache_len (an int, or a 0-d tensor).
        mask: a boolean [B, 1|Tq, C + T] over (cache ++ new) keys, or
        None; masked probabilities are zeroed after the softmax. pos_emb
        (rel-pos only) spans the C + T keys. → (out [B, Tq, n_feat], the
        ring slid to its last C entries, min(cache_len + T, C))."""
        q, k, v = self.qkv(query, key, value)
        c = cache_kv.shape[2]
        k_cache, v_cache = torch.chunk(cache_kv.to(k.dtype), 2, dim=-1)
        k_all = torch.cat([k_cache, k], dim=2)
        v_all = torch.cat([v_cache, v], dim=2)
        idx = torch.arange(c + k.shape[2], device=q.device)
        keep = (idx >= c - cache_len)[None, None, :]
        if mask is not None:
            keep = keep & mask
        out = self._softmax_out(self._scores(q, k_all, pos_emb), keep,
                                v_all, q.dtype)
        ring = torch.cat([k_all, v_all], dim=-1)
        new_len = cache_len + k.shape[2]
        # cache_len is an int, or a 0-d tensor in an exported chunk step.
        new_len = (new_len.clamp(max=c) if torch.is_tensor(new_len)
                   else min(new_len, c))
        return out, ring[:, :, ring.shape[2] - c:], new_len


class RelPositionMultiHeadedAttention(MultiHeadedAttention):
    """Rel-pos MHA with the Transformer-XL u/v biases and no rel_shift."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(n_head, n_feat, dropout_rate, dtype)
        self.linear_pos = Dense(n_feat, n_feat, bias=False, dtype=dtype)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_head, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_head, self.d_k))

    def _scores(self, q, k, pos_emb):
        """pos_emb [1|B, Tk, n_feat] (a batch-1 table broadcasts)."""
        p = self.linear_pos(pos_emb)
        pb, pt = p.shape[0], p.shape[1]
        p = p.reshape(pb, pt, self.n_head, self.d_k).transpose(1, 2)
        q_u = q + self.pos_bias_u[None, :, None, :].to(q.dtype)
        q_v = q + self.pos_bias_v[None, :, None, :].to(q.dtype)
        matrix_ac = torch.matmul(q_u, k.transpose(-2, -1))
        matrix_bd = torch.matmul(q_v, p.transpose(-2, -1))
        return (matrix_ac + matrix_bd) / torch.sqrt(
            torch.tensor(float(self.d_k), dtype=q.dtype))
