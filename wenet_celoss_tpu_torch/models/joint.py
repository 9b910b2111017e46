"""Transducer joint network (port of ``wenet_celoss_tpu/models/joint.py``:
``project_enc``, ``frames`` and ``single`` for decoding; ``project`` and
``output_params`` for the streaming loss, which applies the output layer
itself (``ops/rnnt_loss.py``); the materialised ``forward``, which the
losses of ``rnnt_impl`` scan, fused and pallas take; and ``pruned``, the
joint of the pruned loss's windows)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from wenet_celoss_tpu_torch.models.layers import Dense
from wenet_celoss_tpu_torch.utils.common import get_activation


class TransducerJoint(nn.Module):

    def __init__(self, voca_size: int, enc_output_size: int,
                 pred_output_size: int, join_dim: int,
                 prejoin_linear: bool = True, postjoin_linear: bool = False,
                 joint_mode: str = "add", activation: str = "tanh",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if joint_mode != "add":
            raise NotImplementedError(f"joint_mode={joint_mode!r}")
        if not prejoin_linear and not postjoin_linear and not (
                enc_output_size == pred_output_size == join_dim):
            raise ValueError("without pre/post-join linears the encoder, "
                             "predictor and join dims must agree")
        self.enc_output_size = enc_output_size
        self.pred_output_size = pred_output_size
        self.prejoin_linear = prejoin_linear
        self.postjoin_linear = postjoin_linear
        self.activation = activation
        if prejoin_linear:
            self.enc_ffn = Dense(enc_output_size, join_dim, dtype=dtype)
            self.pred_ffn = Dense(pred_output_size, join_dim, dtype=dtype)
        if postjoin_linear:
            self.post_ffn = Dense(join_dim, join_dim, dtype=dtype)
        self.ffn_out = Dense(join_dim, voca_size, dtype=dtype)

    def _combine(self, enc: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        out = enc + pred
        if self.postjoin_linear:
            out = self.post_ffn(out)
        return self.ffn_out(get_activation(self.activation)(out))

    def forward(self, enc_out: torch.Tensor,
                pred_out: torch.Tensor) -> torch.Tensor:
        """enc_out [B, T, E], pred_out [B, U, P] → logits [B, T, U, V],
        materialised: B·T·U·V values (at B=64, T=127, U=33, V=5002 it
        is 2.7 GB in bf16)."""
        if self.prejoin_linear:
            enc_out = self.enc_ffn(enc_out)
            pred_out = self.pred_ffn(pred_out)
        return self._combine(enc_out[:, :, None, :], pred_out[:, None, :, :])

    def pruned(self, enc_out: torch.Tensor,
               pred_w: torch.Tensor) -> torch.Tensor:
        """enc_out [B, T, E], pred_w [B, T, S, P] (the predictor rows of
        each frame's window) → logits [B, T, S, V]; the full
        [B, T, U+1, V] joint never exists."""
        if self.prejoin_linear:
            enc_out = self.enc_ffn(enc_out)
            pred_w = self.pred_ffn(pred_w)
        return self._combine(enc_out[:, :, None, :], pred_w)

    def project(self, enc_out: torch.Tensor, pred_out: torch.Tensor):
        """The pre-join projections only → (enc_j [B, T, J],
        pred_j [B, U, J])."""
        if self.prejoin_linear:
            return self.enc_ffn(enc_out), self.pred_ffn(pred_out)
        return enc_out, pred_out

    def output_params(self):
        """(weight [V, J], bias [V]) of the output layer, in
        ``torch.nn.Linear`` layout."""
        if self.postjoin_linear:
            raise NotImplementedError("the streaming loss takes the "
                                      "pre-join add joint only")
        return self.ffn_out.weight, self.ffn_out.bias

    def single(self, enc_t: torch.Tensor, pred_u: torch.Tensor):
        """enc_t [B, E], pred_u [B, P] → logits [B, V]."""
        if self.prejoin_linear:
            enc_t = self.enc_ffn(enc_t)
            pred_u = self.pred_ffn(pred_u)
        return self._combine(enc_t, pred_u)

    def project_enc(self, enc_out: torch.Tensor) -> torch.Tensor:
        """[B, T, E] → pre-joined [B, T, J], computed once per utterance."""
        return self.enc_ffn(enc_out) if self.prejoin_linear else enc_out

    def frames(self, enc_j: torch.Tensor, pred_u: torch.Tensor):
        """enc_j [B, T, J] (pre-projected), pred_u [B, P] → logits
        [B, T, V]: one predictor state joined against EVERY frame."""
        p = self.pred_ffn(pred_u) if self.prejoin_linear else pred_u
        return self._combine(enc_j, p[:, None, :])
