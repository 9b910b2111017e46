"""Transducer joint network, decode path (port of
``wenet_celoss_tpu/models/joint.py``: ``project_enc``, ``frames`` and
``single``)."""

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
