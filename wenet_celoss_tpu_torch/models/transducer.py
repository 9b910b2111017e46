"""RNN-T model with contextual biasing, decode-support methods (port of
``wenet_celoss_tpu/models/transducer.py``). It carries the attention
decoder and the CTC head of the JAX model so that its weights map whole;
the transducer losses come with the flagship's training slice."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from wenet_celoss_tpu_torch.models.context_bias import ContextBias
from wenet_celoss_tpu_torch.models.encoder import ConformerEncoder
from wenet_celoss_tpu_torch.models.joint import TransducerJoint
from wenet_celoss_tpu_torch.models.predictor import RNNPredictor


class Transducer(nn.Module):

    def __init__(self, vocab_size: int, encoder: ConformerEncoder,
                 predictor: RNNPredictor, joint: TransducerJoint,
                 context_bias: Optional[ContextBias] = None,
                 blank: int = 0, decoder: Optional[nn.Module] = None,
                 ctc: Optional[nn.Module] = None):
        super().__init__()
        self.vocab_size = vocab_size
        self.blank = blank
        self.encoder = encoder
        self.predictor = predictor
        self.joint = joint
        self.context_bias = context_bias
        self.decoder = decoder
        self.ctc = ctc

    @property
    def device(self) -> torch.device:
        return self.joint.ffn_out.weight.device

    def bias_hidden(self, context_list: torch.Tensor,
                    context_lengths: torch.Tensor) -> torch.Tensor:
        return self.context_bias.forward_bias_hidden(context_list,
                                                     context_lengths)

    def encode_transducer(self, speech: torch.Tensor,
                          speech_lengths: torch.Tensor,
                          bias_hidden: Optional[torch.Tensor] = None):
        """Encode and (optionally) bias → (encoder_out, encoder_out_biased,
        enc_bias or None, pad_mask)."""
        encoder_out, pad_mask = self.encoder(speech, speech_lengths)
        enc_bias = None
        encoder_out_biased = encoder_out
        if bias_hidden is not None:
            encoder_out_biased, enc_bias = \
                self.context_bias.forward_encoder_bias(bias_hidden,
                                                       encoder_out)
        return encoder_out, encoder_out_biased, enc_bias, pad_mask

    def predictor_init_state(self, batch_size: int):
        return self.predictor.init_state(batch_size, self.device)

    def predictor_step(self, token, state, padding=None):
        return self.predictor.forward_step(token, state, padding)

    def predictor_bias_step(self, bias_hidden: torch.Tensor,
                            pred_out: torch.Tensor):
        """Bias one predictor output [B, P] → (biased [B, P],
        bias branch [B, E])."""
        out, pred_bias = self.context_bias.forward_predictor_bias(
            bias_hidden, pred_out[:, None, :])
        return out[:, 0], pred_bias[:, 0]

    def hw_gate_logits(self, enc_bias: torch.Tensor) -> torch.Tensor:
        """Per-frame hotword-gate logits [B, T, num_labels] from the
        encoder bias branch [B, T, E].

        Decode-time gating does not depend on the predictor: the gate
        attends a SINGLETON key (the frame's enc-bias), and softmax over
        one key weights it 1.0 whatever the query, so the query is a
        dummy of zeros."""
        b, t, e = enc_bias.shape
        flat = enc_bias.reshape(b * t, 1, e)
        hw = self.context_bias.forward_hw_pred_both(flat,
                                                    torch.zeros_like(flat))
        return hw.reshape(b, t, -1)

    def hw_gate_frames(self, enc_bias: torch.Tensor) -> torch.Tensor:
        """Per-frame hotword-gate ids [B, T] (argmax of the gate logits)."""
        return torch.argmax(self.hw_gate_logits(enc_bias), dim=-1)

    def joint_enc_proj(self, encoder_out: torch.Tensor) -> torch.Tensor:
        return self.joint.project_enc(encoder_out)

    def joint_frames(self, enc_j: torch.Tensor,
                     pred_u: torch.Tensor) -> torch.Tensor:
        """enc_j [B, T, J] × pred [B, P] → joint logits [B, T, V]."""
        return self.joint.frames(enc_j, pred_u)
