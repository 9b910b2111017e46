"""RNN-T model with contextual biasing and the hotword CE loss (port of
``wenet_celoss_tpu/models/transducer.py``): the training forward with its
loss mix, and the decode-support methods.

loss = transducer_weight * RNN-T + ctc_weight * CTC
       + (1 - transducer_weight - ctc_weight) * attention
       + hw_weight * hotword CE (loss_mode both | pred | sep).

When hotwords are given, the BIASED encoder output feeds the joint, the
CTC head and the attention decoder; the ``pred`` mode's hotword head reads
the UNBIASED predictor output. The RNN-T loss (``ops/rnnt_loss.py``) is
chosen by ``rnnt_impl`` as in the JAX package: "streaming" (K2, K9 and K3
on the card), or on the materialised joint "scan" (the plain wavefront,
autograd through it, as the JAX package's XLA scan; no kernel) and
"fused" and "pallas" (K9 on the card) (the factory maps
``fused_rnnt_loss`` to "fused"), or "pruned": ``simple_loss_scale`` times
the simple loss of the factored joint ``simple_am_proj(encoder_out) +
simple_lm_proj(predictor_out)`` (K9 on the card) plus the exact loss over
the ``prune_range`` label positions of each frame that the simple
lattice picks (plain torch; the joint's ``pruned`` windows).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from wenet_celoss_tpu_torch.models.asr_model import ASRModel
from wenet_celoss_tpu_torch.models.context_bias import ContextBias
from wenet_celoss_tpu_torch.models.encoder import TransformerEncoder
from wenet_celoss_tpu_torch.models.joint import TransducerJoint
from wenet_celoss_tpu_torch.models.layers import Dense
from wenet_celoss_tpu_torch.ops.rnnt_loss import (
    LOSSES, rnnt_loss_pruned, rnnt_loss_simple_and_ranges,
    rnnt_loss_streaming)
from wenet_celoss_tpu_torch.utils.common import IGNORE_ID, add_blank


def cross_entropy_mean(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Plain CE in fp32, the mean over ALL positions (padding was mapped to
    class 0 first, as the JAX package does)."""
    logq = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logq, -1, targets[..., None].long()).mean()


class Transducer(ASRModel):

    def __init__(self, vocab_size: int, encoder: TransformerEncoder,
                 predictor: nn.Module, joint: TransducerJoint,
                 context_bias: Optional[ContextBias] = None,
                 blank: int = 0, decoder: Optional[nn.Module] = None,
                 ctc: Optional[nn.Module] = None,
                 transducer_weight: float = 1.0, ctc_weight: float = 0.0,
                 hw_weight: float = 0.0, loss_mode: str = "both",
                 rnnt_impl: str = "streaming", streaming_chunk: int = 16,
                 prune_range: int = 5, simple_loss_scale: float = 0.5,
                 lsm_weight: float = 0.0, reverse_weight: float = 0.0,
                 length_normalized_loss: bool = False,
                 ignore_id: int = IGNORE_ID):
        super().__init__(vocab_size, encoder, decoder, ctc,
                         ctc_weight=ctc_weight, ignore_id=ignore_id,
                         reverse_weight=reverse_weight,
                         lsm_weight=lsm_weight,
                         length_normalized_loss=length_normalized_loss)
        self.blank = blank
        self.predictor = predictor
        self.joint = joint
        self.context_bias = context_bias
        if rnnt_impl not in ("streaming", "pruned", *LOSSES):
            raise ValueError(f"unknown rnnt_impl {rnnt_impl!r}")
        if rnnt_impl == "pruned":
            self.simple_am_proj = Dense(joint.enc_output_size, vocab_size)
            self.simple_lm_proj = Dense(joint.pred_output_size, vocab_size)
        # Registration order is the order in which the factory draws the
        # seeded weights: the decode path's modules first, then the
        # training-only heads, so that the heads do not change them.
        for name in ("decoder", "ctc"):
            if name in self._modules:
                self._modules[name] = self._modules.pop(name)
        self.transducer_weight = transducer_weight
        self.hw_weight = hw_weight
        self.loss_mode = loss_mode
        self.rnnt_impl = rnnt_impl
        self.streaming_chunk = streaming_chunk
        self.prune_range = prune_range
        self.simple_loss_scale = simple_loss_scale

    @property
    def device(self) -> torch.device:
        return self.joint.ffn_out.weight.device

    def forward(self, speech, speech_lengths, text, text_lengths,
                context_list=None, context_lengths=None, hw_label=None,
                context_n_valid=None, gen: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Training forward → {'loss', 'loss_att', 'loss_ctc',
        'loss_rnnt', 'hw_loss'}; with ``gen`` every dropout runs, and a
        ``use_dynamic_chunk`` encoder in training mode draws its chunk
        from it (as ``ASRModel.forward``)."""
        use_bias = self.context_bias is not None and context_list is not None
        bias_hidden = None
        if use_bias:
            bias_hidden = self.context_bias.forward_bias_hidden(
                context_list, context_lengths, context_n_valid)
        encoder_out, enc_pad_mask = self.encoder(speech, speech_lengths, gen)
        encoder_lens = enc_pad_mask.sum(dim=1)
        enc_bias = pred_bias = None
        if use_bias:
            encoder_out, enc_bias = self.context_bias.forward_encoder_bias(
                bias_hidden, encoder_out, context_n_valid)

        ys_in = add_blank(text, text_lengths, self.blank, self.ignore_id)
        predictor_out = self.predictor(ys_in, gen)
        predictor_out_unbiased = predictor_out
        if use_bias:
            predictor_out, pred_bias = \
                self.context_bias.forward_predictor_bias(
                    bias_hidden, predictor_out, context_n_valid)

        rnnt_text = torch.where(text == self.ignore_id,
                                torch.zeros_like(text), text)
        if self.rnnt_impl == "streaming":
            enc_j, pred_j = self.joint.project(encoder_out, predictor_out)
            w_out, b_out = self.joint.output_params()
            losses = rnnt_loss_streaming(
                enc_j, pred_j, w_out, b_out, rnnt_text, encoder_lens,
                text_lengths, self.blank, activation=self.joint.activation,
                chunk=self.streaming_chunk)
        elif self.rnnt_impl == "pruned":
            losses = self._pruned_losses(encoder_out, predictor_out,
                                         rnnt_text, encoder_lens,
                                         text_lengths)
        else:
            losses = LOSSES[self.rnnt_impl](
                self.joint(encoder_out, predictor_out), rnnt_text,
                encoder_lens, text_lengths, self.blank)
        loss_rnnt = losses.mean()
        loss = self.transducer_weight * loss_rnnt

        zero = torch.zeros((), device=loss.device)
        loss_att = zero
        attention_weight = 1.0 - self.transducer_weight - self.ctc_weight
        if attention_weight > 0.0 and self.decoder is not None:
            loss_att, _ = self._calc_att_loss(encoder_out, enc_pad_mask,
                                              text, text_lengths, gen)
            loss = loss + attention_weight * loss_att
        loss_ctc = zero
        if self.ctc_weight > 0.0 and self.ctc is not None:
            loss_ctc = self.ctc(encoder_out, encoder_lens, text,
                                text_lengths)
            loss = loss + self.ctc_weight * loss_ctc
        hw_loss = zero
        if use_bias and self.hw_weight > 0.0 and hw_label is not None:
            hw_loss = self._calc_hw_loss(bias_hidden, predictor_out_unbiased,
                                         enc_bias, pred_bias, hw_label)
            loss = loss + self.hw_weight * hw_loss
        return {"loss": loss, "loss_att": loss_att, "loss_ctc": loss_ctc,
                "loss_rnnt": loss_rnnt, "hw_loss": hw_loss}

    def _pruned_losses(self, encoder_out, predictor_out, labels,
                       encoder_lens, label_lengths):
        """simple_loss_scale * the simple loss + the pruned loss, [B]."""
        am = self.simple_am_proj(encoder_out)                  # [B, T, V]
        lm = self.simple_lm_proj(predictor_out)                # [B, U+1, V]
        simple, ranges = rnnt_loss_simple_and_ranges(
            am, lm, labels, encoder_lens, label_lengths, self.prune_range,
            self.blank)
        u1 = predictor_out.shape[1]
        b = encoder_out.shape[0]
        abs_u = (ranges[:, :, None] + torch.arange(
            self.prune_range, device=ranges.device)).clamp(0, u1 - 1)
        pred_w = predictor_out[torch.arange(b, device=abs_u.device)[
            :, None, None], abs_u]                             # [B, T, S, P]
        pruned = rnnt_loss_pruned(self.joint.pruned(encoder_out, pred_w),
                                  ranges, labels, encoder_lens,
                                  label_lengths, self.blank)
        return self.simple_loss_scale * simple + pruned

    def _calc_hw_loss(self, bias_hidden, predictor_out_unbiased, enc_bias,
                      pred_bias, hw_label):
        """hw_label [B, U] (ignore_id padded) → the hotword CE."""
        clean = torch.where(hw_label == self.ignore_id,
                            torch.zeros_like(hw_label), hw_label)
        if self.loss_mode == "pred":
            hw = self.context_bias.forward_hw_pred(bias_hidden,
                                                   predictor_out_unbiased)
            return cross_entropy_mean(hw[:, :-1], clean)
        if self.loss_mode == "both":
            hw = self.context_bias.forward_hw_pred_both(enc_bias, pred_bias)
            return cross_entropy_mean(hw[:, :-1], clean)
        # sep: the dec head classifies, targets get a prepended 0.
        _, dec_hw = self.context_bias.forward_hw_pred_both_sep(enc_bias,
                                                               pred_bias)
        target = torch.cat([torch.zeros_like(clean[:, :1]), clean], dim=1)
        return cross_entropy_mean(dec_hw, target)

    def bias_hidden(self, context_list: torch.Tensor,
                    context_lengths: torch.Tensor,
                    context_n_valid=None) -> torch.Tensor:
        return self.context_bias.forward_bias_hidden(
            context_list, context_lengths, context_n_valid)

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

    def predictor_gather_state(self, state, idx: torch.Tensor):
        """The predictor state of rows ``idx`` (the beam's parents): the
        RNN's rows lie on dim 1, the stateless predictors' on dim 0."""
        return self.predictor.gather_state(state, idx)

    def predictor_bias_step(self, bias_hidden: torch.Tensor,
                            pred_out: torch.Tensor):
        """Bias one predictor output [B, P] → (biased [B, P],
        bias branch [B, E])."""
        out, pred_bias = self.context_bias.forward_predictor_bias(
            bias_hidden, pred_out[:, None, :])
        return out[:, 0], pred_bias[:, 0]

    def hw_gate_step(self, enc_bias_t: torch.Tensor,
                     pred_bias_u: torch.Tensor) -> torch.Tensor:
        """Per-step hotword-gate logits of the "exact" greedy decode:
        enc bias at frame t [B, E] × pred bias at step u [B, E] →
        [B, num_labels]."""
        hw = self.context_bias.forward_hw_pred_both(enc_bias_t[:, None, :],
                                                    pred_bias_u[:, None, :])
        return hw[:, 0]

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

    def joint_step(self, enc_t: torch.Tensor,
                   pred_u: torch.Tensor) -> torch.Tensor:
        """enc_t [B, E] × pred_u [B, P] → joint logits [B, V]."""
        return self.joint.single(enc_t, pred_u)

    def predictor_forward(self, ys_in: torch.Tensor) -> torch.Tensor:
        """Whole-sequence predictor forward of blank-prepended labels, no
        dropout (K4 on the card)."""
        return self.predictor(ys_in)

    def transducer_score(self, encoder_out, enc_pad_mask, hyps, hyps_lens):
        """Per-hypothesis transducer log-probability, -RNN-T loss of each
        label sequence given the plain encoder output, over the whole
        n-best at once with the streaming loss (the [B·N, T, U, V] joint
        never materialises; on the card: K4 for a 2-layer LSTM predictor,
        then K2, then K9).

        encoder_out [B, T, E]; enc_pad_mask [B, T]; hyps [B, N, U]
        (padding arbitrary); hyps_lens [B, N] → scores [B, N]. Every
        hypothesis is scored at the padded length U."""
        b, n, u = hyps.shape
        flat = hyps.reshape(b * n, u)
        flat_lens = hyps_lens.reshape(b * n)
        memory = encoder_out.repeat_interleave(n, dim=0)
        enc_lens = enc_pad_mask.sum(dim=1).repeat_interleave(n)
        valid = (torch.arange(u, device=hyps.device)[None, :]
                 < flat_lens[:, None])
        toks = torch.where(valid, flat, torch.zeros_like(flat))
        ys_in = add_blank(flat, flat_lens, self.blank, self.ignore_id)
        enc_j, pred_j = self.joint.project(memory,
                                           self.predictor_forward(ys_in))
        w_out, b_out = self.joint.output_params()
        losses = rnnt_loss_streaming(
            enc_j, pred_j, w_out, b_out, toks, enc_lens, flat_lens,
            self.blank, activation=self.joint.activation,
            chunk=self.streaming_chunk)
        return -losses.reshape(b, n)
