"""Hybrid CTC + attention ASR model (port of
``wenet_celoss_tpu/models/asr_model.py``): the training forward
(``__call__`` and ``_calc_att_loss``; a dynamic-chunk encoder draws its
chunk from the step's generator while the model trains) and the
decode-support methods: ``encode`` and ``encode_ctc`` (full context, or a
chunk mask), ``ctc_logprobs``, ``decoder_scores``, ``decoder_one_step``,
and the streaming ones, ``encoder_init_cache``, ``encoder_forward_chunk``
and ``encoder_forward_chunk_ctc``.

loss = ctc_weight * ctc + (1 - ctc_weight) * att, where att mixes the
left-to-right and (U2++) right-to-left decoders' label-smoothed losses by
``reverse_weight``. sos = eos = vocab - 1.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from wenet_celoss_tpu_torch.models.ctc_head import CTC
from wenet_celoss_tpu_torch.models.decoder import BiTransformerDecoder
from wenet_celoss_tpu_torch.models.encoder import TransformerEncoder
from wenet_celoss_tpu_torch.models.label_smoothing import \
    label_smoothing_loss
from wenet_celoss_tpu_torch.utils.common import (IGNORE_ID, acc_dtype,
                                                 accuracy, add_sos_eos,
                                                 reverse_pad_list)


class ASRModel(nn.Module):

    def __init__(self, vocab_size: int, encoder: TransformerEncoder,
                 decoder: BiTransformerDecoder, ctc: CTC,
                 ctc_weight: float = 0.5, ignore_id: int = IGNORE_ID,
                 reverse_weight: float = 0.0, lsm_weight: float = 0.1,
                 length_normalized_loss: bool = False):
        super().__init__()
        self.vocab_size = vocab_size
        self.encoder = encoder
        self.decoder = decoder
        self.ctc = ctc
        self.ctc_weight = ctc_weight
        self.ignore_id = ignore_id
        self.reverse_weight = reverse_weight
        self.lsm_weight = lsm_weight
        self.length_normalized_loss = length_normalized_loss
        self.sos = self.eos = vocab_size - 1

    @property
    def device(self) -> torch.device:
        return self.ctc.ctc_lo.weight.device

    def forward(self, speech, speech_lengths, text, text_lengths,
                gen: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Training forward → {'loss', 'loss_att', 'loss_ctc', 'acc'}; with
        ``gen`` every dropout runs (training), without it none does. A
        ``use_dynamic_chunk`` encoder in training mode draws its chunk from
        ``gen`` and raises without one."""
        encoder_out, enc_pad_mask = self.encoder(speech, speech_lengths, gen)
        encoder_lens = enc_pad_mask.sum(dim=1)
        zero = torch.zeros((), device=encoder_out.device)
        loss_att, acc = zero, zero
        if self.ctc_weight < 1.0:
            loss_att, acc = self._calc_att_loss(
                encoder_out, enc_pad_mask, text, text_lengths, gen)
        loss_ctc = zero
        if self.ctc_weight > 0.0:
            loss_ctc = self.ctc(encoder_out, encoder_lens, text,
                                text_lengths)
        loss = self.ctc_weight * loss_ctc + (1 - self.ctc_weight) * loss_att
        return {"loss": loss, "loss_att": loss_att, "loss_ctc": loss_ctc,
                "acc": acc}

    def _calc_att_loss(self, encoder_out, enc_pad_mask, ys_pad, ys_lens,
                       gen=None):
        ys_in, ys_out = add_sos_eos(ys_pad, ys_lens, self.sos, self.eos,
                                    self.ignore_id)
        # The reversed labels pad with float(ignore_id) and are cast back,
        # as the JAX package does.
        r_ys = reverse_pad_list(ys_pad, ys_lens, float(self.ignore_id))
        r_ys_in, r_ys_out = add_sos_eos(r_ys.to(ys_pad.dtype), ys_lens,
                                        self.sos, self.eos, self.ignore_id)
        l_logits, r_logits = self.decoder(
            encoder_out, enc_pad_mask, ys_in, ys_lens + 1, r_ys_in,
            self.reverse_weight, gen)
        loss = label_smoothing_loss(l_logits, ys_out, self.lsm_weight,
                                    self.length_normalized_loss,
                                    self.ignore_id)
        if self.reverse_weight > 0.0:
            loss_r = label_smoothing_loss(
                r_logits, r_ys_out, self.lsm_weight,
                self.length_normalized_loss, self.ignore_id)
            loss = (1 - self.reverse_weight) * loss \
                + self.reverse_weight * loss_r
        return loss, accuracy(l_logits, ys_out, self.ignore_id)

    # ------------------------------------------------ decode support ---
    def encode(self, speech, speech_lengths, decoding_chunk_size: int = -1,
               num_decoding_left_chunks: int = -1):
        """Encoding without dropout → (encoder_out [B, T', D], pad_mask
        [B, T']): the full context, or the chunk mask the arguments and
        the encoder's ``static_chunk_size`` give (see
        ``TransformerEncoder.forward``)."""
        return self.encoder(speech, speech_lengths, None,
                            decoding_chunk_size, num_decoding_left_chunks)

    def ctc_logprobs(self, encoder_out: torch.Tensor) -> torch.Tensor:
        return self.ctc.log_softmax(encoder_out)

    def encode_ctc(self, speech, speech_lengths,
                   decoding_chunk_size: int = -1,
                   num_decoding_left_chunks: int = -1):
        """→ (encoder_out, pad_mask, CTC log-probs [B, T', V] fp32)."""
        encoder_out, pad_mask = self.encode(speech, speech_lengths,
                                            decoding_chunk_size,
                                            num_decoding_left_chunks)
        return encoder_out, pad_mask, self.ctc.log_softmax(encoder_out)

    def decoder_scores(self, encoder_out, enc_pad_mask, hyps_in, hyps_lens,
                       r_hyps_in, reverse_weight: float = 0.0):
        """Teacher-forced log-probs of both decoders for n-best rescoring
        → (left, right), each [B, U, V] fp32 (the right one of zero
        logits without a right decoder or reverse weight)."""
        l_logits, r_logits = self.decoder(encoder_out, enc_pad_mask,
                                          hyps_in, hyps_lens, r_hyps_in,
                                          reverse_weight)
        return (torch.log_softmax(l_logits.to(acc_dtype(l_logits.dtype)),
                                  dim=-1),
                torch.log_softmax(r_logits.to(acc_dtype(r_logits.dtype)),
                                  dim=-1))

    def decoder_one_step(self, memory, memory_pad_mask, ys_buffer,
                         pos: int) -> torch.Tensor:
        return self.decoder.forward_one_step(memory, memory_pad_mask,
                                             ys_buffer, pos)

    # ------------------------------------------------ streaming -------
    def encoder_init_cache(self, batch_size: int, required_cache_size: int):
        return self.encoder.init_cache(batch_size, required_cache_size)

    def encoder_forward_chunk(self, xs, cache, chunk_valid=None):
        return self.encoder.forward_chunk(xs, cache, chunk_valid)

    def encoder_forward_chunk_ctc(self, xs, cache, chunk_valid=None):
        """One chunk → (encoder_out, its CTC log-probs, new cache)."""
        ys, new_cache = self.encoder.forward_chunk(xs, cache, chunk_valid)
        return ys, self.ctc.log_softmax(ys), new_cache
