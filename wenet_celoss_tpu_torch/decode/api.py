"""Decode API, one call per decode mode (port of
``wenet_celoss_tpu/decode/api.py``): CTC greedy, CTC prefix beam,
attention beam, attention rescoring, RNN-T greedy, RNN-T beam (with or
without a context list), and the two transducer/attention rescorings.

RNN-T greedy with a context list runs under one of three gating states
(``context_filter_state``), each with two encoder passes (one biased with
the list, one with the empty list):
- "off": every frame decodes on the biased streams; the gate of each
  token's frame is still recorded;
- "on": the per-frame gate chooses the stream, label-synchronously;
- "exact": the backtracking repair loop, one utterance at a time with
  host syncs at every step (``rnnt_greedy.rnnt_gated_greedy_search_exact``).
``last_gates`` is then (gates [B, G], lens [B]): under "off" and "on" one
gate per token (G = the token buffer, lens the token counts, tensors);
under "exact" one gate per predictor step (numpy, zero-padded to the
longest record, lens the record lengths).

Every CTC and attention mode takes the encode's keywords: the full
context by default, a chunk mask with ``decoding_chunk_size`` (which, as
in the JAX package, masks only a model with ``static_chunk_size``: a
dynamic-chunk model decodes with the full context), and with
``simulate_streaming=True`` the true chunk-by-chunk forward over bounded
caches (``encode_ctc_streaming``).
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from wenet_celoss_tpu_torch.decode import (attention_beam, ctc_greedy,
                                           ctc_prefix_beam, rescoring,
                                           rnnt_beam, rnnt_greedy)
from wenet_celoss_tpu_torch.decode.streaming import forward_chunk_by_chunk
from wenet_celoss_tpu_torch.models.asr_model import ASRModel
from wenet_celoss_tpu_torch.models.factory import resolve_device
from wenet_celoss_tpu_torch.models.subsampling import subsampled_length
from wenet_celoss_tpu_torch.models.transducer import Transducer


def _lists(tokens: torch.Tensor, lens: torch.Tensor) -> List[List[int]]:
    """tokens [B, U], lens [B] → token lists."""
    return [row[:ln] for row, ln in zip(tokens.cpu().tolist(),
                                        lens.cpu().tolist())]


def _best(nbest):
    """(tokens [B, U], lens [B]) of the highest-scoring hypothesis of an
    n-best (the first on a tie)."""
    return rescoring.pick_best(nbest["scores"], nbest["tokens"],
                               nbest["lens"])


class Decoder:
    """Binds an ASRModel or a Transducer to decode calls, in eval mode, on
    the card unless the caller passes ``device="cpu"``. Inputs may be
    numpy arrays or tensors."""

    def __init__(self, model: Union[ASRModel, Transducer], device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.last_gates = None

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _inputs(self, feats, feat_lens):
        return (self._tensor(feats, torch.float32),
                self._tensor(feat_lens, torch.long))

    # ------------------------------------------------------- CTC / AED ---
    @torch.no_grad()
    def encode_ctc(self, feats, feat_lens, decoding_chunk_size: int = -1,
                   num_decoding_left_chunks: int = -1):
        """→ (encoder_out [B, T', D], pad_mask [B, T'], CTC log-probs
        [B, T', V])."""
        feats, feat_lens = self._inputs(feats, feat_lens)
        return self.model.encode_ctc(feats, feat_lens, decoding_chunk_size,
                                     num_decoding_left_chunks)

    @torch.no_grad()
    def encode_ctc_streaming(self, feats, feat_lens,
                             decoding_chunk_size: int,
                             num_decoding_left_chunks: int = -1):
        """Simulated streaming: the chunk-by-chunk forward with bounded
        attention and conv caches → (encoder_out [B, T', D], mask [B, T'],
        CTC log-probs [B, T', V]) over the frames of whole chunks (T' =
        chunks × ``decoding_chunk_size``; frames after the last whole
        window are dropped). The cache holds ``num_decoding_left_chunks``
        chunks, 16 when that is 0 or negative (a bound the JAX package
        sets where the reference grows its cache without one)."""
        feats, feat_lens = self._inputs(feats, feat_lens)
        model = self.model
        enc = model.encoder
        left = num_decoding_left_chunks if num_decoding_left_chunks > 0 \
            else 16
        cache = model.encoder_init_cache(feats.shape[0],
                                         decoding_chunk_size * left)

        def step(xs, c, valid):
            ys, ctc_lp, c = model.encoder_forward_chunk_ctc(xs, c, valid)
            return (ys, ctc_lp), c

        total_out = subsampled_length(enc.input_layer, feat_lens)
        (ys, ctc_lp), _ = forward_chunk_by_chunk(
            step, cache, feats, enc.subsampling_rate, enc.right_context,
            decoding_chunk_size, out_lens=total_out)
        t_out = ys.shape[1]
        out_lens = torch.clamp(total_out, max=t_out)
        mask = (torch.arange(t_out, device=ys.device)[None, :]
                < out_lens[:, None])
        return ys, mask, ctc_lp

    def _encode(self, feats, feat_lens, simulate_streaming: bool = False,
                decoding_chunk_size: int = -1,
                num_decoding_left_chunks: int = -1):
        if simulate_streaming and decoding_chunk_size > 0:
            return self.encode_ctc_streaming(feats, feat_lens,
                                             decoding_chunk_size,
                                             num_decoding_left_chunks)
        return self.encode_ctc(feats, feat_lens, decoding_chunk_size,
                               num_decoding_left_chunks)

    def ctc_greedy_search(self, feats, feat_lens, **kw) -> List[List[int]]:
        _, mask, ctc_lp = self._encode(feats, feat_lens, **kw)
        return ctc_greedy.ctc_greedy_search(ctc_lp, mask)

    @torch.no_grad()
    def ctc_prefix_beam_search(self, feats, feat_lens, beam: int = 10,
                               first_beam: Optional[int] = None, **kw):
        """→ (best token list per utterance, the search's result dict,
        encoder_out, pad_mask). ``first_beam`` (the tokens a frame
        considers) defaults to ``beam``."""
        enc, mask, ctc_lp = self._encode(feats, feat_lens, **kw)
        res = ctc_prefix_beam.ctc_prefix_beam_search(
            ctc_lp, mask.sum(dim=1), beam=beam,
            first_beam=first_beam if first_beam else beam)
        return ctc_prefix_beam.nbest_to_lists(res, 1), res, enc, mask

    @torch.no_grad()
    def attention_nbest(self, feats, feat_lens, beam: int = 10,
                        max_len: int = 0, **kw):
        """The attention beam's n-best: {tokens [B, N, L], lens [B, N],
        scores [B, N]}, best first; ``max_len`` 0 is the encoder's
        length."""
        enc, mask, _ = self._encode(feats, feat_lens, **kw)
        if max_len <= 0:
            max_len = int(enc.shape[1])
        model = self.model
        hyps, lens, scores = attention_beam.attention_beam_search(
            model.decoder_one_step, enc, mask, model.sos, model.eos, beam,
            max_len)
        return {"tokens": hyps, "lens": lens, "scores": scores}

    def attention_arrays(self, feats, feat_lens, beam: int = 10,
                         max_len: int = 0, **kw):
        """(hyps [B, N, L], lens [B, N]), best first."""
        nb = self.attention_nbest(feats, feat_lens, beam, max_len, **kw)
        return nb["tokens"], nb["lens"]

    def attention(self, feats, feat_lens, beam: int = 10, max_len: int = 0,
                  **kw) -> List[List[int]]:
        hyps, lens = self.attention_arrays(feats, feat_lens, beam=beam,
                                           max_len=max_len, **kw)
        return attention_beam.attention_hyps_to_lists(hyps, lens,
                                                      self.model.eos)

    @torch.no_grad()
    def attention_rescoring_nbest(self, feats, feat_lens, beam: int = 10,
                                  ctc_weight: float = 0.0,
                                  reverse_weight: float = 0.0, **kw):
        """The CTC prefix beam's n-best with ``scores`` [B, N] replaced by
        the rescoring's totals (attention + ctc_weight * CTC)."""
        _, res, enc, mask = self.ctc_prefix_beam_search(
            feats, feat_lens, beam=beam, **kw)
        model = self.model
        _, _, total = rescoring.attention_rescoring(
            model.decoder_scores, enc, mask, res, model.sos, model.eos,
            ctc_weight, reverse_weight)
        return {**res, "scores": total}

    def attention_rescoring_arrays(self, feats, feat_lens, beam: int = 10,
                                   ctc_weight: float = 0.0,
                                   reverse_weight: float = 0.0, **kw):
        """(best_tokens [B, U], best_lens [B]): the CTC prefix beam's
        n-best re-ranked by the attention decoder."""
        return _best(self.attention_rescoring_nbest(
            feats, feat_lens, beam=beam, ctc_weight=ctc_weight,
            reverse_weight=reverse_weight, **kw))

    def attention_rescoring(self, feats, feat_lens, beam: int = 10,
                            ctc_weight: float = 0.0,
                            reverse_weight: float = 0.0,
                            **kw) -> List[List[int]]:
        return _lists(*self.attention_rescoring_arrays(
            feats, feat_lens, beam=beam, ctc_weight=ctc_weight,
            reverse_weight=reverse_weight, **kw))

    # ------------------------------------------------------ Transducer ---
    @torch.no_grad()
    def rnnt_greedy_arrays(self, feats, feat_lens, n_steps: int = 4,
                           context_list=None, context_lengths=None,
                           context_filter_state: str = "off",
                           trace: Optional[list] = None):
        """(tokens [B, U], lens [B], gates [B, U] or None); under "exact"
        (token lists, None, None), with the gates in ``last_gates``.

        feats [B, T, F] float, feat_lens [B]; context_list [N, L] phrase
        ids padded with -1 (row 0 is the no-bias sentinel ``[0]``),
        context_lengths [N]. ``trace``: see ``decode.rnnt_greedy``."""
        model = self.model
        feats, feat_lens = self._inputs(feats, feat_lens)
        b = feats.shape[0]
        p_step = model.predictor_step
        if context_list is None:
            enc, _, _, mask = model.encode_transducer(feats, feat_lens)
            enc_lens = mask.long().sum(dim=1)
            enc_j = model.joint_enc_proj(enc)
            toks, lens = rnnt_greedy.rnnt_greedy_search_labelsync(
                p_step, lambda p: model.joint_frames(enc_j, p),
                model.predictor_init_state(b), enc.shape[1], enc_lens,
                blank=model.blank, n_steps=n_steps, trace=trace)
            return toks, lens, None

        if context_filter_state == "exact":
            return self._rnnt_exact(feats, feat_lens, context_list,
                                    context_lengths, n_steps, trace)
        if context_filter_state not in ("on", "off"):
            raise ValueError(
                f"context_filter_state={context_filter_state!r}: one of "
                "'on', 'off', 'exact'")
        gate_on = context_filter_state == "on"
        bias_h = model.bias_hidden(self._tensor(context_list, torch.long),
                                   self._tensor(context_lengths, torch.long))
        _, e_biased, e_bias, mask = model.encode_transducer(
            feats, feat_lens, bias_h)
        e_lens = mask.long().sum(dim=1)
        # The gate-off stream is biased with the EMPTY hotword list (the
        # sentinel [0] only), as the reference does.
        bias_h_e = model.bias_hidden(
            torch.zeros((1, 1), dtype=torch.long, device=self.device),
            torch.ones((1,), dtype=torch.long, device=self.device))
        _, e_empty, _, _ = model.encode_transducer(feats, feat_lens,
                                                   bias_h_e)
        gate_logits = model.hw_gate_logits(e_bias)
        gate_all = torch.argmax(gate_logits, dim=-1)
        use_bias_all = (gate_all > 0) if gate_on else \
            torch.ones_like(gate_all, dtype=torch.bool)
        e_sel = torch.where(use_bias_all[..., None], e_biased, e_empty)
        e_j_sel = model.joint_enc_proj(e_sel)

        def joint_frames_sel(pred_biased, pred_empty, use_bias):
            lb = model.joint_frames(e_j_sel, pred_biased)
            le = model.joint_frames(e_j_sel, pred_empty)
            return torch.where(use_bias[..., None], lb, le)

        return rnnt_greedy.rnnt_gated_greedy_search_labelsync(
            p_step, lambda p: model.predictor_bias_step(bias_h, p),
            joint_frames_sel, gate_logits, model.predictor_init_state(b),
            e_biased.shape[1], e_lens, blank=model.blank, n_steps=n_steps,
            gate_on=gate_on,
            predictor_bias_step_empty=lambda p: model.predictor_bias_step(
                bias_h_e, p),
            trace=trace)

    @torch.no_grad()
    def _rnnt_exact(self, feats, feat_lens, context_list, context_lengths,
                    n_steps: int, trace: Optional[list]):
        """The "exact" gating state: two encoder passes (the real list and
        the empty list, sentinel [0]) over the batch, then the repair loop
        one utterance at a time with batch-1 steps and the model's
        ``loss_mode``. Sets ``last_gates`` and returns (token lists, None,
        None). ``trace`` receives one list per utterance (see
        ``rnnt_greedy.rnnt_gated_greedy_search_exact``)."""
        model = self.model
        b = feats.shape[0]
        bias_h = model.bias_hidden(self._tensor(context_list, torch.long),
                                   self._tensor(context_lengths, torch.long))
        _, e_biased, e_bias, mask = model.encode_transducer(
            feats, feat_lens, bias_h)
        e_lens = mask.long().sum(dim=1).tolist()
        bias_h_e = model.bias_hidden(
            torch.zeros((1, 1), dtype=torch.long, device=self.device),
            torch.ones((1,), dtype=torch.long, device=self.device))
        _, e_empty, _, _ = model.encode_transducer(feats, feat_lens,
                                                   bias_h_e)
        all_hyps, all_gates = [], []
        for i in range(b):
            utt_trace = [] if trace is not None else None
            hyps, gates = rnnt_greedy.rnnt_gated_greedy_search_exact(
                model.predictor_step,
                lambda p: model.predictor_bias_step(bias_h, p),
                lambda p: model.predictor_bias_step(bias_h_e, p),
                model.joint_step,
                lambda e, p: model.hw_gate_step(e, p),
                model.predictor_init_state(1), e_empty[i:i + 1],
                e_biased[i:i + 1], e_bias[i:i + 1], e_lens[i],
                blank=model.blank, n_steps=n_steps,
                loss_mode=model.loss_mode, trace=utt_trace)
            all_hyps.append(hyps)
            all_gates.append(gates)
            if trace is not None:
                trace.append(utt_trace)
        glens = np.array([len(g) for g in all_gates], np.int32)
        gates_arr = np.zeros((b, max(int(glens.max(initial=0)), 1)),
                             np.int32)
        for i, g in enumerate(all_gates):
            gates_arr[i, :len(g)] = g
        self.last_gates = (gates_arr, glens)
        return all_hyps, None, None

    def rnnt_greedy_search(self, feats, feat_lens, n_steps: int = 4,
                           context_list=None, context_lengths=None,
                           context_filter_state: str = "off",
                           trace: Optional[list] = None) -> List[List[int]]:
        """Token lists per utterance. With a context list, the gates go to
        ``self.last_gates`` (see the module docstring for each state)."""
        toks, lens, gates = self.rnnt_greedy_arrays(
            feats, feat_lens, n_steps=n_steps, context_list=context_list,
            context_lengths=context_lengths,
            context_filter_state=context_filter_state, trace=trace)
        if lens is None:   # "exact": ragged host lists, last_gates set
            return toks
        if gates is not None:
            self.last_gates = (gates, lens)
        return rnnt_greedy.greedy_to_lists(toks, lens)

    @torch.no_grad()
    def rnnt_beam_search(self, feats, feat_lens, beam: int = 5,
                         ctc_weight: float = 0.0,
                         transducer_weight: float = 1.0, context_list=None,
                         context_lengths=None):
        """RNN-T prefix beam search (top-k min(beam, 10) a hypothesis),
        fused with the CTC head when ``ctc_weight`` > 0, on the biased
        encoder and predictor streams when a context list is given →
        (result dict: tokens [B, N, U], lens [B, N], scores [B, N], best
        first; encoder_out searched; pad_mask)."""
        model = self.model
        feats, feat_lens = self._inputs(feats, feat_lens)
        b = feats.shape[0]
        bias_hidden = None
        if context_list is not None:
            bias_hidden = model.bias_hidden(
                self._tensor(context_list, torch.long),
                self._tensor(context_lengths, torch.long))
        enc, enc_biased, _, mask = model.encode_transducer(feats, feat_lens,
                                                           bias_hidden)
        enc_use = enc if bias_hidden is None else enc_biased
        joint_fn = model.joint_step
        if bias_hidden is not None:
            def joint_fn(enc_t, pred_u):
                pred_b, _ = model.predictor_bias_step(bias_hidden, pred_u)
                return model.joint_step(enc_t, pred_b)
        ctc_lp = model.ctc_logprobs(enc_use) if ctc_weight > 0.0 else None
        res = rnnt_beam.rnnt_prefix_beam_search(
            model.predictor_step, joint_fn,
            model.predictor_init_state(b * beam), enc_use, mask.sum(dim=1),
            beam=beam, topk=min(beam, 10), ctc_log_probs=ctc_lp,
            transducer_weight=transducer_weight, ctc_weight=ctc_weight,
            blank=model.blank, state_gather=model.predictor_gather_state)
        return res, enc_use, mask

    def rnnt_beam_to_lists(self, res) -> List[List[int]]:
        """The best hypothesis of each utterance as a token list."""
        return _lists(res["tokens"][:, 0], res["lens"][:, 0])

    def _attention_scores(self, enc, mask, res, reverse_weight: float):
        model = self.model
        return rescoring.score_hyps_with_decoder(
            model.decoder_scores, enc, mask, res["tokens"], res["lens"],
            model.sos, model.eos, reverse_weight)

    @torch.no_grad()
    def ctc_beam_td_attn_nbest(self, feats, feat_lens, beam: int = 10,
                               ctc_weight: float = 0.0,
                               transducer_weight: float = 0.0,
                               attn_weight: float = 0.0,
                               reverse_weight: float = 0.0, **kw):
        """The CTC prefix beam's n-best with ``scores`` [B, N] replaced by
        ``attn_weight * att + ctc_weight * ctc + transducer_weight * td``
        (td: ``Transducer.transducer_score``)."""
        _, res, enc, mask = self.ctc_prefix_beam_search(
            feats, feat_lens, beam=beam, **kw)
        att = self._attention_scores(enc, mask, res, reverse_weight)
        td = self.model.transducer_score(enc, mask, res["tokens"],
                                         res["lens"])
        return {**res, "scores": attn_weight * att
                + ctc_weight * res["scores"] + transducer_weight * td}

    def ctc_beam_td_attn_rescoring_arrays(self, feats, feat_lens,
                                          beam: int = 10, **weights):
        """(best_tokens [B, U], best_lens [B]) of
        :meth:`ctc_beam_td_attn_nbest`."""
        return _best(self.ctc_beam_td_attn_nbest(feats, feat_lens,
                                                 beam=beam, **weights))

    def ctc_beam_td_attn_rescoring(self, feats, feat_lens, beam: int = 10,
                                   ctc_weight: float = 0.0,
                                   transducer_weight: float = 0.0,
                                   attn_weight: float = 0.0,
                                   reverse_weight: float = 0.0,
                                   **kw) -> List[List[int]]:
        return _lists(*self.ctc_beam_td_attn_rescoring_arrays(
            feats, feat_lens, beam=beam, ctc_weight=ctc_weight,
            transducer_weight=transducer_weight, attn_weight=attn_weight,
            reverse_weight=reverse_weight, **kw))

    @torch.no_grad()
    def rnnt_beam_attn_nbest(self, feats, feat_lens, beam: int = 5,
                             attn_weight: float = 1.0,
                             transducer_weight: float = 1.0,
                             search_ctc_weight: float = 0.0,
                             reverse_weight: float = 0.0, context_list=None,
                             context_lengths=None):
        """The RNN-T beam's n-best with ``scores`` [B, N] replaced by
        ``attn_weight * att + transducer_weight * beam score``."""
        res, enc, mask = self.rnnt_beam_search(
            feats, feat_lens, beam=beam, ctc_weight=search_ctc_weight,
            transducer_weight=transducer_weight, context_list=context_list,
            context_lengths=context_lengths)
        att = self._attention_scores(enc, mask, res, reverse_weight)
        return {**res, "scores": attn_weight * att
                + transducer_weight * res["scores"]}

    def rnnt_beam_attn_rescoring(self, feats, feat_lens, beam: int = 5,
                                 **kw) -> List[List[int]]:
        """The transducer n-best re-ranked by the attention decoder (see
        :meth:`rnnt_beam_attn_nbest`), best hypothesis per utterance."""
        return _lists(*_best(self.rnnt_beam_attn_nbest(
            feats, feat_lens, beam=beam, **kw)))
