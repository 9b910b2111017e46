"""Decode API, RNN-T greedy modes (port of ``wenet_celoss_tpu/decode/api.py``:
``Decoder.rnnt_greedy_arrays`` and ``Decoder.rnnt_greedy_search`` with no
context, and with context under ``context_filter_state`` "on" or "off").

The ``"exact"`` host-driven backtracking mode and the other decode modes
come with later slices.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from wenet_celoss_tpu_torch.decode import rnnt_greedy
from wenet_celoss_tpu_torch.models.factory import resolve_device
from wenet_celoss_tpu_torch.models.transducer import Transducer


class Decoder:
    """Binds a model to decode calls, on the card unless the caller passes
    ``device="cpu"``."""

    def __init__(self, model: Transducer, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.last_gates = None

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    @torch.no_grad()
    def rnnt_greedy_arrays(self, feats, feat_lens, n_steps: int = 4,
                           context_list=None, context_lengths=None,
                           context_filter_state: str = "off",
                           trace: Optional[list] = None):
        """(tokens [B, U], lens [B], gates [B, U] or None).

        feats [B, T, F] float, feat_lens [B]; context_list [N, L] phrase
        ids padded with -1 (row 0 is the no-bias sentinel ``[0]``),
        context_lengths [N]. ``trace``: see ``decode.rnnt_greedy``."""
        model = self.model
        feats = self._tensor(feats, torch.float32)
        feat_lens = self._tensor(feat_lens, torch.long)
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

        if context_filter_state not in ("on", "off"):
            raise NotImplementedError(
                f"context_filter_state={context_filter_state!r} is not "
                "ported (the 'exact' backtracking mode comes later)")
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

    def rnnt_greedy_search(self, feats, feat_lens, n_steps: int = 4,
                           context_list=None, context_lengths=None,
                           context_filter_state: str = "off",
                           trace: Optional[list] = None) -> List[List[int]]:
        """Token lists per utterance; with context, the per-token gates go
        to ``self.last_gates`` as (gates [B, U], lens [B])."""
        toks, lens, gates = self.rnnt_greedy_arrays(
            feats, feat_lens, n_steps=n_steps, context_list=context_list,
            context_lengths=context_lengths,
            context_filter_state=context_filter_state, trace=trace)
        if gates is not None:
            self.last_gates = (gates, lens)
        return rnnt_greedy.greedy_to_lists(toks, lens)
