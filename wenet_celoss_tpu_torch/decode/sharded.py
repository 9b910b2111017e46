"""Batch decode split over the ranks of a process group, with the results
all-gathered (port of ``wenet_celoss_tpu/decode/sharded.py``).

The JAX ``ShardedDecoder`` runs one SPMD program with the batch sharded
over the mesh's ``data`` axis and all-gathers the results over it. Here
every rank holds the whole batch (all ranks read the same list), pads it
to a multiple of the world size (zero rows of full length, as JAX
``_place`` does), decodes its share, rows [r·share, (r+1)·share), with a
plain :class:`~wenet_celoss_tpu_torch.decode.api.Decoder`, and
``exchange`` all-gathers the padded results (tokens, lengths, scores, the
gates) in rank order; ``take`` drops the padding rows. Every rank then
holds every utterance's result.

``"exact"`` gating (a host loop, one utterance at a time) and any mode
outside ``SUPPORTED_MODES`` run the parent class on the whole batch on
every rank.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from wenet_celoss_tpu_torch.decode import ctc_greedy, ctc_prefix_beam
from wenet_celoss_tpu_torch.decode.api import Decoder, _best, _lists
from wenet_celoss_tpu_torch.decode.rnnt_greedy import greedy_to_lists
from wenet_celoss_tpu_torch.parallel import dist
from wenet_celoss_tpu_torch.utils.common import remove_duplicates_and_blank


class ShardedDecoder(Decoder):
    """A :class:`Decoder` whose batch is split over ``group``'s ranks."""

    #: decode modes that run split over the ranks with the all-gather
    #: (the recognize CLI's mode names); anything else runs the parent.
    SUPPORTED_MODES = frozenset({
        "attention", "ctc_greedy_search", "ctc_prefix_beam_search",
        "attention_rescoring", "rnnt_greedy_search", "rnnt_beam_search",
        "rnnt_beam_attn_rescoring", "ctc_beam_td_attn_rescoring",
    })

    def __init__(self, model, group: dist.DistContext):
        super().__init__(model, device=group.device)
        self.group = group
        # The share is decoded by a plain Decoder, so that the parent's
        # modes that call one another never place a batch twice.
        self.local = Decoder(model, device=self.device)

    # ------------------------------------------------------------ placement
    def _place(self, feats, feat_lens) -> Tuple[torch.Tensor, torch.Tensor,
                                                Callable]:
        """This rank's share of the batch padded to a multiple of the world
        size → (feats, feat_lens, take); ``take(arr)`` drops the padding
        rows from an exchanged result."""
        feats, feat_lens = self._inputs(feats, feat_lens)
        n_real = int(feats.shape[0])
        world, rank = self.group.world, self.group.rank
        pad = (-n_real) % world
        if pad:
            feats = torch.cat([feats, feats.new_zeros(
                (pad,) + tuple(feats.shape[1:]))])
            feat_lens = torch.cat([feat_lens, feat_lens.new_full(
                (pad,), feats.shape[1])])
        share = (n_real + pad) // world
        rows = slice(rank * share, (rank + 1) * share)

        def take(arr):
            return arr[:n_real]

        return feats[rows], feat_lens[rows], take

    def exchange(self, *arrays: torch.Tensor) -> List[torch.Tensor]:
        """All-gather each rank's rows of every array in rank order."""
        return [dist.all_gather_rows(a, self.group) for a in arrays]

    # ---------------------------------------------------------------- modes
    def ctc_greedy_search(self, feats, feat_lens, **kw) -> List[List[int]]:
        feats, feat_lens, take = self._place(feats, feat_lens)
        _, mask, ctc_lp = self.local._encode(feats, feat_lens, **kw)
        ids = ctc_greedy.ctc_greedy_frames(ctc_lp, mask)
        (ids,) = self.exchange(ids)
        return [remove_duplicates_and_blank(row)
                for row in take(ids).cpu().tolist()]

    def ctc_prefix_beam_search(self, feats, feat_lens, beam: int = 10,
                               first_beam: Optional[int] = None, **kw):
        """→ (best token lists, the whole batch's result dict, this rank's
        encoder_out and pad_mask)."""
        feats, feat_lens, take = self._place(feats, feat_lens)
        _, res, enc, mask = self.local.ctc_prefix_beam_search(
            feats, feat_lens, beam=beam, first_beam=first_beam, **kw)
        keys = ("tokens", "lens", "scores", "viterbi", "times")
        full = dict(res, **{k: take(v) for k, v in
                            zip(keys, self.exchange(*(res[k]
                                                      for k in keys)))})
        return ctc_prefix_beam.nbest_to_lists(full, 1), full, enc, mask

    def attention(self, feats, feat_lens, beam: int = 10, max_len: int = 0,
                  **kw) -> List[List[int]]:
        feats, feat_lens, take = self._place(feats, feat_lens)
        hyps, lens = self.local.attention_arrays(feats, feat_lens, beam=beam,
                                                 max_len=max_len, **kw)
        # Only the per-utterance winners travel.
        toks, tlens = self.exchange(hyps[:, 0], lens[:, 0])
        return _lists(take(toks), take(tlens))

    def attention_rescoring(self, feats, feat_lens, beam: int = 10,
                            ctc_weight: float = 0.0,
                            reverse_weight: float = 0.0,
                            **kw) -> List[List[int]]:
        feats, feat_lens, take = self._place(feats, feat_lens)
        toks, lens = self.local.attention_rescoring_arrays(
            feats, feat_lens, beam=beam, ctc_weight=ctc_weight,
            reverse_weight=reverse_weight, **kw)
        toks, lens = self.exchange(toks, lens)
        return _lists(take(toks), take(lens))

    def ctc_beam_td_attn_rescoring(self, feats, feat_lens, beam: int = 10,
                                   ctc_weight: float = 0.0,
                                   transducer_weight: float = 0.0,
                                   attn_weight: float = 0.0,
                                   reverse_weight: float = 0.0,
                                   **kw) -> List[List[int]]:
        feats, feat_lens, take = self._place(feats, feat_lens)
        toks, lens = self.local.ctc_beam_td_attn_rescoring_arrays(
            feats, feat_lens, beam=beam, ctc_weight=ctc_weight,
            transducer_weight=transducer_weight, attn_weight=attn_weight,
            reverse_weight=reverse_weight, **kw)
        toks, lens = self.exchange(toks, lens)
        return _lists(take(toks), take(lens))

    def rnnt_greedy_search(self, feats, feat_lens, n_steps: int = 4,
                           context_list=None, context_lengths=None,
                           context_filter_state: str = "off",
                           trace: Optional[list] = None) -> List[List[int]]:
        if context_filter_state == "exact" and context_list is not None:
            # The host-driven repair loop has no batched arrays to
            # exchange: the whole batch on every rank.
            return super().rnnt_greedy_search(
                feats, feat_lens, n_steps=n_steps, context_list=context_list,
                context_lengths=context_lengths,
                context_filter_state=context_filter_state, trace=trace)
        feats, feat_lens, take = self._place(feats, feat_lens)
        toks, lens, gates = self.local.rnnt_greedy_arrays(
            feats, feat_lens, n_steps=n_steps, context_list=context_list,
            context_lengths=context_lengths,
            context_filter_state=context_filter_state, trace=trace)
        if gates is not None:
            toks, lens, gates = self.exchange(toks, lens, gates)
            self.last_gates = (take(gates), take(lens))
        else:
            toks, lens = self.exchange(toks, lens)
        return greedy_to_lists(take(toks), take(lens))

    def rnnt_beam_search(self, feats, feat_lens, beam: int = 5,
                         ctc_weight: float = 0.0,
                         transducer_weight: float = 1.0, context_list=None,
                         context_lengths=None):
        """→ (the whole batch's result dict, this rank's searched
        encoder_out and pad_mask)."""
        feats, feat_lens, take = self._place(feats, feat_lens)
        res, enc_use, mask = self.local.rnnt_beam_search(
            feats, feat_lens, beam=beam, ctc_weight=ctc_weight,
            transducer_weight=transducer_weight, context_list=context_list,
            context_lengths=context_lengths)
        tokens, tlens, scores = self.exchange(res["tokens"], res["lens"],
                                              res["scores"])
        return (dict(res, tokens=take(tokens), lens=take(tlens),
                     scores=take(scores)), enc_use, mask)

    def rnnt_beam_attn_rescoring(self, feats, feat_lens, beam: int = 5,
                                 **kw) -> List[List[int]]:
        feats, feat_lens, take = self._place(feats, feat_lens)
        toks, lens = _best(self.local.rnnt_beam_attn_nbest(
            feats, feat_lens, beam=beam, **kw))
        toks, lens = self.exchange(toks, lens)
        return _lists(take(toks), take(lens))
