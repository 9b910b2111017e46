"""Batched CTC prefix beam search with Viterbi scores and emission times
(port of ``wenet_celoss_tpu/decode/ctc_prefix_beam.py``).

A fixed [B, BEAM] set of prefixes with (log_pb, log_pnb) scores, token
buffers and two rolling hashes. Each frame expands beam × (first_beam +
1) candidates: a "keep" entry per prefix (the blank and repeat
continuations) and an "extend" entry per top-k token. Candidates with the
same (hash1, hash2, length) are merged into their first representative by
log-sum-exp over a [C, C] equality mask, and the beam keeps the best
``beam`` of them. Viterbi best-path scores per channel and the frames of
each token's emission are carried along (merged by max).

The JAX package's ``lax.scan`` over frames is a Python loop here, with no
host sync inside. Every top-k orders ties by index (``stable_topk``), as
``jax.lax.top_k`` does, and the hashes wrap in int32 as they do there.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

from wenet_celoss_tpu_torch.utils.common import LOG_ZERO, stable_topk

# The two rolling hashes of a prefix: multipliers and empty-prefix values
# (shared with the RNN-T prefix beam).
H1_MULT, H2_MULT = 1000003, 10007
H1_INIT, H2_INIT = 17, 29


class BeamState(NamedTuple):
    tokens: torch.Tensor    # [B, BM, U] int64
    lens: torch.Tensor      # [B, BM]
    pb: torch.Tensor        # [B, BM] log p(prefix, ends blank)
    pnb: torch.Tensor       # [B, BM] log p(prefix, ends non-blank)
    h1: torch.Tensor        # [B, BM] rolling hash 1, int32
    h2: torch.Tensor        # [B, BM] rolling hash 2, int32
    vit_b: torch.Tensor     # [B, BM] best path score, path ends in blank
    vit_nb: torch.Tensor    # [B, BM] best path score, ends in non-blank
    times_b: torch.Tensor   # [B, BM, U] emission frames of the vit_b path
    times_nb: torch.Tensor  # [B, BM, U] emission frames of the vit_nb path
    ctp: torch.Tensor       # [B, BM] emission log-prob of the nb path's
    #                         last token


def _init_state(b: int, beam: int, u_max: int, device) -> BeamState:
    zeros_i = torch.zeros((b, beam, u_max), dtype=torch.long, device=device)
    neg = torch.full((b, beam), LOG_ZERO, device=device)
    first = neg.clone()
    first[:, 0] = 0.0
    return BeamState(
        tokens=zeros_i, lens=torch.zeros((b, beam), dtype=torch.long,
                                         device=device),
        pb=first, pnb=neg,
        h1=torch.full((b, beam), H1_INIT, dtype=torch.int32, device=device),
        h2=torch.full((b, beam), H2_INIT, dtype=torch.int32, device=device),
        vit_b=first.clone(), vit_nb=neg.clone(), times_b=zeros_i,
        times_nb=zeros_i.clone(), ctp=neg.clone())


def roll_hash(h: torch.Tensor, mult: int, tok: torch.Tensor) -> torch.Tensor:
    """``h * mult + tok + 1`` in wrapping int32 arithmetic: computed in
    int64, where it cannot overflow, then reduced modulo 2^32 into int32's
    range."""
    x = (h.long() * mult + tok.long() + 1) & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, BM, U] rows picked by idx [B, K] → [B, K, U]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def candidate_layout(b: int, n: int, k: int, device):
    """The candidate order of a frame, [keep (N), extend (N * K)]: each
    candidate's parent slot and whether it extends ([B, C] each, C = N *
    (K + 1)), and the candidate index [C]."""
    ar = torch.arange(n, device=device)
    parent = torch.cat([ar, ar.repeat_interleave(k)])[None].expand(b, -1)
    is_ext = torch.cat([torch.zeros(n, dtype=torch.bool, device=device),
                        torch.ones(n * k, dtype=torch.bool, device=device)])
    return parent, is_ext[None].expand(b, -1), torch.arange(
        n * (k + 1), device=device)


def merge_prefixes(lens, h1, h2, cand_parent, cand_is_ext, cand_tok, idx):
    """Each candidate's prefix (its parent's length and rolling hashes,
    extended by its token where it extends), the [B, C, C] mask of
    candidates with the same (hash1, hash2, length), and whether each
    candidate is the first of its prefix, the one that carries the merged
    mass → (cand_len, cand_h1, cand_h2, eq, is_rep)."""
    par_len = torch.gather(lens, 1, cand_parent)
    par_h1 = torch.gather(h1, 1, cand_parent)
    par_h2 = torch.gather(h2, 1, cand_parent)
    cand_len = torch.where(cand_is_ext, par_len + 1, par_len)
    cand_h1 = torch.where(cand_is_ext, roll_hash(par_h1, H1_MULT, cand_tok),
                          par_h1)
    cand_h2 = torch.where(cand_is_ext, roll_hash(par_h2, H2_MULT, cand_tok),
                          par_h2)
    eq = ((cand_h1[:, :, None] == cand_h1[:, None, :])
          & (cand_h2[:, :, None] == cand_h2[:, None, :])
          & (cand_len[:, :, None] == cand_len[:, None, :]))
    is_rep = eq.to(torch.uint8).argmax(dim=2) == idx[None, :]
    return cand_len, cand_h1, cand_h2, eq, is_rep


def extend_tokens(tokens, lens, sel_parent, sel_is_ext, sel_tok):
    """The kept hypotheses' token buffers [B, N, U]: each parent's, with
    the new token written at the parent's length where the hypothesis
    extends (at the last slot once the buffer is full)."""
    u_max = tokens.shape[2]
    out = _gather_rows(tokens, sel_parent)
    pos = torch.gather(lens, 1, sel_parent).clamp_max(u_max - 1)
    hit = torch.arange(u_max, device=tokens.device) == pos[..., None]
    return torch.where(hit & sel_is_ext[..., None], sel_tok[..., None], out)


def ctc_prefix_beam_search(ctc_log_probs: torch.Tensor,
                           input_lengths: torch.Tensor, beam: int = 10,
                           first_beam: int = 10, u_max: int = 0,
                           blank: int = 0) -> Dict[str, torch.Tensor]:
    """Run the search.

    ctc_log_probs [B, T, V]; input_lengths [B] valid frames; ``beam``
    prefixes kept; ``first_beam`` tokens a frame considered; ``u_max``
    the longest output (0: T). Returns tokens [B, BM, U], lens [B, BM],
    scores [B, BM] (log p, best first), viterbi [B, BM], times
    [B, BM, U]."""
    b, t_max, v = ctc_log_probs.shape
    dev = ctc_log_probs.device
    if u_max <= 0:
        u_max = t_max
    k = min(first_beam, v)
    bm = beam
    st = _init_state(b, bm, u_max, dev)
    cand_parent, cand_is_ext, idx = candidate_layout(b, bm, k, dev)
    slots = torch.arange(u_max, device=dev)
    no_ext = torch.zeros((b, bm * k), dtype=torch.bool, device=dev)

    for t in range(t_max):
        logp_t = ctc_log_probs[:, t]                           # [B, V]
        valid_t = t < input_lengths                            # [B]
        topv, topi = stable_topk(logp_t, k)                    # [B, K]
        lp_blank = logp_t[:, blank]

        last_tok = torch.gather(st.tokens, 2,
                                (st.lens - 1).clamp_min(0)[..., None])[..., 0]
        has_tok = st.lens > 0
        lp_last = torch.gather(logp_t, 1, last_tok)            # [B, BM]

        # "keep": the blank and repeat continuations fire only when blank
        # / the prefix's last token survived the first-beam prune.
        blank_in = (topi == blank).any(dim=1)[:, None]
        last_in = (topi[:, None, :] == last_tok[..., None]).any(dim=2)
        keep_pb = torch.where(
            blank_in, torch.logaddexp(st.pb, st.pnb) + lp_blank[:, None],
            LOG_ZERO)
        keep_pnb = torch.where(has_tok & last_in, st.pnb + lp_last, LOG_ZERO)
        # Viterbi: a blank continue from either channel, a repeat continue
        # from the non-blank one only.
        keep_vit_b = torch.where(
            blank_in, torch.maximum(st.vit_b, st.vit_nb) + lp_blank[:, None],
            LOG_ZERO)
        keep_vit_b_from_nb = st.vit_nb > st.vit_b
        keep_vit_nb = torch.where(has_tok & last_in, st.vit_nb + lp_last,
                                  LOG_ZERO)

        # "extend": append top-k token c, [B, BM, K].
        cand_tok = topi[:, None, :].expand(b, bm, k)
        cand_lp = topv[:, None, :].expand(b, bm, k)
        is_blank = cand_tok == blank
        repeat = (cand_tok == last_tok[..., None]) & has_tok[..., None]
        base = torch.where(repeat, st.pb[..., None],
                           torch.logaddexp(st.pb, st.pnb)[..., None])
        ext_pnb = torch.where(is_blank, LOG_ZERO, base + cand_lp)
        # A repeat extension comes through the blank channel, else the
        # better of both.
        vit_base = torch.where(repeat, st.vit_b[..., None],
                               torch.maximum(st.vit_b, st.vit_nb)[..., None])
        ext_vit_from_nb = ~repeat & (st.vit_nb > st.vit_b)[..., None]
        ext_vit_nb = torch.where(is_blank, LOG_ZERO, vit_base + cand_lp)
        full_len = (st.lens >= u_max)[..., None]
        ext_pnb = torch.where(full_len, LOG_ZERO, ext_pnb)
        ext_vit_nb = torch.where(full_len, LOG_ZERO, ext_vit_nb)
        ext_neg = torch.full((b, bm * k), LOG_ZERO, device=dev)

        cand_token = torch.cat([torch.zeros_like(st.lens),
                                cand_tok.reshape(b, -1)], dim=1)
        cand_pb = torch.cat([keep_pb, ext_neg], dim=1)
        cand_pnb = torch.cat([keep_pnb, ext_pnb.reshape(b, -1)], dim=1)
        cand_vit_b = torch.cat([keep_vit_b, ext_neg], dim=1)
        cand_vit_nb = torch.cat([keep_vit_nb, ext_vit_nb.reshape(b, -1)],
                                dim=1)
        # Whether each channel's winning path came from the parent's
        # non-blank channel (which parent times buffer it inherits).
        cand_b_from_nb = torch.cat([keep_vit_b_from_nb, no_ext], dim=1)
        cand_nb_from_nb = torch.cat([torch.ones_like(keep_vit_b_from_nb),
                                     ext_vit_from_nb.reshape(b, -1)], dim=1)
        # The nb path's last-token emission log-prob, and whether a repeat
        # continuation refreshes that token's time this frame.
        keep_refresh = has_tok & last_in & (lp_last > st.ctp)
        keep_ctp = torch.where(last_in, torch.maximum(st.ctp, lp_last),
                               st.ctp)
        cand_ctp = torch.cat([keep_ctp, cand_lp.reshape(b, -1)], dim=1)
        cand_refresh = torch.cat([keep_refresh, no_ext], dim=1)

        # Merge identical prefixes into their first representative.
        cand_len, cand_h1, cand_h2, eq, is_rep = merge_prefixes(
            st.lens, st.h1, st.h2, cand_parent, cand_is_ext, cand_token, idx)
        neg_mask = torch.where(eq, 0.0, LOG_ZERO)
        m_pb = torch.logsumexp(cand_pb[:, None, :] + neg_mask, dim=2)
        m_pnb = torch.logsumexp(cand_pnb[:, None, :] + neg_mask, dim=2)
        m_vit_b, m_vit_b_src = torch.where(
            eq, cand_vit_b[:, None, :], LOG_ZERO).max(dim=2)
        m_vit_nb, m_vit_nb_src = torch.where(
            eq, cand_vit_nb[:, None, :], LOG_ZERO).max(dim=2)
        # Non-representatives carry no mass: they may still fill the beam
        # when there are fewer distinct prefixes than slots.
        m_pb = torch.where(is_rep, m_pb, LOG_ZERO)
        m_pnb = torch.where(is_rep, m_pnb, LOG_ZERO)
        m_vit_b = torch.where(is_rep, m_vit_b, LOG_ZERO)
        m_vit_nb = torch.where(is_rep, m_vit_nb, LOG_ZERO)

        _, top_idx = stable_topk(torch.logaddexp(m_pb, m_pnb), bm)

        def sel(x):
            return torch.gather(x, 1, top_idx)

        new_tokens = extend_tokens(st.tokens, st.lens, sel(cand_parent),
                                   sel(cand_is_ext), sel(cand_token))

        def times_for(src, from_nb_flags, refresh_flags):
            """The new times buffer of one Viterbi channel."""
            par = torch.gather(cand_parent, 1, src)
            is_ext = torch.gather(cand_is_ext, 1, src)
            from_nb = torch.gather(from_nb_flags, 1, src)
            times = torch.where(from_nb[..., None],
                                _gather_rows(st.times_nb, par),
                                _gather_rows(st.times_b, par))
            plen = torch.gather(st.lens, 1, par)
            # An extension writes t at its new slot; a repeat
            # continuation on the nb channel refreshes the last token's
            # time when this frame improves its emission log-prob.
            do = is_ext
            if refresh_flags is not None:
                do = do | torch.gather(refresh_flags, 1, src)
            upd_pos = torch.where(is_ext, plen.clamp_max(u_max - 1),
                                  (plen - 1).clamp_min(0))
            hit = (slots == upd_pos[..., None]) & do[..., None]
            return torch.where(hit, t, times)

        sel_vnb_src = sel(m_vit_nb_src)
        new = BeamState(
            tokens=new_tokens, lens=sel(cand_len), pb=sel(m_pb),
            pnb=sel(m_pnb), h1=sel(cand_h1), h2=sel(cand_h2),
            vit_b=sel(m_vit_b), vit_nb=sel(m_vit_nb),
            times_b=times_for(sel(m_vit_b_src), cand_b_from_nb, None),
            times_nb=times_for(sel_vnb_src, cand_nb_from_nb, cand_refresh),
            ctp=torch.gather(cand_ctp, 1, sel_vnb_src))
        # Frames past an utterance's length leave its beam unchanged.
        st = BeamState(*(
            torch.where(valid_t.reshape((b,) + (1,) * (n.dim() - 1)), n, o)
            for n, o in zip(new, st)))

    score = torch.logaddexp(st.pb, st.pnb)
    vit = torch.maximum(st.vit_b, st.vit_nb)
    times = torch.where((st.vit_nb > st.vit_b)[..., None], st.times_nb,
                        st.times_b)
    order = torch.argsort(-score, dim=1, stable=True)
    return {"tokens": _gather_rows(st.tokens, order),
            "lens": torch.gather(st.lens, 1, order),
            "scores": torch.gather(score, 1, order),
            "viterbi": torch.gather(vit, 1, order),
            "times": _gather_rows(times, order)}


def nbest_to_lists(result: Dict[str, torch.Tensor],
                   n: int = 1) -> List[List[List[int]]]:
    """The first ``n`` hypotheses of each utterance as token lists."""
    tokens = result["tokens"].cpu().tolist()
    lens = result["lens"].cpu().tolist()
    return [[row[:ln] for row, ln in zip(tokens[i][:n], lens[i][:n])]
            for i in range(len(tokens))]
