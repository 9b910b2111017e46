"""Batched RNN-T prefix beam search with CTC shallow fusion (port of
``wenet_celoss_tpu/decode/rnnt_beam.py``).

Breadth-first over frames, at most one emission a frame, shallow fusion
``log(w_t e^logp_t + w_ctc e^ctc_t)``, prefix merging by the same
hash-equality log-sum-exp as the CTC prefix beam, and a predictor state
per hypothesis: a flat [B·N] predictor step on the parents' gathered
states (gathered by the predictor's layout), kept only for the
hypotheses that extended. The JAX package's
``lax.scan`` over frames is a Python loop here, with no host sync inside;
every top-k orders ties by index, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from wenet_celoss_tpu_torch.decode.ctc_prefix_beam import (
    H1_INIT, H2_INIT, candidate_layout, extend_tokens, merge_prefixes)
from wenet_celoss_tpu_torch.utils.common import LOG_ZERO, stable_topk


def _log(w: float) -> float:
    return math.log(w) if w > 0 else -math.inf


def rnnt_prefix_beam_search(predictor_step: Callable, joint_step: Callable,
                            init_state, encoder_out: torch.Tensor,
                            encoder_lens: torch.Tensor, beam: int = 5,
                            topk: int = 5,
                            ctc_log_probs: Optional[torch.Tensor] = None,
                            transducer_weight: float = 0.7,
                            ctc_weight: float = 0.3, blank: int = 0,
                            u_max: int = 0, *, state_gather: Callable
                            ) -> Dict[str, torch.Tensor]:
    """Run the search.

    predictor_step: (token [B·N], state, padding [B·N]) → (out, state).
    joint_step: (enc [B·N, E], pred [B·N, P]) → logits [B·N, V].
    init_state: the predictor's state for B·N rows, a dict of tensors.
    state_gather: (state, flat_idx [B·N]) → the state of those rows
    (``Transducer.predictor_gather_state``: the RNN predictor's
    [L, B·N, H] entries hold their rows on dim 1, the stateless
    predictors' history on dim 0). encoder_out [B, T, E]; ctc_log_probs:
    [B, T, V] to fuse, or None.
    Returns tokens [B, N, U], lens [B, N], scores [B, N], best first."""
    b, t_max, _ = encoder_out.shape
    dev = encoder_out.device
    n = beam
    if u_max <= 0:
        u_max = t_max
    bn = b * n

    pred_out, state = predictor_step(
        torch.full((bn,), blank, dtype=torch.long, device=dev), init_state,
        torch.zeros((bn,), dtype=torch.long, device=dev))
    tokens = torch.zeros((b, n, u_max), dtype=torch.long, device=dev)
    lens = torch.zeros((b, n), dtype=torch.long, device=dev)
    scores = torch.full((b, n), LOG_ZERO, device=dev)
    scores[:, 0] = 0.0
    h1 = torch.full((b, n), H1_INIT, dtype=torch.int32, device=dev)
    h2 = torch.full((b, n), H2_INIT, dtype=torch.int32, device=dev)

    cand_parent, cand_is_ext, idx = candidate_layout(b, n, topk, dev)
    rows = (torch.arange(b, device=dev) * n)[:, None]
    log_wt, log_wc = _log(transducer_weight), _log(ctc_weight)

    for t in range(t_max):
        valid_t = (t < encoder_lens)[:, None]                   # [B, 1]
        logits = joint_step(encoder_out[:, t].repeat_interleave(n, dim=0),
                            pred_out)                           # [B·N, V]
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, n, -1)
        if ctc_log_probs is not None:
            fused = torch.logaddexp(log_wt + logp,
                                    log_wc + ctc_log_probs[:, t][:, None])
        else:
            fused = logp

        # Candidates: stay (blank) and the top-k non-blank extensions.
        stay = scores + fused[:, :, blank]                      # [B, N]
        fused_nb = fused.clone()
        fused_nb[:, :, blank] = LOG_ZERO
        top_lp, top_tok = stable_topk(fused_nb, topk)           # [B, N, K]
        ext = torch.where((lens >= u_max)[..., None], LOG_ZERO,
                          scores[..., None] + top_lp)
        cand_tok = torch.cat([torch.zeros_like(lens),
                              top_tok.reshape(b, -1)], dim=1)
        cand_score = torch.cat([stay, ext.reshape(b, -1)], dim=1)

        # Merge identical prefixes into their first representative.
        cand_len, cand_h1, cand_h2, eq, is_rep = merge_prefixes(
            lens, h1, h2, cand_parent, cand_is_ext, cand_tok, idx)
        m_score = torch.logsumexp(
            torch.where(eq, cand_score[:, None, :], LOG_ZERO), dim=2)
        m_score = torch.where(is_rep, m_score, LOG_ZERO)

        top_score, top_idx = stable_topk(m_score, n)            # [B, N]

        def sel(x):
            return torch.gather(x, 1, top_idx)

        sel_parent = sel(cand_parent)
        sel_is_ext = sel(cand_is_ext)
        sel_tok = sel(cand_tok)
        new_tokens = extend_tokens(tokens, lens, sel_parent, sel_is_ext,
                                   sel_tok)

        # Predictor: gather the parents' states, step the extended rows.
        parent_flat = (rows + sel_parent).reshape(-1)
        par_pred = pred_out[parent_flat]
        do = (sel_is_ext & valid_t).reshape(-1)
        new_pred, state = predictor_step(
            sel_tok.reshape(-1), state_gather(state, parent_flat),
            (~do).long())
        keep = do[:, None].to(par_pred.dtype)
        pred_out = new_pred * keep + par_pred * (1 - keep)

        # A finished utterance keeps its whole beam.
        tokens = torch.where(valid_t[..., None], new_tokens, tokens)
        lens = torch.where(valid_t, sel(cand_len), lens)
        scores = torch.where(valid_t, top_score, scores)
        h1 = torch.where(valid_t, sel(cand_h1), h1)
        h2 = torch.where(valid_t, sel(cand_h2), h2)

    order = torch.argsort(-scores, dim=1, stable=True)
    return {"tokens": torch.gather(tokens, 1,
                                   order[..., None].expand(-1, -1, u_max)),
            "lens": torch.gather(lens, 1, order),
            "scores": torch.gather(scores, 1, order)}
