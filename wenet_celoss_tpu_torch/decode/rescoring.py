"""Attention rescoring of CTC prefix-beam n-best lists (port of
``wenet_celoss_tpu/decode/rescoring.py``): the attention decoder,
teacher-forced over every hypothesis of the [B, N] n-best at once as
[B·N] rows (left-to-right and, for U2++, right-to-left), re-ranks them
by ``att (+ reverse) + ctc_weight * ctc_score``."""

from __future__ import annotations

from typing import Callable

import torch

from wenet_celoss_tpu_torch.utils.common import (IGNORE_ID, add_sos_eos,
                                                 reverse_pad_list)


def score_hyps_with_decoder(decoder_scores_fn: Callable, encoder_out,
                            enc_pad_mask, hyp_tokens, hyp_lens, sos: int,
                            eos: int, reverse_weight: float = 0.0):
    """Attention scores of hypothesis lists.

    decoder_scores_fn: (memory, memory_pad_mask, hyps_in, hyps_lens,
    r_hyps_in, reverse_weight) → (left, right) log-probs, each
    [B·N, U+1, V]. encoder_out [B, T, D]; hyp_tokens [B, N, U]; hyp_lens
    [B, N]. Returns att_scores [B, N], reverse-blended."""
    b, n, u = hyp_tokens.shape
    flat = hyp_tokens.reshape(b * n, u)
    flat_lens = hyp_lens.reshape(b * n)
    memory = encoder_out.repeat_interleave(n, dim=0)
    memory_mask = enc_pad_mask.repeat_interleave(n, dim=0)
    valid = (torch.arange(u, device=flat.device)[None, :]
             < flat_lens[:, None])
    toks = torch.where(valid, flat, IGNORE_ID)
    hyps_in, hyps_out = add_sos_eos(toks, flat_lens, sos, eos, IGNORE_ID)
    r_toks = reverse_pad_list(toks, flat_lens, float(IGNORE_ID))
    r_hyps_in, r_hyps_out = add_sos_eos(r_toks.to(toks.dtype), flat_lens,
                                        sos, eos, IGNORE_ID)
    l_logp, r_logp = decoder_scores_fn(memory, memory_mask, hyps_in,
                                       flat_lens + 1, r_hyps_in,
                                       reverse_weight)

    def seq_score(logp, targets):
        picked = torch.gather(logp, -1,
                              targets.clamp_min(0)[..., None])[..., 0]
        return torch.where(targets != IGNORE_ID, picked, 0.0).sum(dim=-1)

    score = seq_score(l_logp, hyps_out)
    if reverse_weight > 0.0:
        score = ((1.0 - reverse_weight) * score
                 + reverse_weight * seq_score(r_logp, r_hyps_out))
    return score.reshape(b, n)


def pick_best(total, tokens, lens):
    """The hypothesis of highest ``total`` [B, N] (the first on a tie) →
    (tokens [B, U], lens [B])."""
    best = torch.argmax(total, dim=1)
    rows = torch.arange(total.shape[0], device=total.device)
    return tokens[rows, best], lens[rows, best]


def attention_rescoring(decoder_scores_fn: Callable, encoder_out,
                        enc_pad_mask, nbest: dict, sos: int, eos: int,
                        ctc_weight: float = 0.0,
                        reverse_weight: float = 0.0):
    """Re-rank a ctc_prefix_beam_search result → (best_tokens [B, U],
    best_lens [B], total_scores [B, N])."""
    att = score_hyps_with_decoder(
        decoder_scores_fn, encoder_out, enc_pad_mask, nbest["tokens"],
        nbest["lens"], sos, eos, reverse_weight)
    total = att + ctc_weight * nbest["scores"]
    best_tokens, best_lens = pick_best(total, nbest["tokens"], nbest["lens"])
    return best_tokens, best_lens, total
