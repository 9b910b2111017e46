"""Batched attention-decoder beam search (port of
``wenet_celoss_tpu/decode/attention_beam.py``): [B, N] hypotheses kept as
flat [B·N] rows of a fixed-size token buffer, two top-k's a step, an
ended hypothesis extended by eos at no cost. The JAX package's
``lax.scan`` over ``max_len`` steps is a Python loop over the same steps;
every top-k orders ties by index, as ``jax.lax.top_k`` does."""

from __future__ import annotations

from typing import Callable, List

import torch

from wenet_celoss_tpu_torch.utils.common import LOG_ZERO, stable_topk


def attention_beam_search(one_step: Callable, encoder_out, enc_pad_mask,
                          sos: int, eos: int, beam: int, max_len: int):
    """Run the search.

    one_step: (memory [B·N, T, D], memory_pad_mask [B·N, T], ys_buffer
    [B·N, L], pos) → log-probs [B·N, V]. encoder_out [B, T, D];
    enc_pad_mask [B, T]. Returns (hyps [B, N, max_len] without sos, lens
    [B, N], scores [B, N]), best first."""
    b = encoder_out.shape[0]
    n = beam
    dev = encoder_out.device
    memory = encoder_out.repeat_interleave(n, dim=0)
    memory_mask = enc_pad_mask.repeat_interleave(n, dim=0)
    buf = torch.full((b * n, max_len + 1), eos, dtype=torch.long, device=dev)
    buf[:, 0] = sos
    scores = torch.full((b, n), LOG_ZERO, device=dev)
    scores[:, 0] = 0.0
    scores = scores.reshape(-1)
    end_flag = torch.zeros((b * n,), dtype=torch.bool, device=dev)
    rows = (torch.arange(b, device=dev) * n)[:, None]
    eos_only = None
    for pos in range(max_len):
        logp = one_step(memory, memory_mask, buf, pos)          # [B·N, V]
        if eos_only is None:
            eos_only = torch.full((logp.shape[-1],), LOG_ZERO, device=dev)
            eos_only[eos] = 0.0
        # An ended hypothesis emits eos alone, with no score change.
        logp = torch.where(end_flag[:, None], eos_only[None, :], logp)
        top_lp, top_tok = stable_topk(logp, n)                  # [B·N, N]
        cand = (scores[:, None] + top_lp).reshape(b, n * n)
        best, best_idx = stable_topk(cand, n)                   # [B, N]
        parent_flat = (rows + best_idx // n).reshape(-1)
        tok = torch.gather(top_tok[parent_flat], 1,
                           (best_idx % n).reshape(-1, 1))[:, 0]
        ended = end_flag[parent_flat]
        buf = buf[parent_flat]
        buf[:, pos + 1] = torch.where(ended, eos, tok)
        end_flag = ended | (tok == eos)
        scores = best.reshape(-1)

    hyps = buf[:, 1:].reshape(b, n, max_len)
    scores = scores.reshape(b, n)
    is_eos = hyps == eos
    lens = torch.where(is_eos.any(dim=-1),
                       is_eos.to(torch.uint8).argmax(dim=-1), max_len)
    order = torch.argsort(-scores, dim=1, stable=True)
    hyps = torch.gather(hyps, 1, order[..., None].expand(-1, -1, max_len))
    return (hyps, torch.gather(lens, 1, order),
            torch.gather(scores, 1, order))


def attention_hyps_to_lists(hyps, lens, eos: int) -> List[List[int]]:
    """The best hypothesis of each utterance as a token list."""
    hyps = hyps[:, 0].cpu().tolist()
    lens = lens[:, 0].cpu().tolist()
    return [row[:ln] for row, ln in zip(hyps, lens)]
