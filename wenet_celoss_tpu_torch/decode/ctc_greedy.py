"""Batched CTC greedy search (port of
``wenet_celoss_tpu/decode/ctc_greedy.py``): per-frame argmax, pads forced
to blank, then the blank and repeat collapse on the host."""

from __future__ import annotations

from typing import List

import torch

from wenet_celoss_tpu_torch.utils.common import remove_duplicates_and_blank


def ctc_greedy_frames(ctc_log_probs: torch.Tensor,
                      enc_pad_mask: torch.Tensor,
                      blank: int = 0) -> torch.Tensor:
    """[B, T, V] log-probs → each frame's best id [B, T], pads at blank
    (the first of equal maxima, as ``jnp.argmax`` takes)."""
    ids = torch.argmax(ctc_log_probs, dim=-1)
    return torch.where(enc_pad_mask, ids, blank)


def ctc_greedy_search(ctc_log_probs: torch.Tensor, enc_pad_mask: torch.Tensor,
                      blank: int = 0) -> List[List[int]]:
    """Token lists per utterance."""
    ids = ctc_greedy_frames(ctc_log_probs, enc_pad_mask, blank)
    return [remove_duplicates_and_blank(row, blank)
            for row in ids.cpu().tolist()]
