"""Hotword lists and per-token hotword labels for training batches (the
port of ``wenet_celoss_tpu/data/processor.py``: ``context_generate`` in
its sampling mode 1, ``hw_label_generate`` with binary labels, and the
context keys of its ``padding`` step). Pure Python and numpy. The other
context modes, the rolling global list and per-phrase labels come with
the data pipeline (``ROADMAP.md``)."""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np

IGNORE_ID = -1


def context_generate(labels: List[List[int]], bpe_start_ids: set,
                     context_len_min: int = 1, context_len_max: int = 4,
                     rng: Optional[random.Random] = None):
    """The batch's hotword list: up to 3 non-overlapping spans of
    ``context_len_min``-``context_len_max`` words per utterance, sampled
    from its labels (a word starts at a token in ``bpe_start_ids``).
    Entry 0 is always the "no hotword" phrase [0]."""
    rng = rng or random
    context_list: List[List[int]] = []
    for y in labels:
        starts = [i for i, t in enumerate(y) if t in bpe_start_ids]
        word_num = len(starts)
        if word_num == 0:
            continue
        starts.append(len(y))
        spans: List[tuple] = []
        for _ in range(3):
            rand_len = rng.randint(min(word_num, context_len_min),
                                   min(word_num, context_len_max))
            if len(starts) - rand_len - 1 <= 0:
                continue
            ridx = rng.randint(0, len(starts) - rand_len - 1)
            st, en = starts[ridx], starts[ridx + rand_len]
            if any(not (en <= s or st >= e) for s, e in spans):
                continue
            spans.append((st, en))
            context_list.append(list(y[st:en]))
    return [[0]] + context_list


def hw_label_generate(labels: List[List[int]],
                      context_list: List[List[int]]) -> List[List[int]]:
    """Per-token hotword labels: 1 where a phrase of the list (past entry
    0) matches the labels, the first match at each position winning,
    else 0."""
    hw_labels = []
    for y in labels:
        n = len(y)
        hw = [0] * n
        for i in range(n):
            for phrase in context_list[1:]:
                length = len(phrase)
                if i + length <= n and list(y[i:i + length]) == list(phrase):
                    hw[i:i + length] = [1] * length
                    break
        hw_labels.append(hw)
    return hw_labels


def context_batch(labels: List[List[int]], context_list: List[List[int]],
                  max_phrases: int = 0) -> Dict[str, np.ndarray]:
    """The batch keys of the JAX package's padding step: context_list
    [N, L] (ignore_id padded; N = ``max_phrases`` or the list's length),
    context_lengths [N], context_n_valid, hw_labels [B, U] (ignore_id
    padded)."""
    hw = hw_label_generate(labels, context_list)
    n_max = max_phrases or len(context_list)
    ctx = context_list[:n_max]
    l_max = max(max(len(p) for p in ctx), 1)
    ctx_pad = np.full((n_max, l_max), IGNORE_ID, np.int64)
    ctx_lens = np.zeros((n_max,), np.int64)
    for i, p in enumerate(ctx):
        ctx_pad[i, :len(p)] = p
        ctx_lens[i] = len(p)
    u_max = max((len(y) for y in labels), default=0)
    hw_pad = np.full((len(labels), u_max), IGNORE_ID, np.int64)
    for i, h in enumerate(hw):
        hw_pad[i, :len(h)] = h
    return {"context_list": ctx_pad, "context_lengths": ctx_lens,
            "context_n_valid": np.int64(len(ctx)), "hw_labels": hw_pad}
