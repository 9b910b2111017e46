"""Hotword lists and per-token hotword labels for batches (the port of
``wenet_celoss_tpu/data/processor.py``: ``context_generate`` in each
context mode with the rolling global list ``ContextMaintainer``,
``hw_label_generate`` with binary or per-phrase labels, and the context
keys of its ``padding`` step). Pure Python and numpy."""

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


class ContextMaintainer:
    """The rolling global hotword list of context mode 1: the newest
    ``list_size`` phrases."""

    def __init__(self, list_size: int = 30):
        self.list_size = list_size
        self.items: List[List[int]] = []

    def add(self, add_list: List[List[int]]) -> List[List[int]]:
        self.items.extend(add_list)
        if len(self.items) > self.list_size:
            self.items = self.items[len(self.items) - self.list_size:]
        return self.items


def batch_context_list(labels: List[List[int]], context_mode: int,
                       bpe_start_ids: Optional[set] = None,
                       file_list: Optional[List[List[int]]] = None,
                       dict_entry: Optional[List[List[int]]] = None,
                       context_len_min: int = 1, context_len_max: int = 4,
                       maintainer: Optional[ContextMaintainer] = None,
                       rng: Optional[random.Random] = None):
    """A batch's hotword list in each context mode: 0 none (None); 1
    spans sampled from the labels (:func:`context_generate`), rolled
    through ``maintainer`` and read newest first when one is given; 2 and
    3 the file's list; 4 the utterance's dict entry. Entry 0 is always
    the "no hotword" phrase [0]."""
    if context_mode == 0:
        return None
    if context_mode in (2, 3):
        return [[0]] + [list(x) for x in (file_list or [])]
    if context_mode == 4:
        return [[0]] + [list(x) for x in (dict_entry or [])]
    if context_mode != 1:
        raise ValueError(f"unknown context_mode {context_mode}")
    if bpe_start_ids is None:
        raise ValueError("context mode 1 needs bpe_start_ids")
    sampled = context_generate(labels, bpe_start_ids, context_len_min,
                               context_len_max, rng)[1:]
    if maintainer is not None:
        sampled = list(maintainer.add(sampled))[::-1]
    return [[0]] + sampled


def hw_label_generate(labels: List[List[int]],
                      context_list: List[List[int]],
                      num_labels: int = 2) -> List[List[int]]:
    """Per-token hotword labels: where a phrase of the list (past entry
    0) matches the labels, the first match at each position winning, 1
    (``num_labels`` 2) or the phrase's index in the list; else 0."""
    hw_labels = []
    for y in labels:
        n = len(y)
        hw = [0] * n
        for i in range(n):
            for j, phrase in enumerate(context_list[1:], 1):
                length = len(phrase)
                if i + length <= n and list(y[i:i + length]) == list(phrase):
                    hw[i:i + length] = [1 if num_labels == 2 else j] * length
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
