"""Decode-time hotword shortlist, the fork's ContextFilter (copy of
``wenet_celoss_tpu/decode/context_filter.py``, pure numpy):
1. ``posterior_phrase_scores``: each phrase's mean over its tokens of the
   per-token max posterior across time;
2. ``ContextFilter.second_filter``: sliding windows over the posterior
   (hop = window/4); per phrase a monotonic-alignment DP maximising the
   sum of its tokens' posteriors at increasing frames; the phrases whose
   best windowed score / length passes a threshold are kept.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def posterior_phrase_scores(posterior: np.ndarray, context_list: np.ndarray,
                            context_lengths: np.ndarray) -> np.ndarray:
    """[T, V] posterior, [N, L] phrases → [N] mean-of-max scores
    (entry 0 = no-bias sentinel gets -inf)."""
    n, l = context_list.shape
    scores = np.full((n,), -np.inf)
    if posterior.shape[0] == 0:
        return scores
    max_p = posterior.max(axis=0)                        # [V]
    for i in range(1, n):
        li = int(context_lengths[i])
        if li > 0:
            scores[i] = max_p[context_list[i, :li]].mean()
    return scores


def _window_dp(post_win: np.ndarray, phrase: np.ndarray) -> float:
    """Best monotonic alignment sum of phrase tokens over the window."""
    n = post_win.shape[0]
    m = len(phrase)
    if m > n:
        return -np.inf
    tok_post = post_win[:, phrase]                       # [n, m]
    dp = np.full((n, m), -np.inf)
    dp[0, 0] = tok_post[0, 0]
    for j in range(1, n):
        dp[j, 0] = max(dp[j - 1, 0], tok_post[j, 0])
    for k in range(1, m):
        for j in range(k, n):
            stay = dp[j - 1, k] if j > k else -np.inf
            adv = dp[j - 1, k - 1] + tok_post[j, k]
            dp[j, k] = max(adv, stay)
    return float(dp[-1, -1])


class ContextFilter:
    """Two-stage shortlist over a large hotword inventory."""

    def __init__(self, context_list: np.ndarray,
                 context_lengths: np.ndarray, window_size: int = 64,
                 topk_first: int = 50, topk_second: float = -3.0):
        self.context_list = np.asarray(context_list)
        self.context_lengths = np.asarray(context_lengths)
        self.window_size = window_size
        self.topk_first = topk_first
        self.topk_second = topk_second
        n = self.context_list.shape[0]
        self.context_score = np.full((n,), -np.inf)

    def posterior_filter(self, posterior: np.ndarray) -> None:
        """Accumulate first-stage scores over a posterior chunk [T, V]."""
        s = posterior_phrase_scores(posterior, self.context_list,
                                    self.context_lengths)
        self.context_score = np.maximum(self.context_score, s)

    def second_filter(self, posterior: np.ndarray
                      ) -> Tuple[List[np.ndarray], List[int]]:
        """Refine the top-k phrases with the windowed DP; returns the
        shortlist (with the no-bias sentinel first)."""
        n = self.context_list.shape[0]
        order = np.argsort(-self.context_score)
        topk = [int(i) for i in order[:min(self.topk_first, n)] if i != 0]
        topk_score = {i: -np.inf for i in topk}

        t = posterior.shape[0]
        w = self.window_size
        hop = max(w // 4, 1)
        start, end = 0, min(w, t)
        while True:
            win = posterior[start:end]
            for i in topk:
                m = int(self.context_lengths[i])
                if m == 0:
                    continue
                score = _window_dp(win, self.context_list[i, :m])
                topk_score[i] = max(topk_score[i], score / m)
            if end >= t:
                break
            start += hop
            end += hop
            if end > t:
                end = t
                start = max(end - w, 0)

        res_list = [self.context_list[0]]
        res_lengths = [1]
        for i, s in sorted(topk_score.items(), key=lambda kv: -kv[1]):
            if s < self.topk_second:
                break
            m = int(self.context_lengths[i])
            res_list.append(self.context_list[i, :m])
            res_lengths.append(m)
        return res_list, res_lengths
