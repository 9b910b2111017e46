"""ARPA n-gram language model: parser + backoff scorer + n-best rescoring
(copy of ``wenet_celoss_tpu/lm/arpa.py``; pure Python).

Covers the reference's LM capability (4-gram "fglarge" rescoring of n-best
lists, `BASELINE.md` LM rows; the reference routes LM through a WFST TLG
graph built by `tools/fst/*` + vendored kaldi `lm/arpa2fst`). Here the LM
applies directly to n-best hypotheses — the dominant use in the reference's
own results tables — with standard Katz backoff:

  p(w | h) = p*(w | h)                 if (h, w) listed
           = backoff(h) * p(w | h')    otherwise (h' = shorter history)
"""

from __future__ import annotations

import gzip
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class ArpaLM:
    def __init__(self, path: Optional[str] = None):
        # ngram tuple -> (log10 prob, log10 backoff)
        self.ngrams: Dict[Tuple[str, ...], Tuple[float, float]] = {}
        self.order = 0
        if path:
            self.load(path)

    def load(self, path: str) -> None:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf8", errors="replace") as f:
            section = 0
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("\\") and "-grams:" in line:
                    section = int(line[1:line.index("-")])
                    self.order = max(self.order, section)
                    continue
                if line.startswith("\\") or line.startswith("ngram "):
                    if line == "\\end\\":
                        break
                    continue
                if section == 0:
                    continue
                parts = line.split("\t")
                if len(parts) < 2:
                    parts = line.split()
                    if len(parts) < section + 1:
                        continue
                    logp = float(parts[0])
                    words = tuple(parts[1:1 + section])
                    backoff = (float(parts[1 + section])
                               if len(parts) > 1 + section else 0.0)
                else:
                    logp = float(parts[0])
                    words = tuple(parts[1].split())
                    backoff = float(parts[2]) if len(parts) > 2 else 0.0
                self.ngrams[words] = (logp, backoff)

    def _raw(self, words: Tuple[str, ...]):
        return self.ngrams.get(words)

    def log10_prob(self, word: str, history: Sequence[str]) -> float:
        """Backoff log10 p(word | history)."""
        hist = tuple(history)[-(self.order - 1):] if self.order > 1 else ()
        return self._score(hist, word)

    def _score(self, hist: Tuple[str, ...], word: str) -> float:
        entry = self._raw(hist + (word,))
        if entry is not None:
            return entry[0]
        if not hist:
            unk = self._raw(("<unk>",))
            return unk[0] if unk else -10.0
        bo = self._raw(hist)
        backoff = bo[1] if bo else 0.0
        return backoff + self._score(hist[1:], word)

    def sentence_log10(self, words: Sequence[str], bos: bool = True,
                       eos: bool = True) -> float:
        """Sum of log10 p over the sentence with <s>/<\\s> handling."""
        hist: List[str] = ["<s>"] if bos else []
        total = 0.0
        for w in words:
            total += self.log10_prob(w, hist)
            hist.append(w)
        if eos:
            total += self.log10_prob("</s>", hist)
        return total

    def sentence_loge(self, words: Sequence[str], **kw) -> float:
        return self.sentence_log10(words, **kw) * math.log(10.0)


def lm_rescore_nbest(lm: ArpaLM, nbest_texts: List[List[str]],
                     am_scores: Sequence[float], lm_weight: float = 0.5
                     ) -> List[float]:
    """Combine acoustic scores with LM scores (natural log domain)."""
    out = []
    for text_words, am in zip(nbest_texts, am_scores):
        out.append(float(am) + lm_weight * lm.sentence_loge(text_words))
    return out
