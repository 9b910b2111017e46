"""WER/CER scoring with alignment on the host (copy of
``wenet_celoss_tpu/utils/wer.py``): the plain edit distance that the
hotword-gate sidecar of the recognize CLI scores with, the DP alignment
with backtrace, and the corpus WER calculator (char or word mode).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance (unit costs)."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        for j in range(1, m + 1):
            sub = prev[j - 1] + (ref[i - 1] != hyp[j - 1])
            cur[j] = min(sub, prev[j] + 1, cur[j - 1] + 1)
        prev = cur
    return prev[m]


@dataclass
class Alignment:
    ref: List[str]
    hyp: List[str]
    ops: List[str]  # 'cor' | 'sub' | 'ins' | 'del'
    n_cor: int = 0
    n_sub: int = 0
    n_ins: int = 0
    n_del: int = 0

    @property
    def errors(self) -> int:
        return self.n_sub + self.n_ins + self.n_del


def align(ref: Sequence[str], hyp: Sequence[str]) -> Alignment:
    """Full DP alignment with backtrace."""
    n, m = len(ref), len(hyp)
    dist = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        dist[i][0] = i
    for j in range(m + 1):
        dist[0][j] = j
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = dist[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1])
            dist[i][j] = min(sub, dist[i - 1][j] + 1, dist[i][j - 1] + 1)
    # Backtrace.
    ops: List[Tuple[str, str, str]] = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dist[i][j] == dist[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1]):
            ops.append(("cor" if ref[i - 1] == hyp[j - 1] else "sub",
                        ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and dist[i][j] == dist[i - 1][j] + 1:
            ops.append(("del", ref[i - 1], ""))
            i -= 1
        else:
            ops.append(("ins", "", hyp[j - 1]))
            j -= 1
    ops.reverse()
    out = Alignment(ref=[o[1] for o in ops], hyp=[o[2] for o in ops],
                    ops=[o[0] for o in ops])
    for o in out.ops:
        setattr(out, "n_" + o, getattr(out, "n_" + o) + 1)
    return out


def characterize(text: str) -> List[str]:
    """Split mixed CJK/Latin text: CJK chars as units, Latin runs as words
    (reference compute-wer.py characterize semantics, simplified)."""
    out: List[str] = []
    cur = ""
    for ch in text:
        if "一" <= ch <= "鿿" or "㐀" <= ch <= "䶿":
            if cur:
                out.append(cur)
                cur = ""
            out.append(ch)
        elif ch.isspace():
            if cur:
                out.append(cur)
                cur = ""
        else:
            cur += ch
    if cur:
        out.append(cur)
    return out


@dataclass
class WerStats:
    n_ref: int = 0
    n_cor: int = 0
    n_sub: int = 0
    n_ins: int = 0
    n_del: int = 0
    n_utt: int = 0
    n_utt_err: int = 0
    details: List[str] = field(default_factory=list)

    @property
    def wer(self) -> float:
        return 100.0 * (self.n_sub + self.n_ins + self.n_del) / max(self.n_ref, 1)

    @property
    def ser(self) -> float:
        return 100.0 * self.n_utt_err / max(self.n_utt, 1)

    def summary(self) -> str:
        return (f"WER {self.wer:.2f}% [N={self.n_ref} C={self.n_cor} "
                f"S={self.n_sub} I={self.n_ins} D={self.n_del}] "
                f"SER {self.ser:.2f}%")


def score(refs: Dict[str, str], hyps: Dict[str, str],
          char_mode: bool = False, case_sensitive: bool = False) -> WerStats:
    """Score hypothesis dict against reference dict keyed by utterance id."""
    stats = WerStats()
    for utt, ref_text in sorted(refs.items()):
        hyp_text = hyps.get(utt, "")
        if not case_sensitive:
            ref_text, hyp_text = ref_text.upper(), hyp_text.upper()
        ref = characterize(ref_text) if char_mode else ref_text.split()
        hyp = characterize(hyp_text) if char_mode else hyp_text.split()
        a = align(ref, hyp)
        stats.n_ref += len(ref)
        stats.n_cor += a.n_cor
        stats.n_sub += a.n_sub
        stats.n_ins += a.n_ins
        stats.n_del += a.n_del
        stats.n_utt += 1
        stats.n_utt_err += 1 if a.errors else 0
        stats.details.append(
            f"utt: {utt}\nREF: {' '.join(a.ref)}\nHYP: {' '.join(a.hyp)}\n"
            f"ERR: {a.errors}")
    return stats
