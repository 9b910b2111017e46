"""From-scratch sentencepiece-unigram trainer (a copy of
``wenet_celoss_tpu/data/spm_train.py``; pure Python).

The reference wraps `sentencepiece.SentencePieceTrainer` (`tools/spm_train`,
recipe stage 2 of `examples/librispeech/s0/run.sh`); that library is not a
dependency here, so this module implements the unigram-LM training algorithm
(Kudo 2018, arXiv:1804.10959) directly and serializes the result in the
sentencepiece ModelProto wire format that
:mod:`wenet_celoss_tpu_torch.data.tokenizer` already parses — trained models are
interchangeable with real `.model` files for inference.

Algorithm:
  1. corpus → word counts (whitespace pre-tokenization, each word prefixed
     with the ``▁`` boundary marker — pieces never cross word boundaries,
     matching sentencepiece's ``split_by_whitespace=true`` default).
  2. seed vocabulary: frequent substrings scored by count·len, capped at
     ``seed_size``; all single characters are always kept.
  3. EM over the per-word segmentation lattices: the E-step computes
     expected piece counts via forward-backward in log space; the M-step
     re-normalizes piece log-probabilities.
  4. prune: each removable piece is scored by the likelihood loss its
     removal would cause (freq · (logp(piece) − logp(best alternative
     segmentation))); the worst ``1 − shrink_factor`` fraction is dropped;
     repeat EM+prune until ``vocab_size`` is reached.
  5. serialize ``<unk>/<s>/</s>`` control pieces + normal pieces with their
     final log-prob scores.
"""

from __future__ import annotations

import math
import struct
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Tuple

LOG_ZERO = -1e30


def _log_add(a: float, b: float) -> float:
    if a < b:
        a, b = b, a
    if b <= LOG_ZERO:
        return a
    return a + math.log1p(math.exp(b - a))


def word_counts(lines: Iterable[str]) -> Dict[str, int]:
    counts: Counter = Counter()
    for line in lines:
        for w in line.split():
            counts["▁" + w] += 1
    return dict(counts)


def seed_vocab(counts: Dict[str, int], seed_size: int,
               max_piece_len: int = 16) -> Dict[str, float]:
    """Candidate pieces scored by count·len; single chars always included."""
    sub_counts: Counter = Counter()
    char_counts: Counter = Counter()
    for word, c in counts.items():
        n = len(word)
        for ch in word:
            char_counts[ch] += c
        for i in range(n):
            for j in range(i + 2, min(i + max_piece_len, n) + 1):
                sub_counts[word[i:j]] += c
    # Multi-char candidates ranked by count·len (the sentencepiece seed
    # heuristic: longer frequent substrings are better compression).
    ranked = sorted(sub_counts.items(), key=lambda kv: -kv[1] * len(kv[0]))
    pieces: Dict[str, float] = {}
    for ch, c in char_counts.items():
        pieces[ch] = float(c)
    budget = max(seed_size - len(pieces), 0)
    for piece, c in ranked[:budget]:
        pieces[piece] = float(c * len(piece))
    # counts → initial log-probs
    total = sum(pieces.values())
    return {p: math.log(v / total) for p, v in pieces.items()}


def _lattice_edges(word: str, pieces: Dict[str, float],
                   max_len: int) -> List[List[Tuple[int, str, float]]]:
    """edges[j] = [(i, piece, score)] for pieces spanning s[i:j]."""
    n = len(word)
    edges: List[List[Tuple[int, str, float]]] = [[] for _ in range(n + 1)]
    for i in range(n):
        for j in range(i + 1, min(i + max_len, n) + 1):
            sc = pieces.get(word[i:j])
            if sc is not None:
                edges[j].append((i, word[i:j], sc))
    return edges


def _forward_backward(word: str, edges, n: int):
    alpha = [LOG_ZERO] * (n + 1)
    alpha[0] = 0.0
    for j in range(1, n + 1):
        a = LOG_ZERO
        for i, _, sc in edges[j]:
            if alpha[i] > LOG_ZERO:
                a = _log_add(a, alpha[i] + sc)
        alpha[j] = a
    beta = [LOG_ZERO] * (n + 1)
    beta[n] = 0.0
    for j in range(n, 0, -1):
        if beta[j] <= LOG_ZERO:
            continue
        for i, _, sc in edges[j]:
            b = beta[j] + sc
            if beta[i] < b or beta[i] <= LOG_ZERO:
                beta[i] = _log_add(beta[i], b)
    return alpha, beta


def _viterbi_logp(word: str, pieces: Dict[str, float],
                  max_len: int) -> float:
    n = len(word)
    best = [LOG_ZERO] * (n + 1)
    best[0] = 0.0
    for j in range(1, n + 1):
        for i in range(max(0, j - max_len), j):
            if best[i] <= LOG_ZERO:
                continue
            sc = pieces.get(word[i:j])
            if sc is not None and best[i] + sc > best[j]:
                best[j] = best[i] + sc
    return best[n]


def em_step(counts: Dict[str, int],
            pieces: Dict[str, float]) -> Tuple[Dict[str, float], float]:
    """One E+M step; returns (new log-probs, corpus log-likelihood)."""
    max_len = max(len(p) for p in pieces)
    expected: defaultdict = defaultdict(float)
    loglik = 0.0
    for word, c in counts.items():
        n = len(word)
        edges = _lattice_edges(word, pieces, max_len)
        alpha, beta = _forward_backward(word, edges, n)
        z = alpha[n]
        if z <= LOG_ZERO:  # unsegmentable (shouldn't happen: chars kept)
            continue
        loglik += c * z
        for j in range(1, n + 1):
            for i, piece, sc in edges[j]:
                if alpha[i] > LOG_ZERO and beta[j] > LOG_ZERO:
                    expected[piece] += c * math.exp(alpha[i] + sc
                                                    + beta[j] - z)
    log_total = math.log(sum(expected.values()))
    new = {}
    for p in pieces:
        e = expected.get(p, 0.0)
        new[p] = math.log(e) - log_total if e > 0 else LOG_ZERO
    return new, loglik


def prune_step(counts: Dict[str, int], pieces: Dict[str, float],
               target: int, shrink_factor: float = 0.75) -> Dict[str, float]:
    """Drop the least-useful removable pieces (likelihood-loss ranking)."""
    max_len = max(len(p) for p in pieces)
    # Piece frequencies under Viterbi segmentation of the corpus.
    freq: defaultdict = defaultdict(float)
    for word, c in counts.items():
        n = len(word)
        best = [LOG_ZERO] * (n + 1)
        back: List[Tuple[int, str]] = [(-1, "")] * (n + 1)
        best[0] = 0.0
        for j in range(1, n + 1):
            for i in range(max(0, j - max_len), j):
                if best[i] <= LOG_ZERO:
                    continue
                sc = pieces.get(word[i:j])
                if sc is not None and best[i] + sc > best[j]:
                    best[j] = best[i] + sc
                    back[j] = (i, word[i:j])
        j = n
        while j > 0:
            i, piece = back[j]
            if i < 0:
                break
            freq[piece] += c
            j = i
    removable = [p for p in pieces if len(p) > 1]
    losses = []
    for p in removable:
        f = freq.get(p, 0.0)
        if f == 0.0:
            losses.append((0.0, p))
            continue
        # Best alternative segmentation of the piece without itself.
        others = dict(pieces)
        del others[p]
        alt = _viterbi_logp(p, others, max_len)
        losses.append((f * (pieces[p] - alt), p))
    losses.sort(key=lambda t: t[0])
    n_chars = len(pieces) - len(removable)
    keep_n = max(target - n_chars,
                 int(len(removable) * shrink_factor))
    drop = {p for _, p in losses[:max(len(removable) - keep_n, 0)]}
    return {p: s for p, s in pieces.items() if p not in drop}


def train_unigram(lines: Iterable[str], vocab_size: int,
                  seed_size: int = 0, num_sub_iters: int = 2,
                  max_piece_len: int = 16,
                  character_coverage: float = 1.0,
                  verbose: bool = False) -> List[Tuple[str, float]]:
    """Train; returns ordered [(piece, score)] WITHOUT control symbols.

    ``vocab_size`` counts the 3 control pieces (<unk>, <s>, </s>) the model
    file will carry, matching sentencepiece's accounting.
    """
    counts = word_counts(lines)
    if not counts:
        raise ValueError("empty corpus")
    n_normal = vocab_size - 3
    if seed_size <= 0:
        seed_size = max(n_normal * 4, 1000)
    pieces = seed_vocab(counts, seed_size, max_piece_len)
    if character_coverage < 1.0:
        # Drop the rarest chars beyond the coverage budget (they fall back
        # to <unk>/byte pieces in real spm; here simply to unknown-char).
        char_freq = Counter()
        for w, c in counts.items():
            for ch in w:
                char_freq[ch] += c
        total = sum(char_freq.values())
        keep, acc = set(), 0
        for ch, c in char_freq.most_common():
            keep.add(ch)
            acc += c
            if acc / total >= character_coverage:
                break
        pieces = {p: s for p, s in pieces.items()
                  if len(p) > 1 or p in keep}
    n_chars = sum(1 for p in pieces if len(p) == 1)
    if n_normal < n_chars:
        raise ValueError(
            f"vocab_size {vocab_size} < required character pieces "
            f"{n_chars} + 3 control symbols")

    while True:
        for _ in range(num_sub_iters):
            pieces, ll = em_step(counts, pieces)
            pieces = {p: s for p, s in pieces.items()
                      if s > LOG_ZERO or len(p) == 1}
            if verbose:
                print(f"EM: {len(pieces)} pieces, loglik={ll:.1f}")
        if len(pieces) <= n_normal:
            break
        pieces = prune_step(counts, pieces, n_normal)
        if verbose:
            print(f"prune → {len(pieces)} pieces")
    # Final EM polish + re-normalize.
    pieces, _ = em_step(counts, pieces)
    floor = min((s for s in pieces.values() if s > LOG_ZERO),
                default=-20.0) - 5.0
    out = [(p, s if s > LOG_ZERO else floor) for p, s in pieces.items()]
    out.sort(key=lambda t: -t[1])
    return out[:n_normal]


# ---------------------------------------------------------------------------
# ModelProto serialization (inverse of tokenizer.parse_sentencepiece_model).
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _sentence_piece(piece: str, score: float, ptype: int) -> bytes:
    body = bytearray()
    pb = piece.encode("utf-8")
    body += b"\x0a" + _varint(len(pb)) + pb          # field 1, wire 2
    body += b"\x15" + struct.pack("<f", score)       # field 2, wire 5
    if ptype != 1:
        body += b"\x18" + _varint(ptype)             # field 3, wire 0
    return b"\x0a" + _varint(len(body)) + bytes(body)


def write_model(path: str, pieces: List[Tuple[str, float]]) -> None:
    """Write ModelProto: <unk> (type 2), <s> and </s> (type 3), then
    normal pieces — the standard sentencepiece id layout."""
    blob = bytearray()
    blob += _sentence_piece("<unk>", 0.0, 2)
    blob += _sentence_piece("<s>", 0.0, 3)
    blob += _sentence_piece("</s>", 0.0, 3)
    for p, s in pieces:
        blob += _sentence_piece(p, s, 1)
    with open(path, "wb") as f:
        f.write(bytes(blob))


def write_vocab(path: str, pieces: List[Tuple[str, float]]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write("<unk>\t0\n<s>\t0\n</s>\t0\n")
        for p, s in pieces:
            f.write(f"{p}\t{s:.6g}\n")
