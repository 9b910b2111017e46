"""WFST (LG) decoding graph: lexicon trie ∘ n-gram backoff automaton
(copy of ``wenet_celoss_tpu/lm/fst.py``; pure Python, plus torch tensors
as ``wfst_beam_decode``'s input).

Covers the reference's TLG capability (`tools/fst/make_tlg.sh` +
`runtime/core/decoder/ctc_wfst_beam_search.cc` over vendored kaldi
`lattice-faster-online-decoder`). Design differences:

- No openfst / static TLG composition. L (lexicon) is kept as a unit trie
  and G (LM) as a deterministic backoff automaton with *failure* semantics;
  the decoder composes them on the fly, so graph memory is |L| + |G| rather
  than |L x G| and LM backoff weights are applied exactly.
- The CTC topology "T" is not a graph at all: the decoder tracks the last
  emitted unit per token, which realizes blank/repeat semantics directly
  (reference builds T into TLG, `tools/fst/ctc_token_fst.py`).
- Word-final lexicon arcs return to the trie root and carry the word output
  (kaldi-L style olabel placement: reference `tools/fst/prepare_dict.py` +
  `compile_lexicon_token_fst.sh`).

The binary format (`lg.bin`) is shared with the C++ runtime decoder
(`runtime/core/decoder/wfst_beam_search.{h,cc}`); this module is the
graph's writer and the numpy reference decoder used for parity tests.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .arpa import ArpaLM

LOG10 = math.log(10.0)
NO_WORD = 0  # olabel 0 == epsilon (no word emitted on this arc)


# ---------------------------------------------------------------------------
# Lexicon trie (L)
# ---------------------------------------------------------------------------

class LexiconTrie:
    """Unit-labelled trie; word-final arcs go back to the root with the
    word id as output label."""

    def __init__(self):
        # arcs[node] = list of (unit_id, word_id, next_node); word_id ==
        # NO_WORD for interior arcs.
        self.arcs: List[List[Tuple[int, int, int]]] = [[]]

    @property
    def num_nodes(self) -> int:
        return len(self.arcs)

    def add_word(self, units: Sequence[int], word_id: int) -> None:
        if not units:
            return
        node = 0
        for u in units[:-1]:
            nxt = None
            for (au, aw, an) in self.arcs[node]:
                if au == u and aw == NO_WORD:
                    nxt = an
                    break
            if nxt is None:
                nxt = len(self.arcs)
                self.arcs.append([])
                self.arcs[node].append((u, NO_WORD, nxt))
            node = nxt
        # Final arc: unique per word, olabel = word, back to root.
        final = (units[-1], word_id, 0)
        if final not in self.arcs[node]:
            self.arcs[node].append(final)


# ---------------------------------------------------------------------------
# N-gram backoff automaton (G)
# ---------------------------------------------------------------------------

class NgramGraph:
    """Deterministic word automaton with failure-style backoff.

    States are LM histories. Word arcs carry -ln p; each state has a backoff
    (cost, state). Matches arpa2fst semantics (reference vendors kaldi
    `lm/arpa-lm-compiler.cc`) except backoff arcs are failure transitions
    (taken only when no explicit arc exists), which scores exactly like the
    source ARPA model.
    """

    def __init__(self):
        self.arcs: List[Dict[int, Tuple[float, int]]] = []  # word -> (cost, next)
        self.backoff: List[Tuple[float, int]] = []          # (cost, state)
        self.final: List[float] = []                        # -ln p(</s> | h)
        self.start = 0

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @classmethod
    def from_arpa(cls, lm: ArpaLM, word2id: Dict[str, int]) -> "NgramGraph":
        g = cls()
        order = max(lm.order, 1)

        # States: every history (len < order) that is a context of some
        # n-gram or carries a backoff weight, plus the empty history.
        state_ids: Dict[Tuple[str, ...], int] = {}

        def ensure_state(hist: Tuple[str, ...]) -> int:
            if hist not in state_ids:
                state_ids[hist] = len(state_ids)
            return state_ids[hist]

        ensure_state(())
        for ngram in lm.ngrams:
            if len(ngram) < order:
                ensure_state(ngram)         # potential context state
            if len(ngram) > 1:
                ensure_state(ngram[:-1])    # context of this ngram

        def suffix_state(hist: Tuple[str, ...]) -> int:
            h = hist[-(order - 1):] if order > 1 else ()
            while h and h not in state_ids:
                h = h[1:]
            return state_ids[h] if h else state_ids[()]

        n = len(state_ids)
        g.arcs = [dict() for _ in range(n)]
        g.backoff = [(0.0, state_ids[()])] * n
        g.final = [math.inf] * n

        for ngram, (logp, bow) in lm.ngrams.items():
            word = ngram[-1]
            hist = ngram[:-1]
            if hist not in state_ids:
                continue  # unreachable context (pruned LM hole)
            s = state_ids[hist]
            if word == "</s>":
                g.final[s] = -logp * LOG10
                continue
            if word == "<s>":
                # <s> is never consumed as a word; its "arc" only defines
                # the start state, handled below.
                continue
            wid = word2id.get(word)
            if len(ngram) < order and ngram in state_ids:
                nxt = state_ids[ngram]
            else:
                nxt = suffix_state(ngram)
            if wid is not None and wid != NO_WORD:
                g.arcs[s][wid] = (-logp * LOG10, nxt)

        for hist, sid in state_ids.items():
            if not hist:
                continue
            entry = lm.ngrams.get(hist)
            bow = entry[1] if entry else 0.0
            g.backoff[sid] = (-bow * LOG10, suffix_state(hist[1:]) if len(hist) > 1 else state_ids[()])

        # Fill finals through the backoff chain so the decoder can read a
        # single array (costs already include the backoff weights walked).
        unigram = state_ids[()]
        if math.isinf(g.final[unigram]):
            g.final[unigram] = 0.0  # LM without </s>: free sentence end
        for hist, sid in sorted(state_ids.items(), key=lambda kv: -len(kv[0])):
            if math.isinf(g.final[sid]):
                bcost, bstate = g.backoff[sid]
                g.final[sid] = bcost + g.final[bstate]

        start_hist = ("<s>",)
        g.start = state_ids.get(start_hist, unigram)
        return g

    def advance(self, state: int, word_id: int) -> Tuple[float, int]:
        """Failure-semantics advance: (cost, next_state)."""
        cost = 0.0
        s = state
        while True:
            hit = self.arcs[s].get(word_id)
            if hit is not None:
                return cost + hit[0], hit[1]
            bcost, bstate = self.backoff[s]
            if bstate == s:  # at unigram state and word unknown
                return math.inf, s
            cost += bcost
            s = bstate


# ---------------------------------------------------------------------------
# LG container + serialization
# ---------------------------------------------------------------------------

MAGIC = 0x57_4C_47_32  # "WLG2"


@dataclass
class LgGraph:
    trie: LexiconTrie
    ngram: NgramGraph
    words: List[str]  # id -> word, words[0] == "<eps>"
    num_units: int = 0

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            w = f.write
            w(struct.pack("<IIII", MAGIC, self.num_units, len(self.words),
                          self.trie.num_nodes))
            l_offsets = [0]
            flat = []
            for arcs in self.trie.arcs:
                flat.extend(arcs)
                l_offsets.append(len(flat))
            w(struct.pack("<I", len(flat)))
            w(struct.pack("<%dI" % len(l_offsets), *l_offsets))
            for (u, wd, nxt) in flat:
                w(struct.pack("<III", u, wd, nxt))

            g = self.ngram
            g_flat: List[Tuple[int, int, float]] = []
            g_offsets = [0]
            for arcs in g.arcs:
                for wid in sorted(arcs):
                    cost, nxt = arcs[wid]
                    g_flat.append((wid, nxt, cost))
                g_offsets.append(len(g_flat))
            w(struct.pack("<III", g.num_states, g.start, len(g_flat)))
            w(struct.pack("<%dI" % len(g_offsets), *g_offsets))
            for (wid, nxt, cost) in g_flat:
                w(struct.pack("<IIf", wid, nxt, cost))
            for (cost, state) in g.backoff:
                w(struct.pack("<If", state, cost))
            finals = [c if math.isfinite(c) else 3.0e38 for c in g.final]
            w(struct.pack("<%df" % len(finals), *finals))
            blob = "\n".join(self.words).encode("utf8")
            w(struct.pack("<I", len(blob)))
            w(blob)

    @classmethod
    def read(cls, path: str) -> "LgGraph":
        with open(path, "rb") as f:
            data = f.read()
        off = 0

        def rd(fmt):
            nonlocal off
            vals = struct.unpack_from(fmt, data, off)
            off += struct.calcsize(fmt)
            return vals

        magic, num_units, num_words, num_nodes = rd("<IIII")
        if magic != MAGIC:
            raise ValueError("bad LG magic")
        (num_l_arcs,) = rd("<I")
        l_offsets = rd("<%dI" % (num_nodes + 1))
        trie = LexiconTrie()
        trie.arcs = [[] for _ in range(num_nodes)]
        flat = [rd("<III") for _ in range(num_l_arcs)]
        for node in range(num_nodes):
            trie.arcs[node] = [flat[i] for i in
                               range(l_offsets[node], l_offsets[node + 1])]
        num_g, g_start, num_g_arcs = rd("<III")
        g_offsets = rd("<%dI" % (num_g + 1))
        g_flat = [rd("<IIf") for _ in range(num_g_arcs)]
        ng = NgramGraph()
        ng.start = g_start
        ng.arcs = [dict() for _ in range(num_g)]
        for s in range(num_g):
            for i in range(g_offsets[s], g_offsets[s + 1]):
                wid, nxt, cost = g_flat[i]
                ng.arcs[s][wid] = (cost, nxt)
        ng.backoff = []
        for _ in range(num_g):
            state, cost = rd("<If")
            ng.backoff.append((cost, state))
        ng.final = list(rd("<%df" % num_g))
        (blob_len,) = rd("<I")
        words = data[off:off + blob_len].decode("utf8").split("\n") \
            if blob_len else []
        return cls(trie=trie, ngram=ng, words=words, num_units=num_units)


def build_lg(lexicon: Sequence[Tuple[str, Sequence[int]]], arpa: ArpaLM,
             num_units: int) -> LgGraph:
    """lexicon: [(word, [unit ids])]; words deduplicated in order."""
    words: List[str] = ["<eps>"]
    word2id: Dict[str, int] = {}
    for w, _ in lexicon:
        if w not in word2id:
            word2id[w] = len(words)
            words.append(w)
    trie = LexiconTrie()
    for w, units in lexicon:
        trie.add_word(list(units), word2id[w])
    ngram = NgramGraph.from_arpa(arpa, word2id)
    return LgGraph(trie=trie, ngram=ngram, words=words, num_units=num_units)


# ---------------------------------------------------------------------------
# Reference decoder (numpy; mirrors runtime/core/decoder/wfst_beam_search.cc)
# ---------------------------------------------------------------------------

@dataclass
class WfstDecodeOptions:
    blank: int = 0
    beam: float = 16.0
    max_active: int = 7000
    acoustic_scale: float = 1.0
    lm_scale: float = 1.0
    nbest: int = 1
    blank_skip_thresh: float = 1.1  # >1 disables frame skipping
    word_penalty: float = 0.0


@dataclass
class WfstHyp:
    words: List[int]
    units: List[int]
    times: List[int]          # frame per unit
    word_times: List[int]     # frame of first unit of each word
    cost: float


@dataclass
class _Bp:
    unit: int
    word: int
    frame: int
    prev: int


def wfst_beam_decode(lg: LgGraph, log_probs, opts: Optional[WfstDecodeOptions]
                     = None) -> List[WfstHyp]:
    """Token-passing Viterbi beam search over on-the-fly L∘G with CTC
    blank/repeat semantics tracked per token.

    log_probs: [T, V] CTC log posteriors (unit ids; opts.blank is blank):
    a numpy array, or a torch tensor on any device, read to the host once.
    """
    import numpy as np
    opts = opts or WfstDecodeOptions()
    if hasattr(log_probs, "detach"):   # a torch tensor
        log_probs = log_probs.detach().cpu().numpy()
    log_probs = np.asarray(log_probs, dtype=np.float64)
    T, V = log_probs.shape
    trie, ng = lg.trie, lg.ngram
    blank = opts.blank

    # token key: (l_node, g_state, last_unit); last_unit == blank means the
    # previous frame (on the decoded timeline) was blank.
    bp_arena: List[_Bp] = []
    tokens: Dict[Tuple[int, int, int], Tuple[float, int]] = {
        (0, ng.start, blank): (0.0, -1)}

    last_best = -1
    last_was_blank = False
    decoded_frames: List[int] = []
    pending_blank: Optional[Tuple[int, "object"]] = None

    def process_frame(frame_idx: int, logp) -> None:
        nonlocal tokens
        ascale = opts.acoustic_scale
        new_tokens: Dict[Tuple[int, int, int], Tuple[float, int]] = {}
        best = min(c for c, _ in tokens.values())
        cutoff = best + opts.beam

        def offer(key, cost, bp):
            cur = new_tokens.get(key)
            if cur is None or cost < cur[0]:
                new_tokens[key] = (cost, bp)

        for (l, g, last_u), (cost, bp) in tokens.items():
            if cost > cutoff:
                continue
            # 1. blank
            offer((l, g, blank), cost - ascale * logp[blank], bp)
            # 2. repeat last emission (stay put)
            if last_u != blank:
                offer((l, g, last_u), cost - ascale * logp[last_u], bp)
            # 3. advance through trie arcs
            for (u, wd, nl) in trie.arcs[l]:
                if u == last_u:
                    continue  # same unit without blank = repeat, handled above
                c = cost - ascale * logp[u]
                if c > cutoff + opts.beam:
                    continue
                gg = g
                if wd != NO_WORD:
                    lmc, gg = ng.advance(g, wd)
                    if math.isinf(lmc):
                        continue
                    c += opts.lm_scale * lmc + opts.word_penalty
                bp_arena.append(_Bp(u, wd, frame_idx, bp))
                offer((nl, gg, u), c, len(bp_arena) - 1)

        # prune: beam + max_active
        costs = sorted(c for c, _ in new_tokens.values())
        thresh = costs[0] + opts.beam
        if len(costs) > opts.max_active:
            thresh = min(thresh, costs[opts.max_active])
        tokens = {k: v for k, v in new_tokens.items() if v[0] <= thresh}

    for t in range(T):
        logp = log_probs[t]
        if math.exp(logp[blank]) > opts.blank_skip_thresh:
            last_was_blank = True
            pending_blank = (t, logp)
            continue
        cur_best = int(np.argmax(logp))
        if (cur_best != blank and last_was_blank and cur_best == last_best
                and pending_blank is not None):
            # re-insert one skipped blank frame between identical symbols
            process_frame(pending_blank[0], pending_blank[1])
            decoded_frames.append(pending_blank[0])
        last_best = cur_best
        last_was_blank = False
        pending_blank = None
        process_frame(t, logp)
        decoded_frames.append(t)

    # Finalize: only tokens at the trie root (no word in progress) can end.
    finals: List[Tuple[float, int]] = []
    for (l, g, _last), (cost, bp) in tokens.items():
        if l != 0:
            continue
        finals.append((cost + opts.lm_scale * ng.final[g], bp))
    if not finals:  # fall back: any token, no final cost
        finals = [(cost, bp) for (_k), (cost, bp) in tokens.items()]
    finals.sort(key=lambda x: x[0])

    results: List[WfstHyp] = []
    seen = set()
    for cost, bp in finals:
        units: List[int] = []
        words: List[int] = []
        times: List[int] = []
        word_times: List[int] = []
        i = bp
        chain: List[_Bp] = []
        while i >= 0:
            chain.append(bp_arena[i])
            i = bp_arena[i].prev
        chain.reverse()
        start = 0
        for j, e in enumerate(chain):
            units.append(e.unit)
            times.append(e.frame)
            if e.word != NO_WORD:
                words.append(e.word)
                word_times.append(chain[start].frame)
                start = j + 1
        key = tuple(words)
        if key in seen:
            continue
        seen.add(key)
        results.append(WfstHyp(words=words, units=units, times=times,
                               word_times=word_times, cost=cost))
        if len(results) >= opts.nbest:
            break
    return results
