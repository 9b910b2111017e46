"""Label checking: verify a transcription against audio via constrained
CTC alignment with edit operations (copy of
``wenet_celoss_tpu/decode/label_check.py``; pure Python over numpy).

Capability parity with the reference's `runtime/core/bin/label_checker_main.cc`,
which composes a CTC topology FST with a per-utterance "align FST" (correct /
deletion / insertion-substitution-filler arcs with penalties) and decodes the
audio through it, emitting the label sequence annotated with ``<del>`` and
``<is>...</is>`` markers. Here the composition is realized directly as a
Viterbi token-passing DP over states (label position, in-filler, last unit)
— no openfst — with exact CTC blank/repeat collapse semantics:

- **correct**: the next reference unit is emitted → advance.
- **deletion**: skip a reference unit for ``del_penalty`` (audio lacks it).
- **insertion/substitution**: enter a filler loop for ``is_penalty`` per
  emitted unit (audio contains units the reference does not).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

DELETION = "<del>"
IS_START = "<is>"
IS_END = "</is>"

_NEG = -1e30


@dataclass
class CheckedLabel:
    """One aligned item: a reference unit (kept or deleted) or an inserted
    audio unit inside an <is> span."""
    unit: int
    kind: str            # "ok" | "del" | "ins"
    frame: int = -1      # first emission frame (ok/ins; -1 for del)


def _viterbi(logp, labels: Sequence[int], blank: int,
             is_penalty: float, del_penalty: float,
             beam: int = 200, filler_topk: int = 20):
    """Token-passing Viterbi over (pos, filler, last_unit) states.

    Returns the best final hypothesis's backpointer chain as a list of
    (op, unit, frame) with op in {"ok", "del", "ins"}.
    """
    t_max, v = logp.shape
    l_len = len(labels)

    # hyp: (cost, path) keyed by (pos, filler, last_unit); path is a
    # backpointer tuple chain (parent_path, op, unit, frame) — shared
    # structurally, so memory is O(beam * T).
    def eps_closure(hyps: Dict, frame: int) -> Dict:
        """Apply deletion / filler enter / filler exit arcs (no frame
        consumed) to a fixed point."""
        changed = True
        while changed:
            changed = False
            for (pos, filler, last), (cost, path) in list(hyps.items()):
                cands = []
                if not filler and pos < l_len:
                    cands.append(((pos + 1, 0, last),
                                  cost - del_penalty,
                                  (path, "del", labels[pos], frame)))
                if not filler:
                    # entering the filler resets CTC last-unit (the
                    # reference's filler arcs are fresh states)
                    cands.append(((pos, 1, blank), cost, path))
                else:
                    cands.append(((pos, 0, blank), cost, path))
                for key, c, p in cands:
                    if c > hyps.get(key, (_NEG, None))[0]:
                        hyps[key] = (c, p)
                        changed = True
        return hyps

    import numpy as np

    hyps: Dict = {(0, 0, blank): (0.0, None)}
    hyps = eps_closure(hyps, -1)
    k = min(filler_topk, v)
    for t in range(t_max):
        row = logp[t]
        # Filler arcs accept any unit; restrict to the frame's top-k
        # posterior units (beam-style prune; insertions the audio actually
        # contains are by definition high-posterior).
        top_units = np.argpartition(-row, k - 1)[:k]
        new: Dict = {}

        def offer(key, cost, path):
            if cost > new.get(key, (_NEG, None))[0]:
                new[key] = (cost, path)

        for (pos, filler, last), (cost, path) in hyps.items():
            # blank: stay, reset last unit
            offer((pos, filler, blank), cost + row[blank], path)
            # repeat of last unit: CTC collapse, no advance
            if last != blank:
                offer((pos, filler, last), cost + row[last], path)
            if filler:
                # filler consumes any unit at is_penalty each
                for u in top_units:
                    u = int(u)
                    if u == blank or u == last:
                        continue
                    offer((pos, 1, u), cost + row[u] - is_penalty,
                          (path, "ins", u, t))
            elif pos < l_len:
                u = labels[pos]
                if u != last:
                    offer((pos + 1, 0, u), cost + row[u],
                          (path, "ok", u, t))
        new = eps_closure(new, t)
        if len(new) > beam:
            new = dict(sorted(new.items(),
                              key=lambda kv: -kv[1][0])[:beam])
        hyps = new

    best = None
    for (pos, filler, _), (cost, path) in hyps.items():
        if pos == l_len and not filler:
            if best is None or cost > best[0]:
                best = (cost, path)
    if best is None:
        return None, _NEG
    ops: List[Tuple[str, int, int]] = []
    node = best[1]
    while node is not None:
        node, op, unit, frame = node
        ops.append((op, unit, frame))
    ops.reverse()
    return ops, best[0]


def check_labels(ctc_log_probs, labels: Sequence[int], blank: int = 0,
                 is_penalty: float = 2.3, del_penalty: float = 2.3,
                 beam: int = 200,
                 filler_topk: int = 20) -> Optional[List[CheckedLabel]]:
    """Align `labels` to the audio's CTC posteriors with edit operations.

    Args:
      ctc_log_probs: [T, V] numpy array of CTC log posteriors.
      is_penalty / del_penalty: natural-log costs per edit (the reference's
        FLAGS_is_penalty / FLAGS_del_penalty, label_checker_main.cc:28-30).
    Returns the aligned items, or None if no alignment survived the beam.
    """
    import numpy as np
    logp = np.asarray(ctc_log_probs, dtype=np.float64)
    ops, _ = _viterbi(logp, list(labels), blank, is_penalty, del_penalty,
                      beam, filler_topk)
    if ops is None:
        return None
    return [CheckedLabel(unit=u, kind=op, frame=f) for op, u, f in ops]


def render(items: List[CheckedLabel], id2sym: Dict[int, str],
           frame_shift_ms: int = 10, subsampling: int = 1
           ) -> Tuple[str, str]:
    """→ (annotated text with <del>/<is> markers, 'sym:time_ms' line)."""
    parts: List[str] = []
    times: List[str] = []
    in_is = False
    for it in items:
        sym = id2sym.get(it.unit, "<unk>")
        if it.kind == "ins":
            if not in_is:
                parts.append(IS_START)
                in_is = True
            parts.append(sym)
        else:
            if in_is:
                parts.append(IS_END)
                in_is = False
            if it.kind == "del":
                parts.append(DELETION + sym)
            else:
                parts.append(sym)
                times.append(
                    f"{sym}:{it.frame * frame_shift_ms * subsampling}")
    if in_is:
        parts.append(IS_END)
    return " ".join(parts), " ".join(times)
