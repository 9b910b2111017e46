"""Build an LG decoding graph (lexicon trie ∘ n-gram backoff automaton):
the port of the root script ``tools/fst/build_lg.py``.

    python -m wenet_celoss_tpu_torch.bin.build_lg --units units.txt \\
        --arpa lm.arpa (--lexicon lexicon.txt | --wordlist words.txt) \\
        --out_dir lang/

Writes ``lg.bin`` (read by the C++ runtime, ``decoder_main --fst_path``,
and by ``lm/fst.py``'s ``LgGraph.read`` / ``wfst_beam_decode``) and
``words.txt``. Pure Python: no device.

Lexicon sources (one required):
  --lexicon lexicon.txt     kaldi style: "word unit1 unit2 ..."
  --wordlist words.txt      spell each word from units: tries "▁word",
                            then "▁" + chars, then plain chars (char models)
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from wenet_celoss_tpu_torch.lm.arpa import ArpaLM
from wenet_celoss_tpu_torch.lm.fst import build_lg


def read_units(path):
    unit2id = {}
    with open(path, encoding="utf8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                unit2id[parts[0]] = int(parts[1])
    return unit2id


def spell(word, unit2id):
    """Greedy longest-match spelling of a word into units."""
    for candidate in ("▁" + word, word):
        ids, rest = [], candidate
        ok = True
        while rest:
            for ln in range(len(rest), 0, -1):
                if rest[:ln] in unit2id:
                    ids.append(unit2id[rest[:ln]])
                    rest = rest[ln:]
                    break
            else:
                ok = False
                break
        if ok and ids:
            return ids
    return None


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--units", required=True, help="units.txt: unit id")
    p.add_argument("--arpa", required=True)
    p.add_argument("--lexicon", default=None)
    p.add_argument("--wordlist", default=None)
    p.add_argument("--out_dir", required=True)
    args = p.parse_args(argv)

    unit2id = read_units(args.units)
    lexicon = []
    if args.lexicon:
        with open(args.lexicon, encoding="utf8") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                word, units = parts[0], parts[1:]
                if all(u in unit2id for u in units):
                    lexicon.append((word, [unit2id[u] for u in units]))
                else:
                    print(f"skip (unknown unit): {word}", file=sys.stderr)
    elif args.wordlist:
        with open(args.wordlist, encoding="utf8") as f:
            for line in f:
                word = line.split()[0] if line.split() else None
                if not word or word in ("<s>", "</s>", "<unk>", "<eps>"):
                    continue
                ids = spell(word, unit2id)
                if ids:
                    lexicon.append((word, ids))
                else:
                    print(f"skip (unspellable): {word}", file=sys.stderr)
    else:
        p.error("one of --lexicon / --wordlist is required")

    lm = ArpaLM(args.arpa)
    num_units = max(unit2id.values()) + 1
    lg = build_lg(lexicon, lm, num_units)

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    lg.write(str(out / "lg.bin"))
    with open(out / "words.txt", "w", encoding="utf8") as f:
        for i, w in enumerate(lg.words):
            f.write(f"{w} {i}\n")
    print(f"LG: {lg.trie.num_nodes} trie nodes, "
          f"{lg.ngram.num_states} LM states, {len(lg.words) - 1} words "
          f"-> {out / 'lg.bin'}")


if __name__ == "__main__":
    main()
