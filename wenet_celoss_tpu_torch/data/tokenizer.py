"""Tokenization (copy of ``wenet_celoss_tpu/data/tokenizer.py``): CJK
characters one by one, Latin runs optionally BPE-segmented,
non-linguistic symbols passed through, symbol-table lookup with an
``<unk>`` fallback.

The sentencepiece package is not needed: a reader of the .model protobuf
(the wire format of ModelProto: repeated SentencePiece{piece=1, score=2,
type=3}) and a Viterbi unigram segmenter over the piece scores, the
algorithm sentencepiece runs at inference.
"""

from __future__ import annotations

import re
import struct
from typing import Dict, List, Optional, Tuple


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_sentencepiece_model(path: str) -> Dict[str, float]:
    """Parse a sentencepiece ModelProto → {piece: score}.

    Only normal pieces (type 1 or unset) are kept; control/unknown/byte
    pieces are skipped.
    """
    with open(path, "rb") as f:
        buf = f.read()
    pieces: Dict[str, float] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # repeated SentencePiece
            length, pos = _read_varint(buf, pos)
            sub = buf[pos:pos + length]
            pos += length
            piece, score, ptype = None, 0.0, 1
            spos = 0
            while spos < len(sub):
                stag, spos = _read_varint(sub, spos)
                sfield, swire = stag >> 3, stag & 7
                if sfield == 1 and swire == 2:
                    slen, spos = _read_varint(sub, spos)
                    piece = sub[spos:spos + slen].decode("utf-8",
                                                         errors="replace")
                    spos += slen
                elif sfield == 2 and swire == 5:
                    score = struct.unpack("<f", sub[spos:spos + 4])[0]
                    spos += 4
                elif sfield == 3 and swire == 0:
                    ptype, spos = _read_varint(sub, spos)
                else:  # skip unknown
                    if swire == 0:
                        _, spos = _read_varint(sub, spos)
                    elif swire == 2:
                        slen, spos = _read_varint(sub, spos)
                        spos += slen
                    elif swire == 5:
                        spos += 4
                    elif swire == 1:
                        spos += 8
                    else:
                        raise ValueError(f"bad wire type {swire}")
            if piece is not None and ptype == 1:
                pieces[piece] = score
        else:  # skip other top-level fields
            if wire == 0:
                _, pos = _read_varint(buf, pos)
            elif wire == 2:
                length, pos = _read_varint(buf, pos)
                pos += length
            elif wire == 5:
                pos += 4
            elif wire == 1:
                pos += 8
            else:
                raise ValueError(f"bad wire type {wire}")
    return pieces


class UnigramTokenizer:
    """Viterbi segmentation over sentencepiece unigram piece scores."""

    def __init__(self, model_path: str):
        self.pieces = parse_sentencepiece_model(model_path)
        self.max_len = max((len(p) for p in self.pieces), default=1)
        self.min_score = min(self.pieces.values(), default=0.0) - 10.0

    def encode(self, text: str) -> List[str]:
        """Segment ' '-joined words; sentencepiece convention: spaces →
        '▁' word-boundary marker prepended to each word."""
        s = "▁" + text.replace(" ", "▁")
        n = len(s)
        # Viterbi over character positions.
        best = [float("-inf")] * (n + 1)
        back: List[Optional[Tuple[int, str]]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            for j in range(i + 1, min(i + self.max_len, n) + 1):
                piece = s[i:j]
                score = self.pieces.get(piece)
                if score is None:
                    if j - i == 1:  # unknown single char fallback
                        score = self.min_score
                    else:
                        continue
                if best[i] + score > best[j]:
                    best[j] = best[i] + score
                    back[j] = (i, piece)
        out: List[str] = []
        j = n
        while j > 0:
            i, piece = back[j]
            out.append(piece)
            j = i
        out.reverse()
        return out


_CJK_RE = re.compile(r"([一-鿿])")


def is_cjk(ch: str) -> bool:
    return "一" <= ch <= "鿿"


class Tokenizer:
    """Text → (tokens, ids) per the reference tokenize processor."""

    def __init__(self, symbol_table: Dict[str, int],
                 bpe_model: Optional[str] = None,
                 non_lang_syms: Optional[List[str]] = None,
                 split_with_space: bool = False):
        self.symbol_table = symbol_table
        self.bpe = UnigramTokenizer(bpe_model) if bpe_model else None
        self.non_lang_syms = non_lang_syms or []
        self.split_with_space = split_with_space
        if self.non_lang_syms:
            pattern = "|".join(re.escape(s) for s in self.non_lang_syms)
            self.non_lang_re = re.compile(f"({pattern})")
        else:
            self.non_lang_re = None

    def text_to_tokens(self, text: str) -> List[str]:
        parts = (self.non_lang_re.split(text) if self.non_lang_re
                 else [text])
        tokens: List[str] = []
        for part in parts:
            if not part:
                continue
            if part in self.non_lang_syms:
                tokens.append(part)
                continue
            if self.bpe is not None:
                # Segment contiguous non-CJK runs with BPE, CJK per char
                # (reference `processor.py:305-346`).
                for seg in _CJK_RE.split(part):
                    if not seg:
                        continue
                    if is_cjk(seg[0]) and len(seg) == 1:
                        tokens.append(seg)
                    else:
                        tokens.extend(self.bpe.encode(seg.strip()))
            else:
                if self.split_with_space:
                    tokens.extend(t for t in part.split() if t)
                else:
                    for ch in part:
                        tokens.append("▁" if ch == " " else ch)
        return tokens

    def tokens_to_ids(self, tokens: List[str]) -> List[int]:
        table = self.symbol_table
        unk = table.get("<unk>")
        out = []
        for t in tokens:
            if t in table:
                out.append(table[t])
            elif unk is not None:
                out.append(unk)
        return out

    def __call__(self, text: str) -> Tuple[List[str], List[int]]:
        tokens = self.text_to_tokens(text)
        return tokens, self.tokens_to_ids(tokens)
