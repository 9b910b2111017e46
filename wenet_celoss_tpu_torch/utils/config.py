"""Config files with dotted-path overrides (port of
``wenet_celoss_tpu/utils/config.py``: ``load_config``, ``save_config``,
``override_config`` with the coercion to the existing value's type).

The configs are YAML. The machine with the card has no PyYAML, so both
directions use a small reader and writer of this module's own. The reader
takes the subset the repo's configs use: block mappings and sequences
(also "- key: value" items), flow lists of scalars, ``{}`` and ``[]``,
comments and quoted strings. Plain scalars resolve as ``yaml.safe_load`` resolves them
(YAML 1.1): ``1e-3`` (no dot) stays a string while ``1.0e-3`` is a float,
``true/false/yes/no/on/off`` are booleans and ``~`` or ``null`` is None.
Anything outside the subset (anchors, tags, block scalars, multi-line
plain scalars, tabs) raises and names the line. The writer writes floats
so that they read back as floats (``1.0e-05``).
"""

from __future__ import annotations

import copy
import json
import math
import re
from typing import Any, Dict, List, Tuple

# YAML 1.1 implicit resolvers, as PyYAML's SafeLoader has them.
_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True,
         "True": True, "TRUE": True, "on": True, "On": True, "ON": True,
         "no": False, "No": False, "NO": False, "false": False,
         "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                     |[-+]?0[0-7_]+
                     |[-+]?(?:0|[1-9][0-9_]*)
                     |[-+]?0x[0-9a-fA-F_]+
                     |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                       |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                       |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                       |[-+]?\.(?:inf|Inf|INF)
                       |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")


class YamlSubsetError(ValueError):
    pass


def _sexagesimal(text: str, value_fn) -> Any:
    value = 0
    for part in text.split(":"):
        value = value * 60 + value_fn(part)
    return value


def _int(text: str) -> int:
    v = text.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        return sign * _sexagesimal(v, int)
    return sign * int(v)


def _float(text: str) -> float:
    v = text.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * math.inf
    if v == ".nan":
        return math.nan
    if ":" in v:
        return sign * _sexagesimal(v, float)
    return sign * float(v)


def resolve_plain(text: str, line: int) -> Any:
    """A plain (unquoted) scalar as YAML 1.1 reads it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    if _TIMESTAMP.match(text) or text.startswith(("&", "*", "!", "|",
                                                   ">", "%", "@", "`")):
        raise YamlSubsetError(f"line {line}: {text!r} is outside the YAML "
                              "subset this reader takes")
    return text


def _quoted(text: str, line: int) -> Tuple[str, str]:
    """The quoted scalar at the start of ``text`` → (value, rest)."""
    q = text[0]
    i = 1
    while True:
        j = text.find(q, i)
        if j < 0:
            raise YamlSubsetError(f"line {line}: unterminated quote")
        if q == "'" and text[j + 1:j + 2] == "'":
            i = j + 2
            continue
        if q == '"':
            k = j - 1
            while k > 0 and text[k] == "\\":
                k -= 1
            if (j - 1 - k) % 2:
                i = j + 1
                continue
        break
    body = text[1:j]
    if q == "'":
        return body.replace("''", "'"), text[j + 1:]
    try:
        return json.loads('"' + body + '"'), text[j + 1:]
    except ValueError as e:
        raise YamlSubsetError(f"line {line}: escape outside the subset in "
                              f"{text[:j + 1]!r}") from e


def _strip_comment(text: str) -> str:
    """``text`` without a trailing comment (a # at the start or after a
    space, outside quotes)."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " [,{:-"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _scalar(text: str, line: int) -> Any:
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, line)
        if rest.strip():
            raise YamlSubsetError(f"line {line}: text after a quoted "
                                  f"scalar: {rest!r}")
        return value
    return resolve_plain(text, line)


def _flow(text: str, line: int) -> Any:
    """A flow list of scalars, or the empty flow map ``{}``."""
    if text == "{}":
        return {}
    if text[0] != "[" or not text.endswith("]"):
        raise YamlSubsetError(f"line {line}: only flow lists of scalars "
                              f"and {{}} are in the subset: {text!r}")
    items, buf, quote = [], "", None
    for ch in text[1:-1]:
        if quote:
            buf += ch
            if ch == quote:
                quote = None
        elif ch in "'\"" and not buf.strip():
            quote = ch
            buf += ch
        elif ch in "[]{}":
            raise YamlSubsetError(f"line {line}: nested flow collections "
                                  "are outside the subset")
        elif ch == ",":
            items.append(buf)
            buf = ""
        else:
            buf += ch
    if buf.strip():
        items.append(buf)
    elif items:
        raise YamlSubsetError(f"line {line}: empty flow item")
    return [_scalar(x, line) for x in items]


def _split_key(text: str, line: int) -> Tuple[Any, bool, str]:
    """``key: rest`` → (key, True, rest); a line with no mapping key →
    (None, False, text)."""
    if text[:1] in ("'", '"'):
        key, rest = _quoted(text, line)
        if rest.startswith(":") and (len(rest) == 1 or rest[1] == " "):
            return key, True, rest[1:].strip()
        return None, False, text
    m = re.match(r"^([^'\"\[\]{},#][^#]*?):(?: |$)", text)
    if m is None:
        return None, False, text
    return resolve_plain(m.group(1).strip(), line), True, \
        text[m.end():].strip()


def _value(text: str, line: int) -> Any:
    if text[:1] in ("[", "{"):
        return _flow(text, line)
    return _scalar(text, line)


class _Reader:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, int, str]] = []   # (line, indent, text)
        for n, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise YamlSubsetError(f"line {n}: tab in indentation")
            body = _strip_comment(raw)
            if not body.strip() or (body.startswith("---")
                                    and not self.lines):
                continue
            if body.startswith(("---", "...")):
                raise YamlSubsetError(f"line {n}: more than one document")
            self.lines.append((n, len(body) - len(body.lstrip(" ")),
                               body.strip()))
        self.pos = 0

    def parse(self) -> Any:
        if not self.lines:
            return None
        value = self._node(self.lines[0][1])
        if self.pos < len(self.lines):
            n = self.lines[self.pos][0]
            raise YamlSubsetError(f"line {n}: unexpected indentation")
        return value

    def _node(self, indent: int) -> Any:
        n, ind, text = self.lines[self.pos]
        if ind != indent:
            raise YamlSubsetError(f"line {n}: unexpected indentation")
        if text == "-" or text.startswith("- "):
            return self._sequence(indent)
        _, is_key, _ = _split_key(text, n)
        if is_key:
            return self._mapping(indent)
        self.pos += 1
        if self.pos < len(self.lines) and self.lines[self.pos][1] > indent:
            raise YamlSubsetError(f"line {self.lines[self.pos][0]}: "
                                  "multi-line scalars are outside the "
                                  "subset")
        return _value(text, n)

    def _child(self, indent: int, n: int, seq_ok: bool) -> Any:
        """The block under a key or dash at ``indent`` (None if empty); a
        mapping's value may be a sequence at the key's own indent."""
        if self.pos < len(self.lines):
            _, ind, text = self.lines[self.pos]
            if ind > indent:
                return self._node(ind)
            if seq_ok and ind == indent and (text == "-"
                                             or text.startswith("- ")):
                return self._sequence(indent)
        return None

    def _mapping(self, indent: int) -> Dict:
        out: Dict = {}
        while self.pos < len(self.lines):
            n, ind, text = self.lines[self.pos]
            if ind < indent:
                break
            if ind > indent:
                raise YamlSubsetError(f"line {n}: unexpected indentation")
            key, is_key, rest = _split_key(text, n)
            if not is_key:
                if text == "-" or text.startswith("- "):
                    break
                raise YamlSubsetError(f"line {n}: expected 'key: value'")
            self.pos += 1
            out[key] = _value(rest, n) if rest else \
                self._child(indent, n, seq_ok=True)
        return out

    def _sequence(self, indent: int) -> List:
        out: List = []
        while self.pos < len(self.lines):
            n, ind, text = self.lines[self.pos]
            if ind != indent or not (text == "-" or text.startswith("- ")):
                if ind > indent:
                    raise YamlSubsetError(f"line {n}: unexpected "
                                          "indentation")
                break
            rest = text[1:].strip()
            self.pos += 1
            if not rest:
                out.append(self._child(indent, n, seq_ok=False))
                continue
            if rest == "-" or rest.startswith(("- ", "? ")):
                raise YamlSubsetError(f"line {n}: nested inline sequences "
                                      "are outside the subset")
            _, is_key, _ = _split_key(rest, n)
            if not is_key:
                out.append(_value(rest, n))
                continue
            # "- key: value": a mapping whose keys sit at the column of
            # the first key.
            col = ind + (len(text) - len(rest))
            self.pos -= 1
            self.lines[self.pos] = (n, col, rest)
            out.append(self._mapping(col))
        return out


def parse_yaml(text: str) -> Any:
    """The subset reader: YAML text → Python values."""
    return _Reader(text).parse()


def _float_text(x: float) -> str:
    if math.isnan(x):
        return ".nan"
    if math.isinf(x):
        return ".inf" if x > 0 else "-.inf"
    text = repr(x)
    if "e" in text:
        mant, exp = text.split("e")
        if "." not in mant:
            mant += ".0"
        if exp[0] not in "+-":
            exp = "+" + exp
        return f"{mant}e{exp}"
    return text if "." in text else text + ".0"


_SAFE_PLAIN = re.compile(r"^[A-Za-z_/][A-Za-z0-9_./\-]*$")


def _scalar_text(x: Any) -> str:
    if x is None:
        return "null"
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, int):
        return str(x)
    if isinstance(x, float):
        return _float_text(x)
    if isinstance(x, str):
        if _SAFE_PLAIN.match(x) and resolve_plain(x, 0) == x:
            return x
        if x.isprintable() and x.isascii():
            return "'" + x.replace("'", "''") + "'"
        return json.dumps(x)
    raise TypeError(f"cannot write {type(x).__name__} as a YAML scalar")


def _dump(obj: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(obj, dict):
        for key, value in obj.items():
            head = f"{pad}{_scalar_text(key)}:"
            if isinstance(value, (dict, list, tuple)) and value:
                out.append(head)
                _dump(value, indent + 2, out)
            else:
                out.append(f"{head} {_inline(value)}")
    else:
        for value in obj:
            if isinstance(value, (dict, list, tuple)) and value:
                out.append(f"{pad}-")
                _dump(value, indent + 2, out)
            else:
                out.append(f"{pad}- {_inline(value)}")


def _inline(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, (list, tuple)):
        return "[]"
    return _scalar_text(value)


def dump_yaml(obj: Any) -> str:
    """The subset writer: dicts, lists and tuples (as lists) of scalars
    → YAML text that ``yaml.safe_load`` and :func:`parse_yaml` read back
    to ``obj``."""
    if not isinstance(obj, (dict, list, tuple)) or not obj:
        return _inline(obj) + "\n"
    out: List[str] = []
    _dump(obj, 0, out)
    return "\n".join(out) + "\n"


def load_config(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf8") as f:
        return parse_yaml(f.read())


def save_config(configs: Dict[str, Any], path: str) -> None:
    with open(path, "w", encoding="utf8") as f:
        f.write(dump_yaml(configs))


def _coerce(old: Any, new: str) -> Any:
    if isinstance(old, bool):
        return new.lower() in ("1", "true", "yes", "on")
    if isinstance(old, int):
        return int(new)
    if isinstance(old, float):
        return float(new)
    if isinstance(old, list):
        item = old[0] if old else new
        return [_coerce(item, v) for v in new.split(",")]
    return new


def override_config(configs: Dict[str, Any],
                    overrides: List[str]) -> Dict[str, Any]:
    """Apply ``["a.b.c value", ...]`` overrides, coercing to existing types."""
    out = copy.deepcopy(configs)
    for item in overrides:
        parts = item.split()
        if len(parts) != 2:
            raise ValueError(f"override must be 'dotted.key value': {item!r}")
        keys, value = parts[0].split("."), parts[1]
        node = out
        for k in keys[:-1]:
            if k not in node:
                raise KeyError(f"unknown config path {parts[0]!r}")
            node = node[k]
        leaf = keys[-1]
        if leaf not in node:
            raise KeyError(f"unknown config key {parts[0]!r}")
        node[leaf] = _coerce(node[leaf], value)
    return out
