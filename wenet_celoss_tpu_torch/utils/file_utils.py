"""Symbol-table and list-file reading (copy of
``wenet_celoss_tpu/utils/file_utils.py``): ``read_lists``,
``read_symbol_table`` and ``read_non_lang_symbols`` with its pattern check.
"""

from __future__ import annotations

import re
from typing import Dict, List


def read_lists(path: str) -> List[str]:
    with open(path, "r", encoding="utf8") as f:
        return [line.strip() for line in f if line.strip()]


def read_symbol_table(path: str) -> Dict[str, int]:
    table: Dict[str, int] = {}
    with open(path, "r", encoding="utf8") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) != 2:
                continue
            table[parts[0]] = int(parts[1])
    return table


_NON_LANG_RE = re.compile(r"^(\{[^{}]+\}|<[^<>]+>|\[[^\[\]]+\])$")


def read_non_lang_symbols(path: str | None) -> List[str]:
    """Read non-linguistic symbols; each must look like {x}, <x> or [x]
    (reference `file_utils.py:26-56`)."""
    if path is None:
        return []
    syms = read_lists(path)
    for s in syms:
        if not _NON_LANG_RE.match(s):
            raise ValueError(
                f"non-linguistic symbol {s!r} must be wrapped in {{}}, <> or []")
    return syms
