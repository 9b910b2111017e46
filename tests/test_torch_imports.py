"""The port stands alone: no module of ``wenet_celoss_tpu_torch`` and
nothing in ``chip_smoke.py`` imports jax, flax or the JAX package (only
the tests import both)."""

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(r"^(jax|jaxlib|flax|wenet_celoss_tpu)(\.|$)")
FILES = sorted((ROOT / "wenet_celoss_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if FORBIDDEN.match(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_pattern_matches_whole_names_only():
    assert FORBIDDEN.match("wenet_celoss_tpu.models")
    assert FORBIDDEN.match("jax")
    assert not FORBIDDEN.match("wenet_celoss_tpu_torch.ops")
    assert not FORBIDDEN.match("jaxtyping")
