"""The port stands alone: no module of ``wenet_celoss_tpu_torch`` and
nothing in ``chip_smoke.py`` imports jax, flax, optax or the JAX package
(only the tests import both). The serving and export modules import no
yaml or msgpack (the machine with the card has neither), and only the
gRPC front end imports grpc. The tools' CLIs (alignment, label checker,
build_lg) import no yaml or msgpack either, and the two that run a model
choose their device through ``resolve_device`` alone."""

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(r"^(jax|jaxlib|flax|optax|wenet_celoss_tpu)(\.|$)")
HOST_ONLY = re.compile(r"^(yaml|msgpack)(\.|$)")
GRPC = re.compile(r"^grpc(\.|$)")
SERVING = ("bin/runtime_worker.py", "bin/export.py", "bin/grpc_server.py",
           "utils/quantize.py", "decode/rnnt_greedy.py")
TOOLS = ("bin/alignment.py", "bin/label_checker.py", "bin/build_lg.py",
         "lm/arpa.py", "lm/fst.py", "decode/label_check.py",
         "utils/flops.py")
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


@pytest.mark.parametrize("rel", SERVING)
def test_serving_modules_import_no_yaml_or_msgpack(rel):
    mods = list(_imported_modules(ROOT / "wenet_celoss_tpu_torch" / rel))
    bad = [m for m in mods if FORBIDDEN.match(m) or HOST_ONLY.match(m)]
    assert not bad, f"{rel} imports {bad}"


def test_only_the_grpc_front_end_imports_grpc():
    users = [str(p.relative_to(ROOT)) for p in FILES
             if any(GRPC.match(m) for m in _imported_modules(p))]
    assert users == ["wenet_celoss_tpu_torch/bin/grpc_server.py"]
    assert FORBIDDEN.match("optax") and not GRPC.match("grpcio_tools_x")


@pytest.mark.parametrize("rel", TOOLS)
def test_tools_import_no_yaml_or_msgpack(rel):
    mods = list(_imported_modules(ROOT / "wenet_celoss_tpu_torch" / rel))
    bad = [m for m in mods if FORBIDDEN.match(m) or HOST_ONLY.match(m)]
    assert not bad, f"{rel} imports {bad}"


@pytest.mark.parametrize("rel", ["bin/alignment.py", "bin/label_checker.py"])
def test_tool_clis_take_their_device_from_resolve_device(rel, tmp_path):
    """The CLI names no device of its own (no ``torch.device``, no
    "cuda"), calls resolve_device once with --device, and without a card
    and without --device it raises before reading anything."""
    import importlib
    import torch
    src = (ROOT / "wenet_celoss_tpu_torch" / rel).read_text()
    assert src.count("resolve_device(args.device)") == 1
    assert "torch.device(" not in src and '"cuda"' not in src
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    mod = importlib.import_module(
        "wenet_celoss_tpu_torch." + rel[:-3].replace("/", "."))
    missing = str(tmp_path / "missing")
    argv = {"bin/alignment.py": ["--input_data", missing, "--result_file",
                                 missing],
            "bin/label_checker.py": ["--wav_scp", missing, "--text",
                                     missing, "--result", missing]}[rel]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--config", missing, "--checkpoint", missing,
                  "--symbol_table", missing] + argv)
