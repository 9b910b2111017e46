"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled for
``sm_90a`` into ``wenet_celoss_tpu_torch/_build/lib<name>-<hash>.so`` at
first use (the hash is of the source and ``csrc/*.cuh``, so an edited
source or header rebuilds), and
the library is loaded once per process. ``build_all`` starts one ``nvcc``
per source, all at once. Nothing here runs at import time.
``wants_autograd`` picks a wrapper's route: its ``autograd.Function``
when a gradient will be taken, else its registered forward operator.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (put nvcc on PATH)")


def _target(name: str) -> Path:
    """The library path, named by a hash of the source and the shared
    headers it may include."""
    h = hashlib.sha1((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no current build, one nvcc
    process each, started together. Returns {name: library path}."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: _target(name) for name in names}


def wants_autograd(*tensors) -> bool:
    """Whether a wrapper must take its ``autograd.Function`` (a gradient
    will be taken through it) rather than its forward operator."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib
