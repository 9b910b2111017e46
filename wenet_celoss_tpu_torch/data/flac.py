"""FLAC decoding for the data pipeline, through ctypes over the repo's C++
decoder ``runtime/core/frontend/flac.cc`` (the one the JAX package's
``data/flac.py`` and the serving runtime build).

The shared library is built at first use with the system ``g++`` into
``wenet_celoss_tpu_torch/_build/libflacdec-<hash>.so`` (the hash is of
the source and its header, so an edited source rebuilds). A failed build
raises. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
CORE_DIR = PKG_DIR.parent / "runtime" / "core"
SOURCE = CORE_DIR / "frontend" / "flac.cc"
BUILD_DIR = PKG_DIR / "_build"

_libs: dict = {}


def _target() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update((CORE_DIR / "frontend" / "flac.h").read_bytes())
    return BUILD_DIR / f"libflacdec-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """The decoder's shared library, compiled if it has no current build."""
    out = _target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-I",
         str(CORE_DIR), str(SOURCE), "-o", str(tmp)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the FLAC decoder failed (g++ exited "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)   # atomic when processes build at once
    return out


def _lib() -> ctypes.CDLL:
    lib = _libs.get("flac")
    if lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.flac_decode.restype = ctypes.c_int
        lib.flac_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)]
        lib.flac_free.restype = None
        lib.flac_free.argtypes = [ctypes.POINTER(ctypes.c_int32)]
        _libs["flac"] = lib
    return lib


def read_flac(source) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file, file object or bytes → (samples float32 in int16
    range, [n] mono or [n, channels], sample_rate), the contract of
    ``data.wav.read_wav``."""
    if isinstance(source, (bytes, bytearray)):
        data = bytes(source)
    elif hasattr(source, "read"):
        data = source.read()
    else:
        with open(source, "rb") as f:
            data = f.read()
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_int32)()
    channels = ctypes.c_int32()
    rate = ctypes.c_int32()
    bits = ctypes.c_int32()
    frames = ctypes.c_int64()
    rc = lib.flac_decode(data, len(data), ctypes.byref(out),
                         ctypes.byref(channels), ctypes.byref(rate),
                         ctypes.byref(bits), ctypes.byref(frames))
    if rc != 0:
        raise ValueError(f"flac decode failed (rc={rc})")
    try:
        n = frames.value * channels.value
        arr = np.ctypeslib.as_array(out, shape=(n,)).astype(np.float32)
    finally:
        lib.flac_free(out)
    # Scale to the int16 range as read_wav does (24-bit /256, 8-bit *256).
    shift = bits.value - 16
    if shift > 0:
        arr /= float(1 << shift)
    elif shift < 0:
        arr *= float(1 << (-shift))
    if channels.value > 1:
        arr = arr.reshape(frames.value, channels.value)
    return arr, rate.value
