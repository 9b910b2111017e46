"""Kaldi ark/scp matrix and vector IO, pure numpy (a copy of
``wenet_celoss_tpu/data/kaldi_io.py``).

Parity with reference ``wenet/dataset/kaldi_io.py`` for the formats the
toolkit actually uses: binary float/double matrices and vectors ("BFM",
"BDM", "BFV", "BDV"), compressed matrices ("CM" one-byte-with-column-
headers, "CM2" two-byte, "CM3" one-byte), text-mode matrices, scp offset
indexing, and write_mat/write_vec_flt (+ write_cmat for producing
compressed arks, which the reference cannot do).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

import numpy as np


def _read_token(f) -> str:
    tok = b""
    while True:
        c = f.read(1)
        if not c or c == b" ":
            break
        tok += c
    return tok.decode()


def read_mat(f_or_path) -> np.ndarray:
    """Read one matrix at the current position (after the key)."""
    f = open(f_or_path, "rb") if isinstance(f_or_path, str) else f_or_path
    binary = f.read(2)
    if binary == b"\x00B":
        return _read_mat_binary(f)
    # Text mode: rewind those two bytes into the parse.
    rest = binary + f.read()
    return _read_mat_text(rest.decode())


def _read_mat_binary(f) -> np.ndarray:
    header = _read_token(f)
    if header in ("CM", "CM2", "CM3"):
        return _read_mat_compressed(f, header)
    dtype = {"FM": "<f4", "DM": "<f8"}.get(header)
    if dtype is None:
        raise ValueError(f"unknown matrix header {header!r}")
    assert f.read(1) == b"\x04"
    rows = struct.unpack("<i", f.read(4))[0]
    assert f.read(1) == b"\x04"
    cols = struct.unpack("<i", f.read(4))[0]
    data = np.frombuffer(f.read(rows * cols * int(dtype[2])), dtype)
    return data.reshape(rows, cols).astype(np.float32)


def _read_mat_compressed(f, fmt: str) -> np.ndarray:
    """Kaldi CompressedMatrix payloads (format spec: kaldi
    matrix/compressed-matrix.{h,cc}; the reference reads the same three,
    wenet/dataset/kaldi_io.py).

    All three share a global header {min f4, range f4, rows i4, cols i4}.
    CM2/CM3 follow with row-major uint16/uint8 codes mapped linearly onto
    [min, min+range]. CM follows with per-column uint16 quartile headers
    (p0,p25,p75,p100, themselves linear codes) and column-major uint8
    codes mapped piecewise-linearly between the quartiles (0..64 →
    [p0,p25], 64..192 → [p25,p75], 192..255 → [p75,p100])."""
    gmin, grange = struct.unpack("<ff", f.read(8))
    rows, cols = struct.unpack("<ii", f.read(8))
    if fmt == "CM2":
        codes = np.frombuffer(f.read(rows * cols * 2), "<u2")
        return (gmin + grange * codes.astype(np.float32) / 65535.0) \
            .reshape(rows, cols)
    if fmt == "CM3":
        codes = np.frombuffer(f.read(rows * cols), "u1")
        return (gmin + grange * codes.astype(np.float32) / 255.0) \
            .reshape(rows, cols)
    heads = np.frombuffer(f.read(cols * 8), "<u2").reshape(cols, 4)
    pct = (gmin + grange * heads.astype(np.float32) / 65535.0)  # [cols,4]
    codes = np.frombuffer(f.read(cols * rows), "u1") \
        .reshape(cols, rows).astype(np.float32)
    p0, p25, p75, p100 = pct[:, 0:1], pct[:, 1:2], pct[:, 2:3], pct[:, 3:4]
    low = p0 + (p25 - p0) * (codes / 64.0)
    mid = p25 + (p75 - p25) * ((codes - 64.0) / 128.0)
    high = p75 + (p100 - p75) * ((codes - 192.0) / 63.0)
    vals = np.where(codes <= 64, low, np.where(codes <= 192, mid, high))
    return np.ascontiguousarray(vals.T)


def _quantize_u16(values: np.ndarray, gmin: float, grange: float):
    return np.clip(np.round((values - gmin) / max(grange, 1e-20) * 65535.0),
                   0, 65535).astype("<u2")


def write_cmat(f, mat: np.ndarray, key: str = "", fmt: str = "CM") -> int:
    """Write a compressed matrix ("CM"/"CM2"/"CM3"); returns the value
    offset. Quantization follows the format's decompression map so a
    read-back lands within one code step of the input."""
    if key:
        f.write((key + " ").encode())
    offset = f.tell()
    mat = np.asarray(mat, np.float32)
    rows, cols = mat.shape
    gmin = float(mat.min())
    grange = max(float(mat.max()) - gmin, 1e-10)
    f.write(b"\x00B" + fmt.encode() + b" ")
    f.write(struct.pack("<ffii", gmin, grange, rows, cols))
    if fmt == "CM2":
        f.write(_quantize_u16(mat, gmin, grange).tobytes())
        return offset
    if fmt == "CM3":
        codes = np.clip(np.round((mat - gmin) / grange * 255.0),
                        0, 255).astype("u1")
        f.write(codes.tobytes())
        return offset
    assert fmt == "CM", fmt
    q = np.quantile(mat, [0.0, 0.25, 0.75, 1.0], axis=0).astype(np.float32)
    heads = _quantize_u16(q.T, gmin, grange)           # [cols, 4]
    f.write(heads.tobytes())
    pct = gmin + grange * heads.astype(np.float32) / 65535.0
    p0, p25 = pct[:, 0][None], pct[:, 1][None]
    p75, p100 = pct[:, 2][None], pct[:, 3][None]
    low = np.round((mat - p0) / np.maximum(p25 - p0, 1e-10) * 64.0)
    mid = 64.0 + np.round((mat - p25) / np.maximum(p75 - p25, 1e-10)
                          * 128.0)
    high = 192.0 + np.round((mat - p75) / np.maximum(p100 - p75, 1e-10)
                            * 63.0)
    codes = np.where(mat < p25, low, np.where(mat <= p75, mid, high))
    codes = np.clip(codes, 0, 255).astype("u1")
    f.write(np.ascontiguousarray(codes.T).tobytes())
    return offset


def _read_mat_text(text: str) -> np.ndarray:
    body = text[text.index("[") + 1: text.index("]")]
    rows = [r for r in body.strip().split("\n") if r.strip()]
    return np.array([[float(v) for v in r.split()] for r in rows],
                    np.float32)


def read_vec_flt(f) -> np.ndarray:
    binary = f.read(2)
    if binary == b"\x00B":
        header = _read_token(f)
        dtype = {"FV": "<f4", "DV": "<f8"}.get(header)
        if dtype is None:
            raise ValueError(f"unknown vector header {header!r}")
        assert f.read(1) == b"\x04"
        n = struct.unpack("<i", f.read(4))[0]
        return np.frombuffer(f.read(n * int(dtype[2])),
                             dtype).astype(np.float32)
    rest = (binary + f.read()).decode()
    body = rest[rest.index("[") + 1: rest.index("]")]
    return np.array([float(v) for v in body.split()], np.float32)


def read_ark(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate (key, matrix) over a binary/text ark file."""
    with open(path, "rb") as f:
        while True:
            key = b""
            while True:
                c = f.read(1)
                if not c:
                    return
                if c == b" ":
                    break
                key += c
            yield key.decode(), read_mat(f)


def read_scp(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate (key, matrix) via an scp of `key ark_path:offset` lines."""
    with open(path, "r") as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if len(parts) != 2:
                continue
            key, target = parts
            ark_path, offset = target.rsplit(":", 1)
            with open(ark_path, "rb") as ark:
                ark.seek(int(offset))
                yield key, read_mat(ark)


def write_mat(f, mat: np.ndarray, key: str = "") -> int:
    """Write a binary float matrix; returns the value offset (for scp)."""
    if key:
        f.write((key + " ").encode())
    offset = f.tell()
    f.write(b"\x00BFM ")
    rows, cols = mat.shape
    f.write(b"\x04" + struct.pack("<i", rows))
    f.write(b"\x04" + struct.pack("<i", cols))
    f.write(np.ascontiguousarray(mat, "<f4").tobytes())
    return offset


def write_vec_flt(f, vec: np.ndarray, key: str = "") -> int:
    if key:
        f.write((key + " ").encode())
    offset = f.tell()
    f.write(b"\x00BFV ")
    f.write(b"\x04" + struct.pack("<i", len(vec)))
    f.write(np.ascontiguousarray(vec, "<f4").tobytes())
    return offset
