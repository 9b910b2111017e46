"""Checkpoints, read side (port of the loading half of
``wenet_celoss_tpu/utils/checkpoint.py``) and the port's own format.

- A JAX checkpoint (``<n>.ckpt``, ``final.ckpt``) is the flax parameter
  tree written by ``flax.serialization.to_bytes``: msgpack with flax's
  ext types (code 1 an ndarray, code 3 a numpy scalar: each a msgpack
  [shape, dtype name, raw little-endian C-order bytes]; code 2 a complex)
  and arrays above flax's chunk limit split into a
  ``__msgpack_chunked_array__`` dict. The machine with the card has no
  ``msgpack`` and no ``flax``, so :func:`msgpack_restore` decodes it with
  a reader of its own; ``utils/convert.py params_from_jax`` maps the tree
  onto the port's ``state_dict``.
- The port's own format (extension ``.pt``) is ``torch.save`` of the
  ``state_dict``.

A JAX checkpoint holds ``params`` only: a ``batch_norm`` model loaded from
one keeps the running statistics it was built with, as the JAX CLI does
(init, then the params replaced).
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from wenet_celoss_tpu_torch.utils.convert import params_from_jax

CHUNKED = "__msgpack_chunked_array__"


class _Unpacker:
    """A msgpack decoder for maps, arrays, str, bin, ints, floats, nil,
    bools and flax's ext types. Map keys and str come back as str, arrays
    as lists; ndarrays as numpy arrays (bfloat16 ones as torch tensors:
    numpy has no bfloat16)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",        # bin
                 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",        # str
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}        # ext
        if b in sized:
            n = self._unpack(sized[b])
            if b in (0xC4, 0xC5, 0xC6):
                return bytes(self._take(n))
            if b in (0xD9, 0xDA, 0xDB):
                return str(self._take(n), "utf-8")
            if b in (0xDC, 0xDD):
                return [self.value() for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self._map(n)
            return self._ext(self._unpack(">b"), n)
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self._unpack(fixed[b])
        if 0xD4 <= b <= 0xD8:
            return self._ext(self._unpack(">b"), 1 << (b - 0xD4))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def _map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def _ext(self, code: int, n: int) -> Any:
        payload = bytes(self._take(n))
        if code == 2:
            real, imag = _Unpacker(payload).value()
            return complex(real, imag)
        if code not in (1, 3):
            raise ValueError(f"msgpack ext type {code} is not supported")
        shape, name, buf = _Unpacker(payload).value()
        if isinstance(name, bytes):
            name = name.decode()
        if name == "bfloat16":
            arr = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
            arr = arr.reshape(shape)
            return arr if code == 1 else arr.reshape(())
        dtype = np.dtype(name).newbyteorder("<")
        arr = np.frombuffer(buf, dtype=dtype).reshape(shape).copy()
        return arr if code == 1 else arr[()]


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get(CHUNKED) is True:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes) -> Any:
    """flax msgpack bytes → the tree of dicts and array leaves that
    ``flax.serialization.msgpack_restore`` returns, chunked arrays joined."""
    reader = _Unpacker(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                         "msgpack object")
    return _unchunk(tree)


def _float_leaves(tree: Any) -> Any:
    """bfloat16 leaves as float32 numpy arrays (exact)."""
    if isinstance(tree, dict):
        return {k: _float_leaves(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` in a checkpoint, on the CPU: the port's own
    (``.pt``) as saved, a JAX one (flax msgpack of ``params``) through the
    weight bridge."""
    if str(path).endswith(".pt"):
        return torch.load(path, map_location="cpu", weights_only=True)
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    return params_from_jax({"params": _float_leaves(tree)})


def save_checkpoint(model: nn.Module, path: str) -> None:
    """The port's own format: ``torch.save`` of the ``state_dict`` (on the
    CPU) at ``path`` (extension ``.pt``)."""
    if not str(path).endswith(".pt"):
        raise ValueError(f"{path}: the port's checkpoints end in .pt")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)


def load_into(model: nn.Module, path: str) -> None:
    """Load a checkpoint into ``model``. Every key of the checkpoint must
    be the model's; a JAX checkpoint may lack only the batch norms'
    running statistics (it holds ``params``, not ``batch_stats``)."""
    state = load_checkpoint(path)
    dev = next(model.parameters()).device
    missing, unexpected = model.load_state_dict(
        {k: v.to(dev) for k, v in state.items()}, strict=False)
    stats = [k for k in missing
             if k.endswith((".running_mean", ".running_var"))]
    if unexpected or len(stats) != len(missing) or (
            stats and str(path).endswith(".pt")):
        raise KeyError(f"{path}: checkpoint does not match the model: "
                       f"missing {missing}, unexpected {unexpected}")
