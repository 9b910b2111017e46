"""Checkpoints: the JAX package's format read, the port's own written
(port of ``wenet_celoss_tpu/utils/checkpoint.py``).

- A JAX checkpoint (``<n>.ckpt``, ``final.ckpt``) is the flax parameter
  tree written by ``flax.serialization.to_bytes``: msgpack with flax's
  ext types (code 1 an ndarray, code 3 a numpy scalar: each a msgpack
  [shape, dtype name, raw little-endian C-order bytes]; code 2 a complex)
  and arrays above flax's chunk limit split into a
  ``__msgpack_chunked_array__`` dict. The machine with the card has no
  ``msgpack`` and no ``flax``, so :func:`msgpack_restore` decodes it with
  a reader of its own; ``utils/convert.py params_from_jax`` maps the tree
  onto the port's ``state_dict``.
- The port's own epoch file (extension ``.pt``) is ``torch.save`` of the
  ``state_dict``: parameters and the batch norms' running statistics
  (a JAX epoch file holds ``params`` only).
- A full-state file (``step_<n>.state``) is ``torch.save`` of
  ``TrainState.state_dict()`` plus the executor's generator state, for a
  kill and resume mid-epoch. It is written atomically (a tmp file, then
  ``os.replace``) by a background thread; :func:`wait_pending` waits.
- Each file has a sidecar of infos (epoch, step, cv_loss, lr, ...): the
  path less a final ``.mspk`` or ``.state``, plus ``.yaml`` (``3.pt`` →
  ``3.pt.yaml``, ``step_8.state`` → ``step_8.yaml``), the JAX package's
  naming, written and read by ``utils/config.py`` (no PyYAML).

A JAX checkpoint holds ``params`` only: a ``batch_norm`` model loaded from
one keeps the running statistics it was built with, as the JAX CLI does
(init, then the params replaced), and a model with a global CMVN keeps
the statistics of its config's cmvn_file.
"""

from __future__ import annotations

import glob
import os
import re
import struct
import threading
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from wenet_celoss_tpu_torch.utils.config import dump_yaml, parse_yaml
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


def infos_path(path: str) -> str:
    """The sidecar of infos beside a checkpoint (the JAX package's rule)."""
    return re.sub(r"\.(mspk|state)$", "", str(path)) + ".yaml"


def _write_infos(path: str, infos: Dict) -> None:
    info = infos_path(path)
    tmp = info + ".tmp"
    with open(tmp, "w", encoding="utf8") as f:
        f.write(dump_yaml(infos))
    os.replace(tmp, info)


def load_checkpoint_infos(path: str) -> Dict:
    info = infos_path(path)
    if os.path.exists(info):
        with open(info, encoding="utf8") as f:
            return parse_yaml(f.read()) or {}
    return {}


StateDict = Dict[str, torch.Tensor]


def save_checkpoint(model: Union[nn.Module, StateDict], path: str,
                    infos: Optional[Dict] = None) -> None:
    """The port's own format: ``torch.save`` of the ``state_dict`` (of a
    model, or given) on the CPU at ``path`` (extension ``.pt``), and its
    sidecar of ``infos``."""
    if not str(path).endswith(".pt"):
        raise ValueError(f"{path}: the port's checkpoints end in .pt")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    torch.save({k: v.detach().cpu() for k, v in sd.items()}, path)
    _write_infos(path, infos or {})


_PENDING: List[threading.Thread] = []
_FAILED: List[BaseException] = []


def _atomic_save(payload: Dict, path: str, infos: Optional[Dict]) -> None:
    try:
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        if infos is not None:
            _write_infos(path, infos)
    except BaseException as e:  # noqa: BLE001 - re-raised by wait_pending
        _FAILED.append(e)


def save_train_state(state, path: str, infos: Optional[Dict] = None,
                     gen: Optional[torch.Generator] = None) -> None:
    """Full-state checkpoint of a ``parallel/train.py`` ``TrainState``
    (parameters, running statistics, Adam's count and moments, step) and
    the state of ``gen``. The copy to the host is synchronous (training
    goes on updating the tensors in place); the write runs in a
    background thread (:func:`wait_pending` waits for it)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = state.state_dict()
    payload["gen"] = None if gen is None else gen.get_state()
    t = threading.Thread(target=_atomic_save, args=(payload, path, infos),
                         daemon=True)
    t.start()
    _PENDING.append(t)


def wait_pending() -> None:
    """Block until every background write has landed; raise the first
    error a write met."""
    while _PENDING:
        _PENDING.pop().join()
    if _FAILED:
        err = _FAILED[0]
        _FAILED.clear()
        raise RuntimeError("a checkpoint write failed") from err


def load_train_state(state, path: str,
                     gen: Optional[torch.Generator] = None):
    """Restore a file of :func:`save_train_state` into ``state`` (in
    place, on its model's device) and ``gen``; returns ``state``."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.load_state_dict(payload)
    if gen is not None:
        if payload.get("gen") is None:
            raise KeyError(f"{path}: no generator state")
        gen.set_state(payload["gen"])
    return state


def _in_modules(key: str, modules: List[str]) -> bool:
    return any(key.split(".")[0] == m or key.startswith(m) for m in modules)


def filter_modules(sd: StateDict, modules: List[str]) -> StateDict:
    """The entries of a ``state_dict`` under the top-level modules named
    (a key's first component equal to one, or the key starting with it)."""
    return {k: v for k, v in sd.items() if _in_modules(k, modules)}


@torch.no_grad()
def load_trained_modules(model: nn.Module, ckpt_path: str,
                         modules: List[str]) -> None:
    """Warm-start the listed modules of ``model`` from a checkpoint (JAX
    or ``.pt``) in place; the rest keep their values."""
    loaded = filter_modules(load_checkpoint(ckpt_path), modules)
    own = model.state_dict()
    for k, v in loaded.items():
        if k in own:
            own[k].copy_(v)


def average_checkpoints(paths: List[str]) -> StateDict:
    """The uniform average of the checkpoints' ``state_dict`` entries, in
    float64, cast back to each entry's dtype in the first checkpoint."""
    if not paths:
        raise ValueError("no checkpoints to average")
    acc = first = None
    for p in paths:
        sd = load_checkpoint(p)
        if first is None:
            first = sd
            acc = {k: v.double() for k, v in sd.items()}
        else:
            for k in acc:
                acc[k] += sd[k].double()
    n = float(len(paths))
    return {k: (acc[k] / n).to(first[k].dtype) for k in acc}


def select_checkpoints(model_dir: str, num: int, val_best: bool = True,
                       min_epoch: int = 0, max_epoch: int = 65536
                       ) -> List[str]:
    """Last-N, or N-best by the infos' ``cv_loss``, of the epoch files
    ``<model_dir>/[0-9]*.pt`` with ``min_epoch <= epoch <= max_epoch``."""
    infos = []
    for p in glob.glob(os.path.join(model_dir, "[0-9]*.pt")):
        meta = load_checkpoint_infos(p)
        epoch = meta.get("epoch", -1)
        if not (min_epoch <= epoch <= max_epoch):
            continue
        infos.append((p, meta.get("cv_loss", float("inf")), epoch))
    if val_best:
        infos.sort(key=lambda x: x[1])
    else:
        infos.sort(key=lambda x: -x[2])
    return [p for p, _, _ in infos[:num]]


# Buffers a JAX checkpoint (``params``) does not hold: the batch norms'
# running statistics (its ``batch_stats``) and the global CMVN, which both
# packages build from the config's cmvn_file.
_NOT_IN_JAX = (".running_mean", ".running_var", "encoder.cmvn_mean",
               "encoder.cmvn_istd")


def load_into(model: nn.Module, path: str) -> None:
    """Load a checkpoint into ``model``. Every key of the checkpoint must
    be the model's, and a ``.pt`` must hold every key of the model; a JAX
    checkpoint may lack only the running statistics and the CMVN
    buffers, which keep the model's values."""
    state = load_checkpoint(path)
    dev = next(model.parameters()).device
    missing, unexpected = model.load_state_dict(
        {k: v.to(dev) for k, v in state.items()}, strict=False)
    allowed = [k for k in missing if k.endswith(_NOT_IN_JAX)]
    if unexpected or len(allowed) != len(missing) or (
            missing and str(path).endswith(".pt")):
        raise KeyError(f"{path}: checkpoint does not match the model: "
                       f"missing {missing}, unexpected {unexpected}")
