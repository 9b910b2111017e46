"""Data parallelism over several processes (the data-axis part of
``wenet_celoss_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over the global batch; the port
runs one process per rank, each over its part of the step's batch, and
makes the step equal to the one-process step on the whole batch:

- every rank pads its batch to the step's common shape (``agree_shapes``:
  one all-reduce of MAX over [B, T, U]),
  padding rows as ``pad_batch_to_multiple`` does (zeros, ``feat_lengths``
  1) and padding frames and labels as the data pipeline does (0, and -1
  for label-like entries);
- the step-global entries (``SHARED_KEYS``, and every entry without the
  batch axis) are rank 0's, broadcast as the JAX package does on
  several hosts;
- rank r holds part r of the whole batch: rows [r·B, (r+1)·B). Within
  ``step_shard`` every dropout site draws the whole batch's mask at its
  rows (``ops/dropout.py batch_part``), the batch norms take the whole
  batch's statistics (``models/convolution.py``) and a token-count
  denominator counts every rank's tokens (``token_denominator``);
- ``parallel/train.py`` all-reduces the gradients, so each rank's loss
  is its part of the global mean.

Collectives are ``all_reduce``, ``all_gather``, ``broadcast`` and
``barrier`` only (gloo has no ``reduce_scatter``). A gloo group stages
card tensors through the host.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

from wenet_celoss_tpu_torch.ops import dropout as drop

# Batch entries shared by the whole step rather than per utterance (the
# hotword list): never split or padded along the batch axis, always
# rank 0's.
SHARED_KEYS = frozenset({"context_list", "context_lengths"})
# Entries whose padding columns are labels (the pipeline pads them with
# the ignore id).
_LABEL_PAD = -1


@dataclass
class DistContext:
    """One rank of a data-parallel group."""
    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def comm_device(self) -> torch.device:
        """Where a collective's tensors live: the card for nccl, the host
        for gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     device=None, rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> DistContext:
    """Join the process group. Rank, world size and local rank come from
    the arguments or torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``); ``init_method`` defaults to ``env://``
    (``MASTER_ADDR``/``MASTER_PORT``). The rank's device is ``device``
    through ``resolve_device`` (several ranks may share one card), else
    ``cuda:<LOCAL_RANK>``, which raises when that card does not exist. The
    backend is ``backend``, else nccl on the card and gloo on the CPU; a
    backend that fails to start raises (no other is tried)."""
    from wenet_celoss_tpu_torch.models.factory import resolve_device
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
             else int(world_size))
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = resolve_device(device if device is not None else f"cuda:{local}")
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else 0
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank}: {dev} does not exist "
                               f"({torch.cuda.device_count()} cards)")
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a card; use gloo on the CPU")
    if not tdist.is_initialized():
        tdist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world)
    return DistContext(rank, world, dev, backend)


def shutdown() -> None:
    if tdist.is_initialized():
        tdist.destroy_process_group()


# ------------------------------------------------------------ batch rules
def is_batch_entry(key: str, arr: np.ndarray, b: int) -> bool:
    """The shared rule of ``mesh.py``: an entry with the batch's leading
    size that is not step-global."""
    return arr.ndim >= 1 and arr.shape[0] == b and key not in SHARED_KEYS


def pad_batch_to_multiple(batch: Dict, multiple: int) -> Dict:
    """Pad the batch axis to a multiple of ``multiple`` (JAX
    ``mesh.pad_batch_to_multiple``): padding rows are zeros, with
    ``feat_lengths`` 1 (a zero-frame row would leave an encoder mask with
    no frame) and ``keys`` "<pad>"; the batch size is read from
    ``feats``."""
    b = np.asarray(batch["feats"]).shape[0]
    return pad_batch_rows(batch, b + (-b) % multiple)


def pad_batch_rows(batch: Dict, rows: int) -> Dict:
    """Pad the batch axis to ``rows`` rows by ``pad_batch_to_multiple``'s
    rule."""
    b = np.asarray(batch["feats"]).shape[0]
    pad = rows - b
    if pad < 0:
        raise ValueError(f"batch of {b} rows is above {rows}")
    if pad == 0:
        return batch
    out = dict(batch)
    for k, v in batch.items():
        if k == "keys":
            out[k] = list(v) + ["<pad>"] * pad
            continue
        arr = np.asarray(v)
        if is_batch_entry(k, arr, b):
            fill = np.ones if k == "feat_lengths" else np.zeros
            out[k] = np.concatenate(
                [arr, fill((pad,) + arr.shape[1:], arr.dtype)], axis=0)
    return out


def split_batch(batch: Dict, part: int, parts: int) -> Dict:
    """Rows [part·B/parts, (part+1)·B/parts) of every batch entry (the
    JAX package's ``shard_batch`` placement of one data shard); shared
    entries whole. B must divide by ``parts``."""
    b = np.asarray(batch["feats"]).shape[0]
    if b % parts:
        raise ValueError(f"{b} rows do not split into {parts} parts")
    s = b // parts
    out = {}
    for k, v in batch.items():
        if k == "keys":
            out[k] = list(v)[part * s:(part + 1) * s]
            continue
        arr = np.asarray(v)
        out[k] = arr[part * s:(part + 1) * s] if is_batch_entry(k, arr, b) \
            else arr
    return out


def _pad_cols(arr: np.ndarray, n: int, fill) -> np.ndarray:
    if arr.shape[1] == n:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[1] = (0, n - arr.shape[1])
    return np.pad(arr, widths, constant_values=fill)


def _time_dims(batch: Dict, b: int):
    """(T of feats, U of the label-like [B, U] entries)."""
    u = 0
    for k, v in batch.items():
        arr = np.asarray(v) if k != "keys" else None
        if arr is not None and k != "feats" and arr.ndim == 2 \
                and is_batch_entry(k, arr, b):
            u = max(u, arr.shape[1])
    return np.asarray(batch["feats"]).shape[1], u


def agree_shapes(batch: Dict, ctx: DistContext) -> Dict:
    """This rank's batch at the step's common shape, with rank 0's
    step-global entries: one all-reduce of MAX over [B, T, U], then each
    rank pads frames (0), label columns (-1) and rows
    (``pad_batch_rows``); rank 0's step-global entries are broadcast
    (``broadcast_shared``)."""
    feats = np.asarray(batch["feats"])
    b = feats.shape[0]
    t, u = _time_dims(batch, b)
    vec = torch.tensor([b, t, u], dtype=torch.int64, device=ctx.comm_device)
    tdist.all_reduce(vec, op=tdist.ReduceOp.MAX)
    b_all, t_all, u_all = (int(x) for x in vec.tolist())
    out = dict(batch)
    shared = {}
    for k, v in batch.items():
        if k == "keys":
            continue
        arr = np.asarray(v)
        if not is_batch_entry(k, arr, b):
            shared[k] = arr
        elif k == "feats":
            out[k] = _pad_cols(arr, t_all, 0)
        elif arr.ndim == 2:
            out[k] = _pad_cols(arr, u_all, _LABEL_PAD)
    out = pad_batch_rows(out, b_all)
    out.update(broadcast_shared(shared, ctx))
    return out


def broadcast_shared(shared: Dict[str, np.ndarray],
                     ctx: DistContext) -> Dict[str, np.ndarray]:
    """Rank 0's step-global entries (the hotword list, its lengths, its
    count) on every rank, as the JAX package broadcasts process 0's on
    several hosts. Each rank's per-utterance ``hw_labels`` stay its own
    (ROADMAP.md Queue C records that they were built against its own
    list)."""
    obj = [shared if ctx.rank == 0 else None]
    tdist.broadcast_object_list(obj, src=0, device=ctx.comm_device)
    return obj[0]


# ----------------------------------------------------------- the step shard
_STEP: Optional[DistContext] = None


@contextlib.contextmanager
def step_shard(ctx: Optional[DistContext]) -> Iterator[None]:
    """Within the block, the model's forward and backward treat the batch
    as part ``ctx.rank`` of ``ctx.world`` (the module docstring); None
    leaves the one-process step."""
    global _STEP
    if ctx is None or ctx.world == 1:
        yield
        return
    old, _STEP = _STEP, ctx
    try:
        with drop.batch_part(ctx.rank, ctx.world):
            yield
    finally:
        _STEP = old


def active() -> Optional[DistContext]:
    """The step's group inside ``step_shard``, else None."""
    return _STEP


def all_reduce_sum(t: torch.Tensor, ctx: DistContext) -> torch.Tensor:
    """The SUM over ranks of ``t`` (a new tensor on t's device)."""
    buf = t.detach().to(ctx.comm_device, copy=True)
    tdist.all_reduce(buf)
    return buf.to(t.device)


def token_denominator(count: torch.Tensor) -> float:
    """A token-count denominator: max(count, 1) in one process; inside
    ``step_shard`` max(every rank's count, 1) / ranks, so that the mean of
    the ranks' losses divides by the whole batch's count."""
    ctx = active()
    if ctx is None:
        return float(max(int(count), 1))
    total = all_reduce_sum(count.reshape(1).to(torch.float64), ctx)
    return max(float(total), 1.0) / ctx.world


def flatten(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def all_reduce_mean_(tensors: List[torch.Tensor],
                     ctx: DistContext) -> List[torch.Tensor]:
    """The mean over ranks of each tensor, through one flat fp32 buffer
    in the given order (summed, then divided by the world size); returns
    new tensors shaped and typed as the inputs."""
    if not tensors:
        return []
    flat = flatten([t.float() for t in tensors]).to(ctx.comm_device)
    tdist.all_reduce(flat)
    flat = (flat / ctx.world).to(tensors[0].device)
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[at:at + n].view(t.shape).to(t.dtype))
        at += n
    return out


@torch.no_grad()
def broadcast_module_(module: torch.nn.Module, ctx: DistContext) -> None:
    """Rank 0's parameters and buffers on every rank, in place (one
    broadcast a dtype, in ``state_dict`` order)."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in module.state_dict().values():
        by_dtype.setdefault(t.dtype, []).append(t)
    for tensors in by_dtype.values():
        flat = flatten(tensors).to(ctx.comm_device)
        tdist.broadcast(flat, src=0)
        at = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[at:at + n].view(t.shape))
            at += n


def all_have_next(have: bool, ctx: DistContext) -> bool:
    """True while every rank has a next batch (one all-reduce of MIN)."""
    flag = torch.tensor([1 if have else 0], dtype=torch.int32,
                        device=ctx.comm_device)
    tdist.all_reduce(flag, op=tdist.ReduceOp.MIN)
    return bool(int(flag.item()))


def all_gather_rows(t: torch.Tensor, ctx: DistContext,
                    fill=0) -> torch.Tensor:
    """Every rank's ``t`` stacked along the batch axis in rank order.
    Ranks bring equal row counts; other axes may differ and are padded to
    the largest with ``fill`` first (one all-reduce of MAX over them)."""
    shape = torch.tensor(list(t.shape), dtype=torch.int64,
                         device=ctx.comm_device)
    tdist.all_reduce(shape, op=tdist.ReduceOp.MAX)
    want = [int(x) for x in shape.tolist()]
    if want[0] != t.shape[0]:
        raise ValueError(f"ranks bring {t.shape[0]} and {want[0]} rows")
    if list(t.shape) != want:
        full = torch.full(want, fill, dtype=t.dtype, device=t.device)
        full[tuple(slice(0, n) for n in t.shape)] = t
        t = full
    src = t.contiguous().to(ctx.comm_device)
    parts = [torch.empty_like(src) for _ in range(ctx.world)]
    tdist.all_gather(parts, src)
    return torch.cat(parts, dim=0).to(t.device)


def barrier(ctx: Optional[DistContext]) -> None:
    if ctx is not None and ctx.world > 1:
        tdist.barrier()
