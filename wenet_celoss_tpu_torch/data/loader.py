"""Sharded multi-process batch loader (port of
``wenet_celoss_tpu/data/loader.py``).

``Dataset``'s thread pool parallelises only the featurize stage (numpy
releases the GIL there); the GIL-held stages (read, tokenize, spec_aug,
batching, padding, hotword sampling) stay serial. ``MultiProcessLoader``
runs the whole chain in ``num_workers`` spawned processes, each over a
disjoint shard of the data list, and streams finished padded batches back
over bounded queues; the parent pops round-robin, so the batch order does
not depend on worker scheduling.

Workers are spawned (the parent holds a CUDA context, and forking a
process that holds one is undefined), with the card hidden from them
(``CUDA_VISIBLE_DEVICES=""``): a worker never creates a CUDA context.
Each runs its chain serially on one BLAS/OpenMP thread.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import time
from typing import Dict, Iterator, List, Optional

_SENTINEL = ("__end__", None)
# Finished batches a worker may hold in its queue: bounds host memory.
_QUEUE_DEPTH = 2
# The spawned workers' environment: no card, one BLAS/OpenMP thread each
# (a worker owns one core; spinning BLAS threads of several workers on
# the same cores cost 4x the CPU time of the same work in one thread).
_WORKER_ENV = (("CUDA_VISIBLE_DEVICES", ""), ("OMP_NUM_THREADS", "1"),
               ("OPENBLAS_NUM_THREADS", "1"), ("MKL_NUM_THREADS", "1"))


def _get(q, proc, w: int):
    """The next message of worker ``w``; raises if the worker has exited
    without sending its sentinel (killed, or crashed in native code), which
    a plain blocking ``get`` would wait for forever."""
    while True:
        try:
            return q.get(timeout=1.0)
        except queue_mod.Empty:
            if proc.is_alive():
                continue
        try:  # what the worker sent just before it exited
            return q.get(timeout=1.0)
        except queue_mod.Empty:
            raise RuntimeError(f"loader worker {w} exited with code "
                               f"{proc.exitcode} before its end of "
                               f"data") from None


def _worker_main(queue, data_type, list_file, symbol_table, conf,
                 bpe_model, non_lang_syms, rank, world_size, epoch):
    try:
        from wenet_celoss_tpu_torch.data.dataset import Dataset
        # Handshake: the imports are done, so the parent can tell one-time
        # interpreter start-up from pipeline work.
        queue.put(("ready", None))
        ds = Dataset(data_type, list_file, symbol_table, conf,
                     bpe_model=bpe_model, non_lang_syms=non_lang_syms,
                     partition=True, rank=rank, world_size=world_size)
        ds.set_epoch(epoch)
        for batch in ds:
            queue.put(("batch", batch))
    except Exception as e:  # the parent re-raises it
        queue.put(("error", f"{type(e).__name__}: {e}"))
    finally:
        queue.put(_SENTINEL)


class MultiProcessLoader:
    """Iterable over padded batches made by ``num_workers`` processes,
    each running the whole chain on a disjoint shard of the data list.

    Worker ``w`` of rank ``r`` takes ``lists[r * num_workers + w ::
    world_size * num_workers]`` of the epoch's shuffled list (every
    process shuffles with the same epoch seed, so the shards are disjoint
    and cover the list). ``partition=False`` (every rank sees the whole
    list) still shards among this loader's workers. ``startup_s`` is the
    seconds from the first spawn until every worker finished its imports,
    set on each pass.
    """

    def __init__(self, data_type: str, list_file: str,
                 symbol_table: Dict[str, int], conf: Dict,
                 bpe_model: Optional[str] = None,
                 non_lang_syms: Optional[List[str]] = None,
                 partition: bool = True, rank: int = 0,
                 world_size: int = 1, num_workers: int = 2):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        # The chain inside a worker runs serially: no thread pool and no
        # prefetch thread of its own.
        conf = dict(conf, num_workers=0, prefetch=0)
        self.args = (data_type, list_file, symbol_table, conf, bpe_model,
                     non_lang_syms)
        self.partition = partition
        self.rank = rank
        self.world_size = world_size
        self.num_workers = num_workers
        self.epoch = 0
        self.startup_s = 0.0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _shard(self, w: int):
        if self.partition:
            return (self.rank * self.num_workers + w,
                    self.world_size * self.num_workers)
        return w, self.num_workers

    def __iter__(self) -> Iterator[Dict]:
        ctx = mp.get_context("spawn")
        queues, procs = [], []
        t0 = time.perf_counter()
        saved = {k: os.environ.get(k) for k, _ in _WORKER_ENV}
        os.environ.update(dict(_WORKER_ENV))
        try:
            for w in range(self.num_workers):
                q = ctx.Queue(maxsize=_QUEUE_DEPTH)
                p = ctx.Process(target=_worker_main,
                                args=(q,) + self.args + self._shard(w)
                                + (self.epoch,), daemon=True)
                p.start()
                queues.append(q)
                procs.append(p)
        finally:
            for k, old in saved.items():
                if old is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = old
        live = list(range(self.num_workers))
        pending = [None] * self.num_workers
        try:
            # Every worker's import handshake first (they import at the
            # same time); a worker that fails its imports sends error and
            # sentinel instead, kept for the rotation below.
            for w in range(self.num_workers):
                kind, payload = _get(queues[w], procs[w], w)
                if kind != "ready":
                    pending[w] = (kind, payload)
            self.startup_s = time.perf_counter() - t0
            while live:
                next_live = []
                for w in live:
                    if pending[w] is not None:
                        kind, payload = pending[w]
                        pending[w] = None
                    else:
                        kind, payload = _get(queues[w], procs[w], w)
                    if kind == "batch":
                        next_live.append(w)
                        yield payload
                    elif kind == "error":
                        raise RuntimeError(
                            f"loader worker {w} failed: {payload}")
                    # the sentinel drops the worker from the rotation
                live = next_live
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=5)


def make_loader(data_type, list_file, symbol_table, conf, **kw):
    """``conf["loader_processes"] > 0`` selects the multi-process loader,
    else the in-process ``Dataset`` chain."""
    from wenet_celoss_tpu_torch.data.dataset import Dataset
    n = int(conf.get("loader_processes", 0) or 0)
    if n > 0:
        return MultiProcessLoader(data_type, list_file, symbol_table,
                                  conf, num_workers=n, **kw)
    return Dataset(data_type, list_file, symbol_table, conf, **kw)
