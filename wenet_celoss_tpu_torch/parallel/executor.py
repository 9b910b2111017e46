"""Epoch train and cv loops (port of ``wenet_celoss_tpu/parallel/executor.py``).

Gradient accumulation over ``accum_grad`` micro-batches (a partial
accumulation left at the end of an epoch is dropped), the clip and the
non-finite skip of ``parallel/train.py``, a log line and a metrics
record every ``log_interval`` batches, a full-state checkpoint every
``checkpoint_every`` optimizer steps, and the cv loss as the batch-weighted
mean of the finite batch losses.

One CPU ``torch.Generator`` (seed 0 unless given) gives every step its
dropout seeds and, for a dynamic-chunk encoder, its chunk; a step draws
from it in order, so a run resumed with the generator's saved state draws
what the uninterrupted run drew.

Data parallel (``group``, a ``parallel/dist.py DistContext``; every rank
runs an Executor over its own part of the training list): each batch is
brought to the step's common shape with rank 0's hotword list
(``dist.agree_shapes``) and stepped over the group (``parallel/train.py``);
every rank stops at the shortest rank's batch count (``_joined``, the
JAX executor's even stepping: one all-reduce of MIN a batch), so a
partial accumulation is dropped on every rank alike. Only rank 0 calls
``metrics_writer`` and ``checkpoint_fn``. The cv pass runs on every rank
over the whole cv list, without the group (no collective), as in JAX.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from wenet_celoss_tpu_torch.parallel import dist
from wenet_celoss_tpu_torch.parallel import train as T


class Executor:
    def __init__(self, model, tx, schedule: Callable[[int], float],
                 accum_grad: int = 1, log_interval: int = 100,
                 gen: Optional[torch.Generator] = None,
                 checkpoint_every: int = 0, checkpoint_fn=None,
                 metrics_writer: Optional[Callable[[Dict], None]] = None,
                 group: Optional[dist.DistContext] = None):
        self.device = next(model.parameters()).device
        self.group = group if group is not None and group.world > 1 \
            else None
        self.writer = self.group is None or self.group.rank == 0
        self.accum_grad = accum_grad
        self.log_interval = log_interval
        # checkpoint_fn(state, gen) every `checkpoint_every` optimizer
        # steps (a mid-epoch kill and resume).
        self.checkpoint_every = checkpoint_every
        self.checkpoint_fn = checkpoint_fn
        # Called with one flat dict a logged batch (metrics.jsonl).
        self.metrics_writer = metrics_writer
        self.grad_fn = T.make_grad_fn(model, accum_grad, self.group)
        self.apply_fn = T.make_apply_fn(tx, self.group)
        self.train_step = (T.make_train_step(model, tx, group=self.group)
                           if accum_grad == 1 else None)
        self.eval_fn = T.make_eval_fn(model)
        self.schedule = schedule
        self.gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.step = 0

    def _place(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The batch's arrays on the model's device (integers as int64),
        without ``keys``."""
        out = {}
        for k, v in batch.items():
            if k == "keys":
                continue
            arr = np.asarray(v)
            dtype = torch.long if arr.dtype.kind in "iu" else None
            out[k] = torch.as_tensor(arr, dtype=dtype, device=self.device)
        return out

    def _joined(self, data: Iterable[Dict]):
        """The batches while every rank of the group has one (JAX
        ``Executor._joined``): ranks with unequal lists all stop at the
        shortest's count instead of one waiting in a collective that the
        others never join."""
        if self.group is None:
            yield from data
            return
        it = iter(data)
        while True:
            nxt = next(it, None)
            if not dist.all_have_next(nxt is not None, self.group):
                return
            yield nxt

    def train_epoch(self, state: T.TrainState, data: Iterable[Dict],
                    epoch: int = 0) -> T.TrainState:
        acc = None
        n_acc = 0
        t0 = time.time()
        frames = 0
        for batch_idx, batch in enumerate(self._joined(data)):
            frames += int(np.sum(batch["feat_lengths"]))
            if self.group is not None:
                batch = dist.agree_shapes(batch, self.group)
            placed = self._place(batch)
            stepped = False
            if self.train_step is not None:
                state, metrics, gnorm = self.train_step(state, placed,
                                                        self.gen)
                self.step = state.step
                stepped = True
            else:
                grads, metrics = self.grad_fn(state, placed, self.gen)
                acc = T.accumulate(acc, grads)
                n_acc += 1
                if n_acc >= self.accum_grad:
                    state, gnorm = self.apply_fn(state, acc)
                    acc, n_acc = None, 0
                    self.step = state.step
                    stepped = True
            if (stepped and self.writer and self.checkpoint_every > 0
                    and self.checkpoint_fn is not None
                    and self.step % self.checkpoint_every == 0):
                self.checkpoint_fn(state, self.gen)
            if batch_idx % self.log_interval == 0:
                lr = float(self.schedule(max(self.step, 1)))
                elapsed = time.time() - t0
                audio_sps = frames / 100.0 / max(elapsed, 1e-6)
                logging.info("epoch %d batch %d loss %.4f lr %.6g "
                             "audio-s/s %.1f", epoch, batch_idx,
                             float(metrics["loss"]), lr, audio_sps)
                if self.metrics_writer is not None and self.writer:
                    rec = {"epoch": epoch, "batch": batch_idx,
                           "step": self.step, "lr": lr,
                           "audio_s_per_s": round(audio_sps, 2)}
                    for k, v in metrics.items():
                        try:
                            rec[k] = float(v)
                        except (TypeError, ValueError, RuntimeError):
                            pass  # None or not a scalar
                    if stepped:
                        rec["grad_norm"] = float(gnorm)
                    self.metrics_writer(rec)
        return state

    def cv(self, state: T.TrainState, data: Iterable[Dict]) -> float:
        total, count = 0.0, 0
        for batch in data:
            metrics = self.eval_fn(state, self._place(batch))
            loss = float(metrics["loss"])
            if math.isfinite(loss):
                b = len(batch["keys"])
                total += loss * b
                count += b
        return total / max(count, 1)
