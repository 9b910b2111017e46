"""Training step: optimizer, gradient accumulation, non-finite skip (port
of ``wenet_celoss_tpu/parallel/train.py``).

The JAX package chains optax's ``clip_by_global_norm``, ``scale_by_adam``
and ``scale_by_learning_rate(warmup_lr)``; ``ClippedAdam`` writes that
chain out, because torch's own clip (``/ (norm + 1e-6)``) and Adam (its
step advances on a skipped update) do not compute the same thing:

- the clip scales by ``max_norm / norm`` only when ``norm >= max_norm``;
- Adam: b1 0.9, b2 0.999, eps 1e-8, bias-corrected by the count of
  applied updates;
- the learning rate is the schedule at that count, from 0 (and
  ``warmup_lr`` clamps it to at least 1);
- a non-finite global norm skips the update: parameters AND optimizer
  state stay as they were, only ``state.step`` advances.

State is updated in place (the model holds the fp32 parameters; the
optimizer's moments are fp32 tensors beside them), where the JAX package
returns a new pytree. Dropout draws its seeds from the caller's
``torch.Generator``, and so does a ``use_dynamic_chunk`` encoder (U2++)
its chunk, first in each training forward (the JAX package splits its step
key for the two); such a model raises when it trains without a generator.
The generator is a CPU one, so a seed draws the same chunk on the CPU and
on the card. The compute dtype (bf16 or fp32) is the model's.
Reported ``gnorm`` is the pre-clip global norm.

The gradient and training-step functions put the model in training mode
and the evaluation function in eval mode. A batch_norm conv module's
running statistics (the JAX package's ``TrainState.batch_stats``) are the
model's buffers: each training forward advances them, on every
micro-batch and on a step whose norm is not finite too, as the JAX
package's executor and ``train_step`` do.

Data parallel (``group``, a ``parallel/dist.py DistContext``): each rank
runs the forward and backward on its part of the step's batch inside
``dist.step_shard`` (the whole batch's dropout masks, batch-norm
statistics and token counts), the metrics are averaged over the ranks,
and before the norm the (accumulated) gradients are all-reduced in one
flat buffer in parameter order, summed and divided by the world size.
Clipping, the non-finite skip and Adam then see the same gradient on
every rank, so the parameters stay equal bit for bit. Every rank seeds
its generator alike, so the dropout seeds and the dynamic chunk agree.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from wenet_celoss_tpu_torch.parallel import dist
from wenet_celoss_tpu_torch.utils.scheduler import warmup_lr

Batch = Dict[str, torch.Tensor]
Grads = List[torch.Tensor]


@dataclass
class AdamState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: AdamState

    @property
    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())

    def state_dict(self) -> Dict:
        """The whole state as CPU copies: ``step`` (batches that reached
        the optimizer, skipped ones too), the model's ``state_dict``
        (parameters and the batch norms' running statistics) and Adam's
        ``count`` (applied updates; the learning rate reads it), ``mu``
        and ``nu`` in parameter order."""
        def cpu(t):
            return t.detach().to("cpu", copy=True)
        opt = self.opt_state
        return {"step": int(self.step),
                "model": {k: cpu(v) for k, v in
                          self.model.state_dict().items()},
                "opt": {"count": int(opt.count),
                        "mu": [cpu(t) for t in opt.mu],
                        "nu": [cpu(t) for t in opt.nu]}}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict) -> None:
        """Restore :meth:`state_dict`'s output in place, onto the model's
        device."""
        self.model.load_state_dict(sd["model"])
        opt = self.opt_state
        for name in ("mu", "nu"):
            dst, src = getattr(opt, name), sd["opt"][name]
            if len(dst) != len(src):
                raise ValueError(f"{name}: {len(src)} tensors in the state, "
                                 f"{len(dst)} parameters in the model")
            for d, v in zip(dst, src):
                d.copy_(v)
        opt.count = int(sd["opt"]["count"])
        self.step = int(sd["step"])


def global_norm(grads: Grads) -> torch.Tensor:
    """sqrt of the sum of squares of every element (fp32 scalar)."""
    return torch.linalg.vector_norm(torch.stack(
        [n.float() for n in torch._foreach_norm(grads)]))


class ClippedAdam:
    """clip_by_global_norm → scale_by_adam → scale by -schedule(count)."""

    def __init__(self, grad_clip: float, schedule: Callable[[int], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.grad_clip = float(grad_clip)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: List[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def apply(self, grads: Grads, gnorm: torch.Tensor, state: AdamState,
              params: List[torch.Tensor]) -> None:
        """One update of ``params`` and ``state`` in place, given the
        finite pre-clip norm ``gnorm`` of ``grads``."""
        if float(gnorm) >= self.grad_clip:
            grads = torch._foreach_div(grads, gnorm)
            torch._foreach_mul_(grads, self.grad_clip)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1 - b2)
        lr = self.schedule(state.count)
        state.count += 1
        mu_hat = torch._foreach_div(state.mu, 1 - b1 ** state.count)
        nu_hat = torch._foreach_div(state.nu, 1 - b2 ** state.count)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(params, updates, alpha=-lr)


def make_optimizer(configs: Dict) -> Tuple[ClippedAdam, Callable]:
    optim_conf = configs.get("optim_conf", {})
    lr = optim_conf.get("lr", 0.002)
    sched_conf = configs.get("scheduler_conf", {})
    schedule = warmup_lr(lr, sched_conf.get("warmup_steps", 25000))
    return ClippedAdam(configs.get("grad_clip", 5.0), schedule), schedule


def create_train_state(model: nn.Module, tx: ClippedAdam) -> TrainState:
    return TrainState(step=0, model=model,
                      opt_state=tx.init(list(model.parameters())))


def _forward(model: nn.Module, batch: Batch,
             gen: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
    args = (batch["feats"], batch["feat_lengths"], batch["labels"],
            batch["label_lengths"])
    if "context_list" in batch:
        args += (batch["context_list"], batch["context_lengths"],
                 batch.get("hw_labels"), batch.get("context_n_valid"))
    return model(*args, gen=gen)


def make_grad_fn(model: nn.Module, accum_grad: int = 1,
                 group: Optional[dist.DistContext] = None):
    """(state, batch, gen) → (grads, metrics): the gradients of
    ``loss / accum_grad`` in parameter order (zeros for a parameter the
    loss does not reach, as JAX gives), and the detached loss dict. The
    batch holds feats, feat_lengths, labels, label_lengths on the model's
    device and, for a transducer with hotwords, context_list,
    context_lengths and optionally hw_labels and context_n_valid;
    ``gen`` is the step's generator (dropout seeds, the dynamic chunk).
    With ``group`` the batch is this rank's part of the step's batch (the
    module docstring): the gradients stay this rank's, the metrics are
    the means over the ranks."""

    def grad_fn(state: TrainState, batch: Batch,
                gen: Optional[torch.Generator]):
        state.model.train()
        params = state.params
        with dist.step_shard(group):
            metrics = _forward(state.model, batch, gen)
            grads = torch.autograd.grad(metrics["loss"] / accum_grad,
                                        params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        if group is not None and group.world > 1:
            names = sorted(metrics)
            metrics = dict(zip(names, dist.all_reduce_mean_(
                [metrics[k] for k in names], group)))
        return grads, metrics

    return grad_fn


def make_apply_fn(tx: ClippedAdam, group: Optional[dist.DistContext] = None):
    """(state, grads) → (state, pre-clip gnorm); a non-finite norm leaves
    parameters and optimizer state as they were. With ``group`` the
    gradients are first averaged over the ranks."""

    def apply_fn(state: TrainState, grads: Grads):
        if group is not None and group.world > 1:
            grads = dist.all_reduce_mean_(list(grads), group)
        gnorm = global_norm(grads)
        if math.isfinite(float(gnorm)):
            tx.apply(grads, gnorm, state.opt_state, state.params)
        state.step += 1
        return state, gnorm

    return apply_fn


def make_train_step(model: nn.Module, tx: ClippedAdam, accum_grad: int = 1,
                    group: Optional[dist.DistContext] = None):
    """(state, batch, gen) → (state, metrics, gnorm): gradient, clip and
    update in one call (over the ranks of ``group``, if given)."""
    grad_fn = make_grad_fn(model, accum_grad, group)
    apply_fn = make_apply_fn(tx, group)

    def train_step(state: TrainState, batch: Batch,
                   gen: Optional[torch.Generator]):
        grads, metrics = grad_fn(state, batch, gen)
        state, gnorm = apply_fn(state, grads)
        return state, metrics, gnorm

    return train_step


def make_eval_fn(model: nn.Module):
    """(state, batch) → the loss dict without dropout or gradients."""

    @torch.no_grad()
    def eval_fn(state: TrainState, batch: Batch):
        state.model.eval()
        return _forward(state.model, batch, None)

    return eval_fn


def accumulate(acc: Optional[Grads], grads: Grads) -> Grads:
    if acc is None:
        return grads
    return torch._foreach_add(acc, grads)
