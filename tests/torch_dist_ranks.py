"""One rank of the CPU data-parallel tests (tests/test_torch_dist*.py).

    python tests/torch_dist_ranks.py SPEC RANK WORLD INIT_METHOD OUT

Joins a gloo group through INIT_METHOD (a ``file://`` path, so that test
workers running at once never share a port), runs every job of the
``torch.save``d SPEC on its part, and writes its results to OUT
(``torch.save``). It imports torch and the port only: the tests that
start it import the JAX package, which a rank must not.

Jobs (dicts with a ``kind``):
- ``train``: ``steps`` steps of ``parallel/train.py`` over the group, on
  this rank's rows of the global ``batch`` brought to the step's shape by
  ``dist.agree_shapes``; with ``grads`` the step is taken as the grad
  function, the all-reduce and the apply function, and the averaged
  gradients are kept;
- ``decode``: ``decode/sharded.py ShardedDecoder`` calls on the whole
  batch (every rank holds it);
- ``agree``: ``dist.agree_shapes`` of this rank's own batch;
- ``cli``: the train or recognize CLI's ``main`` with its argv (the CLI
  joins its own group from torchrun's environment).
"""

import sys

import numpy as np
import torch


def _tensors(batch):
    return {k: torch.as_tensor(v) if np.asarray(v).dtype == np.float32
            else torch.as_tensor(np.asarray(v), dtype=torch.long)
            for k, v in batch.items() if k != "keys"}


def _model(job):
    from wenet_celoss_tpu_torch.models.factory import init_model
    model = init_model(job["cfg"], device="cpu")
    model.load_state_dict(job["state"], strict=True)
    return model


def run_train(job, ctx):
    from wenet_celoss_tpu_torch.parallel import dist, train
    model = _model(job)
    tx, _ = train.make_optimizer(job["cfg"])
    state = train.create_train_state(model, tx)
    part = dist.agree_shapes(
        dist.split_batch(job["batch"], ctx.rank, ctx.world), ctx)
    batch = _tensors(part)
    gen = torch.Generator().manual_seed(0) if job.get("dropout") else None
    out = {"steps": []}
    if job.get("grads"):
        grad_fn = train.make_grad_fn(model, group=ctx)
        apply_fn = train.make_apply_fn(tx)
    else:
        step = train.make_train_step(model, tx, group=ctx)
    for _ in range(job["steps"]):
        rec = {}
        if job.get("grads"):
            grads, metrics = grad_fn(state, batch, gen)
            grads = dist.all_reduce_mean_(grads, ctx)
            rec["grads"] = [g.clone() for g in grads]
            state, gnorm = apply_fn(state, grads)
        else:
            state, metrics, gnorm = step(state, batch, gen)
        rec.update(metrics={k: float(v) for k, v in metrics.items()},
                   gnorm=float(gnorm), state=state.state_dict())
        out["steps"].append(rec)
    return out


def run_decode(job, ctx):
    from wenet_celoss_tpu_torch.decode.sharded import ShardedDecoder
    dec = ShardedDecoder(_model(job), ctx)
    out = []
    for method, kw in job["calls"]:
        res = getattr(dec, method)(job["feats"], job["lens"], **kw)
        if method == "ctc_prefix_beam_search":
            res = (res[0], {k: v.clone() for k, v in res[1].items()})
        elif method == "rnnt_beam_search":
            res = {k: v.clone() for k, v in res[0].items()}
        gates = None
        if dec.last_gates is not None:
            gates = [np.asarray(torch.as_tensor(g)) for g in dec.last_gates]
            dec.last_gates = None
        out.append((res, gates))
    return out


def run_agree(job, ctx):
    from wenet_celoss_tpu_torch.parallel import dist
    return dist.agree_shapes(job["batches"][ctx.rank], ctx)


def run_cli(job, ctx):
    """The CLI's main; for the train CLI, every rank's model state after
    each epoch (kept by wrapping ``Executor.train_epoch``)."""
    import importlib
    from wenet_celoss_tpu_torch.parallel.executor import Executor
    states = []
    epoch = Executor.train_epoch

    def keep(self, state, data, n=0):
        state = epoch(self, state, data, n)
        states.append({k: v.clone() for k, v in
                       state.model.state_dict().items()})
        return state

    Executor.train_epoch = keep
    try:
        importlib.import_module(
            f"wenet_celoss_tpu_torch.bin.{job['cli']}").main(job["argv"])
    finally:
        Executor.train_epoch = epoch
    return states


def main(spec_path, rank, world, init_method, out_path):
    torch.set_num_threads(2)
    spec = torch.load(spec_path, weights_only=False)
    for name in spec.get("block", ()):
        sys.modules[name] = None
    import random
    from wenet_celoss_tpu_torch.parallel import dist
    results = []
    ctx = None
    for job in spec["jobs"]:
        random.seed(0)
        if job["kind"] == "cli":
            results.append(run_cli(job, None))
            continue
        if ctx is None:
            ctx = dist.init_distributed("gloo", init_method, device="cpu",
                                        rank=rank, world_size=world)
        results.append({"train": run_train, "decode": run_decode,
                        "agree": run_agree}[job["kind"]](job, ctx))
    if ctx is not None:
        dist.barrier(ctx)
        dist.shutdown()
    torch.save(results, out_path)


def spawn(jobs, tmp, world=2, block=(), timeout=300):
    """Run ``jobs`` (one list for every rank, or {rank: list}) on
    ``world`` rank processes started at once (gloo over a ``file://``
    rendezvous under ``tmp``) → (each rank's results, its log). The
    processes get torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK);
    ``block`` names modules each rank makes unimportable first."""
    import os
    import subprocess
    from pathlib import Path
    tmp = Path(tmp)
    root = Path(__file__).resolve().parent.parent
    procs, outs = [], []
    for r in range(world):
        spec = tmp / f"spec{r}.pt"
        torch.save({"jobs": jobs[r] if isinstance(jobs, dict) else jobs,
                    "block": list(block)}, spec)
        out = tmp / f"out{r}.pt"
        env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="2",
                   RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(spec), str(r), str(world),
             f"file://{tmp}/rendezvous", str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs.append(out)
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    return [torch.load(o, weights_only=False) for o in outs], logs


def spawn_once(name, make, tmp_path_factory, **kw):
    """``spawn(*make(tmp))`` once for the test session, whatever the
    number of xdist workers running tests that need it: the first worker
    to take the lock runs it in a directory shared by the session's
    workers and saves (results, logs, make's extra); the others wait for
    the lock and load them. ``make(tmp)`` → (jobs, extra)."""
    import fcntl
    import os
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent   # this session's directory, every worker's
    tmp = root / f"torch_dist_{name}"
    with open(root / f"torch_dist_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = tmp / "results.pt"
        if not done.exists():
            tmp.mkdir(exist_ok=True)
            jobs, extra = make(tmp)
            results, logs = spawn(jobs, tmp, **kw)
            torch.save((results, logs, extra), done)
        return torch.load(done, weights_only=False)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
