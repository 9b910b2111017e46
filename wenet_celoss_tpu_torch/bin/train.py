"""Training CLI of the port (the flags of ``wenet_celoss_tpu/bin/train.py``,
plus ``--device``).

    python -m wenet_celoss_tpu_torch.bin.train --config conf.yaml \\
        --train_data train/data.list --cv_data dev/data.list \\
        --symbol_table units.txt --cmvn global_cmvn --model_dir exp/m

YAML config and ``--override_config``, the training data through
``data/loader.py make_loader`` (``dataset_conf.loader_processes`` > 0: that
many worker processes), the cv data through ``Dataset`` without speed
perturb, spec_aug, spec_sub or shuffle; ``<model_dir>/train.yaml`` (the
config with input_dim, output_dim, cmvn_file and is_json_cmvn); the epoch
loop of ``parallel/executor.py``, a cv loss a epoch, ``<epoch>.pt`` with
infos {epoch, cv_loss, step, lr}, ``step_<n>.state`` every
``--step_checkpoint_interval`` optimizer steps, ``metrics.jsonl``, and
``final.pt``, a relative symlink to the last epoch's file. Each epoch
logs its train seconds and the loader's start-up seconds.

``--checkpoint`` resumes: a ``.state`` restores the whole state (step,
epoch, optimizer, generator) and re-runs its epoch from the first batch;
a ``.pt`` or a JAX ``.ckpt`` warm-starts the parameters (a ``.pt`` also
the running statistics) with a fresh optimizer, at the infos' epoch + 1
and step, as the JAX CLI does. ``--enc_init`` loads the modules of
``--enc_init_mods`` from a checkpoint.

Runs on the card; ``--device cpu`` runs the plain PyTorch versions on the
CPU. The yaml's top-level ``rnnt_impl`` is not read, as in the JAX
package's factory. Reads YAML and checkpoints with the port's own
readers (no PyYAML, msgpack or flax).

``--distributed`` trains data-parallel over the processes torchrun
starts (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``, or ``--ddp.init_method``), one rank a process, over
``--dist_backend`` (nccl on the card, gloo on the CPU by default); each
rank runs on ``cuda:<LOCAL_RANK>`` unless ``--device`` names one (two
ranks may share a card over gloo):

    torchrun --nproc_per_node 2 -m wenet_celoss_tpu_torch.bin.train \
        --distributed --dist_backend gloo --device cpu ...

The training list is partitioned by rank, dynamic batches round to the
world size, rank 0's parameters are broadcast once, every step runs over
the group (``parallel/dist.py``, ``parallel/executor.py``) and every rank
stops an epoch at the shortest rank's batch count. Only rank 0 writes
train.yaml, metrics, step and epoch checkpoints and ``final.pt``, as the
JAX CLI does. ``--model_parallel`` above 1 (tensor parallelism) raises:
ROADMAP.md Queue A item 9b.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import logging
import os
import time
from typing import List, Optional


def get_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="training your network")
    parser.add_argument("--config", required=True, help="config file")
    parser.add_argument("--data_type", default="raw",
                        choices=["raw", "shard"])
    parser.add_argument("--train_data", required=True)
    parser.add_argument("--cv_data", required=True)
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--symbol_table", required=True)
    parser.add_argument("--bpe_model", default=None)
    parser.add_argument("--non_lang_syms", default=None)
    parser.add_argument("--override_config", action="append", default=[])
    parser.add_argument("--cmvn", default=None)
    parser.add_argument("--num_epochs", type=int, default=None)
    parser.add_argument("--step_checkpoint_interval", type=int, default=0,
                        help="save a full-state step_<n>.state every N "
                             "optimizer steps (mid-epoch kill/resume)")
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="tensor parallel over cards: not ported, "
                             "raises above 1 (ROADMAP.md item 9b)")
    parser.add_argument("--metrics_file", default=None,
                        help="per-logged-step metrics JSONL (default "
                             "<model_dir>/metrics.jsonl)")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of the first "
                             "train epoch to <dir>/trace.json")
    parser.add_argument("--distributed", action="store_true",
                        help="data parallel over the processes torchrun "
                             "starts (one rank a process)")
    parser.add_argument("--dist_backend", default=None,
                        choices=["nccl", "gloo"],
                        help="process group backend (default: nccl on the "
                             "card, gloo on the CPU)")
    parser.add_argument("--ddp.init_method", dest="init_method",
                        default=None,
                        help="process group init method (default env://)")
    parser.add_argument("--enc_init", default=None,
                        help="pretrained model for partial warm start")
    parser.add_argument("--enc_init_mods", default="encoder.",
                        help="comma list of module prefixes to warm start")
    parser.add_argument("--device", default=None,
                        help="torch device; the card by default, 'cpu' "
                             "for the plain PyTorch versions")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    # torch is imported here, not with the module: the loader's spawned
    # workers import this module (it is __main__ under -m) and need no
    # torch.
    import torch

    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model_parallel > 1 (tensor parallelism: the FFN, attention, "
            "joint and vocabulary projections split over cards) is not "
            "ported: ROADMAP.md Queue A item 9b")

    from wenet_celoss_tpu_torch.data.dataset import Dataset
    from wenet_celoss_tpu_torch.data.loader import make_loader
    from wenet_celoss_tpu_torch.models.factory import (init_model,
                                                       resolve_device)
    from wenet_celoss_tpu_torch.parallel import dist
    from wenet_celoss_tpu_torch.parallel import train as T
    from wenet_celoss_tpu_torch.parallel.executor import Executor
    from wenet_celoss_tpu_torch.utils import checkpoint as ckpt
    from wenet_celoss_tpu_torch.utils.config import (load_config,
                                                     override_config,
                                                     save_config)
    from wenet_celoss_tpu_torch.utils.file_utils import (
        read_non_lang_symbols, read_symbol_table)

    group = None
    if args.distributed:
        group = dist.init_distributed(args.dist_backend, args.init_method,
                                      device=args.device)
        device = group.device
        logging.info("rank %d of %d on %s over %s", group.rank, group.world,
                     device, group.backend)
    else:
        device = resolve_device(args.device)
    rank = group.rank if group is not None else 0
    world_size = group.world if group is not None else 1
    configs = load_config(args.config)
    if args.override_config:
        configs = override_config(configs, args.override_config)
    symbol_table = read_symbol_table(args.symbol_table)
    non_lang_syms = read_non_lang_symbols(args.non_lang_syms)

    train_conf = configs["dataset_conf"]
    cv_conf = copy.deepcopy(train_conf)
    cv_conf.update(speed_perturb=False, spec_aug=False, spec_sub=False,
                   shuffle=False)
    # The JAX CLI rounds dynamic batches to its data-parallel width and
    # writes it into train.yaml; Dataset does not read it.
    bc = train_conf.setdefault("batch_conf", {})
    if bc.get("batch_type", "static") == "dynamic":
        bc["round_to"] = world_size

    train_dataset = make_loader(args.data_type, args.train_data,
                                symbol_table, train_conf,
                                bpe_model=args.bpe_model,
                                non_lang_syms=non_lang_syms,
                                partition=True, rank=rank,
                                world_size=world_size)
    cv_dataset = Dataset(args.data_type, args.cv_data, symbol_table,
                         cv_conf, args.bpe_model, non_lang_syms,
                         partition=False)

    # input_dim comes from fbank_conf whatever feats_type is, as in the
    # JAX CLI (an MFCC config needs num_ceps equal to it).
    configs["input_dim"] = train_conf.get("fbank_conf",
                                          {}).get("num_mel_bins", 80)
    configs["output_dim"] = len(symbol_table)
    configs["cmvn_file"] = args.cmvn
    configs["is_json_cmvn"] = True
    if rank == 0:
        os.makedirs(args.model_dir, exist_ok=True)
        save_config(configs, os.path.join(args.model_dir, "train.yaml"))

    model = init_model(configs, device=device, seed=777)
    tx, schedule = T.make_optimizer(configs)
    state = T.create_train_state(model, tx)
    gen = torch.Generator().manual_seed(0)

    start_epoch = 0
    if args.checkpoint and args.checkpoint.endswith(".state"):
        # Full state: parameters, optimizer, step, generator.
        ckpt.load_train_state(state, args.checkpoint, gen=gen)
        start_epoch = ckpt.load_checkpoint_infos(args.checkpoint).get(
            "epoch", 0)
    elif args.checkpoint:
        # Warm start: the parameters only; the optimizer starts afresh.
        ckpt.load_into(model, args.checkpoint)
        infos = ckpt.load_checkpoint_infos(args.checkpoint)
        start_epoch = infos.get("epoch", -1) + 1
        state.step = infos.get("step", 0)
    elif args.enc_init:
        mods = [m.rstrip(".") for m in args.enc_init_mods.split(",")]
        ckpt.load_trained_modules(model, args.enc_init, mods)
    if group is not None:
        dist.broadcast_module_(model, group)

    epoch_holder = [start_epoch]

    def step_checkpoint(st, g):
        n = int(st.step)
        ckpt.save_train_state(
            st, os.path.join(args.model_dir, f"step_{n}.state"),
            {"step": n, "epoch": epoch_holder[0]}, gen=g)

    metrics_path = args.metrics_file or os.path.join(args.model_dir,
                                                     "metrics.jsonl")
    if rank == 0:
        os.makedirs(os.path.dirname(metrics_path) or ".", exist_ok=True)
    num_epochs = args.num_epochs or configs.get("max_epoch", 100)
    final_epoch = None
    with (open(metrics_path, "a", buffering=1) if rank == 0
          else contextlib.nullcontext()) as metrics_f:
        executor = Executor(
            model, tx, schedule, accum_grad=configs.get("accum_grad", 1),
            log_interval=configs.get("log_interval", 100), gen=gen,
            checkpoint_every=args.step_checkpoint_interval,
            checkpoint_fn=step_checkpoint,
            metrics_writer=(lambda rec: metrics_f.write(json.dumps(rec)
                                                        + "\n"))
            if rank == 0 else None, group=group)
        executor.step = state.step
        prof = None
        if args.profile_dir and rank == 0:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        for epoch in range(start_epoch, num_epochs):
            epoch_holder[0] = epoch
            train_dataset.set_epoch(epoch)
            logging.info("Epoch %d TRAIN", epoch)
            t0 = time.perf_counter()
            state = executor.train_epoch(state, iter(train_dataset), epoch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            logging.info("Epoch %d TRAIN %.3f s, loader start-up %.3f s",
                         epoch, time.perf_counter() - t0,
                         getattr(train_dataset, "startup_s", 0.0))
            if prof is not None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                prof.stop()
                os.makedirs(args.profile_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(args.profile_dir, "trace.json"))
                prof = None
            logging.info("Epoch %d CV", epoch)
            cv_loss = executor.cv(state, iter(cv_dataset))
            logging.info("Epoch %d CV loss %.4f", epoch, cv_loss)
            if rank == 0:
                ckpt.save_checkpoint(
                    model, os.path.join(args.model_dir, f"{epoch}.pt"),
                    {"epoch": epoch, "cv_loss": float(cv_loss),
                     "step": int(state.step),
                     "lr": float(schedule(max(int(state.step), 1)))})
            final_epoch = epoch
    ckpt.wait_pending()
    if final_epoch is not None and rank == 0:
        final = os.path.join(args.model_dir, "final.pt")
        if os.path.islink(final) or os.path.exists(final):
            os.remove(final)
        os.symlink(f"{final_epoch}.pt", final)
    if group is not None:
        # Every file rank 0 wrote is complete before any rank returns.
        dist.barrier(group)
        dist.shutdown()


if __name__ == "__main__":
    main()
