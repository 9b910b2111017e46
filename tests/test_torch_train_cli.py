"""The port's train CLI (``bin/train.py``) against the JAX package's, in
process on the CPU.

Both start from one JAX ``init.ckpt`` (the JAX CLI's ``PRNGKey(777)``
init of the model) and train the tiny yaml flagship (run.sh's shrunk
widths with the hotword tower kept, ``batch_norm``, context mode 1;
dither, speed perturb and spec_aug on; every dropout rate 0) for 2 epochs
on 8 train-clean-100 WAVs, cv on 4 others, with ``--cmvn`` (the port's
``compute_cmvn_stats``), static batches of 2, ``accum_grad`` 2, a record
a batch and ``--step_checkpoint_interval 1``. Compared: ``train.yaml``,
the epoch infos, ``metrics.jsonl``, ``1.pt`` against ``1.ckpt`` through
the weight bridge, the running statistics and Adam's count and moments
against the JAX package's ``step_<n>.state``, and the ``final.*`` links.
Then a resume from the port's ``step_2.state``, the CLI in a subprocess
with ``yaml``, ``msgpack``, ``flax`` and ``jax`` blocked (two loader
processes), the flags that raise, and an MFCC config whose ``num_ceps``
differs from the fbank ``num_mel_bins`` that sets ``input_dim`` (both
CLIs raise).
"""

import copy
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import flax
import jax
import numpy as np
import pytest
import torch
import yaml

from test_torch_data_extra import write_train_inputs
from test_torch_executor import ZERO_GRAD, assert_records_match
from test_torch_recognize import KEEP_CONTEXT, run_sh_overrides
from wenet_celoss_tpu.bin import train as jax_train_cli
from wenet_celoss_tpu.models.factory import init_model as jax_init_model
from wenet_celoss_tpu.parallel import mesh as jax_mesh
from wenet_celoss_tpu.utils import checkpoint as jax_ckpt
from wenet_celoss_tpu.utils import config as jax_config
from wenet_celoss_tpu.utils import platform as jax_platform
from wenet_celoss_tpu_torch.bin import compute_cmvn_stats
from wenet_celoss_tpu_torch.bin import train
from wenet_celoss_tpu_torch.utils import checkpoint, config
from wenet_celoss_tpu_torch.utils.convert import params_from_jax
from wenet_celoss_tpu_torch.utils.scheduler import warmup_lr

ROOT = Path(__file__).resolve().parent.parent
CONF = ROOT / "examples" / "librispeech" / "conf" / "conformer_rnnt_bias.yaml"
# run.sh's switches that this test keeps as the yaml has them.
KEEP_YAML = ("dataset_conf.fbank_conf.dither", "dataset_conf.speed_perturb",
             "dataset_conf.spec_aug", "scheduler_conf.warmup_steps",
             "optim_conf.lr", "accum_grad", "dataset_conf.batch_conf")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def cli_config():
    """The yaml flagship shrunk as run.sh does (hotword tower kept), every
    dropout rate 0, static batches of 2, accum_grad 2, a record a batch;
    frames padded to 256, labels to 40 and 16 hotword slots of 4 tokens,
    so that every batch has one shape (the JAX CLI compiles a step for
    each shape)."""
    ovs = [o for o in run_sh_overrides()
           if o not in KEEP_CONTEXT and not o.startswith(KEEP_YAML)]
    cfg = jax_config.override_config(yaml.safe_load(CONF.read_text()), ovs)
    for conf in (cfg["encoder_conf"], cfg["decoder_conf"]):
        for k in conf:
            if k.endswith("dropout_rate"):
                conf[k] = 0.0
    cfg["predictor_conf"].update(embed_dropout=0.0, dropout=0.0)
    dc = cfg["dataset_conf"]
    dc["batch_conf"] = {"batch_type": "static", "batch_size": 2}
    dc["pad_conf"].update(max_phrases=16, phrase_len=4)
    dc.update(feat_buckets=[256], label_buckets=[40])
    cfg.update(accum_grad=2, log_interval=1)
    return cfg


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Config, train and cv lists, symbol table, cmvn and the JAX init
    checkpoint → the arguments both CLIs share."""
    tmp = tmp_path_factory.mktemp("train_cli")
    cv_dir = tmp / "cv"
    cv_dir.mkdir()
    cv_list, _, _ = write_train_inputs(cv_dir, 4, offset=8)
    train_list, units, table = write_train_inputs(tmp, 8)
    cfg = cli_config()
    conf = tmp / "conf.yaml"
    conf.write_text(yaml.dump(cfg))
    cmvn = str(tmp / "global_cmvn")
    compute_cmvn_stats.main(["--train_config", str(conf), "--in_scp",
                             str(tmp / "wav.scp"), "--out_cmvn", cmvn])
    full = dict(copy.deepcopy(cfg), input_dim=80, output_dim=len(table),
                cmvn_file=cmvn, is_json_cmvn=True)
    rng = np.random.default_rng(0)   # the JAX CLI's init batch
    ex = (np.zeros((2, 64, 80), np.float32), np.array([64, 64], np.int32),
          rng.integers(1, len(table) - 1, (2, 8)).astype(np.int32),
          np.array([8, 8], np.int32))
    ex = ex + (rng.integers(1, len(table) - 1, (3, 2)).astype(np.int32),
               np.array([2, 2, 2], np.int32),
               rng.integers(0, 2, (2, 8)).astype(np.int32))
    variables = jax.jit(jax_init_model(full).init)(jax.random.PRNGKey(777),
                                                   *ex)
    init = str(tmp / "init.ckpt")
    jax_ckpt.save_checkpoint(jax.device_get(variables["params"]), init)
    args = ["--config", str(conf), "--train_data", train_list,
            "--cv_data", cv_list, "--symbol_table", units, "--cmvn", cmvn,
            "--num_epochs", "2", "--step_checkpoint_interval", "1"]
    return tmp, args, init, cfg


def run_jax_cli(argv, monkeypatch):
    """The JAX CLI in process on one CPU device, without its TPU runtime
    flags or its compilation cache."""
    make_mesh = jax_mesh.make_mesh
    monkeypatch.setattr(jax_mesh, "make_mesh",
                        lambda mp=1: make_mesh(mp, jax.devices()[:1]))
    monkeypatch.setattr(jax_platform, "configure_tpu_runtime", lambda: None)
    monkeypatch.setattr(jax_platform, "enable_compilation_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    random.seed(0)   # mode-1 hotword sampling draws from `random`
    jax_train_cli.main()


def run_port_cli(argv):
    random.seed(0)
    train.main(argv + ["--device", "cpu"])


def _records(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def _close(name, got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    return None if err <= tol * scale else (name, err, scale)


def test_train_cli_matches_jax_cli(inputs, monkeypatch):
    tmp, args, init, cfg = inputs
    jdir, pdir = tmp / "jax", tmp / "port"
    run_jax_cli(args + ["--model_dir", str(jdir), "--checkpoint", init],
                monkeypatch)
    run_port_cli(args + ["--model_dir", str(pdir), "--checkpoint", init])

    # train.yaml: the same config (the port's writer, read by both).
    want = yaml.safe_load((jdir / "train.yaml").read_text())
    assert config.load_config(str(pdir / "train.yaml")) == want
    assert yaml.safe_load((pdir / "train.yaml").read_text()) == want
    assert want["input_dim"] == 80 and want["cmvn_file"] == args[9]

    # Epoch infos and the records of all 8 batches.
    for e in (0, 1):
        got = checkpoint.load_checkpoint_infos(str(pdir / f"{e}.pt"))
        w = jax_ckpt.load_checkpoint_infos(str(jdir / f"{e}.ckpt"))
        assert set(got) == set(w) == {"epoch", "cv_loss", "step", "lr"}
        assert (got["epoch"], got["step"]) == (w["epoch"], w["step"]) == \
            (e, 2 * (e + 1))
        np.testing.assert_allclose(got["cv_loss"], w["cv_loss"], rtol=1e-5)
        np.testing.assert_allclose(got["lr"], w["lr"], rtol=1e-6)
    recs = _records(pdir / "metrics.jsonl")
    assert len(recs) == 8
    assert_records_match(recs, _records(jdir / "metrics.jsonl"))

    # Parameters of the last epoch: each element to 1e-5 of its tensor's
    # largest element plus twice the summed learning rate of the 4 steps
    # (Adam moves an element whose gradient is at the two packages'
    # rounding noise by the learning rate in either direction; the biases
    # start at 0 and stay within a few learning rates of it). The
    # running statistics and Adam's moments after every step against the
    # JAX package's full-state files.
    with open(jdir / "1.ckpt", "rb") as f:
        want = params_from_jax({"params": flax.serialization.msgpack_restore(
            f.read())})
    got = checkpoint.load_checkpoint(str(pdir / "1.pt"))
    schedule = warmup_lr(cfg["optim_conf"]["lr"],
                         cfg["scheduler_conf"]["warmup_steps"])
    noise = 2 * sum(schedule(c) for c in range(4))
    bad = [(k, err) for k, w in want.items()
           if not (err := float((got[k] - w).abs().max()))
           <= 1e-5 * float(w.abs().max()) + noise]
    assert not bad
    steps = sorted(p.name for p in jdir.glob("step_*.state"))
    assert steps == sorted(p.name for p in pdir.glob("step_*.state")) == [
        f"step_{n}.state" for n in (1, 2, 3, 4)]
    for name in steps:
        with open(jdir / name, "rb") as f:
            j_state = flax.serialization.msgpack_restore(f.read())
        stats = params_from_jax({"batch_stats": j_state["batch_stats"]})
        p_state = torch.load(pdir / name, weights_only=True)
        assert p_state["step"] == int(j_state["step"])
        assert len(stats) == 4
        bad = [_close(f"{name} {k}", p_state["model"][k], w, 1e-5)
               for k, w in stats.items()]
        # Adam's count and moments after every step: each tensor to 1e-4
        # of its largest element (two fp32 gradients summed in different
        # orders over real audio: the worst of the 4 steps reads 3.2e-5,
        # a small bias's mu); the moments of the tensors whose exact
        # gradient is 0 (rounding noise on both sides) to 1e-6.
        adam = next(s for s in j_state["opt_state"].values()
                    if isinstance(s, dict) and "mu" in s)
        assert p_state["opt"]["count"] == int(adam["count"])
        names = [k for k in p_state["model"] if k in want]
        assert len(names) == len(want) == len(p_state["opt"]["mu"])
        for tag in ("mu", "nu"):
            j_moment = params_from_jax({"params": adam[tag]})
            for k, m in zip(names, p_state["opt"][tag]):
                if k.endswith(ZERO_GRAD):
                    err = float((m - j_moment[k]).abs().max())
                    bad.append(None if err <= 1e-6 else (tag, k, err))
                else:
                    bad.append(_close(f"{name} {tag} {k}", m, j_moment[k],
                                      1e-4))
        assert not [b for b in bad if b is not None]
        if name == "step_4.state":
            for k in stats:
                assert torch.equal(got[k], p_state["model"][k]), k
    assert os.readlink(jdir / "final.ckpt") == "1.ckpt"
    assert os.readlink(pdir / "final.pt") == "1.pt"

    # Resume from step_2.state (written in epoch 0): epoch 0 runs again
    # from its first batch at step 2, with the optimizer and generator
    # restored.
    rdir = tmp / "resume"
    run_port_cli(args + ["--model_dir", str(rdir), "--checkpoint",
                         str(pdir / "step_2.state")])
    r = _records(rdir / "metrics.jsonl")
    assert [(x["epoch"], x["batch"], x["step"]) for x in r] == [
        (0, 0, 2), (0, 1, 3), (0, 2, 3), (0, 3, 4),
        (1, 0, 4), (1, 1, 5), (1, 2, 5), (1, 3, 6)]
    assert checkpoint.load_checkpoint_infos(str(rdir / "1.pt"))["step"] == 6


def test_train_cli_runs_without_yaml_msgpack_flax(inputs):
    """The port's CLI in a subprocess with yaml, msgpack, flax and jax
    blocked (the machine with the card has none of them), the train data
    through two loader processes: one epoch, its files written."""
    tmp, args, init, cfg = inputs
    cfg = dict(cfg, dataset_conf=dict(cfg["dataset_conf"],
                                      loader_processes=2))
    conf = tmp / "conf_loader.yaml"
    conf.write_text(yaml.dump(cfg))
    out = tmp / "blocked"
    argv = args + ["--model_dir", str(out), "--checkpoint", init,
                   "--device", "cpu"]
    argv[argv.index("--config") + 1] = str(conf)
    argv[argv.index("--num_epochs") + 1] = "1"
    code = ("import sys\n"
            "for m in ('yaml', 'msgpack', 'flax', 'jax'):\n"
            "    sys.modules[m] = None\n"
            "from wenet_celoss_tpu_torch.bin import train\n"
            f"train.main({argv!r})\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = sorted(p.name for p in out.iterdir())
    assert names == ["0.pt", "0.pt.yaml", "final.pt", "metrics.jsonl",
                     "step_1.state", "step_1.yaml", "step_2.state",
                     "step_2.yaml", "train.yaml"]
    assert len(_records(out / "metrics.jsonl")) == 4


@pytest.mark.parametrize("flag", [["--model_parallel", "2"],
                                  ["--distributed", "--model_parallel", "2"]])
def test_scale_out_flags_raise(inputs, flag):
    """Tensor parallelism is not ported (data parallelism is:
    tests/test_torch_dist_cli.py): it raises before any process group or
    file, with or without --distributed."""
    tmp, args, init, _ = inputs
    with pytest.raises(NotImplementedError, match="item 9b"):
        train.main(args + ["--model_dir", str(tmp / "never"), "--device",
                           "cpu"] + flag)
    assert not (tmp / "never").exists()


def test_mfcc_input_dim_comes_from_fbank_conf(inputs, monkeypatch):
    """input_dim is fbank_conf's num_mel_bins whatever feats_type is, in
    both CLIs: an MFCC config with 40 coefficients builds an 80-wide
    model, and both CLIs raise on its first batch (the subsampling's
    output projection has the width of 80 bins)."""
    tmp, args, init, cfg = inputs
    cfg = copy.deepcopy(cfg)
    cfg["dataset_conf"].update(feats_type="mfcc", mfcc_conf={
        "num_mel_bins": 40, "num_ceps": 40})
    conf = tmp / "conf_mfcc.yaml"
    conf.write_text(yaml.dump(cfg))
    argv = list(args)
    argv[argv.index("--config") + 1] = str(conf)
    argv = argv[:argv.index("--cmvn")] + argv[argv.index("--cmvn") + 2:]
    with pytest.raises(flax.errors.ScopeParamShapeError, match="embed/out"):
        run_jax_cli(argv + ["--model_dir", str(tmp / "mfcc_jax")],
                    monkeypatch)
    with pytest.raises(RuntimeError, match="cannot be multiplied"):
        run_port_cli(argv + ["--model_dir", str(tmp / "mfcc_port")])
    for d in ("mfcc_jax", "mfcc_port"):
        assert config.load_config(str(tmp / d / "train.yaml"))[
            "input_dim"] == 80
