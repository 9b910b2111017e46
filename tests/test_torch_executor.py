"""The port's epoch loop and full-state checkpoints on the CPU:

- ``parallel/executor.py Executor`` against the JAX package's: the tiny
  flagship with the batch_norm conv module and hotwords, dropout 0,
  ``accum_grad`` 2 over 4 batches, a record a batch: every parameter,
  Adam moment and running statistic, Adam's count, the metrics records and
  the cv loss; and, with ``accum_grad`` 1, a non-finite batch skipped
  (parameters and optimizer state kept, the step counted) and left out
  of the cv loss;
- kill and resume bit for bit with dropout 0.1 (as
  ``tests/test_checkpoint_resume.py`` holds the JAX package to 1e-6): a
  run stopped at step 2 by its ``step_2.state`` and resumed in a model
  built with another seed ends equal to the uninterrupted run;
- ``utils/checkpoint.py``: the infos sidecars (read by ``yaml.safe_load``
  and by the JAX package as it writes them), the atomic background write
  and ``wait_pending``, ``load_trained_modules``, ``average_checkpoints``,
  ``select_checkpoints`` and ``bin/average_model.py`` against the JAX
  package's on bridged weights.
"""

import copy
import functools
import math
import os
import random
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import test_torch_batch_norm as tbn
import test_torch_transducer as ttrans
from test_torch_models import _fill
from wenet_celoss_tpu.bin import average_model as jax_average_model
from wenet_celoss_tpu.models.factory import init_example
from wenet_celoss_tpu.models.factory import init_model as jax_init_model
from wenet_celoss_tpu.parallel import train as jax_train
from wenet_celoss_tpu.parallel.executor import Executor as JaxExecutor
from wenet_celoss_tpu.utils import checkpoint as jax_ckpt
from wenet_celoss_tpu_torch.bin import average_model
from wenet_celoss_tpu_torch.data.context import (context_batch,
                                                 context_generate)
from wenet_celoss_tpu_torch.models.factory import init_model
from wenet_celoss_tpu_torch.parallel import train
from wenet_celoss_tpu_torch.parallel.executor import Executor
from wenet_celoss_tpu_torch.utils import checkpoint as ckpt
from wenet_celoss_tpu_torch.utils.convert import params_from_jax

TOL = 1e-5
# Tensors whose gradient is 0 in exact arithmetic (softmax ignores a shift
# shared by all keys; the batch norm cancels the depthwise conv's bias):
# Adam moves them by rounding noise, so their values are held to 1e-2 of
# their largest element and their moments to 1e-6.
ZERO_GRAD = ("linear_k.bias", "depthwise_conv.bias")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def make_batch(seed: int, nan: bool = False):
    """4 utterances of the tiny flagship's shapes (64 frames, 6 labels,
    16 phrase slots of 8 tokens) with hotwords sampled from the labels."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((4, 64, 80)).astype(np.float32)
    if nan:
        feats[1, 3, 5] = np.nan
    lens = np.array([64, 50, 33, 20], np.int32)
    # Label lengths CTC can align in the subsampled frames (15, 11, 7, 3);
    # the first the longest, as hw_labels take its width.
    llen = np.array([6] + [int(rng.integers(1, n)) for n in (6, 5, 3)],
                    np.int32)
    seqs = [[int(t) for t in rng.integers(1, ttrans.VOCAB - 2, n)]
            for n in llen]
    labels = np.full((4, 6), -1, np.int32)
    for i, y in enumerate(seqs):
        labels[i, :len(y)] = y
    ctx = context_generate(seqs, bpe_start_ids=set(range(1, 10)),
                           rng=random.Random(seed))
    extra = {k: np.asarray(v, np.int32)
             for k, v in context_batch(seqs, ctx, max_phrases=16).items()}
    cl = np.full((16, 8), -1, np.int32)
    cl[:, :extra["context_list"].shape[1]] = extra["context_list"]
    extra["context_list"] = cl
    return {"keys": [f"b{seed}u{i}" for i in range(4)], "feats": feats,
            "feat_lengths": lens, "labels": labels, "label_lengths": llen,
            **extra}


def _bridge(tree):
    return params_from_jax({"params": jax.tree_util.tree_map(np.asarray,
                                                             tree)})


def _close(name, got, want, scale_tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    return None if err <= scale_tol * scale else (name, err, scale)


def assert_state_matches(model, opt, j_state):
    """Every parameter and Adam moment (each to 1e-5 of its tensor's
    largest element; ZERO_GRAD tensors as above) and every running
    statistic (1e-5) against the JAX train state."""
    params = _bridge(j_state.params)
    adam = j_state.opt_state[1]
    mu, nu = _bridge(adam.mu), _bridge(adam.nu)
    bad = []
    for i, (name, p) in enumerate(model.named_parameters()):
        noise = name.endswith(ZERO_GRAD)
        bad.append(_close(name, p.detach(), params[name],
                          1e-2 if noise else TOL))
        for tag, got, want in (("mu", opt.mu[i], mu[name]),
                               ("nu", opt.nu[i], nu[name])):
            if noise:
                err = float((got - want).abs().max())
                bad.append(None if err <= 1e-6 else (tag, name, err))
            else:
                bad.append(_close(f"{tag} {name}", got, want))
    assert opt.count == int(adam.count)
    stats = params_from_jax({"batch_stats": jax.tree_util.tree_map(
        np.asarray, j_state.batch_stats)})
    assert stats
    for name, w in stats.items():
        bad.append(_close(name, model.get_buffer(name), w))
    bad = [b for b in bad if b is not None]
    assert not bad


def assert_records_match(got, want, rtol=TOL):
    """Equal keys and counters, lr to float32 rounding (the JAX schedule
    computes in float32); losses and grad_norm to ``rtol`` (NaN where the
    JAX package has NaN). audio_s_per_s is a wall-clock rate."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w), (set(g) ^ set(w))
        for k in ("epoch", "batch", "step"):
            assert g[k] == w[k], k
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        for k in set(w) - {"epoch", "batch", "step", "lr",
                           "audio_s_per_s"}:
            if math.isnan(w[k]):
                assert math.isnan(g[k]), k
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=rtol,
                                           atol=1e-6, err_msg=k)


def small_lr(cfg):
    """The config with the yaml's schedule (lr 1e-3, 25000 warm-up
    steps): an update of ~4e-8 an element. Adam moves an element whose
    gradient is at the two packages' rounding noise by the learning rate
    in either direction; at this rate that stays under the tolerances, so
    the second step's gradients are taken at the same parameters."""
    cfg = copy.deepcopy(cfg)
    cfg["optim_conf"] = {"lr": 0.001}
    cfg["scheduler_conf"] = {"warmup_steps": 25000}
    return cfg


def jax_state(jm, variables, tx):
    return jax_train.create_train_state(
        jm, jax.tree_util.tree_map(jnp.asarray, variables), tx)


def test_executor_accumulates_like_jax():
    """accum_grad 2 over 4 batches (2 optimizer steps), a record a batch,
    then the cv loss over 2 batches."""
    cfg, jm, variables, tm0 = tbn._pair()
    cfg = small_lr(cfg)
    batches = [make_batch(s) for s in range(4)]
    cv_batches = [make_batch(s) for s in (10, 11)]
    tx, schedule = jax_train.make_optimizer(cfg)
    j_recs, recs = [], []
    j_ex = JaxExecutor(jm, tx, schedule, accum_grad=2, log_interval=1,
                       metrics_writer=j_recs.append)
    j_st = j_ex.train_epoch(jax_state(jm, variables, tx), iter(batches))
    j_cv = j_ex.cv(j_st, iter(cv_batches))

    model = copy.deepcopy(tm0)
    t_tx, t_schedule = train.make_optimizer(cfg)
    ex = Executor(model, t_tx, t_schedule, accum_grad=2, log_interval=1,
                  metrics_writer=recs.append)
    st = ex.train_epoch(train.create_train_state(model, t_tx),
                        iter(batches))
    cv = ex.cv(st, iter(cv_batches))
    assert st.step == ex.step == int(j_st.step) == 2
    assert_state_matches(model, st.opt_state, j_st)
    assert_records_match(recs, j_recs)
    assert [("grad_norm" in r) for r in recs] == [False, True, False, True]
    np.testing.assert_allclose(cv, j_cv, rtol=TOL)


def test_executor_skips_a_nonfinite_batch_like_jax():
    """accum_grad 1 (the fused step), the layer_norm flagship: batch 1
    holds a NaN, so its step keeps parameters and optimizer state while
    the step count advances; the cv loss leaves the NaN batch out."""
    cfg, jm, variables, tm0 = ttrans._pair()
    cfg = small_lr(cfg)
    batches = [make_batch(0), make_batch(1, nan=True), make_batch(2)]
    cv_batches = [make_batch(10), make_batch(11, nan=True)]
    tx, schedule = jax_train.make_optimizer(cfg)
    j_recs, recs = [], []
    j_ex = JaxExecutor(jm, tx, schedule, log_interval=1,
                       metrics_writer=j_recs.append)
    j_st = j_ex.train_epoch(jax_state(jm, variables, tx), iter(batches))
    j_cv = j_ex.cv(j_st, iter(cv_batches))

    model = copy.deepcopy(tm0)
    t_tx, t_schedule = train.make_optimizer(cfg)
    ex = Executor(model, t_tx, t_schedule, log_interval=1,
                  metrics_writer=recs.append)
    st = ex.train_epoch(train.create_train_state(model, t_tx),
                        iter(batches))
    cv = ex.cv(st, iter(cv_batches))
    assert st.step == int(j_st.step) == 3
    assert st.opt_state.count == int(j_st.opt_state[1].count) == 2
    assert math.isnan(recs[1]["grad_norm"])
    assert_records_match(recs, j_recs)
    np.testing.assert_allclose(cv, j_cv, rtol=TOL)
    assert math.isfinite(cv)
    params = _bridge(j_st.params)
    bad = [_close(n, p.detach(), params[n],
                  1e-2 if n.endswith(ZERO_GRAD) else TOL)
           for n, p in model.named_parameters()]
    assert not [b for b in bad if b is not None]


# ------------------------------------------------- kill and resume ---
def _dropout_cfg():
    cfg = copy.deepcopy(tbn._pair()[0])
    for conf in (cfg["encoder_conf"], cfg["decoder_conf"]):
        for k in conf:
            if k.endswith("dropout_rate"):
                conf[k] = 0.1
    cfg["predictor_conf"].update(embed_dropout=0.1, dropout=0.1)
    return cfg


def _snapshot(state, gen):
    sd = state.state_dict()
    return sd, gen.get_state()


def test_resume_from_step_state_is_bit_exact(tmp_path):
    """Run A: 4 steps. Run B: 2 steps, step_2.state written by the
    checkpoint function in the background. Run C: a model built with
    another seed loads the state and the generator, then trains batches
    2-3. A and C: equal bits in every parameter, moment and running
    statistic, the same step, Adam count and generator state."""
    cfg = _dropout_cfg()
    batches = [make_batch(s) for s in range(4)]

    def run(data, seed=0, resume=None, save=None, gen_seed=5):
        model = init_model(cfg, device="cpu", seed=seed)
        tx, schedule = train.make_optimizer(cfg)
        state = train.create_train_state(model, tx)
        gen = torch.Generator().manual_seed(gen_seed)
        if resume is not None:
            ckpt.load_train_state(state, resume, gen=gen)
        ex = Executor(model, tx, schedule, gen=gen, checkpoint_every=1,
                      checkpoint_fn=save)
        ex.step = state.step
        return ex.train_epoch(state, iter(data)), gen

    a, gen_a = run(batches)
    path = str(tmp_path / "step_2.state")

    def save(st, gen):
        if st.step == 2:
            ckpt.save_train_state(st, path, {"step": 2, "epoch": 0},
                                  gen=gen)

    run(batches[:2], save=save)
    ckpt.wait_pending()
    assert ckpt.load_checkpoint_infos(path) == {"step": 2, "epoch": 0}
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
    c, gen_c = run(batches[2:], seed=1, resume=path)
    (sd_a, g_a), (sd_c, g_c) = _snapshot(a, gen_a), _snapshot(c, gen_c)
    assert sd_a["step"] == sd_c["step"] == 4
    assert sd_a["opt"]["count"] == sd_c["opt"]["count"] == 4
    assert torch.equal(g_a, g_c)
    for k, v in sd_a["model"].items():
        assert torch.equal(v, sd_c["model"][k]), k
    for name in ("mu", "nu"):
        for x, y in zip(sd_a["opt"][name], sd_c["opt"][name]):
            assert torch.equal(x, y), name
    # The dropout drew from the generator: a run with another generator
    # seed ends elsewhere.
    b, _ = run(batches, gen_seed=6)
    assert not torch.equal(b.model.encoder.embed.out.weight,
                           a.model.encoder.embed.out.weight)


# ------------------------------------------------ checkpoint helpers ---
def test_infos_sidecars_read_both_ways(tmp_path):
    """The port's sidecar is what yaml.safe_load and the JAX package read,
    and the port reads the JAX package's; the naming rule maps .pt,
    .state and .ckpt alike."""
    cfg, _, _, tm0 = tbn._pair()
    infos = {"epoch": 3, "cv_loss": 12.5, "step": 40, "lr": 3.2e-05}
    ckpt.save_checkpoint(tm0, str(tmp_path / "3.pt"), infos)
    assert yaml.safe_load((tmp_path / "3.pt.yaml").read_text()) == infos
    assert jax_ckpt.load_checkpoint_infos(str(tmp_path / "3.pt")) == infos
    jax_ckpt.save_checkpoint({"w": np.zeros(2, np.float32)},
                             str(tmp_path / "3.ckpt"), infos)
    assert ckpt.load_checkpoint_infos(str(tmp_path / "3.ckpt")) == infos
    assert ckpt.infos_path("d/step_8.state") == "d/step_8.yaml"
    assert ckpt.load_checkpoint_infos(str(tmp_path / "none.pt")) == {}


def test_train_state_write_is_a_snapshot_and_errors_surface(tmp_path,
                                                            monkeypatch):
    """The state written in the background is the state at the call (the
    model changes right after); wait_pending re-raises a failed write."""
    cfg, _, _, tm0 = tbn._pair()
    model = copy.deepcopy(tm0)
    tx, _ = train.make_optimizer(cfg)
    state = train.create_train_state(model, tx)
    state.step, state.opt_state.count = 7, 5
    before = copy.deepcopy(model.state_dict())
    gen = torch.Generator().manual_seed(3)
    path = str(tmp_path / "s" / "step_7.state")
    ckpt.save_train_state(state, path, {"step": 7}, gen=gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    ckpt.wait_pending()
    other = train.create_train_state(copy.deepcopy(tm0), tx)
    gen2 = torch.Generator()
    ckpt.load_train_state(other, path, gen=gen2)
    assert other.step == 7 and other.opt_state.count == 5
    assert torch.equal(gen2.get_state(), gen.get_state())
    for k, v in other.model.state_dict().items():
        assert torch.equal(v, before[k]), k

    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(ckpt.torch, "save", broken)
    ckpt.save_train_state(state, str(tmp_path / "bad.state"))
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        ckpt.wait_pending()
    assert not os.path.exists(tmp_path / "bad.state")


@functools.lru_cache(maxsize=None)
def _trees():
    """Three seeded JAX parameter trees of the tiny batch_norm flagship."""
    cfg = tbn._pair()[0]
    jm = jax_init_model(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *init_example(cfg, frames=16, labels=2))
    return cfg, [_fill(shapes, seed=s)["params"] for s in (1, 2, 3)]


def _sd_equal(got, want, names=None):
    for k in names or want:
        assert torch.equal(got[k], want[k]), k


def test_load_trained_modules_matches_jax(tmp_path):
    """Encoder (and encoder+ctc) warm start from a JAX checkpoint and from
    the same weights as a .pt: the parameters the JAX package's
    load_trained_modules gives, through the bridge."""
    cfg, trees = _trees()
    a, b = trees[0], trees[1]
    path = str(tmp_path / "b.ckpt")
    jax_ckpt.save_checkpoint(b, path)
    model_b = init_model(cfg, device="cpu")
    ckpt.load_into(model_b, path)
    ckpt.save_checkpoint(model_b, str(tmp_path / "b.pt"))
    for mods in (["encoder"], ["encoder", "ctc"]):
        want = _bridge(jax_ckpt.load_trained_modules(a, path, mods))
        for src in (path, str(tmp_path / "b.pt")):
            model = init_model(cfg, device="cpu")
            model.load_state_dict(_bridge(a), strict=False)
            ckpt.load_trained_modules(model, src, mods)
            _sd_equal(model.state_dict(), want)
    assert set(ckpt.filter_modules(_bridge(b), ["ctc"])) == {
        "ctc.ctc_lo.weight", "ctc.ctc_lo.bias"}


def test_average_and_select_match_jax(tmp_path, monkeypatch):
    """Epoch files 0-2 with cv losses in both formats: the last-2 and the
    2-best selections, the float64 averages (bit for bit after the
    bridge), and both average_model CLIs' outputs and infos."""
    cfg, trees = _trees()
    losses = [3.0, 1.0, 2.0]
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    for e, (tree, loss) in enumerate(zip(trees, losses)):
        infos = {"epoch": e, "cv_loss": loss}
        jax_ckpt.save_checkpoint(tree, str(jdir / f"{e}.ckpt"), infos)
        model = init_model(cfg, device="cpu")
        ckpt.load_into(model, str(jdir / f"{e}.ckpt"))
        ckpt.save_checkpoint(model, str(pdir / f"{e}.pt"), infos)
    stems = lambda ps: [os.path.basename(p).split(".")[0] for p in ps]
    for val_best in (True, False):
        got = ckpt.select_checkpoints(str(pdir), 2, val_best)
        want = jax_ckpt.select_checkpoints(str(jdir), 2, val_best)
        assert stems(got) == stems(want) == (["1", "2"] if val_best
                                             else ["2", "1"])
    assert stems(ckpt.select_checkpoints(str(pdir), 5, False,
                                         min_epoch=1)) == ["2", "1"]
    paths = [str(pdir / f"{e}.pt") for e in range(3)]
    want = _bridge(jax_ckpt.average_checkpoints(
        trees[0], [str(jdir / f"{e}.ckpt") for e in range(3)]))
    got = ckpt.average_checkpoints(paths)
    _sd_equal(got, want)
    with pytest.raises(ValueError):
        ckpt.average_checkpoints([])

    average_model.main(["--dst_model", str(tmp_path / "avg.pt"),
                        "--src_path", str(pdir), "--num", "2",
                        "--val_best"])
    monkeypatch.setattr(sys, "argv", [
        "average", "--dst_model", str(tmp_path / "avg.ckpt"),
        "--src_path", str(jdir), "--num", "2", "--val_best"])
    jax_average_model.main()
    with open(tmp_path / "avg.ckpt", "rb") as f:
        jax_avg = _bridge(flax.serialization.msgpack_restore(f.read()))
    _sd_equal(ckpt.load_checkpoint(str(tmp_path / "avg.pt")), jax_avg)
    got_from = ckpt.load_checkpoint_infos(str(tmp_path / "avg.pt"))
    want_from = jax_ckpt.load_checkpoint_infos(str(tmp_path / "avg.ckpt"))
    assert stems(got_from["averaged_from"]) == \
        stems(want_from["averaged_from"]) == ["1", "2"]
