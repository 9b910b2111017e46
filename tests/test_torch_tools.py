"""The port's tools held against the JAX package on the CPU:
``ops/ctc_loss.py ctc_forced_align`` (exact: ragged lengths, repeats, a
label length of 0, T' = 2U + 1); the alignment CLI and the label checker
CLI against ``wenet_celoss_tpu/bin/alignment.py`` and
``tools/label_checker.py`` in process (``ali.txt``, every TextGrid, the
result and timestamp files byte for byte; the port's CLIs in a
subprocess with ``yaml``, ``msgpack`` and ``flax`` blocked, as on the
machine with the card); the batched fbank and MFCC against the JAX
``compute_fbank`` / ``compute_mfcc`` at dither 0 (1e-3, the bound of
``tests/test_data.py``); and ``utils/flops.py`` equal to JAX's for every
config of ``configs.py`` and ``chip_smoke.py``'s V1-V3.

The JAX CLIs run their model's ``init`` as zeros of its shapes and its
``apply`` jitted (the ``jax_cli`` fixture, ``JitApply``): the checkpoint
replaces every parameter, and eager flax takes minutes on this CPU.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from test_torch_exact_gating import JitApply
from test_torch_models import _fill
from test_torch_recognize import run_sh_overrides, write_inputs
from wenet_celoss_tpu import configs as jax_configs
from wenet_celoss_tpu.bin import alignment as jax_alignment
from wenet_celoss_tpu.models import factory as jax_factory
from wenet_celoss_tpu.ops import fbank as jax_fbank
from wenet_celoss_tpu.ops.ctc_loss import ctc_forced_align as jax_align
from wenet_celoss_tpu.utils import checkpoint as jax_ckpt
from wenet_celoss_tpu.utils import config as jax_config
from wenet_celoss_tpu.utils import flops as jax_flops
from wenet_celoss_tpu_torch import configs
from wenet_celoss_tpu_torch.ops import fbank
from wenet_celoss_tpu_torch.ops.ctc_loss import ctc_forced_align
from wenet_celoss_tpu_torch.utils import flops

ROOT = Path(__file__).resolve().parent.parent
TEST_CLEAN = ROOT / "examples" / "librispeech" / "data_hw" / "test-clean"
N_WAVS = 4


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------- alignment ---
def _align_case(seed, b, t, u, v=6, full=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, v)).astype(np.float32) * 2.0
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    labels = rng.integers(1, 3, (b, u)).astype(np.int32)   # many repeats
    ll = rng.integers(0, u + 1, (b,)).astype(np.int32)
    il = rng.integers(1, t + 1, (b,)).astype(np.int32)
    ll[0] = 0                                              # U = 0
    if full:                                               # T' = 2U + 1
        ll[1:] = u
        il[1:] = 2 * u + 1
    return lp.astype(np.float32), labels, il, ll


@pytest.mark.parametrize("case", ["ragged", "short", "tight", "one_label"])
def test_ctc_forced_align_matches_jax(case):
    """The state path of every frame equal to JAX's, blank past each
    input length; labels padded with -1 as the CLIs' batches pad them."""
    b, t, u, full = {"ragged": (6, 40, 7, False), "short": (5, 3, 4, False),
                     "tight": (4, 11, 5, True),
                     "one_label": (4, 9, 1, False)}[case]
    for seed in range(3):
        lp, labels, il, ll = _align_case(seed, b, t, u, full=full)
        padded = np.where(np.arange(u)[None] < ll[:, None], labels, -1)
        want = np.asarray(jax_align(jnp.asarray(lp), jnp.asarray(
            np.maximum(padded, 0)), jnp.asarray(il), jnp.asarray(ll)))
        got = ctc_forced_align(torch.as_tensor(lp),
                               torch.as_tensor(padded, dtype=torch.long),
                               torch.as_tensor(il, dtype=torch.long),
                               torch.as_tensor(ll, dtype=torch.long))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got.numpy()[np.arange(t)[None] >= il[:, None]] == 0).all()


# ------------------------------------------------------------- CLIs ---
@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """run.sh's shrunk flagship (no context tower) as a config file, a
    JAX checkpoint of seeded values, the first N_WAVS test-clean WAVs as
    a data list, a wav.scp and the transcripts."""
    tmp = tmp_path_factory.mktemp("tools")
    data_list, units = write_inputs(tmp, n_wavs=N_WAVS)
    table = dict(line.split() for line in
                 Path(units).read_text().splitlines())
    cfg = jax_config.override_config(
        jax_config.load_config(str(ROOT / "examples" / "librispeech" / "conf"
                                   / "conformer_rnnt_bias.yaml")),
        run_sh_overrides())
    cfg.update(input_dim=80, output_dim=len(table))
    (tmp / "train.yaml").write_text(yaml.safe_dump(cfg))
    jm = jax_factory.init_model(cfg)
    params = _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                  *jax_factory.init_example(cfg)),
                   seed=11)["params"]
    params["ctc"]["ctc_lo"]["bias"][0] += 1.0
    jax_ckpt.save_checkpoint(params, str(tmp / "final.ckpt"))
    keys = [json.loads(line)["key"]
            for line in Path(data_list).read_text().splitlines()]
    (tmp / "wav.scp").write_text("".join(
        f"{k} {TEST_CLEAN / 'wavs' / (k + '.wav')}\n" for k in keys))
    return {"dir": tmp, "data_list": data_list, "units": units,
            "config": str(tmp / "train.yaml"),
            "checkpoint": str(tmp / "final.ckpt")}


def _alignment_argv(c, out):
    return ["--config", c["config"], "--input_data", c["data_list"],
            "--checkpoint", c["checkpoint"], "--symbol_table", c["units"],
            "--result_file", str(out / "ali.txt"), "--gen_praat",
            "--batch_size", "8"]


def _checker_argv(c, out):
    return ["--config", c["config"], "--checkpoint", c["checkpoint"],
            "--symbol_table", c["units"], "--wav_scp",
            str(c["dir"] / "wav.scp"), "--text", str(TEST_CLEAN / "text"),
            "--result", str(out / "result.txt"), "--timestamp",
            str(out / "ts.txt"), "--is_penalty", "0.5", "--del_penalty",
            "0.5", "--beam", "1000"]


def _files(out: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(out.iterdir())}


@pytest.fixture(scope="module")
def port_runs(cli):
    """Both CLIs of the port, --device cpu, in one subprocess with yaml,
    msgpack, flax and jax blocked."""
    outs = {n: cli["dir"] / "port" / n for n in ("alignment", "checker")}
    code = ("import sys\n"
            "for m in ('yaml', 'msgpack', 'flax', 'jax'):\n"
            "    sys.modules[m] = None\n"
            "import torch\n"
            "torch.set_num_threads(2)\n"
            "from wenet_celoss_tpu_torch.bin import alignment, "
            "label_checker\n"
            f"alignment.main({_alignment_argv(cli, outs['alignment'])!r}"
            " + ['--device', 'cpu'])\n"
            f"label_checker.main({_checker_argv(cli, outs['checker'])!r}"
            " + ['--device', 'cpu'])\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {n: _files(p) for n, p in outs.items()}


@pytest.fixture
def jax_cli(monkeypatch):
    """The JAX package's models made with ``init`` from their shapes
    (zeros, the batch norms' running variances ones, as flax initialises
    them: the checkpoint holds no running statistics) and ``apply``
    jitted, for the CLIs run in process."""
    init = fnn.Module.init

    def shapes_only(self, rngs, *args, **kwargs):
        shapes = jax.eval_shape(lambda r: init(self, r, *args, **kwargs),
                                rngs)
        return jax.tree_util.tree_map_with_path(
            lambda path, s: (jnp.ones if path[-1].key == "var"
                             else jnp.zeros)(s.shape, s.dtype), shapes)
    make = jax_factory.init_model
    monkeypatch.setattr(fnn.Module, "init", shapes_only)
    monkeypatch.setattr(jax_factory, "init_model",
                        lambda cfg: JitApply(make(cfg)))
    monkeypatch.setattr("wenet_celoss_tpu.utils.platform."
                        "enable_compilation_cache", lambda *a, **k: None)


def test_alignment_cli_matches_jax(cli, port_runs, jax_cli, monkeypatch):
    out = cli["dir"] / "jax" / "alignment"
    monkeypatch.setattr(sys, "argv", ["alignment"]
                        + _alignment_argv(cli, out))
    jax_alignment.main()
    want = _files(out)
    assert port_runs["alignment"] == want
    assert len(want) == N_WAVS + 1
    lines = want["ali.txt"].decode().splitlines()
    assert len(lines) == N_WAVS and all(
        any(x != "0" for x in line.split()[1:]) for line in lines)
    assert all(b"intervals [1]" in v for k, v in want.items()
               if k.endswith(".TextGrid"))


def test_label_checker_cli_matches_tool(cli, port_runs, jax_cli,
                                        monkeypatch):
    out = cli["dir"] / "jax" / "checker"
    spec = importlib.util.spec_from_file_location(
        "jax_label_checker_tool", ROOT / "tools" / "label_checker.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", ["label_checker.py"]
                        + _checker_argv(cli, out))
    tool.main()
    want = _files(out)
    assert port_runs["checker"] == want
    lines = want["result.txt"].decode().splitlines()
    assert len(lines) == N_WAVS
    assert any(mark in want["result.txt"] for mark in (b"<del>", b"<is>"))
    assert len(want["ts.txt"].decode().splitlines()) == N_WAVS


# ------------------------------------------------------------ fbank ---
def _padded(wavs):
    lens = np.array([len(w) for w in wavs])
    batch = np.zeros((len(wavs), lens.max()), np.float32)
    for i, w in enumerate(wavs):
        batch[i, :len(w)] = w
    return batch, lens


def _both_paths(batch, lens, kind, cfg):
    port_fn, jax_fn = ((fbank.compute_fbank, jax_fbank.compute_fbank)
                       if kind == "fbank" else
                       (fbank.compute_mfcc, jax_fbank.compute_mfcc))
    port_cfg = (fbank.FbankConfig if kind == "fbank"
                else fbank.MfccConfig)(**cfg)
    jax_cfg = (jax_fbank.FbankConfig if kind == "fbank"
               else jax_fbank.MfccConfig)(**cfg)
    got, got_n = port_fn(torch.as_tensor(batch), torch.as_tensor(lens),
                         port_cfg)
    want, want_n = jax_fn(jnp.asarray(batch), jnp.asarray(lens), jax_cfg)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    return got.numpy(), np.asarray(want), got_n.numpy(), port_cfg


CONFS = {"fbank": dict(num_mel_bins=80), "mfcc": dict(num_mel_bins=23,
                                                      num_ceps=13)}


@pytest.mark.parametrize("kind", ["fbank", "mfcc"])
def test_batched_fbank_matches_jax_on_noise(kind):
    """tests/test_data.py's input (white noise at 8000) in a ragged padded
    batch, one utterance shorter than a frame, dither 0: within 1e-3
    (rtol and atol) of the JAX path and of the port's numpy path per
    utterance, padded frames 0."""
    rng = np.random.default_rng(3)
    wavs = [(rng.standard_normal(n) * 8000).astype(np.float32)
            for n in (16000, 399, 1601, 7000)]
    batch, lens = _padded(wavs)
    got, want, n, cfg = _both_paths(batch, lens, kind, CONFS[kind])
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    host = fbank.compute_fbank_np if kind == "fbank" \
        else fbank.compute_mfcc_np
    for i, w in enumerate(wavs):
        h = host(w, cfg)
        assert n[i] == len(h)
        np.testing.assert_allclose(got[i, :n[i]], h, rtol=1e-3, atol=1e-3)
        assert not got[i, n[i]:].any()
    one, one_n = (fbank.compute_fbank if kind == "fbank"
                  else fbank.compute_mfcc)(torch.as_tensor(wavs[0]),
                                           cfg=cfg)
    # The one-utterance call is the batched path on a batch of one; the
    # FFT may take another route for it, so equal to rounding.
    assert int(one_n) == n[0]
    np.testing.assert_allclose(one.numpy(), got[0, :n[0]], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kind", ["fbank", "mfcc"])
def test_batched_fbank_matches_jax_on_the_wavs(kind):
    """The 16 committed test-clean WAVs padded to a batch: the log-mel by
    chip_smoke.fbank_close (1e-3, quiet bins in the energy domain), the
    MFCC by mfcc_close (1e-3 plus the log-mel difference carried through
    the DCT), against the JAX path, as F1 holds the card's."""
    from wenet_celoss_tpu_torch.data.wav import read_wav
    wavs = [read_wav(str(p))[0] for p in
            sorted((TEST_CLEAN / "wavs").glob("*.wav"))]
    batch, lens = _padded(wavs)
    got, want, _, cfg = _both_paths(batch, lens, kind, CONFS[kind])
    if kind == "fbank":
        rec = chip_smoke.fbank_close(got, want)
    else:
        fb_cfg = {k: v for k, v in CONFS[kind].items() if k != "num_ceps"}
        got_fb, want_fb, _, _ = _both_paths(batch, lens, "fbank", fb_cfg)
        rec = chip_smoke.mfcc_close(got, want, got_fb, want_fb, cfg)
    assert rec["beyond"] == 0, rec


def test_batched_fbank_dither_draws_from_the_generator():
    wav = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, 4000)).astype(np.float32) * 100)
    cfg = fbank.FbankConfig(dither=1.0)
    runs = [fbank.compute_fbank(wav, cfg=cfg, generator=torch.Generator()
                                .manual_seed(s))[0] for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    plain = fbank.compute_fbank(wav, cfg=cfg)[0]
    assert torch.equal(plain, fbank.compute_fbank(
        wav, cfg=fbank.FbankConfig())[0])


# ------------------------------------------------------------ flops ---
def _all_configs(mod):
    out = {}
    for name in ("conformer_rnnt_bias", "conformer_ctc_aed",
                 "u2pp_conformer"):
        out[name] = getattr(mod, name)()
        out[name + "_tiny"] = getattr(mod, name)(tiny=True)
    for v, overrides, _ in chip_smoke.VARIANTS:
        out[v] = chip_smoke.variant_config(mod.conformer_rnnt_bias,
                                           overrides)()
    return out


def test_flops_match_jax():
    got_cfgs, want_cfgs = _all_configs(configs), _all_configs(jax_configs)
    assert got_cfgs == want_cfgs
    for name, cfg in want_cfgs.items():
        for batch, t_in, u in ((256, 512, 32), (64, 512, 32), (1, 97, 5),
                               (16, 1000, 70)):
            assert flops.forward_flops(got_cfgs[name], batch, t_in, u) == \
                jax_flops.forward_flops(cfg, batch, t_in, u), name
            assert flops.train_step_flops(got_cfgs[name], batch, t_in, u,
                                          n_ctx=4, l_ctx=3) == \
                jax_flops.train_step_flops(cfg, batch, t_in, u, n_ctx=4,
                                           l_ctx=3), name
        layer = cfg["encoder_conf"].get("input_layer", "conv2d")
        for t in (7, 64, 511):
            assert flops.subsampled_len(t, layer) == \
                jax_flops.subsampled_len(t, layer)
    assert flops.train_step_flops(got_cfgs["conformer_rnnt_bias"], 256,
                                  512, 32) > 1e13

