"""The port's serving worker (``wenet_celoss_tpu_torch/bin/runtime_worker.py``)
against the JAX package's, on tiny models (two blocks, d = 32, vocab 24)
whose seeded weights are saved once as a JAX ``.ckpt`` that both workers
read: the tiny ``u2pp_conformer`` (streamable: the chunk step with its
caches) and a tiny ``conformer_rnnt_bias`` (non-causal: the chunk-masked
prefix, plus the transducer requests).

- ``rnnt_greedy_chunk`` against JAX's on a state carried across two
  chunks;
- the workers in process: every ``O`` reply within 1e-5 over a stream
  that crosses several windows and ends with a flush, ``greedy_new_tokens``
  equal call by call, ``rnnt_beam`` token lists equal and scores within
  1e-4, ``rescore`` within 1e-4;
- both workers as subprocesses over pipes with one frame script: reply
  headers equal byte for byte, payloads within the same tolerances;
- ``decoder_main`` (the C++ serving stack) once per mode with
  ``--worker_cmd`` naming each worker: equal result lines.

The JAX worker initialises its flax module eagerly before it loads the
checkpoint, ~40 s at this size on the CPU; here ``Module.init`` returns
zeros of the right shapes instead (``shape_only_init``, and the
``JAX_LAUNCHER`` script for its subprocesses): the checkpoint replaces
every parameter either way.
"""

import argparse
import contextlib
import fcntl
import os
import struct
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

from test_torch_models import _fill
from wenet_celoss_tpu import configs as jax_configs
from wenet_celoss_tpu.bin import runtime_worker as jax_worker
from wenet_celoss_tpu.decode.rnnt_greedy import \
    rnnt_greedy_chunk as jax_greedy_chunk
from wenet_celoss_tpu.models.factory import init_example
from wenet_celoss_tpu.models.factory import init_model as jax_init_model
from wenet_celoss_tpu.utils import checkpoint as jax_ckpt
from wenet_celoss_tpu_torch.bin import runtime_worker
from wenet_celoss_tpu_torch.decode.rnnt_greedy import rnnt_greedy_chunk

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "runtime" / "build"
WAVS = ROOT / "examples" / "librispeech" / "data_hw" / "test-clean" / "wavs"
VOCAB = 24
MEL = 40
CHUNK = 4
LOG_TOL, SCORE_TOL = 1e-5, 1e-4

JAX_LAUNCHER = """\
import jax
import jax.numpy as jnp
import flax.linen as nn

_init = nn.Module.init


def _shape_only_init(self, rngs, *args, **kwargs):
    shapes = jax.eval_shape(lambda r: _init(self, r, *args, **kwargs), rngs)
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                  shapes)


nn.Module.init = _shape_only_init
from wenet_celoss_tpu.bin.runtime_worker import main  # noqa: E402

main()
"""


@contextlib.contextmanager
def shape_only_init():
    """flax ``Module.init`` gives zeros of the right shapes (see the
    module docstring)."""
    init = fnn.Module.init

    def shapes_only(self, rngs, *args, **kwargs):
        shapes = jax.eval_shape(lambda r: init(self, r, *args, **kwargs),
                                rngs)
        return jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    fnn.Module.init = shapes_only
    try:
        yield
    finally:
        fnn.Module.init = init


def tiny_config(kind: str) -> dict:
    """"u2pp": the tiny U2++ conformer (causal conv, chunk step);
    "rnnt": a tiny flagship transducer (non-causal conv)."""
    if kind == "u2pp":
        cfg = jax_configs.u2pp_conformer(input_dim=MEL, vocab_size=VOCAB,
                                         tiny=True)
    else:
        cfg = jax_configs.conformer_rnnt_bias(input_dim=MEL,
                                              vocab_size=VOCAB, tiny=True)
        cfg["predictor_conf"].update(embed_size=32, output_size=32,
                                     hidden_size=32)
        cfg["joint_conf"].update(join_dim=64)
        cfg["context_conf"].update(embedding_size=32, linear_units=64)
    cfg["encoder_conf"].update(num_blocks=2, output_size=32,
                               linear_units=64, attention_heads=2,
                               cnn_module_kernel=7)
    cfg["decoder_conf"].update(num_blocks=1, r_num_blocks=1,
                               linear_units=64, attention_heads=2)
    # The C API reads the mel bins from the model directory's train.yaml.
    cfg.setdefault("dataset_conf", {}).setdefault(
        "fbank_conf", {})["num_mel_bins"] = MEL
    return cfg


def write_model_dir(path: Path, kind: str) -> Path:
    """train.yaml, final.ckpt (seeded JAX weights) and units.txt."""
    path.mkdir(parents=True, exist_ok=True)
    cfg = tiny_config(kind)
    shapes = jax.eval_shape(jax_init_model(cfg).init, jax.random.PRNGKey(0),
                            *init_example(cfg))
    jax_ckpt.save_checkpoint(_fill(shapes, seed=5)["params"],
                             str(path / "final.ckpt"))
    with open(path / "train.yaml", "w") as f:
        yaml.dump(cfg, f)
    syms = ["<blank>"] + [chr(65 + i) for i in range(VOCAB - 2)] + \
        ["<sos/eos>"]
    (path / "units.txt").write_text(
        "".join(f"{s} {i}\n" for i, s in enumerate(syms)))
    return path


def worker_args(model_dir: Path, chunk: int = CHUNK) -> list:
    return ["--config", str(model_dir / "train.yaml"), "--checkpoint",
            str(model_dir / "final.ckpt"), "--chunk_size", str(chunk)]


def make_workers(model_dir: Path):
    ns = dict(config=str(model_dir / "train.yaml"),
              checkpoint=str(model_dir / "final.ckpt"), chunk_size=CHUNK,
              num_left_chunks=2)
    with shape_only_init():
        jw = jax_worker.Worker(argparse.Namespace(**ns))
    tw = runtime_worker.Worker(argparse.Namespace(**ns, device="cpu"))
    return jw, tw


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serving")
    return {kind: write_model_dir(tmp / kind, kind)
            for kind in ("u2pp", "rnnt")}


@pytest.fixture(scope="module")
def rnnt_workers(model_dirs):
    return make_workers(model_dirs["rnnt"])


def test_worker_device_flag_goes_through_resolve_device(model_dirs,
                                                        monkeypatch):
    """No card: the worker raises unless given --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = runtime_worker.get_parser().parse_args(
        worker_args(model_dirs["u2pp"]))
    assert args.device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime_worker.Worker(args)


def test_rnnt_greedy_chunk_matches_jax(rnnt_workers):
    """Two encoder chunks of two rows, the carry passed on: the tokens,
    lengths and predictor output after each chunk."""
    jw, tw = rnnt_workers
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((2, 10, 32)).astype(np.float32)
    enc[1] *= 0.2   # a second row that emits on fewer frames

    def jstep(tok, state, padding=None):
        return jw.model.apply(jw.variables, tok, state, padding,
                              method="predictor_step")

    def jjoint(enc_t, pred_u):
        return jw.model.apply(jw.variables, enc_t, pred_u,
                              method="joint_step")

    state = jw.model.apply(jw.variables, 2, method="predictor_init_state")
    jcarry = jstep(jnp.zeros((2,), jnp.int32), state,
                   jnp.zeros((2,), jnp.int32))
    model = tw.model
    tcarry = model.predictor_step(torch.zeros(2, dtype=torch.long),
                                  model.predictor_init_state(2),
                                  torch.zeros(2, dtype=torch.long))
    for lo, hi in ((0, 6), (6, 10)):
        jt, jl, jcarry = jax_greedy_chunk(jstep, jjoint, jcarry,
                                          jnp.asarray(enc[:, lo:hi]))
        with torch.no_grad():
            tt, tl, tcarry = rnnt_greedy_chunk(
                model.predictor_step, model.joint_step, tcarry,
                torch.from_numpy(enc[:, lo:hi]))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        for i in range(2):
            n = int(tl[i])
            np.testing.assert_array_equal(tt[i, :n].numpy(),
                                          np.asarray(jt)[i, :n])
        np.testing.assert_allclose(tcarry[0].numpy(),
                                   np.asarray(jcarry[0]), atol=1e-5)
    assert int(tl.sum()) > 0


def _stream(jw, tw, feats, sizes):
    """Feed both workers the same pieces, then flush; compare each O
    reply and, on a transducer, each G reply. → frames emitted."""
    jw.reset()
    tw.reset()
    assert jw.meta() == tw.meta()
    pos, frames = 0, 0
    for size in list(sizes) + [0]:
        piece = feats[pos:pos + size]
        pos += size
        want = jw.forward_chunk(piece)
        got = tw.forward_chunk(piece)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=LOG_TOL, rtol=0)
        frames += got.shape[0]
        if jw.is_transducer:
            assert tw.greedy_new_tokens() == jw.greedy_new_tokens()
    return frames


@pytest.mark.parametrize("kind", ["u2pp", "rnnt"])
def test_worker_matches_jax_worker(kind, model_dirs, rnnt_workers):
    jw, tw = (rnnt_workers if kind == "rnnt"
              else make_workers(model_dirs["u2pp"]))
    assert tw.streamable == (kind == "u2pp") == jw.streamable
    feats = np.random.default_rng(1).standard_normal(
        (170, MEL)).astype(np.float32)
    frames = _stream(jw, tw, feats, (37, 11, 50, 3, 41))
    assert frames >= 35
    hyps = [[1, 2, 3], [4, 5], [], [7, 8, 9, 10, 11, 2, 2]]
    if kind == "rnnt":
        want, got = jw.rnnt_beam(4), tw.rnnt_beam(4)
        assert [h for h, _ in got] == [h for h, _ in want]
        np.testing.assert_allclose([s for _, s in got],
                                   [s for _, s in want], atol=SCORE_TOL)
        hyps = [h for h, _ in want] + hyps
    for rw in (0.0, 0.3):
        np.testing.assert_allclose(tw.rescore(hyps, rw),
                                   jw.rescore(hyps, rw), atol=SCORE_TOL,
                                   rtol=0)


# ------------------------------------------------ over the pipes ---
def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="2")


def _read(f, n):
    return runtime_worker.read_exact(f, n)


def _reply(f):
    """One reply → (header bytes, payload as a list of numbers)."""
    tag = _read(f, 1)
    if tag == b"M":
        raw = _read(f, 4)
        return tag + raw + _read(f, struct.unpack("<I", raw)[0]), []
    if tag == b"O":
        raw = _read(f, 8)
        t, v = struct.unpack("<II", raw)
        return tag + raw, list(np.frombuffer(_read(f, 4 * t * v), "<f4"))
    if tag in (b"T", b"S"):
        raw = _read(f, 4)
        (n,) = struct.unpack("<I", raw)
        return tag + raw, list(np.frombuffer(
            _read(f, 4 * n), "<i4" if tag == b"T" else "<f4"))
    if tag == b"N":
        raw = _read(f, 4)
        header, payload = [tag + raw], []
        for _ in range(struct.unpack("<I", raw)[0]):
            lraw = _read(f, 4)
            n = struct.unpack("<I", lraw)[0]
            header.append(lraw + _read(f, 4 * n))   # the tokens
            payload.append(struct.unpack("<f", _read(f, 4))[0])
        return b"".join(header), payload
    raise AssertionError(f"unknown reply tag {tag!r}")


def _requests(feats):
    out = [b"I" + struct.pack("<I", 0)]
    for lo, hi in ((0, 37), (37, 100), (100, 100)):
        piece = feats[lo:hi]
        out += [b"F" + struct.pack("<II", *piece.shape)
                + piece.astype("<f4").tobytes(), b"G"]
    hyps = [[3, 1, 2], [5], []]
    r = b"R" + struct.pack("<If", len(hyps), 0.3)
    for h in hyps:
        r += struct.pack("<I", len(h)) + np.asarray(h, "<i4").tobytes()
    return out + [b"B" + struct.pack("<I", 3), r]


def _run_script(cmd, feats):
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env=_env())
    try:
        replies = []
        for req in _requests(feats):
            proc.stdin.write(req)
            proc.stdin.flush()
            replies.append(_reply(proc.stdout))
        proc.stdin.write(b"Q")
        proc.stdin.close()
        assert proc.wait(timeout=60) == 0, proc.stderr.read()[-3000:]
        assert proc.stdout.read() == b"", "bytes after the last reply"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return replies


def test_protocol_over_pipes(model_dirs, tmp_path):
    """The transducer model (non-streamable path, every request) through
    both workers as subprocesses: the torch worker on the CPU, the JAX
    worker through JAX_LAUNCHER."""
    launcher = tmp_path / "jax_worker.py"
    launcher.write_text(JAX_LAUNCHER)
    args = worker_args(model_dirs["rnnt"])
    feats = np.random.default_rng(2).standard_normal(
        (100, MEL)).astype(np.float32)
    got = _run_script([sys.executable, "-m",
                       "wenet_celoss_tpu_torch.bin.runtime_worker", *args,
                       "--device", "cpu"], feats)
    want = _run_script([sys.executable, str(launcher), *args], feats)
    assert [h[:1] for h, _ in got] == [b"M", b"O", b"T", b"O", b"T",
                                       b"O", b"T", b"N", b"S"]
    for (gh, gp), (wh, wp) in zip(got, want):
        assert gh == wh
        tol = LOG_TOL if gh[:1] == b"O" else SCORE_TOL
        if gh[:1] == b"T":
            assert gp == wp
        else:
            np.testing.assert_allclose(gp, wp, atol=tol, rtol=0)


# ------------------------------------------------ decoder_main ---
@pytest.fixture(scope="session")
def runtime_build():
    os.makedirs(BUILD, exist_ok=True)
    # xdist: workers configure/build the shared tree one at a time.
    with open(os.path.join(BUILD, ".build_lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["cmake", "../core", "-G", "Ninja"], cwd=BUILD,
                       check=True, capture_output=True)
        subprocess.run(["ninja"], cwd=BUILD, check=True,
                       capture_output=True)
    return BUILD


def decoder_main(build, model_dir: Path, wav_scp: Path, worker_cmd: str,
                 mode: str, chunk: int = 8):
    """decoder_main's result lines (stdout) for ``mode``."""
    extra = [] if mode == "default" else ["--mode", mode]
    if mode == "rnnt_beam_search":
        extra += ["--beam", "4"]
    res = subprocess.run(
        [str(build / "decoder_main"), "--wav_scp", str(wav_scp),
         "--symbol_table", str(model_dir / "units.txt"),
         "--worker_cmd", worker_cmd, "--chunk_size", str(chunk),
         "--num_bins", str(MEL), *extra],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr[-3000:]
    return res.stdout.splitlines()


def torch_worker_cmd(model_dir: Path, chunk: int = 8) -> str:
    return " ".join([sys.executable, "-m",
                     "wenet_celoss_tpu_torch.bin.runtime_worker",
                     *worker_args(model_dir, chunk), "--device", "cpu"])


def write_wav_scp(path: Path, names) -> Path:
    path.write_text("".join(f"{Path(n).stem} {WAVS / n}\n" for n in names))
    return path


@pytest.mark.parametrize("mode", ["default", "rnnt_greedy_search",
                                  "rnnt_beam_search"])
def test_decoder_main_matches_jax_worker(mode, runtime_build, model_dirs,
                                         tmp_path):
    """The C++ serving stack over two WAVs with the tiny transducer (the
    default mode: CTC prefix beam and attention rescoring, 'R'; the
    transducer greedy, 'G'; the transducer beam, 'B' and 'R')."""
    model_dir = model_dirs["rnnt"]
    scp = write_wav_scp(tmp_path / "wav.scp", ["test-clean-u002.wav",
                                                "test-clean-u004.wav"])
    launcher = tmp_path / "jax_worker.py"
    launcher.write_text(JAX_LAUNCHER)
    jax_cmd = " ".join([sys.executable, str(launcher),
                        *worker_args(model_dir, 8)])
    got = decoder_main(runtime_build, model_dir, scp,
                       torch_worker_cmd(model_dir), mode)
    want = decoder_main(runtime_build, model_dir, scp, jax_cmd, mode)
    assert len(got) == 2 and got == want
    assert any(len(line.split()) > 1 for line in got), "nothing decoded"
