"""The port's export CLI (``wenet_celoss_tpu_torch/bin/export.py``) and int8
bundles (``utils/quantize.py``) against the JAX package's.

The tiny ``u2pp_conformer`` of ``test_torch_runtime_worker`` (its seeded
JAX ``.ckpt``) is exported by both packages on the CPU: the port's CLI in
a subprocess with ``yaml``, ``msgpack`` and ``flax`` blocked (the machine
with the card has none of them), the JAX CLI in process. Each ``.pt2``
runs after ``torch.export.load`` on the same inputs as the JAX StableHLO
artifact (deserialized with ``jax.export``): outputs within 1e-5, the
chunk step over two chunks with its caches passed on. The manifests are
equal but for the artifact names, and the graphs hold K1 as the
registered operator. The int8 weights equal the JAX package's bit for
bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax import export as jax_export

from test_torch_models import _fill
from test_torch_runtime_worker import (shape_only_init, tiny_config,
                                       write_model_dir)
from wenet_celoss_tpu.bin import export as jax_export_cli
from wenet_celoss_tpu.models.factory import init_example
from wenet_celoss_tpu.models.factory import init_model as jax_init_model
from wenet_celoss_tpu.utils import quantize as jax_quantize
from wenet_celoss_tpu_torch.bin import export
from wenet_celoss_tpu_torch.models.factory import init_model
from wenet_celoss_tpu_torch.utils import quantize
from wenet_celoss_tpu_torch.utils.convert import (jax_channel_axis,
                                                  params_from_jax)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
FLAGS = ["--max_frames", "128", "--chunk_size", "4", "--num_left_chunks",
         "2", "--beam", "3", "--max_hyp_len", "8"]
K1_OP = torch.ops.wenet_torch.ln_ffn_residual_fwd.default


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("export")
    model_dir = write_model_dir(tmp / "model", "u2pp")
    base = ["--config", str(model_dir / "train.yaml"), "--checkpoint",
            str(model_dir / "final.ckpt")] + FLAGS
    argv = base + ["--output_dir", str(tmp / "torch"), "--device", "cpu"]
    code = ("import sys\n"
            "for m in ('yaml', 'msgpack', 'flax', 'jax'):\n"
            "    sys.modules[m] = None\n"
            "from wenet_celoss_tpu_torch.bin import export\n"
            f"export.main({argv!r})\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with shape_only_init():
        old = sys.argv
        sys.argv = ["export"] + base + ["--output_dir", str(tmp / "jax")]
        try:
            jax_export_cli.main()
        finally:
            sys.argv = old
    return tmp, model_dir


def tensor_bytes(tree) -> int:
    """The bytes of every tensor in a (bundle's) dict, entries' too."""
    return sum(tensor_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in tree.values())


def _jax(tmp, name):
    with open(tmp / "jax" / f"{name}.stablehlo", "rb") as f:
        return jax_export.deserialize(f.read())


def _torch(tmp, name, sub="torch"):
    return torch.export.load(str(tmp / sub / f"{name}.pt2"))


def _close(got, want):
    got, want = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(
        want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), atol=TOL, rtol=0)


def test_encoder_ctc_matches_jax(exported):
    tmp, _ = exported
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((1, 128, 40)).astype(np.float32)
    lens = np.array([100], np.int32)
    want = _jax(tmp, "encoder_ctc").call(jnp.asarray(feats),
                                         jnp.asarray(lens))
    got = _torch(tmp, "encoder_ctc").module()(torch.from_numpy(feats),
                                              torch.from_numpy(lens))
    _close(got, want)


def test_chunk_step_matches_jax(exported):
    """Two chunks, each program's own cache passed on (att_len and offset
    as 0-d int32 tensors in both)."""
    tmp, _ = exported
    man = yaml.safe_load((tmp / "torch" / "manifest.yaml").read_text())
    jexp = _jax(tmp, "encoder_chunk_ctc")
    tprog = _torch(tmp, "encoder_chunk_ctc").module()
    _, att, _, cnn, _ = jexp.in_avals
    jcache = {"att": jnp.zeros(att.shape), "att_len": jnp.int32(0),
              "cnn": jnp.zeros(cnn.shape), "offset": jnp.int32(0)}
    tcache = {"att": torch.zeros(att.shape),
              "att_len": torch.tensor(0, dtype=torch.int32),
              "cnn": torch.zeros(cnn.shape),
              "offset": torch.tensor(0, dtype=torch.int32)}
    rng = np.random.default_rng(2)
    for _ in range(2):
        xs = rng.standard_normal((1, man["window"], 40)).astype(np.float32)
        jy, jlp, jcache = jexp.call(jnp.asarray(xs), jcache)
        ty, tlp, tcache = tprog(torch.from_numpy(xs), tcache)
        _close((ty, tlp, tcache), (jy, jlp, jcache))
    assert int(tcache["offset"]) == 8 and int(tcache["att_len"]) == 8


def test_decoder_scores_matches_jax(exported):
    tmp, _ = exported
    jexp = _jax(tmp, "decoder_scores")
    rng = np.random.default_rng(3)
    mem_av, mask_av, hyp_av, _, _ = jexp.in_avals
    n, t_sub = mask_av.shape
    memory = rng.standard_normal(mem_av.shape).astype(np.float32)
    mask = np.arange(t_sub)[None, :] < rng.integers(5, t_sub, (n, 1))
    hyps = rng.integers(1, 22, hyp_av.shape).astype(np.int32)
    hyps[:, 0] = 23
    lens = rng.integers(2, hyp_av.shape[1] + 1, (n,)).astype(np.int32)
    args = (memory, mask, hyps, lens, hyps[:, ::-1].copy())
    want = jexp.call(*map(jnp.asarray, args))
    got = _torch(tmp, "decoder_scores").module()(*map(torch.from_numpy,
                                                      args))
    _close(got, want)


def test_manifest_matches_jax_but_names(exported):
    tmp, _ = exported
    got = yaml.safe_load((tmp / "torch" / "manifest.yaml").read_text())
    want = yaml.safe_load((tmp / "jax" / "manifest.yaml").read_text())
    assert got.pop("artifacts") == ["encoder_ctc.pt2",
                                    "encoder_chunk_ctc.pt2",
                                    "decoder_scores.pt2", "params.pt"]
    assert want.pop("artifacts") == [
        "encoder_ctc.stablehlo", "encoder_chunk_ctc.stablehlo",
        "decoder_scores.stablehlo", "params.mspk"]
    assert got == want


@pytest.mark.parametrize("name,want", [("encoder_ctc", 4),
                                       ("encoder_chunk_ctc", 4),
                                       ("decoder_scores", 2)])
def test_graph_holds_k1_operator(exported, name, want):
    """Two blocks × two FFN halves in each encoder graph; one FFN in each
    of the two decoders."""
    tmp, _ = exported
    graph = _torch(tmp, name).graph
    assert sum(n.target is K1_OP for n in graph.nodes) == want


def test_int8_export_and_bundle(exported):
    """--quantize int8 in process: the bundle holds one int8 byte a
    weight of every tensor of two or more axes plus an fp32 scale a
    channel, the rest in fp32 (0.301× the fp32 bundle's bytes at this
    size; the 0.3× bound is held on the transducer below and at full
    width on the card), and its weights are the programs' weights (the
    encoder program against the live model loaded from the bundle)."""
    tmp, model_dir = exported
    export.main(["--config", str(model_dir / "train.yaml"), "--checkpoint",
                 str(model_dir / "final.ckpt"), *FLAGS, "--output_dir",
                 str(tmp / "int8"), "--device", "cpu", "--quantize",
                 "int8"])
    man = yaml.safe_load((tmp / "int8" / "manifest.yaml").read_text())
    assert man["quantize"] == "int8"
    assert man["artifacts"][-1] == "params_int8.pt"
    bundle = torch.load(tmp / "int8" / "params_int8.pt", weights_only=True)
    fp32 = torch.load(tmp / "torch" / "params.pt", weights_only=True)
    assert set(bundle) == set(fp32)
    want = sum(t.numel() + 4 * t.shape[jax_channel_axis(k, t.dim())]
               if t.dim() >= 2 else 4 * t.numel() for k, t in fp32.items())
    assert tensor_bytes(bundle) == want
    model = init_model(tiny_config("u2pp"), device="cpu")
    model.load_state_dict(quantize.load_quantized(
        str(tmp / "int8" / "params_int8.pt")))
    feats = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 128, 40)).astype(np.float32))
    lens = torch.tensor([90], dtype=torch.int32)
    with torch.no_grad():
        want = model.encode_ctc(feats, lens)
    got = _torch(tmp, "encoder_ctc", "int8").module()(feats, lens)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=0)


def test_quantize_matches_jax_bitwise(tmp_path):
    """The tiny transducer (dense, conv2d, depthwise, LSTM gates,
    embeddings, rel-pos biases): the port's dequantized tensors equal
    params_from_jax of the JAX package's, bit for bit; load_quantized
    reads the JAX package's .mspk to the same tensors."""
    cfg = tiny_config("rnnt")
    shapes = jax.eval_shape(jax_init_model(cfg).init, jax.random.PRNGKey(0),
                            *init_example(cfg))
    params = _fill(shapes, seed=7)["params"]
    want = params_from_jax({"params": jax_quantize.dequantize_params(
        jax_quantize.quantize_params(params))})
    model = init_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax({"params": params}),
                          strict=False)
    q = quantize.quantize_params(model.state_dict())
    assert q["predictor.rnn.0.wi.weight"][quantize.Q_KEY].dtype == \
        torch.int8
    got = quantize.dequantize_params(q)
    assert set(want) <= set(got)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    jax_quantize.save_quantized(params, str(tmp_path / "params_int8.mspk"))
    back = quantize.load_quantized(str(tmp_path / "params_int8.mspk"))
    assert set(back) == set(want)
    for k, w in want.items():
        assert torch.equal(back[k], w), k
    assert tensor_bytes(q) <= 0.3 * tensor_bytes(model.state_dict())
    quantize.save_quantized(model.state_dict(), str(tmp_path / "q.pt"))
    back = quantize.load_quantized(str(tmp_path / "q.pt"))
    for k, v in got.items():
        assert torch.equal(back[k], v), k


def test_export_device_flag_goes_through_resolve_device(tmp_path,
                                                        monkeypatch):
    """No card: the CLI raises unless given --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--config", "train.yaml", "--checkpoint", "final.ckpt",
            "--output_dir", str(tmp_path)]
    assert export.get_parser().parse_args(argv).device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.main(argv)
