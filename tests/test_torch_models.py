"""The PyTorch port held against the JAX package, module by module and for
the whole RNN-T greedy decode, on the tiny flagship in fp32 on the CPU.

Both packages get the same weights: seeded numpy values in the JAX
package's parameter tree, carried to the port by the weight bridge.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from wenet_celoss_tpu.configs import conformer_rnnt_bias
from wenet_celoss_tpu.decode.api import Decoder as JaxDecoder
from wenet_celoss_tpu.models.factory import init_example
from wenet_celoss_tpu.models.factory import init_model as jax_init_model
from wenet_celoss_tpu.ops.fbank import FbankConfig as JaxFbankConfig
from wenet_celoss_tpu.ops.fbank import compute_fbank_np as jax_fbank_np
from wenet_celoss_tpu_torch.data.wav import read_wav
from wenet_celoss_tpu_torch.decode.api import Decoder
from wenet_celoss_tpu_torch.models.factory import init_model
from wenet_celoss_tpu_torch.ops.fbank import FbankConfig, compute_fbank_np
from wenet_celoss_tpu_torch.utils.convert import params_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)
# Blank bias on the joint output and hotword-gate bias: with these the
# tiny random model emits a few tokens a row and gates some of them on.
BLANK_BIAS, GATE_BIAS = 1.5, 1.3
VOCAB = 30


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _fill(shapes, seed):
    """Seeded numpy values for every leaf of a flax variables tree."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(s.shape) / np.sqrt(
                np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(s.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        if name == "embedding":
            return rng.standard_normal(s.shape)
        return 0.1 * rng.standard_normal(s.shape)   # biases, means, u/v

    return jax.tree_util.tree_map_with_path(
        lambda p, s: leaf(p, s).astype(np.float32), shapes)


@functools.lru_cache(maxsize=None)
def _pair(conv_norm: str = "layer_norm"):
    """(cfg, jax model, jax variables, torch model) sharing weights."""
    cfg = conformer_rnnt_bias(tiny=True, vocab_size=VOCAB)
    cfg["encoder_conf"]["cnn_module_norm"] = conv_norm
    jm = jax_init_model(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *init_example(cfg, frames=16, labels=2))
    variables = _fill(shapes, seed=0)
    variables["params"]["joint"]["ffn_out"]["bias"][0] += BLANK_BIAS
    variables["params"]["context_bias"]["hw_output_layer"]["bias"][1] += \
        GATE_BIAS
    tm = init_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(variables), strict=True)
    return cfg, jm, variables, tm


def _inputs():
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((4, 64, 80)).astype(np.float32)
    lens = np.array([64, 50, 33, 20], np.int32)
    ctx = np.array([[0, -1, -1], [3, 4, 5], [7, 8, -1], [9, 10, 11]],
                   np.int32)
    ctx_lens = np.array([1, 3, 2, 3], np.int32)
    return feats, lens, ctx, ctx_lens


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("conv_norm", ["layer_norm", "batch_norm"])
def test_encoder_matches_jax(conv_norm):
    _, jm, v, tm = _pair(conv_norm)
    feats, lens, _, _ = _inputs()
    j_out, _, _, j_mask = jm.apply(v, feats, lens, None,
                                   method="encode_transducer")
    with torch.no_grad():
        t_out, _, _, t_mask = tm.encode_transducer(_t(feats),
                                                   _t(lens, torch.long))
    mask = np.asarray(j_mask)
    np.testing.assert_array_equal(t_mask.numpy(), mask)
    np.testing.assert_allclose(t_out.numpy()[mask], np.asarray(j_out)[mask],
                               **TOL)


def test_context_bias_branches_match_jax():
    """bias_hidden, the encoder and predictor bias branches, and the
    per-frame hotword gate."""
    _, jm, v, tm = _pair()
    feats, lens, ctx, ctx_lens = _inputs()
    j_bh = jm.apply(v, ctx, ctx_lens, method="bias_hidden")
    _, j_eb, j_ebias, j_mask = jm.apply(v, feats, lens, j_bh,
                                        method="encode_transducer")
    pred = np.random.default_rng(2).standard_normal((4, 64)).astype(
        np.float32)
    j_pb = jm.apply(v, j_bh, pred, method="predictor_bias_step")
    j_gate = jm.apply(v, j_ebias, method="hw_gate_frames")
    with torch.no_grad():
        t_bh = tm.bias_hidden(_t(ctx, torch.long), _t(ctx_lens, torch.long))
        _, t_eb, t_ebias, _ = tm.encode_transducer(
            _t(feats), _t(lens, torch.long), t_bh)
        t_pb = tm.predictor_bias_step(t_bh, _t(pred))
        t_gate = tm.hw_gate_frames(t_ebias)
    mask = np.asarray(j_mask)
    np.testing.assert_allclose(t_bh.numpy(), np.asarray(j_bh), **TOL)
    np.testing.assert_allclose(t_eb.numpy()[mask], np.asarray(j_eb)[mask],
                               **TOL)
    np.testing.assert_allclose(t_ebias.numpy()[mask],
                               np.asarray(j_ebias)[mask], **TOL)
    for got, want in zip(t_pb, j_pb):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(t_gate.numpy()[mask],
                                  np.asarray(j_gate)[mask])


def test_predictor_steps_and_joint_frames_match_jax():
    """Several predictor steps with some rows frozen, then the joint of
    one frame and of every frame against the last predictor output."""
    _, jm, v, tm = _pair()
    rng = np.random.default_rng(3)
    b = 4
    j_state = jm.apply(v, b, method="predictor_init_state")
    t_state = tm.predictor_init_state(b)
    for step in range(4):
        tok = rng.integers(0, VOCAB, (b,)).astype(np.int32)
        pad = (rng.random(b) < 0.3).astype(np.int32) if step else \
            np.zeros(b, np.int32)
        j_out, j_state = jm.apply(v, tok, j_state, pad,
                                  method="predictor_step")
        with torch.no_grad():
            t_out, t_state = tm.predictor_step(_t(tok, torch.long), t_state,
                                               _t(pad, torch.long))
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
        for key in ("h", "c"):
            np.testing.assert_allclose(t_state[key].numpy(),
                                       np.asarray(j_state[key]), **TOL)
    enc = rng.standard_normal((b, 9, 64)).astype(np.float32)
    j_single = jm.apply(v, enc[:, 0], j_out, method="joint_step")
    with torch.no_grad():
        t_single = tm.joint.single(_t(enc[:, 0]), t_out)
    np.testing.assert_allclose(t_single.numpy(), np.asarray(j_single), **TOL)
    j_enc = jm.apply(v, enc, method="joint_enc_proj")
    j_logits = jm.apply(v, method=lambda m: m.joint.frames(
        m.joint.project_enc(enc), j_out))
    with torch.no_grad():
        t_enc = tm.joint_enc_proj(_t(enc))
        t_logits = tm.joint_frames(t_enc, t_out)
    np.testing.assert_allclose(t_enc.numpy(), np.asarray(j_enc), **TOL)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)


@pytest.mark.parametrize("context", ["none", "on", "off"])
def test_greedy_decode_matches_jax(context):
    """Whole slice: identical hyps (and per-token gates) to the JAX
    Decoder, plain and hotword-gated."""
    _, jm, v, tm = _pair()
    feats, lens, ctx, ctx_lens = _inputs()
    kw = {} if context == "none" else dict(
        context_list=ctx, context_lengths=ctx_lens,
        context_filter_state=context)
    jd, td = JaxDecoder(jm, v), Decoder(tm, device="cpu")
    want = jd.rnnt_greedy_search(feats, lens, n_steps=3, **kw)
    got = td.rnnt_greedy_search(feats, lens, n_steps=3, **kw)
    assert got == want
    assert sum(map(len, want)) >= 4, "the model should emit tokens"
    if context != "none":
        j_gates, t_gates = np.asarray(jd.last_gates[0]), \
            td.last_gates[0].numpy()
        gates = [list(t_gates[i, :len(h)]) for i, h in enumerate(got)]
        assert gates == [list(j_gates[i, :len(h)])
                         for i, h in enumerate(want)]
        flat = np.concatenate(gates)
        assert 0 < flat.mean() < 1, "gates should be mixed on this model"


def test_bridge_raises_on_unknown_leaf():
    _, _, v, tm = _pair()
    params = dict(v["params"])
    sd = params_from_jax({"params": params,
                          "batch_stats": v.get("batch_stats", {})})
    assert set(sd) == set(tm.state_dict())
    # No subtree is skipped any more: the decoder maps leaf by leaf.
    with pytest.raises(KeyError, match="anything"):
        params_from_jax({"params": dict(params, decoder=dict(
            params["decoder"], anything=np.zeros(3, np.float32)))})
    bad = dict(params, context_bias=dict(
        params["context_bias"], mystery={"kernel": np.zeros((2, 2))}))
    with pytest.raises(KeyError, match="mystery"):
        params_from_jax({"params": bad})
    bad_leaf = dict(params, joint=dict(
        params["joint"], ffn_out={"kernel": np.zeros((2, 2)),
                                  "scale": np.zeros(2)}))
    with pytest.raises(KeyError, match="scale"):
        params_from_jax({"params": bad_leaf})
    with pytest.raises(KeyError, match="cache"):
        params_from_jax({"params": params, "cache": {}})


def test_entry_points_need_the_card_or_cpu(monkeypatch):
    cfg, _, _, tm = _pair()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Decoder(tm)


def test_fbank_matches_jax_package():
    """The port's numpy front end against the JAX package's, on a
    committed WAV."""
    import pathlib
    wav_dir = (pathlib.Path(__file__).resolve().parent.parent / "examples"
               / "librispeech" / "data_hw" / "test-clean" / "wavs")
    wav, sr = read_wav(str(sorted(wav_dir.glob("*.wav"))[0]))
    assert sr == 16000
    got = compute_fbank_np(wav, FbankConfig())
    want = jax_fbank_np(wav, JaxFbankConfig())
    assert got.shape == want.shape == (got.shape[0], 80)
    np.testing.assert_array_equal(got, want)


def test_cmvn_loaders_and_apply_match_jax_package(tmp_path):
    import json

    from wenet_celoss_tpu.models.cmvn import load_cmvn as jax_load_cmvn
    from wenet_celoss_tpu_torch.models.cmvn import apply_cmvn, load_cmvn
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((50, 80)) * 3.0 + 1.0
    path = tmp_path / "global_cmvn"
    path.write_text(json.dumps({
        "mean_stat": frames.sum(0).tolist(),
        "var_stat": (frames ** 2).sum(0).tolist(), "frame_num": 50}))
    kaldi = tmp_path / "cmvn.ark"
    kaldi.write_text(
        " [\n " + " ".join(map(str, frames.sum(0))) + " 50\n "
        + " ".join(map(str, (frames ** 2).sum(0))) + " 0 ]\n")
    for p, is_json in ((path, True), (kaldi, False)):
        mean, istd = load_cmvn(str(p), is_json)
        j_mean, j_istd = jax_load_cmvn(str(p), is_json)
        np.testing.assert_array_equal(mean, j_mean)
        np.testing.assert_array_equal(istd, j_istd)
    x = rng.standard_normal((2, 7, 80)).astype(np.float32)
    got = apply_cmvn(torch.from_numpy(x), torch.from_numpy(mean),
                     torch.from_numpy(istd))
    np.testing.assert_allclose(got.numpy(), (x - j_mean) * j_istd,
                               rtol=1e-6, atol=1e-6)
