"""U2++ streaming in the port held against the JAX package on the CPU in
fp32, at tiny sizes (2 blocks, d <= 64, K = 7):

- the chunk masks (full, fixed chunk with 2 and unlimited left chunks,
  static chunk, dynamic at decode) equal; the dynamic draw's mapping to
  (chunk, left chunks) equals the JAX package's, its random draws
  scripted, over every draw in 1..T;
- the causal conv module on a padded batch and chunk by chunk through its
  frame cache, and both attentions' ``forward_with_cache`` over a partly
  filled ring with an utterance that ends inside the chunk (1e-5);
- ``forward_chunk`` chunk by chunk for the causal conformer and the
  abs-pos transformer against JAX's ``forward_chunk_by_chunk`` (1e-5),
  and against the port's own chunk-masked full forward on the valid
  frames (2e-5, the JAX package's contract);
- ``Decoder.encode_ctc_streaming`` on the tiny ``u2pp_conformer`` with
  ragged lengths (output, mask and CTC log-probs, 1e-4), and the CTC
  greedy and attention-rescoring hypotheses with ``simulate_streaming``;
- three ``make_train_step`` steps of the tiny U2++ model with a static
  chunk: plain, under ``CONV_PALLAS=1`` (K8's plain version, causal)
  and under ``LNMM_PALLAS=conv`` (K7 with the causal bias rows) with the
  JAX package's ln_matmul route switched on (tolerances of
  ``test_torch_train.check_train_steps``);
- the dynamic chunk draws from the step's generator only, and a U2++
  model raises when it trains without one; a causal batch_norm module
  raises.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as ttrain
from test_torch_models import _fill
from wenet_celoss_tpu.configs import u2pp_conformer as jax_u2pp
from wenet_celoss_tpu.decode.api import Decoder as JaxDecoder
from wenet_celoss_tpu.decode.streaming import \
    forward_chunk_by_chunk as jax_chunk_by_chunk
from wenet_celoss_tpu.models import attention as jax_attention
from wenet_celoss_tpu.models.convolution import \
    ConvolutionModule as JaxConv
from wenet_celoss_tpu.models.encoder import \
    ConformerEncoder as JaxConformerEncoder
from wenet_celoss_tpu.models.encoder import \
    TransformerEncoder as JaxTransformerEncoder
from wenet_celoss_tpu.models.factory import init_example
from wenet_celoss_tpu.models.factory import init_model as jax_init_model
from wenet_celoss_tpu.ops import ffn_pallas
from wenet_celoss_tpu.parallel import train as jax_train
from wenet_celoss_tpu.utils import mask as jax_mask
from wenet_celoss_tpu_torch.configs import u2pp_conformer
from wenet_celoss_tpu_torch.decode.api import Decoder
from wenet_celoss_tpu_torch.decode.streaming import (chunk_geometry,
                                                     forward_chunk_by_chunk)
from wenet_celoss_tpu_torch.models import encoder_layer
from wenet_celoss_tpu_torch.models.attention import (
    MultiHeadedAttention, RelPositionMultiHeadedAttention)
from wenet_celoss_tpu_torch.models.convolution import ConvolutionModule
from wenet_celoss_tpu_torch.models.embedding import sinusoid_table
from wenet_celoss_tpu_torch.models.encoder import (ConformerEncoder,
                                                   TransformerEncoder)
from wenet_celoss_tpu_torch.models.factory import init_model
from wenet_celoss_tpu_torch.ops import conv as port_conv
from wenet_celoss_tpu_torch.ops import ln_matmul as lnmm
from wenet_celoss_tpu_torch.parallel import train
from wenet_celoss_tpu_torch.utils import mask
from wenet_celoss_tpu_torch.utils.convert import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
FEAT, D, K = 16, 16, 7
VOCAB = ttrain.VOCAB


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                      else x)


def _dense(p):
    """A flax Dense's params → a torch Linear's state dict."""
    out = {"weight": torch.as_tensor(np.asarray(p["kernel"]).T.copy())}
    if "bias" in p:
        out["bias"] = torch.as_tensor(np.asarray(p["bias"]))
    return out


def _prefixed(prefix, sd):
    return {f"{prefix}.{k}": v for k, v in sd.items()}


# ------------------------------------------------------------- masks ---
@pytest.mark.parametrize("dynamic,decode,static,left", [
    (False, 0, 0, -1),     # full context
    (True, 3, 0, 2),       # fixed chunk, 2 left chunks
    (True, 3, 0, -1),      # fixed chunk, unlimited left context
    (True, -1, 0, -1),     # dynamic model, full context at decode
    (False, 0, 4, -1),     # static chunk
    (False, 3, 4, 1)])     # static model, decode-time chunk
def test_chunk_masks_match_jax(dynamic, decode, static, left):
    lens = np.array([13, 9, 1])
    pad = np.arange(13)[None, :] < lens[:, None]
    kw = dict(use_dynamic_chunk=dynamic, use_dynamic_left_chunk=False,
              decoding_chunk_size=decode, static_chunk_size=static,
              num_decoding_left_chunks=left)
    want = jax_mask.add_optional_chunk_mask(jnp.asarray(pad), **kw)
    got = mask.add_optional_chunk_mask(torch.as_tensor(pad), **kw)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    for chunk, nl in ((3, 2), (4, -1), (1, 0), (13, 1)):
        want = jax_mask.subsequent_chunk_mask(13, jnp.asarray(chunk),
                                              jnp.asarray(nl))
        for args in ((chunk, nl), (torch.tensor(chunk), torch.tensor(nl))):
            np.testing.assert_array_equal(
                _np(mask.subsequent_chunk_mask(13, *args)),
                np.asarray(want))


@pytest.mark.parametrize("t,left", [(50, False), (50, True), (127, True)])
def test_dynamic_draw_mapping_matches_jax(monkeypatch, t, left):
    """For every draw in 1..T (and left-chunk fractions 0, 0.5, 0.99) the
    JAX package's (chunk, left chunks), read off its calls with
    ``jax.random.randint`` scripted, equal :func:`mask.dynamic_chunk`'s."""
    script = {}
    seen = []

    def randint(key, shape, minval, maxval, dtype=jnp.int32):
        if int(minval) == 1:
            return jnp.asarray(script["draw"], dtype)
        return jnp.asarray(int(script["u"] * int(maxval)), dtype)

    def chunk_mask(size, chunk_size, num_left_chunks):
        seen.append((int(chunk_size), int(num_left_chunks)))
        return jnp.ones((size, size), bool)

    monkeypatch.setattr(jax.random, "randint", randint)
    monkeypatch.setattr(jax_mask, "subsequent_chunk_mask", chunk_mask)
    pad = jnp.ones((1, t), bool)
    fracs = (0.0, 0.5, 0.99) if left else (0.0,)
    for draw in range(1, t + 1):
        for u in fracs:
            script.update(draw=draw, u=u)
            jax_mask.add_optional_chunk_mask(
                pad, use_dynamic_chunk=True, use_dynamic_left_chunk=left,
                decoding_chunk_size=0, static_chunk_size=0,
                num_decoding_left_chunks=-1, rng=jax.random.PRNGKey(0))
            assert mask.dynamic_chunk(draw, t, left, u) == seen[-1], \
                (draw, u)
    chunks = {c for c, _ in seen}
    assert t in chunks and set(range(1, 26)) <= chunks


# ------------------------------------------------------ conv module ---
@functools.lru_cache(maxsize=None)
def _conv_pair():
    jm = JaxConv(D, K, "layer_norm", causal=True)
    x = jnp.zeros((2, 9, D))
    v = _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), seed=3)
    p = v["params"]
    tm = ConvolutionModule(D, K, "layer_norm", causal=True)
    sd = {**_prefixed("pointwise_conv1", _dense(p["pointwise_conv1"])),
          **_prefixed("pointwise_conv2", _dense(p["pointwise_conv2"])),
          "depthwise_conv.weight": torch.as_tensor(np.transpose(
              np.asarray(p["depthwise_conv"]["kernel"]), (2, 1, 0)).copy()),
          "depthwise_conv.bias": torch.as_tensor(
              np.asarray(p["depthwise_conv"]["bias"])),
          "norm_layer.weight": torch.as_tensor(
              np.asarray(p["norm_layer"]["scale"])),
          "norm_layer.bias": torch.as_tensor(
              np.asarray(p["norm_layer"]["bias"]))}
    tm.load_state_dict(sd, strict=True)
    return jm, v, tm.eval()


def test_causal_conv_module_matches_jax():
    """A padded batch (the left pad in the raw domain, pads masked in and
    out), then the same frames chunk by chunk (3, 5 and 4 frames) through
    ``forward_with_cache`` from a zero cache: each chunk and each new
    cache against the JAX module's, and the chunks together equal to the
    port's full-context output of the unpadded utterance."""
    jm, v, tm = _conv_pair()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, D)).astype(np.float32)
    pad = np.arange(12)[None, :] < np.array([12, 7])[:, None]
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(pad))
    with torch.no_grad():
        full = tm(torch.as_tensor(x), torch.as_tensor(pad))
    np.testing.assert_allclose(_np(full), np.asarray(want), **TOL)
    j_cache = jnp.zeros((2, K - 1, D))
    t_cache = torch.zeros(2, K - 1, D)
    outs, start = [], 0
    for size in (3, 5, 4):
        xs = x[:, start:start + size]
        start += size
        want, j_cache = jm.apply(v, jnp.asarray(xs), j_cache,
                                 method="forward_with_cache")
        with torch.no_grad():
            got, t_cache = tm.forward_with_cache(torch.as_tensor(xs),
                                                 t_cache)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        np.testing.assert_allclose(_np(t_cache), np.asarray(j_cache), **TOL)
        outs.append(got)
    np.testing.assert_allclose(_np(torch.cat(outs, 1))[0], _np(full)[0],
                               **TOL)


def test_causal_batch_norm_module_raises():
    with pytest.raises(ValueError, match="layer_norm"):
        ConvolutionModule(D, K, "batch_norm", causal=True)
    with pytest.raises(ValueError, match="causal"):
        ConvolutionModule(D, K, "layer_norm").forward_with_cache(
            torch.zeros(1, 2, D), torch.zeros(1, 0, D))


# -------------------------------------------------------- attention ---
@pytest.mark.parametrize("rel", [False, True])
def test_attention_forward_with_cache_matches_jax(rel):
    """A ring of C = 8 slots with 5 valid, 4 new frames, and a key mask
    ending the second utterance after 2 of them: output, new ring and
    its valid length."""
    heads, c, t, offset = 2, 8, 4, 11
    j_cls = (jax_attention.RelPositionMultiHeadedAttention if rel
             else jax_attention.MultiHeadedAttention)
    jm = j_cls(heads, D)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((2, t, D)), jnp.float32)
    v = _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, x, x,
                             None, jnp.zeros((1, t, D))), seed=4)
    t_cls = RelPositionMultiHeadedAttention if rel else MultiHeadedAttention
    tm = t_cls(heads, D)
    p = v["params"]
    sd = {}
    for name in ("linear_q", "linear_k", "linear_v", "linear_out",
                 "linear_pos"):
        if name in p:
            sd.update(_prefixed(name, _dense(p[name])))
    for name in ("pos_bias_u", "pos_bias_v"):
        if name in p:
            sd[name] = torch.as_tensor(np.asarray(p[name]))
    tm.load_state_dict(sd, strict=True)
    cache = rng.standard_normal((2, heads, c, 2 * D // heads)).astype(
        np.float32)
    valid = np.array([t, 2])
    key_ok = np.concatenate([np.ones((2, c), bool),
                             np.arange(t)[None, :] < valid[:, None]], 1)
    m = key_ok[:, None, :]
    pos = sinusoid_table(torch.arange(offset - c, offset + t)[None, :], D)
    want, j_ring, j_len = jm.apply(
        v, x, x, x, jnp.asarray(cache), jnp.asarray(5), jnp.asarray(m),
        jnp.asarray(pos.numpy()), method="forward_with_cache")
    xt = torch.as_tensor(np.array(x))
    with torch.no_grad():
        got, ring, new_len = tm.forward_with_cache(
            xt, xt, xt, torch.as_tensor(cache), 5, torch.as_tensor(m), pos)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(ring), np.asarray(j_ring), **TOL)
    assert new_len == int(j_len) == 8


# ---------------------------------------------------------- encoders ---
ENC_KW = dict(output_size=D, attention_heads=2, linear_units=32,
              num_blocks=2, dropout_rate=0.0, positional_dropout_rate=0.0,
              attention_dropout_rate=0.0)
ENCODERS = {
    "conformer": (JaxConformerEncoder, ConformerEncoder,
                  dict(pos_enc_layer_type="rel_pos", causal=True,
                       cnn_module_kernel=K, cnn_module_norm="layer_norm")),
    "transformer": (JaxTransformerEncoder, TransformerEncoder,
                    dict(pos_enc_layer_type="abs_pos")),
}
CHUNK, LEFT = 4, 2


@functools.lru_cache(maxsize=None)
def _encoder_pair(name):
    j_cls, t_cls, kw = ENCODERS[name]
    jm = j_cls(input_size=FEAT, static_chunk_size=CHUNK, **ENC_KW, **kw)
    x = jnp.zeros((1, 67, FEAT))
    v = _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x,
                             jnp.array([67])), seed=6)
    tm = t_cls(FEAT, static_chunk_size=CHUNK, **ENC_KW, **kw)
    sd = params_from_jax({"params": {"encoder": v["params"]}})
    tm.load_state_dict({k[len("encoder."):]: t for k, t in sd.items()},
                       strict=True)
    return jm, v, tm.eval()


@pytest.mark.parametrize("name", ["conformer", "transformer"])
def test_forward_chunk_matches_jax_and_the_masked_forward(name):
    """Five chunks of 4 output frames (left 2 chunks) of a ragged batch,
    the second utterance ending inside the fourth chunk: every chunk
    against JAX's chunk-by-chunk forward, the final caches too; and the
    streamed output against the port's full forward under the same chunk
    mask on each utterance's valid frames."""
    jm, v, tm = _encoder_pair(name)
    stride, window = chunk_geometry(4, 6, CHUNK)
    n = 5
    t = window + (n - 1) * stride
    rng = np.random.default_rng(8)
    feats = (0.5 * rng.standard_normal((2, t, FEAT))).astype(np.float32)
    lens = np.array([t, 3 * stride + 9])
    out_lens = ((lens - 1) // 2) // 2 + 1    # the subsampled lengths
    j_cache = jm.apply(v, 2, CHUNK * LEFT, method="init_cache")

    def j_step(xs, c, valid):
        return jm.apply(v, xs, c, chunk_valid=valid, method="forward_chunk")
    want, j_final = jax_chunk_by_chunk(
        j_step, j_cache, jnp.asarray(feats), 4, 6, CHUNK,
        out_lens=jnp.asarray(out_lens))
    t_cache = tm.init_cache(2, CHUNK * LEFT)
    got, t_final = forward_chunk_by_chunk(
        tm.forward_chunk, t_cache, torch.as_tensor(feats), 4, 6, CHUNK,
        out_lens=torch.as_tensor(out_lens))
    assert got.shape == (2, n * CHUNK, D)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for key in ("att", "cnn"):
        np.testing.assert_allclose(_np(t_final[key]),
                                   np.asarray(j_final[key]), **TOL)
    assert t_final["att_len"] == int(j_final["att_len"]) == CHUNK * LEFT
    assert t_final["offset"] == int(j_final["offset"]) == n * CHUNK
    with torch.no_grad():
        full, pad = tm(torch.as_tensor(feats), torch.as_tensor(lens), None,
                       CHUNK, LEFT)
    for i, n_valid in enumerate(np.minimum(out_lens, n * CHUNK)):
        np.testing.assert_allclose(_np(got)[i, :n_valid],
                                   _np(full)[i, :n_valid], rtol=2e-5,
                                   atol=2e-5)
    assert (_np(pad).sum(1) == np.minimum(out_lens, full.shape[1])).all()


def test_streaming_a_non_causal_conformer_raises():
    tm = ConformerEncoder(FEAT, cnn_module_norm="layer_norm", **ENC_KW)
    with pytest.raises(NotImplementedError, match="causal"):
        tm.forward_chunk(torch.zeros(1, 15, FEAT), tm.init_cache(1, 8))


# ---------------------------------------------------------- decoder ---
def _u2pp_cfg(static_chunk=0):
    cfg = jax_u2pp(tiny=True, vocab_size=VOCAB)
    cfg["encoder_conf"].update(dropout_rate=0.0, positional_dropout_rate=0.0,
                               attention_dropout_rate=0.0)
    cfg["decoder_conf"].update(dropout_rate=0.0, positional_dropout_rate=0.0,
                               self_attention_dropout_rate=0.0,
                               src_attention_dropout_rate=0.0)
    cfg["encoder_conf"]["cnn_module_kernel"] = K
    cfg["scheduler_conf"]["warmup_steps"] = 2
    if static_chunk:
        cfg["encoder_conf"].update(use_dynamic_chunk=False,
                                   static_chunk_size=static_chunk)
    return cfg


@functools.lru_cache(maxsize=None)
def _u2pp_pair(static_chunk=0):
    cfg = _u2pp_cfg(static_chunk)
    jm = jax_init_model(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *init_example(cfg, frames=16, labels=2))
    variables = _fill(shapes, seed=9)
    tm = init_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(variables), strict=True)
    return cfg, jm, variables, tm


@functools.lru_cache(maxsize=None)
def _decoders():
    _, jm, v, tm = _u2pp_pair()
    return JaxDecoder(jm, v), Decoder(tm, device="cpu")


def _feats():
    """3 utterances of 111, 80 and 47 frames: 6 chunks of 4 at the
    longest, the others ending inside a chunk."""
    rng = np.random.default_rng(10)
    feats = rng.standard_normal((3, 111, 80)).astype(np.float32)
    return feats, np.array([111, 80, 47], np.int32)


@pytest.mark.parametrize("left", [2, -1])
def test_encode_ctc_streaming_matches_jax(left):
    jd, td = _decoders()
    feats, lens = _feats()
    want = jd.encode_ctc_streaming(feats, lens, 4, left)
    got = td.encode_ctc_streaming(feats, lens, 4, left)
    assert got[0].shape == (3, 24, 64)
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    for g, w in zip((got[0], got[2]), (want[0], want[2])):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("mode", ["ctc_greedy_search",
                                  "attention_rescoring"])
def test_streaming_decode_modes_match_jax(mode):
    jd, td = _decoders()
    feats, lens = _feats()
    kw = dict(simulate_streaming=True, decoding_chunk_size=4,
              num_decoding_left_chunks=2)
    if mode == "attention_rescoring":
        kw.update(beam=4, ctc_weight=0.5, reverse_weight=0.3)
    want = getattr(jd, mode)(feats, lens, **kw)
    assert getattr(td, mode)(feats, lens, **kw) == want
    assert sum(map(len, want)) >= 3


# --------------------------------------------------------- training ---
class _Counting:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.fixture
def _route(request, monkeypatch):
    """"plain"; "conv": CONV_PALLAS=1 in the port (K8's plain version,
    counted; the JAX package's layers run the unfused module); "lnmm":
    LNMM_PALLAS=conv in the port (K7 counted) and the JAX conv module's
    ln_matmul route forced on, in interpret mode."""
    route = request.param
    counting = None
    if route == "conv":
        monkeypatch.setenv("CONV_PALLAS", "1")
        counting = _Counting(port_conv.conv_block_residual)
        monkeypatch.setattr(encoder_layer, "conv_block_residual", counting)
    elif route == "lnmm":
        monkeypatch.setenv("LNMM_PALLAS", "conv")
        counting = _Counting(lnmm.ln_matmul)
        monkeypatch.setattr(lnmm, "ln_matmul", counting)
        monkeypatch.setattr(JaxConv, "_use_ln_mm", lambda self: True)
        monkeypatch.setattr(ffn_pallas, "ln_matmul",
                            functools.partial(ffn_pallas.ln_matmul,
                                              interpret=True))
    return route, counting


@functools.lru_cache(maxsize=None)
def _jax_step_fns(ln_matmul_route: bool):
    """The JAX package's grad and apply functions for the static-chunk
    U2++ model, and its optimizer; traced at first call (under the
    ln_matmul route's patches for ``ln_matmul_route``)."""
    cfg, jm, _, _ = _u2pp_pair(static_chunk=4)
    tx, _ = jax_train.make_optimizer(cfg)
    return jax_train.make_grad_fn(jm), jax_train.make_apply_fn(tx), tx


@pytest.mark.parametrize("_route", ["plain", "conv", "lnmm"],
                         indirect=True)
def test_u2pp_train_steps_match_jax(_route):
    """Three steps of the tiny U2++ model (static chunk 4, so both
    packages mask the same chunks) against the JAX package's grad and
    apply functions traced under the same route: losses, pre-clip gnorm,
    every parameter and update (``check_train_steps``). The causal conv
    runs as K8 (one call a layer a step) or with K7's bias rows."""
    route, counting = _route
    cfg, _, v, tm = _u2pp_pair(static_chunk=4)
    # The JAX layers run the unfused module under "conv" too, so the plain
    # route's compiled functions serve both; "lnmm" traces anew.
    grad_fn, apply_fn, tx = _jax_step_fns(route == "lnmm")
    batch = ttrain._batch(feat_seed=2)
    ttrain.check_train_steps(
        cfg, copy.deepcopy(tm), v["params"], grad_fn, apply_fn, tx, batch,
        ttrain._torch_batch(batch), ("loss", "loss_att", "loss_ctc"))
    if counting is not None:
        assert counting.calls == 3 * cfg["encoder_conf"]["num_blocks"]


def test_dynamic_chunk_draws_from_the_step_generator_only():
    """A U2++ model in training mode raises without a generator; with one,
    the same seed gives the same losses, and the global generator is left
    as it was."""
    _, _, _, tm = _u2pp_pair()
    batch = ttrain._torch_batch(ttrain._batch())
    state = train.TrainState(0, tm, None)
    grad_fn = train.make_grad_fn(tm)
    with pytest.raises(ValueError, match="generator"):
        grad_fn(state, batch, None)
    before = torch.get_rng_state()
    runs = [grad_fn(state, batch, torch.Generator().manual_seed(s))[1]
            for s in (3, 3, 4)]
    assert torch.equal(before, torch.get_rng_state())
    assert float(runs[0]["loss"]) == float(runs[1]["loss"])
    tm.eval()
