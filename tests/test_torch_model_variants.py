"""Every model the JAX factory builds, held against the JAX package at tiny
widths in fp32 on the CPU: the front ends (linear, conv2d, conv2d6,
conv2d8) with each positional encoding (abs_pos, rel_pos, no_pos),
``concat_after`` in the encoder and the decoder, a decoder without its
output layer, the GRU, embedding and conv predictors, the BLSTM, LSTM and
transformer phrase extractors with the linear and transformer bias
encoders, the pruned RNN-T loss (the simple loss, the prune ranges and
the pruned loss), a whole training step of two such models, and the
transducer beam and gated greedy decodes with the stateless predictors.

Both packages get the same weights: seeded numpy values in the JAX
parameter tree, carried to the port by the weight bridge; every dropout
rate 0. Tolerances: 1e-5 on forwards, 1e-4 on losses and gradients,
identical ranges and hypotheses.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import _fill, _inputs
from test_torch_transducer import _batch, _torch_batch
from wenet_celoss_tpu.configs import conformer_rnnt_bias
from wenet_celoss_tpu.decode.api import Decoder as JaxDecoder
from wenet_celoss_tpu.decode.streaming import \
    forward_chunk_by_chunk as jax_chunk_by_chunk
from wenet_celoss_tpu.models import context_bias as jax_cb
from wenet_celoss_tpu.models import decoder as jax_dec
from wenet_celoss_tpu.models import encoder as jax_enc
from wenet_celoss_tpu.models import predictor as jax_pred
from wenet_celoss_tpu.models.factory import init_example
from wenet_celoss_tpu.models.factory import init_model as jax_init_model
from wenet_celoss_tpu.ops import rnnt_loss as jax_rl
from wenet_celoss_tpu.parallel import train as jax_train
from wenet_celoss_tpu_torch.decode.api import Decoder
from wenet_celoss_tpu_torch.decode.streaming import (chunk_geometry,
                                                     forward_chunk_by_chunk)
from wenet_celoss_tpu_torch.models import context_bias, decoder, encoder
from wenet_celoss_tpu_torch.models import predictor
from wenet_celoss_tpu_torch.models.factory import init_model
from wenet_celoss_tpu_torch.ops import ln_matmul as lnmm
from wenet_celoss_tpu_torch.ops import rnnt_loss
from wenet_celoss_tpu_torch.parallel import train
from wenet_celoss_tpu_torch.utils.convert import params_from_jax

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
FEAT, D, VOCAB = 20, 16, 30
NO_DROP = dict(dropout_rate=0.0, positional_dropout_rate=0.0,
               attention_dropout_rate=0.0)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _load(tm, variables, scope: str, strict: bool = True):
    """The JAX variables of one module (under ``scope`` in the bridge's
    paths) into the port's module of the same config."""
    sd = params_from_jax({"params": {scope: variables["params"]}})
    sd = {k[len(scope) + 1:]: t for k, t in sd.items()}
    missing, unexpected = tm.load_state_dict(sd, strict=strict)
    assert not unexpected
    return tm.eval(), missing


# ------------------------------------------------------ front ends ---
CHUNK, LEFT = 4, 2


@functools.lru_cache(maxsize=None)
def _encoder_pair(kind, input_layer, pos, concat_after=False,
                  normalize_before=True):
    kw = dict(output_size=D, attention_heads=2, linear_units=32,
              num_blocks=1, input_layer=input_layer, pos_enc_layer_type=pos,
              static_chunk_size=CHUNK, normalize_before=normalize_before,
              concat_after=concat_after, **NO_DROP)
    if kind == "conformer":
        kw.update(causal=True, cnn_module_kernel=3,
                  cnn_module_norm="layer_norm")
        j_cls, t_cls = jax_enc.ConformerEncoder, encoder.ConformerEncoder
    else:
        j_cls, t_cls = jax_enc.TransformerEncoder, encoder.TransformerEncoder
    jm = j_cls(input_size=FEAT, **kw)
    v = _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                             jnp.zeros((1, 67, FEAT)), jnp.array([67])),
              seed=3)
    tm, _ = _load(t_cls(FEAT, **kw), v, "encoder")
    return jm, v, tm


def _check_encoder(jm, v, tm, full_context: bool = True):
    """The full forward on a ragged batch and two streamed chunks (left
    context 2 chunks), each against the JAX package's."""
    rate, right = tm.subsampling_rate, tm.right_context
    assert (rate, right) == (jm.subsampling_rate, jm.right_context)
    stride, window = chunk_geometry(rate, right, CHUNK)
    t = window + stride
    rng = np.random.default_rng(4)
    feats = (0.5 * rng.standard_normal((2, t, FEAT))).astype(np.float32)
    lens = np.array([t, t - rate - 1], np.int32)
    if full_context:
        want, j_mask = jax.jit(lambda v, x, n: jm.apply(v, x, n, -1))(
            v, feats, lens)
        with torch.no_grad():
            got, t_mask = tm(torch.as_tensor(feats), torch.as_tensor(lens),
                             None, -1)
        np.testing.assert_array_equal(_np(t_mask), np.asarray(j_mask))
        m = np.asarray(j_mask)
        np.testing.assert_allclose(_np(got)[m], np.asarray(want)[m], **FWD)
    j_cache = jm.apply(v, 2, CHUNK * LEFT, method="init_cache")
    j_step = jax.jit(functools.partial(jm.apply, method="forward_chunk"))
    want, _ = jax_chunk_by_chunk(lambda xs, c: j_step(v, xs, c), j_cache,
                                 jnp.asarray(feats), rate, right, CHUNK)
    got, _ = forward_chunk_by_chunk(tm.forward_chunk,
                                    tm.init_cache(2, CHUNK * LEFT),
                                    torch.as_tensor(feats), rate, right,
                                    CHUNK)
    assert got.shape == (2, 2 * CHUNK, D)
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)


@pytest.mark.parametrize("pos", ["abs_pos", "rel_pos", "no_pos"])
@pytest.mark.parametrize("input_layer",
                         ["linear", "conv2d", "conv2d6", "conv2d8"])
def test_front_end_and_position_encoding_match_jax(input_layer, pos):
    """The causal conformer with each front end and encoding (plain MHA
    unless rel_pos): forward and forward_chunk."""
    jm, v, tm = _encoder_pair("conformer", input_layer, pos)
    attn = type(tm.layers[0].self_attn).__name__
    assert (attn == "RelPositionMultiHeadedAttention") == (pos == "rel_pos")
    _check_encoder(jm, v, tm)


@pytest.mark.parametrize("normalize_before", [True, False])
def test_encoder_concat_after_matches_jax(normalize_before):
    """The transformer encoder with concat_after, pre- and post-norm:
    forward and forward_chunk (whose step adds the attention's output
    alone, as the JAX package's does)."""
    jm, v, tm = _encoder_pair("transformer", "conv2d6", "abs_pos", True,
                              normalize_before)
    assert tm.layers[0].concat_linear is not None
    _check_encoder(jm, v, tm)


def test_conformer_default_position_encoding_is_the_jax_packages():
    """Without ``pos_enc_layer_type`` both packages' conformers take the
    absolute encoding and plain MHA (the JAX encoders' default is
    abs_pos whichever the encoder)."""
    assert jax_enc.ConformerEncoder(input_size=FEAT).pos_enc_layer_type \
        == "abs_pos"
    tm = encoder.ConformerEncoder(FEAT, D, 2, 32, 1)
    assert type(tm.embed.pos_enc).__name__ == "PositionalEncoding"
    assert type(tm.layers[0].self_attn).__name__ == "MultiHeadedAttention"


def test_conformer_accepts_and_ignores_concat_after():
    a = encoder.ConformerEncoder(FEAT, D, 2, 32, 1, concat_after=True,
                                 selfattention_layer_type="rel_selfattn",
                                 positionwise_conv_kernel_size=1)
    b = encoder.ConformerEncoder(FEAT, D, 2, 32, 1)
    assert set(a.state_dict()) == set(b.state_dict())


# ---------------------------------------------------------- decoder ---
@pytest.mark.parametrize("normalize_before,concat_after,use_output_layer", [
    (True, True, True), (False, True, True), (True, False, False)])
def test_decoder_variants_match_jax(normalize_before, concat_after,
                                    use_output_layer, monkeypatch):
    """The bidirectional decoder with concat_after (pre- and post-norm;
    no layer reaches K7 even with LNMM_PALLAS set) and without its output
    layer: teacher-forced logits and one beam step."""
    kw = dict(vocab_size=VOCAB, encoder_output_size=D, attention_heads=2,
              linear_units=32, num_blocks=1, r_num_blocks=1,
              dropout_rate=0.0, positional_dropout_rate=0.0,
              normalize_before=normalize_before, concat_after=concat_after,
              use_output_layer=use_output_layer)
    rng = np.random.default_rng(5)
    mem = rng.standard_normal((2, 9, D)).astype(np.float32)
    mask = np.arange(9)[None, :] < np.array([9, 6])[:, None]
    ys = rng.integers(1, VOCAB, (2, 5)).astype(np.int32)
    ys_lens = np.array([5, 3], np.int32)
    jm = jax_dec.BiTransformerDecoder(**kw)
    v = _fill(jax.eval_shape(
        functools.partial(jm.init, reverse_weight=0.3),
        jax.random.PRNGKey(0), mem, mask, ys, ys_lens, ys), seed=2)
    tm, _ = _load(decoder.BiTransformerDecoder(**kw), v, "decoder")
    assert (tm.left_decoder.output_layer is None) != use_output_layer
    want = jax.jit(functools.partial(jm.apply, reverse_weight=0.3))(
        v, mem, mask, ys, ys_lens, ys)
    monkeypatch.setenv("LNMM_PALLAS", "1")
    fused = []
    real = lnmm.ln_matmul
    monkeypatch.setattr(lnmm, "ln_matmul",
                        lambda *a, **k: fused.append(1) or real(*a, **k))
    with torch.no_grad():
        got = tm(*(torch.as_tensor(a) for a in (mem, mask)),
                 torch.as_tensor(ys, dtype=torch.long),
                 torch.as_tensor(ys_lens, dtype=torch.long),
                 torch.as_tensor(ys, dtype=torch.long), 0.3)
        step = tm.forward_one_step(torch.as_tensor(mem),
                                   torch.as_tensor(mask),
                                   torch.as_tensor(ys, dtype=torch.long), 2)
    assert bool(fused) == (normalize_before and not concat_after)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **FWD)
    j_step = jax.jit(functools.partial(jm.apply, method="forward_one_step"))(
        v, mem, mask, ys, 2)
    np.testing.assert_allclose(_np(step), np.asarray(j_step), **FWD)


# -------------------------------------------------------- predictors ---
PREDICTORS = {
    "gru": (jax_pred.RNNPredictor, predictor.RNNPredictor,
            dict(embed_size=D, output_size=D, hidden_size=D, num_layers=2,
                 rnn_type="gru", embed_dropout=0.0, dropout=0.0)),
    "embedding": (jax_pred.EmbeddingPredictor, predictor.EmbeddingPredictor,
                  dict(embed_size=D, embed_dropout=0.0, n_head=2,
                       history_size=2)),
    "conv": (jax_pred.ConvPredictor, predictor.ConvPredictor,
             dict(embed_size=D, embed_dropout=0.0, history_size=2,
                  bias=True)),
}


@pytest.mark.parametrize("name", list(PREDICTORS))
def test_predictor_matches_jax(name):
    """The whole-sequence forward, then three decode steps from the zero
    state with one row frozen by the padding at each step."""
    j_cls, t_cls, kw = PREDICTORS[name]
    jm = j_cls(voca_size=VOCAB, **kw)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, VOCAB, (3, 7)).astype(np.int32)
    v = _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0), toks), seed=4)
    tm, _ = _load(t_cls(voca_size=VOCAB, **kw), v, "predictor")
    with torch.no_grad():
        got = tm(torch.as_tensor(toks, dtype=torch.long))
    np.testing.assert_allclose(_np(got), np.asarray(jax.jit(jm.apply)(
        v, toks)), **FWD)
    j_state = jm.apply(v, 3, method="init_state")
    t_state = tm.init_state(3, torch.device("cpu"))
    j_fwd_step = jax.jit(functools.partial(jm.apply, method="forward_step"))
    for u in range(3):
        pad = (np.arange(3) == u).astype(np.int32)
        j_out, j_state = j_fwd_step(v, toks[:, u], j_state, pad)
        with torch.no_grad():
            t_out, t_state = tm.forward_step(
                torch.as_tensor(toks[:, u], dtype=torch.long), t_state,
                torch.as_tensor(pad, dtype=torch.long))
        np.testing.assert_allclose(_np(t_out), np.asarray(j_out), **FWD)
        assert set(t_state) == set(j_state)
        for k in t_state:
            np.testing.assert_allclose(_np(t_state[k]),
                                       np.asarray(j_state[k]), **FWD)


# ---------------------------------------------------------- context ---
@pytest.mark.parametrize("bias_encoder", ["linear", "transformer"])
@pytest.mark.parametrize("extractor", ["BLSTM", "LSTM", "transformer"])
def test_context_towers_match_jax(extractor, bias_encoder):
    """forward_bias_hidden over 5 phrase slots, the last two past
    n_valid (empty phrases, -1 padded; the transformer bias encoder's
    keys stop at n_valid)."""
    kw = dict(output_size=D, vocab_size=VOCAB, embedding_size=D,
              num_layers=1, attention_heads=2, linear_units=32,
              num_block=2, bias_encoder_type=bias_encoder,
              context_extractor=extractor)
    ctx = np.array([[3, 4, 5], [7, -1, -1], [9, 10, -1], [-1] * 3,
                    [-1] * 3], np.int32)
    lens = np.array([3, 1, 2, 0, 0], np.int32)
    n_valid = np.array(3, np.int32)
    jm = jax_cb.ContextBias(**kw)
    v = _fill(jax.eval_shape(
        functools.partial(jm.init, method="forward_bias_hidden"),
        jax.random.PRNGKey(0), ctx, lens, n_valid), seed=7)
    tm, missing = _load(context_bias.ContextBias(**kw), v, "context_bias",
                        strict=False)
    tower = ("extractor.", "context_encoder.", "context_proj.",
             "context_norm.")
    assert not [k for k in missing if k.startswith(tower)]
    want = jax.jit(functools.partial(jm.apply, method="forward_bias_hidden"))(
        v, ctx, lens, n_valid)
    with torch.no_grad():
        got = tm.forward_bias_hidden(torch.as_tensor(ctx, dtype=torch.long),
                                     torch.as_tensor(lens, dtype=torch.long),
                                     torch.as_tensor(n_valid))
    assert got.shape == (1, 5, D)
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)


# ----------------------------------------------------- pruned loss ---
def _lattice_inputs():
    rng = np.random.default_rng(8)
    b, t, u, v = 3, 9, 5, 11
    am = rng.standard_normal((b, t, v)).astype(np.float32)
    lm = rng.standard_normal((b, u + 1, v)).astype(np.float32)
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    t_lens = np.array([9, 7, 4], np.int32)
    u_lens = np.array([5, 3, 0], np.int32)
    labels[np.arange(u)[None, :] >= u_lens[:, None]] = 0
    return am, lm, labels, t_lens, u_lens


def _lt(*arrays):
    return [torch.as_tensor(a, dtype=torch.long) if a.dtype == np.int32
            else torch.tensor(a, requires_grad=True) for a in arrays]


@pytest.mark.parametrize("what", ["simple", "ranges", "pruned"])
def test_pruned_loss_parts_match_jax(what):
    """rnnt_loss_simple (K9's plain version under the closed-form
    gradient) and rnnt_loss_pruned, values and gradients; the prune
    ranges identical, and those of rnnt_loss_simple_and_ranges too."""
    am, lm, labels, t_lens, u_lens = _lattice_inputs()
    s = 3
    t_am, t_lm, t_lab, t_tl, t_ul = _lt(am, lm, labels, t_lens, u_lens)
    if what == "ranges":
        want = np.asarray(jax_rl.get_rnnt_prune_ranges(
            am, lm, labels, t_lens, u_lens, s))
        got = rnnt_loss.get_rnnt_prune_ranges(t_am, t_lm, t_lab, t_tl, t_ul,
                                              s)
        np.testing.assert_array_equal(_np(got), want)
        _, both = rnnt_loss.rnnt_loss_simple_and_ranges(
            t_am, t_lm, t_lab, t_tl, t_ul, s)
        np.testing.assert_array_equal(_np(both), want)
        assert (want[:, -1] > 0).any() and (np.diff(want, axis=1) >= 0).all()
        return
    if what == "simple":
        def j_fn(a, m):
            return jnp.sum(jax_rl.rnnt_loss_simple(a, m, labels, t_lens,
                                                   u_lens) * jnp.arange(1, 4))
        want, (g_a, g_m) = jax.jit(jax.value_and_grad(j_fn, (0, 1)))(am,
                                                                     lm)
        got = rnnt_loss.rnnt_loss_simple(t_am, t_lm, t_lab, t_tl, t_ul)
        (got * torch.arange(1, 4)).sum().backward()
        np.testing.assert_allclose(float((got * torch.arange(1, 4)).sum()),
                                   float(want), **GRAD)
        np.testing.assert_allclose(_np(t_am.grad), np.asarray(g_a), **GRAD)
        np.testing.assert_allclose(_np(t_lm.grad), np.asarray(g_m), **GRAD)
        return
    ranges = np.asarray(jax_rl.get_rnnt_prune_ranges(am, lm, labels, t_lens,
                                                     u_lens, s))
    logits = np.random.default_rng(9).standard_normal(
        am.shape[:2] + (s, am.shape[2])).astype(np.float32)

    def j_fn(x):
        return jnp.sum(jax_rl.rnnt_loss_pruned(x, ranges, labels, t_lens,
                                               u_lens) * jnp.arange(1, 4))
    want, g = jax.value_and_grad(j_fn)(logits)   # not jittable in JAX
    (t_x,) = _lt(logits)
    got = rnnt_loss.rnnt_loss_pruned(t_x, torch.as_tensor(ranges).long(),
                                     t_lab, t_tl, t_ul)
    total = (got * torch.arange(1, 4)).sum()
    total.backward()
    np.testing.assert_allclose(float(total), float(want), **GRAD)
    np.testing.assert_allclose(_np(t_x.grad), np.asarray(g), **GRAD)


# -------------------------------------------------------- whole models ---
def _v1():
    """conformer with conv2d6 + rel_pos, transformer extractor and bias
    encoder, embedding predictor, pruned loss, concat_after decoder."""
    cfg = conformer_rnnt_bias(tiny=True, vocab_size=VOCAB)
    cfg["encoder_conf"].update(input_layer="conv2d6")
    cfg["context_conf"].update(context_extractor="transformer",
                               bias_encoder_type="transformer")
    cfg["predictor"] = "embedding"
    cfg["model_conf"]["rnnt_impl"] = "pruned"
    cfg["decoder_conf"]["concat_after"] = True
    return cfg


def _v2():
    """transformer encoder with conv2d8, no_pos and concat_after, LSTM
    extractor, GRU predictor, streaming loss."""
    cfg = conformer_rnnt_bias(tiny=True, vocab_size=VOCAB)
    cfg["encoder"] = "transformer"
    cfg["encoder_conf"].update(input_layer="conv2d8",
                               pos_enc_layer_type="no_pos",
                               concat_after=True)
    cfg["context_conf"]["context_extractor"] = "LSTM"
    cfg["predictor_conf"]["rnn_type"] = "gru"
    return cfg


def _v3():
    """conformer with a linear front end and abs_pos, conv predictor."""
    cfg = conformer_rnnt_bias(tiny=True, vocab_size=VOCAB)
    cfg["encoder_conf"].update(input_layer="linear",
                               pos_enc_layer_type="abs_pos")
    cfg["predictor"] = "conv"
    return cfg


VARIANTS = {"v1": _v1, "v2": _v2, "v3": _v3}


@functools.lru_cache(maxsize=None)
def _model_pair(name):
    cfg = VARIANTS[name]()
    # One encoder block and one bias-encoder block: the JAX trace and
    # compile of a training step grows with every block.
    cfg["encoder_conf"]["num_blocks"] = 1
    cfg["context_conf"]["num_block"] = 1
    for conf in (cfg["encoder_conf"], cfg["decoder_conf"]):
        for k in list(conf) + ["positional_dropout_rate"]:
            if k.endswith("dropout_rate"):
                conf[k] = 0.0
    cfg["predictor_conf"].update(embed_dropout=0.0, dropout=0.0)
    jm = jax_init_model(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *init_example(cfg, frames=64, labels=2))
    v = _fill(shapes, seed=0)
    tm = init_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(v), strict=True)
    return cfg, jm, v, tm


def _long_batch():
    """The flagship tests' batch (hotwords, hw labels, two empty phrase
    slots) at three times its frames, so that every utterance keeps more
    frames than its CTC alignment needs after the ×6 and ×8 front ends
    (an infeasible CTC loss is ~1e5 and swamps every gradient)."""
    batch = _batch()
    rng = np.random.default_rng(12)
    batch["feats"] = rng.standard_normal((4, 192, 80)).astype(np.float32)
    batch["feat_lengths"] = batch["feat_lengths"] * 3
    return batch


@pytest.mark.parametrize("name", ["v1", "v2"])
def test_training_step_matches_jax(name):
    """Every loss term and every parameter gradient of one step against
    the JAX package's make_grad_fn, each gradient to 1e-4 of its largest
    element (floored at 1e-3); the key projections' biases, zero in exact
    arithmetic, under 1e-6 in both packages."""
    _, jm, v, tm = _model_pair(name)
    batch = _long_batch()
    state = jax_train.TrainState(step=jnp.zeros((), jnp.int32),
                                 params=v["params"], opt_state=None)
    j_grads, j_metrics, _ = jax_train.make_grad_fn(jm)(
        state, batch, jax.random.PRNGKey(0))
    want = params_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, j_grads)})
    grads, metrics = train.make_grad_fn(tm)(
        train.TrainState(0, tm, None), _torch_batch(batch),
        torch.Generator())
    for k in ("loss", "loss_rnnt", "loss_ctc", "loss_att", "hw_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   rtol=1e-4, err_msg=k)
    names = [n for n, _ in tm.named_parameters()]
    assert set(names) == set(want)
    bad = []
    for n, g in zip(names, grads):
        w = want[n].numpy()
        if n.endswith("linear_k.bias"):
            # Zero in exact arithmetic (softmax ignores a shift shared by
            # all keys): both packages' values must be rounding noise.
            noise = max(float(np.abs(w).max()), float(g.abs().max()))
            if not noise <= 1e-6:
                bad.append((n, noise, 0.0))
            continue
        scale = max(float(np.abs(w).max()), 1e-3)
        err = float(np.abs(g.numpy() - w).max())
        if not err <= 1e-4 * scale:
            bad.append((n, err, scale))
    assert not bad, bad


@pytest.mark.parametrize("name", ["v1", "v3"])
def test_transducer_decodes_match_jax(name):
    """The RNN-T beam (the stateless predictor's history gathered on its
    rows) and the gated greedy decode: identical hypotheses."""
    _, jm, v, tm = _model_pair(name)
    feats, lens, ctx, ctx_lens = _inputs()
    jd, td = JaxDecoder(jm, v), Decoder(tm, device="cpu")
    kw = dict(beam=3)
    j_res, _, _ = jd.rnnt_beam_search(feats, lens, **kw)
    t_res, _, _ = td.rnnt_beam_search(feats, lens, **kw)
    assert td.rnnt_beam_to_lists(t_res) == jd.rnnt_beam_to_lists(j_res)
    np.testing.assert_array_equal(_np(t_res["lens"]),
                                  np.asarray(j_res["lens"]))
    kw = dict(context_list=ctx, context_lengths=ctx_lens,
              context_filter_state="on", n_steps=3)
    assert td.rnnt_greedy_search(feats, lens, **kw) == \
        jd.rnnt_greedy_search(feats, lens, **kw)
