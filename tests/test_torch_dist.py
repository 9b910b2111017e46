"""Data parallelism and the sharded decode of the port on the CPU (gloo,
2 ranks, tiny models, fp32), against the port's one-process path and
the JAX package:

- the batch rules of ``parallel/dist.py`` against JAX ``mesh.py``
  (``pad_batch_to_multiple``; ``shard_batch``'s row split on a 2-device
  mesh, the step-global hotword list kept whole);
- the dropout masks with a global row base: ``dropout`` inside
  ``batch_part`` and the plain K1, K6, K4 and K8 with ``row_base`` (K4
  also ``global_b``) give each rank the matching rows of the whole
  batch's mask;
- 2 ranks (one spawn of ``tests/torch_dist_ranks.py`` a test session):
  2 ``make_train_step`` steps of the tiny batch_norm flagship with
  hotwords and every dropout rate 0.1, against the port's one-process
  step on the whole batch from the ranks' state before each step
  (losses and gnorm to 1e-5 relative, every
  parameter as ``test_torch_train.assert_params_match`` holds it, the
  running statistics to 1e-5; the ranks bitwise equal); the same step
  with dropout off against JAX ``make_grad_fn``/``make_apply_fn`` on a
  2-device mesh over the whole batch (loss to 1e-4, every gradient to
  1e-3 relative Frobenius, T3's bounds); ``agree_shapes`` of two
  unequal batches; ``ShardedDecoder`` over 5 utterances (one padding
  row) in every supported mode, for the tiny flagship (with hotwords,
  gating "off", "on" and "exact") and the tiny ``conformer_ctc_aed``,
  against the port's ``Decoder`` and JAX's ``ShardedDecoder`` ("exact",
  which both packages run unsplit on the plain decoder, against the
  port's ``Decoder`` only: the JAX loop is eager and takes minutes);
- the multi-host hotword list of JAX ``mesh.py`` (ROADMAP.md Queue C): a
  rank's ``hw_labels`` differ between its own list and rank 0's.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_batch_norm as tbn
import test_torch_transducer as ttrans
import torch_dist_ranks
from test_torch_models import _pair as flagship_pair
from test_torch_train import NOISE_GRAD
from test_torch_train import _pair as ctc_aed_pair
from wenet_celoss_tpu.data.processor import hw_label_generate
from wenet_celoss_tpu.decode.sharded import ShardedDecoder as JaxSharded
from wenet_celoss_tpu.parallel import mesh as jax_mesh
from wenet_celoss_tpu.parallel import train as jax_train
from wenet_celoss_tpu_torch.decode.api import Decoder
from wenet_celoss_tpu_torch.models.factory import init_model
from wenet_celoss_tpu_torch.ops import conv, dropout, ffn, lstm
from wenet_celoss_tpu_torch.parallel import dist, train
from wenet_celoss_tpu_torch.utils.convert import params_from_jax

STEPS = 2
BEAM = 3


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------- batch rules ---
def _np_batch(b=3, seed=0):
    rng = np.random.default_rng(seed)
    return {"keys": [f"u{i}" for i in range(b)],
            "feats": rng.standard_normal((b, 7, 4)).astype(np.float32),
            "feat_lengths": rng.integers(1, 8, b).astype(np.int32),
            "labels": rng.integers(0, 9, (b, 5)).astype(np.int32),
            "label_lengths": rng.integers(0, 6, b).astype(np.int32),
            # as many phrases as utterances: still step-global
            "context_list": rng.integers(0, 9, (b, 2)).astype(np.int32),
            "context_lengths": np.full((b,), 2, np.int32),
            "context_n_valid": np.int32(b)}


@pytest.mark.parametrize("b,multiple", [(3, 2), (4, 2), (5, 4), (1, 8)])
def test_pad_batch_to_multiple_matches_jax(b, multiple):
    batch = _np_batch(b)
    got = dist.pad_batch_to_multiple(batch, multiple)
    want = jax_mesh.pad_batch_to_multiple(batch, multiple)
    assert sorted(got) == sorted(want)
    assert got["keys"] == want["keys"]
    for k in want:
        if k != "keys":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype


def test_split_batch_matches_jax_shard_batch():
    """Row r's shard of JAX shard_batch on a 2-device mesh is split_batch's
    part r; the shared entries are whole in both."""
    batch = dist.pad_batch_to_multiple(_np_batch(3), 2)
    mesh = jax_mesh.make_mesh(devices=jax.devices()[:2])
    placed = jax_mesh.shard_batch(mesh, batch)
    for k, arr in placed.items():
        shards = sorted(arr.addressable_shards, key=lambda s: s.device.id)
        for r in range(2):
            got = dist.split_batch(batch, r, 2)[k]
            np.testing.assert_array_equal(got, np.asarray(shards[r].data),
                                          err_msg=k)
    assert dist.split_batch(batch, 1, 2)["keys"] == ["u2", "<pad>"]
    for k in dist.SHARED_KEYS:
        assert k in jax_mesh._SHARED_KEYS


# ----------------------------------------------------- mask row base ---
def test_dropout_sites_draw_the_whole_batchs_mask():
    """Each rank's mask is the matching rows of the whole batch's, at the
    plain sites and in the plain K1, K6, K4 and K8."""
    torch.manual_seed(0)
    x = torch.randn(4, 6, 8)
    gen = lambda: torch.Generator().manual_seed(3)   # noqa: E731
    whole = dropout.dropout(x, 0.3, gen())
    for part in range(2):
        with dropout.batch_part(part, 2):
            got = dropout.dropout(x[2 * part:2 * part + 2], 0.3, gen())
        assert torch.equal(got, whole[2 * part:2 * part + 2])
    assert dropout.current_part() == (0, 1)

    d, f, seed = 16, 32, 12345
    w = [torch.randn(s) * 0.3 for s in ((d,), (d,), (f, d), (f,), (d, f),
                                        (d,))]
    x2 = torch.randn(12, d)
    for r0 in (0, 5):
        _same_mask_rows(lambda: ffn.ln_ffn_residual_ref(
            x2, *w, "swish", 0.5, 1e-5, 0.2, 0.3, seed), lambda: (
            ffn.ln_ffn_residual_ref(x2[r0:r0 + 7], *w, "swish", 0.5, 1e-5,
                                    0.2, 0.3, seed, row_base=r0)),
            slice(r0, r0 + 7))
        _same_mask_rows(lambda: ffn.ffn_fused_ref(x2, *w[2:], "relu", 0.2,
                                                  seed),
                        lambda: ffn.ffn_fused_ref(x2[r0:r0 + 7], *w[2:],
                                                  "relu", 0.2, seed,
                                                  row_base=r0),
                        slice(r0, r0 + 7))

    h = 16
    xw1 = torch.randn(5, 4, 4 * h)
    lw = [torch.randn(4 * h, h) * 0.2, torch.randn(4 * h, h) * 0.2,
          torch.randn(4 * h) * 0.1, torch.randn(4 * h, h) * 0.2]
    for r0, n in ((0, 2), (2, 3), (3, 1)):
        _same_mask_rows(
            lambda: lstm.lstm2_seq_ref(xw1, *lw, rate=0.3, seed=seed),
            lambda: lstm.lstm2_seq_ref(xw1[r0:r0 + n], *lw, rate=0.3,
                                       seed=seed, row_base=r0, global_b=5),
            slice(r0, r0 + n))
    # the local batch's own mask is not the whole batch's rows
    with pytest.raises(AssertionError):
        _same_mask_rows(
            lambda: lstm.lstm2_seq_ref(xw1, *lw, rate=0.3, seed=seed),
            lambda: lstm.lstm2_seq_ref(xw1[2:5], *lw, rate=0.3, seed=seed),
            slice(2, 5))

    b, t, c, k = 4, 9, 8, 3
    xc = torch.randn(b, t, c)
    mask = torch.ones(b, t)
    cw = [torch.ones(c), torch.zeros(c), torch.randn(c, 2 * c) * 0.3,
          torch.zeros(2 * c), torch.randn(k, c) * 0.3, torch.zeros(c),
          torch.ones(c), torch.zeros(c), torch.randn(c, c) * 0.3,
          torch.zeros(c)]
    for r0 in (1, 2):
        _same_mask_rows(
            lambda: conv.conv_block_residual_ref(xc, mask, *cw, seed, False,
                                                 0.4),
            lambda: conv.conv_block_residual_ref(
                xc[r0:r0 + 2], mask[r0:r0 + 2], *cw, seed, False, 0.4,
                row_base=r0), slice(r0, r0 + 2))


def _masks_of(fn):
    """(fn's output, the keep mask of every apply_mask call it made)."""
    masks = []
    orig = dropout.apply_mask

    def spy(x, seed, stream, rate, offset=0):
        masks.append(orig(torch.ones_like(x), seed, stream, rate,
                          offset) != 0)
        return orig(x, seed, stream, rate, offset)

    dropout.apply_mask = spy
    try:
        return fn(), masks
    finally:
        dropout.apply_mask = orig


def _same_mask_rows(whole_fn, part_fn, rows):
    """The part's masks are the whole batch's at ``rows`` (the batch axis
    first), and so, up to rounding, are its outputs."""
    y, want = _masks_of(whole_fn)
    y_part, got = _masks_of(part_fn)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w[rows])
    torch.testing.assert_close(y_part, y[rows], rtol=1e-5, atol=1e-6)


def test_queue_c_rank_hw_labels_follow_their_own_list():
    """A rank's hw_labels were built against its own hotword list; the
    step uses rank 0's (broadcast, as mesh.py does on several hosts), so
    its labels disagree with the list the model is given."""
    rank1_labels = [[5, 6, 7, 2], [3, 5, 6]]
    own = [[0], [5, 6]]          # sampled from rank 1's own labels
    rank0 = [[0], [8, 9]]        # what rank 0 broadcasts
    got_own, _, _ = hw_label_generate(rank1_labels, own)
    got_rank0, _, _ = hw_label_generate(rank1_labels, rank0)
    assert got_own == [[1, 1, 0, 0], [0, 1, 1]]
    assert got_rank0 == [[0, 0, 0, 0], [0, 0, 0]]


# -------------------------------------------------------------- ranks ---
def _dropout_cfg():
    cfg = copy.deepcopy(tbn._pair()[0])
    for conf in (cfg["encoder_conf"], cfg["decoder_conf"]):
        for k in conf:
            if k.endswith("dropout_rate"):
                conf[k] = 0.1
    cfg["predictor_conf"].update(embed_dropout=0.1, dropout=0.1)
    return cfg


def _decode_feats():
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((5, 64, 80)).astype(np.float32)
    return feats, np.array([64, 41, 57, 20, 33], np.int32)


def _decode_calls(name):
    _, _, ctx, ctx_lens = __import__("test_torch_models")._inputs()
    calls = [("ctc_greedy_search", {}),
             ("ctc_prefix_beam_search", {"beam": BEAM}),
             ("attention", {"beam": BEAM}),
             ("attention_rescoring", {"beam": BEAM, "ctc_weight": 0.5,
                                      "reverse_weight": 0.0})]
    if name == "ctc_aed":
        return calls
    hot = {"context_list": ctx, "context_lengths": ctx_lens}
    return calls + [
        ("rnnt_greedy_search", {}),
        ("rnnt_greedy_search", dict(hot, context_filter_state="off")),
        ("rnnt_greedy_search", dict(hot, context_filter_state="on")),
        ("rnnt_greedy_search", dict(hot, context_filter_state="exact")),
        ("rnnt_beam_search", dict(hot, beam=BEAM, ctc_weight=0.3)),
        ("rnnt_beam_attn_rescoring", {"beam": BEAM, "search_ctc_weight":
                                      0.3}),
        ("ctc_beam_td_attn_rescoring", {"beam": BEAM, "ctc_weight": 0.5,
                                        "transducer_weight": 0.5,
                                        "attn_weight": 1.0})]


DECODERS = {"flagship": flagship_pair, "ctc_aed": ctc_aed_pair}


def _agree_batches():
    a, b = _np_batch(3, seed=1), _np_batch(2, seed=2)
    b["feats"] = b["feats"][:, :5]
    b["labels"] = b["labels"][:, :3]
    b["context_list"] = b["context_list"][:1]
    return [a, b]


def _jobs(tmp):
    _, _, _, tm = tbn._pair()
    state = tm.state_dict()
    jobs = [{"kind": "train", "cfg": _dropout_cfg(), "state": state,
             "batch": ttrans._batch(), "steps": STEPS, "dropout": True},
            {"kind": "train", "cfg": tbn._pair()[0], "state": state,
             "batch": ttrans._batch(), "steps": 1, "grads": True},
            {"kind": "agree", "batches": _agree_batches()}]
    feats, lens = _decode_feats()
    for name, pair in DECODERS.items():
        cfg, _, _, model = pair()
        jobs.append({"kind": "decode", "cfg": cfg,
                     "state": model.state_dict(), "feats": feats,
                     "lens": lens, "calls": _decode_calls(name)})
    return jobs, None


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank job of the module in one spawn of 2 gloo ranks, once a
    session (``torch_dist_ranks.spawn_once``)."""
    return torch_dist_ranks.spawn_once("steps", _jobs, tmp_path_factory)[0]


def _assert_same_bits(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_two_rank_steps_with_dropout_equal_the_one_process_step(ranks):
    cfg = _dropout_cfg()
    model = init_model(cfg, device="cpu")
    model.load_state_dict(tbn._pair()[3].state_dict())
    tx, schedule = train.make_optimizer(cfg)
    state = train.create_train_state(model, tx)
    grad_fn, apply_fn = train.make_grad_fn(model), train.make_apply_fn(tx)
    batch = ttrans._torch_batch(ttrans._batch())
    gen = torch.Generator().manual_seed(0)
    r0, r1 = ranks[0][0]["steps"], ranks[1][0]["steps"]
    for i in range(STEPS):
        if i:
            # Each step starts from the ranks' state after the last one
            # (parameters, running statistics, Adam's moments), so that
            # rounding does not compound from step to step.
            state.load_state_dict(r0[i - 1]["state"])
        grads, metrics = grad_fn(state, batch, gen)
        # Elements whose gradient is rounding noise (the depthwise
        # biases' is 0 in exact arithmetic: the batch norm cancels them)
        # move by up to the learning rate either way under Adam.
        noise = {n: ((g != 0) & (g.abs() < NOISE_GRAD))
                 | n.endswith("depthwise_conv.bias")
                 for (n, _), g in zip(model.named_parameters(), grads)}
        state, gnorm = apply_fn(state, grads)
        _assert_same_bits(r0[i]["state"]["model"], r1[i]["state"]["model"])
        for k in ("mu", "nu"):
            assert all(torch.equal(a, b) for a, b in zip(
                r0[i]["state"]["opt"][k], r1[i]["state"]["opt"][k]))
        assert r0[i]["metrics"] == r1[i]["metrics"]
        for k in ttrans.LOSSES:
            np.testing.assert_allclose(r0[i]["metrics"][k],
                                       float(metrics[k]), rtol=1e-5,
                                       err_msg=f"{k} step {i}")
        np.testing.assert_allclose(r0[i]["gnorm"], float(gnorm), rtol=1e-5)
        got = r0[i]["state"]["model"]
        bad = []
        lr = schedule(i)
        for name, p in model.named_parameters():
            w, g = p.detach(), got[name]
            scale = float(w.abs().max())
            limit = torch.full(w.shape, (1e-2 if name.endswith(
                "linear_k.bias") else 1e-4) * scale)
            limit = torch.where(noise[name], max(2 * lr, 1e-4 * scale),
                                limit)
            if not bool(((g - w).abs() <= limit).all()):
                bad.append((name, float(((g - w).abs() - limit).max())))
        assert not bad, (i, bad)
        for name, buf in model.named_buffers():
            if "running" in name:
                np.testing.assert_allclose(got[name].numpy(), buf.numpy(),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=f"{name} step {i}")


def test_two_rank_step_matches_jax_mesh(ranks):
    """Dropout off: the 2 ranks' loss and averaged gradients against the
    JAX package's step on a 2-device mesh over the whole batch."""
    cfg, jm, v, tm = tbn._pair()
    mesh = jax_mesh.make_mesh(devices=jax.devices()[:2])
    tx, _ = jax_train.make_optimizer(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    j_state = jax_mesh.shard_state(mesh, jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"])))
    batch = jax_mesh.shard_batch(mesh, ttrans._batch())
    j_grads, j_metrics, _ = jax_train.make_grad_fn(jm)(
        j_state, batch, jax.random.PRNGKey(0))
    rec = ranks[0][1]["steps"][0]
    assert ranks[1][1]["steps"][0]["metrics"] == rec["metrics"]
    for k in ttrans.LOSSES:
        np.testing.assert_allclose(rec["metrics"][k], float(j_metrics[k]),
                                   rtol=1e-4, err_msg=k)
    want = params_from_jax({"params": jax.tree_util.tree_map(np.asarray,
                                                             j_grads)})
    for (name, _), g in zip(tm.named_parameters(), rec["grads"]):
        w = want[name].numpy()
        if name.endswith(("depthwise_conv.bias", "linear_k.bias")):
            # 0 in exact arithmetic (the batch norm's mean, the softmax's
            # shift): both sides are rounding noise, held to the JAX
            # mesh test's atol.
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-5,
                                       err_msg=name)
            continue
        err = np.linalg.norm(g.numpy() - w) / max(np.linalg.norm(w), 1e-6)
        assert err <= 1e-3, (name, err)


def test_agree_shapes_pads_to_the_common_shape(ranks):
    a, b = _agree_batches()
    got0, got1 = ranks[0][2], ranks[1][2]
    for got in (got0, got1):
        assert got["feats"].shape == (3, 7, 4)
        assert got["labels"].shape == (3, 5)
        np.testing.assert_array_equal(got["context_list"], a["context_list"])
        assert int(got["context_n_valid"]) == 3
    np.testing.assert_array_equal(got0["feats"], a["feats"])
    np.testing.assert_array_equal(got1["feats"][:2, :5], b["feats"])
    assert not got1["feats"][:, 5:].any() and not got1["feats"][2].any()
    np.testing.assert_array_equal(got1["labels"][:2, 3:], -1)
    np.testing.assert_array_equal(got1["labels"][2], 0)
    np.testing.assert_array_equal(got1["feat_lengths"],
                                  list(b["feat_lengths"]) + [1])
    assert got1["keys"] == b["keys"] + ["<pad>"]


def _lists(x):
    return [list(map(int, h)) for h in x]


@functools.lru_cache(maxsize=None)
def _jax_sharded(name):
    _, jm, v, _ = DECODERS[name]()
    return JaxSharded(jm, v, jax_mesh.make_mesh(devices=jax.devices()[:2]))


@pytest.mark.parametrize("name", list(DECODERS))
def test_sharded_decoder_matches_plain_and_jax(name, ranks):
    """Both ranks hold every utterance's result; each mode equals the
    port's Decoder on the whole batch and JAX's ShardedDecoder."""
    job = 3 + list(DECODERS).index(name)
    got0, got1 = ranks[0][job], ranks[1][job]
    _, _, _, tm = DECODERS[name]()
    plain = Decoder(tm, device="cpu")
    jdec = _jax_sharded(name)
    feats, lens = _decode_feats()
    for (method, kw), (g0, gates0), (g1, gates1) in zip(
            _decode_calls(name), got0, got1):
        tag = f"{method} {kw.get('context_filter_state', '')}"
        plain.last_gates = None
        want = getattr(plain, method)(feats, lens, **kw)
        if kw.get("context_filter_state") == "exact":
            jwant = want   # the fallback is the plain Decoder itself
        else:
            jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                   for k, v in kw.items()}
            jwant = getattr(jdec, method)(jnp.asarray(feats),
                                          jnp.asarray(lens), **jkw)
        if method == "ctc_prefix_beam_search":   # n-best lists, then best
            g0, g1, want, jwant = ([h[0] for h in x[0]]
                                   for x in (g0, g1, want, jwant))
        elif method == "rnnt_beam_search":
            g0, g1 = Decoder.rnnt_beam_to_lists(None, g0), \
                Decoder.rnnt_beam_to_lists(None, g1)
            want = plain.rnnt_beam_to_lists(want[0])
            jwant = [[int(x) for x in t[0, :n[0]]] for t, n in zip(
                np.asarray(jwant[0]["tokens"]), np.asarray(jwant[0]["lens"]))]
        assert _lists(g0) == _lists(g1), tag
        assert _lists(g0) == _lists(want), tag
        assert _lists(g0) == _lists(jwant), tag
        assert len(g0) == 5
        if plain.last_gates is not None:
            wg, wl = (np.asarray(torch.as_tensor(x)) for x in
                      plain.last_gates)
            for gates in (gates0, gates1):
                np.testing.assert_array_equal(gates[1], wl, err_msg=tag)
                for i, n in enumerate(wl):
                    np.testing.assert_array_equal(gates[0][i, :n],
                                                  wg[i, :n], err_msg=tag)


def test_sharded_modes_are_jax_and_the_cli_s():
    from wenet_celoss_tpu_torch.bin.recognize import MODES
    from wenet_celoss_tpu_torch.decode.sharded import ShardedDecoder
    assert ShardedDecoder.SUPPORTED_MODES == JaxSharded.SUPPORTED_MODES \
        == set(MODES)
