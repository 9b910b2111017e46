"""The port's model factory held against the JAX package's on the tiny
configs, on the CPU: the dropout rates a config that leaves them out
builds (the modules' defaults), and ``decoder: "transformer"`` (the
left-to-right decoder alone, ``r_num_blocks`` 0), whose parameter tree,
losses and every gradient must match the JAX model's; and the streaming
loss's chunk, which ``model_conf`` does not set in either factory.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import _fill
from test_torch_train import _batch, _torch_batch
from wenet_celoss_tpu import configs as jax_configs
from wenet_celoss_tpu.models.factory import init_example
from wenet_celoss_tpu.models.factory import init_model as jax_init_model
from wenet_celoss_tpu.parallel import train as jax_train
from wenet_celoss_tpu_torch import configs
from wenet_celoss_tpu_torch.models.factory import init_model
from wenet_celoss_tpu_torch.parallel import train
from wenet_celoss_tpu_torch.utils.convert import params_from_jax

VOCAB = 30
ENCODER_KEYS = ("dropout_rate", "positional_dropout_rate",
                "attention_dropout_rate")
DECODER_KEYS = ("dropout_rate", "positional_dropout_rate",
                "self_attention_dropout_rate", "src_attention_dropout_rate")
PREDICTOR_KEYS = ("embed_dropout", "dropout")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _without_rates(cfg):
    for k in ENCODER_KEYS:
        cfg["encoder_conf"].pop(k, None)
    for k in DECODER_KEYS:
        cfg["decoder_conf"].pop(k, None)
    for k in PREDICTOR_KEYS:
        cfg.get("predictor_conf", {}).pop(k, None)
    return cfg


def _port_rates(model):
    """{(top module, module class, attribute): {values}} over every float
    attribute of the built port tree whose name holds "dropout"."""
    seen = {}
    for name, mod in model.named_modules():
        for k, v in vars(mod).items():
            if "dropout" in k and isinstance(v, float):
                seen.setdefault((name.split(".")[0], type(mod).__name__, k),
                                set()).add(v)
    return seen


def _jax_field(module, name):
    return float(getattr(module, name))


@pytest.mark.parametrize("name", ["conformer_rnnt_bias", "conformer_ctc_aed"])
def test_dropout_defaults_match_jax(name):
    """Both factories build the tiny config with every encoder, decoder
    and predictor dropout key removed; each rate of the port's tree equals
    the JAX module field it stands for (the JAX defaults: 0.1, attention
    0.0)."""
    jm = jax_init_model(_without_rates(
        getattr(jax_configs, name)(tiny=True, vocab_size=VOCAB)))
    tm = init_model(_without_rates(
        getattr(configs, name)(tiny=True, vocab_size=VOCAB)), device="cpu")
    enc, dec = jm.encoder, jm.decoder
    want_by_class = {
        "encoder": {
            "ConformerEncoderLayer": _jax_field(enc, "dropout_rate"),
            "PositionwiseFeedForward": _jax_field(enc, "dropout_rate"),
            "RelPositionalEncoding": _jax_field(enc,
                                                "positional_dropout_rate"),
            "RelPositionMultiHeadedAttention": _jax_field(
                enc, "attention_dropout_rate")},
        "decoder": {
            "DecoderLayer": _jax_field(dec, "dropout_rate"),
            "PositionwiseFeedForward": _jax_field(dec, "dropout_rate"),
            "PositionalEncoding": _jax_field(dec, "positional_dropout_rate")}}
    seen = _port_rates(tm)
    checked = 0
    for (top, cls, attr), values in seen.items():
        if top == "decoder" and cls == "MultiHeadedAttention":
            want = {_jax_field(dec, "self_attention_dropout_rate"),
                    _jax_field(dec, "src_attention_dropout_rate")}
        elif top == "predictor":
            want = {_jax_field(jm.predictor, attr)}
        elif top in want_by_class:
            want = {want_by_class[top][cls]}
        else:
            continue   # context bias: fixed rates, not config keys
        assert values == want, (top, cls, attr, values, want)
        checked += 1
    assert _jax_field(enc, "dropout_rate") == 0.1
    assert _jax_field(enc, "positional_dropout_rate") == 0.1
    if name == "conformer_rnnt_bias":
        assert {_jax_field(jm.predictor, k) for k in PREDICTOR_KEYS} == {0.1}
        assert checked == 10
    else:
        assert checked == 8


def _transformer_cfg(cfgs):
    """Tiny conformer_ctc_aed with the left-to-right decoder alone, every
    dropout rate 0."""
    cfg = cfgs.conformer_ctc_aed(tiny=True, vocab_size=VOCAB)
    cfg["decoder"] = "transformer"
    cfg["decoder_conf"].pop("r_num_blocks", None)
    for conf, keys in ((cfg["encoder_conf"], ENCODER_KEYS),
                       (cfg["decoder_conf"], DECODER_KEYS)):
        for k in keys:
            conf[k] = 0.0
    return cfg


@functools.lru_cache(maxsize=None)
def _transformer_pair():
    """(jax model, jax variables, torch model) sharing weights."""
    cfg = _transformer_cfg(jax_configs)
    jm = jax_init_model(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *init_example(cfg, frames=16, labels=2))
    variables = _fill(shapes, seed=2)
    tm = init_model(_transformer_cfg(configs), device="cpu")
    return jm, variables, tm


def test_transformer_decoder_tree_matches_jax():
    """The port builds no right-to-left decoder, as the JAX factory's
    r_num_blocks 0 does, and every leaf of the JAX tree maps through the
    weight bridge onto a port parameter of the same shape, strictly."""
    jm, variables, tm = _transformer_pair()
    assert jm.decoder.r_num_blocks == 0
    assert tm.decoder.right_decoder is None
    sd = params_from_jax(variables)
    assert not any(k.startswith("decoder.right") for k in sd)
    assert set(sd) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    tm.load_state_dict(sd, strict=True)


def test_transformer_decoder_loss_and_every_gradient_match_jax():
    """The loss dict and every parameter gradient of one step against the
    JAX package's make_grad_fn, each tensor to 1e-4 of its largest element
    (scale floored at 1e-3: the key biases' gradient is zero in exact
    arithmetic), as in test_torch_train."""
    jm, variables, tm = _transformer_pair()
    tm.load_state_dict(params_from_jax(variables), strict=True)
    batch = _batch()
    state = jax_train.TrainState(step=jnp.zeros((), jnp.int32),
                                 params=variables["params"], opt_state=None)
    j_grads, j_metrics, _ = jax_train.make_grad_fn(jm)(
        state, batch, jax.random.PRNGKey(0))
    want = params_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, j_grads)})
    grads, metrics = train.make_grad_fn(tm)(
        train.TrainState(0, tm, None), _torch_batch(batch),
        torch.Generator())
    for k in ("loss", "loss_att", "loss_ctc", "acc"):
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   rtol=1e-5, err_msg=k)
    names = [n for n, _ in tm.named_parameters()]
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-3)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * scale, (name, err, scale)


def test_streaming_chunk_is_the_jax_models_field():
    """A config that carries ``streaming_chunk: 4`` builds the JAX model
    with its field default (the JAX factory never passes the key); the
    port's chunk equals that field."""
    cfgs = [cf.conformer_rnnt_bias(tiny=True, vocab_size=VOCAB)
            for cf in (jax_configs, configs)]
    for cfg in cfgs:
        cfg.setdefault("model_conf", {})["streaming_chunk"] = 4
    jm = jax_init_model(cfgs[0])
    tm = init_model(cfgs[1], device="cpu")
    assert jm.streaming_chunk == 16
    assert tm.streaming_chunk == jm.streaming_chunk


@pytest.mark.parametrize("tiny", [True, False])
def test_u2pp_conformer_builds(tiny):
    """``u2pp_conformer()`` builds on the CPU, tiny and at full width
    (d=256, 12 causal conformer blocks, dynamic chunk, 6 + 3 decoder
    blocks): every conv module causal with K - 1 = 14 cached frames."""
    cfg = configs.u2pp_conformer(tiny=tiny)
    tm = init_model(cfg, device="cpu")
    enc = tm.encoder
    assert enc.use_dynamic_chunk and not enc.use_dynamic_left_chunk
    assert enc.static_chunk_size == 0 and enc._conv_lorder() == 14
    assert len(enc.layers) == (2 if tiny else 12)
    assert all(layer.conv_module.causal for layer in enc.layers)
    assert len(tm.decoder.right_decoder.decoders) == (1 if tiny else 3)
    assert tm.reverse_weight == 0.3
    cache = enc.init_cache(2, 64)
    d = 64 if tiny else 256
    assert cache["att"].shape == (len(enc.layers), 2, 2 if tiny else 4, 64,
                                  2 * d // (2 if tiny else 4))
    assert cache["cnn"].shape == (len(enc.layers), 2, 14, d)


def test_bridge_maps_the_u2pp_tree_whole():
    """Every leaf of the tiny JAX U2++ tree maps onto the port's model,
    which takes it strictly, and no parameter of the port is left
    unset."""
    cfg = jax_configs.u2pp_conformer(tiny=True, vocab_size=VOCAB)
    jm = jax_init_model(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *init_example(cfg, frames=16, labels=2))
    variables = _fill(shapes, seed=5)
    sd = params_from_jax(variables)
    assert len(jax.tree_util.tree_leaves(variables)) == len(sd)
    tm = init_model(configs.u2pp_conformer(tiny=True, vocab_size=VOCAB),
                    device="cpu")
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd, strict=True)
    for name, t in tm.state_dict().items():
        assert torch.equal(t, sd[name]), name
