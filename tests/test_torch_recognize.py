"""The port's recognize CLI and what it reads, held against the JAX package
on the CPU: the YAML config reader and writer, the flax msgpack
checkpoint reader, the test-time ``Dataset`` (also in context mode 3),
``read_audio`` on FLAC, the BPE ``Tokenizer``, the ``context_filter``
functions, and ``recognize.main()`` of both packages over the same
checkpoint, data and hotwords: the result files and the ``.gate_dist``
sidecar equal byte for byte. A subprocess runs the port's CLI with
``yaml``, ``msgpack`` and ``flax`` blocked, as on the machine with the
card, which has none of them.
"""

import functools
import json
import os
import pickle
import random
import re
import shutil
import subprocess
import sys
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_exact_gating import JitApply
from test_torch_models import _fill
from wenet_celoss_tpu import configs as jax_configs
from wenet_celoss_tpu.bin import recognize as jax_recognize
from wenet_celoss_tpu.data import processor as jax_processor
from wenet_celoss_tpu.data.dataset import Dataset as JaxDataset
from wenet_celoss_tpu.data.flac import read_flac as jax_read_flac
from wenet_celoss_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from wenet_celoss_tpu.decode import api as jax_api
from wenet_celoss_tpu.decode.api import Decoder as JaxDecoder
from wenet_celoss_tpu.decode import context_filter as jax_cf
from wenet_celoss_tpu.models.factory import init_example
from wenet_celoss_tpu.models.factory import init_model as jax_init_model
from wenet_celoss_tpu.utils import checkpoint as jax_ckpt
from wenet_celoss_tpu.utils import config as jax_config
from wenet_celoss_tpu.utils import file_utils as jax_file_utils
from wenet_celoss_tpu.utils import wer as jax_wer
from wenet_celoss_tpu_torch.bin import recognize
from wenet_celoss_tpu_torch.data.dataset import Dataset
from wenet_celoss_tpu_torch.data.tokenizer import Tokenizer
from wenet_celoss_tpu_torch.data.wav import read_audio
from wenet_celoss_tpu_torch.decode import context_filter
from wenet_celoss_tpu_torch.utils import checkpoint, config, file_utils, wer
from wenet_celoss_tpu_torch.utils.convert import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
CONF_DIR = ROOT / "examples" / "librispeech" / "conf"
TEST_CLEAN = ROOT / "examples" / "librispeech" / "data_hw" / "test-clean"
YAMLS = sorted(CONF_DIR.glob("*.yaml"))
CONFIGS = ("conformer_rnnt_bias", "conformer_ctc_aed", "u2pp_conformer")
# The CLI runs keep the context tower: run.sh's shrink list without these.
KEEP_CONTEXT = ("context nobias", "model_conf.hw_weight 0.0")
# Joint blank and hotword-gate biases: the random tiny model then emits a
# few tokens an utterance and gates some frames on and some off.
BLANK_BIAS, GATE_BIAS = 2.0, 1.3
CLI_MODES = "rnnt_greedy_search,attention_rescoring,ctc_beam_td_attn_rescoring"


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def run_sh_overrides():
    """The --override_config list of examples/librispeech/run.sh's
    shrunk dry run."""
    text = (ROOT / "examples" / "librispeech" / "run.sh").read_text()
    block = text[text.index("for ov in"):]
    block = block[:block.index("; do")]
    return re.findall(r'"([^"]+)"', block)


# ----------------------------------------------------------- config ---
@pytest.mark.parametrize("path", YAMLS, ids=lambda p: p.name)
def test_load_config_matches_yaml(path):
    assert config.load_config(str(path)) == yaml.safe_load(path.read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_reader_takes_yaml_dump_and_writer_round_trips(name, tmp_path):
    cfg = getattr(jax_configs, name)()
    text = yaml.dump(cfg)
    assert config.parse_yaml(text) == yaml.safe_load(text) == cfg
    path = str(tmp_path / "c.yaml")
    config.save_config(cfg, path)
    with open(path) as f:
        assert yaml.safe_load(f) == cfg
    assert config.load_config(path) == cfg


def test_scalars_resolve_as_yaml_1_1():
    text = ("a: 1e-3\nb: 1.0e-3\nc: [yes, No, on, OFF, ~, null, '1.5']\n"
            "d: 0x1f\ne: 017\nf: .inf\ng: 'it''s' # note\nh: \"\\u2581\"\n"
            "i:\n- 1_000\n- -2.5\nj: {}\nk:\n")
    assert config.parse_yaml(text) == yaml.safe_load(text)
    assert config.parse_yaml(text)["a"] == "1e-3"
    odd = {"small": 1e-05, "big": 1e16, "neg": -0.0, "s": ["1e-3", "yes",
           "null", "a: b", "#c", "", "▁"], "n": None, "t": (1, 2),
           "nested": [{"x": [1]}, [2, [3]]], "e": []}
    text = config.dump_yaml(odd)
    assert "1.0e-05" in text
    want = yaml.safe_load(text)
    assert want == {**odd, "t": [1, 2]}
    assert config.parse_yaml(text) == want


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: &anchor 2\n", 2), ("a:\n  b: |\n    x\n", 2),
    ("a: [1, [2]]\n", 1), ("a: b\n  c\n", 2), ("a: !!str 1\n", 1),
    ("a:\n\t- 1\n", 2), ("a: 1\nb: {c: 2}\n", 2)])
def test_outside_the_subset_raises_with_its_line(text, line):
    with pytest.raises(ValueError, match=f"line {line}"):
        config.parse_yaml(text)


def test_override_config_matches_jax():
    cfg = yaml.safe_load((CONF_DIR / "conformer_rnnt_bias.yaml").read_text())
    ovs = run_sh_overrides()
    assert len(ovs) == 31
    assert config.override_config(cfg, ovs) == \
        jax_config.override_config(cfg, ovs)
    with pytest.raises(KeyError):
        config.override_config(cfg, ["encoder_conf.nope 1"])


# ------------------------------------------------------- checkpoint ---
def _same_leaves(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same_leaves(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    if isinstance(got, torch.Tensor):     # bfloat16
        assert want.dtype.name == "bfloat16", path
        assert np.array_equal(got.view(torch.int16).numpy(),
                              want.view(np.int16)), path
        return
    got = np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert got.tobytes() == want.tobytes(), path


def test_checkpoint_reader_matches_flax(tmp_path, monkeypatch):
    """fp32, bf16 and int leaves bit for bit, a numpy scalar, and an
    array above flax's chunk limit (the limit lowered for the test)."""
    rng = np.random.default_rng(0)
    tree = {"enc": {"kernel": rng.standard_normal((5, 7)).astype(np.float32),
                    "bias": rng.standard_normal(7).astype(np.float32)},
            "half": jnp.asarray(rng.standard_normal((3, 4)), jnp.bfloat16),
            "ids": np.arange(-3, 9, dtype=np.int32),
            "big": np.arange(5, dtype=np.int64) << 40,
            "step": np.float32(2.5)}
    path = str(tmp_path / "0.ckpt")
    jax_ckpt.save_checkpoint(tree, path)
    data = Path(path).read_bytes()
    _same_leaves(checkpoint.msgpack_restore(data),
                 flax.serialization.msgpack_restore(data))
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    tree["chunked"] = rng.standard_normal((10, 9)).astype(np.float32)
    data = flax.serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    _same_leaves(checkpoint.msgpack_restore(data),
                 flax.serialization.msgpack_restore(data))


def test_load_checkpoint_maps_jax_params_and_pt_round_trips(tmp_path):
    cfg = jax_configs.conformer_rnnt_bias(tiny=True, vocab_size=12)
    jm = jax_init_model(cfg)
    variables = _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                     *init_example(cfg)), seed=3)
    path = str(tmp_path / "final.ckpt")
    jax_ckpt.save_checkpoint(variables["params"], path)
    got = checkpoint.load_checkpoint(path)
    want = params_from_jax({"params": variables["params"]})
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    from wenet_celoss_tpu_torch.models.factory import init_model
    model = init_model(cfg, device="cpu", seed=1)
    checkpoint.load_into(model, path)
    pt = str(tmp_path / "m.pt")
    checkpoint.save_checkpoint(model, pt)
    back = checkpoint.load_checkpoint(pt)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


# ---------------------------------------------------- data pipeline ---
@functools.lru_cache(maxsize=None)
def symbol_table_lines():
    """<blank>, the word boundary and the 26 letters (27 characters),
    <sos/eos> last."""
    syms = ["<blank>", "▁"] + [chr(c) for c in range(65, 91)] + ["<sos/eos>"]
    return [f"{s} {i}" for i, s in enumerate(syms)]


def write_inputs(tmp: Path, n_wavs: int = 16):
    """data.list of the first ``n_wavs`` test-clean WAVs (paths from this
    checkout) and the symbol table."""
    lines = (TEST_CLEAN / "data.list").read_text().splitlines()[:n_wavs]
    with open(tmp / "data.list", "w") as f:
        for line in lines:
            obj = json.loads(line)
            obj["wav"] = str(TEST_CLEAN / "wavs" / Path(obj["wav"]).name)
            f.write(json.dumps(obj) + "\n")
    (tmp / "units.txt").write_text("\n".join(symbol_table_lines()) + "\n")
    return str(tmp / "data.list"), str(tmp / "units.txt")


def eval_conf():
    conf = yaml.safe_load(
        (CONF_DIR / "conformer_rnnt_bias.yaml").read_text())["dataset_conf"]
    conf = dict(conf, filter=False, speed_perturb=False, spec_aug=False,
                spec_sub=False, shuffle=False, sort=False, context_mode=0,
                batch_conf={"batch_type": "static", "batch_size": 4})
    conf["fbank_conf"] = dict(conf["fbank_conf"], dither=0.0)
    return conf


def _words(table, *words):
    return [[table["▁"]] + [table[c] for c in w] for w in words]


@pytest.mark.parametrize("context", [False, True])
def test_dataset_matches_jax(context, tmp_path):
    """The 16 test-clean WAVs in test-time configuration, batches of 4:
    keys, feats (1e-6), lengths and labels; with context mode 3 and a
    file list also the context list and the hotword labels."""
    data_list, units = write_inputs(tmp_path)
    table = file_utils.read_symbol_table(units)
    assert table == jax_file_utils.read_symbol_table(units)
    conf = eval_conf()
    if context:
        conf["context_mode"] = 3
        conf["pad_conf"] = dict(conf["pad_conf"], file_list=_words(
            table, "SPEECH", "BROWN", "LAZY"))
    got = list(Dataset("raw", data_list, table, conf, partition=False))
    want = list(JaxDataset("raw", data_list, table, conf, partition=False))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g["keys"] == w["keys"]
        np.testing.assert_allclose(g["feats"], w["feats"], rtol=1e-6,
                                   atol=1e-6)
        for k in ("feat_lengths", "labels", "label_lengths") + (
                ("context_list", "context_lengths", "hw_labels",
                 "context_decoder_labels", "context_n_valid")
                if context else ()):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if context:
        assert sum(int((b["hw_labels"] > 0).sum()) for b in got) > 10


def test_context_modes_match_jax():
    """Modes 1 (sampled, rolled through the global list), 2 and 4, and
    per-phrase hotword labels."""
    from wenet_celoss_tpu_torch.data.context import (ContextMaintainer,
                                                     batch_context_list,
                                                     hw_label_generate)
    rng = np.random.default_rng(5)
    labels = [list(rng.integers(1, 9, int(n))) for n in (12, 7, 9)]
    starts = {1, 2, 3}
    got_m, want_m = ContextMaintainer(4), jax_processor.ContextMaintainer(4)
    for _ in range(3):
        got = batch_context_list(labels, 1, bpe_start_ids=starts,
                                 maintainer=got_m, rng=random.Random(7))
        want = jax_processor.context_generate(
            labels, context_mode=1, bpe_start_ids=starts,
            maintainer=want_m, rng=random.Random(7))
        assert got == want
    phrases = [[3, 4], [5]]
    assert batch_context_list(labels, 2, file_list=phrases) == \
        jax_processor.context_generate(labels, context_mode=2,
                                       context_file_list=phrases)
    assert batch_context_list(labels, 4, dict_entry=phrases) == \
        jax_processor.context_generate(labels, context_mode=4,
                                       context_dict_entry=phrases)
    ctx = [[0]] + [list(y[2:4]) for y in labels]
    for n in (2, 5):
        assert hw_label_generate(labels, ctx, n) == \
            jax_processor.hw_label_generate(labels, ctx, n)[0]


def test_read_audio_flac_matches_jax(tmp_path):
    """A FLAC made by tools/flac_encode.py (as tests/test_flac.py makes
    its own): the port's read_audio equals the JAX package's read_flac."""
    sys.path.insert(0, str(ROOT / "tools"))
    from flac_encode import encode_flac
    rng = np.random.default_rng(1)
    t = np.arange(9001)
    x = (8000 * np.sin(2 * np.pi * 440 * t / 16000)
         + 50 * rng.standard_normal(t.size)).astype(np.int32)
    for ch, samples in ((1, x), (2, np.stack([x, np.roll(x, 3)], 1))):
        path = tmp_path / f"a{ch}.flac"
        path.write_bytes(encode_flac(samples, 16000, mode="lpc",
                                     mid_side=ch == 2))
        got, sr = read_audio(str(path))
        want, want_sr = jax_read_flac(str(path))
        assert sr == want_sr == 16000
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_tokenizer_matches_jax(tmp_path):
    """BPE (a model trained in the test by the JAX package's spm_train),
    characters and non-linguistic symbols: the same tokens and ids."""
    from wenet_celoss_tpu.data.spm_train import train_unigram, write_model
    texts = [" ".join(json.loads(line)["txt"].split()) for line in
             (TEST_CLEAN / "data.list").read_text().splitlines()]
    model = str(tmp_path / "bpe.model")
    pieces = train_unigram([t.lower() for t in texts] * 3, 40)
    write_model(model, pieces)
    table = {p: i for i, (p, _) in enumerate(pieces, 2)}
    table["<unk>"] = 1
    syms = ["<noise>", "[laugh]"]
    for bpe, split in ((model, False), (None, False), (None, True)):
        got = Tokenizer(table, bpe, syms, split)
        want = JaxTokenizer(table, bpe, syms, split)
        for text in [t.lower() for t in texts] + [
                "speech <noise> fox [laugh] zebra", "你好 world"]:
            assert got(text) == want(text)
    nl = tmp_path / "nl.txt"
    nl.write_text("\n".join(syms) + "\n")
    assert file_utils.read_non_lang_symbols(str(nl)) == \
        jax_file_utils.read_non_lang_symbols(str(nl)) == syms


def test_context_filter_and_wer_match_jax():
    rng = np.random.default_rng(2)
    post = rng.dirichlet(np.ones(12) * 0.3, size=150).astype(np.float32)
    ctx = np.full((7, 4), -1, np.int32)
    ctx[0, 0] = 0
    lens = np.array([1, 2, 3, 4, 2, 1, 3], np.int32)
    for i in range(1, 7):
        ctx[i, :lens[i]] = rng.integers(1, 12, lens[i])
    np.testing.assert_array_equal(
        context_filter.posterior_phrase_scores(post, ctx, lens),
        jax_cf.posterior_phrase_scores(post, ctx, lens))
    got = context_filter.ContextFilter(ctx, lens, window_size=32,
                                       topk_first=5, topk_second=-3.0)
    want = jax_cf.ContextFilter(ctx, lens, window_size=32, topk_first=5,
                                topk_second=-3.0)
    for chunk in (post[:60], post[60:]):
        got.posterior_filter(np.log(chunk))
        want.posterior_filter(np.log(chunk))
    np.testing.assert_array_equal(got.context_score, want.context_score)
    g_list, g_lens = got.second_filter(np.log(post))
    w_list, w_lens = want.second_filter(np.log(post))
    assert g_lens == w_lens and len(g_lens) > 1
    for a, b in zip(g_list, w_list):
        np.testing.assert_array_equal(a, b)
    refs = {"u1": "the cat sat", "u2": "a dog", "u3": "你好 world"}
    hyps = {"u1": "the bat sat down", "u2": "", "u3": "你 world"}
    for char_mode in (False, True):
        g = wer.score(refs, hyps, char_mode=char_mode)
        w = jax_wer.score(refs, hyps, char_mode=char_mode)
        assert g.summary() == w.summary() and g.details == w.details
    assert wer.edit_distance([1, 0, 1, 1], [1, 1]) == \
        jax_wer.edit_distance([1, 0, 1, 1], [1, 1]) == 2


# -------------------------------------------------------------- CLI ---
@functools.lru_cache(maxsize=None)
def cli_inputs(tmp: str):
    """Config, data list of 4 WAVs, symbol table, hotword files and a
    checkpoint written by the JAX package's save_checkpoint: seeded numpy
    values in the JAX parameter tree (as every parity test of the port
    makes them), plus the blank and gate biases."""
    tmp = Path(tmp)
    conf = str(tmp / "train.yaml")
    shutil.copy(CONF_DIR / "conformer_rnnt_bias.yaml", conf)
    overrides = [o for o in run_sh_overrides() if o not in KEEP_CONTEXT]
    data_list, units = write_inputs(tmp, n_wavs=4)
    table = file_utils.read_symbol_table(units)
    cfg = jax_config.override_config(jax_config.load_config(conf), overrides)
    cfg.update(input_dim=80, output_dim=len(table))
    jm = jax_init_model(cfg)
    params = _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                  *init_example(cfg)), seed=7)["params"]
    params["joint"]["ffn_out"]["bias"][0] += BLANK_BIAS
    params["context_bias"]["hw_output_layer"]["bias"][1] += GATE_BIAS
    ckpt = str(tmp / "final.ckpt")
    jax_ckpt.save_checkpoint(params, ckpt)
    hot = _words(table, "SPEECH", "BROWN", "OVER")
    (tmp / "hotwords.txt").write_text(
        "\n".join(" ".join(map(str, p)) for p in hot) + "\n")
    keys = [json.loads(line)["key"]
            for line in Path(data_list).read_text().splitlines()]
    with open(tmp / "context.pkl", "wb") as f:
        pickle.dump({k: hot[i % 3:] for i, k in enumerate(keys)}, f)
    args = ["--config", conf, "--test_data", data_list, "--checkpoint",
            ckpt, "--symbol_table", units, "--batch_size", "4",
            "--beam_size", "3", "--mode", CLI_MODES]
    for o in overrides:
        args += ["--override_config", o]
    return args, tmp


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    return cli_inputs(str(tmp_path_factory.mktemp("cli")))


class OnceJaxDecoder(JaxDecoder):
    """The JAX CLI's Decoder: made once, with its model's apply jitted
    (see ``test_torch_exact_gating.JitApply``), and kept for the later CLI
    runs, which load the same checkpoint and config (its compiled
    searches are kept with it)."""
    made = None

    def __new__(cls, model, params):
        if cls.made is None:
            cls.made = super().__new__(cls)
            JaxDecoder.__init__(cls.made, JitApply(model), params)
        return cls.made

    def __init__(self, model, params):
        pass


CASES = {"mode2_off": ["--context_mode", "2", "--context_filter_state",
                       "off"],
         "mode2_on": ["--context_mode", "2", "--context_filter_state", "on"],
         "mode2_exact": ["--context_mode", "2", "--context_filter_state",
                         "exact"],
         "mode3_exact": ["--context_mode", "3", "--context_filter_state",
                         "exact"],
         "mode4": ["--context_mode", "4"]}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax(case, cli, monkeypatch):
    """Both CLIs in process (the port's with --device cpu): every mode's
    result file, and mode 3's .gate_dist, equal byte for byte."""
    args, tmp = cli
    extra = list(CASES[case])
    if case.startswith("mode4"):
        extra += ["--context_dict", str(tmp / "context.pkl")]
    else:
        extra += ["--context_list_file", str(tmp / "hotwords.txt")]
    out = {}
    monkeypatch.setattr(jax_api, "Decoder", OnceJaxDecoder)
    monkeypatch.setattr("wenet_celoss_tpu.utils.platform."
                        "enable_compilation_cache", lambda *a, **k: None)
    for pkg in ("jax", "port"):
        result = tmp / case / pkg / "text"
        argv = args + extra + ["--result_file", str(result)]
        if pkg == "jax":
            monkeypatch.setattr(sys, "argv", ["recognize"] + argv)
            jax_recognize.main()
        else:
            recognize.main(argv + ["--device", "cpu"])
        out[pkg] = {p.name: p.read_bytes()
                    for p in sorted(result.parent.iterdir())}
    assert out["port"] == out["jax"]
    assert len(out["jax"]) == 3 + case.startswith("mode3")
    greedy = out["jax"]["text.rnnt_greedy_search"].decode().splitlines()
    assert len(greedy) == 4
    assert any(len(line.split()) > 1 for line in greedy), \
        "the model should emit tokens"


def test_cli_runs_without_yaml_msgpack_flax(cli):
    """The port's CLI in a subprocess with yaml, msgpack and flax blocked
    (the machine with the card has none of them), context mode 3 under
    "exact": it finishes and writes its files."""
    args, tmp = cli
    out = tmp / "blocked" / "text"
    argv = args + ["--context_mode", "3", "--context_list_file",
                   str(tmp / "hotwords.txt"), "--context_filter_state",
                   "exact", "--result_file", str(out), "--device", "cpu"]
    code = ("import sys\n"
            "for m in ('yaml', 'msgpack', 'flax', 'jax'):\n"
            "    sys.modules[m] = None\n"
            "from wenet_celoss_tpu_torch.bin import recognize\n"
            f"recognize.main({argv!r})\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = sorted(p.name for p in out.parent.iterdir())
    assert names == ["text.attention_rescoring",
                     "text.ctc_beam_td_attn_rescoring",
                     "text.gate_dist", "text.rnnt_greedy_search"]
