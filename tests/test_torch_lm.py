"""The port's language-model tools held against the JAX package on the
CPU: ``lm/arpa.py`` (``ArpaLM`` scores, ``lm_rescore_nbest``) and
``lm/fst.py`` (``build_lg``, ``LgGraph.write`` bytes, ``LgGraph.read`` of
a JAX-written ``lg.bin``, ``wfst_beam_decode`` hypotheses and costs, also
from a torch tensor), on the ARPA texts of ``tests/test_lm.py`` and
``tests/test_wfst.py`` and on one written from the committed test-clean
transcripts; and ``bin/build_lg.py`` against ``tools/fst/build_lg.py``
(``lg.bin`` and ``words.txt`` byte for byte). Every comparison is exact.
"""

import importlib.util
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch

from test_lm import ARPA as LM_ARPA
from test_wfst import ARPA as WFST_ARPA
from test_wfst import LEXICON
from wenet_celoss_tpu.lm import arpa as jax_arpa
from wenet_celoss_tpu.lm import fst as jax_fst
from wenet_celoss_tpu_torch.bin import build_lg as port_build_lg
from wenet_celoss_tpu_torch.lm import arpa, fst

ROOT = Path(__file__).resolve().parent.parent
TEXT = ROOT / "examples" / "librispeech" / "data_hw" / "test-clean" / "text"


def transcript_arpa() -> str:
    """A unigram ARPA of the test-clean transcripts' words (counts with
    add-one, <unk> and </s> one count each), as chip_smoke.py writes it."""
    import chip_smoke
    return chip_smoke.unigram_arpa([line.split(" ", 1)[1] for line in
                                    TEXT.read_text().splitlines()])


ARPAS = {"test_lm": LM_ARPA, "test_wfst": WFST_ARPA}


@pytest.fixture(scope="module")
def arpa_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("arpa")
    files = {}
    for name, text in dict(ARPAS, transcripts=transcript_arpa()).items():
        files[name] = str(tmp / f"{name}.arpa")
        Path(files[name]).write_text(text)
    return files


def _histories(words, order):
    out = [()]
    for w in words:
        out.append((w,))
        if order > 2:
            out.extend((v, w) for v in words[:4])
    return out


@pytest.mark.parametrize("name", ["test_lm", "test_wfst", "transcripts"])
def test_arpa_scores_match_jax(name, arpa_files):
    got, want = arpa.ArpaLM(arpa_files[name]), \
        jax_arpa.ArpaLM(arpa_files[name])
    assert got.order == want.order and got.ngrams == want.ngrams
    words = sorted({w for g in want.ngrams for w in g}) + ["zzz"]
    for w in words:
        for h in _histories(words, want.order):
            assert got.log10_prob(w, h) == want.log10_prob(w, h)
    rng = np.random.default_rng(0)
    sents = [list(rng.choice(words, int(rng.integers(0, 6))))
             for _ in range(30)]
    for s in sents:
        for bos, eos in ((True, True), (False, True), (True, False)):
            assert got.sentence_log10(s, bos=bos, eos=eos) == \
                want.sentence_log10(s, bos=bos, eos=eos)
        assert got.sentence_loge(s) == want.sentence_loge(s)
    am = rng.standard_normal(len(sents)).tolist()
    for weight in (0.5, 1.3):
        assert arpa.lm_rescore_nbest(got, sents, am, weight) == \
            jax_arpa.lm_rescore_nbest(want, sents, am, weight)


def _graphs(arpa_path, lexicon, num_units):
    return (fst.build_lg(lexicon, arpa.ArpaLM(arpa_path), num_units),
            jax_fst.build_lg(lexicon, jax_arpa.ArpaLM(arpa_path),
                             num_units))


def _same_graph(got, want):
    assert got.words == want.words and got.num_units == want.num_units
    assert got.trie.arcs == want.trie.arcs
    for k in ("arcs", "backoff", "final", "start"):
        assert getattr(got.ngram, k) == getattr(want.ngram, k), k


def transcript_lexicon():
    """The transcripts' words spelled as ▁ + letters over chip_smoke.py's
    units (blank 0, ▁ 1, A-Z 2-27)."""
    words = sorted({w for line in TEXT.read_text().splitlines()
                    for w in line.split()[1:]})
    unit = {"▁": 1, **{chr(65 + i): 2 + i for i in range(26)}}
    return [(w, [1] + [unit[c] for c in w]) for w in words
            if all(c in unit for c in w)]


@pytest.mark.parametrize("case", ["wfst", "transcripts"])
def test_build_lg_write_and_read_match_jax(case, arpa_files, tmp_path):
    if case == "wfst":
        path, lexicon, units = arpa_files["test_wfst"], LEXICON, 4
    else:
        path, lexicon, units = arpa_files["transcripts"], \
            transcript_lexicon(), 30
    got, want = _graphs(path, lexicon, units)
    _same_graph(got, want)
    got.write(str(tmp_path / "port.bin"))
    want.write(str(tmp_path / "jax.bin"))
    data = (tmp_path / "jax.bin").read_bytes()
    assert (tmp_path / "port.bin").read_bytes() == data
    read_port = fst.LgGraph.read(str(tmp_path / "jax.bin"))
    read_jax = jax_fst.LgGraph.read(str(tmp_path / "jax.bin"))
    _same_graph(read_port, read_jax)
    read_port.write(str(tmp_path / "again.bin"))
    assert (tmp_path / "again.bin").read_bytes() == data


def _logp(t, v, seed, peaky=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, v)) * (4.0 if peaky else 1.0)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


OPTIONS = {
    "default": {},
    "wide": dict(beam=1e9, max_active=10 ** 9, nbest=4),
    "narrow": dict(beam=4.0, max_active=3, nbest=3, lm_scale=0.5,
                   acoustic_scale=1.5, word_penalty=0.3),
    "skip": dict(beam=12.0, blank_skip_thresh=0.6, nbest=2),
}


@pytest.mark.parametrize("opts", list(OPTIONS))
def test_wfst_beam_decode_matches_jax(opts, arpa_files):
    """Hypotheses (words, units, frames) and costs equal, on random and
    on peaky log-probs, from numpy and from a torch tensor."""
    cases = [(_graphs(arpa_files["test_wfst"], LEXICON, 4), 4),
             (_graphs(arpa_files["transcripts"], transcript_lexicon(), 30),
              30)]
    seen_words = 0
    for (got_lg, want_lg), v in cases:
        for seed in range(4):
            logp = _logp(9 + 3 * seed, v, seed, peaky=seed % 2 == 1)
            want = jax_fst.wfst_beam_decode(
                want_lg, logp, jax_fst.WfstDecodeOptions(**OPTIONS[opts]))
            for x in (logp, torch.as_tensor(logp)):
                got = fst.wfst_beam_decode(
                    got_lg, x, fst.WfstDecodeOptions(**OPTIONS[opts]))
                assert [asdict(h) for h in got] == \
                    [asdict(h) for h in want]
            seen_words += sum(len(h.words) for h in want)
    assert seen_words > 0


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_build_lg_tool", ROOT / "tools" / "fst" / "build_lg.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("source", ["wordlist", "lexicon"])
def test_build_lg_cli_matches_tool(source, arpa_files, tmp_path,
                                   monkeypatch, capsys):
    """Both CLIs on the same units, ARPA and word list or lexicon (with
    one unspellable word and one unknown unit): lg.bin and words.txt
    byte for byte, and the same report."""
    units = tmp_path / "units.txt"
    syms = ["<blank>", "▁"] + [chr(c) for c in range(65, 91)]
    units.write_text("".join(f"{s} {i}\n" for i, s in enumerate(syms)))
    words = [w for w, _ in transcript_lexicon()]
    src = tmp_path / f"{source}.txt"
    if source == "wordlist":
        src.write_text("\n".join(["<s>", "</s>", "<unk>"] + words
                                 + ["café", ""]) + "\n")
    else:
        src.write_text("".join(f"{w} ▁ {' '.join(w)}\n" for w in words)
                       + "BAD ▁ ?\nX\n")
    reports = {}
    tool = _load_tool()
    for side in ("jax", "port"):
        argv = ["--units", str(units), "--arpa",
                arpa_files["transcripts"], f"--{source}", str(src),
                "--out_dir", str(tmp_path / side)]
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["build_lg.py"] + argv)
            tool.main()
        else:
            port_build_lg.main(argv)
        out = capsys.readouterr()
        reports[side] = (out.out.replace(str(tmp_path / side), "<out>"),
                         out.err)
    for name in ("lg.bin", "words.txt"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    assert reports["port"] == reports["jax"]
    assert "skip" in reports["jax"][1]
    assert port_build_lg.spell("ABC", {"▁A": 1, "B": 2, "C": 3}) == \
        tool.spell("ABC", {"▁A": 1, "B": 2, "C": 3}) == [1, 2, 3]
    assert len(words) >= 10
