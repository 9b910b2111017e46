"""The port's training-side data modules held against the JAX package on
the CPU: fbank with dither and MFCC (``ops/fbank.py``), the train-time
``Dataset`` (the yaml flagship's ``dataset_conf``: dither, speed perturb,
spec_aug, shuffle, sort, dynamic batches, hotword context mode 1) over two
epochs, serially and in the thread pool, and with ``feats_type: mfcc``;
``bin/compute_cmvn_stats.py``; and the pure numpy or Python modules
``data/kaldi_io.py``, ``data/wav_distortion.py`` and ``data/spm_train.py``.
"""

import io
import json
import random
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from wenet_celoss_tpu.bin import compute_cmvn_stats as jax_cmvn
from wenet_celoss_tpu.data import kaldi_io as jax_kaldi_io
from wenet_celoss_tpu.data import spm_train as jax_spm
from wenet_celoss_tpu.data import wav_distortion as jax_wd
from wenet_celoss_tpu.data.dataset import Dataset as JaxDataset
from wenet_celoss_tpu.ops import fbank as jax_fbank
from wenet_celoss_tpu_torch.bin import compute_cmvn_stats
from wenet_celoss_tpu_torch.data import kaldi_io, spm_train, wav_distortion
from wenet_celoss_tpu_torch.data.dataset import Dataset
from wenet_celoss_tpu_torch.data.wav import read_wav
from wenet_celoss_tpu_torch.ops import fbank

ROOT = Path(__file__).resolve().parent.parent
CONF = ROOT / "examples" / "librispeech" / "conf" / "conformer_rnnt_bias.yaml"
TRAIN = ROOT / "examples" / "librispeech" / "data_hw" / "train-clean-100"
FEAT_TOL = dict(rtol=1e-6, atol=1e-6)


def write_train_inputs(tmp: Path, n_wavs: int, offset: int = 0):
    """data.list of ``n_wavs`` committed train-clean-100 WAVs (paths under
    this checkout), a wav.scp of them, and a character symbol table
    (blank, the word boundary, A-Z, <sos/eos>)."""
    lines = (TRAIN / "data.list").read_text().splitlines()
    lines = lines[offset:offset + n_wavs]
    with open(tmp / "data.list", "w") as f, open(tmp / "wav.scp", "w") as g:
        for line in lines:
            obj = json.loads(line)
            obj["wav"] = str(TRAIN / "wavs" / Path(obj["wav"]).name)
            f.write(json.dumps(obj) + "\n")
            g.write(f"{obj['key']} {obj['wav']}\n")
    syms = ["<blank>", "▁"] + [chr(c) for c in range(65, 91)] + ["<sos/eos>"]
    (tmp / "units.txt").write_text("".join(f"{s} {i}\n"
                                           for i, s in enumerate(syms)))
    table = {s: i for i, s in enumerate(syms)}
    return str(tmp / "data.list"), str(tmp / "units.txt"), table


def train_conf():
    """The yaml flagship's train-time dataset_conf, with dynamic batches
    of 600 frames so that 12 WAVs make several batches."""
    conf = yaml.safe_load(CONF.read_text())["dataset_conf"]
    conf["batch_conf"] = dict(conf["batch_conf"], max_frames_in_batch=600)
    return conf


# ------------------------------------------------------- fbank, MFCC ---
def _wav():
    wav, sr = read_wav(str(sorted((TRAIN / "wavs").glob("*.wav"))[0]))
    assert sr == 16000
    return wav


@pytest.mark.parametrize("seed", [0, 7])
def test_dithered_fbank_and_mfcc_match_jax(seed):
    """Dither 0.1 and 1.0 drawn from generators of one seed, and MFCC (13
    and 40 coefficients, liftered or not) with and without dither: equal
    to 1e-6, and the dither changes the features."""
    wav = _wav()
    for dither in (0.1, 1.0):
        cfg = fbank.FbankConfig(dither=dither)
        got = fbank.compute_fbank_np(wav, cfg, np.random.default_rng(seed))
        want = jax_fbank.compute_fbank_np(
            wav, jax_fbank.FbankConfig(dither=dither),
            np.random.default_rng(seed))
        np.testing.assert_allclose(got, want, **FEAT_TOL)
        plain = fbank.compute_fbank_np(wav, fbank.FbankConfig())
        assert not np.allclose(got, plain, atol=1e-3)
    for kw in (dict(num_mel_bins=23, num_ceps=13, dither=0.1),
               dict(num_mel_bins=40, num_ceps=40, cepstral_lifter=0.0),
               dict(num_mel_bins=80, num_ceps=80, high_freq=-400.0)):
        got = fbank.compute_mfcc_np(wav, fbank.MfccConfig(**kw),
                                    np.random.default_rng(seed))
        want = jax_fbank.compute_mfcc_np(wav, jax_fbank.MfccConfig(**kw),
                                         np.random.default_rng(seed))
        assert got.shape == want.shape and got.shape[1] == kw["num_ceps"]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


# ------------------------------------------------ train-time Dataset ---
BATCH_KEYS = ("feat_lengths", "labels", "label_lengths", "context_list",
              "context_lengths", "hw_labels", "context_decoder_labels",
              "context_n_valid")


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g["keys"] == w["keys"]
        assert set(g) == set(w)
        np.testing.assert_allclose(g["feats"], w["feats"], **FEAT_TOL)
        for k in BATCH_KEYS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(scope="module")
def train_list(tmp_path_factory):
    return write_train_inputs(tmp_path_factory.mktemp("train"), 12)


@pytest.mark.parametrize("case", ["serial", "threads", "mfcc"])
def test_train_dataset_matches_jax(case, train_list):
    """Two epochs of the train-time pipeline: keys, feats (1e-6), labels,
    the sampled hotword lists and hotword labels equal; the two epochs
    differ (a new shuffle, speed and dither draw)."""
    data_list, _, table = train_list
    conf = train_conf()
    conf["num_workers"] = 2 if case == "threads" else 0
    if case == "mfcc":
        conf["feats_type"] = "mfcc"
        conf["mfcc_conf"] = dict(num_mel_bins=40, num_ceps=20, dither=0.1)
    ours = Dataset("raw", data_list, table, conf, partition=False)
    ref = JaxDataset("raw", data_list, table, conf, partition=False)
    epochs = []
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        # Mode-1 hotword sampling draws from the global random module in
        # both packages: each pass starts from the same seed.
        random.seed(100 + epoch)
        got = list(ours)
        random.seed(100 + epoch)
        want = list(ref)
        assert_batches_equal(got, want)
        if case == "mfcc":
            assert got[0]["feats"].shape[-1] == 20
        assert sum(int((b["hw_labels"] > 0).sum()) for b in got) > 0
        epochs.append(got)
    assert [b["keys"] for b in epochs[0]] != [b["keys"] for b in epochs[1]]


# ------------------------------------------------------------- cmvn ---
def test_compute_cmvn_stats_matches_jax(tmp_path, monkeypatch):
    """The same JSON from both tools over 6 WAVs (float64 sums, the
    frame count), an unreadable line skipped; no frame at all raises."""
    _, _, _ = write_train_inputs(tmp_path, 6)
    scp = tmp_path / "wav.scp"
    scp.write_text(scp.read_text() + f"bad {tmp_path / 'missing.wav'}\n")
    args = ["--train_config", str(CONF), "--in_scp", str(scp)]
    compute_cmvn_stats.main(args + ["--out_cmvn", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["cmvn"] + args +
                        ["--out_cmvn", str(tmp_path / "jax")])
    jax_cmvn.main()
    got = json.loads((tmp_path / "port").read_text())
    want = json.loads((tmp_path / "jax").read_text())
    assert got["frame_num"] == want["frame_num"] > 0
    np.testing.assert_allclose(got["mean_stat"], want["mean_stat"],
                               rtol=1e-12)
    np.testing.assert_allclose(got["var_stat"], want["var_stat"],
                               rtol=1e-12)
    (tmp_path / "empty.scp").write_text(f"bad {tmp_path / 'missing.wav'}\n")
    with pytest.raises(ValueError, match="no frames"):
        compute_cmvn_stats.main(["--train_config", str(CONF), "--in_scp",
                                 str(tmp_path / "empty.scp"), "--out_cmvn",
                                 str(tmp_path / "none")])


# ---------------------------------------------- numpy data modules ---
def test_kaldi_io_matches_jax(tmp_path):
    """Matrices, compressed matrices (CM, CM2, CM3) and vectors: the same
    bytes written, the same arrays read back, through ark and scp."""
    rng = np.random.default_rng(0)
    m = (rng.standard_normal((17, 9)) * 4.0).astype(np.float32)
    v = rng.standard_normal(11).astype(np.float32)
    blobs = []
    for mod in (kaldi_io, jax_kaldi_io):
        f = io.BytesIO()
        offs = [mod.write_mat(f, m, key="m")]
        for fmt in ("CM", "CM2", "CM3"):
            offs.append(mod.write_cmat(f, m, key=fmt, fmt=fmt))
        offs.append(mod.write_vec_flt(f, v, key="v"))
        blobs.append((f.getvalue(), offs))
    assert blobs[0] == blobs[1]
    ark = tmp_path / "a.ark"
    ark.write_bytes(blobs[0][0])
    names = ["m", "CM", "CM2", "CM3"]
    (tmp_path / "a.scp").write_text("".join(
        f"{k} {ark}:{o}\n" for k, o in zip(names, blobs[0][1])))
    for read in ("read_scp",):
        got = dict(getattr(kaldi_io, read)(str(tmp_path / "a.scp")))
        want = dict(getattr(jax_kaldi_io, read)(str(tmp_path / "a.scp")))
        assert list(got) == list(want) == names
        for k in names:
            np.testing.assert_array_equal(got[k], want[k])
    with open(ark, "rb") as f:
        f.seek(blobs[0][1][-1])
        got_v = kaldi_io.read_vec_flt(f)
    np.testing.assert_array_equal(got_v, v)
    text = tmp_path / "t.mat"
    text.write_text(" [\n 1 2 3\n 4 5 6 ]\n")
    np.testing.assert_array_equal(kaldi_io.read_mat(str(text)),
                                  jax_kaldi_io.read_mat(str(text)))


def test_wav_distortion_matches_jax():
    """Every registered distortion, and the fence and jag masks from the
    same random.Random seed: equal arrays."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(4000) * 0.4).astype(np.float32).clip(-1, 1)
    assert list(wav_distortion.DISTORTIONS) == list(jax_wd.DISTORTIONS)
    for name in wav_distortion.DISTORTIONS:
        random.seed(3)
        got = wav_distortion.distort_wav(x, name)
        random.seed(3)
        want = jax_wd.distort_wav(x, name)
        np.testing.assert_array_equal(got, want, err_msg=name)
    for fn in ("distort_fence", "distort_jag"):
        got = getattr(wav_distortion, fn)(x, rng=random.Random(5))
        want = getattr(jax_wd, fn)(x, rng=random.Random(5))
        np.testing.assert_array_equal(got, want, err_msg=fn)


def test_spm_train_matches_jax(tmp_path):
    """The committed transcripts: the same pieces and scores, and the
    same model and vocabulary bytes."""
    texts = [json.loads(line)["txt"].lower() for line in
             (TRAIN / "data.list").read_text().splitlines()[:60]]
    got = spm_train.train_unigram(texts, 40)
    want = jax_spm.train_unigram(texts, 40)
    assert got == want and len(got) > 20
    for mod, tag in ((spm_train, "port"), (jax_spm, "jax")):
        mod.write_model(str(tmp_path / f"{tag}.model"), got)
        mod.write_vocab(str(tmp_path / f"{tag}.vocab"), got)
    for ext in ("model", "vocab"):
        assert (tmp_path / f"port.{ext}").read_bytes() == \
            (tmp_path / f"jax.{ext}").read_bytes()
