"""The port's multi-process loader (``data/loader.py``), as
``tests/test_mp_loader.py`` holds the JAX package's: the same samples as
``Dataset``, deterministic per epoch, ranks that compose, worker errors
raised in the parent, and the factory; plus the port's batches against
the JAX package's loader with the same worker split, and the parent's
environment restored after the spawn (the workers get the card hidden)."""

import json
import multiprocessing
import os

import numpy as np
import pytest

from wenet_celoss_tpu.data.loader import MultiProcessLoader as JaxLoader
from wenet_celoss_tpu.data.wav import write_wav
from wenet_celoss_tpu_torch.data.dataset import Dataset
from wenet_celoss_tpu_torch.data.loader import (MultiProcessLoader, _get,
                                                make_loader)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp_corpus")
    rng = np.random.default_rng(0)
    symbol_table = {"<blank>": 0, "<unk>": 1}
    words = [f"w{i}" for i in range(20)]
    for i, w in enumerate(words):
        symbol_table[w] = i + 2
    symbol_table["<sos/eos>"] = len(symbol_table)
    lp = root / "data.list"
    with open(lp, "w") as f:
        for i in range(24):
            n = int(16000 * (0.6 + 0.05 * (i % 5)))
            wav = (rng.standard_normal(n) * 2000).astype(np.int16) \
                .astype(np.float32)
            p = root / f"u{i:03d}.wav"
            write_wav(str(p), wav, 16000)
            txt = " ".join(words[j] for j in rng.integers(0, 20, 4))
            f.write(json.dumps({"key": f"u{i:03d}", "wav": str(p),
                                "txt": txt}) + "\n")
    return str(lp), symbol_table


def _conf(**kw):
    return {
        "filter_conf": {"max_length": 2000, "min_length": 1,
                        "token_max_length": 100, "token_min_length": 1},
        "speed_perturb": True, "spec_aug": True,
        "fbank_conf": {"num_mel_bins": 23, "dither": 0.1},
        "shuffle": True, "shuffle_conf": {"shuffle_size": 32},
        "sort": True, "sort_conf": {"sort_size": 8},
        "batch_conf": {"batch_type": "static", "batch_size": 3},
        "split_with_space": True, **kw,
    }


def _keys(batches):
    return sorted(k for b in batches for k in b["keys"])


def test_loader_covers_same_samples_as_dataset(corpus):
    lp, symtab = corpus
    base = list(Dataset("raw", lp, symtab, _conf(), partition=False))
    got = list(MultiProcessLoader("raw", lp, symtab, _conf(),
                                  partition=False, num_workers=2))
    assert _keys(got) == _keys(base)
    b = got[0]
    assert b["feats"].ndim == 3 and b["feats"].dtype == np.float32
    assert len(b["feat_lengths"]) == b["feats"].shape[0]


def test_loader_matches_jax_loader(corpus):
    """Two workers on both sides, epoch 2: the same batches in the same
    order, feats to 1e-6 (dither, speed perturb and spec_aug on); the
    parent's environment is as it was, and startup_s is measured."""
    lp, symtab = corpus
    env = dict(os.environ)
    ours = MultiProcessLoader("raw", lp, symtab, _conf(), partition=False,
                              num_workers=2)
    ref = JaxLoader("raw", lp, symtab, _conf(), partition=False,
                    num_workers=2)
    ours.set_epoch(2)
    ref.set_epoch(2)
    got, want = list(ours), list(ref)
    assert dict(os.environ) == env
    assert ours.startup_s > 0
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert g["keys"] == w["keys"]
        np.testing.assert_allclose(g["feats"], w["feats"], rtol=1e-6,
                                   atol=1e-6)
        for k in ("feat_lengths", "labels", "label_lengths"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_loader_deterministic_per_epoch(corpus):
    lp, symtab = corpus
    mp = MultiProcessLoader("raw", lp, symtab, _conf(), partition=False,
                            num_workers=2)
    mp.set_epoch(3)
    a = [tuple(b["keys"]) for b in mp]
    b = [tuple(b["keys"]) for b in mp]
    assert a == b
    mp.set_epoch(4)
    c = [tuple(b["keys"]) for b in mp]
    assert a != c  # the epoch reshuffles


def test_loader_shards_compose_with_rank(corpus):
    """Rank r of world W with n workers sees lists[r*n+w :: W*n]: the two
    ranks' unions are disjoint and cover the list."""
    lp, symtab = corpus
    k0 = _keys(list(MultiProcessLoader(
        "raw", lp, symtab, _conf(), partition=True, rank=0, world_size=2,
        num_workers=2)))
    k1 = _keys(list(MultiProcessLoader(
        "raw", lp, symtab, _conf(), partition=True, rank=1, world_size=2,
        num_workers=2)))
    assert not (set(k0) & set(k1))
    assert sorted(k0 + k1) == _keys(
        list(Dataset("raw", lp, symtab, _conf(), partition=False)))


def test_make_loader_factory(corpus):
    lp, symtab = corpus
    conf = _conf()
    assert isinstance(make_loader("raw", lp, symtab, conf), Dataset)
    conf["loader_processes"] = 2
    loader = make_loader("raw", lp, symtab, conf)
    assert isinstance(loader, MultiProcessLoader)
    assert loader.num_workers == 2
    with pytest.raises(ValueError):
        MultiProcessLoader("raw", lp, symtab, conf, num_workers=0)


def test_loader_surfaces_worker_error(corpus):
    lp, symtab = corpus
    conf = _conf(fbank_conf={"num_mel_bins": -5})  # breaks fbank in-worker
    mp = MultiProcessLoader("raw", lp, symtab, conf, partition=False,
                            num_workers=2)
    with pytest.raises(RuntimeError, match="loader worker"):
        list(mp)


def test_loader_raises_when_a_worker_dies():
    """A worker that exits without its sentinel (killed, or crashed in
    native code) raises in the parent instead of blocking it forever."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=os._exit, args=(3,))
    p.start()
    p.join()
    with pytest.raises(RuntimeError, match="worker 0 exited with code 3"):
        _get(q, p, 0)
    q.put(("batch", 1))
    assert _get(q, p, 0) == ("batch", 1)   # sent before it exited
