"""The port's label checker (``decode/label_check.py``: ``check_labels``,
``render``) held against the JAX package's on the CPU: the aligned items
and both rendered lines equal, on ``tests/test_label_check.py``'s
near-one-hot posteriors and on random ones (float32, as the CLIs feed
them), across penalties, beams and the filler's top-k."""

from dataclasses import asdict

import numpy as np
import pytest

from test_label_check import _logp
from wenet_celoss_tpu.decode import label_check as jax_lc
from wenet_celoss_tpu_torch.decode import label_check

ID2SYM = {i: s for i, s in enumerate("_abcdefghijklmnopqrstuvwxyz")}

# (frames of the audio, the labels claimed): test_label_check.py's cases.
HAND = [([1, 1, 0, 2, 0, 3], [1, 2, 3]), ([1, 0, 0, 3, 0, 0], [1, 2, 3]),
        ([1, 0, 4, 4, 0, 2], [1, 2]), ([1, 0, 4, 4, 0, 3], [1, 2, 3]),
        ([1, 0, 2, 0, 3, 0, 4], [1, 2, 3, 4]), ([1, 0, 1], [1, 1]),
        ([1, 0, 4, 4, 0, 2], [1, 3, 2]), ([0, 0], [1]), ([1], [])]


def _both(logp, labels, **kw):
    got = label_check.check_labels(logp, labels, **kw)
    want = jax_lc.check_labels(logp, labels, **kw)
    assert (got is None) == (want is None)
    if want is None:
        return None
    assert [asdict(x) for x in got] == [asdict(x) for x in want]
    for shift, sub in ((10, 1), (10, 4), (40, 6)):
        assert label_check.render(got, ID2SYM, shift, sub) == \
            jax_lc.render(want, ID2SYM, shift, sub)
    return want


@pytest.mark.parametrize("case", range(len(HAND)))
def test_hand_posteriors_match_jax(case):
    frames, labels = HAND[case]
    _both(_logp(frames).astype(np.float32), labels)
    _both(_logp(frames, v=6, peak=3.0), labels, is_penalty=0.5,
          del_penalty=4.0)


@pytest.mark.parametrize("seed", range(4))
def test_random_posteriors_match_jax(seed):
    """Random posteriors (peaky and flat) over 28 units, labels that agree
    with the audio's best path in part: every edit kind appears."""
    rng = np.random.default_rng(seed)
    kinds = set()
    for trial in range(6):
        t, v = int(rng.integers(8, 40)), 28
        x = rng.standard_normal((t, v)) * (5.0 if trial % 2 else 1.5)
        logp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(
            np.float32)
        best = [int(u) for u in logp.argmax(-1) if u]
        labels = [u for u in best if rng.random() < 0.7] + \
            list(rng.integers(1, v, int(rng.integers(0, 3))))
        for kw in ({}, dict(is_penalty=1.0, del_penalty=0.7, beam=8,
                            filler_topk=3)):
            items = _both(logp, labels, **kw)
            kinds.update(x.kind for x in items or [])
    assert kinds >= {"ok", "del", "ins"}
