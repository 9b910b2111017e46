"""The port's CTC, attention and transducer beam decode modes held against
the JAX package's ``Decoder`` on the tiny flagship (``conformer_rnnt_bias``,
every mode), the tiny ``conformer_ctc_aed`` and the tiny post-norm
transformer CTC/AED (the CTC and attention modes), in fp32 on the CPU.

Both packages get the same weights: seeded numpy values in the JAX
package's parameter tree, carried to the port by the weight bridge (the
flagship's from ``tests/test_torch_models.py``, with its blank and gate
biases). Every n-best's tokens and lengths must be identical, scores
within 1e-4, and the CTC prefix beam's emission times identical.
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_models import _inputs
from test_torch_models import _pair as flagship_pair
from test_torch_postnorm import _pair as postnorm_pair
from test_torch_train import _pair as ctc_aed_pair
from wenet_celoss_tpu.decode.api import Decoder as JaxDecoder
from wenet_celoss_tpu_torch.decode.api import Decoder
from wenet_celoss_tpu_torch.decode.ctc_prefix_beam import roll_hash
from wenet_celoss_tpu_torch.utils.common import (LOG_ZERO,
                                                 remove_duplicates_and_blank,
                                                 stable_topk)

TOL = dict(rtol=1e-4, atol=1e-4)
BEAM = 4
MODELS = {"flagship": lambda: flagship_pair(), "ctc_aed": ctc_aed_pair,
          "postnorm": postnorm_pair}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _decoders(name):
    """(JAX Decoder, port Decoder) of one model; the JAX one keeps its
    compiled searches between tests."""
    _, jm, v, tm = MODELS[name]()
    return JaxDecoder(jm, v), Decoder(tm, device="cpu")


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _assert_nbest_equal(got, want, scores=True):
    """tokens [B, N, U] up to each length, lens [B, N], scores [B, N]."""
    lens = _np(want["lens"])
    np.testing.assert_array_equal(_np(got["lens"]), lens)
    g_tok, w_tok = _np(got["tokens"]), _np(want["tokens"])
    for i, j in np.ndindex(lens.shape):
        np.testing.assert_array_equal(g_tok[i, j, :lens[i, j]],
                                      w_tok[i, j, :lens[i, j]])
    if scores:
        np.testing.assert_allclose(_np(got["scores"]), _np(want["scores"]),
                                   **TOL)


@pytest.mark.parametrize("name", ["flagship", "ctc_aed", "postnorm"])
def test_ctc_greedy_matches_jax(name):
    jd, td = _decoders(name)
    feats, lens, _, _ = _inputs()
    want = jd.ctc_greedy_search(feats, lens)
    assert td.ctc_greedy_search(feats, lens) == want
    assert sum(map(len, want)) >= 4


@pytest.mark.parametrize("name", ["flagship", "ctc_aed"])
def test_ctc_prefix_beam_matches_jax(name):
    """The whole n-best: tokens, lengths, scores, Viterbi scores and
    emission times (of the live hypotheses)."""
    jd, td = _decoders(name)
    feats, lens, _, _ = _inputs()
    j_lists, j_res, _, _ = jd.ctc_prefix_beam_search(feats, lens, beam=BEAM)
    t_lists, t_res, _, _ = td.ctc_prefix_beam_search(feats, lens, beam=BEAM)
    assert t_lists == j_lists
    _assert_nbest_equal(t_res, j_res)
    live = _np(j_res["scores"]) > LOG_ZERO / 2
    np.testing.assert_allclose(_np(t_res["viterbi"])[live],
                               _np(j_res["viterbi"])[live], **TOL)
    np.testing.assert_array_equal(_np(t_res["times"])[live],
                                  _np(j_res["times"])[live])
    assert live.sum() > len(lens)


@pytest.mark.parametrize("name", ["flagship", "ctc_aed", "postnorm"])
def test_attention_beam_matches_jax(name):
    jd, td = _decoders(name)
    feats, lens, _, _ = _inputs()
    j_hyps, j_lens = jd.attention_arrays(feats, lens, beam=BEAM)
    t_hyps, t_lens = td.attention_arrays(feats, lens, beam=BEAM)
    _assert_nbest_equal({"tokens": t_hyps, "lens": t_lens},
                        {"tokens": j_hyps, "lens": j_lens}, scores=False)
    assert td.attention(feats, lens, beam=BEAM) == \
        jd.attention(feats, lens, beam=BEAM)


@pytest.mark.parametrize("name,ctc_weight,reverse_weight", [
    ("flagship", 0.5, 0.3), ("ctc_aed", 0.5, 0.3), ("ctc_aed", 0.0, 0.0),
    ("postnorm", 0.5, 0.0)])
def test_attention_rescoring_matches_jax(name, ctc_weight, reverse_weight):
    jd, td = _decoders(name)
    feats, lens, _, _ = _inputs()
    kw = dict(beam=BEAM, ctc_weight=ctc_weight,
              reverse_weight=reverse_weight)
    assert td.attention_rescoring(feats, lens, **kw) == \
        jd.attention_rescoring(feats, lens, **kw)


@pytest.mark.parametrize("context,ctc_weight", [
    (False, 0.0), (True, 0.0), (False, 0.3)])
def test_rnnt_beam_matches_jax(context, ctc_weight):
    """Plain, with the hotword list (biased streams) and with CTC shallow
    fusion: the whole n-best."""
    jd, td = _decoders("flagship")
    feats, lens, ctx, ctx_lens = _inputs()
    kw = dict(beam=BEAM, ctc_weight=ctc_weight,
              transducer_weight=1.0 - ctc_weight)
    if context:
        kw.update(context_list=ctx, context_lengths=ctx_lens)
    j_res, _, _ = jd.rnnt_beam_search(feats, lens, **kw)
    t_res, _, _ = td.rnnt_beam_search(feats, lens, **kw)
    _assert_nbest_equal(t_res, j_res)
    assert td.rnnt_beam_to_lists(t_res) == jd.rnnt_beam_to_lists(j_res)
    assert _np(t_res["lens"]).sum() >= 4


def test_transducer_and_decoder_scores_match_jax():
    """The rescorers' two scores of a CTC n-best: ``transducer_score``
    (the streaming loss over every hypothesis) and the attention scores
    through ``decoder_scores`` (reverse-blended)."""
    from wenet_celoss_tpu.decode import rescoring as jax_rescoring
    from wenet_celoss_tpu_torch.decode import rescoring
    _, jm, v, tm = flagship_pair()
    jd, td = _decoders("flagship")
    feats, lens, _, _ = _inputs()
    _, j_res, j_enc, j_mask = jd.ctc_prefix_beam_search(feats, lens,
                                                        beam=BEAM)
    _, t_res, t_enc, t_mask = td.ctc_prefix_beam_search(feats, lens,
                                                        beam=BEAM)
    j_td = jm.apply(v, j_enc, j_mask, j_res["tokens"], j_res["lens"],
                    method="transducer_score")
    j_att = jax_rescoring.score_hyps_with_decoder(
        lambda *a: jm.apply(v, *a, method="decoder_scores"), j_enc, j_mask,
        j_res["tokens"], j_res["lens"], jm.sos, jm.eos, 0.3)
    with torch.no_grad():
        t_td = tm.transducer_score(t_enc, t_mask, t_res["tokens"],
                                   t_res["lens"])
        t_att = rescoring.score_hyps_with_decoder(
            tm.decoder_scores, t_enc, t_mask, t_res["tokens"],
            t_res["lens"], tm.sos, tm.eos, 0.3)
    np.testing.assert_allclose(t_td.numpy(), np.asarray(j_td), **TOL)
    np.testing.assert_allclose(t_att.numpy(), np.asarray(j_att), **TOL)


@pytest.mark.parametrize("mode", ["ctc_beam_td", "rnnt_beam_attn"])
def test_transducer_rescorings_match_jax(mode):
    """Both rescorings with non-zero weights on every score."""
    jd, td = _decoders("flagship")
    feats, lens, ctx, ctx_lens = _inputs()
    if mode == "ctc_beam_td":
        kw = dict(beam=BEAM, ctc_weight=0.5, transducer_weight=0.7,
                  attn_weight=0.3, reverse_weight=0.3)
        fn = "ctc_beam_td_attn_rescoring"
    else:
        kw = dict(beam=BEAM, attn_weight=0.4, transducer_weight=1.0,
                  reverse_weight=0.3, context_list=ctx,
                  context_lengths=ctx_lens)
        fn = "rnnt_beam_attn_rescoring"
    assert getattr(td, fn)(feats, lens, **kw) == \
        getattr(jd, fn)(feats, lens, **kw)


def test_streaming_requests_raise():
    """Simulated streaming of a non-causal conformer with a CNN module
    raises, as in the JAX package; a chunked encode of a model without
    ``static_chunk_size`` keeps the full context, as the JAX package's
    does (U2++ streaming itself: ``tests/test_torch_streaming.py``)."""
    jd, td = _decoders("ctc_aed")
    feats, lens, _, _ = _inputs()
    with pytest.raises(NotImplementedError, match="causal"):
        td.ctc_greedy_search(feats, lens, simulate_streaming=True,
                             decoding_chunk_size=4)
    got = td.ctc_greedy_search(feats, lens, decoding_chunk_size=4)
    assert got == td.ctc_greedy_search(feats, lens)
    assert got == jd.ctc_greedy_search(feats, lens, decoding_chunk_size=4)


def test_helpers():
    """The CTC collapse, the index-ordered top-k on ties, and the int32
    wrap of the rolling hash (as a wrapping int32 product gives)."""
    assert remove_duplicates_and_blank([0, 3, 3, 0, 3, 5, 5, 0]) == [3, 3, 5]
    x = torch.tensor([[1.0, 5.0, 5.0, 2.0, 5.0]])
    vals, idx = stable_topk(x, 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[5.0] * 3]
    h = torch.tensor([2 ** 31 - 1, -2 ** 31, 12345], dtype=torch.int32)
    tok = torch.tensor([7, 0, 3])
    want = (h.numpy().astype(np.int32) * np.int32(1000003)
            + tok.numpy().astype(np.int32) + np.int32(1))
    got = roll_hash(h, 1000003, tok)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
