"""The "exact" hotword-gated greedy decode (the backtracking repair loop)
held against the JAX package on the CPU: on the JAX tests' golden trace,
on 50 seeded random scripts of step functions, and at the ``Decoder``
level on the tiny flagship under ``loss_mode`` "both" and "pred".

A backtrack is counted in the test's scripted gate callable: every gate
read appends one gate record, except a read that starts a backtrack,
which appends none and pops one, so backtracks = (reads - records) / 2.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import BLANK_BIAS, GATE_BIAS, VOCAB, _fill, _inputs
from wenet_celoss_tpu.configs import conformer_rnnt_bias
from wenet_celoss_tpu.decode.api import Decoder as JaxDecoder
from wenet_celoss_tpu.decode.rnnt_greedy import \
    rnnt_gated_greedy_search_exact as jax_exact
from wenet_celoss_tpu.models.factory import init_example
from wenet_celoss_tpu.models.factory import init_model as jax_init_model
from wenet_celoss_tpu_torch.decode.api import Decoder
from wenet_celoss_tpu_torch.decode.rnnt_greedy import \
    rnnt_gated_greedy_search_exact
from wenet_celoss_tpu_torch.models.factory import init_model
from wenet_celoss_tpu_torch.utils.convert import params_from_jax


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class Script:
    """Scripted step functions over integer-valued tensors, for either
    package (``xp`` builds its arrays). The predictor output is the state
    id, the biased and empty predictor streams add 1000 and 2000, the
    empty and biased encoder streams are t and t + 100; the gate and the
    joint look their answers up in seeded tables."""

    def __init__(self, seed: int, t: int, xp):
        rng = np.random.default_rng(seed)
        self.xp = xp
        self.n_states = 97
        self.vocab = 5
        self.gate = rng.random((t, self.n_states)) < rng.uniform(0.3, 0.7)
        # joint[enc id, pred id]: blank about half the time.
        self.joint = np.where(rng.random((t + 100, 2000 + self.n_states))
                              < rng.uniform(0.35, 0.65), 0,
                              rng.integers(1, self.vocab,
                                           (t + 100, 2000 + self.n_states)))
        self.gate_reads = 0

    def _arr(self, rows):
        return self.xp(np.asarray(rows, np.float32))

    def predictor_step(self, tok, state, pad):
        new = (int(state) * 31 + int(tok[0]) + 7) % self.n_states
        return self._arr([[new]]), new

    def predictor_bias_step(self, pred_out):
        return pred_out + 1000.0, pred_out

    def predictor_bias_step_empty(self, pred_out):
        return pred_out + 2000.0, pred_out

    def gate_step(self, bias_t, pred_bias):
        self.gate_reads += 1
        g = int(self.gate[int(bias_t[0, 0]), int(pred_bias[0, 0])])
        return self._arr([[1.0 - g, float(g)]])

    def joint_step(self, enc_sel, pred_sel):
        tok = int(self.joint[int(enc_sel[0, 0]), int(pred_sel[0, 0])])
        logits = np.zeros((1, self.vocab), np.float32)
        logits[0, tok] = 1.0
        return self.xp(logits)

    def run(self, fn, t, n_steps, loss_mode):
        enc_empty = self._arr(np.arange(t, dtype=np.float32)[None, :, None])
        return fn(self.predictor_step, self.predictor_bias_step,
                  self.predictor_bias_step_empty, self.joint_step,
                  self.gate_step, 0, enc_empty, enc_empty + 100.0,
                  enc_empty, t, blank=0, n_steps=n_steps,
                  loss_mode=loss_mode)


def test_golden_trace_matches_jax_test():
    """The JAX tests' hand-traced scenario (T=3, n_steps=2): one repair,
    hyps [1, 2, 1], gate record [1, 1, 1, 1]."""
    G = {(0, 0): 1, (0, 1): 0, (1, 2): 1, (2, 1): 0}
    J = {(10, 200): 1, (0, 101): 0, (1, 101): 2, (10, 201): 2,
         (10, 202): 0, (11, 202): 0, (12, 202): 1, (12, 201): 0}

    def predictor_step(tok, state, pad):
        return torch.tensor([[float(tok[0])]]), int(tok[0])

    def gate_step(bias_t, pred_bias):
        g = G.get((int(bias_t[0, 0]), int(pred_bias[0, 0])), 0)
        return torch.tensor([[1.0 - g, float(g)]])

    def joint_step(enc_sel, pred_sel):
        logits = torch.zeros((1, 3))
        logits[0, J.get((int(enc_sel[0, 0]), int(pred_sel[0, 0])), 0)] = 1
        return logits

    enc_empty = torch.tensor([[[0.0], [1.0], [2.0]]])
    hyps, gates = rnnt_gated_greedy_search_exact(
        predictor_step, lambda p: (p + 100.0, p), lambda p: (p + 200.0, p),
        joint_step, gate_step, init_state=0, encoder_out_empty=enc_empty,
        encoder_out_biased=enc_empty + 10.0, enc_bias=enc_empty,
        encoder_len=3, blank=0, n_steps=2)
    assert hyps == [1, 2, 1], (hyps, gates)
    assert gates == [1, 1, 1, 1], (hyps, gates)


def test_random_scripts_match_jax():
    """50 seeded scripts (T 3-12, n_steps 1-4, both stream pairings):
    identical hyps and gate records; at least 20 backtrack, one at least
    twice."""
    backtracks = []
    for seed in range(50):
        rng = np.random.default_rng(1000 + seed)
        t = int(rng.integers(3, 13))
        n_steps = int(rng.integers(1, 5))
        loss_mode = ("pred", "both")[seed % 2]
        got_s = Script(seed, t, torch.from_numpy)
        want_s = Script(seed, t, jnp.asarray)
        got = got_s.run(rnnt_gated_greedy_search_exact, t, n_steps,
                        loss_mode)
        want = want_s.run(jax_exact, t, n_steps, loss_mode)
        assert got == want, (seed, got, want)
        assert got_s.gate_reads == want_s.gate_reads
        n_back, odd = divmod(got_s.gate_reads - len(got[1]), 2)
        assert odd == 0
        backtracks.append(n_back)
    assert sum(n > 0 for n in backtracks) >= 20, backtracks
    assert max(backtracks) >= 2, backtracks


class JitApply:
    """A flax module whose ``apply`` runs jitted, one program a method.
    The JAX ``Decoder``'s "exact" loop calls ``model.apply`` eagerly at
    every step, which takes over a minute for the tiny batch on this CPU;
    jitted, the same functions take a second. Calls with Python numbers
    or None (static arguments) stay eager."""

    def __init__(self, module: nn.Module):
        self.module = module
        self._jits = {}

    def __getattr__(self, name):
        return getattr(self.module, name)

    def apply(self, params, *args, method=None):
        if callable(method) or any(a is None or isinstance(a, (int, float))
                                   for a in args):
            return self.module.apply(params, *args, method=method)
        fn = self._jits.get(method)
        if fn is None:
            fn = self._jits[method] = jax.jit(functools.partial(
                self.module.apply, method=method))
        return fn(params, *args)


@functools.lru_cache(maxsize=None)
def _pair(loss_mode: str):
    """(jax model, jax variables, torch model) of the tiny flagship,
    sharing seeded weights (the blank and gate biases of
    ``test_torch_models``).

    The gate that "exact" reads (``hw_gate_step``) is the "both" mode's
    head: a model trained under "pred" has no such layers in either
    package. So "pred" takes the "both" weights, with ``loss_mode``
    "pred" (the stream crossing) in both packages' models."""
    cfg = conformer_rnnt_bias(tiny=True, vocab_size=VOCAB)
    jm = jax_init_model(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *init_example(cfg, frames=16, labels=2))
    variables = _fill(shapes, seed=0)
    variables["params"]["joint"]["ffn_out"]["bias"][0] += BLANK_BIAS
    variables["params"]["context_bias"]["hw_output_layer"]["bias"][1] += \
        GATE_BIAS
    tm = init_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(variables), strict=True)
    if loss_mode != "both":
        cfg["model_conf"]["loss_mode"] = loss_mode
        jm = jax_init_model(cfg)
        tm.loss_mode = loss_mode
    return jm, variables, tm


def test_hw_gate_step_matches_jax_and_frame_form():
    """The per-step gate logits against the JAX method (1e-5), and against
    the port's frame form (the gate attends one key, so the predictor
    side does not change it)."""
    jm, v, tm = _pair("both")
    rng = np.random.default_rng(4)
    e = tm.context_bias.hw_output_layer_enc.weight.shape[1]
    enc_bias = rng.standard_normal((4, e)).astype(np.float32)
    pred_bias = rng.standard_normal((4, e)).astype(np.float32)
    want = np.asarray(jm.apply(v, enc_bias, pred_bias,
                               method="hw_gate_step"))
    with torch.no_grad():
        got = tm.hw_gate_step(torch.from_numpy(enc_bias),
                              torch.from_numpy(pred_bias))
        frames = tm.hw_gate_logits(torch.from_numpy(enc_bias)[:, None])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(frames[:, 0].numpy(), got.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("loss_mode", ["both", "pred"])
def test_decoder_exact_matches_jax(loss_mode):
    """Decoder.rnnt_greedy_search(..., "exact") on the tiny flagship:
    identical hyps and last_gates (gates [B, G] zero-padded, record
    lengths [B]) to the JAX Decoder; the gate takes both values and at
    least one utterance backtracks."""
    jm, v, tm = _pair(loss_mode)
    feats, lens, ctx, ctx_lens = _inputs()
    kw = dict(context_list=ctx, context_lengths=ctx_lens,
              context_filter_state="exact", n_steps=3)
    jd, td = JaxDecoder(JitApply(jm), v), Decoder(tm, device="cpu")
    want = jd.rnnt_greedy_search(feats, lens, **kw)
    reads = []
    gate_step = tm.hw_gate_step
    tm.hw_gate_step = lambda *a: reads.append(1) or gate_step(*a)
    try:
        got = td.rnnt_greedy_search(feats, lens, **kw)
    finally:
        del tm.hw_gate_step
    assert got == want
    assert sum(map(len, want)) >= 4, "the model should emit tokens"
    j_gates, j_glens = jd.last_gates
    t_gates, t_glens = td.last_gates
    np.testing.assert_array_equal(t_glens, np.asarray(j_glens))
    np.testing.assert_array_equal(t_gates, np.asarray(j_gates))
    flat = np.concatenate([t_gates[i, :n] for i, n in enumerate(t_glens)])
    assert 0 < flat.mean() < 1, "gates should be mixed on this model"
    n_back, odd = divmod(len(reads) - int(t_glens.sum()), 2)
    assert odd == 0 and n_back >= 1, (len(reads), t_glens)


def test_exact_trace_records_every_decision():
    """The trace of one utterance: one entry per gate read and joint, the
    backtracks marked with token -1, the gaps finite."""
    _, _, tm = _pair("both")
    feats, lens, ctx, ctx_lens = _inputs()
    trace = []
    hyps = Decoder(tm, device="cpu").rnnt_greedy_search(
        feats, lens, context_list=ctx, context_lengths=ctx_lens,
        context_filter_state="exact", n_steps=3, trace=trace)
    assert len(trace) == len(hyps)
    for utt, hyp in zip(trace, hyps):
        assert all(np.isfinite(gap) and gap >= 0 for _, _, gap in utt)
        emitted = [tok for _, tok, _ in utt if tok > 0]
        assert len(emitted) >= len(hyp)


def test_predictor_steps_leave_saved_states_unchanged():
    """The backtrack restores a state saved several steps earlier: the
    port's predictor step (frozen rows or not) must return new tensors
    and never write into the state it was given."""
    _, _, tm = _pair("both")
    state = tm.predictor_init_state(2)
    saved = [{k: v.clone() for k, v in state.items()}]
    states = [state]
    with torch.no_grad():
        for step, pad in enumerate(([0, 0], [1, 0], [0, 1])):
            _, state = tm.predictor_step(torch.tensor([3 + step, 5]), state,
                                         torch.tensor(pad))
            states.append(state)
            saved.append({k: v.clone() for k, v in state.items()})
    for got, want in zip(states, saved):
        for k in want:
            assert torch.equal(got[k], want[k])
