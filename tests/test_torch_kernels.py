"""The port's CUDA kernels on the card, against their plain PyTorch
versions and the CPU run of the same model. Every test here needs an
NVIDIA card and nvcc and skips without one. This file imports no jax, so
it also runs on the machine with the card, where jax is absent:

    python -m pytest --noconftest -o addopts="" -m gpu \\
        tests/test_torch_kernels.py -q
"""

import copy

import numpy as np
import pytest
import torch

from wenet_celoss_tpu_torch.configs import (conformer_ctc_aed,
                                            conformer_rnnt_bias)
from wenet_celoss_tpu_torch.decode.api import Decoder
from wenet_celoss_tpu_torch.models.factory import init_model
from wenet_celoss_tpu_torch.ops import conv, ffn, ln_matmul, lstm, rnnt_loss
from wenet_celoss_tpu_torch.utils.common import LOG_ZERO
from wenet_celoss_tpu_torch.parallel import train

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["ln_ffn_residual", "ffn_fused"])
@pytest.mark.parametrize("d,f", [(64, 512), (256, 2048)])
@pytest.mark.parametrize("n", [1, 1000, 8128, 32512])
@pytest.mark.parametrize("activation", ["relu", "swish"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_kernel_matches_plain_version_on_card(dtype, kernel, d, f, n,
                                              activation, rate):
    """The forward of K1 (ln_ffn_residual, ff_scale 0.5, both masks at
    ``rate``) and K6 (ffn_fused, the hidden mask) at the tiny and full
    widths, N from one row to the training encoder's 32512 (both
    schedules of the bf16 kernel), against the plain version with the
    same masks: fp32 to 1e-4 + 1e-4*|ref| elementwise, bf16 to relative
    Frobenius 1e-2 (summation order and bf16 rounding of the hidden at
    the plain version's points); one launch a call, and the same bits on
    a second call."""
    dt = getattr(torch, dtype)
    args, _ = _k1_args(n, dt, seed=n + d, d=d, f=f)
    x, g, bl, w1, b1, w2, b2 = args
    if kernel == "ln_ffn_residual":
        cfg = (activation, 0.5, 1e-5, rate, rate, 99)
        counter = ffn.ln_ffn_residual
        before = counter.launches
        got = ffn.ln_ffn_residual(*args, *cfg)
        again = ffn.ln_ffn_residual(*args, *cfg)
        want = ffn.ln_ffn_residual_ref(*args, *cfg)
    else:
        cfg = (activation, rate, 99)
        counter = ffn.ffn_fused
        before = counter.launches
        got = ffn.ffn_fused(x, w1, b1, w2, b2, *cfg)
        again = ffn.ffn_fused(x, w1, b1, w2, b2, *cfg)
        want = ffn.ffn_fused_ref(x, w1, b1, w2, b2, *cfg)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    err = got.float() - want.float()
    if dt == torch.float32:
        assert bool((err.abs() <= 1e-4 + 1e-4 * want.abs()).all())
    else:
        assert float(err.norm() / want.float().norm()) <= 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [16, 1024])
def test_k1_forward_at_streaming_chunk_rows(dtype, n):
    """K1's forward at the rows of one streaming chunk (16 output frames:
    N = 16 for one utterance, 1024 for 64), swish, ff_scale 0.5, rate 0
    as every FFN block of ``forward_with_cache`` runs it: one launch a
    call, the same bits on a second call, and the plain version's values
    (the tolerances of test_kernel_matches_plain_version_on_card)."""
    dt = getattr(torch, dtype)
    args, _ = _k1_args(n, dt, seed=n)
    cfg = ("swish", 0.5, 1e-5, 0.0, 0.0, 0)
    before = ffn.ln_ffn_residual.launches
    got = ffn.ln_ffn_residual(*args, *cfg)
    again = ffn.ln_ffn_residual(*args, *cfg)
    want = ffn.ln_ffn_residual_ref(*args, *cfg)
    torch.cuda.synchronize()
    assert ffn.ln_ffn_residual.launches == before + 2
    assert torch.equal(got, again)
    err = got.float() - want.float()
    if dt == torch.float32:
        assert bool((err.abs() <= 1e-4 + 1e-4 * want.abs()).all())
    else:
        assert float(err.norm() / want.float().norm()) <= 1e-2


def _k1_args(n, dt, seed=7, d=256, f=2048):
    rng = np.random.default_rng(seed)

    def arr(*shape, std=1.0, mean=0.0):
        return torch.as_tensor(mean + std * rng.standard_normal(shape),
                               dtype=torch.float32, device="cuda")
    x = arr(n, d).to(dt)
    g, bl = arr(d, std=0.1, mean=1.0), arr(d, std=0.1)
    w1, b1 = arr(f, d, std=d ** -0.5).to(dt), arr(f, std=0.1)
    w2, b2 = arr(d, f, std=f ** -0.5).to(dt), arr(d, std=0.1)
    dy = arr(n, d).to(dt)
    return (x, g, bl, w1, b1, w2, b2), dy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n,activation,ff_scale",
                         [(1000, "relu", 1.0), (4064, "swish", 0.5)])
def test_backward_kernel_matches_plain_version_on_card(dtype, rate, n,
                                                       activation, ff_scale):
    """The forward with dropout and all seven gradients against autograd
    through the plain version with the same seed: the masks of the forward
    and both backward passes must agree. dx to 1e-4 + 1e-4*|ref| in fp32
    (for relu over the rows with no |z1| < 1e-5, where another summation
    order can flip relu' between 0 and 1); bf16 and the weight gradients
    (sums over N rows in another order) to relative Frobenius 1e-2."""
    dt = getattr(torch, dtype)
    args, dy = _k1_args(n, dt)
    cfg = (activation, ff_scale, 1e-5, rate, rate, 12345)
    k1 = ffn.ln_ffn_residual
    before = (k1.launches, k1.bwd_launches)
    ins = [a.detach().requires_grad_(True) for a in args]
    y = ffn.ln_ffn_residual(*ins, *cfg)
    got = torch.autograd.grad(y, ins, dy)
    torch.cuda.synchronize()
    assert (k1.launches, k1.bwd_launches) == (before[0] + 1, before[1] + 1)
    want_y = ffn.ln_ffn_residual_ref(*args, *cfg)
    want = ffn.backward_ref(*args[:1], dy, *args[1:], *cfg)
    rows = slice(None)
    if activation == "relu":
        x, g, bl, w1, b1 = args[:5]
        xn = torch.nn.functional.layer_norm(x.float(), (x.shape[1],), g, bl)
        z1 = xn.to(dt).float() @ w1.float().t() + b1
        rows = (z1.abs() >= 1e-5).all(dim=1)
    for name, a, b in zip(["y", "dx", "dg", "dbl", "dw1", "db1", "dw2",
                           "db2"], [y, *got], [want_y, *want]):
        assert a.dtype == b.dtype, name
        err = a.float() - b.float()
        if dt == torch.float32 and name in ("y", "dx"):
            ok = err.abs() <= 1e-4 + 1e-4 * b.abs()
            assert bool(ok[rows].all() if name == "dx" else ok.all()), name
        else:
            rel = float(err.norm() / b.float().norm())
            assert rel <= 1e-2, (name, rel)


@pytest.mark.parametrize("kernel", ["ln_ffn_residual", "ffn_fused"])
@pytest.mark.parametrize("d,f", [(64, 512), (256, 2048)])
@pytest.mark.parametrize("n", [1, 1000, 4064, 8448])
@pytest.mark.parametrize("activation", ["relu", "swish"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_backward_matches_plain_version_on_card(kernel, d, f, n,
                                                     activation, rate):
    """The bf16 backward (wgmma and TMA, both passes) of K1 and K6 at the
    tiny and full widths, N from one row to the decoder's 8448 (one and
    two warpgroups a pass-A block), every gradient against autograd
    through the plain version with the same masks: relative Frobenius
    <= 1e-2 (bf16 rounding of dh, dz1 and the hidden at the Pallas
    kernel's points, N-row sums in another order); one launch."""
    args, dy = _k1_args(n, torch.bfloat16, seed=n + d, d=d, f=f)
    x, g, bl, w1, b1, w2, b2 = args
    if kernel == "ln_ffn_residual":
        cfg = (activation, 0.5, 1e-5, rate, rate, 2024)
        counter = ffn.ln_ffn_residual
        before = counter.bwd_launches
        got = ffn.backward_kernel(x, dy, *args[1:], *cfg)
        want = ffn.backward_ref(x, dy, *args[1:], *cfg)
    else:
        cfg = (activation, rate, 2024)
        counter = ffn.ffn_fused
        before = counter.bwd_launches
        got = ffn.ffn_backward_kernel(x, dy, w1, b1, w2, b2, *cfg)
        want = ffn.ffn_backward_ref(x, dy, w1, b1, w2, b2, *cfg)
    torch.cuda.synchronize()
    assert counter.bwd_launches == before + 1
    for i, (a, r) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(a).all()), i
        if float(r.float().norm()) == 0.0:
            assert float(a.float().norm()) == 0.0, i
        else:
            assert _rel(a, r) <= 1e-2, (i, _rel(a, r))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [132, 330, 700, 1000, 1281])
def test_backward_weight_pass_is_deterministic_on_ragged_splits(dtype, n):
    """The weight-gradient pass splits N into whole 64-row chunks; at
    these N the last split is short (bf16: 4, 74, 124, 232 and 129 rows
    of 64, 128, 192, 256 and 384 at F = 2048; fp32: or, counted before the
    rounding, would be empty). dW1, db1 and dW2 must be the same bits on
    every call, with a larger backward launched in between so that shared
    memory holds other sums when the small one starts."""
    dt = getattr(torch, dtype)
    cfg = ("relu", 1.0, 1e-5, 0.1, 0.1, 77)
    args, dy = _k1_args(n, dt, seed=n)
    big, big_dy = _k1_args(8448, dt, seed=1)
    first = ffn.backward_kernel(args[0], dy, *args[1:], *cfg)
    for _ in range(5):
        ffn.backward_kernel(big[0], big_dy, *big[1:], *cfg)
        again = ffn.backward_kernel(args[0], dy, *args[1:], *cfg)
        for i in (4, 5, 6):
            assert torch.equal(first[i], again[i]), i


def test_tiny_model_on_card_matches_cpu():
    """The tiny flagship in fp32: encoder within 1e-4 of the CPU run
    (plain versions), identical plain and gated hyps, and 2 kernel
    launches per conformer block per encoder pass."""
    cfg = conformer_rnnt_bias(tiny=True, vocab_size=30)
    card = init_model(cfg, seed=3)
    cpu = init_model(cfg, device="cpu", seed=3)
    with torch.no_grad():
        card.joint.ffn_out.bias[0] += 1.5
        cpu.joint.ffn_out.bias[0] += 1.5
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((4, 64, 80)).astype(np.float32)
    lens = np.array([64, 50, 33, 20])
    ctx = np.array([[0, -1, -1], [3, 4, 5], [7, 8, -1]])
    ctx_lens = np.array([1, 3, 2])
    with torch.no_grad():
        e_card = card.encode_transducer(
            torch.as_tensor(feats, device="cuda"),
            torch.as_tensor(lens, device="cuda"))
        e_cpu = cpu.encode_transducer(torch.as_tensor(feats),
                                      torch.as_tensor(lens))
    mask = e_cpu[3]
    torch.testing.assert_close(e_card[0].cpu()[mask], e_cpu[0][mask],
                               rtol=1e-4, atol=1e-4)
    d_card, d_cpu = Decoder(card), Decoder(cpu, device="cpu")
    blocks = cfg["encoder_conf"]["num_blocks"]
    for kw, passes in (({}, 1), ({"context_filter_state": "on"}, 2)):
        if kw:
            kw.update(context_list=ctx, context_lengths=ctx_lens)
        before = ffn.ln_ffn_residual.launches
        got = d_card.rnnt_greedy_search(feats, lens, n_steps=3, **kw)
        assert ffn.ln_ffn_residual.launches - before == 2 * blocks * passes
        assert got == d_cpu.rnnt_greedy_search(feats, lens, n_steps=3, **kw)


def _rnd(g, *shape, std=1.0):
    return (torch.randn(*shape, generator=g) * std).cuda()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["tanh", "relu", "swish"])
@pytest.mark.parametrize("h,v,blank", [(128, 1000, 0), (512, 5002, 0),
                                       (512, 1000, 999)])
def test_joint_kernels_match_plain_versions_on_card(dtype, activation, h, v,
                                                    blank):
    """K2's planes to 1e-3 + 1e-4*|ref| (row U of emit_lp has no label)
    and K3's four gradients to relative Frobenius 1e-4 (fp32) or 1e-2
    (bf16) on a ragged shape (B*T'*U1 = 1665 rows, T' = 37, V not a
    multiple of a tile) at both joint widths the configs run (2d = 128 and
    512); the last case puts blank and every other label on V - 1, the
    padded tile's last real column. One launch a call, and the same bits
    on a second call of each kernel."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(3)
    b, t, u1 = 5, 37, 9
    args = (_rnd(g, b, t, h, std=0.5).to(dt), _rnd(g, b, u1, h, std=0.5).to(
        dt), _rnd(g, v, h, std=h ** -0.5).to(dt), _rnd(g, v, std=0.1),
        torch.randint(1, v, (b, u1 - 1), generator=g).cuda())
    if blank:
        args[4][:, ::2] = v - 1
    gb = torch.rand(b, t, u1, generator=g).cuda()
    ge = torch.rand(b, t, u1, generator=g).cuda()
    ge[..., -1] = 0.0
    k2, k3 = rnnt_loss.joint_planes, rnnt_loss.joint_planes_bwd
    before = (k2.launches, k3.launches)
    got = rnnt_loss.joint_planes_kernel(*args, blank, activation)
    again = rnnt_loss.joint_planes_kernel(*args, blank, activation)
    want = rnnt_loss.joint_planes_ref(*args, blank, activation)
    for a, c, r in zip(got, again, want):
        assert torch.equal(a, c)
        err = (a - r)[..., :-1].abs()
        assert bool((err <= 1e-3 + 1e-4 * r[..., :-1].abs()).all())
    lse = got[2].contiguous()
    first = rnnt_loss.joint_planes_bwd_kernel(*args, gb, ge, lse, blank,
                                              activation)
    again = rnnt_loss.joint_planes_bwd_kernel(*args, gb, ge, lse, blank,
                                              activation)
    torch.cuda.synchronize()
    assert (k2.launches, k3.launches) == (before[0] + 2, before[1] + 2)
    ref = rnnt_loss.joint_planes_bwd_ref(*args, gb, ge, lse, blank,
                                         activation)
    limit = 1e-4 if dt == torch.float32 else 1e-2
    for a, c, r in zip(first, again, ref):
        assert torch.equal(a, c)
        assert float((a - r).norm() / r.norm()) <= limit


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,u1,h", [(37, 9, 64), (100, 9, 128),
                                    (100, 17, 256), (37, 1, 64),
                                    (37, 1, 256), (256, 33, 256)])
def test_lstm_kernels_match_plain_version_on_card(dtype, rate, b, u1, h):
    """K4's output and five gradients against autograd through the plain
    version with the same mask, relative Frobenius 1e-4 (fp32) or 2e-2
    (bf16), at every bf16 width (H 64, 128, 256), on batches ragged
    against the bf16 kernels' 64-row cluster group (37, 100), with one
    label step (U1 = 1) and at the training shape; one launch each way,
    and the same bits on a second backward."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(4)
    args = (_rnd(g, b, u1, 4 * h, std=0.5).to(dt),
            *(_rnd(g, 4 * h, h, std=h ** -0.5) for _ in range(2)),
            _rnd(g, 4 * h, std=0.1), _rnd(g, 4 * h, h, std=h ** -0.5))
    dy = _rnd(g, b, u1, h).to(dt)
    before = (lstm.lstm2_seq.launches, lstm.lstm2_seq.bwd_launches)
    ins = [a.detach().requires_grad_(True) for a in args]
    y = lstm.lstm2_seq(*ins, rate=rate, seed=9)
    got = torch.autograd.grad(y, ins, dy)
    torch.cuda.synchronize()
    assert (lstm.lstm2_seq.launches, lstm.lstm2_seq.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    want = (lstm.lstm2_seq_ref(*args, rate=rate, seed=9),
            *lstm.backward_ref(dy, *args, rate=rate, seed=9))
    limit = 1e-4 if dt == torch.float32 else 2e-2
    for a, r in zip((y, *got), want):   # U1 = 1: dWh1 = dWh2 = 0 exactly
        assert float((a.float() - r.float()).norm()) <= \
            limit * float(r.float().norm())
    again = torch.autograd.grad(lstm.lstm2_seq(*ins, rate=rate, seed=9),
                                ins, dy)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [640, 617])
def test_lstm_forward_at_the_nbest_shape_on_card(dtype, b):
    """K4's forward without autograd at the shape transducer_score gives
    it (the n-best of 64 utterances at beam 10: B = 640, U1 = 128, H =
    256) and on a B ragged against the 64-row clusters: one launch, the
    output within the training shape's tolerance (relative Frobenius 1e-4
    fp32, 2e-2 bf16) of the plain version over 128 steps."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(b)
    h, u1 = 256, 128
    args = (_rnd(g, b, u1, 4 * h, std=0.5).to(dt),
            *(_rnd(g, 4 * h, h, std=h ** -0.5) for _ in range(2)),
            _rnd(g, 4 * h, std=0.1), _rnd(g, 4 * h, h, std=h ** -0.5))
    before = lstm.lstm2_seq.launches
    with torch.no_grad():
        y = lstm.lstm2_seq(*args)
        torch.cuda.synchronize()
        assert lstm.lstm2_seq.launches == before + 1
        want = lstm.lstm2_seq_ref(*args)
    limit = 1e-4 if dt == torch.float32 else 2e-2
    assert float((y.float() - want.float()).norm()) <= \
        limit * float(want.float().norm())


def test_joint_forward_at_the_nbest_shape_on_card():
    """K2 without autograd at transducer_score's shape on the n-best of
    64 utterances at beam 10: B = 640 hypotheses of T' = 127 frames
    (81280 encoder rows), U1 = 128, H = 512, V = 5002, bf16: one launch,
    the planes within 1e-3 + 1e-4*|ref| of the plain version (row U of
    emit_lp has no label)."""
    g = torch.Generator().manual_seed(5)
    b, t, u1, h, v = 640, 127, 128, 512, 5002
    dt = torch.bfloat16
    args = (_rnd(g, b, t, h, std=0.5).to(dt), _rnd(g, b, u1, h, std=0.5).to(
        dt), _rnd(g, v, h, std=h ** -0.5).to(dt), _rnd(g, v, std=0.1),
        torch.randint(1, v, (b, u1 - 1), generator=g).cuda())
    before = rnnt_loss.joint_planes.launches
    with torch.no_grad():
        got = rnnt_loss.joint_planes(*args, 0, "tanh")
        torch.cuda.synchronize()
        assert rnnt_loss.joint_planes.launches == before + 1
        want = rnnt_loss.joint_planes_ref(*args, 0, "tanh", chunk=4)
    for a, r in zip(got, want):
        err = (a - r)[..., :-1].abs()
        assert bool((err <= 1e-3 + 1e-4 * r[..., :-1].abs()).all())


def test_lattice_at_the_nbest_shape_on_card():
    """K9 without autograd at the n-best's lattice (B = 640, T' = 127,
    U1 = 128) with ragged frame and label lengths: valid cells within
    1e-4 + 1e-5*|ref|, every cell off a lattice exactly LOG_ZERO, one
    launch."""
    g = torch.Generator().manual_seed(11)
    b, t, u1 = 640, 127, 128
    lp = torch.log_softmax(torch.randn(b, t, u1, 3, generator=g), -1).cuda()
    blank, emit = lp[..., 0].contiguous(), lp[..., 1].contiguous()
    emit[..., -1] = LOG_ZERO
    il = torch.randint(1, t + 1, (b,), generator=g).cuda()
    il[0] = t
    ll = torch.randint(0, u1, (b,), generator=g).cuda()
    ll[0] = u1 - 1
    before = rnnt_loss.alpha_beta.launches
    with torch.no_grad():
        got = rnnt_loss.alpha_beta(blank, emit, il, ll)
        torch.cuda.synchronize()
        assert rnnt_loss.alpha_beta.launches == before + 1
        want = rnnt_loss.alpha_beta_ref(blank, emit, il, ll)
    for a, r in zip(got, want):
        off = r == LOG_ZERO
        assert bool((a[off] == LOG_ZERO).all())
        err = (a - r)[~off].abs()
        assert bool((err <= 1e-4 + 1e-5 * r[~off].abs()).all())


def test_tiny_flagship_training_step_on_card_matches_cpu():
    """One fp32 gradient step of the tiny flagship with hotwords, dropout
    0: every loss term within 1e-4 and every gradient within 1e-3
    relative Frobenius of the CPU run; one launch of K2, K3, K9 and each
    direction of K4, 2 * blocks + 2 K1 launches each way."""
    cfg = conformer_rnnt_bias(tiny=True, vocab_size=30)
    for conf in (cfg["encoder_conf"], cfg["decoder_conf"]):
        for k in conf:
            if k.endswith("dropout_rate"):
                conf[k] = 0.0
    cfg["predictor_conf"].update(embed_dropout=0.0, dropout=0.0)
    card, cpu = init_model(cfg, seed=5), init_model(cfg, device="cpu",
                                                    seed=5)
    rng = np.random.default_rng(2)
    batch = {"feats": rng.standard_normal((4, 64, 80)).astype(np.float32),
             "feat_lengths": np.array([64, 50, 33, 20]),
             "labels": rng.integers(1, 28, (4, 6)),
             "label_lengths": np.array([6, 3, 0, 5]),
             "context_list": np.array([[0, -1], [3, 4], [7, -1]]),
             "context_lengths": np.array([1, 2, 1]),
             "hw_labels": rng.integers(0, 2, (4, 6))}
    counts = [(ffn.ln_ffn_residual, "launches"),
              (ffn.ln_ffn_residual, "bwd_launches"),
              (rnnt_loss.joint_planes, "launches"),
              (rnnt_loss.joint_planes_bwd, "launches"),
              (lstm.lstm2_seq, "launches"), (lstm.lstm2_seq, "bwd_launches"),
              (rnnt_loss.alpha_beta, "launches")]
    before = [getattr(o, a) for o, a in counts]
    results = []
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        results.append(train.make_grad_fn(model)(
            train.TrainState(0, model, None),
            {k: torch.as_tensor(v, device=dev) for k, v in batch.items()},
            torch.Generator()))
        if dev == "cuda":
            torch.cuda.synchronize()
            k1 = 2 * cfg["encoder_conf"]["num_blocks"] + 2
            assert [getattr(o, a) - n for (o, a), n in
                    zip(counts, before)] == [k1, k1, 1, 1, 1, 1, 1]
    (g_card, m_card), (g_cpu, m_cpu) = results
    for k in m_cpu:
        assert abs(float(m_card[k]) - float(m_cpu[k])) <= \
            1e-4 * abs(float(m_cpu[k])) + 1e-6, k
    for a, b in zip(g_card, g_cpu):
        assert float((a.cpu() - b).norm()) <= 1e-3 * float(b.norm()) + 1e-7


@pytest.mark.parametrize("u1", [9, 40, 70])
def test_lattice_kernel_matches_plain_version_on_card(u1):
    """K9 against alpha_scan/beta_scan on a ragged batch (T' = 37, one to
    three 32-column register groups a lane): valid cells within 1e-4 +
    1e-5*|ref|, every cell off beta's lattice exactly LOG_ZERO, one launch."""
    g = torch.Generator().manual_seed(u1)
    b, t = 5, 37
    lp = torch.log_softmax(torch.randn(b, t, u1, 3, generator=g), -1).cuda()
    blank, emit = lp[..., 0].contiguous(), lp[..., 1].contiguous()
    emit[..., -1] = LOG_ZERO
    il = torch.tensor([37, 20, 1, 30, 37]).cuda()
    ll = torch.tensor([u1 - 1, 3, 0, u1 // 2, 1]).cuda()
    before = rnnt_loss.alpha_beta.launches
    got = rnnt_loss.alpha_beta(blank, emit, il, ll)
    torch.cuda.synchronize()
    assert rnnt_loss.alpha_beta.launches == before + 1
    want = rnnt_loss.alpha_beta_ref(blank, emit, il, ll)
    for a, r in zip(got, want):
        off = r == LOG_ZERO
        assert bool((a[off] == LOG_ZERO).all())
        err = (a - r)[~off].abs()
        assert bool((err <= 1e-4 + 1e-5 * r[~off].abs()).all())


@pytest.mark.parametrize("u1", [257, 600, 1030])
def test_lattice_kernel_matches_plain_version_above_256_columns(u1):
    """K9's multi-warp rows (2, 3 and 5 warps of 256 columns, the seam
    columns crossing through shared memory) against alpha_scan/beta_scan
    on a ragged batch: valid cells within 1e-4 + 1e-5*|ref|, every cell
    off beta's lattice exactly LOG_ZERO, one launch."""
    g = torch.Generator().manual_seed(u1)
    b, t = 3, 29
    lp = torch.log_softmax(torch.randn(b, t, u1, 3, generator=g), -1).cuda()
    blank, emit = lp[..., 0].contiguous(), lp[..., 1].contiguous()
    emit[..., -1] = LOG_ZERO
    il = torch.tensor([29, 17, 1]).cuda()
    ll = torch.tensor([u1 - 1, 255, 0]).cuda()
    before = rnnt_loss.alpha_beta.launches
    got = rnnt_loss.alpha_beta(blank, emit, il, ll)
    torch.cuda.synchronize()
    assert rnnt_loss.alpha_beta.launches == before + 1
    want = rnnt_loss.alpha_beta_ref(blank, emit, il, ll)
    for a, r in zip(got, want):
        off = r == LOG_ZERO
        assert bool((a[off] == LOG_ZERO).all())
        err = (a - r)[~off].abs()
        assert bool((err <= 1e-4 + 1e-5 * r[~off].abs()).all())


# K9 at its edge shapes: (B, T', U1, input lengths, label lengths). One
# cell; one row of the lattice either way; 0 labels and T_b = 1; rows of
# 140 bytes (every 4th 16-byte aligned); U1 around 256 (4 and 5 warps a
# direction), on 9 warps, and on 32 warps at 5 and 8 columns a lane (the
# 8192-column limit). The kernel stages a row that fits in shared memory
# and runs the rest on rings: the training width at T' = 300 and one
# column at T' = 3400 take the ring with 0 labels, T_b = 1 and full rows.
LATTICE_EDGES = (
    (1, 1, 1, [1], [0]),
    (3, 1, 6, [1, 1, 1], [5, 0, 2]),
    (2, 7, 1, [7, 1], [0, 0]),
    (5, 5, 7, [5, 1, 3, 5, 2], [6, 0, 6, 2, 0]),
    (3, 9, 255, [9, 1, 4], [254, 0, 100]),
    (3, 9, 256, [9, 5, 1], [255, 17, 0]),
    (3, 9, 257, [9, 2, 7], [256, 256, 3]),
    (2, 6, 513, [6, 3], [512, 40]),
    (2, 3, 4097, [3, 2], [4096, 1000]),
    (2, 3, 8192, [3, 1], [8191, 0]),
    (4, 300, 33, [300, 1, 300, 157], [32, 0, 0, 20]),
    (2, 3400, 1, [3400, 1], [0, 0]),
)


@pytest.mark.parametrize("case", range(len(LATTICE_EDGES)))
def test_lattice_kernel_edge_shapes(case):
    """K9 at LATTICE_EDGES against alpha_scan/beta_scan: valid cells
    within 1e-4 + 1e-5*|ref|, every cell off a lattice exactly LOG_ZERO,
    beta[0,0] equal to the terminal alpha + blank within 1e-5 relative,
    the same bits again."""
    b, t, u1, il, ll = LATTICE_EDGES[case]
    g = torch.Generator().manual_seed(case)
    lp = torch.log_softmax(torch.randn(b, t, u1, 3, generator=g), -1).cuda()
    blank, emit = lp[..., 0].contiguous(), lp[..., 1].contiguous()
    emit[..., -1] = LOG_ZERO
    il, ll = torch.tensor(il).cuda(), torch.tensor(ll).cuda()
    got = rnnt_loss.alpha_beta_kernel(blank, emit, il, ll)
    again = rnnt_loss.alpha_beta_kernel(blank, emit, il, ll)
    torch.cuda.synchronize()
    want = rnnt_loss.alpha_beta_ref(blank, emit, il, ll)
    for a, a2, r in zip(got, again, want):
        assert torch.equal(a, a2)
        off = r == LOG_ZERO
        assert bool((a[off] == LOG_ZERO).all())
        err = (a - r)[~off].abs()
        assert bool((err <= 1e-4 + 1e-5 * r[~off].abs()).all())
    rows = torch.arange(b, device="cuda")
    term = got[0][rows, il - 1, ll] + blank[rows, il - 1, ll]
    assert bool(((got[1][:, 0, 0] - term).abs()
                 <= 1e-5 * term.abs()).all())


def _conv_args(b, t, d, k, dt, seed):
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(1, t + 1, (b,), generator=g)
    lens[0] = t
    mask = (torch.arange(t)[None, :] < lens[:, None]).float().cuda()
    args = (_rnd(g, b, t, d).to(dt), 1.0 + _rnd(g, d, std=0.1),
            _rnd(g, d, std=0.1), _rnd(g, d, 2 * d, std=d ** -0.5).to(dt),
            _rnd(g, 2 * d, std=0.1), _rnd(g, k, d, std=k ** -0.5),
            _rnd(g, d, std=0.1), 1.0 + _rnd(g, d, std=0.1),
            _rnd(g, d, std=0.1), _rnd(g, d, d, std=d ** -0.5).to(dt),
            _rnd(g, d, std=0.1))
    return args, mask, _rnd(g, b, t, d).to(dt)


@pytest.mark.parametrize("dtype,b,t,d", [
    ("float32", 3, 45, 128), ("bfloat16", 3, 45, 256),
    ("bfloat16", 2, 300, 256), ("bfloat16", 2, 256, 256),
    ("bfloat16", 3, 150, 256), ("bfloat16", 256, 127, 256)])
@pytest.mark.parametrize("causal,rate", [(False, 0.0), (False, 0.1),
                                         (True, 0.1)])
def test_conv_block_kernels_match_plain_version_on_card(dtype, b, t, d,
                                                        causal, rate):
    """K8's output and its eleven backward outputs against autograd
    through the plain version with the same mask, relative Frobenius 1e-4
    (fp32) or 2e-2 (bf16), on padded batches: fp32 at T = 45 (not a
    multiple of its 32-frame tile, K = 7 non-causal), bf16 (D = 256, K =
    15) at T = 45, 150, 256 and 300 (one, two and three 128-frame steps;
    256 ends on a step without PW1 rows), and at the U2++ training
    encoder's B = 256, T = 127 (causal there under ``CONV_PALLAS=1``);
    the same bits on a second backward."""
    dt = getattr(torch, dtype)
    k = 15 if causal or dt == torch.bfloat16 else 7
    args, mask, dy = _conv_args(b, t, d, k, dt, 6)
    cfg = dict(seed=321, causal=causal, rate=rate)
    ins = [a.detach().requires_grad_(True) for a in args]
    before = (conv.conv_block_residual.launches,
              conv.conv_block_residual.bwd_launches)
    y = conv.conv_block_residual(ins[0], mask, *ins[1:], **cfg)
    got = torch.autograd.grad(y, ins, dy)
    torch.cuda.synchronize()
    assert (conv.conv_block_residual.launches,
            conv.conv_block_residual.bwd_launches) == (before[0] + 1,
                                                       before[1] + 1)
    flat = (cfg["seed"], causal, rate, 1e-5)
    want_y = conv.conv_block_residual_ref(args[0], mask, *args[1:], *flat)
    want = conv.backward_ref(args[0], mask, *args[1:], dy, *flat)
    limit = 1e-4 if dt == torch.float32 else 2e-2
    for a, r in zip((y.detach(), *got), (want_y, *want)):
        assert float((a.float() - r.float()).norm()
                     / r.float().norm()) <= limit
    first = conv.backward_kernel(args[0], mask, *args[1:], dy, *flat)
    again = conv.backward_kernel(args[0], mask, *args[1:], dy, *flat)
    assert all(torch.equal(p, q) for p, q in zip(first, again))


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k,masked,d", [
    (1000, 768, False, 256), (8448, 768, False, 256), (4064, 512, True, 256),
    (77, 512, True, 256), (129, 768, True, 256), (8191, 512, False, 256),
    (1000, 192, True, 64), (129, 192, False, 64), (1000, 384, True, 128),
    (8191, 384, False, 128)])
def test_ln_matmul_kernels_match_plain_version_on_card(dtype, n, k, masked,
                                                       d):
    """K7's output and its five gradients against autograd through the
    plain version: relative Frobenius 1e-5 (fp32) or 1e-2 (bf16), at every
    width the bf16 kernels take (K = 192 leaves the weight pass's last
    block half its 128 columns), N ragged against the 64- and 128-row
    blocks; masked rows come out as the bias; the same bits on every
    backward call."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(n)
    args = [_rnd(g, n, d).to(dt), 1.0 + _rnd(g, d, std=0.1),
            _rnd(g, d, std=0.1), _rnd(g, k, d, std=d ** -0.5).to(dt),
            _rnd(g, k, std=0.1)]
    mask = ((torch.rand(n, generator=g) > 0.3).float().cuda() if masked
            else None)
    dy = _rnd(g, n, k).to(dt)
    ins = [a.detach().requires_grad_(True) for a in args]
    lm = ln_matmul.ln_matmul
    before = (lm.launches, lm.bwd_launches)
    y = lm(*ins, mask)
    got = torch.autograd.grad(y, ins, dy)
    torch.cuda.synchronize()
    assert (lm.launches, lm.bwd_launches) == (before[0] + 1, before[1] + 1)
    want_y = ln_matmul.ln_matmul_ref(*args, mask)
    want = ln_matmul.backward_ref(*args, mask, dy, 1e-5)
    limit = 1e-5 if dt == torch.float32 else 1e-2
    for a, r in zip((y.detach(), *got), (want_y, *want)):
        assert a.dtype == r.dtype and _rel(a, r) <= limit
    if masked:
        off = mask == 0
        assert torch.equal(y.detach()[off],
                           args[4].to(dt).expand(int(off.sum()), k))
    first = ln_matmul.backward_kernel(*args, mask, dy, 1e-5)
    again = ln_matmul.backward_kernel(*args, mask, dy, 1e-5)
    assert all(torch.equal(p, q) for p, q in zip(first, again))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation,rate", [("relu", 0.0), ("relu", 0.1),
                                             ("swish", 0.1)])
def test_ffn_fused_kernels_match_plain_version_on_card(dtype, activation,
                                                       rate):
    """K6's output and its five gradients against autograd through the
    plain version with the same mask, N = 1000: fp32 y and dx to 1e-4 +
    1e-4*|ref| (relu: over the rows with no |z1| < 1e-5), bf16 and the
    weight gradients to relative Frobenius 1e-2; the same bits on every
    backward call."""
    dt = getattr(torch, dtype)
    args, dy = _k1_args(1000, dt, seed=11)
    x, _, _, w1, b1, w2, b2 = args
    k6 = ffn.ffn_fused
    before = (k6.launches, k6.bwd_launches)
    ins = [a.detach().requires_grad_(True) for a in (x, w1, b1, w2, b2)]
    y = k6(*ins, activation, rate, 99)
    got = torch.autograd.grad(y, ins, dy)
    torch.cuda.synchronize()
    assert (k6.launches, k6.bwd_launches) == (before[0] + 1, before[1] + 1)
    want_y = ffn.ffn_fused_ref(x, w1, b1, w2, b2, activation, rate, 99)
    want = ffn.ffn_backward_ref(x, dy, w1, b1, w2, b2, activation, rate, 99)
    rows = (x.float() @ w1.float().t() + b1).abs().min(dim=1).values >= 1e-5
    for name, a, r in zip(["y", "dx", "dw1", "db1", "dw2", "db2"],
                          [y, *got], [want_y, *want]):
        assert a.dtype == r.dtype, name
        if dt == torch.float32 and name in ("y", "dx"):
            ok = (a - r).abs() <= 1e-4 + 1e-4 * r.abs()
            if name == "dx" and activation == "relu":
                ok = ok[rows]
            assert bool(ok.all()), name
        else:
            assert _rel(a, r) <= 1e-2, name
    first = ffn.ffn_backward_kernel(x, dy, w1, b1, w2, b2, activation, rate,
                                    99)
    again = ffn.ffn_backward_kernel(x, dy, w1, b1, w2, b2, activation, rate,
                                    99)
    assert all(torch.equal(p, q) for p, q in zip(first, again))


def _postnorm_tiny():
    cfg = conformer_ctc_aed(tiny=True, vocab_size=30)
    cfg["encoder"] = "transformer"
    cfg["encoder_conf"].update(normalize_before=False,
                               pos_enc_layer_type="abs_pos")
    cfg["decoder_conf"]["normalize_before"] = False
    return cfg


@pytest.mark.parametrize("model", ["lnmm_flagship", "postnorm"])
def test_tiny_k6_k7_paths_training_step_on_card_matches_cpu(model,
                                                            monkeypatch):
    """One fp32 gradient step, dropout 0, card against CPU: the tiny
    flagship with LNMM_PALLAS=1 (K7 at 2 + 2 encoder sites and 1 + 1
    decoder self-attentions, each way) and the tiny post-norm transformer
    CTC/AED (K6 at 2 + 1 FFNs each way, K1 never): every loss term within
    1e-4 and every gradient within 1e-3 relative Frobenius."""
    if model == "postnorm":
        cfg = _postnorm_tiny()
        want = {"k6": (3, 3), "k7": (0, 0), "k1": (0, 0)}
    else:
        monkeypatch.setenv("LNMM_PALLAS", "1")
        cfg = conformer_rnnt_bias(tiny=True, vocab_size=30)
        cfg["predictor_conf"].update(embed_dropout=0.0, dropout=0.0)
        want = {"k6": (0, 0), "k7": (6, 6), "k1": (6, 6)}
    for conf in (cfg["encoder_conf"], cfg["decoder_conf"]):
        for k in list(conf) + ["positional_dropout_rate"]:
            if k.endswith("dropout_rate"):
                conf[k] = 0.0
    card, cpu = init_model(cfg, seed=5), init_model(cfg, device="cpu",
                                                    seed=5)
    rng = np.random.default_rng(2)
    batch = {"feats": rng.standard_normal((4, 64, 80)).astype(np.float32),
             "feat_lengths": np.array([64, 50, 33, 20]),
             "labels": rng.integers(1, 28, (4, 6)),
             "label_lengths": np.array([6, 3, 0, 5])}
    if model != "postnorm":
        batch.update(context_list=np.array([[0, -1], [3, 4], [7, -1]]),
                     context_lengths=np.array([1, 2, 1]),
                     hw_labels=rng.integers(0, 2, (4, 6)))
    counters = {"k6": ffn.ffn_fused, "k7": ln_matmul.ln_matmul,
                "k1": ffn.ln_ffn_residual}
    before = {k: (c.launches, c.bwd_launches) for k, c in counters.items()}
    results = []
    for m, dev in ((card, "cuda"), (cpu, "cpu")):
        results.append(train.make_grad_fn(m)(
            train.TrainState(0, m, None),
            {k: torch.as_tensor(v, device=dev) for k, v in batch.items()},
            torch.Generator()))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert {k: (c.launches - before[k][0],
                        c.bwd_launches - before[k][1])
                    for k, c in counters.items()} == want
    (g_card, m_card), (g_cpu, m_cpu) = results
    for k in m_cpu:
        assert abs(float(m_card[k]) - float(m_cpu[k])) <= \
            1e-4 * abs(float(m_cpu[k])) + 1e-6, k
    for a, b in zip(g_card, g_cpu):
        assert float((a.cpu() - b).norm()) <= 1e-3 * float(b.norm()) + 1e-7


def zero_in_exact_arithmetic(name: str) -> bool:
    """A key projection's bias: softmax ignores a shift shared by all
    keys, so its exact gradient is 0 and a computed one is rounding
    noise."""
    return name.endswith("linear_k.bias")


def grad_errors(grads, ref, names):
    """{name: ||g - ref|| / scale} per parameter, the scale floored at
    1e-6 of the reference's global norm (so that a gradient whose exact
    value is 0 has a finite error: its absolute error over 1e-6 of the
    global norm)."""
    gnorm = float(torch.sqrt(sum((r.double() ** 2).sum() for r in ref)))
    return {n: float((g.double() - r.double()).norm())
            / max(float(r.double().norm()), 1e-6 * gnorm)
            for n, g, r in zip(names, grads, ref)}


def float64_step(model, batch):
    """One gradient step of a float64 copy of ``model`` on the CPU →
    (gradients, metrics): the port's CPU path, every normalisation and
    loss in float64 too."""
    m64 = copy.deepcopy(model).double()
    b64 = dict(batch, feats=batch["feats"].double())
    return train.make_grad_fn(m64)(train.TrainState(0, m64, None), b64,
                                   torch.Generator())


def test_tiny_postnorm_card_gradients_against_float64_reference():
    """The tiny post-norm transformer CTC/AED, dropout 0, one fp32 step on
    the card and on the CPU, each held to the port's CPU path in float64:
    every gradient's error on the card (relative Frobenius) at most twice
    the CPU's plus 1e-6; the key projections' biases, whose exact gradient
    is 0, within 1e-6 of the global norm on both."""
    cfg = _postnorm_tiny()
    for conf in (cfg["encoder_conf"], cfg["decoder_conf"]):
        for k in list(conf) + ["positional_dropout_rate"]:
            if k.endswith("dropout_rate"):
                conf[k] = 0.0
    card, cpu = init_model(cfg, seed=5), init_model(cfg, device="cpu",
                                                    seed=5)
    rng = np.random.default_rng(2)
    batch = {"feats": torch.as_tensor(
                 rng.standard_normal((4, 64, 80)).astype(np.float32)),
             "feat_lengths": torch.tensor([64, 50, 33, 20]),
             "labels": torch.as_tensor(rng.integers(1, 28, (4, 6))),
             "label_lengths": torch.tensor([6, 3, 0, 5])}
    g_card, _ = train.make_grad_fn(card)(
        train.TrainState(0, card, None),
        {k: v.cuda() for k, v in batch.items()}, torch.Generator())
    torch.cuda.synchronize()
    g_cpu, _ = train.make_grad_fn(cpu)(train.TrainState(0, cpu, None),
                                       batch, torch.Generator())
    ref, _ = float64_step(cpu, batch)
    names = [n for n, _ in cpu.named_parameters()]
    e_card = grad_errors([g.cpu() for g in g_card], ref, names)
    e_cpu = grad_errors(g_cpu, ref, names)
    bad = {n: (e_card[n], e_cpu[n]) for n in names
           if (max(e_card[n], e_cpu[n]) > 1.0
               if zero_in_exact_arithmetic(n)
               else e_card[n] > 2 * e_cpu[n] + 1e-6)}
    assert not bad


def test_conv_block_bf16_refuses_other_shapes_on_card():
    """A bf16 width or kernel size outside (256, 15) raises before any
    launch on CUDA tensors too, forward and backward."""
    args, mask, dy = _conv_args(2, 40, 128, 15, torch.bfloat16, 3)
    before = (conv.conv_block_residual.launches,
              conv.conv_block_residual.bwd_launches)
    with pytest.raises(ValueError, match="bf16 kernels take"):
        conv.forward_kernel(args[0], mask, *args[1:], 0, False, 0.0, 1e-5)
    with pytest.raises(ValueError, match="bf16 kernels take"):
        conv.backward_kernel(args[0], mask, *args[1:], dy, 0, False, 0.0,
                             1e-5)
    assert (conv.conv_block_residual.launches,
            conv.conv_block_residual.bwd_launches) == before


@pytest.mark.parametrize("ragged", [False, True])
def test_simple_loss_through_the_lattice_kernel_on_card(ragged):
    """rnnt_loss_simple (the pruned loss's first half) with its lattice
    through K9, one launch, against autograd through the plain alpha_scan
    on the same card tensors: the loss within 1e-5 relative, the am and
    lm gradients within 1e-3 relative Frobenius; the ranges of
    rnnt_loss_simple_and_ranges equal to get_rnnt_prune_ranges'."""
    g = torch.Generator().manual_seed(86)
    b, t, u1, v = 8, 43, 17, 300
    am = (2 * torch.randn(b, t, v, generator=g)).cuda().requires_grad_()
    lm = (2 * torch.randn(b, u1, v, generator=g)).cuda().requires_grad_()
    labels = torch.randint(1, v, (b, u1 - 1), generator=g).cuda()
    il, ll = torch.full((b,), t).cuda(), torch.full((b,), u1 - 1).cuda()
    if ragged:
        il = torch.randint(1, t + 1, (b,), generator=g).cuda()
        ll = torch.randint(0, u1, (b,), generator=g).cuda()
    before = rnnt_loss.alpha_beta.launches
    loss, ranges = rnnt_loss.rnnt_loss_simple_and_ranges(am, lm, labels, il,
                                                         ll, 5)
    got = torch.autograd.grad(loss.sum(), (am, lm))
    assert rnnt_loss.alpha_beta.launches == before + 1
    blank, emit = rnnt_loss.factored_planes(am, lm, labels, 0)
    alpha = rnnt_loss.alpha_scan(blank, emit)
    rows = torch.arange(b).cuda()
    ref = -(alpha[rows, il - 1, ll] + blank[rows, il - 1, ll])
    want = torch.autograd.grad(ref.sum(), (am, lm))
    assert float(((loss - ref).abs() / ref.abs()).max()) <= 1e-5
    for a, r in zip(got, want):
        assert float((a - r).norm()) <= 1e-3 * float(r.norm())
    assert torch.equal(ranges, rnnt_loss.get_rnnt_prune_ranges(
        am.detach(), lm.detach(), labels, il, ll, 5))


@pytest.mark.parametrize("n,f", [(8 * 5, 1024), (10, 512)])
def test_k1_at_the_context_towers_shapes_on_card(n, f):
    """K1 in fp32 at the transformer extractor's (F = 1024 over 8 phrases
    of 4 tokens and a CLS) and the transformer bias encoder's (F = 512
    over 10 phrase slots) rows, D = 256, relu: forward and every gradient
    against autograd through the plain version."""
    g = torch.Generator().manual_seed(n)
    d = 256

    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + torch.randn(*shape, generator=g) * std).cuda()
    args = [rnd(n, d), rnd(d, std=0.1, mean=1.0), rnd(d, std=0.1),
            rnd(f, d, std=d ** -0.5), rnd(f, std=0.1),
            rnd(d, f, std=f ** -0.5), rnd(d, std=0.1)]
    dy = rnd(n, d)
    ins = [a.requires_grad_() for a in args]
    y = ffn.ln_ffn_residual(*ins, "relu")
    got = torch.autograd.grad(y, ins, dy)
    ref_ins = [a.detach().clone().requires_grad_() for a in args]
    ref = ffn.ln_ffn_residual_ref(*ref_ins, "relu")
    want = torch.autograd.grad(ref, ref_ins, dy)
    assert float((y - ref).abs().max()) <= 1e-4
    for a, r in zip(got, want):
        assert float((a - r).norm()) <= 1e-4 * float(r.norm()) + 1e-6
