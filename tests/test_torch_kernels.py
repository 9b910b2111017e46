"""The port's CUDA kernels on the card, against their plain PyTorch
versions and the CPU run of the same model. Every test here needs an
NVIDIA card and nvcc and skips without one. This file imports no jax, so
it also runs on the machine with the card, where jax is absent:

    python -m pytest --noconftest -o addopts="" -m gpu \\
        tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from wenet_celoss_tpu_torch.configs import conformer_rnnt_bias
from wenet_celoss_tpu_torch.decode.api import Decoder
from wenet_celoss_tpu_torch.models.factory import init_model
from wenet_celoss_tpu_torch.ops import ffn

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,activation,ff_scale",
                         [(1000, "relu", 1.0), (8128, "swish", 0.5)])
def test_kernel_matches_plain_version_on_card(dtype, n, activation,
                                              ff_scale):
    dt = getattr(torch, dtype)
    d, f = 256, 2048
    rng = np.random.default_rng(5)

    def arr(*shape, std=1.0, mean=0.0):
        return torch.as_tensor(mean + std * rng.standard_normal(shape),
                               dtype=torch.float32, device="cuda")
    x = arr(n, d).to(dt)
    g, bl = arr(d, std=0.1, mean=1.0), arr(d, std=0.1)
    w1, b1 = arr(f, d, std=d ** -0.5).to(dt), arr(f, std=0.1)
    w2, b2 = arr(d, f, std=f ** -0.5).to(dt), arr(d, std=0.1)
    before = ffn.ln_ffn_residual.launches
    got = ffn.ln_ffn_residual(x, g, bl, w1, b1, w2, b2, activation, ff_scale)
    torch.cuda.synchronize()
    assert ffn.ln_ffn_residual.launches == before + 1
    want = ffn.ln_ffn_residual_ref(x, g, bl, w1, b1, w2, b2, activation,
                                   ff_scale)
    err = got.float() - want.float()
    if dt == torch.float32:
        assert bool((err.abs() <= 1e-4 + 1e-4 * want.abs()).all())
    else:
        assert float(err.norm() / want.float().norm()) <= 1e-2


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
