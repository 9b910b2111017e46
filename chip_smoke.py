#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (an H100).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. env    torch and CUDA versions, the card's name and power limit;
  2. build  every hand-written kernel, one nvcc per source, all at once;
  3. k1     ln_ffn_residual against its plain PyTorch version on the card
            (fp32 and bf16, main-path and ragged shapes), with its time,
            the plain version's, two torch.addmm GEMMs as a yardstick and
            the card's bound for the same work;
  4. slice  the flagship (conformer_rnnt_bias, full width, seeded random
            weights) decodes the 16 committed test-clean WAVs through
            init_model → Decoder.rnnt_greedy_search: no context, and 8
            hotwords with the gate "on" and "off". The same model in fp32
            on the CPU (plain versions) must give identical tokens and
            gates, except where the CPU run's top-2 logit gap at that step
            is under 1e-3; the kernel's launch count must be 24 per
            encoder pass;
  5. bench  bf16 decode at the bench shape (B=64, T=512): audio-s/s of the
            plain and gated greedy decode, encoder ms, peak memory, at two
            blank biases (see SLICE_BLANK_BIAS); then each decode once
            under torch.profiler (phase "profile"): the card's busy time,
            idle share and top kernels.
Then the card's name and power limit, the kernels' JSON record, and last
{"ok": true, "device": {...}}. Any failed check exits non-zero without it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WAV_DIR = ROOT / "examples" / "librispeech" / "data_hw" / "test-clean" / "wavs"
# Added to the joint's blank logit. bench.py adds 4.0 so that a random
# model emits at a trained model's rate; on this port's random model 4.0
# leaves nearly every frame blank, and 2.5 or less makes every frame emit
# n_steps tokens. The WAV check uses 3.0, which emits on some frames and
# not others; the bench runs both.
SLICE_BLANK_BIAS = 3.0
BENCH_BLANK_BIASES = (4.0, 3.0)
NEAR_TIE = 1e-3
K1_PER_ENCODER_PASS = 24  # 12 blocks x 2 macaron FFN halves

failures: list = []


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        failures.append(what)
        print(f"CHECK FAILED: {what}", file=sys.stderr, flush=True)


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_k1(ffn, bounds) -> dict:
    """K1 against its plain version; returns its record at the main-path
    shape in bf16, the card's operating point."""
    g = torch.Generator().manual_seed(0)
    d, f = 256, 2048
    record = {}
    for n, act, scale in ((64 * 127, "swish", 0.5), (1000, "relu", 1.0)):
        for dtype in (torch.float32, torch.bfloat16):
            def rnd(*shape, std=1.0):
                return (torch.randn(*shape, generator=g) * std).cuda()
            x = rnd(n, d).to(dtype)
            gam, bet = 1.0 + rnd(d, std=0.1), rnd(d, std=0.1)
            w1 = rnd(f, d, std=d ** -0.5).to(dtype)
            w2 = rnd(d, f, std=f ** -0.5).to(dtype)
            b1, b2 = rnd(f, std=0.1), rnd(d, std=0.1)
            args = (x, gam, bet, w1, b1, w2, b2, act, scale)
            y = ffn.ln_ffn_residual(*args)
            torch.cuda.synchronize()
            ref = ffn.ln_ffn_residual_ref(*args)
            err = (y.float() - ref.float())
            max_abs = float(err.abs().max())
            if dtype == torch.float32:
                ok = bool((err.abs() <= 1e-4 + 1e-4 * ref.abs()).all())
                tol = "max abs <= 1e-4 + 1e-4*|ref|"
            else:
                ok = float(err.norm() / ref.float().norm()) <= 1e-2
                tol = "relative Frobenius <= 1e-2 vs bf16 plain version"
            check(ok and bool(torch.isfinite(y).all()),
                  f"k1 n={n} {act} {dtype} disagrees with its plain version")
            line = {"n": n, "d": d, "f": f, "activation": act,
                    "ff_scale": scale, "dtype": str(dtype).split(".")[-1],
                    "max_abs_err": max_abs,
                    "rel_fro_err": float(err.norm() / ref.float().norm()),
                    "tolerance": tol, "ok": ok}
            if n == 64 * 127:
                ms = cuda_ms(lambda: ffn.ln_ffn_residual(*args))
                plain_ms = cuda_ms(lambda: ffn.ln_ffn_residual_ref(*args))
                b1c, b2c = b1.to(dtype), b2.to(dtype)
                library_ms = cuda_ms(lambda: torch.addmm(
                    b2c, torch.addmm(b1c, x, w1.t()), w2.t()))
                # The least time for this work on an H100 SXM at 700 W
                # (data-sheet peaks; ops/bounds.py).
                dt = "bf16" if dtype == torch.bfloat16 else "fp32"
                flops, nbytes = bounds.ln_ffn_residual(n, d, f, dt)
                bound_ms, bound_by = bounds.bound_ms(flops, nbytes, dt)
                line.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            library="two torch.addmm GEMMs, no LN/act",
                            bound_ms=bound_ms, bound_by=bound_by,
                            flops=flops, bytes=nbytes,
                            share_of_bound=bound_ms / ms)
                if dtype == torch.bfloat16:
                    record = {"max_abs_err": max_abs, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by,
                              "library_ms": library_ms}
            emit("k1", **line)
    return record


def load_wavs():
    from wenet_celoss_tpu_torch.data.wav import read_wav
    from wenet_celoss_tpu_torch.ops.fbank import compute_fbank_np
    paths = sorted(WAV_DIR.glob("*.wav"))
    feats = []
    for p in paths:
        wav, sr = read_wav(str(p))
        if sr != 16000:
            raise ValueError(f"{p}: sample rate {sr}")
        feats.append(compute_fbank_np(wav))
    lens = np.array([len(x) for x in feats], np.int64)
    batch = np.zeros((len(feats), lens.max(), 80), np.float32)
    for i, x in enumerate(feats):
        batch[i, :len(x)] = x
    return [p.name for p in paths], batch, lens


def hotwords(vocab: int, n: int = 8, length: int = 4, seed: int = 0):
    """Row 0 is the no-bias sentinel [0]; rows are padded with -1."""
    rng = np.random.default_rng(seed)
    ctx = np.full((n + 1, length), -1, np.int64)
    ctx[0, 0] = 0
    ctx[1:] = rng.integers(1, vocab - 2, (n, length))
    lens = np.full((n + 1,), length, np.int64)
    lens[0] = 1
    return ctx, lens


def with_blank_bias(model, bias: float):
    with torch.no_grad():
        model.joint.ffn_out.bias[model.blank] += bias
    return model


MODES = {"plain": {}, "gated_on": {"context_filter_state": "on"},
         "gated_off": {"context_filter_state": "off"}}


def decode(dec, feats, lens, ctx, ctx_lens, mode, trace=None):
    kw = dict(MODES[mode])
    if kw:
        kw.update(context_list=ctx, context_lengths=ctx_lens)
    hyps = dec.rnnt_greedy_search(feats, lens, n_steps=4, trace=trace,
                                  **kw)
    gates = None
    if kw:
        g = dec.last_gates[0].cpu().numpy()
        gates = [[int(v) for v in g[i, :len(h)]] for i, h in enumerate(hyps)]
    return hyps, gates


def compare(card, cpu, trace):
    """Card vs CPU tokens and gates per utterance. A difference is allowed
    only at a step where the CPU run's top-2 gap was under NEAR_TIE; the
    rest of that utterance is then not compared."""
    (c_hyps, c_gates), (r_hyps, r_gates) = card, cpu
    same, ties, bad = 0, [], []
    for i, (a, b) in enumerate(zip(c_hyps, r_hyps)):
        ga = c_gates[i] if c_gates else [0] * len(a)
        gb = r_gates[i] if r_gates else [0] * len(b)
        pairs_a, pairs_b = list(zip(a, ga)), list(zip(b, gb))
        if pairs_a == pairs_b:
            same += 1
            continue
        u = next((j for j, (p, q) in enumerate(zip(pairs_a, pairs_b))
                  if p != q), min(len(a), len(b)))
        gap = float(trace[u][i]) if u < len(trace) else float("inf")
        (ties if gap < NEAR_TIE else bad).append(
            {"utt": i, "step": u, "cpu_top2_gap": gap})
    return same, ties, bad


def phase_slice(init_model, Decoder, conformer_rnnt_bias, ffn) -> int:
    """Full-width fp32 decode of the committed WAVs on the card, held
    against the same model on the CPU. Returns the kernel launches of the
    main path."""
    cfg = conformer_rnnt_bias()
    names, feats, lens = load_wavs()
    check(len(names) == 16, f"slice: {len(names)} WAVs in {WAV_DIR}, want 16")
    ctx, ctx_lens = hotwords(cfg["output_dim"])
    model = with_blank_bias(init_model(cfg, seed=0), SLICE_BLANK_BIAS)
    dec = Decoder(model)
    card, launches = {}, {}
    ffn.ln_ffn_residual.launches = 0          # the main path starts here
    t0 = time.perf_counter()
    for mode in MODES:
        before = ffn.ln_ffn_residual.launches
        card[mode] = decode(dec, feats, lens, ctx, ctx_lens, mode)
        launches[mode] = ffn.ln_ffn_residual.launches - before
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    total = ffn.ln_ffn_residual.launches      # ... and ends here
    for mode, n in launches.items():
        passes = 1 if mode == "plain" else 2
        check(n == passes * K1_PER_ENCODER_PASS,
              f"slice {mode}: {n} K1 launches, want "
              f"{passes * K1_PER_ENCODER_PASS}")

    torch.set_num_threads(os.cpu_count() or 1)
    cpu_model = init_model(cfg, device="cpu", seed=0)
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    cpu_dec = Decoder(cpu_model, device="cpu")
    with torch.no_grad():
        enc_card, _, _, mask = model.encode_transducer(
            torch.as_tensor(feats, device="cuda"),
            torch.as_tensor(lens, device="cuda"))
        enc_cpu, _, _, _ = cpu_model.encode_transducer(
            torch.as_tensor(feats), torch.as_tensor(lens))
    mask = mask.cpu()
    enc_err = float((enc_card.cpu() - enc_cpu)[mask].abs().max())
    check(enc_err <= 1e-3, f"slice encoder card vs CPU max abs {enc_err}")
    for mode in MODES:
        trace: list = []
        cpu = decode(cpu_dec, feats, lens, ctx, ctx_lens, mode, trace)
        same, ties, bad = compare(card[mode], cpu, trace)
        check(not bad, f"slice {mode}: card and CPU differ away from a "
                       f"near tie: {bad}")
        check(any(card[mode][0]), f"slice {mode}: no token emitted")
        gates = card[mode][1]
        emit("slice", mode=mode, utterances=len(names),
             tokens=sum(map(len, card[mode][0])),
             gate_on_share=(float(np.mean(np.concatenate(gates)))
                            if gates and any(gates) else None),
             identical_to_cpu=same, near_tie_flips=ties, other_diffs=bad,
             min_cpu_top2_gap=float(torch.stack(trace).min()),
             k1_launches=launches[mode], encoder_max_abs_vs_cpu=enc_err)
    emit("slice", mode="all", wavs=str(WAV_DIR.relative_to(ROOT)),
         blank_bias=SLICE_BLANK_BIAS, audio_s=float(lens.sum() * 0.01),
         card_decode_s=seconds,
         k1_launches=total, first_hyp=card["gated_on"][0][0][:12])
    return total


def device_busy(prof):
    """The card's busy time (union of its kernel and copy intervals, ms)
    and the ms per kernel name, from a profiler run."""
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e3, by_name


def phase_profile(dec, feats, lens, ctx, ctx_lens, mode: str,
                  blank_bias: float, timed_ms: float) -> None:
    """One decode under torch.profiler: the card's busy time, its idle
    share of the unprofiled time ``timed_ms`` (the profiler slows the
    host) and of the profiled wall time, K1's time, and the kernels that
    take the most. Run after every timing: the profiler slows what
    follows it in the process."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode(dec, feats, lens, ctx, ctx_lens, mode)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, by_name = device_busy(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit("profile", mode=mode, blank_bias=blank_bias, timed_ms=timed_ms,
         profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
         idle_share=1.0 - busy_ms / timed_ms,
         idle_share_profiled=1.0 - busy_ms / wall_ms,
         k1_ms=sum(v for k, v in by_name.items() if "ln_ffn_fwd" in k),
         kernels=len(by_name),
         top=[{"kernel": k[:90], "ms": v} for k, v in top])


def phase_bench(init_model, Decoder, conformer_rnnt_bias, ffn,
                blank_bias: float):
    """bf16 at the bench shape; the fp32 comparison is for information.
    Returns what phase_profile needs to profile the same decodes."""
    b, t, iters = 64, 512, 5
    cfg = conformer_rnnt_bias()
    cfg["dtype"] = "bfloat16"
    rng = np.random.default_rng(0)
    feats = torch.as_tensor(rng.standard_normal((b, t, 80)),
                            dtype=torch.float32, device="cuda")
    lens = torch.full((b,), t, dtype=torch.long, device="cuda")
    ctx, ctx_lens = hotwords(cfg["output_dim"], seed=1)
    model = with_blank_bias(init_model(cfg, seed=0), blank_bias)
    dec = Decoder(model)
    audio_s = b * t * 0.01
    out = {"batch": b, "frames": t, "dtype": "bfloat16", "n_steps": 4,
           "hotwords": 8, "blank_bias": blank_bias, "iters": iters,
           "timing": "median host ms per batch, synchronised"}
    with torch.no_grad():
        enc_ms = cuda_ms(lambda: model.encode_transducer(feats, lens),
                         iters=5, warmup=1)
    out["encoder_ms"] = enc_ms
    hyps = {}
    for mode in ("plain", "gated_on"):
        hyps[mode] = decode(dec, feats, lens, ctx, ctx_lens, mode)[0]
        torch.cuda.reset_peak_memory_stats()
        before = ffn.ln_ffn_residual.launches
        times = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(dec, feats, lens, ctx, ctx_lens, mode)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        med = times[len(times) // 2]
        out[f"{mode}_audio_s_per_s"] = audio_s / (med / 1e3)
        out[f"{mode}_ms_per_batch"] = med
        out[f"{mode}_ms_min_max"] = [times[0], times[-1]]
        out[f"{mode}_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out[f"{mode}_k1_launches_per_batch"] = \
            (ffn.ln_ffn_residual.launches - before) / iters
        out[f"{mode}_tokens_per_utt"] = sum(map(len, hyps[mode])) / b
        out[f"{mode}_max_tokens_per_utt"] = max(map(len, hyps[mode]))
    cfg32 = conformer_rnnt_bias()
    ref = decode(Decoder(with_blank_bias(init_model(cfg32, seed=0),
                                         blank_bias)),
                 feats, lens, ctx, ctx_lens, "plain")[0]
    out["bf16_vs_fp32_identical_utts"] = sum(
        a == r for a, r in zip(hyps["plain"], ref))
    emit("bench", **out)
    return [(dec, feats, lens, ctx, ctx_lens, mode, blank_bias,
             out[f"{mode}_ms_per_batch"]) for mode in ("plain", "gated_on")]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from wenet_celoss_tpu_torch.configs import conformer_rnnt_bias
    from wenet_celoss_tpu_torch.decode.api import Decoder
    from wenet_celoss_tpu_torch.models.factory import init_model
    from wenet_celoss_tpu_torch.ops import _build, bounds, ffn

    name = torch.cuda.get_device_name(0)
    card = smi()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=name, count=torch.cuda.device_count(), nvidia_smi=card,
         peaks="H100 SXM data sheet at 700 W; this card: " + card)

    t0 = time.perf_counter()
    _build.build_all(["ln_ffn_residual"])
    emit("build", seconds=time.perf_counter() - t0,
         per_source=_build.build_seconds)

    k1 = phase_k1(ffn, bounds)
    launches = phase_slice(init_model, Decoder, conformer_rnnt_bias, ffn)
    to_profile = []
    for bias in BENCH_BLANK_BIASES:
        to_profile += phase_bench(init_model, Decoder, conformer_rnnt_bias,
                                  ffn, bias)
    for args in to_profile:
        phase_profile(*args)

    if failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failures),
              file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": [dict(
        name="ln_ffn_residual", route="cuda",
        source="wenet_celoss_tpu_torch/csrc/ln_ffn_residual.cu",
        replaces="wenet_celoss_tpu/ops/ffn_pallas.py:272",
        launches=launches, **k1)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
