#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (an H100).

    python3 chip_smoke.py

Phases, each printing JSON lines, in the order below, except that the
untimed card-against-CPU checks run beside processes that would leave
this one waiting: decode_modes, stream_slice, tools' A1, L1 and LM1 and
the training checks T0-check to BN-check run while serve_runs' processes
and E1's int8 export do (``checks``); recognize, train_cli_check and
train_resume while the D ranks do (``beside_d``); and F1 follows the
serving runs:
  env       torch and CUDA versions, the card's name and power limit;
  build     every hand-written kernel, one nvcc per source, all at once,
            and beside them decoder_main from runtime/core with g++ (one
            process a source, then the link; no CMake); then S3's CPU side
            starts in a process of its own (s3_setup: the recognize CLI's
            runs with --device cpu, read by the recognize phase), and the
            CPU references in another (refs_setup, refs_child: the CPU
            side of every other card-against-CPU phase, S1's decodes to
            V3's step, each read by its phase as it is done);
  k1, k1_bwd  ln_ffn_residual forward and backward with dropout 0 and
            0.1 against its plain version (fp32, bf16, main-path and
            ragged shapes; the same bits on a second call), the weight
            pass on ragged splits (same bits every call), both masks' bits
            and keep rates in fp32 and bf16 (every hidden column), times,
            yardsticks and bounds (also at one streaming chunk's rows, N =
            16 and 1024, swish); the bf16 forward at N = 8128 and 32512
            beside two addmm in card time, under both of its schedules;
            the bf16 backward and its five-mm yardstick also in card time
            with the calls back to back, the backward split into pass A,
            pass B and the partial sums under torch.profiler;
  k2_k3, k4 the streaming joint's and the 2-layer LSTM's kernels the same
            way (same bits over repeated calls; K2/K3 also at H=512 on a
            ragged N and with blank and labels on V - 1; K4 in bf16 at H
            64, 128 and 256, B ragged against its 64-row clusters, U1 = 1,
            its mask equal to the plain one); K2, K3 and their chunked
            cuBLAS yardsticks (also with W padded to V = 5008) in card
            time, K3 split by pass, its workspace bytes; K4 and cuDNN's
            LSTM in card time at B = 256 and 64, each direction split by
            stage;
  k9        the RNN-T lattice against alpha_scan/beta_scan (B=256 T'=127
            U1=33 full and ragged, the pallas path's B=64, a wide U1=90,
            U1=600 full and ragged on ten warps a direction):
            valid cells, invalid cells exactly LOG_ZERO, beta[0,0] against
            the terminal alpha, the same bits over 3 calls; its card
            time, µs a diagonal step, its bound;
  k8        the fused conv block, forward (N=64*127) and backward
            (N=256*127), D=256 K=15, fp32/bf16, causal or not, dropout 0
            and 0.1, against the plain version, and bf16 at T = 300 and
            256 (across the kernels' 128-frame steps); the mask's bits and
            keep rate; times beside the port's unfused block;
  k7        ln_matmul forward and backward against its plain version at
            the main paths' shapes (N = 8128, 32512, 8448; K = 768 QKV and
            512 pointwise conv1 with a row mask; a ragged N), fp32 and
            bf16: masked rows the bias, the same bits over 3 backwards;
            the bf16 forward at N = 8128 and 32512 (K = 768) in card time
            under each schedule it keeps (1 or 2 column groups);
  k6        ffn_fused (the post-norm FFN, K1's kernels without LN and
            residual) the same way, relu and swish, dropout 0 and 0.1; the
            mask's bits (every hidden column) and keep rate in fp32 and
            bf16; the bf16 backward split by pass;
  row_base  K1/K6, K4 and K8 as the second of two ranks calls them (a
            nonzero global row base, K4 also the whole batch; D1's fp32
            and D2's bf16 rows): every forward mask bit-equal to the plain
            mask at the global indices, the backwards against autograd
            through the plain version at the same base and away from it
            at the rank's local indices;
  slice     S1: the flagship (full width, seeded random weights) decodes
            the 16 committed test-clean WAVs through init_model →
            Decoder.rnnt_greedy_search, no context and 8 hotwords gated
            "on" and "off"; tokens and gates identical to the CPU fp32 run
            except where its top-2 logit gap is under 1e-3; 24 K1 launches
            an encoder pass;
  conv_decode  S1 with CONV_PALLAS=1 against the same CPU run, 12 K8
            launches an encoder pass;
  lnmm_decode  S1-lnmm: S1 with LNMM_PALLAS=1 against the same CPU run,
            24 K7 launches an encoder pass; then with CONV_PALLAS=1 too
            (K8 first: 12 K7, 12 K8);
  bench     B1/B2: bf16 decode at B=64, T=512, two blank biases;
  bench_lnmm  B1-lnmm: B1 with LNMM_PALLAS unset and set in turns;
  op_dispatch  B1 plain and S1 plain through the registered forward
            operators and through the autograd.Function route they
            replaced, in turns; K1 at N = 16 called back to back by both
            routes and by the bare launch (µs a call);
  decode_modes  S1 for the CTC greedy, CTC prefix beam, attention beam,
            attention rescoring, RNN-T beam (plain and with the 8
            hotwords) and both transducer/attention rescorings (non-zero
            weights): top-1 tokens identical to the CPU fp32 run except
            where the CPU's score gap between the two hypotheses is under
            1e-3 (CTC greedy: its frames' top-2 log-prob gap); the prefix
            beam's best score and emission times; each mode's launches;
  stream_slice  S2: the full-width U2++ conformer (fp32, seeded) decodes
            the same WAVs chunk by chunk (chunk 16, 4 left chunks) through
            CTC greedy and attention rescoring, card against CPU by S1's
            flip rules, 24 K1 launches a chunk (the stream_decode path);
            U2's contract: with static_chunk_size 16 the streamed encoder
            output equals the chunk-masked full forward (1e-4);
  serve_u2pp  R1: the full-width U2++ conformer (fp32, chunk 16, 4 left)
            behind the worker of bin/runtime_worker.py: a protocol client
            streams the 16 WAVs as one stream through the card worker and
            the --device cpu worker (each O reply and one R compared), the
            F round trips and start-up; an in-process worker's launches
            (24 K1 a chunk, N = 16) and one chunk under torch.profiler,
            fp32 and bf16;
  serve_rnnt  R2: the flagship (fp32, blank bias +3.0; the chunk-masked
            prefix) the same way on the card: F, G, B and R round trips,
            tokens an encoder frame, 24 K1 an F, the flush profiled;
  serve_runs  decoder_main (built above) over the 16 WAVs, card worker
            against CPU worker, equal result lines: R1 default (CTC
            prefix beam and attention rescoring), R2 rnnt_greedy_search,
            rnnt_beam_search (beam 4) and default; W1: decoder_main in
            WFST mode (--fst_path, an LG from bin.build_lg over R1's units
            and the transcripts' words and unigram ARPA) with R1's card
            worker, its K1 launches counted in the worker; and
            bin/export.py on the card on R1's configuration at 3 + 1 + 1
            blocks (E1_DEPTH), fp32 and --quantize int8; all at once;
  export    E1: each .pt2 loaded back and run on the card against the live
            model's entry point, its K1 operator nodes counted (6, 6, 2:
            two a block), the bundle sizes and the int8 / fp32 ratio;
  tools (w1)  W1's 16 lines against the port's wfst_beam_decode over the
            log-probs the tee recorded (the same beam and scales, its
            n-best ranked by the attention scores decoder_main got);
  bench_modes  B3: bench.py's decode keys ctc_greedy,
            attention_rescoring, rnnt_beam, ctc_beam_td_attn_rescoring
            (beams 10, 5, 10) and attention (beam 10) at B1's shape and
            blank bias, timed; their launches a batch (K1; K2, K4 and K9
            in transducer_score);
  bench_stream  B4: bench.py's streaming key, the U2++ model at vocab
            1024, bf16, B=64 × 512 frames, 7 chunks, 168 K1 launches a
            batch, timed;
  tools     A1: the alignment CLI (bin/alignment.main, --gen_praat) on
            S3's files on the card against --device cpu: ali.txt and the
            16 TextGrids; L1: the label checker CLI on the same model,
            wav.scp and text, result and timestamps; a file may differ
            only at an utterance whose search margin on the CPU is
            provably under NEAR_TIE, the search redone on the card's
            log-probs giving the card's line; LM1: S1's CTC prefix-beam
            n-best, card and CPU, rescored by lm_rescore_nbest with the
            transcripts' ARPA, the same orders; F1: the batched fbank and
            MFCC on the card over the 16 WAVs and at B = 64 x 512 frames
            against the numpy path (fbank_close, mfcc_close), ms a batch
            beside the host path's; K1 launches counted on A1, L1, LM1;
  recognize S3 (after the training phases below): the port's CLI (bin/recognize.main, in process) with S1's
            model saved as a .pt, its config written by save_config, a
            symbol table and a data.list of the 16 WAVs: all 8 modes with
            S1's 8 hotwords (context mode 2) under "off",
            rnnt_greedy_search (the one mode that reads the gating state)
            under "on" and "exact", then mode 3 under "exact" (the
            .gate_dist sidecar, which must differ only by a near tie),
            each once on the card and once with --device cpu (the CPU
            runs in the process s3_setup started); each mode's
            lines equal, or a flip under S1's rule (the first differing
            decision's CPU top-2 gap, or the n-best score gap, under
            1e-3); the backtracks of both runs; K1, K2, K4 and K9
            launches against s3_want; read_audio on a FLAC (the decoder
            built with this machine's g++);
  d1, d2, d3, d4, dist  scale-out over two rank processes (both on cuda:0
            over gloo on a one-card machine: the code path, not a
            speed-up; one started pair runs all four, ``dist_ranks``):
            D1 the full-width batch_norm flagship, fp32, dropout 0.1, T3's
            16 WAVs split 8 + 8, one step over the group against the
            one-process card step on the whole batch (loss terms, T3's
            gradient bounds, running statistics; the ranks bit for bit
            after Adam; K1, K2, K3, K4 and K9 a rank as one step's), again
            over nccl with one rank a card where there are two cards; D2
            T4's bf16 point split 128 + 128, ms a step on each rank, the
            gradient all-reduce's ms, the card's idle share; D3 the
            recognize CLI with --sharded on S3's inputs in three modes,
            byte-equal to S3's card files, rank 1 writing nothing; D4 the
            train CLI with --distributed on the first 96 of T12's train
            WAVs for one epoch (accum_grad 1): both ranks stop at the
            same joined batch count, bit for bit equal, launches as
            derived, only rank 0 writes;
  train_check, train, train_wavs  T0-T2: conformer_ctc_aed, one fp32 step
            card against CPU, bf16 steps at B=256 T=512 U=32 timed, 12
            steps on the committed train-clean-100 WAVs (the loss falls);
  postnorm_train_check  T9-check: T0 for the post-norm transformer
            CTC/AED (18 + 18 K6 launches, no K1), each limit at least
            twice the CPU's own difference between 8 and 3 threads, and
            every gradient's error on the card against the port's CPU step
            in float64 at most twice the CPU's fp32 error plus 1e-6;
  u2pp_train_check  T11-check: T0 for the U2++ conformer with its
            dynamic chunk drawn from the same seeded generator on both
            (the first seed that draws a chunk, not the full context);
  rnnt_train_check, rnnt_pallas_train_check, conv_train_check,
  lnmm_train_check, bn_train_check  one fp32 step of the flagship with
            hotwords, card against CPU: the streaming loss (K2, K9, K3),
            rnnt_impl pallas (character vocabulary), CONV_PALLAS=1,
            LNMM_PALLAS=1 (T8-check), the batch_norm conv module (BN-check,
            its running statistics after the step too);
  rnnt_train, conv_train, lnmm_train, bn_train, rnnt_pallas_train  T4,
            T7, T8, T10, T6: the flagship in bf16 with dropout 0.1 timed
            (B=256; B=64 for pallas, whose [B, T', U+1, V] logits
            materialise), launches per step (T10: batch_norm, K8 0);
  v_kernels  K1 in fp32 at the context towers' shapes (the transformer
            extractor's F = 1024 over 8 phrases x 5 rows, the transformer
            bias encoder's F = 512 over 10 slots), forward and backward,
            and K9 under rnnt_loss_simple at V1's step shape (B=64,
            T'=86, U1=33, V=5002), the loss and the am and lm gradients,
            against their plain versions on the card; the pruned
            lattice's ms and card intervals at V1's shape;
  v1, v2, v3  the model variants of the JAX factory at the flagship's
            widths (VARIANTS): V1 conv2d6 + rel_pos, transformer
            extractor and bias encoder, embedding predictor, "pruned",
            concat_after decoder; V2 the transformer encoder with conv2d8,
            no_pos and concat_after, the LSTM extractor, a GRU predictor;
            V3 a linear front end with abs_pos, the conv predictor. Each:
            one fp32 step on 4 of S1's WAVs (word labels, hotwords),
            card against CPU with T3's bounds; the gated greedy and the
            RNN-T beam over S1's 16 WAVs, card against CPU by S1's rules;
            two bf16 steps at B=64 x 512 frames (V3 256), the second
            timed; every step's launches against variant_want;
  postnorm_train  T9: the post-norm model at T1's point, timed;
  u2pp_train, u2pp_conv_train  T11, T11-conv: the U2++ conformer at T1's
            point with its dynamic chunk, and under CONV_PALLAS=1 (K8
            causal, 12 + 12 a step), timed;
  rnnt_train_wavs, bn_train_wavs  T5 and T10's curve: 12 flagship steps
            on the WAVs (the loss falls);
  train_cli  T12: the train CLI (bin/train.main, in process) on the yaml
            flagship as it stands plus two loader processes and a record a
            batch: the 200 train-clean-100 WAVs, cv on the 16 dev-clean
            WAVs, --cmvn from compute_cmvn_stats, 1 epoch, a step file
            every step, --profile_dir: its epoch files, infos, links,
            train.yaml, records and rnnt_impl ("scan"), its launches
            against the counts derived from its batches (K1 30 + 30 and K4
            1 + 1 a micro-batch, K1 30 and K4 1 a cv batch, no other);
            average_model --num 1 and the recognize CLI on the average;
            seconds an epoch, audio-s/s, the loader's start-up, the card's
            busy time and idle share over epoch 0 from the trace;
  train_cli_check  T12-check: the CLI on the card and with --device cpu,
            16 WAVs, fp32, dropout 0, accum_grad 1, 1 epoch: records and
            cv loss 1e-4, parameters 1e-3, running statistics 1e-4;
  train_resume  T12-resume: the yaml flagship (bf16, dropout 0.1), 4
            batches of 8 through the Executor: a run resumed from its
            step_2.state in a model of another seed against the
            uninterrupted run and two repeats of it;
  exact_bench  B5: bf16, B=16 × 512 random frames, blank bias +3.0, 8
            hotwords: "on" (median of 3) against "exact" on the first two
            utterances, ms an utterance, the search loop's host reads an
            utterance, the card's busy ms and idle share of "on" from one
            profile;
  profile   each decode (B3's modes too) and training step under
            torch.profiler, last: the card's busy time, idle share and
            each kernel's time (K4's and K9's, and K7's and K8's on their
            paths, must read above 0);
            one more T4 step, ops/dropout.py's apply_mask wrapped to
            name its caller, charges its int64 element-wise kernels to
            their call sites (int64_sites);
  k8_device K8 against the port's unfused block in card time, calls back to back (CUDA events behind a spin kernel;
            the kernels line's library_ms for K8), the forward at N =
            8128 and 32512, the backward split by pass;
  k8_causal_device  K8 causal against the port's unfused causal block
            the same way: forward at N = 8128 and 32512, backward 32512;
  k6_k7_device  K6 and K7 against the port's unfused compositions the
            same way (their library_ms; K6's forward also at N = 32512).

Then the card's name and power limit, the kernels line, and the ok line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import json
import math
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

# Idle OpenMP threads sleep rather than spin, here and in every process
# started from here: S3's and the CPU references' processes, the serving
# workers and the loaders share the host's 8 cores with the phases.
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
DATA_DIR = ROOT / "examples" / "librispeech" / "data_hw"
WAV_DIR = DATA_DIR / "test-clean" / "wavs"
TRAIN_DIR = DATA_DIR / "train-clean-100"
# Added to the joint's blank logit. bench.py adds 4.0 so that a random
# model emits at a trained model's rate; on this port's random model 4.0
# leaves nearly every frame blank, and 2.5 or less makes every frame emit
# n_steps tokens. The WAV check uses 3.0, which emits on some frames and
# not others; the bench runs both.
SLICE_BLANK_BIAS = 3.0
BENCH_BLANK_BIASES = (4.0, 3.0)
NEAR_TIE = 1e-3
K1_PER_ENCODER_PASS = 24  # 12 blocks x 2 macaron FFN halves
K8_PER_ENCODER_PASS = 12  # one conv block a layer under CONV_PALLAS=1
K7_PER_ENCODER_PASS = 24  # 12 QKV + 12 pointwise conv1 under LNMM_PALLAS=1
K1_GRADS = ("y", "dx", "dg", "dbl", "dw1", "db1", "dw2", "db2")
# Kernel names of K1's and K6's forward in a profile: fp32, bf16.
FFN_FWD_KERNELS = ("ln_ffn_fwd<", "fwd16::ffn_fwd<")
# K4's forward (the cluster recurrences and the xw2 GEMM) and backward
# (the recurrences, the gd GEMM, the weight pass and its sums): bf16, fp32.
K4_FWD_KERNELS = ("lstm16::fwd_rec<", "lstm16::xw2_gemm<", "lstm2_fwd<")
K4_BWD_KERNELS = ("lstm16::bwd_rec<", "lstm16::gd_gemm<",
                  "lstm16::dw_gemm<", "lstm16::bwd_sums(", "lstm2_bwd")
# K7's forward and backward (passes A, B and the split sums): bf16, fp32.
K7_FWD_KERNELS = ("lnmm16::fwd<", "f32k::ln_mm_fwd(")
K7_BWD_KERNELS = ("lnmm16::bwd_rows<", "lnmm16::bwd_weights<",
                  "lnmm16::sum_splits(", "f32k::ln_mm_bwd_rows(",
                  "f32k::ln_mm_bwd_weights(")
# K9 (alpha and beta, every plan) in a profile.
K9_KERNELS = ("k9::lattice<",)

# K8's forward and backward in a profile: bf16 (namespace conv16: the
# cluster kernel, pass B, pass C and the sums), fp32.
K8_FWD_KERNELS = ("conv16::clu<false>", "conv_fwd<")
K8_BWD_KERNELS = ("conv16::clu<true>", "conv16::bwd_b(", "conv16::wgrad(",
                  "conv16::sum_segs(", "conv_bwd_a<", "conv_bwd_b<",
                  "namespace)::wgrad_")
# K8's bf16 backward by pass (stage_ms).
K8_BWD_STAGES = (("pass_a", ("conv16::clu<true>",), 1),
                 ("pass_b", ("conv16::bwd_b(",), 1),
                 ("pass_c", ("conv16::wgrad(",), 1),
                 ("sums", ("conv16::sum_segs(",), 1))

failures: list = []
# When the script started: every phase line carries its seconds since
# (``at_s``), so a run's lines show where its wall time went.
STARTED = time.perf_counter()


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw,
                      "at_s": time.perf_counter() - STARTED}), flush=True)


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


K1_CASES = (  # (N, activation, ff_scale, dtypes); N >= 32512 in bf16 only
    (64 * 127, "swish", 0.5, (torch.float32, torch.bfloat16)),
    (1000, "relu", 1.0, (torch.float32, torch.bfloat16)),
    (256 * 127, "swish", 0.5, (torch.bfloat16,)),
    # The attention decoder's rows in B3's n-best modes: B·beam·(L+1).
    (64 * 10 * 128, "relu", 1.0, (torch.bfloat16,)),
    # One streaming chunk's rows (16 frames): B4's 64 utterances, and one.
    (64 * 16, "swish", 0.5, (torch.float32, torch.bfloat16)),
    (16, "swish", 0.5, (torch.float32, torch.bfloat16)))
# Decode, training, and one streaming chunk of B4 (64 utterances x 16).
K1_TIMED = ((64 * 127, 0.0), (256 * 127, 0.1), (64 * 16, 0.0))


def phase_k1(ffn, bounds) -> dict:
    """K1's forward against its plain version at dropout 0 and 0.1, the
    same bits on a second call; returns its record at the main-path shape
    in bf16, the card's operating point (N = 8128, rate 0, as decode runs
    it), with the training shape's times (N = 32512, rate 0.1) under
    ``*_n32512`` keys and a streaming chunk's (N = 1024, rate 0) under
    ``*_n1024``."""
    g = torch.Generator().manual_seed(0)
    d, f = 256, 2048
    record = {}
    for n, act, scale, dtypes in K1_CASES:
        for dtype in dtypes:
            def rnd(*shape, std=1.0):
                return (torch.randn(*shape, generator=g) * std).cuda()
            x = rnd(n, d).to(dtype)
            gam, bet = 1.0 + rnd(d, std=0.1), rnd(d, std=0.1)
            w1 = rnd(f, d, std=d ** -0.5).to(dtype)
            w2 = rnd(d, f, std=f ** -0.5).to(dtype)
            b1, b2 = rnd(f, std=0.1), rnd(d, std=0.1)
            for rate in (0.0, 0.1):
                args = (x, gam, bet, w1, b1, w2, b2, act, scale, 1e-5, rate,
                        rate, 4242)
                y = ffn.ln_ffn_residual(*args)
                again = ffn.ln_ffn_residual(*args)
                torch.cuda.synchronize()
                same = torch.equal(y, again)
                ref = ffn.ln_ffn_residual_ref(*args)
                err = (y.float() - ref.float())
                max_abs = float(err.abs().max())
                if dtype == torch.float32:
                    ok = bool((err.abs() <= 1e-4 + 1e-4 * ref.abs()).all())
                    tol = "max abs <= 1e-4 + 1e-4*|ref|"
                else:
                    ok = float(err.norm() / ref.float().norm()) <= 1e-2
                    tol = "relative Frobenius <= 1e-2 vs bf16 plain version"
                ok = ok and same and bool(torch.isfinite(y).all())
                check(ok, f"k1 n={n} {act} {dtype} rate={rate} disagrees "
                          f"with its plain version (same bits {same})")
                line = {"n": n, "d": d, "f": f, "activation": act,
                        "ff_scale": scale, "rate": rate,
                        "dtype": str(dtype).split(".")[-1],
                        "max_abs_err": max_abs,
                        "rel_fro_err": float(err.norm() / ref.float().norm()),
                        "same_bits_second_call": same, "tolerance": tol,
                        "ok": ok}
                if dtype == torch.bfloat16 and (n, rate) in K1_TIMED:
                    line.update(k1_fwd_times(ffn, bounds, args, n, d, f))
                    if n == 64 * 127:
                        record.update(max_abs_err=max_abs, **{
                            k: line[k] for k in (
                                "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "library_event_ms",
                                "device_ms")})
                    else:
                        record.update({f"{k}_n{n}": line[k] for k in (
                            "device_ms", "library_ms", "bound_ms",
                            "plain_ms")})
                emit("k1", **line)
    return record


def k1_fwd_times(ffn, bounds, args, n, d, f) -> dict:
    """K1's bf16 forward at one main-path point: event and card times
    (``device_ms``) beside two addmm (no LN, activation or mask; its card
    time is ``library_ms``), the plain version and the bound, and the
    card time under each schedule of the kernel (two warpgroups over 64
    rows, or 64 of 128 rows each), ``schedule`` the one N gets."""
    x, w1, b1, w2, b2 = args[0], args[3], args[4], args[5], args[6]
    b1c, b2c = b1.to(x.dtype), b2.to(x.dtype)

    def k1():
        return ffn.ln_ffn_residual(*args)

    def addmm():
        return torch.addmm(b2c, torch.addmm(b1c, x, w1.t()), w2.t())
    # The least time for this work on an H100 SXM at 700 W (data-sheet
    # peaks; ops/bounds.py).
    flops, nbytes = bounds.ln_ffn_residual(n, d, f, "bf16")
    bound_ms, bound_by = bounds.bound_ms(flops, nbytes, "bf16")
    out = dict(ms=cuda_ms(k1),
               plain_ms=cuda_ms(lambda: ffn.ln_ffn_residual_ref(*args),
                                iters=10),
               library_event_ms=cuda_ms(addmm),
               device_ms=device_ms(k1, iters=20),
               library_ms=device_ms(addmm, iters=20),
               library="two torch.addmm GEMMs, no LN/act/mask "
                       "(library_ms in device time)",
               bound_ms=bound_ms, bound_by=bound_by, flops=flops,
               bytes=nbytes, schedule=ffn.fwd_schedule(n))
    out["share_of_bound"] = bound_ms / out["device_ms"]
    out["over_library"] = out["device_ms"] / out["library_ms"]
    for force, name in ((1, "split_64_rows"), (0, "rows_128")):
        ffn.fwd_schedule(n, force)
        out[f"device_ms_{name}"] = device_ms(k1, iters=20)
    ffn.fwd_schedule(n, -1)
    return out


def k1_inputs(n: int, dtype, seed: int, d: int = 256, f: int = 2048):
    """K1's arguments (x, g, bl, w1, b1, w2, b2) and an upstream dy."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + torch.randn(*shape, generator=g) * std).cuda()
    args = (rnd(n, d).to(dtype), rnd(d, std=0.1, mean=1.0), rnd(d, std=0.1),
            rnd(f, d, std=d ** -0.5).to(dtype), rnd(f, std=0.1),
            rnd(d, f, std=f ** -0.5).to(dtype), rnd(d, std=0.1))
    return args, rnd(n, d).to(dtype)


def kernel_keep_rates(ffn, dropout, rate: float = 0.1, seed: int = 99,
                      n: int = 256 * 127, d: int = 256, f: int = 2048,
                      row_base: int = 0):
    """The keep rate of each mask as the forward kernel draws it, fp32 and
    bf16, and whether each bit equals the plain mask function's. With
    W1 = 0, b1 = 2 (relu) and W2 the identity on the hidden columns
    [k D, k D + D), the output is y = x + drop2(drop1(2) + b2) there, so
    y == x exactly where a mask dropped. k walks all F / D column groups,
    so every hidden bit is compared; the output mask is read with k = 0.
    ``row_base``: the rows are rows [row_base, row_base + n) of a larger
    batch, whose mask they must draw."""
    x32 = torch.randn(n, d, generator=torch.Generator().manual_seed(1)).cuda()
    ones, zeros = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
    b1 = torch.full((f,), 2.0, device="cuda")
    thresh = dropout.threshold(rate)[0]
    rows = row_base + torch.arange(n, device="cuda")[:, None]
    cols = torch.arange(d, device="cuda")[None, :]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        w1 = torch.zeros(f, d, device="cuda", dtype=dtype)
        eye = torch.eye(d, device="cuda", dtype=dtype)
        for name, stream, b2, rates, groups, stride in (
                ("hidden", dropout.STREAM_FFN_HIDDEN, zeros, (rate, 0.0),
                 f // d, f),
                ("output", dropout.STREAM_FFN_OUT, ones, (0.0, rate), 1, d)):
            kept_n, draws, equal = 0, 0, True
            for k in range(groups):
                w2 = torch.zeros(d, f, device="cuda", dtype=dtype)
                w2[:, k * d:(k + 1) * d] = eye
                y = ffn.forward_kernel(x, ones, zeros, w1, b1, w2, b2,
                                       "relu", 1.0, 1e-5, *rates, seed,
                                       row_base)
                kept = y != x
                off = k * d if name == "hidden" else 0
                plain = dropout.keep_mask(seed, stream,
                                          rows * stride + off + cols, thresh)
                equal = equal and bool(torch.equal(kept, plain))
                kept_n += int(kept.sum())
                draws += kept.numel()
            out[f"{name}_{str(dtype).split('.')[-1]}"] = {
                "keep_rate": kept_n / draws, "draws": draws,
                "column_groups": groups, "equals_plain_mask": equal}
    return out


def relu_kink_free_rows(args, eps: float = 1e-5):
    """Rows whose hidden pre-activations z1 = LN(x) W1^T + b1 (the plain
    version's, in fp32) all lie further than eps from relu's kink."""
    x, g, bl, w1, b1 = args[:5]
    xn = torch.nn.functional.layer_norm(x.float(), (x.shape[1],), g, bl,
                                        1e-5).to(x.dtype).float()
    z1 = xn @ w1.float().t() + b1
    return ~(z1.abs() < eps).any(dim=1)


def phase_k1_bwd(ffn, bounds, dropout) -> dict:
    """K1's forward and backward kernels with dropout against autograd
    through the plain version on the card; returns the backward's record
    at the encoder's training shape in bf16 at rate 0.1."""
    d, f = 256, 2048
    record, agree = {}, True
    for n, act, scale in ((256 * 127, "swish", 0.5),
                          (256 * 33, "relu", 1.0), (1000, "relu", 1.0)):
        for dtype in (torch.float32, torch.bfloat16):
            args, dy = k1_inputs(n, dtype, seed=n)
            for rate in (0.0, 0.1):
                cfg = (act, scale, 1e-5, rate, rate, 4242)
                ins = [a.detach().requires_grad_(True) for a in args]
                y = ffn.ln_ffn_residual(*ins, *cfg)
                got = torch.autograd.grad(y, ins, dy)
                torch.cuda.synchronize()
                want = (ffn.ln_ffn_residual_ref(*args, *cfg),
                        *ffn.backward_ref(args[0], dy, *args[1:], *cfg))
                errs, ok = {}, True
                rows = relu_kink_free_rows(args) if act == "relu" else None
                for name, a, b in zip(K1_GRADS, (y.detach(), *got), want):
                    err = a.float() - b.float()
                    rel = float(err.norm() / b.float().norm())
                    if dtype == torch.float32 and name in ("y", "dx"):
                        bad = err.abs() > 1e-4 + 1e-4 * b.float().abs()
                        if name == "dx" and rows is not None:
                            bad = bad[rows]
                        good = not bool(bad.any())
                    else:
                        good = rel <= 1e-2
                    good = good and bool(torch.isfinite(a).all())
                    errs[name] = {"max_abs": float(err.abs().max()),
                                  "rel_fro": rel, "ok": good}
                    ok = ok and good
                check(ok, f"k1_bwd n={n} {act} {dtype} rate={rate} "
                          f"disagrees with the plain version: {errs}")
                if rate > 0:
                    agree = agree and ok
                line = {"n": n, "activation": act, "ff_scale": scale,
                        "dtype": str(dtype).split(".")[-1], "rate": rate,
                        "ok": ok, "errors": errs, "tolerance":
                        "fp32 y, dx: max abs <= 1e-4 + 1e-4*|ref| (relu: "
                        "over the rows with no |z1| < 1e-5, where fp32 "
                        "rounding in another order can flip relu' between "
                        "0 and 1); bf16 and weight gradients (N-row sums in "
                        "another order, bf16 rounding of dh/dy2 before the "
                        "GEMMs as the Pallas kernel does): relative "
                        "Frobenius <= 1e-2"}
                if rows is not None:
                    line["relu_rows_near_kink"] = int((~rows).sum())
                if dtype == torch.bfloat16 and rate > 0 and n != 1000:
                    line.update(k1_times(ffn, bounds, args, dy, cfg))
                    if n == 256 * 127:
                        record = {"max_abs_err": errs["dx"]["max_abs"],
                                  **{k: line[k] for k in (
                                      "ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms",
                                      "library_event_ms", "device_ms",
                                      "pass_a_ms", "pass_b_ms",
                                      "partial_sums_ms")}}
                emit("k1_bwd", **line)
    emit("k1_bwd_splits", **bwd_split_check(ffn))
    keep = kernel_keep_rates(ffn, dropout)
    for name, r in keep.items():
        sigma = (0.9 * 0.1 / r["draws"]) ** 0.5
        check(r["equals_plain_mask"] and abs(r["keep_rate"] - 0.9)
              < 5 * sigma, f"k1 {name} mask: {r}")
    emit("k1_masks", rate=0.1, expected_keep=1 - 0.1, masks=keep,
         fwd_bwd_masks_agree=agree,
         how="forward kernel output against the plain mask function; the "
             "backward's masks by its gradients at rate 0.1 against "
             "autograd through the plain version with the same seed")
    return record


BWD_SPLIT_NS = (132, 330, 700, 1000, 1100, 1281)
BWD_PASS_B = (4, 5, 6)   # dw1, db1, dw2 in backward_kernel's result


def bwd_split_check(ffn, repeats: int = 8) -> dict:
    """Pass B of the backward on ragged N whose row splits, rounded up to
    whole 64-row chunks, leave the last split short or would leave it
    empty: the weight gradients must agree with autograd through the
    plain version and be the same bits on every call, with a large
    backward launched between calls so that shared memory holds other
    sums when the small one starts."""
    cfg = ("relu", 1.0, 1e-5, 0.1, 0.1, 77)
    out, ok_all = {}, True
    for dtype in (torch.float32, torch.bfloat16):
        big, big_dy = k1_inputs(256 * 33, dtype, seed=3)
        for n in BWD_SPLIT_NS:
            args, dy = k1_inputs(n, dtype, seed=n + 1)
            first = ffn.backward_kernel(args[0], dy, *args[1:], *cfg)
            same = True
            for _ in range(repeats):
                ffn.backward_kernel(big[0], big_dy, *big[1:], *cfg)
                again = ffn.backward_kernel(args[0], dy, *args[1:], *cfg)
                same = same and all(torch.equal(first[i], again[i])
                                    for i in BWD_PASS_B)
            want = ffn.backward_ref(args[0], dy, *args[1:], *cfg)
            rel = max(float((first[i] - want[i].float()).norm()
                            / want[i].float().norm()) for i in BWD_PASS_B)
            ok = same and rel <= 1e-2
            check(ok, f"k1_bwd splits n={n} {dtype}: same bits on every "
                      f"call {same}, worst weight-gradient rel Frobenius "
                      f"{rel}")
            ok_all = ok_all and ok
            out[f"{str(dtype).split('.')[-1]}_n{n}"] = {
                "same_bits_every_call": same, "worst_rel_fro": rel}
    return {"ok": ok_all, "repeats": repeats, "cases": out,
            "tolerance": "dw1, db1, dw2 the same bits on every call; "
                         "relative Frobenius <= 1e-2 against the plain "
                         "version"}


def k1_times(ffn, bounds, args, dy, cfg) -> dict:
    """Forward and backward kernel ms, the plain versions' ms, five
    torch.mm GEMMs of the same backward (never called by the port) and
    the bounds; bf16 inputs."""
    x, g, bl, w1, b1, w2, b2 = args
    n, d = x.shape
    f = w1.shape[0]
    fwd_ms = cuda_ms(lambda: ffn.forward_kernel(*args, *cfg), iters=20)
    ms = cuda_ms(lambda: ffn.backward_kernel(x, dy, *args[1:], *cfg),
                 iters=20)
    plain_fwd_ms = cuda_ms(lambda: ffn.ln_ffn_residual_ref(*args, *cfg),
                           iters=10)
    plain_ms = cuda_ms(lambda: ffn.backward_ref(x, dy, *args[1:], *cfg),
                       iters=10)
    h = torch.randn(n, f, device=x.device).to(x.dtype)
    dz = torch.randn_like(h)

    def gemms():
        torch.mm(x, w1.t())          # recomputed z1 = xn W1^T
        torch.mm(dy, w2)             # dh = dy2 W2
        torch.mm(dz, w1)             # dxn = dz1 W1
        torch.mm(dz.t(), x)          # dW1 = dz1^T xn
        torch.mm(dy.t(), h)          # dW2 = dy2^T h
    library_event_ms = cuda_ms(gemms, iters=20)
    passes = device_passes(lambda: ffn.backward_kernel(x, dy, *args[1:],
                                                       *cfg), launches=8)
    library_ms = device_ms(gemms)
    flops, nbytes = bounds.ln_ffn_residual_bwd(n, d, f, "bf16")
    bound, by = bounds.bound_ms(flops, nbytes, "bf16")
    fwd_flops, fwd_bytes = bounds.ln_ffn_residual(n, d, f, "bf16")
    fwd_bound, fwd_by = bounds.bound_ms(fwd_flops, fwd_bytes, "bf16")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_event_ms": library_event_ms, **passes,
            "library": "five torch.mm bf16 GEMMs of the backward "
                       "(library_ms device time, library_event_ms events)",
            "bound_ms": bound, "bound_by": by, "flops": flops,
            "bytes": nbytes, "share_of_bound": bound / ms,
            "fwd_ms": fwd_ms, "fwd_plain_ms": plain_fwd_ms,
            "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by,
            "bound_source": "H100 SXM data sheet at 700 W (ops/bounds.py)"}


def rel_fro(a, b) -> float:
    b = b.float()
    return float((a.float() - b).norm() / b.norm().clamp_min(1e-30))


def joint_inputs(b, t, u1, h, v, dtype, seed, tail=False):
    """K2/K3's arguments on the card: enc_j, pred_j, w [V, H], bias,
    labels [B, U1-1], lengths, and plane gradients gb, ge that are 0 off
    each utterance's lattice (shaped like occupancies: nonnegative). With
    ``tail`` every other label is V - 1, the last real column of the
    padded V tile."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).cuda()
    enc, pred = rnd(b, t, h, std=0.5).to(dtype), rnd(b, u1, h, std=0.5).to(
        dtype)
    w = rnd(v, h, std=h ** -0.5).to(dtype)
    bias = rnd(v, std=0.1)
    labels = torch.randint(1, v, (b, u1 - 1), generator=g).cuda()
    if tail:
        labels[:, ::2] = v - 1
    ilen = torch.randint(max(1, t // 2), t + 1, (b,), generator=g).cuda()
    llen = torch.randint(0, u1, (b,), generator=g).cuda()
    ilen[0], llen[0] = t, u1 - 1
    on = ((torch.arange(t, device="cuda")[None, :, None] < ilen[:, None, None])
          & (torch.arange(u1, device="cuda")[None, None, :]
             <= llen[:, None, None]))
    gb = torch.rand(b, t, u1, generator=g).cuda() * on
    ge = torch.rand(b, t, u1, generator=g).cuda() * on
    ge[..., -1] = 0.0
    return (enc, pred, w, bias, labels), gb.contiguous(), ge.contiguous()


JOINT_CASES = (  # (name, B, T, U1, H, V, dtype, blank)
    ("train_bf16", 256, 127, 33, 512, 5002, torch.bfloat16, 0),
    ("small_fp32", 3, 19, 5, 64, 40, torch.float32, 0),
    ("ragged_fp32", 5, 37, 9, 128, 1000, torch.float32, 0),
    ("ragged_bf16", 5, 37, 9, 128, 1000, torch.bfloat16, 0),
    # N = 1001 rows, a multiple of neither K2's 128-row blocks nor K3's
    # 64-row chunks, at the flagship's widths.
    ("ragged_h512_bf16", 7, 13, 11, 512, 5002, torch.bfloat16, 0),
    # blank and every other label on V - 1: the padded tail's edge.
    ("tail_bf16", 5, 37, 9, 512, 5002, torch.bfloat16, 5001),
)


def phase_k2_k3(rnnt, bounds, timed: bool = True) -> tuple:
    """K2 and K3 against their plain versions on the card; the same bits
    over repeated K2 and K3 calls; at the training shape in bf16 the times
    of both, the plain versions', cuBLAS GEMMs of the same products
    (chunked over T) and the bounds. Returns the (K2, K3) records."""
    rec2, rec3 = {}, {}
    for name, b, t, u1, h, v, dtype, blank in JOINT_CASES:
        args, gb, ge = joint_inputs(b, t, u1, h, v, dtype, seed=t + v,
                                    tail=blank == v - 1)
        fwd = [rnnt.joint_planes_kernel(*args, blank, "tanh")
               for _ in range(2)]
        torch.cuda.synchronize()
        got = fwd[0]
        same_fwd = all(torch.equal(x, y) for x, y in zip(*fwd))
        want = rnnt.joint_planes_ref(*args, blank, "tanh")
        errs = {}
        for pname, a, r in zip(("blank_lp", "emit_lp", "lse"), got, want):
            if pname == "emit_lp":   # row U has no label
                a, r = a[..., :-1], r[..., :-1]
            err = (a - r).abs()
            errs[pname] = {"max_abs": float(err.max()),
                           "ok": bool((err <= 1e-3 + 1e-4 * r.abs()).all())}
        lse = got[2].contiguous()
        bwd = [rnnt.joint_planes_bwd_kernel(*args, gb, ge, lse, blank,
                                            "tanh")
               for _ in range(3)]
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for again in bwd[1:]
                   for x, y in zip(bwd[0], again))
        want_b = rnnt.joint_planes_bwd_ref(*args, gb, ge, lse, blank, "tanh")
        limit = 1e-4 if dtype == torch.float32 else 1e-2
        for gname, a, r in zip(("denc", "dpred", "dw", "db"), bwd[0],
                               want_b):
            rel = rel_fro(a, r)
            errs[gname] = {"max_abs": float((a - r).abs().max()),
                           "rel_fro": rel, "ok": rel <= limit}
        ok = same and same_fwd and all(e["ok"] for e in errs.values())
        check(ok, f"k2_k3 {name}: {errs}, same bits K3 {same}, K2 "
                  f"{same_fwd}")
        line = {"case": name, "B": b, "T": t, "U1": u1, "H": h, "V": v,
                "blank": blank, "dtype": str(dtype).split(".")[-1],
                "ok": ok, "k2_same_bits_over_2_calls": same_fwd,
                "k3_same_bits_over_3_calls": same, "errors": errs,
                "tolerance": "planes: max abs <= 1e-3 + 1e-4*|ref| (row U "
                             "of emit_lp excluded: no label); gradients "
                             f"relative Frobenius <= {limit} (fp32 sums in "
                             "another order; bf16 rounding of dlogits "
                             "before its GEMMs as the Pallas kernel does)"}
        if name == "train_bf16" and timed:
            line.update(joint_times(rnnt, bounds, args, gb, ge, lse))
            keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "event_ms", "library_event_ms", "library_ms_v5008")
            rec2 = {"max_abs_err": errs["lse"]["max_abs"],
                    **{k: line["k2"][k] for k in keys}}
            rec3 = {"max_abs_err": errs["denc"]["max_abs"],
                    **{k: line["k3"][k] for k in keys},
                    **{k: line["k3"][k] for k in (
                        "pass_a_ms", "pass_b_ms", "partial_sums_ms",
                        "workspace_bytes")}}
        emit("k2_k3", **line)
    return rec2, rec3


def joint_times(rnnt, bounds, args, gb, ge, lse) -> dict:
    """K2's and K3's card time (``device_ms``; ``event_ms`` by events
    around the calls), K3 split by pass, its workspace, the plain
    versions' times and the cuBLAS yardsticks of the same products, also
    with W padded to V = 5008 (rows a multiple of 16 bytes), for
    information."""
    enc, pred, w, bias, labels = args
    b, t, h = enc.shape
    u1, v = pred.shape[1], w.shape[0]

    def k2():
        rnnt.joint_planes_kernel(*args, 0, "tanh")

    def k3():
        rnnt.joint_planes_bwd_kernel(*args, gb, ge, lse, 0, "tanh")
    k2_event = cuda_ms(k2, iters=5, warmup=1)
    k3_event = cuda_ms(k3, iters=3, warmup=1)
    p2 = cuda_ms(lambda: rnnt.joint_planes_ref(*args, 0, "tanh"), iters=2,
                 warmup=1)
    p3 = cuda_ms(lambda: rnnt.joint_planes_bwd_ref(*args, gb, ge, lse, 0,
                                                   "tanh"),
                 iters=1, warmup=1)
    # Yardstick: cuBLAS bf16 GEMMs of the same products over 16-frame
    # chunks (the whole [B*T*U1, V] output would take 21 GB): the logits
    # for K2; the logits, dlogits @ W and the dW product for K3.
    chunk = 16
    rows = b * chunk * u1
    n_chunks = -(-t // chunk)

    def yardsticks(wv):
        hid = torch.randn(rows, h, device="cuda").to(enc.dtype)
        dl = torch.randn(rows, wv.shape[0], device="cuda").to(enc.dtype)

        def logits():
            for _ in range(n_chunks):
                torch.mm(hid, wv.t())

        def three():
            for _ in range(n_chunks):
                torch.mm(hid, wv.t())
                torch.mm(dl, wv)
                torch.mm(dl.t(), hid)
        return logits, three
    logits, three = yardsticks(w)
    lib2_event = cuda_ms(logits, iters=3, warmup=1)
    lib3_event = cuda_ms(three, iters=3, warmup=1)
    w5008 = torch.zeros(5008, h, device="cuda", dtype=w.dtype)
    w5008[:v] = w
    logits_pad, three_pad = yardsticks(w5008)
    dev = {"k2": device_ms(k2, iters=5),
           "lib2": device_ms(logits, iters=3),
           "lib2_pad": device_ms(logits_pad, iters=3),
           "k3": device_ms(k3, iters=3),
           "lib3": device_ms(three, iters=3),
           "lib3_pad": device_ms(three_pad, iters=3)}
    passes = device_passes(k3, launches=5, iters=3)
    words = rnnt._lib().rnnt_joint_bwd_workspace(1, b, t, u1, h, v)
    out = {}
    for key, ms, event, plain, lib, lib_event, lib_pad, fn in (
            ("k2", dev["k2"], k2_event, p2, dev["lib2"], lib2_event,
             dev["lib2_pad"], bounds.joint_planes_fwd),
            ("k3", dev["k3"], k3_event, p3, dev["lib3"], lib3_event,
             dev["lib3_pad"], bounds.joint_planes_bwd)):
        flops, nbytes = fn(b, t, u1, h, v, "bf16")
        bound, by = bounds.bound_ms(flops, nbytes, "bf16")
        out[key] = {"ms": ms, "event_ms": event, "plain_ms": plain,
                    "library_ms": lib, "library_event_ms": lib_event,
                    "library_ms_v5008": lib_pad, "bound_ms": bound,
                    "bound_by": by, "flops": flops, "bytes": nbytes,
                    "share_of_bound": bound / ms,
                    "over_library": ms / lib}
    out["k3"].update({k: passes[k] for k in (
        "pass_a_ms", "pass_b_ms", "partial_sums_ms", "profile_complete",
        "intervals")}, device_ms_passes_run=passes["device_ms"],
        workspace_bytes=4 * words)
    out["library"] = ("torch.mm bf16 GEMMs of the same products in "
                      f"{chunk}-frame chunks (logits; + dlogits @ W and "
                      "dW for K3), no softmax; library_ms_v5008 the same "
                      "with W zero-padded to 5008 rows, for information")
    out["timing"] = ("ms, library_ms, library_ms_v5008: card ms per call "
                     "(device_ms); *_event_ms: CUDA events around the "
                     "calls; plain_ms by events")
    return out


LSTM_CASES = (  # (name, B, U1, H, dtype)
    ("train_bf16", 256, 33, 256, torch.bfloat16),
    ("train_fp32", 256, 33, 256, torch.float32),
    ("pallas_bf16", 64, 33, 256, torch.bfloat16),   # T6's batch
    ("ragged_bf16", 37, 9, 256, torch.bfloat16),
    ("ragged100_bf16", 100, 17, 256, torch.bfloat16),   # 64 + 36 rows
    ("h64_bf16", 37, 9, 64, torch.bfloat16),
    ("h128_bf16", 100, 9, 128, torch.bfloat16),
    ("u1_bf16", 37, 1, 256, torch.bfloat16),
    ("ragged_fp32", 37, 9, 64, torch.float32),
    ("u1_fp32", 37, 1, 64, torch.float32),
)
LSTM_TIMED = ("train_bf16", "pallas_bf16")
K4_GRADS = ("dxw1", "dwh1", "dwi2", "dbh2", "dwh2")
# K4's bf16 stages in a profile: (name, substrings of the kernel's name,
# launches a call).
K4_FWD_STAGES = (("layer1_rec", ("fwd_rec<", ", false>"), 1),
                 ("xw2_gemm", ("xw2_gemm<",), 1),
                 ("layer2_rec", ("fwd_rec<", ", true>"), 1))
K4_BWD_STAGES = (("layer2_rec", ("bwd_rec<", ", true>"), 1),
                 ("gd_gemm", ("gd_gemm<",), 1),
                 ("layer1_rec", ("bwd_rec<", ", false>"), 1),
                 ("weight_pass", ("dw_gemm<",), 1),
                 ("sums", ("bwd_sums(",), 2))


def lstm_inputs(b, u1, h, dtype, seed):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).cuda()
    xw1 = rnd(b, u1, 4 * h, std=0.5).to(dtype)
    ws = [rnd(4 * h, h, std=h ** -0.5) for _ in range(3)]
    bh2 = rnd(4 * h, std=0.1)
    dy = rnd(b, u1, h).to(dtype)
    return (xw1, ws[0], ws[1], bh2, ws[2]), dy


def phase_k4(lstm, bounds, dropout, timed: bool = True) -> tuple:
    """K4 forward and backward against autograd through the plain version
    (dropout 0 and 0.1, same seed) at every LSTM_CASES shape (bf16 H 64,
    128, 256; B ragged against the 64-row cluster group; U1 = 1), the
    mask as the forward kernel draws it equal to the plain one, the same
    bits over repeated backward calls, and in bf16 at B = 256 and 64
    (U1 = 33, H = 256) the times: the kernels', the plain versions' and
    cuDNN's LSTM (same weights, dropout 0; its card busy time and
    events), each direction split by stage. Returns the (forward,
    backward) records of B = 256."""
    rec_f, rec_b = {}, {}
    seed = 4242
    for name, b, u1, h, dtype in LSTM_CASES:
        args, dy = lstm_inputs(b, u1, h, dtype, seed=b + h)
        for rate in (0.0, 0.1):
            ins = [a.detach().requires_grad_(True) for a in args]
            y = lstm.lstm2_seq(*ins, rate=rate, seed=seed)
            got = torch.autograd.grad(y, ins, dy)
            torch.cuda.synchronize()
            want_y = lstm.lstm2_seq_ref(*args, rate=rate, seed=seed)
            want = lstm.backward_ref(dy, *args, rate=rate, seed=seed)
            _, saved = lstm.forward_kernel(*args, rate, seed, save=True)
            again = [lstm.backward_kernel(dy, *args, saved, rate, seed)
                     for _ in range(3)]
            torch.cuda.synchronize()
            same = all(torch.equal(x, z) for a in again[1:]
                       for x, z in zip(again[0], a))
            limit = 1e-4 if dtype == torch.float32 else 2e-2
            errs = {}
            for gname, a, r in zip(("y",) + K4_GRADS, (y.detach(), *got),
                                   (want_y, *want)):
                rel = rel_fro(a, r)
                errs[gname] = {"max_abs": float((a.float() - r.float())
                                                .abs().max()),
                               "rel_fro": rel, "ok": rel <= limit}
            ok = same and all(e["ok"] for e in errs.values())
            check(ok, f"k4 {name} rate={rate}: {errs}, same bits {same}")
            line = {"case": name, "B": b, "U1": u1, "H": h, "rate": rate,
                    "dtype": str(dtype).split(".")[-1], "ok": ok,
                    "bwd_same_bits_over_3_calls": same, "errors": errs,
                    "tolerance": f"relative Frobenius <= {limit} against "
                                 "autograd through the plain version (fp32 "
                                 "sums in another order; bf16 states "
                                 "rounded at the same points)"}
            if rate > 0:
                keep = saved[3] != 0
                plain = dropout.keep_mask(
                    seed, dropout.STREAM_LSTM_INTER,
                    (torch.arange(u1, device="cuda")[None, :, None] * b
                     + torch.arange(b, device="cuda")[:, None, None]) * h
                    + torch.arange(h, device="cuda")[None, None, :],
                    dropout.threshold(rate)[0])
                rate_kept = float(keep.double().mean())
                sigma = (0.9 * 0.1 / keep.numel()) ** 0.5
                mask_ok = bool(torch.equal(keep, plain)) and \
                    abs(rate_kept - 0.9) < 5 * sigma
                check(mask_ok, f"k4 {name} mask: keep {rate_kept}")
                line.update(keep_rate=rate_kept, draws=keep.numel(),
                            mask_equals_plain=bool(torch.equal(keep, plain)))
            if name in LSTM_TIMED and rate == 0.0 and timed:
                line.update(lstm_times(lstm, bounds, args, dy))
                if name == "train_bf16":
                    keys = ("ms", "event_ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "library_event_ms",
                            "us_per_step", "stages")
                    rec_f = {"max_abs_err": errs["y"]["max_abs"],
                             **{k: line["fwd"][k] for k in keys}}
                    rec_b = {"max_abs_err": errs["dxw1"]["max_abs"],
                             **{k: line["bwd"][k] for k in keys}}
                else:
                    for rec, key in ((rec_f, "fwd"), (rec_b, "bwd")):
                        rec.update(ms_b64=line[key]["ms"],
                                   library_ms_b64=line[key]["library_ms"])
            emit("k4", **line)
    return rec_f, rec_b


def lstm_times(lstm, bounds, args, dy) -> dict:
    """K4's bf16 forward (saving the states, as training runs it) and
    backward: card ms per call (``device_ms``), by events
    (``event_ms``), split by stage, µs per serial step (2 U1 steps each
    way); the plain versions' times (events); cuDNN's 2-layer LSTM with
    the same recurrent weights, forward and forward + backward, card
    busy time and events; the bounds."""
    xw1, wh1, wi2, bh2, wh2 = args
    b, u1, g4 = xw1.shape
    h = g4 // 4

    def fwd_call():
        return lstm.forward_kernel(*args, save=True)
    _, saved = fwd_call()

    def bwd_call():
        return lstm.backward_kernel(dy, *args, saved)
    dev = {"fwd": device_ms(fwd_call, iters=20),
           "bwd": device_ms(bwd_call, iters=20)}
    ev = {"fwd": cuda_ms(fwd_call, iters=20), "bwd": cuda_ms(bwd_call,
                                                             iters=20)}
    stages = {"fwd": stage_ms(fwd_call, K4_FWD_STAGES),
              "bwd": stage_ms(bwd_call, K4_BWD_STAGES)}
    plain = {"fwd": cuda_ms(lambda: lstm.lstm2_seq_ref(*args), iters=3,
                            warmup=1),
             "bwd": cuda_ms(lambda: lstm.backward_ref(dy, *args), iters=3,
                            warmup=1)}
    # Yardstick: cuDNN's 2-layer LSTM with the same recurrent weights,
    # dropout 0 (it also runs layer 1's input projection, from H inputs).
    net = torch.nn.LSTM(h, h, num_layers=2, batch_first=True).cuda().to(
        xw1.dtype)
    with torch.no_grad():
        net.weight_hh_l0.copy_(wh1)
        net.weight_ih_l1.copy_(wi2)
        net.weight_hh_l1.copy_(wh2)
        net.bias_hh_l1.copy_(bh2)
    net.flatten_parameters()   # one packed weight buffer, as cuDNN wants
    x = torch.randn(b, u1, h, device="cuda").to(xw1.dtype)

    def lib_fwd():
        with torch.no_grad():
            net(x)
    xg = x.requires_grad_(True)

    def lib_both():
        out, _ = net(xg)
        torch.autograd.grad(out, [xg] + list(net.parameters()), dy)
    lf_dev, lb_dev = busy_ms(lib_fwd), busy_ms(lib_both)
    lf_ev, lb_ev = cuda_ms(lib_fwd, iters=20), cuda_ms(lib_both, iters=20)
    lib = {"fwd": (lf_dev, lf_ev), "bwd": (lb_dev - lf_dev, lb_ev - lf_ev)}
    out = {"library": "torch.nn.LSTM (cuDNN), 2 layers, same recurrent "
                      "weights, flattened, dropout 0; backward = "
                      "forward+backward minus forward",
           "timing": "ms: card ms per call (device_ms); library_ms: the "
                     "card's busy ms per call under torch.profiler, the "
                     "median of 3 profiles (cuDNN's LSTM synchronises with "
                     "the host, flattened weights or not, so device_ms "
                     "cannot queue it ahead); *_event_ms: CUDA events "
                     "around the calls; plain_ms by events; stages from "
                     "torch.profiler; us_per_step = ms over the 2 U1 serial "
                     "steps; port_bytes: what the kernels move (not in the "
                     "bound), port_bytes_ms: those bytes at the memory rate"}
    port = dict(zip(("fwd", "bwd"),
                    bounds.lstm2_seq_port_bytes(b, u1, h, "bf16")))
    for key, fn in (("fwd", bounds.lstm2_seq), ("bwd", bounds.lstm2_seq_bwd)):
        flops, nbytes = fn(b, u1, h, "bf16")
        bound, by = bounds.bound_ms(flops, nbytes, "bf16")
        out[key] = {"ms": dev[key], "event_ms": ev[key],
                    "plain_ms": plain[key], "library_ms": lib[key][0],
                    "library_event_ms": lib[key][1], "bound_ms": bound,
                    "bound_by": by, "flops": flops, "bytes": nbytes,
                    "port_bytes": port[key],
                    "port_bytes_ms": port[key] / bounds.PEAK_BYTES * 1e3,
                    "share_of_bound": bound / dev[key],
                    "factor": dev[key] / lib[key][0],
                    "us_per_step": dev[key] * 1e3 / (2 * u1),
                    "stages": stages[key]}
    return out


LATTICE_CASES = (  # (name, B, T', U1, ragged lengths)
    ("train", 256, 127, 33, False),
    ("train_ragged", 256, 127, 33, True),
    ("pallas_b64", 64, 127, 33, False),
    ("wide_ragged", 64, 200, 90, True),
    ("wide_600", 16, 127, 600, False),  # 10 warps a direction (ring)
    ("wide_600_ragged", 16, 127, 600, True),
    # transducer_score over B3's n-best: 64 utterances × beam 10, every
    # hypothesis padded to T' + 1 columns.
    ("nbest", 640, 127, 128, False),
    ("nbest_ragged", 640, 127, 128, True),
)


def lattice_inputs(b, t, u1, ragged, seed, log_zero):
    """Blank and label log-prob planes [B, T', U1] (a 3-way log-softmax,
    row U of emit at LOG_ZERO) and the lengths, full or ragged."""
    g = torch.Generator().manual_seed(seed)
    lp = torch.log_softmax(2.0 * torch.randn(b, t, u1, 3, generator=g), -1)
    blank, emit = lp[..., 0].contiguous(), lp[..., 1].contiguous()
    emit[..., -1] = log_zero
    il, ll = torch.full((b,), t), torch.full((b,), u1 - 1)
    if ragged:
        il = torch.randint(1, t, (b,), generator=g)
        ll = torch.randint(0, u1 - 1, (b,), generator=g)
    return blank.cuda(), emit.cuda(), il.cuda(), ll.cuda()


def phase_k9(rnnt, bounds) -> dict:
    """K9 against alpha_scan/beta_scan on the card: valid cells within
    1e-4 + 1e-5*|ref|, invalid cells exactly LOG_ZERO, beta[0, 0] equal to
    the terminal alpha + blank within 1e-5 relative, the same bits over 3
    calls; at the full-length shapes its card time (``device_ms``), µs a
    dependent diagonal step, the plain loops' time and the bound. Returns
    the training shape's record."""
    record = {}
    for name, b, t, u1, ragged in LATTICE_CASES:
        blank, emit_lp, il, ll = lattice_inputs(b, t, u1, ragged, t + u1,
                                                rnnt.LOG_ZERO)
        args = (blank, emit_lp, il, ll)
        got = rnnt.alpha_beta_kernel(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for _ in range(2)
                   for x, y in zip(got, rnnt.alpha_beta_kernel(*args)))
        want = rnnt.alpha_beta_ref(*args)
        errs = {}
        for pname, a, r in zip(("alpha", "beta"), got, want):
            off = r == rnnt.LOG_ZERO
            err = (a - r)[~off].abs()
            exact = bool((a[off] == rnnt.LOG_ZERO).all())
            within = bool((err <= 1e-4 + 1e-5 * r[~off].abs()).all())
            errs[pname] = {"max_abs": float(err.max()),
                           "invalid_cells": int(off.sum()),
                           "invalid_exact": exact, "ok": exact and within}
        alpha, beta = got
        rows = torch.arange(b, device="cuda")
        term = alpha[rows, il - 1, ll] + blank[rows, il - 1, ll]
        rel = float(((beta[:, 0, 0] - term).abs() / term.abs()).max())
        ok = all(e["ok"] for e in errs.values()) and rel <= 1e-5 and same
        check(ok, f"k9 {name}: {errs}, beta[0,0] vs terminal rel {rel}, "
                  f"same bits over 3 calls {same}")
        line = {"case": name, "B": b, "T": t, "U1": u1, "ragged": ragged,
                "ok": ok, "errors": errs,
                "beta00_vs_terminal_rel": rel, "same_bits_3_calls": same,
                "tolerance": "valid cells max abs <= 1e-4 + 1e-5*|ref| "
                             "(fp32 logaddexp chains of up to T'+U1 steps "
                             "in another order of operations); invalid "
                             "cells exactly LOG_ZERO; beta[0,0] vs terminal "
                             "alpha + blank <= 1e-5 relative"}
        if not ragged:
            steps = t + u1 - 1   # alpha and beta side by side
            # int32 lengths: the wrapper's casts are not the kernel's time
            args32 = (blank, emit_lp, il.int(), ll.int())
            ms = device_ms(lambda: rnnt.alpha_beta_kernel(*args32),
                           iters=20)
            plain_ms = cuda_ms(lambda: rnnt.alpha_beta_ref(*args), iters=3,
                               warmup=1)
            flops, nbytes = bounds.alpha_beta(b, t, u1)
            bound, by = bounds.bound_ms(flops, nbytes, "fp32")
            line.update(ms=ms, chain_steps=steps,
                        us_per_step=ms * 1e3 / steps,
                        plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                        flops=flops, bytes=nbytes,
                        share_of_bound=bound / ms,
                        timing="device_ms: card time, calls back to back",
                        library="none: no single PyTorch call computes the "
                                "lattice")
            if name == "train":
                record = {"max_abs_err": max(e["max_abs"]
                                             for e in errs.values()),
                          "ms": ms, "us_per_step": ms * 1e3 / steps,
                          "plain_ms": plain_ms, "bound_ms": bound,
                          "bound_by": by, "library_ms": None}
        emit("k9", **line)
    return record


# K4's forward cases at transducer_score's shapes: (name, B, U1, H, dtype);
# B3 in bf16, S1 in fp32, and a B ragged against the 64-row clusters.
NBEST_LSTM_CASES = (("nbest_bf16", 640, 128, 256, torch.bfloat16),
                    ("nbest_fp32", 640, 128, 256, torch.float32),
                    ("nbest_ragged_bf16", 617, 128, 256, torch.bfloat16))


def phase_nbest_kernels(rnnt, lstm, bounds) -> None:
    """K2 and K4 as transducer_score calls them on B3's n-best (64
    utterances × beam 10, T' = 127, U1 = 128): forward only, under
    torch.no_grad(), each one launch, against its plain version on the
    same inputs, the same bits on a second call, with the card time and
    the bound. K2's plain version runs 4 frames at a time (its logits are
    26 GB at 16)."""
    b, t, u1, h, v = 640, 127, 128, 512, 5002
    args, _, _ = joint_inputs(b, t, u1, h, v, torch.bfloat16, seed=u1 + v)
    with torch.no_grad():
        before = rnnt.joint_planes.launches
        got = rnnt.joint_planes(*args, 0, "tanh")
        torch.cuda.synchronize()
        launched = rnnt.joint_planes.launches - before
        same = all(torch.equal(x, y) for x, y in zip(
            got, rnnt.joint_planes_kernel(*args, 0, "tanh")))
        want = rnnt.joint_planes_ref(*args, 0, "tanh", chunk=4)
    errs = {}
    for pname, a, r in zip(("blank_lp", "emit_lp", "lse"), got, want):
        if pname == "emit_lp":   # row U has no label
            a, r = a[..., :-1], r[..., :-1]
        err = (a - r).abs()
        errs[pname] = {"max_abs": float(err.max()),
                       "ok": bool((err <= 1e-3 + 1e-4 * r.abs()).all())}
    del want
    ok = launched == 1 and same and all(e["ok"] for e in errs.values())
    check(ok, f"nbest k2: {errs}, launches {launched}, same bits {same}")
    flops, nbytes = bounds.joint_planes_fwd(b, t, u1, h, v, "bf16")
    bound, by = bounds.bound_ms(flops, nbytes, "bf16")
    ms = device_ms(lambda: rnnt.joint_planes_kernel(*args, 0, "tanh"),
                   iters=3, warmup=1)
    emit("nbest_kernels", kernel="k2", B=b, T=t, U1=u1, H=h, V=v,
         dtype="bfloat16", ok=ok, launches=launched, same_bits=same,
         errors=errs, ms=ms, bound_ms=bound, bound_by=by,
         share_of_bound=bound / ms,
         tolerance="planes: max abs <= 1e-3 + 1e-4*|ref| (row U of "
                   "emit_lp excluded: no label)",
         timing="ms: card ms per call (device_ms)")
    del got, args
    torch.cuda.empty_cache()
    for name, b, u1, h, dtype in NBEST_LSTM_CASES:
        args, _ = lstm_inputs(b, u1, h, dtype, seed=b + u1)
        with torch.no_grad():
            before = lstm.lstm2_seq.launches
            y = lstm.lstm2_seq(*args)
            torch.cuda.synchronize()
            launched = lstm.lstm2_seq.launches - before
            same = torch.equal(y, lstm.lstm2_seq(*args))
            want = lstm.lstm2_seq_ref(*args)
        limit = 1e-4 if dtype == torch.float32 else 2e-2
        rel = rel_fro(y, want)
        ok = launched == 1 and same and rel <= limit and bool(
            torch.isfinite(y).all())
        check(ok, f"nbest k4 {name}: rel {rel}, launches {launched}, "
                  f"same bits {same}")
        dt = "bf16" if dtype == torch.bfloat16 else "fp32"
        flops, nbytes = bounds.lstm2_seq(b, u1, h, dt)
        bound, by = bounds.bound_ms(flops, nbytes, dt)
        ms = device_ms(lambda: lstm.forward_kernel(*args), iters=5)
        emit("nbest_kernels", kernel="k4", case=name, B=b, U1=u1, H=h,
             dtype=str(dtype).split(".")[-1], ok=ok, launches=launched,
             same_bits=same, rel_fro_err=rel,
             max_abs_err=float((y.float() - want.float()).abs().max()),
             ms=ms, us_per_step=ms * 1e3 / (2 * u1), bound_ms=bound,
             bound_by=by,
             tolerance=f"relative Frobenius <= {limit} against the plain "
                       "version (K4's training-shape tolerance)",
             timing="ms: card ms per call (device_ms), no states saved")


K8_OUTS = ("y", "dx", "dg1", "db1", "dw1", "dbw1", "dw_dw", "db_dw", "dg2",
           "db2", "dw2", "dbw2")


def conv_inputs(b, t, d, k, dtype, seed):
    """K8's arguments (x, mask, the ten parameters) on a padded batch and
    an upstream dy."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + torch.randn(*shape, generator=g) * std).cuda()
    lens = torch.randint(t // 2, t + 1, (b,), generator=g)
    lens[0] = t
    mask = (torch.arange(t)[None, :] < lens[:, None]).float().cuda()
    params = (rnd(d, std=0.1, mean=1.0), rnd(d, std=0.1),
              rnd(d, 2 * d, std=d ** -0.5).to(dtype), rnd(2 * d, std=0.1),
              rnd(k, d, std=k ** -0.5), rnd(d, std=0.1),
              rnd(d, std=0.1, mean=1.0), rnd(d, std=0.1),
              rnd(d, d, std=d ** -0.5).to(dtype), rnd(d, std=0.1))
    return rnd(b, t, d).to(dtype), mask, params, rnd(b, t, d).to(dtype)


def conv_keep_rate(conv, dropout, rate=0.1, seed=77, b=256, t=127, d=256,
                   k=15, dtype=torch.float32, row_base: int = 0) -> dict:
    """The keep rate of K8's output mask as the forward kernel draws it
    and whether it equals the plain mask function bit for bit: with
    W2 = 0 and bw2 = 1 the block adds drop(1) * mask, so y != x exactly
    where the mask kept a valid frame's channel. ``row_base``: the
    utterances are rows [row_base, row_base + b) of a larger batch."""
    x, mask, params, _ = conv_inputs(b, t, d, k, dtype, seed=5)
    params = list(params)
    params[8] = torch.zeros_like(params[8])
    params[9] = torch.ones_like(params[9])
    y = conv.forward_kernel(x, mask, *params, seed, False, rate, 1e-5,
                            row_base)
    valid = mask.bool()[..., None].expand(b, t, d)
    kept = (y != x)[valid]
    index = row_base * t * d + torch.arange(
        b * t * d, device="cuda").reshape(b, t, d)
    plain = dropout.keep_mask(seed, dropout.STREAM_CONV_OUT, index,
                              dropout.threshold(rate)[0])[valid]
    return {"keep_rate": float(kept.double().mean()), "draws": kept.numel(),
            "equals_plain_mask": bool(torch.equal(kept, plain))}


# bf16 K8 cases whose T crosses the kernels' 128-frame steps: three steps
# (the hidden and dy0 carried twice), and T = 256: two steps when causal,
# three when not, the last without PW1 rows (non-causal output frames
# trail the PW1 rows by 7).
K8_LONG_T = (300, 256)


def phase_k8(conv, bounds, dropout) -> tuple:
    """K8 forward (N = 64*127) and backward (N = 256*127) against the
    plain version and autograd through it on the card, D = 256, K = 15,
    fp32 and bf16, causal and not, rates 0 and 0.1, on padded batches;
    bf16 again at B = 8 with T in K8_LONG_T; the same bits over repeated
    backward calls; the output mask's keep rate and bits; at the route's
    operating point (bf16, non-causal) the times, the plain versions', the
    port's unfused block as the yardstick, and the bounds. Returns the
    (forward, backward) records."""
    d, k, t = 256, 15, 127
    rec_f, rec_b = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        limit = 1e-4 if dtype == torch.float32 else 2e-2
        for causal in (False, True):
            for rate in (0.0, 0.1):
                cfg = (4242, causal, rate, 1e-5)
                x, mask, params, _ = conv_inputs(64, t, d, k, dtype, seed=1)
                y = conv.forward_kernel(x, mask, *params, *cfg)
                torch.cuda.synchronize()
                want_y = conv.conv_block_residual_ref(x, mask, *params, *cfg)
                xb, mb, pb, dy = conv_inputs(256, t, d, k, dtype, seed=2)
                got = [conv.backward_kernel(xb, mb, *pb, dy, *cfg)
                       for _ in range(3)]
                torch.cuda.synchronize()
                same = all(torch.equal(p, q) for again in got[1:]
                           for p, q in zip(got[0], again))
                want = conv.backward_ref(xb, mb, *pb, dy, *cfg)
                errs = {}
                for oname, a, r in zip(K8_OUTS, (y, *got[0]),
                                       (want_y, *want)):
                    rel = rel_fro(a, r)
                    errs[oname] = {"max_abs": float((a.float() - r.float())
                                                    .abs().max()),
                                   "rel_fro": rel, "ok": rel <= limit}
                ok = same and all(e["ok"] for e in errs.values())
                check(ok, f"k8 {dtype} causal={causal} rate={rate}: {errs},"
                          f" same bits {same}")
                line = {"dtype": str(dtype).split(".")[-1], "causal": causal,
                        "rate": rate, "fwd_n": 64 * t, "bwd_n": 256 * t,
                        "D": d, "K": k, "ok": ok,
                        "bwd_same_bits_over_3_calls": same, "errors": errs,
                        "tolerance": f"relative Frobenius <= {limit} against "
                                     "the plain version and autograd "
                                     "through it (fp32 sums in another "
                                     "order; bf16 rounding of LN1's output, "
                                     "silu's output, dv and du at the same "
                                     "points)"}
                if dtype == torch.bfloat16 and not causal and rate > 0:
                    line.update(conv_times(conv, bounds, (x, mask, params),
                                           (xb, mb, pb, dy), cfg))
                    rec_f = {"max_abs_err": errs["y"]["max_abs"],
                             **{key: line["fwd"][key] for key in (
                                 "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}}
                    rec_b = {"max_abs_err": errs["dx"]["max_abs"],
                             **{key: line["bwd"][key] for key in (
                                 "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}}
                emit("k8", **line)
    for t_long in K8_LONG_T:
        for causal in (False, True):
            for rate in (0.0, 0.1):
                cfg = (4242, causal, rate, 1e-5)
                x, mask, params, dy = conv_inputs(8, t_long, d, k,
                                                  torch.bfloat16, seed=t_long)
                y = conv.forward_kernel(x, mask, *params, *cfg)
                got = [conv.backward_kernel(x, mask, *params, dy, *cfg)
                       for _ in range(3)]
                torch.cuda.synchronize()
                same = all(torch.equal(p, q) for again in got[1:]
                           for p, q in zip(got[0], again))
                want_y = conv.conv_block_residual_ref(x, mask, *params, *cfg)
                want = conv.backward_ref(x, mask, *params, dy, *cfg)
                errs = output_errors(K8_OUTS, (y, *got[0]), (want_y, *want),
                                     2e-2)
                ok = same and all(e["ok"] for e in errs.values())
                check(ok, f"k8 bf16 T={t_long} causal={causal} rate={rate}:"
                          f" {errs}, same bits {same}")
                emit("k8", dtype="bfloat16", causal=causal, rate=rate,
                     b=8, t=t_long, D=d, K=k, ok=ok,
                     bwd_same_bits_over_3_calls=same, errors=errs,
                     tolerance="relative Frobenius <= 0.02 against the "
                               "plain version and autograd through it; T "
                               "crosses the kernels' 128-frame steps")
    keep = conv_keep_rate(conv, dropout)
    check(keep["equals_plain_mask"] and abs(keep["keep_rate"] - 0.9)
          <= 0.003 * 0.9, f"k8 mask: {keep}")
    emit("k8_mask", rate=0.1, expected_keep=0.9, **keep,
         tolerance="bit-equal to the plain mask; keep rate within 0.3 % of "
                   "0.9")
    return rec_f, rec_b


def unfused_block(args, dtype, causal: bool = False):
    """The port's unfused conv block, LayerNorm → ConvolutionModule →
    residual, with K8's weights: a yardstick the port does not call."""
    from wenet_celoss_tpu_torch.models.convolution import ConvolutionModule
    from wenet_celoss_tpu_torch.models.layers import LayerNorm
    x, mask, (g1, b1, w1, bw1, w_dw, b_dw, g2, b2, w2, bw2) = args
    d, k = x.shape[2], w_dw.shape[0]
    ln = LayerNorm(d, dtype=dtype).cuda()
    cm = ConvolutionModule(d, k, "layer_norm", causal,
                           dtype=dtype).cuda()
    with torch.no_grad():
        for p, v in ((ln.weight, g1), (ln.bias, b1),
                     (cm.pointwise_conv1.weight, w1.t()),
                     (cm.pointwise_conv1.bias, bw1),
                     (cm.depthwise_conv.weight, w_dw.t()[:, None, :]),
                     (cm.depthwise_conv.bias, b_dw),
                     (cm.norm_layer.weight, g2), (cm.norm_layer.bias, b2),
                     (cm.pointwise_conv2.weight, w2.t()),
                     (cm.pointwise_conv2.bias, bw2)):
            p.copy_(v.float())
    pad = mask.bool()
    return lambda xin: xin + cm(ln(xin), pad), [*ln.parameters(),
                                                  *cm.parameters()]


def conv_times(conv, bounds, fwd_args, bwd_args, cfg) -> dict:
    """K8's forward (rate 0, the decode route) and backward times at the
    main path's shapes, the plain versions', the unfused block's (forward;
    forward + backward less forward) and the bounds; bf16 inputs."""
    x, mask, params = fwd_args
    xb, mb, pb, dy = bwd_args
    fcfg = (cfg[0], cfg[1], 0.0, cfg[3])
    fwd = cuda_ms(lambda: conv.forward_kernel(x, mask, *params, *fcfg),
                  iters=20)
    bwd = cuda_ms(lambda: conv.backward_kernel(xb, mb, *pb, dy, *cfg),
                  iters=10)
    p_fwd = cuda_ms(lambda: conv.conv_block_residual_ref(x, mask, *params,
                                                         *fcfg), iters=5)
    p_bwd = cuda_ms(lambda: conv.backward_ref(xb, mb, *pb, dy, *cfg),
                    iters=3, warmup=1)
    block, _ = unfused_block((x, mask, params), x.dtype)
    with torch.no_grad():
        lib_fwd = cuda_ms(lambda: block(x), iters=20)
    block_b, weights = unfused_block((xb, mb, pb), xb.dtype)
    xg = xb.detach().requires_grad_(True)
    with torch.no_grad():
        lib_fwd_b = cuda_ms(lambda: block_b(xb), iters=10)

    def both():
        torch.autograd.grad(block_b(xg), [xg] + weights, dy)
    lib_both = cuda_ms(both, iters=10)
    d, k = x.shape[2], params[4].shape[0]
    out = {"library": "the port's unfused block (LayerNorm, "
                      "ConvolutionModule with cuDNN's depthwise conv1d, "
                      "residual; no dropout); backward = forward + backward "
                      "less forward"}
    for key, ms, plain, lib, n, fn in (
            ("fwd", fwd, p_fwd, lib_fwd, x.shape[0] * x.shape[1],
             bounds.conv_block_residual),
            ("bwd", bwd, p_bwd, lib_both - lib_fwd_b,
             xb.shape[0] * xb.shape[1], bounds.conv_block_residual_bwd)):
        flops, nbytes = fn(n, d, k, "bf16")
        bound, by = bounds.bound_ms(flops, nbytes, "bf16")
        out[key] = {"n": n, "ms": ms, "plain_ms": plain, "library_ms": lib,
                    "bound_ms": bound, "bound_by": by, "flops": flops,
                    "bytes": nbytes, "share_of_bound": bound / ms}
    return out


def output_errors(names, got, want, limit) -> dict:
    """Each output's max abs and relative Frobenius error against the
    plain version's; ok when finite and within ``limit``."""
    return {name: {"max_abs": float((a.float() - r.float()).abs().max()),
                   "rel_fro": rel_fro(a, r),
                   "ok": rel_fro(a, r) <= limit
                   and bool(torch.isfinite(a).all())}
            for name, a, r in zip(names, got, want)}


K7_OUTS = ("y", "dx", "dg", "dbl", "dw", "db")
K7_CASES = (  # (N, K, row mask): the main paths' shapes and a ragged N
    (64 * 127, 768, False),    # encoder QKV, a decode batch
    (64 * 127, 512, True),     # pointwise conv1, a decode batch
    (256 * 127, 768, False),   # encoder QKV, a training step
    (256 * 127, 512, True),    # pointwise conv1, a training step
    (256 * 33, 768, False),    # decoder self-attention, a training step
    (1000, 512, True))         # ragged against the 64- and 128-row blocks


def k7_inputs(n, k, masked, dtype, seed, d=256):
    """K7's arguments (x, g, bl, w [K, D], b), a row mask or None (a fifth
    of the rows off, as pad frames) and an upstream dy [N, K]."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + torch.randn(*shape, generator=g) * std).cuda()
    args = (rnd(n, d).to(dtype), rnd(d, std=0.1, mean=1.0), rnd(d, std=0.1),
            rnd(k, d, std=d ** -0.5).to(dtype), rnd(k, std=0.1))
    mask = ((torch.rand(n, generator=g) > 0.2).float().cuda() if masked
            else None)
    return args, mask, rnd(n, k).to(dtype)


def phase_k7(lnmm, bounds) -> tuple:
    """K7 forward and backward against the plain version and autograd
    through it on the card, D = 256, fp32 and bf16, at the main paths'
    shapes (K7_CASES); masked rows must come out as the bias; the same
    bits over 3 backward calls; in bf16 the times at the decode batch's
    QKV shape (forward) and the training step's (backward), the plain
    versions' and the bounds, and the forward's card time under each
    schedule at N = 8128 and 32512 (K = 768). Returns the (forward,
    backward) records."""
    rec_f, rec_b = {}, {}
    for n, k, masked in K7_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args, mask, dy = k7_inputs(n, k, masked, dtype, seed=n + k)
            y = lnmm.forward_kernel(*args, mask, 1e-5)
            got = [lnmm.backward_kernel(*args, mask, dy, 1e-5)
                   for _ in range(3)]
            torch.cuda.synchronize()
            same = all(torch.equal(p, q) for again in got[1:]
                       for p, q in zip(got[0], again))
            want_y = lnmm.ln_matmul_ref(*args, mask)
            want = lnmm.backward_ref(*args, mask, dy, 1e-5)
            limit = 1e-5 if dtype == torch.float32 else 1e-2
            errs = output_errors(K7_OUTS, (y, *got[0]), (want_y, *want),
                                 limit)
            bias_rows = True
            if masked:
                off = mask == 0
                bias_rows = bool(torch.equal(
                    y[off], args[4].to(dtype).expand(int(off.sum()), k)))
            ok = same and bias_rows and all(e["ok"] for e in errs.values())
            check(ok, f"k7 n={n} k={k} {dtype} masked={masked}: {errs}, "
                      f"same bits {same}, masked rows the bias {bias_rows}")
            line = {"n": n, "d": 256, "k": k, "masked": masked,
                    "dtype": str(dtype).split(".")[-1], "ok": ok,
                    "bwd_same_bits_over_3_calls": same,
                    "masked_rows_equal_bias": bias_rows, "errors": errs,
                    "tolerance": f"relative Frobenius <= {limit} against "
                                 "the plain version and autograd through "
                                 "it (fp32 sums in another order; bf16 "
                                 "rounding of LN(x) and dxn at other "
                                 "points)"}
            if dtype == torch.bfloat16 and k == 768 and n in (64 * 127,
                                                              256 * 127):
                line.update(k7_fwd_schedules(lnmm, args, mask, n, k))
            if dtype == torch.bfloat16 and (n, k) == (64 * 127, 768):
                ms = cuda_ms(lambda: lnmm.forward_kernel(*args, mask, 1e-5))
                plain = cuda_ms(lambda: lnmm.ln_matmul_ref(*args, mask))
                flops, nbytes = bounds.ln_matmul(n, 256, k, "bf16")
                bound, by = bounds.bound_ms(flops, nbytes, "bf16")
                line.update(fwd_ms=ms, fwd_plain_ms=plain,
                            fwd_bound_ms=bound, fwd_bound_by=by)
                rec_f = {"max_abs_err": errs["y"]["max_abs"], "ms": ms,
                         "plain_ms": plain, "bound_ms": bound,
                         "bound_by": by}
            if dtype == torch.bfloat16 and (n, k) == (256 * 127, 768):
                ms = cuda_ms(lambda: lnmm.backward_kernel(*args, mask, dy,
                                                          1e-5), iters=20)
                plain = cuda_ms(lambda: lnmm.backward_ref(*args, mask, dy,
                                                          1e-5), iters=10)
                flops, nbytes = bounds.ln_matmul_bwd(n, 256, k, "bf16")
                bound, by = bounds.bound_ms(flops, nbytes, "bf16")
                line.update(bwd_ms=ms, bwd_plain_ms=plain,
                            bwd_bound_ms=bound, bwd_bound_by=by)
                rec_b = {"max_abs_err": errs["dx"]["max_abs"], "ms": ms,
                         "plain_ms": plain, "bound_ms": bound,
                         "bound_by": by}
            emit("k7", **line)
    return rec_f, rec_b


def k7_fwd_schedules(lnmm, args, mask, n, k) -> dict:
    """K7's bf16 forward in card time (``device_ms``) under each schedule
    the kernel keeps: every 128-row block over all K output tiles (1
    column group) or over half of them (2), and the groups N gets."""
    out = {"fwd_groups_chosen": lnmm.fwd_schedule(n, k)}
    with torch.no_grad():
        for groups in (1, 2):
            lnmm.fwd_schedule(n, k, groups)
            out[f"fwd_device_ms_groups_{groups}"] = device_ms(
                lambda: lnmm.forward_kernel(*args, mask, 1e-5), iters=20)
    lnmm.fwd_schedule(n, k, -1)
    return out


K6_OUTS = ("y", "dx", "dw1", "db1", "dw2", "db2")
K6_CASES = (  # (N, activation): the post-norm path's shapes, a ragged N
    (64 * 127, "relu"), (256 * 127, "relu"), (256 * 33, "relu"),
    (1000, "swish"))


def k6_inputs(n, act, dtype, seed, eps=1e-4):
    """K6's arguments (x, w1 [F, D], b1, w2 [D, F], b2) and dy. For relu,
    rows with a pre-activation within eps of the kink are drawn anew until
    none is left: another summation order would flip relu' there."""
    args, dy = k1_inputs(n, dtype, seed)
    x, _, _, w1, b1, w2, b2 = args
    g = torch.Generator().manual_seed(seed + 1)
    for _ in range(20):
        if act != "relu":
            break
        z = x.float() @ w1.float().t() + b1
        bad = (z.abs() < eps).any(dim=1)
        if not bool(bad.any()):
            break
        x[bad] = torch.randn(int(bad.sum()), x.shape[1],
                             generator=g).cuda().to(dtype)
    else:
        check(False, f"k6 inputs n={n}: rows near relu's kink remain")
    return (x, w1, b1, w2, b2), dy


def k6_keep_rate(ffn, dropout, dtype, rate=0.1, seed=99, n=256 * 127,
                 d=256, f=2048, row_base: int = 0) -> dict:
    """The hidden mask's keep rate as K6's forward kernel draws it and
    whether each bit equals the plain mask function's: with W1 = 0,
    b1 = 2 (relu), W2 the identity on the hidden columns [k D, k D + D)
    and b2 = 0, y != 0 exactly where the mask kept one of those columns;
    k walks all F / D column groups. The backward's mask: with W2 = [I | 0]
    and dy = 1, db1 is each of the first D columns' kept count times
    1/keep. ``row_base`` as in kernel_keep_rates."""
    x = torch.randn(n, d, generator=torch.Generator().manual_seed(1)).cuda()
    x = x.to(dtype)
    w1 = torch.zeros(f, d, device="cuda", dtype=dtype)
    b1 = torch.full((f,), 2.0, device="cuda")
    b2 = torch.zeros(d, device="cuda")
    thresh, scale = dropout.threshold(rate)
    index = ((row_base + torch.arange(n, device="cuda")[:, None]) * f
             + torch.arange(f, device="cuda")[None, :])
    plain = dropout.keep_mask(seed, dropout.STREAM_FFN_HIDDEN, index, thresh)
    kept_n, equal = 0, True
    for k in range(f // d):
        w2 = torch.zeros(d, f, device="cuda", dtype=dtype)
        w2[:, k * d:(k + 1) * d] = torch.eye(d, device="cuda", dtype=dtype)
        kept = ffn.ffn_forward_kernel(x, w1, b1, w2, b2, "relu", rate,
                                      seed, row_base) != 0
        equal = equal and bool(torch.equal(kept, plain[:, k * d:(k + 1) * d]))
        kept_n += int(kept.sum())
    w2 = torch.zeros(d, f, device="cuda", dtype=dtype)
    w2[:, :d] = torch.eye(d, device="cuda", dtype=dtype)
    _, _, db1, _, _ = ffn.ffn_backward_kernel(
        x, torch.ones_like(x), w1, b1, w2, b2, "relu", rate, seed, row_base)
    counts = torch.round(db1[:d].double() / scale)
    return {"keep_rate": kept_n / plain.numel(), "draws": plain.numel(),
            "column_groups": f // d, "equals_plain_mask": equal,
            "bwd_counts_equal_plain": bool(torch.equal(
                counts, plain[:, :d].sum(0).double()))}


def phase_k6(ffn, bounds, dropout) -> tuple:
    """K6 forward and backward against the plain version and autograd
    through it on the card, D = 256, F = 2048, fp32 and bf16, rates 0 and
    0.1, at the post-norm path's shapes (K6_CASES); the same bits on a
    second forward and over 3 backward calls; the mask's bits and keep
    rate in fp32 and bf16; in bf16 the times at N = 8128 (forward, rate 0)
    and 32512 (forward and backward, rate 0.1), the plain versions' and
    the bounds, and the backward split into its passes. Returns the
    (forward, backward) records."""
    rec_f, rec_b = {}, {}
    for n, act in K6_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args, dy = k6_inputs(n, act, dtype, seed=n + 7)
            for rate in (0.0, 0.1):
                cfg = (act, rate, 4242)
                y = ffn.ffn_forward_kernel(*args, *cfg)
                y_again = ffn.ffn_forward_kernel(*args, *cfg)
                got = [ffn.ffn_backward_kernel(args[0], dy, *args[1:], *cfg)
                       for _ in range(3)]
                torch.cuda.synchronize()
                same = torch.equal(y, y_again) and all(
                    torch.equal(p, q) for again in got[1:]
                    for p, q in zip(got[0], again))
                want = (ffn.ffn_fused_ref(*args, *cfg),
                        *ffn.ffn_backward_ref(args[0], dy, *args[1:], *cfg))
                limit = 1e-5 if dtype == torch.float32 else 1e-2
                errs = output_errors(K6_OUTS, (y, *got[0]), want, limit)
                ok = same and all(e["ok"] for e in errs.values())
                check(ok, f"k6 n={n} {act} {dtype} rate={rate}: {errs}, "
                          f"same bits {same}")
                line = {"n": n, "d": 256, "f": 2048, "activation": act,
                        "dtype": str(dtype).split(".")[-1], "rate": rate,
                        "ok": ok, "same_bits_fwd_twice_bwd_3_calls": same,
                        "errors": errs,
                        "tolerance": f"relative Frobenius <= {limit} "
                                     "against the plain version and "
                                     "autograd through it, the same mask "
                                     "(fp32 sums in another order, relu "
                                     "inputs redrawn off the kink; bf16 "
                                     "rounding of dh and dz1 at other "
                                     "points)"}
                bf = dtype == torch.bfloat16
                if bf and rate == 0 and n == 64 * 127:
                    ms = cuda_ms(lambda: ffn.ffn_forward_kernel(*args, *cfg))
                    plain = cuda_ms(lambda: ffn.ffn_fused_ref(*args, *cfg))
                    flops, nbytes = bounds.ffn_fused(n, 256, 2048, "bf16")
                    bound, by = bounds.bound_ms(flops, nbytes, "bf16")
                    line.update(fwd_ms=ms, fwd_plain_ms=plain,
                                fwd_bound_ms=bound, fwd_bound_by=by)
                    rec_f.update(max_abs_err=errs["y"]["max_abs"], ms=ms,
                                 plain_ms=plain, bound_ms=bound, bound_by=by)
                if bf and rate > 0 and n == 256 * 127:
                    ms = cuda_ms(lambda: ffn.ffn_forward_kernel(*args, *cfg))
                    plain = cuda_ms(lambda: ffn.ffn_fused_ref(*args, *cfg),
                                    iters=10)
                    flops, nbytes = bounds.ffn_fused(n, 256, 2048, "bf16")
                    bound, by = bounds.bound_ms(flops, nbytes, "bf16")
                    line.update(fwd_ms=ms, fwd_plain_ms=plain,
                                fwd_bound_ms=bound, fwd_bound_by=by)
                    rec_f.update(ms_n32512=ms, plain_ms_n32512=plain,
                                 bound_ms_n32512=bound)
                    ms = cuda_ms(lambda: ffn.ffn_backward_kernel(
                        args[0], dy, *args[1:], *cfg), iters=20)
                    plain = cuda_ms(lambda: ffn.ffn_backward_ref(
                        args[0], dy, *args[1:], *cfg), iters=10)
                    flops, nbytes = bounds.ffn_fused_bwd(n, 256, 2048,
                                                         "bf16")
                    bound, by = bounds.bound_ms(flops, nbytes, "bf16")
                    passes = device_passes(lambda: ffn.ffn_backward_kernel(
                        args[0], dy, *args[1:], *cfg), launches=6)
                    split = {k: v for k, v in passes.items()
                             if k.startswith(("pass_", "partial_"))}
                    line.update(bwd_ms=ms, bwd_plain_ms=plain,
                                bwd_bound_ms=bound, bwd_bound_by=by,
                                bwd_device_ms=passes["device_ms"],
                                bwd_profile_complete=passes[
                                    "profile_complete"],
                                bwd_profile_intervals=passes["intervals"],
                                **split)
                    rec_b = {"max_abs_err": errs["dx"]["max_abs"], "ms": ms,
                             "plain_ms": plain, "bound_ms": bound,
                             "bound_by": by, **split}
                emit("k6", **line)
    for dtype in (torch.float32, torch.bfloat16):
        keep = k6_keep_rate(ffn, dropout, dtype)
        sigma = (0.9 * 0.1 / keep["draws"]) ** 0.5
        check(keep["equals_plain_mask"] and keep["bwd_counts_equal_plain"]
              and abs(keep["keep_rate"] - 0.9) < 5 * sigma,
              f"k6 mask {dtype}: {keep}")
        emit("k6_mask", rate=0.1, expected_keep=0.9,
             dtype=str(dtype).split(".")[-1], **keep,
             tolerance="forward bit-equal to the plain mask on every hidden "
                       "column, keep rate within 5 sigma of 0.9; the "
                       "backward's kept count of each of the first D hidden "
                       "columns (db1 * keep, rounded) equal to the plain "
                       "mask's")
    return rec_f, rec_b


# The rows a second rank holds at D1's and D2's splits: K1/K6's rows of
# the encoder (B utterances of 127 frames), K4's and K8's utterances, and
# the whole batch K4's step-major index counts.
ROW_BASE_CASES = (  # (name, rows, row base, whole batch, dtype)
    ("d1_fp32", 8, 8, 16, torch.float32),
    ("d2_bf16", 128, 128, 256, torch.bfloat16),
)


def row_base_grads(name, got, want, local, limit) -> dict:
    """The kernel's gradients against autograd through the plain version
    at the same row base (relative Frobenius <= ``limit``), and the plain
    version at row base 0 (the rank's own indices) away from them: a
    backward that drew its masks at local indices fails the first."""
    errs = {n: rel_fro(a, r) for n, a, r in zip(name, got, want)}
    apart = max(rel_fro(a, r) for a, r in zip(got, local))
    ok = all(e <= limit for e in errs.values()) and apart > 10 * limit
    return {"rel_fro": errs, "rel_fro_to_local_indices": apart, "ok": ok}


def phase_row_base(ffn, lstm, conv, dropout) -> None:
    """K1/K6, K4 and K8 as the second of two ranks calls them: its rows
    start at a nonzero global row base (K4 also takes the whole batch),
    so its masks must be the whole batch's rows. The forward masks bit
    for bit against the plain mask function at the global indices (K1:
    kernel_keep_rates, K6: k6_keep_rate with its backward's mask counts,
    K4: the mask its forward saves, K8: conv_keep_rate); the backwards
    against autograd through the plain version at the same base, and
    away from the plain version at the rank's local indices."""
    seed = 4243
    for name, b, base, whole, dtype in ROW_BASE_CASES:
        dt = str(dtype).split(".")[-1]
        limit = 1e-4 if dtype == torch.float32 else 2e-2
        n, nb = b * 127, base * 127
        keep = kernel_keep_rates(ffn, dropout, n=n, row_base=nb)
        k6 = k6_keep_rate(ffn, dropout, dtype, n=n, row_base=nb)
        args, dy = k1_inputs(n, dtype, seed=n + 1)
        cfg = ("swish", 0.5, 1e-5, 0.1, 0.1, seed)
        got = ffn.backward_kernel(args[0], dy, *args[1:], *cfg, nb)
        k1 = row_base_grads(K1_GRADS[1:], got, ffn.backward_ref(
            args[0], dy, *args[1:], *cfg, nb), ffn.backward_ref(
            args[0], dy, *args[1:], *cfg, 0), max(limit, 1e-3))
        x6, dy6 = k6_inputs(n, "swish", dtype, seed=n + 2)
        got6 = ffn.ffn_backward_kernel(x6[0], dy6, *x6[1:], "swish", 0.1,
                                       seed, nb)
        k6b = row_base_grads(("dx", "dw1", "db1", "dw2", "db2"), got6,
                             ffn.ffn_backward_ref(x6[0], dy6, *x6[1:],
                                                  "swish", 0.1, seed, nb),
                             ffn.ffn_backward_ref(x6[0], dy6, *x6[1:],
                                                  "swish", 0.1, seed, 0),
                             max(limit, 1e-3))
        largs, ldy = lstm_inputs(b, 33, 256, dtype, seed=b + 7)
        _, saved = lstm.forward_kernel(*largs, 0.1, seed, save=True,
                                       row_base=base, global_b=whole)
        lkeep = saved[3] != 0
        lplain = dropout.keep_mask(
            seed, dropout.STREAM_LSTM_INTER,
            (torch.arange(33, device="cuda")[None, :, None] * whole
             + base + torch.arange(b, device="cuda")[:, None, None]) * 256
            + torch.arange(256, device="cuda")[None, None, :],
            dropout.threshold(0.1)[0])
        k4 = row_base_grads(
            K4_GRADS, lstm.backward_kernel(ldy, *largs, saved, 0.1, seed,
                                           row_base=base, global_b=whole),
            lstm.backward_ref(ldy, *largs, 0.1, seed, base, whole),
            lstm.backward_ref(ldy, *largs, 0.1, seed), limit)
        k4["mask_equals_plain"] = bool(torch.equal(lkeep, lplain))
        cb = min(b, 32)
        k8 = conv_keep_rate(conv, dropout, b=cb, dtype=dtype, row_base=cb)
        x, mask, params, cdy = conv_inputs(cb, 127, 256, 15, dtype, seed=3)
        ccfg = (seed, False, 0.1, 1e-5)
        k8b = row_base_grads(
            K8_OUTS[1:], conv.backward_kernel(x, mask, *params, cdy, *ccfg,
                                              cb),
            conv.backward_ref(x, mask, *params, cdy, *ccfg, cb),
            conv.backward_ref(x, mask, *params, cdy, *ccfg, 0), limit)
        torch.cuda.synchronize()
        ok = (all(r["equals_plain_mask"] for r in keep.values())
              and k6["equals_plain_mask"] and k6["bwd_counts_equal_plain"]
              and k4["mask_equals_plain"] and k8["equals_plain_mask"]
              and k1["ok"] and k6b["ok"] and k4["ok"] and k8b["ok"])
        check(ok, f"row_base {name}: K1 {keep} {k1}, K6 {k6} {k6b}, K4 "
                  f"{k4}, K8 {k8} {k8b}")
        emit("row_base", case=name, dtype=dt, rows=b, row_base=base,
             whole_batch=whole, k1_rows=n, k1_row_base=nb, ok=ok,
             k1_masks=keep, k1_bwd=k1, k6_mask=k6, k6_bwd=k6b, k4_bwd=k4,
             k8_mask=k8, k8_rows=cb, k8_row_base=cb, k8_bwd=k8b,
             tolerance="forward masks bit-equal to the plain mask at the "
                       "global indices; backwards relative Frobenius <= "
                       f"{max(limit, 1e-3)} (K1, K6) and {limit} (K4, K8) "
                       "against the plain version at the same base, and "
                       "over 10 times that from the plain version at the "
                       "rank's own indices")


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


def subsampled(frames: int) -> int:
    """Encoder frames after the conv2d subsampling (x4)."""
    return ((frames - 3) // 2 + 1 - 3) // 2 + 1


def load_train_wavs():
    """The committed train-clean-100 WAVs through the port's numpy fbank,
    with character tokens from ``text`` (ids 1.. in sorted character
    order, 0 is blank, labels padded with -1). Utterances whose characters
    (plus one blank between repeats) outnumber their subsampled frames
    cannot be aligned by CTC and are left out. Returns the padded numpy
    batch and the count left out."""
    from wenet_celoss_tpu_torch.data.wav import read_wav
    from wenet_celoss_tpu_torch.ops.fbank import compute_fbank_np
    text = dict(line.rstrip("\n").split(" ", 1)
                for line in (TRAIN_DIR / "text").read_text().splitlines())
    ids = {c: i + 1 for i, c in enumerate(sorted(set("".join(
        text.values()))))}
    feats, labels, dropped = [], [], 0
    for p in sorted((TRAIN_DIR / "wavs").glob("*.wav")):
        wav, sr = read_wav(str(p))
        if sr != 16000:
            raise ValueError(f"{p}: sample rate {sr}")
        fb = compute_fbank_np(wav)
        chars = text[p.stem]
        frames = subsampled(len(fb))
        if frames < len(chars) + sum(a == b for a, b in zip(chars,
                                                             chars[1:])):
            dropped += 1
            continue
        feats.append(fb)
        labels.append([ids[c] for c in chars])
    return pad_batch(feats, labels), dropped


def pad_batch(feats, labels):
    lens = np.array([len(x) for x in feats], np.int64)
    llen = np.array([len(y) for y in labels], np.int64)
    batch = {"feats": np.zeros((len(feats), lens.max(), 80), np.float32),
             "feat_lengths": lens,
             "labels": np.full((len(labels), llen.max()), -1, np.int64),
             "label_lengths": llen}
    for i, (x, y) in enumerate(zip(feats, labels)):
        batch["feats"][i, :len(x)] = x
        batch["labels"][i, :len(y)] = y
    return batch


def head(batch, n: int):
    """The first n utterances, re-padded."""
    lens, llen = batch["feat_lengths"][:n], batch["label_lengths"][:n]
    return {"feats": batch["feats"][:n, :lens.max()], "feat_lengths": lens,
            "labels": batch["labels"][:n, :llen.max()],
            "label_lengths": llen}


def on(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


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


def phase_slice(init_model, Decoder, conformer_rnnt_bias, ffn, refs):
    """Full-width fp32 decode of the committed WAVs on the card, held
    against the same model on the CPU (its runs from the CPU references'
    process, ``refs_s1``). Returns the kernel launches of the main path
    and what conv_decode needs to decode the same WAVs with the same
    model and compare with the same CPU run."""
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

    with torch.no_grad():
        enc_card, _, _, mask = model.encode_transducer(
            torch.as_tensor(feats, device="cuda"),
            torch.as_tensor(lens, device="cuda"))
    ref = refs_result(refs, "s1")
    mask = mask.cpu()
    enc_err = float((enc_card.cpu() - ref["enc"])[mask].abs().max())
    check(enc_err <= 1e-3, f"slice encoder card vs CPU max abs {enc_err}")
    cpu_runs = ref["runs"]
    for mode in MODES:
        cpu, trace = cpu_runs[mode]
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
    return total, (dec, feats, lens, ctx, ctx_lens, cpu_runs, refs)


def refs_s1(spec: dict):
    """S1's and S1-lnmm's CPU side (in the CPU references' process): S1's
    model (seed 0, blank bias +3.0) on the CPU, its encoder output over
    the 16 WAVs and each mode's decode with its top-2 gaps; the same
    under LNMM_PALLAS=1 (K7's plain version)."""
    from wenet_celoss_tpu_torch.configs import conformer_rnnt_bias
    from wenet_celoss_tpu_torch.decode.api import Decoder
    from wenet_celoss_tpu_torch.models.factory import init_model
    cfg = conformer_rnnt_bias()
    _, feats, lens = load_wavs()
    ctx, ctx_lens = hotwords(cfg["output_dim"])
    model = with_blank_bias(init_model(cfg, device="cpu", seed=0),
                            SLICE_BLANK_BIAS)
    cpu_dec = Decoder(model, device="cpu")
    with torch.no_grad():
        enc = model.encode_transducer(torch.as_tensor(feats),
                                      torch.as_tensor(lens))[0]
    for key, env in (("s1", {}), ("s1_lnmm", LNMM)):
        runs = {}
        with routes(**env):
            for mode in MODES:
                trace: list = []
                runs[mode] = (decode(cpu_dec, feats, lens, ctx, ctx_lens,
                                     mode, trace), trace)
        yield key, {"runs": runs, **({"enc": enc} if key == "s1" else {})}



@contextlib.contextmanager
def routes(**env):
    """The given switches in the environment for the block (each is read
    at every forward): CONV sends every layer_norm conv block of the
    encoder through K8, LNMM every pre-norm QKV projection and pointwise
    conv1 through K7 (K8 first where both apply)."""
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


CONV = {"CONV_PALLAS": "1"}
LNMM = {"LNMM_PALLAS": "1"}


def phase_conv_decode(slice_run, conv) -> int:
    """S1 with CONV_PALLAS=1: the same model and WAVs decoded on the card
    with every conv block through K8, held against S1's CPU run (unfused
    conv module) by the same flip rule; 12 K8 launches per encoder pass.
    Returns K8's launches on this path."""
    dec, feats, lens, ctx, ctx_lens, cpu_runs, _ = slice_run
    conv.conv_block_residual.launches = 0     # the path starts here
    conv.conv_block_residual.bwd_launches = 0
    launches = {}
    with routes(**CONV):
        for mode in MODES:
            before = conv.conv_block_residual.launches
            card = decode(dec, feats, lens, ctx, ctx_lens, mode)
            torch.cuda.synchronize()
            launches[mode] = conv.conv_block_residual.launches - before
            cpu, trace = cpu_runs[mode]
            same, ties, bad = compare(card, cpu, trace)
            passes = 1 if mode == "plain" else 2
            check(not bad, f"conv_decode {mode}: card and CPU differ away "
                           f"from a near tie: {bad}")
            check(launches[mode] == passes * K8_PER_ENCODER_PASS,
                  f"conv_decode {mode}: {launches[mode]} K8 launches, want "
                  f"{passes * K8_PER_ENCODER_PASS}")
            emit("conv_decode", mode=mode, utterances=len(lens),
                 tokens=sum(map(len, card[0])), identical_to_cpu=same,
                 near_tie_flips=ties, other_diffs=bad,
                 k8_launches=launches[mode],
                 k8_bwd_launches=conv.conv_block_residual.bwd_launches)
    total = conv.conv_block_residual.launches  # ... and ends here
    check(conv.conv_block_residual.bwd_launches == 0,
          "conv_decode launched K8's backward")
    return total


def phase_lnmm_decode(slice_run, lnmm, conv) -> int:
    """S1-lnmm: S1 with LNMM_PALLAS=1, the same model and WAVs decoded on
    the card with every self-attention's pre-norm and QKV projection and
    every conv block's pre-norm and pointwise conv1 through K7, held
    against the CPU run under the same switch (K7's plain version, from
    the CPU references' process) by S1's flip rule; 24 K7 launches per
    encoder pass. Then a plain decode with CONV_PALLAS=1 as well, where
    K8 takes the conv blocks first: 12 K7 and 12 K8 launches. Returns
    K7's launches with LNMM_PALLAS=1 alone."""
    dec, feats, lens, ctx, ctx_lens, s1_cpu_runs, refs = slice_run
    lm = lnmm.ln_matmul
    lm.launches = lm.bwd_launches = 0          # the path starts here
    cards = {}
    with routes(**LNMM):
        for mode in MODES:
            before = lm.launches
            cards[mode] = (decode(dec, feats, lens, ctx, ctx_lens, mode),
                           lm.launches - before)
            torch.cuda.synchronize()
    total = lm.launches                        # ... and ends here
    cpu_runs = refs_result(refs, "s1_lnmm")["runs"]
    for mode in MODES:
        card, n = cards[mode]
        cpu, trace = cpu_runs[mode]
        same, ties, bad = compare(card, cpu, trace)
        passes = 1 if mode == "plain" else 2
        check(not bad, f"lnmm_decode {mode}: card and CPU differ away "
                       f"from a near tie: {bad}")
        check(n == passes * K7_PER_ENCODER_PASS,
              f"lnmm_decode {mode}: {n} K7 launches, want "
              f"{passes * K7_PER_ENCODER_PASS}")
        emit("lnmm_decode", mode=mode, utterances=len(lens),
             tokens=sum(map(len, card[0])), identical_to_cpu=same,
             near_tie_flips=ties, other_diffs=bad, k7_launches=n,
             k7_bwd_launches=lm.bwd_launches,
             cpu_same_as_unswitched_cpu=cpu_runs[mode][0]
             == s1_cpu_runs[mode][0])
    check(lm.bwd_launches == 0, "lnmm_decode launched K7's backward")
    k8 = conv.conv_block_residual
    before = (lm.launches, k8.launches)
    with routes(**LNMM, **CONV):
        card = decode(dec, feats, lens, ctx, ctx_lens, "plain")
        torch.cuda.synchronize()
    both = (lm.launches - before[0], k8.launches - before[1])
    cpu, trace = cpu_runs["plain"]
    same, ties, bad = compare(card, cpu, trace)
    check(not bad and both == (12, K8_PER_ENCODER_PASS),
          f"lnmm_decode with CONV_PALLAS=1: K7, K8 launches {both}, want "
          f"(12, 12); diffs away from a near tie {bad}")
    emit("lnmm_decode", mode="plain", conv_pallas=True, k7_launches=both[0],
         k8_launches=both[1], identical_to_cpu=same, near_tie_flips=ties,
         other_diffs=bad)
    return total



def card_intervals(prof) -> list:
    """The card's intervals (kernels and copies) a profile recorded, as
    (name, start ns, end ns), read from the profiler's raw records: its
    event tree (``events()``) takes far longer to build than a profiled
    decode or step takes to run."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def device_events(prof) -> int:
    """How many card intervals (kernels and copies) a profile recorded."""
    return len(card_intervals(prof))


def device_busy(prof):
    """The card's busy time (union of its kernel and copy intervals, ms)
    and the ms per kernel name, from a profiler run."""
    spans, by_name = [], {}
    for name, start, stop in card_intervals(prof):
        spans.append((start, stop))
        by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e6
    busy, end = 0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e6, by_name


def device_profile(fn, iters: int, want: int):
    """torch.profiler over ``iters`` calls of ``fn`` → (the profile, whether
    it holds all ``want`` card intervals the calls make). The profiler now
    and then drops card intervals, some or all of them: it profiles again
    until it has them all, else it keeps, of four profiles, the one with
    the most."""
    from torch.profiler import ProfilerActivity, profile
    best, best_n = None, -1
    for _ in range(4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        n = device_events(prof)
        if n > best_n:
            best, best_n = prof, n
        if n >= want:
            break
    return best, best_n >= want


_SLEEP_CYCLES_PER_MS: list = []


def sleep_cycles_per_ms() -> float:
    """How many cycles of ``torch.cuda._sleep`` take a millisecond on this
    card (measured once with CUDA events)."""
    if not _SLEEP_CYCLES_PER_MS:
        cycles = 20_000_000
        torch.cuda._sleep(cycles // 10)           # warm the spin kernel
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(cycles / start.elapsed_time(end))
    return _SLEEP_CYCLES_PER_MS[0]


def device_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """The card's ms per call of ``fn`` with its calls run back to back:
    CUDA events around ``iters`` calls that the host queues behind a spin
    kernel (``torch.cuda._sleep``) lasting longer than the host takes to
    launch them, so the host's launch gaps between small kernels are left
    out. The start event must still be pending once every call is queued;
    if it is not, the spin was too short and the run is made again with a
    spin four times as long. It does not rest on torch.profiler, which
    now and then drops some or all card intervals."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin_ms = 2.0 * host_ms + 1.0
    for _ in range(4):
        torch.cuda._sleep(int(spin_ms * sleep_cycles_per_ms()))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ahead = not start.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters
        spin_ms *= 4.0
    check(False, f"device_ms: the host did not queue {iters} calls within a "
                 f"{spin_ms / 4.0:.1f} ms spin")
    return start.elapsed_time(end) / iters


def busy_ms(fn, iters: int = 10, profiles: int = 3) -> float:
    """The card's busy ms per call of ``fn``: the union of its card
    intervals under torch.profiler over ``iters`` calls, the median of
    ``profiles`` profiles. For a call that synchronises with the host
    inside (cuDNN's LSTM does), which ``device_ms`` cannot queue ahead."""
    for _ in range(2):
        fn()
    runs = []
    for _ in range(profiles):
        prof, _ = device_profile(fn, iters, want=1)
        runs.append(device_busy(prof)[0] / iters)
    return statistics.median(runs)


def stage_ms(fn, stages, iters: int = 10) -> dict:
    """``fn``'s card ms per call split by stage under torch.profiler;
    ``stages`` holds (name, substrings of its kernels' names, launches a
    call). Each stage is the mean of its recorded intervals times its
    launches a call, so a profile that dropped some intervals (the
    profiler does now and then) still gives it; a stage with no recorded
    interval in four profiles is not measured (null)."""
    want = sum(n for *_, n in stages) * iters
    prof, complete = device_profile(fn, iters, want=want)
    spans = {name: [] for name, *_ in stages}
    for kernel, start, stop in card_intervals(prof):
        for name, keys, _ in stages:
            if all(k in kernel for k in keys):
                spans[name].append((stop - start) / 1e6)
    out = {name + "_ms": (sum(spans[name]) / len(spans[name]) * n
                          if spans[name] else None)
           for name, _, n in stages}
    out.update(profile_complete=complete,
               intervals=f"{device_events(prof)} card intervals recorded "
                         f"for {want} launches")
    return out


def device_passes(fn, launches: int, iters: int = 10) -> dict:
    """A two-pass bf16 backward (K1's, K6's or K3's: ``launches`` kernels a
    call, pass A, pass B and the fixed-order partial sums): its card ms
    per call from ``device_ms``, and each pass's from ``stage_ms``."""
    return {"device_ms": device_ms(fn, iters=iters),
            **stage_ms(fn, (("pass_a", ("bwd_rows",), 1),
                            ("pass_b", ("bwd_weights",), 1),
                            ("partial_sums", ("sum_partials",),
                             launches - 2)), iters)}


def phase_k8_device(conv, bounds, fwd_rec: dict, bwd_rec: dict) -> None:
    """K8 in card time (``device_ms``), bf16, non-causal, D=256, K=15:
    the conv16 kernels and the port's unfused block, in that order at each
    shape: forwards at N = 64*127 (rate 0, decode) and 256*127 (rates 0
    and 0.1, T7's shape), the backward at 256*127 (rate 0.1; the unfused
    block's: forward + backward less forward), and K8's backward split by
    pass (``stage_ms``, taken again, up to three times, until its profile
    holds every interval). Event times of the unfused
    block at N = 64*127 carry about ten host launches, so the kernels
    line's ``library_ms`` takes these card times and keeps the event times
    as ``library_event_ms``."""
    d, k, t = 256, 15, 127
    cfg = (4242, False, 0.1, 1e-5)
    line = {}
    for b, seed, rates in ((64, 1, (0.0,)), (256, 2, (0.0, 0.1))):
        x, mask, params, dy = conv_inputs(b, t, d, k, torch.bfloat16, seed)
        block, weights = unfused_block((x, mask, params), x.dtype)
        flops, nbytes = bounds.conv_block_residual(b * t, d, k, "bf16")
        bound, _ = bounds.bound_ms(flops, nbytes, "bf16")
        with torch.no_grad():
            unfused = device_ms(lambda: block(x), iters=20)
            for rate in rates:
                c = (cfg[0], False, rate, cfg[3])
                new = device_ms(lambda: conv.forward_kernel(
                    x, mask, *params, *c), iters=20)
                line[f"fwd_n{b * t}_rate{rate}"] = {
                    "k8_ms": new, "unfused_ms": unfused,
                    "factor": new / unfused, "bound_ms": bound, "share_of_bound": bound / new}
    xg = x.detach().requires_grad_(True)

    def both():
        torch.autograd.grad(block(xg), [xg] + weights, dy)
    unfused_both = device_ms(both)
    unfused_bwd = unfused_both - line[f"fwd_n{256 * t}_rate0.0"]["unfused_ms"]
    flops, nbytes = bounds.conv_block_residual_bwd(256 * t, d, k, "bf16")
    bound, _ = bounds.bound_ms(flops, nbytes, "bf16")

    def bwd():
        conv.backward_kernel(x, mask, *params, dy, *cfg)
    new = device_ms(bwd)
    for _ in range(3):
        passes = stage_ms(bwd, K8_BWD_STAGES)
        if passes["profile_complete"]:
            break
    line[f"bwd_n{256 * t}"] = {
        "k8_ms": new, "unfused_ms": unfused_bwd,
        "unfused_fwd_and_bwd_ms": unfused_both, "factor": new / unfused_bwd,
        "bound_ms": bound, "share_of_bound": bound / new,
        "k8_passes": passes}
    for rec, key in ((fwd_rec, f"fwd_n{64 * t}_rate0.0"),
                     (bwd_rec, f"bwd_n{256 * t}")):
        rec.update(device_ms=line[key]["k8_ms"],
                   library_event_ms=rec["library_ms"],
                   library_ms=line[key]["unfused_ms"])
    fwd_rec.update(
        device_ms_n32512_rate01=line[f"fwd_n{256 * t}_rate0.1"]["k8_ms"])
    emit("k8_device", **line,
         how="card ms per call, calls back to back (device_ms: CUDA "
             "events behind a spin kernel); backward at dropout 0.1, the "
             "unfused block without dropout")


def phase_k8_causal_device(conv, bounds, fwd_rec: dict,
                           bwd_rec: dict) -> None:
    """K8 causal, the U2++ conv block's route under CONV_PALLAS=1, in card
    time (``device_ms``), bf16, D=256, K=15, against the port's unfused
    causal block in the same call: the forward at N = 64*127 (rate 0) and
    256*127 (rate 0.1, T11-conv's shape), the backward at 256*127 (rate
    0.1; the unfused block's forward + backward less forward). The
    readings join K8's records under ``causal_*`` keys."""
    d, k, t = 256, 15, 127
    line = {}
    for b, seed, rate in ((64, 1, 0.0), (256, 2, 0.1)):
        cfg = (4242, True, rate, 1e-5)
        x, mask, params, dy = conv_inputs(b, t, d, k, torch.bfloat16, seed)
        block, weights = unfused_block((x, mask, params), x.dtype,
                                       causal=True)
        flops, nbytes = bounds.conv_block_residual(b * t, d, k, "bf16")
        bound, by = bounds.bound_ms(flops, nbytes, "bf16")
        with torch.no_grad():
            unfused = device_ms(lambda: block(x), iters=20)
            new = device_ms(lambda: conv.forward_kernel(
                x, mask, *params, *cfg), iters=20)
        line[f"fwd_n{b * t}_rate{rate}"] = {
            "k8_ms": new, "unfused_ms": unfused, "factor": new / unfused,
            "bound_ms": bound, "bound_by": by,
            "share_of_bound": bound / new}
    xg = x.detach().requires_grad_(True)

    def both():
        torch.autograd.grad(block(xg), [xg] + weights, dy)
    unfused_both = device_ms(both)
    unfused_bwd = unfused_both - line[f"fwd_n{256 * t}_rate0.1"][
        "unfused_ms"]
    flops, nbytes = bounds.conv_block_residual_bwd(256 * t, d, k, "bf16")
    bound, by = bounds.bound_ms(flops, nbytes, "bf16")
    new = device_ms(lambda: conv.backward_kernel(x, mask, *params, dy,
                                                 *cfg))
    line[f"bwd_n{256 * t}"] = {
        "k8_ms": new, "unfused_ms": unfused_bwd,
        "unfused_fwd_and_bwd_ms": unfused_both, "factor": new / unfused_bwd,
        "bound_ms": bound, "bound_by": by, "share_of_bound": bound / new}
    fwd_rec.update(
        causal_device_ms=line[f"fwd_n{64 * t}_rate0.0"]["k8_ms"],
        causal_library_ms=line[f"fwd_n{64 * t}_rate0.0"]["unfused_ms"],
        causal_device_ms_n32512_rate01=line[f"fwd_n{256 * t}_rate0.1"][
            "k8_ms"])
    bwd_rec.update(causal_device_ms=new, causal_library_ms=unfused_bwd)
    emit("k8_causal_device", **line,
         how="card ms per call, calls back to back (device_ms); the "
             "unfused causal block (LayerNorm, causal ConvolutionModule, "
             "residual; no dropout) in the same call")


def phase_k6_k7_device(ffn, lnmm, k6_recs, k7_recs) -> None:
    """K6 and K7 against the port's own unfused compositions in card time
    (``device_ms``), bf16, the phases' timed shapes: K7 at N = 8128, K = 768
    forward (the port's LayerNorm, F.layer_norm in fp32 cast to bf16, then
    F.linear) and N = 32512 backward; K6 at N = 8128 forward (two
    F.linear and relu), and at N = 32512 forward and backward at rate 0.1
    (the composition without dropout). A backward's yardstick is forward +
    backward less forward. These card times are the kernels line's
    ``library_ms``."""
    import torch.nn.functional as F
    line = {}

    def lnmm_unfused(x, g, bl, w, b):
        xn = F.layer_norm(x.float(), (x.shape[1],), g, bl, 1e-5)
        return F.linear(xn.to(x.dtype), w, b.to(x.dtype))

    def ffn_unfused(x, w1, b1, w2, b2):
        h = torch.relu(F.linear(x, w1, b1.to(x.dtype)))
        return F.linear(h, w2, b2.to(x.dtype))

    def k7_args(n):
        args, _, dy = k7_inputs(n, 768, False, torch.bfloat16, seed=n + 768)
        return args, dy

    def k6_args(n):
        return k6_inputs(n, "relu", torch.bfloat16, seed=n + 7)

    for name, fwd_kernel, bwd_kernel, unfused, inputs in (
            ("k7", lambda a, dy: lnmm.forward_kernel(*a, None, 1e-5),
             lambda a, dy: lnmm.backward_kernel(*a, None, dy, 1e-5),
             lnmm_unfused, k7_args),
            ("k6", lambda a, dy: ffn.ffn_forward_kernel(*a, "relu", 0.0, 1),
             lambda a, dy: ffn.ffn_backward_kernel(a[0], dy, *a[1:], "relu",
                                                   0.1, 1),
             ffn_unfused, k6_args)):
        args, dy = inputs(64 * 127)
        with torch.no_grad():
            fwd = {"kernel_ms": device_ms(lambda: fwd_kernel(args, dy),
                                          iters=20),
                   "unfused_ms": device_ms(lambda: unfused(*args), iters=20)}
        args, dy = inputs(256 * 127)
        ins = [a.detach().requires_grad_(True) for a in args]
        with torch.no_grad():
            unfused_fwd = device_ms(lambda: unfused(*args))
            if name == "k6":   # the training point, rate 0.1
                line["k6_fwd_n32512"] = {
                    "kernel_ms": device_ms(lambda: ffn.ffn_forward_kernel(
                        *args, "relu", 0.1, 1), iters=20),
                    "unfused_ms": unfused_fwd}
                k6_recs[0].update(
                    device_ms_n32512=line["k6_fwd_n32512"]["kernel_ms"],
                    library_ms_n32512=unfused_fwd)

        def both():
            torch.autograd.grad(unfused(*ins), ins, dy)
        unfused_both = device_ms(both)
        bwd = {"kernel_ms": device_ms(lambda: bwd_kernel(args, dy))}
        bwd.update(unfused_ms=unfused_both - unfused_fwd,
                   unfused_fwd_and_bwd_ms=unfused_both)
        line[name] = {"fwd_n8128": fwd, "bwd_n32512": bwd}
        for rec, part in zip(k6_recs if name == "k6" else k7_recs,
                             (fwd, bwd)):
            rec.update(device_ms=part["kernel_ms"],
                       library_ms=part["unfused_ms"])
    emit("k6_k7_device", **line,
         how="card ms per call, calls back to back (device_ms: CUDA "
             "events behind a spin kernel); K6's backward at dropout 0.1, "
             "the unfused composition without dropout")


def phase_profile(dec, feats, lens, ctx, ctx_lens, mode: str,
                  blank_bias: float, timed_ms: float, env=None) -> None:
    """One decode under torch.profiler: the card's busy time, its idle
    share of the unprofiled time ``timed_ms`` (the profiler slows the
    host) and of the profiled wall time, K1's time, and the kernels that
    take the most. Run after every timing: the profiler slows what
    follows it in the process."""
    from torch.profiler import ProfilerActivity, profile
    env = env or {}
    with routes(**env), profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode(dec, feats, lens, ctx, ctx_lens, mode)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, by_name = device_busy(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit("profile", mode=mode, switches=env, blank_bias=blank_bias,
         timed_ms=timed_ms, profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
         idle_share=1.0 - busy_ms / timed_ms,
         idle_share_profiled=1.0 - busy_ms / wall_ms,
         k1_ms=sum(v for k, v in by_name.items()
                   if any(key in k for key in FFN_FWD_KERNELS)),
         k7_ms=sum(v for k, v in by_name.items()
                   if any(key in k for key in K7_FWD_KERNELS)),
         kernels=len(by_name),
         top=[{"kernel": k[:90], "ms": v} for k, v in top])


def bench_setup(init_model, Decoder, conformer_rnnt_bias, blank_bias,
                b: int = 64, t: int = 512):
    """The bf16 flagship with the blank bias, its Decoder, random fbank
    [B, T, 80] at full length and 8 hotwords."""
    cfg = conformer_rnnt_bias()
    cfg["dtype"] = "bfloat16"
    rng = np.random.default_rng(0)
    feats = torch.as_tensor(rng.standard_normal((b, t, 80)),
                            dtype=torch.float32, device="cuda")
    lens = torch.full((b,), t, dtype=torch.long, device="cuda")
    ctx, ctx_lens = hotwords(cfg["output_dim"], seed=1)
    model = with_blank_bias(init_model(cfg, seed=0), blank_bias)
    return model, Decoder(model), feats, lens, ctx, ctx_lens


def timed_decodes(dec, feats, lens, ctx, ctx_lens, mode, iters: int = 5):
    """``iters`` synchronised decodes → their host ms."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(dec, feats, lens, ctx, ctx_lens, mode)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def median_fields(prefix: str, times, audio_s: float) -> dict:
    times = sorted(times)
    med = times[len(times) // 2]
    return {f"{prefix}_ms_per_batch": med,
            f"{prefix}_ms_min_max": [times[0], times[-1]],
            f"{prefix}_audio_s_per_s": audio_s / (med / 1e3)}


def phase_bench(init_model, Decoder, conformer_rnnt_bias, ffn,
                blank_bias: float):
    """bf16 at the bench shape; the fp32 comparison is for information.
    Returns what phase_profile needs to profile the same decodes."""
    b, t, iters = 64, 512, 5
    model, dec, feats, lens, ctx, ctx_lens = bench_setup(
        init_model, Decoder, conformer_rnnt_bias, blank_bias, b, t)
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
        out.update(median_fields(mode, timed_decodes(
            dec, feats, lens, ctx, ctx_lens, mode, iters), audio_s))
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


def phase_bench_lnmm(init_model, Decoder, conformer_rnnt_bias,
                     blank_bias: float):
    """B1-lnmm: B1's model and batch decoded with LNMM_PALLAS unset and
    set in turns (off, on, on, off; 5 batches each), so that the host's
    drift within the run falls on both routes; each route's median, K7's
    launches per batch and the utterances whose hyps match the unfused
    route's. Returns what phase_profile needs to profile the K7 decodes."""
    b, t, iters = 64, 512, 5
    model, dec, feats, lens, ctx, ctx_lens = bench_setup(
        init_model, Decoder, conformer_rnnt_bias, blank_bias, b, t)
    audio_s = b * t * 0.01
    out = {"batch": b, "frames": t, "dtype": "bfloat16", "n_steps": 4,
           "hotwords": 8, "blank_bias": blank_bias, "iters_per_turn": iters,
           "turns": ["off", "on", "on", "off"],
           "timing": "median host ms per batch over both turns of a route, "
                     "synchronised"}
    for mode in ("plain", "gated_on"):
        unfused = decode(dec, feats, lens, ctx, ctx_lens, mode)[0]
        with routes(**LNMM):
            fused = decode(dec, feats, lens, ctx, ctx_lens, mode)[0]
        runs = {"off": [], "on": []}
        for route in out["turns"]:
            before = read_counts()["k7"]
            with routes(**(LNMM if route == "on" else {})):
                runs[route] += timed_decodes(dec, feats, lens, ctx,
                                             ctx_lens, mode, iters)
            n = (read_counts()["k7"] - before) / iters
            if route == "on":
                out[f"{mode}_k7_launches_per_batch"] = n
            else:
                check(n == 0, f"bench_lnmm {mode}: K7 launched unswitched")
        for route, times in runs.items():
            out.update(median_fields(f"{mode}_{route}", times, audio_s))
        out[f"{mode}_utts_same_as_unfused"] = sum(
            a == r for a, r in zip(fused, unfused))
    emit("bench_lnmm", **out)
    return [(dec, feats, lens, ctx, ctx_lens, mode, blank_bias,
             out[f"{mode}_on_ms_per_batch"]) for mode in ("plain", "gated_on")]


# S1-modes: each decode mode of the new slice on the WAVs, fp32, card
# against CPU. (name, the card's call through the entry point a user makes
# → top-1 token lists, the CPU's n-best {tokens, lens, scores} whose best
# is the top-1). ``h`` is (ctx, ctx_lens), the 8 hotwords.
S1_MODES = (
    ("ctc_prefix_beam",
     lambda d, f, l, h: [n[0] for n in d.ctc_prefix_beam_search(
         f, l, beam=10)[0]],
     lambda d, f, l, h: d.ctc_prefix_beam_search(f, l, beam=10)[1]),
    ("attention", lambda d, f, l, h: d.attention(f, l, beam=10),
     lambda d, f, l, h: d.attention_nbest(f, l, beam=10)),
    ("attention_rescoring",
     lambda d, f, l, h: d.attention_rescoring(
         f, l, beam=10, ctc_weight=0.5, reverse_weight=0.3),
     lambda d, f, l, h: d.attention_rescoring_nbest(
         f, l, beam=10, ctc_weight=0.5, reverse_weight=0.3)),
    ("rnnt_beam",
     lambda d, f, l, h: d.rnnt_beam_to_lists(d.rnnt_beam_search(
         f, l, beam=5)[0]),
     lambda d, f, l, h: d.rnnt_beam_search(f, l, beam=5)[0]),
    ("rnnt_beam_hotwords",
     lambda d, f, l, h: d.rnnt_beam_to_lists(d.rnnt_beam_search(
         f, l, beam=5, context_list=h[0], context_lengths=h[1])[0]),
     lambda d, f, l, h: d.rnnt_beam_search(
         f, l, beam=5, context_list=h[0], context_lengths=h[1])[0]),
    ("ctc_beam_td_attn_rescoring",
     lambda d, f, l, h: d.ctc_beam_td_attn_rescoring(
         f, l, beam=10, ctc_weight=0.5, transducer_weight=0.7,
         attn_weight=0.3, reverse_weight=0.3),
     lambda d, f, l, h: d.ctc_beam_td_attn_nbest(
         f, l, beam=10, ctc_weight=0.5, transducer_weight=0.7,
         attn_weight=0.3, reverse_weight=0.3)),
    ("rnnt_beam_attn_rescoring",
     lambda d, f, l, h: d.rnnt_beam_attn_rescoring(
         f, l, beam=5, attn_weight=0.4, transducer_weight=1.0,
         reverse_weight=0.3, context_list=h[0], context_lengths=h[1]),
     lambda d, f, l, h: d.rnnt_beam_attn_nbest(
         f, l, beam=5, attn_weight=0.4, transducer_weight=1.0,
         reverse_weight=0.3, context_list=h[0], context_lengths=h[1])))


def compare_nbest(card_lists, cpu_nbest, key=None):
    """Card top-1 token lists against the CPU's n-best. An utterance
    whose top-1 differs passes only where the card's hypothesis is in the
    CPU's n-best within NEAR_TIE of the CPU's best score; else it is a
    fault (the card's hypothesis outside the CPU's n-best: gap inf).
    ``key`` maps a CPU token list to the form of ``card_lists`` (the
    CLI's text)."""
    toks = cpu_nbest["tokens"].cpu().tolist()
    lens = cpu_nbest["lens"].cpu().tolist()
    scores = cpu_nbest["scores"].cpu()
    best = torch.argmax(scores, dim=1).tolist()
    same, ties, bad = 0, [], []
    for i, hyp in enumerate(card_lists):
        hyps = [row[:n] for row, n in zip(toks[i], lens[i])]
        if key is not None:
            hyps = [key(h) for h in hyps]
        if hyp == hyps[best[i]]:
            same += 1
            continue
        gap = float("inf")
        if hyp in hyps:
            gap = float(scores[i, best[i]] - scores[i, hyps.index(hyp)])
        (ties if gap < NEAR_TIE else bad).append(
            {"utt": i, "cpu_score_gap": gap})
    return same, ties, bad


def ctc_greedy_cpu(cpu_dec, feats, lens, **stream) -> dict:
    """ctc_greedy_check's CPU side: the hypotheses, each frame's argmax,
    the mask and each frame's top-2 log-prob gap."""
    from wenet_celoss_tpu_torch.decode.ctc_greedy import ctc_greedy_frames
    hyps = cpu_dec.ctc_greedy_search(feats, lens, **stream)
    if stream:
        _, mask, lp = cpu_dec.encode_ctc_streaming(
            feats, lens, stream["decoding_chunk_size"],
            stream["num_decoding_left_chunks"])
    else:
        _, mask, lp = cpu_dec.encode_ctc(feats, lens)
    top2 = torch.topk(lp, 2, dim=-1).values
    return {"hyps": hyps, "ids": ctc_greedy_frames(lp, mask), "mask": mask,
            "gap": top2[..., 0] - top2[..., 1]}


def ctc_greedy_check(dec, cpu, feats, lens, **stream) -> dict:
    """CTC greedy card against CPU (``cpu``: ctc_greedy_cpu's result): a
    token list may differ only where each frame whose argmax differs has
    a CPU top-2 log-prob gap under NEAR_TIE. ``stream``: STREAM_KW for the
    simulated-streaming decode (its chunk-by-chunk encode), else the full
    context."""
    from wenet_celoss_tpu_torch.decode.ctc_greedy import ctc_greedy_frames
    reset_counts()
    card = dec.ctc_greedy_search(feats, lens, **stream)
    torch.cuda.synchronize()
    launches = read_counts()
    if stream:
        _, c_mask, c_lp = dec.encode_ctc_streaming(
            feats, lens, stream["decoding_chunk_size"],
            stream["num_decoding_left_chunks"])
    else:
        _, c_mask, c_lp = dec.encode_ctc(feats, lens)
    c_ids = ctc_greedy_frames(c_lp, c_mask).cpu()
    r_ids, r_mask, gap = cpu["ids"], cpu["mask"], cpu["gap"]
    same, ties, bad = 0, [], []
    for i, (a, b) in enumerate(zip(card, cpu["hyps"])):
        if a == b:
            same += 1
            continue
        diff = (c_ids[i] != r_ids[i]) & r_mask[i]
        worst = float(gap[i][diff].max()) if bool(diff.any()) else \
            float("inf")
        (ties if worst < NEAR_TIE else bad).append(
            {"utt": i, "frames": int(diff.sum()), "cpu_top2_gap": worst})
    return dict(identical_to_cpu=same, near_tie_flips=ties, other_diffs=bad,
                tokens=sum(map(len, card)), launches=launches,
                min_cpu_top2_gap=float(gap[r_mask].min()))



def transducer_score_check(dec, ref) -> dict:
    """transducer_score on the card against the CPU on the same inputs
    (``ref``: the CPU's encoder output and mask, the CPU's prefix-beam
    n-best that ctc_beam_td_attn_rescoring scores, and the CPU's scores
    of it; K4, K2 and K9 at the n-best's shapes, fp32): one launch of
    each, every score within 1e-3 + 1e-5*|cpu| (K9's tolerance: fp32
    log-add chains in another order)."""
    enc, mask, want = ref["enc"], ref["mask"], ref["want"]
    hyps, hyp_lens = ref["tokens"], ref["lens"]
    with torch.no_grad():
        reset_counts()
        got = dec.model.transducer_score(enc.cuda(), mask.cuda(),
                                         hyps.cuda(), hyp_lens.cuda())
        torch.cuda.synchronize()
        launches = {k: n for k, n in read_counts().items() if n}
    err = (got.cpu() - want).abs()
    ok = bool((err <= 1e-3 + 1e-5 * want.abs()).all()) and \
        launches == {"k2": 1, "k4": 1, "k9": 1}
    check(ok, f"decode_modes transducer_score: max abs {float(err.max())}, "
              f"launches {launches}")
    return dict(ok=ok, hypotheses=list(hyps.shape), max_abs_err=float(
        err.max()), max_rel_err=float((err / want.abs()).max()),
        launches=launches, tolerance="1e-3 + 1e-5*|cpu| per score")



def phase_decode_modes(slice_run) -> dict:
    """S1 for the beam and rescoring modes: S1's fp32 model (the flagship,
    blank bias +3.0) decodes the 16 WAVs through each mode of S1_MODES
    and CTC greedy on the card, held against the CPU (its runs from the
    CPU references' process, ``refs_decode_modes``): top-1 tokens
    identical, a flip only where the CPU's score gap between the two
    hypotheses is under NEAR_TIE; the prefix beam's best score within
    1e-3 and its emission times identical where the hypothesis is. Every
    count is set to 0 just before each mode's card call and read just
    after, and held to mode_want. transducer_score alone, card against
    CPU on the same n-best (transducer_score_check). Returns the CPU's
    prefix-beam n-best (LM1's)."""
    dec, feats, lens, ctx, ctx_lens, _, refs = slice_run
    hw = (ctx, ctx_lens)
    ref = refs_result(refs, "decode_modes")
    out = {"ctc_greedy": ctc_greedy_check(dec, ref["ctc_greedy"], feats,
                                          lens)}
    for name, card_fn, _ in S1_MODES:
        reset_counts()
        t0 = time.perf_counter()
        card = card_fn(dec, feats, lens, hw)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = read_counts()
        cpu, cpu_s = ref[name]
        same, ties, bad = compare_nbest(card, cpu)
        rec = dict(identical_to_cpu=same, near_tie_flips=ties,
                   other_diffs=bad, tokens=sum(map(len, card)),
                   launches=launches, card_s=card_s, cpu_s=cpu_s,
                   cpu_best_not_first=int(
                       (torch.argmax(cpu["scores"], 1) != 0).sum()))
        if name == "ctc_prefix_beam":
            _, res, _, _ = dec.ctc_prefix_beam_search(feats, lens, beam=10)
            hit = [i for i, h in enumerate(card)
                   if h == cpu["tokens"][i, 0, :cpu["lens"][i, 0]].tolist()]
            rec["best_score_max_abs_vs_cpu"] = max(
                (abs(float(res["scores"][i, 0] - cpu["scores"][i, 0]))
                 for i in hit), default=0.0)
            rec["best_times_identical"] = sum(
                torch.equal(res["times"][i, 0].cpu(), cpu["times"][i, 0])
                for i in hit)
            check(rec["best_score_max_abs_vs_cpu"] <= 1e-3,
                  f"decode_modes {name}: best score off the CPU's by "
                  f"{rec['best_score_max_abs_vs_cpu']}")
            check(rec["best_times_identical"] == len(hit),
                  f"decode_modes {name}: emission times differ from the "
                  f"CPU's on {len(hit) - rec['best_times_identical']} "
                  f"utterances")
        out[name] = rec
        if name == "ctc_beam_td_attn_rescoring":
            emit("decode_modes", mode="transducer_score", **
                 transducer_score_check(dec, {**ref["transducer_score"],
                                              "tokens": cpu["tokens"],
                                              "lens": cpu["lens"]}))
    frames = subsampled(feats.shape[1])
    for name, rec in out.items():
        want = mode_want(name.replace("_hotwords", ""), frames,
                         reverse=name in RESCORINGS)
        check(rec["launches"] == want, f"decode_modes {name}: launches "
              f"{rec['launches']}, want {want}")
        check(not rec["other_diffs"], f"decode_modes {name}: card and CPU "
              f"differ away from a near tie: {rec['other_diffs']}")
        check(rec["tokens"] > 0, f"decode_modes {name}: no token emitted")
        emit("decode_modes", mode=name, utterances=len(lens), dtype="float32",
             **rec)
    return ref["ctc_prefix_beam"][0]


def refs_decode_modes(spec: dict):
    """phase_decode_modes' CPU side (in the CPU references' process):
    S1's model on the CPU, CTC greedy (ctc_greedy_cpu) and each mode of
    S1_MODES (its n-best and seconds), and transducer_score on the CPU's
    encoder output over ctc_beam_td_attn_rescoring's n-best."""
    from wenet_celoss_tpu_torch.configs import conformer_rnnt_bias
    from wenet_celoss_tpu_torch.decode.api import Decoder
    from wenet_celoss_tpu_torch.models.factory import init_model
    cfg = conformer_rnnt_bias()
    _, feats, lens = load_wavs()
    hw = hotwords(cfg["output_dim"])
    model = with_blank_bias(init_model(cfg, device="cpu", seed=0),
                            SLICE_BLANK_BIAS)
    cpu_dec = Decoder(model, device="cpu")
    out = {"ctc_greedy": ctc_greedy_cpu(cpu_dec, feats, lens)}
    for name, _, cpu_fn in S1_MODES:
        t0 = time.perf_counter()
        out[name] = (cpu_fn(cpu_dec, feats, lens, hw),
                     time.perf_counter() - t0)
    enc, mask, _ = cpu_dec.encode_ctc(feats, lens)
    nbest = out["ctc_beam_td_attn_rescoring"][0]
    with torch.no_grad():
        want = model.transducer_score(enc, mask, nbest["tokens"],
                                      nbest["lens"])
    out["transducer_score"] = {"enc": enc, "mask": mask, "want": want}
    yield "decode_modes", out

S3_STATES = ("off", "on", "exact")
S3_NBEST = {
    "attention": lambda d, f, l, c, cl: d.attention_nbest(f, l, beam=10),
    "ctc_prefix_beam_search":
        lambda d, f, l, c, cl: d.ctc_prefix_beam_search(f, l, beam=10)[1],
    "attention_rescoring": lambda d, f, l, c, cl: d.attention_rescoring_nbest(
        f, l, beam=10, ctc_weight=0.0, reverse_weight=0.0),
    "rnnt_beam_search": lambda d, f, l, c, cl: d.rnnt_beam_search(
        f, l, beam=10, ctc_weight=0.3, transducer_weight=1.0,
        context_list=c, context_lengths=cl)[0],
    "rnnt_beam_attn_rescoring": lambda d, f, l, c, cl: d.rnnt_beam_attn_nbest(
        f, l, beam=10, attn_weight=1.0, transducer_weight=1.0,
        search_ctc_weight=0.3, reverse_weight=0.0, context_list=c,
        context_lengths=cl),
    "ctc_beam_td_attn_rescoring":
        lambda d, f, l, c, cl: d.ctc_beam_td_attn_nbest(
            f, l, beam=10, ctc_weight=0.0, transducer_weight=1.0,
            attn_weight=1.0, reverse_weight=0.0)}


def write_units(path: Path, vocab: int) -> None:
    """A symbol table of ``vocab`` entries: blank, the word boundary, the
    26 letters, placeholders, <sos/eos> last."""
    syms = ["<blank>", "▁"] + [chr(c) for c in range(65, 91)]
    syms += [f"<t{i}>" for i in range(len(syms), vocab - 1)] + ["<sos/eos>"]
    path.write_text("".join(f"{sym} {i}\n" for i, sym in enumerate(syms)),
                    encoding="utf8")


def unigram_arpa(sentences) -> str:
    """An ARPA unigram model of the words of ``sentences``: each word's
    count plus one, </s> once a sentence plus one, <unk> one, over their
    total (add-one), log10 to 6 places."""
    counts: dict = {}
    for sent in sentences:
        for w in sent.split() + ["</s>"]:
            counts[w] = counts.get(w, 0) + 1
    counts["<unk>"] = counts.get("<unk>", 0)
    total = sum(counts.values()) + len(counts)
    lines = [f"{math.log10((c + 1) / total):.6f}\t{w}"
             for w, c in sorted(counts.items())]
    return ("\\data\\\n" f"ngram 1={len(lines)}\n\n\\1-grams:\n"
            + "\n".join(lines) + "\n\n\\end\\\n")


# The batched fbank against a reference: rtol and atol of the log-mel
# (the bound of tests/test_data.py, on white noise). A mel bin under
# FBANK_QUIET of its frame's largest energy is ill-conditioned in fp32
# (the FFT's rounding is absolute in the frame's scale; on the committed
# WAVs the JAX package's own batched and numpy paths differ past 1e-3 in
# the log of such bins): it is held in the energy domain to FBANK_QUIET
# of that largest energy instead.
FBANK_TOL = 1e-3
FBANK_QUIET = 1e-6


def fbank_close(got, want) -> dict:
    """Log-mel ``got`` against ``want`` (numpy [..., T, M], padded frames
    0 in both) by the rule above: the count of elements beyond it, and
    the worst differences."""
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    diff = np.abs(got - want)
    loud = diff <= FBANK_TOL + FBANK_TOL * np.abs(want)
    e_want = np.exp(want)
    top = e_want.max(axis=-1, keepdims=True)
    quiet = e_want < FBANK_QUIET * top
    quiet_err = np.abs(np.exp(got) - e_want) / top
    ok = loud | (quiet & (quiet_err <= FBANK_QUIET))
    return {"elements": int(ok.size), "beyond": int((~ok).sum()),
            "beyond_1e-3_log": int((~loud).sum()),
            "max_abs_log": float(diff.max()),
            "quiet_held_in_energy": int((quiet & ~loud).sum()),
            "max_quiet_energy_share": float(
                quiet_err[quiet].max()) if quiet.any() else 0.0}


def mfcc_close(got, want, got_fb, want_fb, cfg) -> dict:
    """MFCC ``got`` against ``want``, each the DCT and lifter of the
    log-mel beside it (``got_fb``, ``want_fb``, held by fbank_close): each
    coefficient within FBANK_TOL (rtol and atol) plus the log-mel
    difference of its frame carried through |lifter · DCT|."""
    from wenet_celoss_tpu_torch.ops.fbank import _dct_matrix, _lifter
    mix = np.abs(_dct_matrix(cfg.num_ceps, cfg.num_mel_bins).astype(
        np.float64) * _lifter(cfg)[:, None])
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    carried = np.abs(np.asarray(got_fb, np.float64)
                     - np.asarray(want_fb, np.float64)) @ mix.T
    diff = np.abs(got - want)
    ok = diff <= FBANK_TOL + FBANK_TOL * np.abs(want) + carried
    return {"elements": int(ok.size), "beyond": int((~ok).sum()),
            "beyond_1e-3": int((diff > FBANK_TOL + FBANK_TOL
                                * np.abs(want)).sum()),
            "max_abs": float(diff.max()),
            "max_carried": float(carried.max())}


def s3_files(tmp: Path, init_model, conformer_rnnt_bias):
    """S1's model (the full-width flagship in fp32, seed 0, blank bias
    +3.0) saved with the port's save_checkpoint, its config with
    save_config (plus a dataset_conf), a symbol table over its output_dim
    (blank, the word boundary, the 26 letters, placeholders, <sos/eos>),
    a data.list of the 16 test-clean WAVs under this checkout and S1's 8
    hotwords → the CLI arguments shared by every S3 run."""
    from wenet_celoss_tpu_torch.utils.checkpoint import save_checkpoint
    from wenet_celoss_tpu_torch.utils.config import save_config
    cfg = conformer_rnnt_bias()
    vocab = cfg["output_dim"]
    model = with_blank_bias(init_model(cfg, seed=0), SLICE_BLANK_BIAS)
    save_checkpoint(model, str(tmp / "final.pt"))
    cfg["dataset_conf"] = {
        "resample_conf": {"resample_rate": 16000},
        "fbank_conf": {"num_mel_bins": 80, "frame_shift": 10,
                       "frame_length": 25, "dither": 0.1}}
    save_config(cfg, str(tmp / "train.yaml"))
    write_units(tmp / "units.txt", vocab)
    text = dict(line.split(" ", 1) for line in
                (WAV_DIR.parent / "text").read_text().splitlines())
    with open(tmp / "data.list", "w") as f:
        for wav in sorted(WAV_DIR.glob("*.wav")):
            f.write(json.dumps({"key": wav.stem, "wav": str(wav),
                                "txt": text[wav.stem]}) + "\n")
    ctx, ctx_lens = hotwords(vocab)
    (tmp / "hotwords.txt").write_text("".join(
        " ".join(map(str, row[:n])) + "\n"
        for row, n in zip(ctx[1:].tolist(), ctx_lens[1:].tolist())))
    return model, ["--config", str(tmp / "train.yaml"), "--test_data",
                   str(tmp / "data.list"), "--checkpoint",
                   str(tmp / "final.pt"), "--symbol_table",
                   str(tmp / "units.txt"), "--batch_size", "16"]


@contextlib.contextmanager
def traced_exact(traces: list):
    """Every "exact" search in the block records its decisions (gate,
    token, top-2 gap) into a new list appended to ``traces``."""
    from wenet_celoss_tpu_torch.decode import rnnt_greedy
    search = rnnt_greedy.rnnt_gated_greedy_search_exact

    def traced(*args, **kw):
        traces.append([])
        kw["trace"] = traces[-1]
        return search(*args, **kw)
    rnnt_greedy.rnnt_gated_greedy_search_exact = traced
    try:
        yield
    finally:
        rnnt_greedy.rnnt_gated_greedy_search_exact = search


def run_cli(recognize, base, extra, out: Path, device: str):
    """One in-process run of the port's CLI → ({file name: lines}, its
    exact-search traces, seconds, launches on the card)."""
    traces: list = []
    argv = base + extra + ["--result_file", str(out / "text")]
    if device == "cpu":
        argv += ["--device", "cpu"]
    reset_counts()
    t0 = time.perf_counter()
    with traced_exact(traces):
        recognize.main(argv)
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: n for k, n in read_counts().items() if n}
    files = {p.name: p.read_text(encoding="utf8").splitlines()
             for p in sorted(out.iterdir())}
    return files, traces, seconds, launches


def exact_diffs(card_traces, cpu_traces, utts):
    """The S1 rule on the "exact" decisions: an utterance may differ only
    where the first decision (gate, token) that differs had a CPU top-2
    gap under NEAR_TIE."""
    ties, bad = [], []
    for i in utts:
        a, b = card_traces[i], cpu_traces[i]
        if [x[:2] for x in a] == [y[:2] for y in b]:
            continue
        k = next((j for j, (x, y) in enumerate(zip(a, b))
                  if x[:2] != y[:2]), min(len(a), len(b)))
        gap = b[k][2] if k < len(b) else float("inf")
        (ties if gap < NEAR_TIE else bad).append(
            {"utt": i, "decision": k, "cpu_top2_gap": gap})
    return ties, bad


class S3Judge:
    """What judges a CLI line that differs between the card and the CPU:
    the CLI's batch (the same Dataset), S1's checkpointed model on the
    card and on the CPU, and the CPU's n-best or trace of each mode. Made
    only when a line differs."""

    def __init__(self, tmp: Path, recognize, Decoder, model, init_model,
                 conformer_rnnt_bias):
        from wenet_celoss_tpu_torch.data.dataset import Dataset
        from wenet_celoss_tpu_torch.utils.config import load_config
        from wenet_celoss_tpu_torch.utils.file_utils import \
            read_symbol_table
        table = read_symbol_table(str(tmp / "units.txt"))
        self.id2sym = {v: k for k, v in table.items()}
        conf = dict(recognize.eval_dataset_conf(
            load_config(str(tmp / "train.yaml")), 16), context_mode=0)
        (batch,) = list(Dataset("raw", str(tmp / "data.list"), table, conf,
                                partition=False))
        self.feats, self.lens = batch["feats"], batch["feat_lengths"]
        self.ctx, self.ctx_lens = hotwords(model.vocab_size)
        self.dec = Decoder(model)
        cpu_model = init_model(conformer_rnnt_bias(), device="cpu", seed=0)
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()})
        self.cpu_dec = Decoder(cpu_model, device="cpu")

    def text(self, hyp):
        from wenet_celoss_tpu_torch.bin.recognize import hyp_text
        return hyp_text(hyp, self.id2sym)

    def diffs(self, mode: str, state: str, card_lines, utts):
        """(near-tie flips, other differences) of the utterances ``utts``
        (indexes into the batch) of a mode's result file."""
        if mode == "ctc_greedy_search":
            cpu = ctc_greedy_cpu(self.cpu_dec, self.feats, self.lens)
            rec = ctc_greedy_check(self.dec, cpu, self.feats, self.lens)
            return ([d for d in rec["near_tie_flips"] if d["utt"] in utts],
                    [d for d in rec["other_diffs"] if d["utt"] in utts])
        if mode == "rnnt_greedy_search":
            trace: list = []
            kind = "gated_" + state
            card = decode(self.dec, self.feats, self.lens, self.ctx,
                          self.ctx_lens, kind)
            cpu = decode(self.cpu_dec, self.feats, self.lens, self.ctx,
                         self.ctx_lens, kind, trace)
            _, ties, bad = compare(card, cpu, trace)
            return ([d for d in ties if d["utt"] in utts],
                    [d for d in bad if d["utt"] in utts])
        nbest = S3_NBEST[mode](self.cpu_dec, self.feats, self.lens,
                               self.ctx, self.ctx_lens)
        texts = [line.split(" ", 1)[1] if " " in line else ""
                 for line in card_lines]
        _, ties, bad = compare_nbest(texts, nbest, key=self.text)
        return ([d for d in ties if d["utt"] in utts],
                [d for d in bad if d["utt"] in utts])


def s3_want(modes, frames: int) -> dict:
    """Launches of one CLI run over one batch: mode_want of each mode,
    and 24 more K1 for rnnt_greedy_search's second encoder pass (the
    empty hotword list)."""
    want = dict(NO_LAUNCHES)
    for mode in modes:
        for k, n in mode_want(mode, frames, reverse=False).items():
            want[k] += n
        if mode == "rnnt_greedy_search":
            want["k1"] += K1_PER_ENCODER_PASS
    return {k: n for k, n in want.items() if n}


def s3_runs(recognize) -> list:
    """S3's CLI runs: (name, modes, context mode, gating state)."""
    runs = [(f"mode2_{state}", recognize.MODES if state == "off"
             else ["rnnt_greedy_search"], "2", state)
            for state in S3_STATES]
    runs.append(("mode3_exact", ["rnnt_greedy_search"], "3", "exact"))
    return runs


def s3_extra(s3: dict, modes, context_mode: str, state: str) -> list:
    return s3["hot"] + ["--mode", ",".join(modes), "--context_mode",
                        context_mode, "--context_filter_state", state]


S3_CPU_THREADS = 3   # of the card machine's 8 cores, beside the phases


def s3_setup(work: Path, init_model, conformer_rnnt_bias) -> dict:
    """S3's inputs (``s3_files`` in ``work/s3``), and its CPU side started
    at once in a process of its own (``s3_cpu_child``), so that the
    full-width model's CPU decodes run while the card phases before S3
    do; ``phase_recognize`` reads its results."""
    tmp = work / "s3"
    tmp.mkdir()
    model, base = s3_files(tmp, init_model, conformer_rnnt_bias)
    s3 = {"dir": tmp, "model": model, "base": base,
          "hot": ["--context_list_file", str(tmp / "hotwords.txt")]}
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; "
            "chip_smoke.s3_cpu_child(json.loads(sys.argv[2]))")
    spec = {"dir": str(tmp), "base": base, "hot": s3["hot"]}
    s3["cpu_proc"] = subprocess.Popen(
        [sys.executable, "-c", code, str(ROOT), json.dumps(spec)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES=""),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    s3["cpu_started"] = time.perf_counter()
    return s3


def s3_cpu_child(spec: dict) -> None:
    """S3's CLI runs with --device cpu (each in process, as ``run_cli``
    runs them), their exact-search traces and seconds into
    ``<dir>/cpu.json``, their files under ``<dir>/<run>/cpu``."""
    import logging
    from wenet_celoss_tpu_torch.bin import recognize
    logging.basicConfig(level=logging.WARNING)
    torch.set_num_threads(S3_CPU_THREADS)
    register_counters()
    tmp = Path(spec["dir"])
    out = {}
    for name, modes, context_mode, state in s3_runs(recognize):
        _, traces, seconds, _ = run_cli(
            recognize, spec["base"], s3_extra(spec, modes, context_mode,
                                              state),
            tmp / name / "cpu", "cpu")
        out[name] = {"traces": traces, "seconds": seconds}
    (tmp / "cpu.json").write_text(json.dumps(out))


def s3_cpu_results(s3: dict) -> dict:
    """The CPU side's results: waits for its process; raises if it
    failed."""
    _, err = s3["cpu_proc"].communicate(timeout=900)
    if s3["cpu_proc"].returncode != 0:
        raise RuntimeError(f"recognize: the CPU side's process exited "
                           f"{s3['cpu_proc'].returncode}: {err[-3000:]}")
    emit("recognize_cpu_side", seconds_since_start=time.perf_counter()
         - s3["cpu_started"], threads=S3_CPU_THREADS)
    return json.loads((s3["dir"] / "cpu.json").read_text())


# -------------------------------------------- the CPU references ---
REFS_CPU_THREADS = 2   # of the card machine's 8 cores, beside S3's 3


def refs_setup(work: Path, s3: dict) -> dict:
    """The CPU side of every card-against-CPU phase but S3's (the fp32
    runs each card phase is held against), started after the build in a
    process of its own (``refs_child``) beside S3's, so that it runs while
    the card phases do. Each result is built from the same seeds,
    configs and inputs as its card side and lands in ``work/refs`` as it
    is done, in the order the phases read them (``refs_result``)."""
    tmp = work / "refs"
    tmp.mkdir()
    spec = {"dir": str(tmp), "tools": tools_files(s3)}
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; "
            "chip_smoke.refs_child(json.loads(sys.argv[2]))")
    with open(tmp / "child.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", code, str(ROOT), json.dumps(spec)],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=str(ROOT),
                     CUDA_VISIBLE_DEVICES="",
                     OMP_NUM_THREADS=str(REFS_CPU_THREADS)))
    return {"dir": tmp, "proc": proc, "tools": spec["tools"], "kept": {}}


REFS = ("refs_s1", "refs_decode_modes", "refs_stream", "refs_tools",
        "refs_steps")


def refs_child(spec: dict) -> None:
    """The CPU references' process: each generator of REFS in turn (each
    takes ``spec``: the results' directory and the tools' arguments),
    each result saved as ``<name>.pt`` (written whole, then renamed) with
    the wall-clock time it was done."""
    import logging
    logging.basicConfig(level=logging.WARNING)
    torch.set_num_threads(REFS_CPU_THREADS)
    register_counters()
    tmp = Path(spec["dir"])
    for fn in REFS:
        for name, result in globals()[fn](spec):
            result = dict(result, _done_at=time.time())
            torch.save(result, tmp / f"{name}.part")
            os.replace(tmp / f"{name}.part", tmp / f"{name}.pt")


def refs_result(refs: dict, name: str, keep: bool = False):
    """A result of the CPU references' process: waits for it (raises if
    the process ended without it) and emits how long it waited. With
    ``keep`` it is kept for the next reader."""
    if name in refs["kept"]:
        return refs["kept"][name]
    path = refs["dir"] / f"{name}.pt"
    t0 = time.perf_counter()
    while not path.exists():
        if refs["proc"].poll() is not None and not path.exists():
            log = (refs["dir"] / "child.log").read_text()[-3000:]
            raise RuntimeError(f"cpu_refs: the process exited "
                               f"{refs['proc'].returncode} before "
                               f"{name}:\n{log}")
        time.sleep(0.1)
    out = torch.load(path, weights_only=False)
    path.unlink()
    emit("cpu_refs", part=name, waited_s=time.perf_counter() - t0,
         done_s_before_read=time.time() - out.pop("_done_at"))
    if keep:
        refs["kept"][name] = out
    return out


# ------------------------------------------------------- the tools ---
TOOLS_LM_WEIGHT = 0.5   # LM1's weight of the ARPA's natural-log score


def tools_files(s3: dict) -> dict:
    """The tools' inputs beside S3's files (S1's model as final.pt, its
    config, units and data.list): a wav.scp and the transcripts of the 16
    WAVs, their words one a line and a unigram ARPA of them
    (unigram_arpa), and the arguments of A1 (the alignment CLI,
    --gen_praat, one batch of 16) and L1 (the label checker) by side,
    the CPU's with --device cpu."""
    d = s3["dir"]
    tmp = d / "tools"
    tmp.mkdir()
    text = (WAV_DIR.parent / "text").read_text()
    (tmp / "text").write_text(text)
    (tmp / "wav.scp").write_text("".join(
        f"{p.stem} {p}\n" for p in sorted(WAV_DIR.glob("*.wav"))))
    sents = [line.split(" ", 1)[1] for line in text.splitlines()]
    (tmp / "words.txt").write_text("".join(
        w + "\n" for w in sorted({w for s in sents for w in s.split()})))
    (tmp / "lm.arpa").write_text(unigram_arpa(sents))
    model = ["--config", str(d / "train.yaml"), "--checkpoint",
             str(d / "final.pt"), "--symbol_table", str(d / "units.txt")]
    out = {"dir": str(tmp), "arpa": str(tmp / "lm.arpa"),
           "wordlist": str(tmp / "words.txt"), "a1": {}, "l1": {}}
    for side in ("card", "cpu"):
        dev = ["--device", "cpu"] if side == "cpu" else []
        out["a1"][side] = model + [
            "--input_data", str(d / "data.list"), "--result_file",
            str(tmp / "a1" / side / "ali.txt"), "--gen_praat",
            "--batch_size", "16"] + dev
        out["l1"][side] = model + [
            "--wav_scp", str(tmp / "wav.scp"), "--text", str(tmp / "text"),
            "--result", str(tmp / "l1" / side / "result.txt"),
            "--timestamp", str(tmp / "l1" / side / "ts.txt")] + dev
    return out


def tools_batches(d: Path, model, device):
    """What A1 and L1 fed their searches: the CLIs' test-time pipeline
    over S3's data.list (dither 0), ``model``'s CTC log-probs of the one
    batch of 16 (A1's) and of each utterance alone (L1's), with the
    labels. → dict of host tensors and lists."""
    from wenet_celoss_tpu_torch.bin import recognize
    from wenet_celoss_tpu_torch.data.dataset import Dataset
    from wenet_celoss_tpu_torch.utils.config import load_config
    from wenet_celoss_tpu_torch.utils.file_utils import read_symbol_table
    table = read_symbol_table(str(d / "units.txt"))
    conf = dict(recognize.eval_dataset_conf(
        load_config(str(d / "train.yaml")), 16), context_mode=0)
    (batch,) = list(Dataset("raw", str(d / "data.list"), table, conf,
                            partition=False))
    feats = torch.as_tensor(batch["feats"], device=device)
    lens = torch.as_tensor(batch["feat_lengths"], dtype=torch.long,
                           device=device)
    with torch.no_grad():
        _, mask, lp = model.encode_ctc(feats, lens)
        alone = [model.encode_ctc(feats[i:i + 1, :int(n)], lens[i:i + 1])[2]
                 [0].cpu() for i, n in enumerate(batch["feat_lengths"])]
    return {"lp": lp.cpu(), "frames": mask.long().sum(1).cpu(),
            "labels": [[int(x) for x in y[:n]] for y, n in
                       zip(batch["labels"], batch["label_lengths"])],
            "alone": alone, "keys": batch["keys"]}


def refs_tools(spec: dict):
    """A1's and L1's CPU sides (in the CPU references' process): each CLI
    with --device cpu (its files under tools/<part>/cpu), and the CPU
    model's log-probs they searched (tools_batches)."""
    from wenet_celoss_tpu_torch.bin import alignment, label_checker
    from wenet_celoss_tpu_torch.configs import conformer_rnnt_bias
    from wenet_celoss_tpu_torch.models.factory import init_model
    from wenet_celoss_tpu_torch.utils.checkpoint import load_into
    tools = spec["tools"]
    seconds = {}
    for part, cli in (("a1", alignment), ("l1", label_checker)):
        t0 = time.perf_counter()
        cli.main(tools[part]["cpu"])
        seconds[part] = time.perf_counter() - t0
    d = Path(tools["dir"]).parent
    model = init_model(conformer_rnnt_bias(), device="cpu")
    load_into(model, str(d / "final.pt"))
    yield "tools", {"seconds": seconds, **tools_batches(d, model, "cpu")}


def tool_files(out: Path) -> dict:
    return {p.name: p.read_text(encoding="utf8")
            for p in sorted(out.iterdir())}


def parted(card: dict, cpu: dict, name: str) -> list:
    """The keys whose line differs between the card's and the CPU's file
    ``name`` (lines "<key> ..."), or, for a TextGrid, whose file does."""
    if name.endswith(".TextGrid"):
        return [name[:-len(".TextGrid")]] if card.get(name) != cpu.get(
            name) else []
    a = dict(line.split(" ", 1) if " " in line else (line, "")
             for line in card.get(name, "").splitlines())
    b = dict(line.split(" ", 1) if " " in line else (line, "")
             for line in cpu.get(name, "").splitlines())
    return sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))


def tool_near_tie(card_lp, cpu_lp, frames: int) -> dict:
    """The bound on a search's margin that a card-against-CPU difference
    of one utterance implies: every hypothesis of a CTC search (the
    Viterbi path, a label checker's edit path) scores one log-prob a
    frame plus fixed costs, so between the two runs each score moves by
    at most T'·max|Δ log-prob|, and a decision that flips had a margin
    under twice that on the CPU."""
    delta = float((card_lp[:frames] - cpu_lp[:frames]).abs().max())
    bound = 2 * frames * delta
    return {"frames": frames, "max_abs_log_prob": delta,
            "cpu_margin_at_most": bound, "near_tie": bound < NEAR_TIE}


def phase_tools(s3: dict, refs: dict, slice_run, lm1_cpu_nbest) -> dict:
    """The tools on the card (S1's model, fp32, the 16 WAVs), each against
    its CPU side: A1 the alignment CLI (ali.txt and the 16 TextGrids), L1
    the label checker CLI (result and timestamps), both in process with
    every count set to 0 just before and read just after (24 K1 launches
    an encoder pass); a file may differ from the CPU's only at an
    utterance whose search margin on the CPU is provably under NEAR_TIE
    (tool_near_tie), and the search redone on the card's log-probs on the
    host must give the card's line. LM1: S1's CTC prefix-beam n-best
    (beam 10) on the card and the CPU's, each rescored by
    lm_rescore_nbest with the transcripts' ARPA: the same orders (F1 and
    W1: phase_f1, phase_w1). Returns the launches by path."""
    from wenet_celoss_tpu_torch.bin import alignment, label_checker
    from wenet_celoss_tpu_torch.decode.label_check import check_labels, \
        render
    from wenet_celoss_tpu_torch.ops.ctc_loss import ctc_forced_align
    from wenet_celoss_tpu_torch.utils.file_utils import read_symbol_table
    t_phase = time.perf_counter()
    tools = refs["tools"]
    tmp = Path(tools["dir"])
    launches = {}
    for part, cli in (("a1", alignment), ("l1", label_checker)):
        reset_counts()
        t0 = time.perf_counter()
        cli.main(tools[part]["card"])
        torch.cuda.synchronize()
        launches[part] = (read_counts(), time.perf_counter() - t0)
    ref = refs_result(refs, "tools")
    card = tools_batches(s3["dir"], s3["model"], "cuda")
    keys = card["keys"]
    id2sym = {v: k for k, v in read_symbol_table(
        str(s3["dir"] / "units.txt")).items()}
    texts = dict(line.split(" ", 1) for line in
                 (tmp / "text").read_text().splitlines())

    def l1_line(key, lp, id2sym):
        """L1's result text of one utterance, searched on the host over
        ``lp`` as the CLI searches (its labels, its default penalties and
        beam)."""
        sym2id = {v: k for k, v in id2sym.items()}
        labels = [sym2id["▁" if c == " " else c] for c in texts[key]
                  if ("▁" if c == " " else c) in sym2id]
        items = check_labels(lp.numpy(), labels)
        return "" if items is None else render(items, id2sym, 10, 4)[0]
    for part in ("a1", "l1"):
        got, want = (tool_files(tmp / part / side) for side in
                     ("card", "cpu"))
        passes = 1 if part == "a1" else len(keys)
        want_k1 = {**NO_LAUNCHES, "k1": passes * K1_PER_ENCODER_PASS}
        counts, seconds = launches[part]
        check(counts == want_k1, f"tools {part}: launches {counts}, want "
                                 f"{want_k1}")
        check(sorted(got) == sorted(want), f"tools {part}: files "
              f"{sorted(got)} on the card, {sorted(want)} on the CPU")
        diffs = {}
        for name in want:
            for key in parted(got, want, name):
                i = keys.index(key)
                if part == "a1":
                    n = int(ref["frames"][i])
                    lp_card, lp_cpu = card["lp"][i], ref["lp"][i]
                    redo = ctc_forced_align(
                        lp_card[None, :n], torch.tensor([card["labels"][i]]),
                        torch.tensor([n]), torch.tensor(
                            [len(card["labels"][i])]))[0].tolist()
                    redone = " ".join(map(str, redo)) == dict(
                        line.split(" ", 1) for line in
                        got["ali.txt"].splitlines())[key]
                else:
                    lp_card, lp_cpu = card["alone"][i], ref["alone"][i]
                    n = lp_card.shape[0]
                    redone = l1_line(key, lp_card, id2sym) == dict(
                        (line.split(" ", 1) + [""])[:2] for line in
                        got["result.txt"].splitlines())[key]
                rec = tool_near_tie(lp_card, lp_cpu, n)
                diffs.setdefault(key, {**rec, "files": [],
                                       "search_redone_matches": redone})
                diffs[key]["files"].append(name)
        bad = {k: v for k, v in diffs.items()
               if not (v["near_tie"] and v["search_redone_matches"])}
        check(not bad, f"tools {part}: card and CPU differ away from a "
                       f"near tie: {bad}")
        rec = {"files": len(want), "files_equal": sum(
            got.get(k) == v for k, v in want.items()),
            "near_tie_flips": diffs, "launches": counts,
            "card_s": seconds, "cpu_s": ref["seconds"][part]}
        if part == "a1":
            rec["utterances_aligned"] = len(got["ali.txt"].splitlines())
            check(rec["utterances_aligned"] == len(keys) and len(want) ==
                  len(keys) + 1, f"tools a1: {len(want)} files")
        else:
            lines = got["result.txt"].splitlines()
            rec.update(lines=len(lines), aligned=sum(" " in line
                                                     for line in lines),
                       edits=sum(line.count("<del>") + line.count("<is>")
                                 for line in lines))
            check(len(lines) == len(keys), f"tools l1: {len(lines)} lines")
        emit("tools", part=part, **rec)
    launches = {part: counts for part, (counts, _) in launches.items()}
    launches["lm1"] = phase_lm1(slice_run, tools, lm1_cpu_nbest)
    emit("tools", part="a1_l1_lm1", seconds=time.perf_counter() - t_phase)
    return launches


def nbest_words(nbest, i: int, id2sym: dict) -> list:
    """Utterance i's hypotheses of a prefix-beam n-best as word lists
    (the units of write_units; ▁ starts a word)."""
    toks = nbest["tokens"][i].cpu().tolist()
    lens = nbest["lens"][i].cpu().tolist()
    return ["".join(id2sym.get(t, "<unk>") for t in row[:n]).replace(
        "▁", " ").split() for row, n in zip(toks, lens)]


def phase_lm1(slice_run, tools: dict, cpu_nbest) -> dict:
    """LM1: S1's CTC prefix-beam n-best on the card (every count set to 0
    just before, read just after: 24 K1) and the CPU's (from
    decode_modes), each hypothesis rescored by lm_rescore_nbest (the
    transcripts' unigram ARPA, weight TOOLS_LM_WEIGHT, on the prefix
    beam's score): per utterance the rescored orders, as token lists,
    equal; a difference only where the CPU's rescored scores at the
    first differing rank lie within NEAR_TIE. Returns the launches."""
    from wenet_celoss_tpu_torch.lm.arpa import ArpaLM, lm_rescore_nbest
    dec, feats, lens = slice_run[:3]
    lm = ArpaLM(tools["arpa"])
    syms = ["<blank>", "▁"] + [chr(c) for c in range(65, 91)]
    id2sym = dict(enumerate(syms))
    reset_counts()
    _, card, _, _ = dec.ctc_prefix_beam_search(feats, lens, beam=10)
    torch.cuda.synchronize()
    launches = read_counts()
    same, ties, bad, moved = 0, [], [], 0
    for i in range(len(lens)):
        orders = []
        for nb in (card, cpu_nbest):
            words = nbest_words(nb, i, id2sym)
            toks = [tuple(r[:n]) for r, n in zip(
                nb["tokens"][i].cpu().tolist(), nb["lens"][i].cpu().tolist())]
            total = lm_rescore_nbest(lm, words, nb["scores"][i].cpu().tolist(),
                                     TOOLS_LM_WEIGHT)
            rank = sorted(range(len(toks)), key=lambda j: -total[j])
            orders.append(([toks[j] for j in rank], [total[j] for j in rank]))
        (a, _), (b, b_total) = orders
        moved += int(b != [tuple(r[:n]) for r, n in zip(
            cpu_nbest["tokens"][i].tolist(), cpu_nbest["lens"][i].tolist())])
        if a == b:
            same += 1
            continue
        k = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        gap = abs(b_total[k] - b_total[b.index(a[k])]) if a[k] in b \
            else float("inf")
        (ties if gap < NEAR_TIE else bad).append(
            {"utt": i, "rank": k, "cpu_rescored_gap": gap})
    want = {**NO_LAUNCHES, "k1": K1_PER_ENCODER_PASS}
    check(not bad and launches == want, f"tools lm1: orders differ away "
          f"from a near tie {bad}; launches {launches}, want {want}")
    emit("tools", part="lm1", utterances=len(lens), beam=10,
         lm_weight=TOOLS_LM_WEIGHT, orders_identical=same,
         near_tie_flips=ties, other_diffs=bad,
         utterances_reordered_by_the_lm=moved, launches=launches)
    return launches


def phase_f1(iters: int = 10) -> None:
    """F1: the batched fbank and MFCC (ops/fbank.py compute_fbank,
    compute_mfcc; plain torch, torch.fft.rfft) on the card over the 16
    WAVs padded to a batch and at bench.py's decode shape (B = 64 × 512
    frames of seeded white noise), against the port's numpy path per
    utterance (fbank_close, mfcc_close); ms a batch on the card (CUDA
    events, mean of ``iters``) beside the numpy path's (host, the whole
    batch once)."""
    from wenet_celoss_tpu_torch.data.wav import read_wav
    from wenet_celoss_tpu_torch.ops import fbank
    rng = np.random.default_rng(21)
    n512 = (512 - 1) * 160 + 400
    batches = {
        "wavs16": [read_wav(str(p))[0] for p in sorted(WAV_DIR.glob("*.wav"))],
        "b64_t512": [(rng.standard_normal(n512) * 8000).astype(np.float32)
                     for _ in range(64)]}
    fb_cfg, mf_cfg = fbank.FbankConfig(), fbank.MfccConfig()
    for name, wavs in batches.items():
        lens = np.array([len(w) for w in wavs])
        pad = np.zeros((len(wavs), lens.max()), np.float32)
        for i, w in enumerate(wavs):
            pad[i, :len(w)] = w
        x = torch.as_tensor(pad, device="cuda")
        n = torch.as_tensor(lens, device="cuda")
        rec = {"batch": len(wavs), "frames_max": int(
            fbank.num_frames(lens.max(), fb_cfg))}
        for kind, fn, cfg, host_fn in (
                ("fbank", fbank.compute_fbank, fb_cfg,
                 fbank.compute_fbank_np),
                ("mfcc", fbank.compute_mfcc, mf_cfg,
                 fbank.compute_mfcc_np)):
            got, got_n = fn(x, n, cfg)
            got, got_n = got.cpu().numpy(), got_n.cpu().numpy()
            t0 = time.perf_counter()
            host = [host_fn(w, cfg) for w in wavs]
            host_ms = (time.perf_counter() - t0) * 1e3
            want = np.zeros_like(got)
            for i, h in enumerate(host):
                want[i, :len(h)] = h
            check(got_n.tolist() == [len(h) for h in host],
                  f"tools f1 {name} {kind}: frame counts {got_n.tolist()}")
            if kind == "fbank":
                judge = fbank_close(got, want)
                got_fb, want_fb = got, want
            else:
                judge = mfcc_close(got, want, got_fb, want_fb, cfg)
            check(judge["beyond"] == 0, f"tools f1 {name} {kind}: {judge}")
            rec[kind] = {**judge, "card_ms": cuda_ms(
                lambda: fn(x, n, cfg), iters=iters), "host_ms": host_ms}
        emit("tools", part="f1", shape=name, **rec,
             rule=f"log-mel {FBANK_TOL} rtol and atol, bins under "
                  f"{FBANK_QUIET} of their frame's largest energy in the "
                  f"energy domain; MFCC {FBANK_TOL} plus the log-mel "
                  f"difference through |lifter x DCT|")


def phase_recognize(init_model, Decoder, conformer_rnnt_bias,
                    s3: dict) -> dict:
    """S3: the port's CLI (bin/recognize.main, in process) decodes the 16
    test-clean WAVs with S1's model from a .pt checkpoint, once on the
    card and once with --device cpu: all 8 modes with S1's 8 hotwords
    (context mode 2) under "off"; rnnt_greedy_search, the one mode that
    reads the gating state, under "on" and "exact"; then context mode 3
    under "exact" (rnnt_greedy_search and its .gate_dist sidecar). Each
    mode's lines card against CPU: equal, or a flip under S1's rule (the
    CPU's top-2 gap under NEAR_TIE at the first difference; the n-best
    score gap for the beam modes). Counts are set to 0 before each card
    run and read after, against s3_want. Returns the launches of the
    card runs, by kernel."""
    import logging
    from wenet_celoss_tpu_torch.bin import recognize
    logging.basicConfig(level=logging.WARNING)
    total = dict.fromkeys(NO_LAUNCHES, 0)
    with contextlib.nullcontext(s3["dir"]) as tmp:
        model, base = s3["model"], s3["base"]
        refs = [json.loads(line)["txt"] for line in
                (tmp / "data.list").read_text().splitlines()]
        judge = None
        frames = None
        cpu_runs = None
        for name, modes, context_mode, state in s3_runs(recognize):
            extra = s3_extra(s3, modes, context_mode, state)
            card = run_cli(recognize, base, extra, tmp / name / "card",
                           "cuda")
            # traces as the CPU side's come back through JSON
            card = (card[0], json.loads(json.dumps(card[1])), *card[2:])
            if cpu_runs is None:
                cpu_runs = s3_cpu_results(s3)
            cpu = ({p.name: p.read_text(encoding="utf8").splitlines()
                    for p in sorted((tmp / name / "cpu").iterdir())},
                   cpu_runs[name]["traces"], cpu_runs[name]["seconds"], {})
            if frames is None:
                judge = S3Judge(tmp, recognize, Decoder, model, init_model,
                                conformer_rnnt_bias)
                frames = subsampled(judge.feats.shape[1])
            want = s3_want(modes, frames)
            check(card[3] == want, f"recognize {name}: launches {card[3]}, "
                                   f"want {want}")
            for k, n in card[3].items():
                total[k] += n
            backtracks = [sum(sum(tok == -1 for _, tok, _ in u) for u in t)
                          for t in (card[1], cpu[1])]
            for fname in sorted(cpu[0]):
                a, b = card[0][fname], cpu[0][fname]
                mode = fname.rsplit(".", 1)[-1] if "." in fname \
                    else modes[0]
                check(len(a) == len(b) == 16 or fname.endswith("gate_dist"),
                      f"recognize {name} {fname}: {len(a)} card lines, "
                      f"{len(b)} CPU lines")
                utts = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
                ties, bad = [], []
                if fname.endswith("gate_dist"):
                    mode = "gate_dist"
                    if utts:
                        ties, bad = exact_diffs(card[1], cpu[1],
                                                range(len(card[1])))
                        if not ties and not bad:
                            bad = [{"sidecar": a, "cpu": b,
                                    "unexplained": True}]
                elif utts and mode == "rnnt_greedy_search" \
                        and state == "exact":
                    ties, bad = exact_diffs(card[1], cpu[1], utts)
                elif utts:
                    ties, bad = judge.diffs(mode, state, a, utts)
                    bad += [{"utt": i, "unjudged": True} for i in utts
                            if i not in {d["utt"] for d in ties + bad}]
                check(not bad, f"recognize {name} {mode}: card and CPU "
                               f"differ away from a near tie: {bad}")
                rec = dict(run=name, mode=mode, state=state,
                           lines=len(a), identical_to_cpu=sum(
                               x == y for x, y in zip(a, b)),
                           near_tie_flips=ties, other_diffs=bad)
                if mode == "rnnt_greedy_search":
                    rec.update(utts_with_tokens=sum(len(x.split()) > 1
                                                    for x in a))
                    check(rec["utts_with_tokens"] > 0,
                          f"recognize {name}: no token emitted")
                if mode == "gate_dist":
                    rec.update(card=a, cpu=b)
                emit("recognize", **rec)
            rec = dict(run=name, modes=len(modes), card_s=card[2],
                       cpu_s=cpu[2], launches=card[3], want=want)
            if state == "exact":
                rec.update(backtracks_card=backtracks[0],
                           backtracks_cpu=backtracks[1],
                           exact_decisions=sum(map(len, card[1])),
                           exact_tokens=sum(tok > 0 for u in card[1]
                                            for _, tok, _ in u),
                           encoder_frames=sum(subsampled(int(n))
                                              for n in judge.lens),
                           reference_chars=sum(map(len, refs)),
                           reference_words=sum(len(r.split())
                                               for r in refs))
            emit("recognize", **rec)
    emit("recognize", **flac_check())
    return total


def flac_check() -> dict:
    """read_audio on a FLAC of the first test-clean WAV (made by
    tools/flac_encode.py), against the WAV's samples: the FLAC decoder
    (runtime/core/frontend/flac.cc) built with this machine's g++."""
    from wenet_celoss_tpu_torch.data.flac import build
    from wenet_celoss_tpu_torch.data.wav import read_audio, read_wav
    sys.path.insert(0, str(ROOT / "tools"))
    from flac_encode import encode_flac
    wav = sorted(WAV_DIR.glob("*.wav"))[0]
    x, sr = read_wav(str(wav))
    t0 = time.perf_counter()
    lib = build()
    build_s = time.perf_counter() - t0
    y, sr2 = read_audio(encode_flac(x.astype(np.int32), sr))
    ok = sr2 == sr and np.array_equal(x, y)
    check(ok, f"recognize flac: read_audio differs from the WAV's samples")
    return dict(flac=wav.name, samples=len(x), identical=ok,
                build_s=build_s, library=lib.name)


EXACT_UTTS = 2   # the "exact" batch: the first utterances of B5's batch


def phase_exact_bench(init_model, Decoder, conformer_rnnt_bias) -> None:
    """B5: "exact" against "on": the bf16 flagship, B = 16 × 512 random
    fbank frames, 8 random 4-token hotwords, blank bias +3.0: ms a batch
    and an utterance, the host reads of the search loop an utterance
    (exact: one gate and one token read a step; on: one a
    label-synchronous iteration). "on": the median of 3 batches after the
    counted one, and the card's busy ms, idle share and interval count
    from one profile. "exact" (host-bound, one utterance at a time, ~1.7
    s an utterance): the counted batch of the first EXACT_UTTS
    utterances, synchronised, and no profile; it must emit tokens."""
    from torch.profiler import ProfilerActivity, profile
    b = 16
    model, dec, feats, lens, ctx, ctx_lens = bench_setup(
        init_model, Decoder, conformer_rnnt_bias, SLICE_BLANK_BIAS, b, 512)
    out = {"batch": b, "exact_batch": EXACT_UTTS, "frames": 512,
           "dtype": "bfloat16", "hotwords": 8,
           "blank_bias": SLICE_BLANK_BIAS,
           "timing": "on: median host ms per batch of 3 after the counted "
                     "one; exact: host ms of the counted batch; "
                     "synchronised",
           "card": smi()}

    def run(state):
        n = EXACT_UTTS if state == "exact" else b
        return dec.rnnt_greedy_search(
            feats[:n], lens[:n], context_list=ctx, context_lengths=ctx_lens,
            context_filter_state=state)
    for state in ("on", "exact"):
        n = EXACT_UTTS if state == "exact" else b
        reads = {"n": 0}

        def counted(fn):
            def wrapper(*a, **k):
                reads["n"] += 1
                return fn(*a, **k)
            return wrapper
        names = (("hw_gate_step", "joint_step") if state == "exact"
                 else ("predictor_step",))
        for nm in names:
            setattr(model, nm, counted(getattr(model, nm)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hyps = run(state)
        torch.cuda.synchronize()
        times = [(time.perf_counter() - t0) * 1e3]
        for nm in names:
            delattr(model, nm)
        loop_reads = reads["n"] - (0 if state == "exact" else 1)
        out.update({
            f"{state}_loop_host_reads_per_utt": loop_reads / n,
            f"{state}_tokens_per_utt": sum(map(len, hyps)) / n})
        if state == "exact":
            check(sum(map(len, hyps)) > 0, "exact_bench: the exact search "
                                           "emitted no token")
            out["exact_ms_per_batch"] = times[0]
            out["exact_ms_per_utt"] = times[0] / n
            continue
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        med = sorted(times)[1]
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(state)
            torch.cuda.synchronize()
        busy = device_busy(prof)[0]
        kernels = device_events(prof)
        out.update({
            "on_ms_per_batch": med,
            "on_ms_per_utt": med / n,
            "on_ms_all": times,
            "on_device_busy_ms": busy,
            "on_idle_share": 1.0 - busy / med,
            "on_card_intervals": kernels,
            "on_card_intervals_per_loop_read": kernels / loop_reads,
            "on_profile_s": time.perf_counter() - t0})
        check(busy > 0, f"exact_bench B={b} on: the profile recorded no "
                        "card time")
    out["exact_over_on_per_utt"] = out["exact_ms_per_utt"] / \
        out["on_ms_per_utt"]
    emit("exact_bench", **out)


# B3: the decode modes of bench.py's decode keys (and attention) at its
# decode shape, with its beams: (name, call).
B3_MODES = (
    ("ctc_greedy", lambda d, f, l: d.ctc_greedy_search(f, l)),
    ("attention_rescoring",
     lambda d, f, l: d.attention_rescoring(f, l, beam=10)),
    ("rnnt_beam", lambda d, f, l: d.rnnt_beam_to_lists(
        d.rnnt_beam_search(f, l, beam=5)[0])),
    ("ctc_beam_td_attn_rescoring",
     lambda d, f, l: d.ctc_beam_td_attn_rescoring(f, l, beam=10)),
    ("attention", lambda d, f, l: d.attention(f, l, beam=10)))


RESCORINGS = ("attention_rescoring", "ctc_beam_td_attn_rescoring",
              "rnnt_beam_attn_rescoring")


def mode_want(name: str, frames: int, reverse: bool) -> dict:
    """Each kernel's launches in one decode of mode ``name`` over
    ``frames`` encoder frames: 24 K1 an encoder pass; the attention beam's
    3 decoder layers a step, one step a frame; a rescoring's teacher-forced
    decoders 3 layers each (the right one only with a reverse weight);
    transducer_score one K4, K2 and K9."""
    k1 = K1_PER_ENCODER_PASS
    if name == "attention":
        k1 += 3 * frames
    elif name in RESCORINGS:
        k1 += 6 if reverse else 3
    want = {**NO_LAUNCHES, "k1": k1}
    if name == "ctc_beam_td_attn_rescoring":
        want.update(k2=1, k4=1, k9=1)
    return want


def phase_bench_modes(init_model, Decoder, conformer_rnnt_bias,
                      blank_bias: float):
    """B3: bf16, B=64 × 512 random frames, B1's blank bias: each mode of
    B3_MODES timed (median host ms of 5 synchronised batches, of 3 for a
    mode above 2 s a batch), its peak memory, and its kernel launches in
    one batch (every count set to 0 just before that batch and read just
    after; that batch is this mode's main-path run). Returns ({mode:
    (launches, want)}, what phase_modes_profile needs)."""
    b, t = 64, 512
    _, dec, feats, lens, _, _ = bench_setup(
        init_model, Decoder, conformer_rnnt_bias, blank_bias, b, t)
    frames = subsampled(t)
    audio_s = b * t * 0.01
    paths, to_profile = {}, []
    for name, fn in B3_MODES:
        reset_counts()
        t0 = time.perf_counter()
        hyps = fn(dec, feats, lens)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
        want = mode_want(name, frames, reverse=False)
        check(launches == want, f"bench_modes {name}: launches {launches}, "
                                f"want {want}")
        paths[name] = (launches, want)
        iters = 3 if first_ms > 2000 else 5
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(dec, feats, lens)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        fields = median_fields(name, times, audio_s)
        emit("bench_modes", mode=name, batch=b, frames=t,
             dtype="bfloat16", blank_bias=blank_bias, iters=iters,
             first_ms=first_ms, **fields,
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
             launches_per_batch={k: n for k, n in launches.items() if n},
             tokens_per_utt=sum(map(len, hyps)) / b,
             timing="median host ms per batch, synchronised")
        to_profile.append((name, dec, feats, lens, fn,
                           fields[f"{name}_ms_per_batch"]))
    return paths, to_profile


def phase_modes_profile(name, dec, feats, lens, fn, timed_ms,
                        prefix: str = "b3_") -> None:
    """One B3 batch under torch.profiler, run after every timing: the
    card's busy ms, its idle share of the unprofiled median, the kernels
    that take the most."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(dec, feats, lens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, by_name = device_busy(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]

    def ms(*keys):
        return sum(v for k, v in by_name.items() if any(s in k for s in keys))
    emit("profile", mode=prefix + name, timed_ms=timed_ms,
         profiled_wall_ms=wall_ms, device_busy_ms=busy,
         idle_share=1.0 - busy / timed_ms,
         idle_share_profiled=1.0 - busy / wall_ms,
         k1_ms=ms(*FFN_FWD_KERNELS), k2_ms=ms("joint_fwd"),
         k4_ms=ms(*K4_FWD_KERNELS), k9_ms=ms(*K9_KERNELS),
         kernels=len(by_name),
         top=[{"kernel": k[:90], "ms": v} for k, v in top])


# U2++ streaming decode: bench.py's streaming key (chunk 16, 4 left chunks).
STREAM_KW = dict(simulate_streaming=True, decoding_chunk_size=16,
                 num_decoding_left_chunks=4)
U2PP_DECODER_K1 = 9   # a rescoring's teacher-forced decoders: 6 + 3 blocks


def stream_chunks(frames: int) -> int:
    """Chunk steps over ``frames`` input frames at chunk 16 through the
    conv2d subsampling (rate 4, right context 6: stride 64, window 67;
    frames after the last whole window are dropped)."""
    from wenet_celoss_tpu_torch.decode.streaming import num_chunks
    return num_chunks(frames, 4, 6, STREAM_KW["decoding_chunk_size"])


def phase_stream_slice(init_model, Decoder, u2pp_conformer,
                       slice_run) -> int:
    """S2: the full-width fp32 U2++ conformer (seeded weights) decodes
    S1's 16 WAVs chunk by chunk (STREAM_KW) through CTC greedy and
    attention rescoring (beam 10, ctc 0.5, reverse 0.3) on the card, held
    against the CPU (``refs_stream``) by S1's flip rules; 24 K1 launches a
    chunk (every count set to 0 just before the greedy decode, the
    stream_decode path, and read just after), 9 more in the rescoring.
    The streamed encoder output card against CPU. Then U2's contract on
    the card: with ``static_chunk_size: 16`` the streamed output equals
    the chunk-masked full forward on the valid frames within 1e-4
    relative Frobenius, and the masks are equal. Returns the
    stream_decode path's K1 launches."""
    _, feats, lens = slice_run[:3]
    ref = refs_result(slice_run[-1], "stream")
    cfg = u2pp_conformer()
    model = init_model(cfg, seed=0)
    dec = Decoder(model)
    chunks = stream_chunks(feats.shape[1])
    t0 = time.perf_counter()
    greedy = ctc_greedy_check(dec, ref["ctc_greedy"], feats, lens,
                              **STREAM_KW)
    greedy["seconds_card"] = time.perf_counter() - t0
    want = {**NO_LAUNCHES, "k1": K1_PER_ENCODER_PASS * chunks}
    check(greedy["launches"] == want, f"stream_slice ctc_greedy: launches "
          f"{greedy['launches']}, want {want}")
    kw = dict(beam=10, ctc_weight=0.5, reverse_weight=0.3, **STREAM_KW)
    reset_counts()
    card = dec.attention_rescoring(feats, lens, **kw)
    torch.cuda.synchronize()
    r_launches = read_counts()
    cpu = ref["rescoring"]
    same, ties, bad = compare_nbest(card, cpu)
    rescoring = dict(identical_to_cpu=same, near_tie_flips=ties,
                     other_diffs=bad, tokens=sum(map(len, card)),
                     launches=r_launches, cpu_best_not_first=int(
                         (torch.argmax(cpu["scores"], 1) != 0).sum()))
    r_want = {**NO_LAUNCHES,
              "k1": K1_PER_ENCODER_PASS * chunks + U2PP_DECODER_K1}
    check(r_launches == r_want, f"stream_slice attention_rescoring: "
          f"launches {r_launches}, want {r_want}")
    for name, rec in (("ctc_greedy", greedy),
                      ("attention_rescoring", rescoring)):
        check(not rec["other_diffs"], f"stream_slice {name}: card and CPU "
              f"differ away from a near tie: {rec['other_diffs']}")
        check(rec["tokens"] > 0, f"stream_slice {name}: no token emitted")
        emit("stream_slice", mode=name, model="u2pp_conformer",
             dtype="float32", utterances=len(lens), chunks=chunks, **rec)
    ys, mask, _ = dec.encode_ctc_streaming(feats, lens, 16, 4)
    ys_cpu, mask_cpu = ref["ys"], ref["mask"]
    enc_err = float((ys.cpu() - ys_cpu)[mask_cpu].abs().max())
    check(torch.equal(mask.cpu(), mask_cpu) and enc_err <= 1e-3,
          f"stream_slice streamed encoder card vs CPU max abs {enc_err}")
    cfg_s = copy.deepcopy(cfg)
    cfg_s["encoder_conf"]["static_chunk_size"] = 16
    dec_s = Decoder(init_model(cfg_s, seed=0))
    ys, mask, lp = dec_s.encode_ctc_streaming(feats, lens, 16, 4)
    full, full_mask, full_lp = dec_s.encode_ctc(feats, lens, 16, 4)
    t_s = ys.shape[1]
    rel = rel_fro(ys[mask], full[:, :t_s][mask])
    rel_lp = rel_fro(lp[mask], full_lp[:, :t_s][mask])
    same_mask = torch.equal(mask, full_mask[:, :t_s])
    check(rel <= 1e-4 and same_mask, f"stream_slice U2 contract: streamed "
          f"vs chunk-masked relative Frobenius {rel}, masks equal "
          f"{same_mask}")
    emit("stream_slice", mode="u2_contract", static_chunk_size=16,
         left_chunks=4, frames_out=t_s, frames_full=int(full.shape[1]),
         valid_frames=int(mask.sum()), rel_fro_encoder=rel,
         rel_fro_ctc_log_probs=rel_lp, masks_equal=same_mask,
         encoder_max_abs_card_vs_cpu=enc_err,
         tolerance="relative Frobenius <= 1e-4 on the valid frames; "
                   "card vs CPU max abs <= 1e-3")
    return greedy["launches"]["k1"]


def refs_stream(spec: dict):
    """S2's CPU side (in the CPU references' process): the U2++ model
    (seed 0) on the CPU, its streamed CTC greedy, attention rescoring
    n-best and streamed encoder output over S1's WAVs."""
    from wenet_celoss_tpu_torch.configs import u2pp_conformer
    from wenet_celoss_tpu_torch.decode.api import Decoder
    from wenet_celoss_tpu_torch.models.factory import init_model
    _, feats, lens = load_wavs()
    cpu_dec = Decoder(init_model(u2pp_conformer(), device="cpu", seed=0),
                      device="cpu")
    kw = dict(beam=10, ctc_weight=0.5, reverse_weight=0.3, **STREAM_KW)
    ys, mask, _ = cpu_dec.encode_ctc_streaming(feats, lens, 16, 4)
    yield "stream", {
        "ctc_greedy": ctc_greedy_cpu(cpu_dec, feats, lens, **STREAM_KW),
        "rescoring": cpu_dec.attention_rescoring_nbest(feats, lens, **kw),
        "ys": ys, "mask": mask}



def phase_bench_stream(init_model, Decoder, u2pp_conformer, b: int = 64,
                       t: int = 512):
    """B4: bench.py's streaming key: the U2++ conformer at vocab 1024,
    bf16, B=64 × 512 random fbank frames, CTC greedy chunk by chunk
    (STREAM_KW). K1 launches in one batch (every count set to 0 just
    before it and read just after) must be 24 a chunk, 7 chunks; then the
    median host ms of 5 synchronised batches with min and max, audio-s/s
    as B1 counts it (B·T·10 ms), peak memory. Returns what
    phase_modes_profile needs."""
    cfg = u2pp_conformer(vocab_size=1024)
    cfg["dtype"] = "bfloat16"
    dec = Decoder(init_model(cfg, seed=0))
    rng = np.random.default_rng(0)
    feats = torch.as_tensor(rng.standard_normal((b, t, 80)),
                            dtype=torch.float32, device="cuda")
    lens = torch.full((b,), t, dtype=torch.long, device="cuda")

    def fn(d, f, n):
        return d.ctc_greedy_search(f, n, **STREAM_KW)
    chunks = stream_chunks(t)
    reset_counts()
    t0 = time.perf_counter()
    hyps = fn(dec, feats, lens)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    want = {**NO_LAUNCHES, "k1": K1_PER_ENCODER_PASS * chunks}
    check(launches == want, f"bench_stream: launches {launches}, want "
                            f"{want}")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(dec, feats, lens)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    fields = median_fields("stream_ctc_greedy", times, b * t * 0.01)
    emit("bench_stream", model="u2pp_conformer", vocab=1024, batch=b,
         frames=t, dtype="bfloat16", chunk=16, left_chunks=4,
         chunks=chunks, frames_out=chunks * 16, frames_subsampled=
         subsampled(t), iters=5, first_ms=first_ms, **fields,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         launches_per_batch={k: n for k, n in launches.items() if n},
         tokens_per_utt=sum(map(len, hyps)) / b,
         timing="median host ms per batch, synchronised; audio-s/s "
                "counts all B·T frames, as B1 does")
    return ("stream_ctc_greedy", dec, feats, lens, fn,
            fields["stream_ctc_greedy_ms_per_batch"])


def no_dropout(cfg):
    """The config with every dropout rate 0."""
    for conf in (cfg["encoder_conf"], cfg["decoder_conf"]):
        for k in list(conf) + ["positional_dropout_rate"]:
            if k.endswith("dropout_rate"):
                conf[k] = 0.0
    return cfg


def float64_check(what, ref64, names, card_g, cpu_g, card_m, cpu_m) -> dict:
    """The port's CPU path in float64 (``ref64``: a float64 copy of the
    CPU's model after its step, its gradients and metrics on the same
    batch, from ``cpu_step``) as the reference of one step. Per gradient,
    the fp32 error of the card and of the CPU against it (relative
    Frobenius, the scale floored at 1e-6 of the reference's global norm);
    the card passes where its error is at most twice the CPU's plus 1e-6.
    The key projections' biases, whose exact gradient is 0 (softmax
    ignores a shift shared by all keys), are held to 1e-6 of the global
    norm on both instead. A gradient that fails is a fault of the port."""
    ref, ref_m = ref64["g"], ref64["m"]
    gnorm = float(torch.sqrt(sum((r ** 2).sum() for r in ref)))
    rows = {}
    for name, a, b, r in zip(names, card_g, cpu_g, ref):
        scale = max(float(r.norm()), 1e-6 * gnorm)
        e_card = float((a.cpu().double() - r).norm()) / scale
        e_cpu = float((b.double() - r).norm()) / scale
        zero = name.endswith("linear_k.bias")
        rows[name] = {"card": e_card, "cpu": e_cpu, "exact_zero": zero,
                      "over_limit": (max(e_card, e_cpu) if zero
                                     else e_card / (2 * e_cpu + 1e-6))}
    worst = max(rows, key=lambda k: rows[k]["over_limit"])
    failed = sorted(k for k, v in rows.items() if v["over_limit"] > 1.0)
    check(not failed, f"{what} float64 reference: gradients over the limit "
                      f"{ {k: rows[k] for k in failed} }")
    noisiest = sorted(rows, key=lambda k: -rows[k]["cpu"])[:12]
    losses = {k: {"card": abs(float(card_m[k]) - float(ref_m[k])),
                  "cpu": abs(float(cpu_m[k]) - float(ref_m[k])),
                  "float64": float(ref_m[k])} for k in ref_m}
    return {"gradients": len(rows), "failed": failed, "worst": worst,
            "worst_errors": rows[worst], "noisiest_on_cpu":
            {k: rows[k] for k in noisiest},
            "median_card_over_cpu": float(np.median(
                [v["card"] / max(v["cpu"], 1e-30) for v in rows.values()
                 if not v["exact_zero"]])),
            "loss_abs_errors": losses,
            "float64_cpu_seconds": ref64["seconds"],
            "rule": "card error <= 2 * CPU error + 1e-6 per gradient "
                    "(relative Frobenius against the float64 CPU step, "
                    "scale floored at 1e-6 of its global norm); key "
                    "biases <= 1e-6 of the global norm"}


def cpu_step(cfg, batch, gen_seed=None, spread=False) -> dict:
    """card_vs_cpu's reference (in the CPU references' process): one fp32
    gradient step of ``init_model(cfg, seed=0)`` on the CPU, the batch
    and generator seed the card's step used (None: torch.Generator()'s
    own) → its gradients, metrics, running statistics and seconds. With
    ``spread`` the step runs on 8 threads and again on 3 (another
    summation order, ``alt_g``), and a float64 copy of the model runs the
    same batch (``float64``: float64_check's reference)."""
    from wenet_celoss_tpu_torch.models.factory import init_model
    from wenet_celoss_tpu_torch.parallel import train
    cpu = init_model(cfg, device="cpu", seed=0)

    def run():
        gen = torch.Generator()
        if gen_seed is not None:
            gen.manual_seed(gen_seed)
        return train.make_grad_fn(cpu)(
            train.TrainState(0, cpu, None), on(batch, "cpu"), gen)
    threads = torch.get_num_threads()
    t0 = time.perf_counter()
    if spread:
        torch.set_num_threads(8)
    g, m = run()
    out = {"g": g, "m": {k: float(v) for k, v in m.items()},
           "buffers": {n: b.clone() for n, b in cpu.named_buffers()
                       if n.endswith(("running_mean", "running_var"))},
           "seconds": time.perf_counter() - t0}
    if spread:
        torch.set_num_threads(3)
        out["alt_g"] = run()[0]
        torch.set_num_threads(threads)
        m64 = copy.deepcopy(cpu).double()
        b64 = on(batch, "cpu")
        b64["feats"] = b64["feats"].double()
        t0 = time.perf_counter()
        ref, ref_m = train.make_grad_fn(m64)(
            train.TrainState(0, m64, None), b64, torch.Generator())
        out["float64"] = {"g": ref, "m": {k: float(v) for k, v in
                                          ref_m.items()},
                          "seconds": time.perf_counter() - t0}
    return out



def card_vs_cpu(what, model, card, cpu, loss_rtol: float = 1e-4,
                spread: bool = False, start_state=None) -> dict:
    """The CPU's run of one gradient step of ``model`` (same weights, same
    batch; ``cpu``: ``cpu_step``'s result) against the card's ``card`` =
    (grads, metrics): every loss term to ``loss_rtol`` relative, the
    gradient norm to 1e-4 relative, each parameter's gradient to 1e-3
    relative Frobenius. ``start_state``: the card model's state before its
    step. A batch_norm model's running statistics after both steps: each
    mean and variance to 1e-4 of its tensor's largest element.

    With ``spread`` (the CPU ran the step on 8 and on 3 threads, another
    summation order) the limits become the larger of those and twice the
    CPU's own difference between its two runs: a model whose fp32
    gradients move by more than the limits under another summation order
    on the same CPU cannot be held tighter than that; and the card's and
    the CPU's gradients are both held to the port's CPU path in float64
    (float64_check). Returns the fields of the phase's line."""
    from wenet_celoss_tpu_torch.parallel import train
    card_g, card_m = card
    cpu_g, cpu_m = cpu["g"], cpu["m"]
    fields = {"cpu_step_seconds": cpu["seconds"]}
    stats = [(n, b, cpu["buffers"][n]) for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    if stats:
        errs = {n: float((a.cpu() - c).abs().max() / c.abs().max())
                for n, a, c in stats}
        worst_stat = max(errs, key=errs.get)
        check(errs[worst_stat] <= 1e-4, f"{what} running statistic "
              f"{worst_stat}: {errs[worst_stat]} of its largest element")
        fields.update(running_stats=len(stats), running_stats_worst=worst_stat,
                      running_stats_worst_rel=errs[worst_stat],
                      running_stats_moved=any(
                          not torch.equal(a.cpu(), start_state[n])
                          for n, a, _ in stats) if start_state else None)
    alt_g = cpu.get("alt_g") if spread else None
    losses = {k: (float(card_m[k]), float(cpu_m[k])) for k in card_m}
    for k, (a, b) in losses.items():
        check(abs(a - b) <= loss_rtol * abs(b),
              f"{what} {k}: card {a} cpu {b}")
    gn_card = float(train.global_norm(card_g))
    gn_cpu = float(train.global_norm(cpu_g))
    gn_limit = 1e-4
    if spread:
        gn_spread = abs(float(train.global_norm(alt_g)) - gn_cpu) / gn_cpu
        gn_limit = max(gn_limit, 2 * gn_spread)
        fields["gnorm_cpu_spread"] = gn_spread
    check(abs(gn_card - gn_cpu) <= gn_limit * gn_cpu,
          f"{what} gnorm card {gn_card} cpu {gn_cpu} (limit {gn_limit})")
    worst, worst_rel, worst_name, raised = 0.0, 0.0, None, {}
    # A depthwise convolution's bias feeding a batch norm has a zero
    # gradient in exact arithmetic (the mean subtraction cancels it): both
    # runs' gradients must be rounding noise, under 1e-6 of the gnorm.
    bn_cancelled = {n for n, m in model.named_modules()
                    if getattr(m, "norm", None) == "batch_norm"}
    noise = {}
    for i, ((name, _), a, b) in enumerate(zip(model.named_parameters(),
                                              card_g, cpu_g)):
        if name.endswith(".depthwise_conv.bias") and \
                name.rsplit(".", 2)[0] in bn_cancelled:
            noise[name] = max(float(a.norm()), float(b.norm())) / gn_cpu
            continue
        # Key-projection biases have a zero gradient in exact arithmetic
        # (softmax ignores a shift shared by all keys): floor the scale.
        scale = max(float(b.norm()), 1e-6 * gn_cpu)
        rel = float((a.cpu() - b).norm()) / scale
        limit = 1e-3
        if spread:
            cpu_rel = float((alt_g[i] - b).norm()) / scale
            if 2 * cpu_rel > limit:
                limit = 2 * cpu_rel
                raised[name] = {"card": rel, "cpu_3_threads": cpu_rel}
        if rel / limit > worst:
            worst, worst_rel, worst_name = rel / limit, rel, name
    check(worst <= 1.0, f"{what} gradient {worst_name} over its limit by "
                        f"{worst}")
    if noise:
        loudest = max(noise, key=noise.get)
        check(noise[loudest] <= 1e-6, f"{what} gradient {loudest}, zero in "
              f"exact arithmetic, at {noise[loudest]} of the gnorm")
        fields.update(bn_cancelled_biases=len(noise),
                      bn_cancelled_bias_max_over_gnorm=noise[loudest])
    if spread:
        fields["limits_raised_by_cpu_spread"] = raised
        fields["float64_reference"] = float64_check(
            what, cpu["float64"], [n for n, _ in model.named_parameters()],
            card_g, cpu_g, card_m, cpu_m)
    return dict(losses_card_cpu=losses, gnorm_card=gn_card,
                gnorm_cpu=gn_cpu, worst_grad_rel_fro=worst_rel,
                worst_grad_over_limit=worst, worst_grad=worst_name,
                **fields)


# The card-against-CPU training steps in the order the phases take them,
# and the CPU step each reads (the CPU runs no switch: CONV and LNMM's
# checks share the plain flagship's).
CHECK_STEPS = ("train_check", "postnorm_train_check", "u2pp_train_check",
               "rnnt_train_check", "rnnt_pallas_train_check",
               "bn_train_check", "v1_check", "v2_check", "v3_check")
CPU_STEP_OF = {"conv_train_check": "rnnt_train_check",
               "lnmm_train_check": "rnnt_train_check"}


def check_recipe(what: str, wavs) -> tuple:
    """(config, batch, generator seed or None, spread) of the
    card-against-CPU step ``what``: dropout 0, T0's 16 WAVs (the
    flagship's with hotwords from their transcripts; V1-V3 4 of S1's WAVs
    with word labels), the same on the card and in ``cpu_step``."""
    from wenet_celoss_tpu_torch.configs import (conformer_ctc_aed,
                                                conformer_rnnt_bias,
                                                u2pp_conformer)
    what = CPU_STEP_OF.get(what, what)
    if what == "train_check":
        return no_dropout(conformer_ctc_aed()), head(wavs, 16), None, False
    if what == "postnorm_train_check":
        return (no_dropout(postnorm_aed(conformer_ctc_aed)), head(wavs, 16),
                None, True)
    if what == "u2pp_train_check":
        return (no_dropout(u2pp_conformer()), head(wavs, 16),
                limited_chunk_seed(wavs), False)
    if what.startswith("v"):
        overrides = {v: o for v, o, _ in VARIANTS}[what[:2]]
        batch4, starts = s1_word_batch(4)
        return (no_dropout_rnnt(variant_config(conformer_rnnt_bias,
                                               overrides)()),
                with_hotwords(batch4, starts=starts), None, False)
    base = batch_norm_flagship(conformer_rnnt_bias) \
        if what == "bn_train_check" else conformer_rnnt_bias
    cfg = no_dropout_rnnt(base())
    if what == "rnnt_pallas_train_check":
        cfg["model_conf"]["rnnt_impl"] = "pallas"
        cfg["output_dim"] = CHAR_VOCAB
    else:
        cfg["model_conf"]["rnnt_impl"] = "streaming"
    return cfg, with_hotwords(head(wavs, 16)), None, False


def refs_steps(spec: dict):
    """Every CPU step of CHECK_STEPS (in the CPU references' process),
    with the V1-V3 decodes' CPU side after each variant's step."""
    wavs, _ = load_train_wavs()
    for what in CHECK_STEPS:
        cfg, batch, gen_seed, spread = check_recipe(what, wavs)
        yield "step_" + what, cpu_step(cfg, batch, gen_seed, spread)
        if what.startswith("v"):
            yield from refs_variant_decodes(what[:2], cfg)



def postnorm_aed(conformer_ctc_aed):
    """conformer_ctc_aed with a post-norm transformer encoder (absolute
    positional encoding) and post-norm decoders: the post-LN layout of
    Vaswani et al. 2017 and Speech-Transformer at conformer_ctc_aed's
    widths (d=256, 4 heads, F=2048, 12 + 6 blocks, relu FFNs). No config
    file of the repo names it; every FFN runs through K6."""
    cfg = conformer_ctc_aed()
    cfg["encoder"] = "transformer"
    cfg["encoder_conf"].update(normalize_before=False,
                               pos_enc_layer_type="abs_pos")
    cfg["decoder_conf"]["normalize_before"] = False
    return cfg


def phase_train_check(init_model, train, wavs, refs, what="train_check",
                      model_name="conformer_ctc_aed", want=None) -> None:
    """One fp32 step of the full-width model of ``check_recipe(what)``,
    dropout 0, on the card and on the CPU (``cpu_step``, in the CPU
    references' process) with the same weights, batch and generator seed;
    every kernel's launches as ``want``; the recipe's ``spread`` as
    card_vs_cpu's. A dynamic-chunk model's chunk is its generator's first
    draw, reported as ``chunk_drawn``."""
    from wenet_celoss_tpu_torch.utils.mask import draw_dynamic_chunk
    cfg, batch, gen_seed, spread = check_recipe(what, wavs)
    model = init_model(cfg, seed=0)
    seed = torch.Generator().initial_seed() if gen_seed is None \
        else gen_seed
    extra = {}
    if model.encoder.use_dynamic_chunk:
        t_sub = subsampled(int(batch["feat_lengths"].max()))
        extra = {"gen_seed": seed, "encoder_frames": t_sub,
                 "chunk_drawn": draw_dynamic_chunk(
                     t_sub, model.encoder.use_dynamic_left_chunk,
                     torch.Generator().manual_seed(seed))}
    reset_counts()
    card_g, card_m = train.make_grad_fn(model)(
        train.TrainState(0, model, None), on(batch, "cuda"),
        torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches == want, f"{what}: launches {launches}, want {want}")
    fields = card_vs_cpu(what, model, (card_g, card_m),
                         refs_result(refs, "step_" + what), spread=spread)
    emit(what, model=model_name, dtype="float32",
         dropout=0.0, utterances=len(batch["feat_lengths"]),
         frames_max=int(batch["feat_lengths"].max()),
         labels_max=int(batch["label_lengths"].max()), **extra, **fields,
         launches=launches,
         tolerance="losses and gnorm 1e-4 relative; each gradient 1e-3 "
                   "relative Frobenius (fp32 sums in another order over "
                   "18 blocks; floor 1e-6 * gnorm for the key biases)"
                   + ("; gnorm and each gradient at least twice the CPU's "
                      "own difference between 8 and 3 threads" if spread
                      else ""))



def timed_steps(step, state, batch, gen, warm: int = 2, iters: int = 5):
    """``warm`` steps, then ``iters`` synchronised timed ones, peak memory
    counted from the first timed step → (state, every step's loss, the
    timed steps' host ms, the last metrics, the last gradient norm)."""
    losses = []
    for _ in range(warm):
        state, m, _ = step(state, batch, gen)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m, gnorm = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    return state, losses, times, m, gnorm


TRAIN_CURVE_STEPS = 12   # the loss falls within the first 5


def train_curve(what, init_model, train, cfg, batch,
                steps: int = TRAIN_CURVE_STEPS, warmup: int = 4):
    """``steps`` bf16 steps of ``cfg``'s model from seed 0 on one batch,
    warmup cut to ``warmup`` steps so that the learning rate peaks within
    the run; the median of the last 5 losses must be below the first.
    Returns (first loss, that median, every step's metrics)."""
    cfg["dtype"] = "bfloat16"
    cfg["scheduler_conf"]["warmup_steps"] = warmup
    model = init_model(cfg, seed=0)
    tx, _ = train.make_optimizer(cfg)
    state = train.create_train_state(model, tx)
    step = train.make_train_step(model, tx)
    gen = torch.Generator().manual_seed(1)
    curve = []
    for _ in range(steps):
        state, m, gnorm = step(state, batch, gen)
        curve.append({**{k: float(x) for k, x in m.items()},
                      "gnorm": float(gnorm)})
    first = curve[0]["loss"]
    last5 = float(np.median([c["loss"] for c in curve[-5:]]))
    check(last5 < first, f"{what}: loss did not fall ({first} → {last5})")
    return first, last5, curve


def phase_train(init_model, cfg, train, what="train",
                model_name="conformer_ctc_aed", want=None, b: int = 256,
                t: int = 512, u: int = 32, env=None):
    """bf16, dropout 0.1, at bench.py's training shape, under the switches
    ``env``. This is the training path's run: every kernel count is set
    to 0 just before it and read just after. Returns (what
    phase_train_profile needs, launches)."""
    warm, iters = 2, 5
    cfg["dtype"] = "bfloat16"
    v = cfg["output_dim"]
    model = init_model(cfg, seed=0)
    tx, _ = train.make_optimizer(cfg)
    state = train.create_train_state(model, tx)
    step = train.make_train_step(model, tx)
    rng = np.random.default_rng(0)
    batch = on({"feats": rng.standard_normal((b, t, 80)).astype(np.float32),
                "feat_lengths": np.full((b,), t, np.int64),
                "labels": rng.integers(1, v - 2, (b, u)),
                "label_lengths": np.full((b,), u, np.int64)}, "cuda")
    gen = torch.Generator().manual_seed(0)
    env = env or {}
    with routes(**env):
        reset_counts()
        state, losses, times, _, gnorm = timed_steps(step, state, batch,
                                                     gen, warm, iters)
        launches = read_counts()
    steps = warm + iters
    want = {k: n * steps for k, n in want.items()}
    check(launches == want, f"{what}: launches {launches} over {steps} "
                            f"steps, want {want}")
    check(all(np.isfinite(losses)), f"{what}: losses {losses}")
    med = sorted(times)[iters // 2]
    audio_s = b * t * 0.01
    emit(what, model=model_name, dtype="bfloat16", dropout=0.1,
         switches=env, batch=b, frames=t, labels=u, vocab=v,
         steps_timed=iters,
         warmup_steps_run=warm, ms_per_step=med,
         ms_min_max=[min(times), max(times)], audio_s_per_s=audio_s / (
             med / 1e3), peak_mem_gib=torch.cuda.max_memory_allocated()
         / 2**30, launches_per_step={k: n / steps for k, n in
                                     launches.items() if n},
         losses=losses, last_gnorm=float(gnorm),
         timing="median host ms per step, synchronised")
    return (state, step, batch, gen, med), launches


def phase_train_wavs(init_model, conformer_ctc_aed, train, wavs) -> None:
    """24 bf16 steps with dropout 0.1 on the committed WAVs (one batch of
    every usable utterance); warmup cut from 25000 to 4 steps so that the
    learning rate reaches its peak within the run. The median of the last
    5 losses must be below the first."""
    first, last5, curve = train_curve("train_wavs", init_model, train,
                                      conformer_ctc_aed(), on(wavs, "cuda"))
    emit("train_wavs", wavs=str(TRAIN_DIR.relative_to(ROOT)),
         utterances=len(wavs["feat_lengths"]), warmup_steps=4,
         first_loss=first, median_last5=last5, curve=curve)


def profile_step(state, step, batch, gen):
    """One training step under torch.profiler → (its wall ms, the card's
    busy ms, ms per kernel name). Run after every timing: the profiler
    slows what follows it in the process."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return (wall_ms, *device_busy(prof))


def phase_train_profile(state, step, batch, gen, timed_ms, mode="train",
                        kernel="k1", env=None) -> None:
    """One training step under torch.profiler (and the switches ``env``),
    run after every timing. ``kernel`` names what runs in
    ln_ffn_residual.cu's kernels on this path: K1, or K6 on the post-norm
    model (which launches no K1)."""
    with routes(**(env or {})):
        wall_ms, busy_ms, by_name = profile_step(state, step, batch, gen)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    emit("profile", mode=mode, timed_ms=timed_ms,
         profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
         idle_share=1.0 - busy_ms / timed_ms,
         idle_share_profiled=1.0 - busy_ms / wall_ms,
         switches=env or {},
         k8_ms=sum(v for k, v in by_name.items()
                   if any(key in k for key in K8_FWD_KERNELS
                          + K8_BWD_KERNELS)),
         **{f"{kernel}_fwd_ms": sum(v for k, v in by_name.items()
                                    if any(key in k
                                           for key in FFN_FWD_KERNELS)),
            f"{kernel}_bwd_ms": sum(v for k, v in by_name.items()
                                    if "ln_ffn_bwd" in k or "bwd16::" in k
                                    or "sum_partials" in k)},
         kernels=len(by_name),
         top=[{"kernel": k[:90], "ms": v} for k, v in top])


# Launch counters of the port's kernels: name -> (wrapper, attribute);
# filled in main once the modules are imported.
COUNTERS: dict = {}
NO_LAUNCHES = dict.fromkeys(("k1", "k1_bwd", "k2", "k3", "k4", "k4_bwd",
                             "k6", "k6_bwd", "k7", "k7_bwd", "k8", "k8_bwd",
                             "k9"), 0)
# Per conformer_ctc_aed training step: 24 encoder + 6 decoder FFN blocks
# (K1 forward and backward).
CTC_PER_STEP = {**NO_LAUNCHES, "k1": 30, "k1_bwd": 30}
# Per flagship training step: 24 encoder + 3 + 3 decoder FFN blocks (K1),
# one joint forward and backward (K2, K3), one predictor forward and
# backward (K4), one lattice (K9).
RNNT_PER_STEP = {**CTC_PER_STEP, "k2": 1, "k3": 1, "k4": 1, "k4_bwd": 1,
                 "k9": 1}
# rnnt_impl "pallas": the materialised joint, K9, no K2/K3.
PALLAS_PER_STEP = {**RNNT_PER_STEP, "k2": 0, "k3": 0}
# CONV_PALLAS=1: each of the 12 conv blocks is one K8 each way.
CONV_PER_STEP = {**RNNT_PER_STEP, "k8": 12, "k8_bwd": 12}
# LNMM_PALLAS=1: 12 QKV + 12 pointwise conv1 + 3 + 3 decoder
# self-attention projections, one K7 each way.
LNMM_PER_STEP = {**RNNT_PER_STEP, "k7": 30, "k7_bwd": 30}
# The post-norm transformer CTC/AED: 12 encoder + 6 decoder FFNs through
# K6 each way, no K1.
POSTNORM_PER_STEP = {**NO_LAUNCHES, "k6": 18, "k6_bwd": 18}
# The U2++ conformer: 24 encoder + 6 left + 3 right decoder FFN blocks
# through K1 each way; under CONV_PALLAS=1 its 12 causal conv blocks
# through K8 each way.
U2PP_PER_STEP = {**NO_LAUNCHES, "k1": 33, "k1_bwd": 33}
U2PP_CONV_PER_STEP = {**U2PP_PER_STEP, "k8": 12, "k8_bwd": 12}
# The kernels S3's CLI runs must launch (K2, K4 and K9 through
# ctc_beam_td_attn_rescoring's transducer_score); the exact counts are
# s3_want's.
RECOGNIZE_KERNELS = {**NO_LAUNCHES, "k1": 1, "k2": 1, "k4": 1, "k9": 1}
# The serving worker's chunks and the exported programs run K1 alone (the
# exact counts are checked in their phases).
SERVE_KERNELS = {**NO_LAUNCHES, "k1": 1}


def register_counters() -> None:
    """Each kernel wrapper's launch count under its key of NO_LAUNCHES."""
    from wenet_celoss_tpu_torch.ops import (conv, ffn, ln_matmul, lstm,
                                            rnnt_loss)
    COUNTERS.update(
        k1=(ffn.ln_ffn_residual, "launches"),
        k1_bwd=(ffn.ln_ffn_residual, "bwd_launches"),
        k2=(rnnt_loss.joint_planes, "launches"),
        k3=(rnnt_loss.joint_planes_bwd, "launches"),
        k4=(lstm.lstm2_seq, "launches"),
        k4_bwd=(lstm.lstm2_seq, "bwd_launches"),
        k6=(ffn.ffn_fused, "launches"),
        k6_bwd=(ffn.ffn_fused, "bwd_launches"),
        k7=(ln_matmul.ln_matmul, "launches"),
        k7_bwd=(ln_matmul.ln_matmul, "bwd_launches"),
        k8=(conv.conv_block_residual, "launches"),
        k8_bwd=(conv.conv_block_residual, "bwd_launches"),
        k9=(rnnt_loss.alpha_beta, "launches"))
    assert set(COUNTERS) == set(NO_LAUNCHES)


def reset_counts() -> None:
    for obj, attr in COUNTERS.values():
        setattr(obj, attr, 0)


def read_counts() -> dict:
    return {name: getattr(obj, attr) for name, (obj, attr) in
            COUNTERS.items()}


SPACE_ID = 1   # " " sorts first among the characters of the text
# Output size of the materialised-joint check: the characters of the
# committed transcripts (ids 1..27) and blank, rounded up.
CHAR_VOCAB = 32


def with_hotwords(batch, seed: int = 0, extra_slots: int = 2,
                  starts=frozenset({SPACE_ID})):
    """The batch with hotwords sampled from its own transcripts (words
    start at the space token) and per-token hw labels, built by the
    port's data/context.py, plus ``extra_slots`` empty phrase slots past
    ``context_n_valid``; ``starts``: the token ids that begin a word."""
    import random

    from wenet_celoss_tpu_torch.data.context import (context_batch,
                                                     context_generate)
    seqs = [[int(t) for t in y[:n]] for y, n in
            zip(batch["labels"], batch["label_lengths"])]
    ctx = context_generate(seqs, bpe_start_ids=set(starts),
                           rng=random.Random(seed))
    return {**batch, **context_batch(seqs, ctx,
                                     max_phrases=len(ctx) + extra_slots)}


def batch_norm_flagship(conformer_rnnt_bias):
    """The flagship config with the batch_norm conv module, as the repo's
    yaml sets it (examples/librispeech/conf/conformer_rnnt_bias.yaml:21;
    the card machine has no PyYAML, so the yaml is not read)."""
    def cfg():
        c = conformer_rnnt_bias()
        c["encoder_conf"]["cnn_module_norm"] = "batch_norm"
        return c
    return cfg


def no_dropout_rnnt(cfg):
    cfg = no_dropout(cfg)
    cfg["predictor_conf"].update(embed_dropout=0.0, dropout=0.0)
    return cfg


def phase_rnnt_train_check(init_model, train, wavs, refs,
                           what="rnnt_train_check", env=None,
                           want=RNNT_PER_STEP) -> dict:
    """One fp32 step of the full-width flagship of ``check_recipe(what)``
    (the streaming loss; "pallas" with a character vocabulary; the
    batch_norm conv module), dropout 0, on the card and on the CPU with
    the same weights and batch (16 committed WAVs, hotwords and hw labels
    from their transcripts): every loss term, the gradient norm, every
    parameter's gradient and the launches of every kernel. ``env`` is the
    card's switches (CONV, LNMM; the CPU runs the unfused modules, the
    plain flagship's step). Returns the launch counts."""
    env = env or {}
    cfg, batch, _, _ = check_recipe(what, wavs)
    model = init_model(cfg, seed=0)
    start = {k: v.cpu().clone() for k, v in model.state_dict().items()}
    reset_counts()
    with routes(**env):
        card_g, card_m = train.make_grad_fn(model)(
            train.TrainState(0, model, None), on(batch, "cuda"),
            torch.Generator())
        torch.cuda.synchronize()
    launches = read_counts()
    check(launches == want, f"{what}: launches {launches}, want {want}")
    fields = card_vs_cpu(what, model, (card_g, card_m), refs_result(
        refs, "step_" + CPU_STEP_OF.get(what, what),
        keep=what in CPU_STEP_OF.values()), loss_rtol=1e-5,
        start_state=start)
    emit(what, model="conformer_rnnt_bias", dtype="float32",
         cnn_module_norm=cfg["encoder_conf"]["cnn_module_norm"],
         rnnt_impl=cfg["model_conf"]["rnnt_impl"], switches=env,
         vocab=cfg["output_dim"],
         dropout=0.0, utterances=len(batch["feat_lengths"]),
         frames_max=int(batch["feat_lengths"].max()),
         labels_max=int(batch["label_lengths"].max()),
         phrases=int(batch["context_n_valid"]),
         phrase_slots=len(batch["context_lengths"]),
         hw_label_share=float((batch["hw_labels"] == 1).sum()
                              / batch["label_lengths"].sum()),
         **fields, launches=launches,
         tolerance="losses 1e-5 relative, gnorm 1e-4; each gradient 1e-3 "
                   "relative Frobenius (floor 1e-6 * gnorm for the key "
                   "biases, whose exact gradient is 0; a batch-normed "
                   "depthwise bias, also 0 exactly, under 1e-6 * gnorm on "
                   "both); running statistics 1e-4 of each tensor's "
                   "largest element")
    return launches



def phase_rnnt_train(init_model, conformer_rnnt_bias, train, b: int = 256,
                     t: int = 512, u: int = 32, what="rnnt_train",
                     impl="streaming", env=None, want=RNNT_PER_STEP,
                     steps=(2, 5), model_name="conformer_rnnt_bias",
                     **extra):
    """The flagship's training path in bf16 with dropout 0.1 at bench.py's
    training shape (B cut for the materialised joint of ``impl`` pallas)
    with 8 hotwords of 4 tokens and random hw labels, under the switches
    ``env``. This is that path's run: every kernel count is set to 0 just
    before it and read just after. ``steps``: (warm-up, timed) steps.
    Returns (what the profile needs, launches)."""
    env = env or {}
    warm, iters = steps
    held = torch.cuda.memory_allocated()   # earlier phases' live tensors
    cfg = conformer_rnnt_bias()
    cfg["dtype"] = "bfloat16"
    cfg["model_conf"]["rnnt_impl"] = impl
    v = cfg["output_dim"]
    model = init_model(cfg, seed=0)
    tx, _ = train.make_optimizer(cfg)
    state = train.create_train_state(model, tx)
    step = train.make_train_step(model, tx)
    rng = np.random.default_rng(0)
    batch = on({"feats": rng.standard_normal((b, t, 80)).astype(np.float32),
                "feat_lengths": np.full((b,), t, np.int64),
                "labels": rng.integers(1, v - 2, (b, u)),
                "label_lengths": np.full((b,), u, np.int64),
                "context_list": rng.integers(1, v - 2, (8, 4)),
                "context_lengths": np.full((8,), 4, np.int64),
                "hw_labels": rng.integers(0, 2, (b, u))}, "cuda")
    gen = torch.Generator().manual_seed(0)
    reset_counts()
    with routes(**env):
        state, losses, times, m, gnorm = timed_steps(step, state, batch,
                                                     gen, warm, iters)
    launches = read_counts()
    steps = warm + iters
    want = {k: n * steps for k, n in want.items()}
    check(launches == want, f"{what}: launches {launches} over {steps} "
                            f"steps, want {want}")
    check(all(np.isfinite(losses)), f"{what}: losses {losses}")
    med = sorted(times)[iters // 2]
    emit(what, model=model_name, dtype="bfloat16",
         rnnt_impl=impl, switches=env, **extra,
         dropout=0.1, batch=b, frames=t, labels=u, vocab=v, hotwords=8,
         steps_timed=iters, warmup_steps_run=warm, ms_per_step=med,
         ms_min_max=[min(times), max(times)],
         audio_s_per_s=b * t * 0.01 / (med / 1e3),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         held_before_gib=held / 2**30,
         launches_per_step={k: n / steps for k, n in launches.items()},
         losses=losses, last_gnorm=float(gnorm),
         last_terms={k: float(x) for k, x in m.items()},
         timing="median host ms per step, synchronised")
    return (state, step, batch, gen, med), launches


# ------------------------------------------------- V1-V3: model variants ---
# Every model the JAX factory builds, at the flagship's widths (d=256, 12
# blocks, vocab 5002, join 512, embed 256): other front ends and position
# encodings, concat_after, the embedding / GRU / conv predictors, the LSTM
# and transformer context towers, the pruned loss. (name, overrides of
# configs.conformer_rnnt_bias(), frames of the timed bf16 steps.)
def _v1(cfg):
    cfg["encoder_conf"].update(input_layer="conv2d6",
                               pos_enc_layer_type="rel_pos")
    cfg["context_conf"].update(context_extractor="transformer",
                               bias_encoder_type="transformer")
    cfg["predictor"] = "embedding"
    cfg["model_conf"]["rnnt_impl"] = "pruned"
    cfg["decoder_conf"]["concat_after"] = True


def _v2(cfg):
    cfg["encoder"] = "transformer"
    cfg["encoder_conf"].update(input_layer="conv2d8",
                               pos_enc_layer_type="no_pos",
                               concat_after=True)
    cfg["context_conf"]["context_extractor"] = "LSTM"
    cfg["predictor_conf"]["rnn_type"] = "gru"
    cfg["model_conf"]["rnnt_impl"] = "streaming"


def _v3(cfg):
    cfg["encoder_conf"].update(input_layer="linear",
                               pos_enc_layer_type="abs_pos")
    cfg["predictor"] = "conv"
    cfg["model_conf"]["rnnt_impl"] = "streaming"


# A linear front end keeps every frame (T' = T): V3's steps take 256.
VARIANTS = (("v1", _v1, 512), ("v2", _v2, 512), ("v3", _v3, 256))


def variant_config(conformer_rnnt_bias, overrides):
    def cfg():
        c = conformer_rnnt_bias()
        c["encoder_conf"].update(output_size=256, num_blocks=12)
        c["output_dim"] = 5002
        c["joint_conf"]["join_dim"] = 512
        c["predictor_conf"]["embed_size"] = 256
        overrides(c)
        return c
    return cfg


def variant_want(cfg) -> dict:
    """One training step's launches, derived from the config: K1 (and its
    backward) once a pre-norm FFN block (two a macaron conformer layer,
    one a transformer or decoder layer, one a block of the transformer
    extractor's 3 and of the transformer bias encoder's ``num_block``);
    the streaming loss one K2, K3 and K9; "pruned" one K9 (its simple
    loss); K4 only for a 2-layer LSTM predictor."""
    enc, dec = cfg["encoder_conf"], cfg["decoder_conf"]
    ctx, pred = cfg["context_conf"], cfg["predictor_conf"]
    k1 = enc["num_blocks"] * (2 if cfg.get("encoder") == "conformer" and
                              enc.get("macaron_style", True) else 1)
    k1 += dec["num_blocks"]
    if cfg["model_conf"].get("reverse_weight", 0.0) > 0:
        k1 += dec.get("r_num_blocks", 0)
    k1 += 3 if ctx["context_extractor"] == "transformer" else 0
    k1 += ctx["num_block"] if ctx["bias_encoder_type"] == "transformer" \
        else 0
    impl = cfg["model_conf"]["rnnt_impl"]
    lstm = int(cfg.get("predictor", "rnn") == "rnn" and
               pred.get("rnn_type", "lstm") == "lstm" and
               pred.get("num_layers", 2) == 2)
    stream = int(impl == "streaming")
    return {**NO_LAUNCHES, "k1": k1, "k1_bwd": k1, "k2": stream,
            "k3": stream, "k9": 1, "k4": lstm, "k4_bwd": lstm}


def s1_word_batch(n: int):
    """The first n of S1's WAVs with their transcripts as word ids (1..,
    in sorted word order): a few labels an utterance, so that CTC can
    align them after the x8 front end too."""
    names, feats, lens = load_wavs()
    text = dict(line.rstrip("\n").split(" ", 1) for line in
                (WAV_DIR.parent / "text").read_text().splitlines())
    words = sorted({w for t in text.values() for w in t.split()})
    ids = {w: i + 1 for i, w in enumerate(words)}
    labels = [[ids[w] for w in text[nm[:-4]].split()] for nm in names[:n]]
    batch = pad_batch([f[:m] for f, m in zip(feats[:n], lens[:n])], labels)
    return batch, set(ids.values())


def phase_variant_kernels(ffn, rnnt) -> None:
    """K1 in fp32 at the context towers' shapes (the transformer
    extractor's D=256, F=1024 over 8 phrases x (4 + CLS) rows, relu; the
    transformer bias encoder's F=512 over 10 phrase slots), forward and
    backward against the plain version (K1_GRADS, phase_k1_bwd's fp32
    rules); and K9 under the simple loss at V1's bf16 step shape (B=64,
    T'=86, U1=33, V=5002): the loss and the gradients of am and lm (K9's
    alpha and beta, the occupancy gradient) against autograd through the
    plain alpha_scan, both on the card."""
    for n, f in ((8 * 5, 1024), (10, 512)):
        args, dy = k1_inputs(n, torch.float32, seed=n, f=f)
        cfg = ("relu", 1.0, 1e-5, 0.0, 0.0, 0)
        ins = [a.detach().requires_grad_(True) for a in args]
        y = ffn.ln_ffn_residual(*ins, *cfg)
        got = torch.autograd.grad(y, ins, dy)
        want = (ffn.ln_ffn_residual_ref(*args, *cfg),
                *ffn.backward_ref(args[0], dy, *args[1:], *cfg))
        rows = relu_kink_free_rows(args)
        errs, ok = {}, True
        for name, a, b in zip(K1_GRADS, (y.detach(), *got), want):
            err = a.float() - b.float()
            rel = float(err.norm() / b.float().norm())
            if name in ("y", "dx"):
                bad = err.abs() > 1e-4 + 1e-4 * b.float().abs()
                good = not bool((bad[rows] if name == "dx" else bad).any())
            else:
                good = rel <= 1e-2
            errs[name] = {"max_abs": float(err.abs().max()), "rel_fro": rel,
                          "ok": good}
            ok = ok and good
        check(ok, f"v_kernels k1 n={n} f={f}: {errs}")
        emit("v_kernels", kernel="k1", n=n, d=256, f=f, dtype="float32",
             ok=ok, errors=errs, tolerance="y, dx: max abs <= 1e-4 + "
             "1e-4*|ref| (dx over rows away from relu's kink); weight "
             "gradients relative Frobenius <= 1e-2")
    g = torch.Generator().manual_seed(86)
    b, t, u1, v = 64, 86, 33, 5002
    am = (2 * torch.randn(b, t, v, generator=g)).cuda().requires_grad_()
    lm = (2 * torch.randn(b, u1, v, generator=g)).cuda().requires_grad_()
    labels = torch.randint(1, v, (b, u1 - 1), generator=g).cuda()
    il = torch.randint(t // 2, t + 1, (b,), generator=g).cuda()
    ll = torch.randint(0, u1, (b,), generator=g).cuda()
    launches = rnnt.alpha_beta.launches
    loss = rnnt.rnnt_loss_simple(am, lm, labels, il, ll)
    got = torch.autograd.grad(loss.sum(), (am, lm))
    k9 = rnnt.alpha_beta.launches - launches
    blank_lp, emit_lp = rnnt.factored_planes(am, lm, labels, 0)
    alpha = rnnt.alpha_scan(blank_lp, emit_lp)
    rows = torch.arange(b, device="cuda")
    ref = -(alpha[rows, il - 1, ll] + blank_lp[rows, il - 1, ll])
    want = torch.autograd.grad(ref.sum(), (am, lm))
    loss_rel = float(((loss - ref).abs() / ref.abs()).max().detach())
    grads = {n: float((a - r).norm() / r.norm())
             for n, a, r in zip(("am", "lm"), got, want)}
    ok = loss_rel <= 1e-5 and max(grads.values()) <= 1e-3 and k9 == 1
    check(ok, f"v_kernels k9 simple loss: loss rel {loss_rel}, grads "
              f"{grads}, K9 launches {k9}")
    emit("v_kernels", kernel="k9", use="rnnt_loss_simple", B=b, T=t, U1=u1,
         V=v, ok=ok, loss_max_rel=loss_rel, grad_rel_fro=grads,
         k9_launches=k9, tolerance="loss 1e-5 relative, gradients 1e-3 "
         "relative Frobenius (T3's gradient bound) against autograd "
         "through alpha_scan")
    # The pruned lattice (plain torch, no kernel of its own) at V1's step:
    # its window joint [B, T', S, V] in bf16, forward and backward.
    s_range = 5
    ranges = rnnt.get_rnnt_prune_ranges(am.detach(), lm.detach(), labels,
                                        il, ll, s_range)
    logits = (2 * torch.randn(b, t, s_range, v, generator=g)).to(
        torch.bfloat16).cuda().requires_grad_()

    def pruned():
        loss = rnnt.rnnt_loss_pruned(logits, ranges, labels, il, ll)
        return torch.autograd.grad(loss.sum(), logits)
    ms = cuda_ms(pruned, iters=5, warmup=2)
    prof, _ = device_profile(pruned, 1, 1)
    busy, _ = device_busy(prof)
    emit("v_kernels", what="rnnt_loss_pruned", B=b, T=t, S=s_range, V=v,
         dtype="bfloat16", ms_fwd_bwd=ms, card_intervals=device_events(prof),
         card_busy_ms=busy, idle_share=1.0 - busy / ms,
         timing="CUDA events over 5 forward + backward calls; card "
                "intervals and busy ms from one profiled call")


def phase_variant(name, overrides, frames, init_model, conformer_rnnt_bias,
                  train, Decoder, refs) -> tuple:
    """One of V1-V3 (see VARIANTS): one fp32 step on 4 of S1's WAVs with
    hotwords and dropout 0, card against CPU with T3's bounds; two bf16
    steps at B=64 x ``frames`` with dropout 0.1, the second timed; the
    gated ("on") greedy and the RNN-T beam (beam 4) decodes of S1's 16
    WAVs (blank bias +3.0, as S1), card against CPU by S1's flip rules
    (the CPU sides from the CPU references' process). Each
    training run's launches against variant_want. Returns the bf16 run's
    (launches, want) and what its profile needs."""
    t0 = time.perf_counter()
    cfg_fn = variant_config(conformer_rnnt_bias, overrides)
    want = variant_want(cfg_fn())
    impl = cfg_fn()["model_conf"]["rnnt_impl"]
    cfg, batch, _, _ = check_recipe(name + "_check", None)
    model = init_model(cfg, seed=0)
    start = {k: v.cpu().clone() for k, v in model.state_dict().items()}
    reset_counts()
    card = train.make_grad_fn(model)(train.TrainState(0, model, None),
                                     on(batch, "cuda"), torch.Generator())
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches == want, f"{name} fp32 step: launches {launches}, want "
                            f"{want}")
    fields = card_vs_cpu(f"{name}_check", model, card, refs_result(
        refs, f"step_{name}_check"), start_state=start)
    t_check = time.perf_counter() - t0
    emit(f"{name}_check", dtype="float32", rnnt_impl=impl, dropout=0.0,
         utterances=4, labels=batch["label_lengths"].tolist(),
         phrases=int(batch["context_n_valid"]), **fields,
         launches=launches, seconds=t_check,
         tolerance="losses 1e-4 relative, gnorm 1e-4; each gradient 1e-3 "
                   "relative Frobenius (floor 1e-6 * gnorm)")

    _, feats, lens = load_wavs()
    ctx, ctx_lens = hotwords(cfg["output_dim"])
    with_blank_bias(model, SLICE_BLANK_BIAS)
    dec = Decoder(model)
    decodes = {}
    reset_counts()
    t1 = time.perf_counter()
    g_card = decode(dec, feats, lens, ctx, ctx_lens, "gated_on")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    b_card, _, _ = dec.rnnt_beam_search(feats, lens, beam=4)
    torch.cuda.synchronize()
    decode_ms = {"gated_on": (t2 - t1) * 1e3,
                 "rnnt_beam": (time.perf_counter() - t2) * 1e3}
    decode_launches = read_counts()
    ref = refs_result(refs, f"{name}_decodes")
    g_cpu, trace = ref["gated_on"]
    for mode, (same, ties, bad), toks in (
            ("gated_on", compare(g_card, g_cpu, trace), g_card[0]),
            ("rnnt_beam", compare_nbest(dec.rnnt_beam_to_lists(b_card),
                                        ref["rnnt_beam"]),
             dec.rnnt_beam_to_lists(b_card))):
        check(not bad, f"{name} {mode}: card and CPU differ away from a "
                       f"near tie: {bad}")
        check(sum(map(len, toks)) > 0, f"{name} {mode}: no token emitted")
        decodes[mode] = dict(identical_to_cpu=same, near_tie_flips=ties,
                             tokens=sum(map(len, toks)),
                             card_ms=decode_ms[mode])
    del dec, model

    cfg_bf16 = variant_config(conformer_rnnt_bias, overrides)
    run, launches = phase_rnnt_train(
        init_model, cfg_bf16, train, b=64, t=frames, what=f"{name}_train",
        impl=impl, want=want, steps=(1, 1), model_name=name)
    emit(name, seconds=time.perf_counter() - t0, check_seconds=t_check,
         decode_launches=decode_launches,
         decodes=decodes, train_ms_per_step=run[-1], frames=frames,
         blank_bias=SLICE_BLANK_BIAS, utterances_decoded=len(lens))
    return (launches, want), run


def refs_variant_decodes(name: str, cfg: dict):
    """A variant's decodes on the CPU (in the CPU references' process):
    its fp32 model (seed 0, dropout 0, blank bias +3.0) over S1's WAVs,
    gated "on" with its top-2 gaps and the RNN-T beam (beam 4)."""
    from wenet_celoss_tpu_torch.decode.api import Decoder
    from wenet_celoss_tpu_torch.models.factory import init_model
    _, feats, lens = load_wavs()
    ctx, ctx_lens = hotwords(cfg["output_dim"])
    cpu_dec = Decoder(with_blank_bias(init_model(cfg, device="cpu", seed=0),
                                      SLICE_BLANK_BIAS), device="cpu")
    trace: list = []
    yield f"{name}_decodes", {
        "gated_on": (decode(cpu_dec, feats, lens, ctx, ctx_lens, "gated_on",
                            trace), trace),
        "rnnt_beam": cpu_dec.rnnt_beam_search(feats, lens, beam=4)[0]}



def phase_rnnt_train_wavs(init_model, conformer_rnnt_bias, train,
                          wavs, what="rnnt_train_wavs") -> None:
    """24 bf16 steps of the flagship with dropout 0.1 on the committed
    WAVs with hotwords from their transcripts; warmup cut to 4 steps. The
    median of the last 5 losses must be below the first."""
    batch = on(with_hotwords(wavs), "cuda")
    first, last5, curve = train_curve(what, init_model, train,
                                      conformer_rnnt_bias(), batch)
    emit(what, wavs=str(TRAIN_DIR.relative_to(ROOT)),
         utterances=len(wavs["feat_lengths"]),
         phrases=int(batch["context_n_valid"]), warmup_steps=4,
         first_loss=first, median_last5=last5, curve=curve)


def phase_rnnt_profile(state, step, batch, gen, timed_ms,
                       mode="rnnt_train", env=None) -> None:
    """One flagship training step under torch.profiler, run after every
    timing: busy time, idle share, each kernel's time. K4's forward and
    backward and K9 (every flagship path) and, on the LNMM_PALLAS path,
    K7's and, on the CONV_PALLAS path, K8's must read above 0 ms: a
    profile that misses them is taken again (the profiler drops card
    intervals now and then), and three that miss them fail the run, so
    that a kernel renamed away from K4_*_KERNELS, K9_KERNELS, K7_*_KERNELS
    or K8_*_KERNELS cannot read 0 silently."""
    lnmm = mode == "lnmm_train"
    conv_path = mode == "conv_train"

    def ms(*keys):
        return sum(v for k, v in by_name.items() if any(s in k for s in keys))

    def seen():
        return ms(*K4_FWD_KERNELS) > 0 and ms(*K4_BWD_KERNELS) > 0 and \
            ms(*K9_KERNELS) > 0 and (
            not lnmm or (ms(*K7_FWD_KERNELS) > 0 and
                         ms(*K7_BWD_KERNELS) > 0)) and (
            not conv_path or (ms(*K8_FWD_KERNELS) > 0 and
                              ms(*K8_BWD_KERNELS) > 0))
    with routes(**(env or {})):
        for _ in range(3):
            wall_ms, busy_ms, by_name = profile_step(state, step, batch, gen)
            if seen():
                break
    check(seen(), f"{mode} profile: K4's kernels "
                  f"{K4_FWD_KERNELS + K4_BWD_KERNELS}, K9's {K9_KERNELS}"
                  + (f" or K7's {K7_FWD_KERNELS + K7_BWD_KERNELS}"
                     if lnmm else "")
                  + (f" or K8's {K8_FWD_KERNELS + K8_BWD_KERNELS}"
                     if conv_path else "") + " read 0 ms in 3 profiles")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit("profile", mode=mode, timed_ms=timed_ms,
         profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
         idle_share=1.0 - busy_ms / timed_ms,
         idle_share_profiled=1.0 - busy_ms / wall_ms,
         k1_fwd_ms=ms(*FFN_FWD_KERNELS),
         k1_bwd_ms=ms("ln_ffn_bwd", "bwd16::", "namespace)::sum_partials"),
         k2_ms=ms("joint_fwd"), k3_ms=ms("joint_bwd_rows",
                                         "joint_bwd_weights"),
         k4_ms=ms(*K4_FWD_KERNELS), k4_bwd_ms=ms(*K4_BWD_KERNELS),
         tile_partial_sums_ms=ms("tile::sum_partials"),
         k9_ms=ms(*K9_KERNELS), k8_fwd_ms=ms(*K8_FWD_KERNELS),
         k8_bwd_ms=ms(*K8_BWD_KERNELS),
         k7_fwd_ms=ms(*K7_FWD_KERNELS), k7_bwd_ms=ms(*K7_BWD_KERNELS),
         kernels=len(by_name),
         top=[{"kernel": k[:90], "ms": v} for k, v in top])


def _ancestors(e):
    while e.cpu_parent is not None:
        e = e.cpu_parent
        yield e


def int64_elementwise(name: str) -> bool:
    """A PyTorch element-wise kernel on int64 ("long") operands."""
    return "elementwise" in name and ("<long" in name or "long>" in name
                                      or "long," in name or "int64" in name)


def _mask_site() -> str:
    """The port's file:line that called into ops/dropout.py."""
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename.endswith("ops/dropout.py"):
        f = f.f_back
    if f is None:
        return "?"
    return (f"{f.f_code.co_filename.split('wenet_celoss_tpu_torch/')[-1]}"
            f":{f.f_lineno}")


def phase_int64_sites(state, step, batch, gen, dropout, mode="rnnt_train",
                      top: int = 12) -> None:
    """Where a training step's int64 element-wise kernels come from: one
    extra step under torch.profiler with input shapes (after the timed and
    profiled steps, which it leaves untouched), ``dropout.apply_mask``
    wrapped for that step in a record_function named by its caller's
    file:line. Each int64 kernel is charged to the op that launched it and
    the op to the enclosing apply_mask call, else to its Python stack
    where the profiler recorded one."""
    from torch.profiler import (ProfilerActivity, profile,
                                record_function)
    plain = dropout.apply_mask

    def traced(*args, **kw):
        with record_function("apply_mask@" + _mask_site()):
            return plain(*args, **kw)
    dropout.apply_mask = traced
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True, with_stack=True) as prof:
            step(state, batch, gen)
            torch.cuda.synchronize()
    finally:
        dropout.apply_mask = plain
    _, by_name = device_busy(prof)
    card_ms = sum(v for k, v in by_name.items() if int64_elementwise(k))
    sites = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        ks = [k for k in getattr(e, "kernels", []) if
              int64_elementwise(k.name)]
        if not ks:
            continue
        where = next((a.name for a in _ancestors(e)
                      if a.name.startswith("apply_mask@")), None)
        if where is None:
            frames = [f for f in (getattr(e, "stack", None) or [])
                      or [a.name for a in _ancestors(e)]
                      if "wenet_celoss_tpu_torch" in f]
            where = (frames[0].split("wenet_celoss_tpu_torch/")[-1]
                     if frames else "(outside apply_mask, no Python stack)")
        shape = str(e.input_shapes[0]) if e.input_shapes else "?"
        ms_, n, ops = sites.get((where, shape), (0.0, 0, set()))
        sites[(where, shape)] = (ms_ + sum(k.duration for k in ks) / 1e3,
                                 n + len(ks), ops | {e.name})
    ranked = sorted(sites.items(), key=lambda kv: -kv[1][0])
    emit("int64_sites", mode=mode, int64_elementwise_card_ms=card_ms,
         attributed_ms=sum(v[0] for v in sites.values()),
         in_apply_mask_ms=sum(v[0] for (w, _), v in sites.items()
                              if w.startswith("apply_mask@")),
         kernels=sorted(((k[:100], v) for k, v in by_name.items()
                         if int64_elementwise(k)), key=lambda kv: -kv[1])[:6],
         sites=[{"site": w, "shape": shp, "ms": m, "launches": n,
                 "ops": sorted(ops)}
                for (w, shp), (m, n, ops) in ranked[:top]],
         note="one extra profiled step; the profiler may drop card "
              "intervals, so attributed_ms may read below the card's sum")


def limited_chunk_seed(wavs) -> int:
    """The first generator seed whose dynamic-chunk draw over T0's batch
    (the first 16 WAVs) is a chunk, not the full context: T11-check then
    holds the chunk mask, not the full one, card against CPU."""
    from wenet_celoss_tpu_torch.utils.mask import draw_dynamic_chunk
    t_sub = subsampled(int(head(wavs, 16)["feat_lengths"].max()))
    seed = 0
    while draw_dynamic_chunk(t_sub, False, torch.Generator().manual_seed(
            seed))[0] >= t_sub:
        seed += 1
    return seed


# ------------------------------------------------- the train CLI (T12) ---
FLAGSHIP_YAML = ROOT / "examples" / "librispeech" / "conf" / \
    "conformer_rnnt_bias.yaml"
DEV_DIR = DATA_DIR / "dev-clean"
LOSS_KEYS = ("loss", "loss_rnnt", "loss_ctc", "loss_att", "hw_loss")
RECORD_KEYS = {"epoch", "batch", "step", "lr", "audio_s_per_s"}
# Per flagship micro-batch of the train CLI (the yaml's rnnt_impl is not
# read, so the loss is "scan": the plain wavefront on the materialised
# joint, no K9, K2 or K3): K1 30 each way, K4 1 each way; per cv batch the
# forwards only.
CLI_PER_BATCH = {**NO_LAUNCHES, "k1": 30, "k1_bwd": 30, "k4": 1,
                 "k4_bwd": 1}
CLI_PER_CV_BATCH = {**NO_LAUNCHES, "k1": 30, "k4": 1}


def write_data_list(path: Path, part: Path, n: int = 0) -> list:
    """data.list (paths under this checkout) and wav.scp beside it of the
    first ``n`` (all with 0) WAVs of a committed part; returns the keys."""
    text = dict(line.split(" ", 1) for line in
                (part / "text").read_text().splitlines())
    wavs = sorted((part / "wavs").glob("*.wav"))
    wavs = wavs[:n] if n else wavs
    with open(path, "w") as f, open(path.with_suffix(".scp"), "w") as g:
        for wav in wavs:
            f.write(json.dumps({"key": wav.stem, "wav": str(wav),
                                "txt": text[wav.stem]}) + "\n")
            g.write(f"{wav.stem} {wav}\n")
    return [w.stem for w in wavs]


@contextlib.contextmanager
def wrapped(obj, name: str, make):
    """``obj.name`` replaced by ``make(original)`` for the block."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def trace_busy(path: Path):
    """The card's busy ms (union of its kernel, memcpy and memset
    intervals) and the interval count in a torch.profiler chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("ph") == "X" and e.get("cat") in
                   ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e3, len(spans)


class CliProbe:
    """Records what one in-process train CLI run does: the built model,
    the train loader, each train epoch's and cv pass's seconds (the card
    synchronised) and each cv pass's batches."""

    def __init__(self):
        self.model = self.loader = None
        self.epoch_s, self.cv_s, self.cv_batches, self.startup_s = \
            [], [], [], []

    @contextlib.contextmanager
    def watch(self):
        from wenet_celoss_tpu_torch.data import loader
        from wenet_celoss_tpu_torch.models import factory
        from wenet_celoss_tpu_torch.parallel import executor
        probe = self

        def init_model(orig):
            def f(*a, **kw):
                probe.model = orig(*a, **kw)
                return probe.model
            return f

        def make_loader(orig):
            def f(*a, **kw):
                probe.loader = orig(*a, **kw)
                return probe.loader
            return f

        def sync():
            if probe.model is not None and \
                    next(probe.model.parameters()).is_cuda:
                torch.cuda.synchronize()

        def train_epoch(orig):
            def f(self, state, data, epoch=0):
                sync()
                t0 = time.perf_counter()
                out = orig(self, state, data, epoch)
                sync()
                probe.epoch_s.append(time.perf_counter() - t0)
                probe.startup_s.append(getattr(probe.loader, "startup_s",
                                               None))
                return out
            return f

        def cv(orig):
            def f(self, state, data):
                probe.cv_batches.append(0)

                def counted():
                    for b in data:
                        probe.cv_batches[-1] += 1
                        yield b
                sync()
                t0 = time.perf_counter()
                out = orig(self, state, counted())
                sync()
                probe.cv_s.append(time.perf_counter() - t0)
                return out
            return f

        with wrapped(factory, "init_model", init_model), \
                wrapped(loader, "make_loader", make_loader), \
                wrapped(executor.Executor, "train_epoch", train_epoch), \
                wrapped(executor.Executor, "cv", cv):
            yield self


def t12_inputs(tmp: Path) -> tuple:
    """T12's and D4's inputs in ``tmp``: cli_inputs over all 200 train
    WAVs and T12's config as ``conf.yaml``."""
    from wenet_celoss_tpu_torch.utils.config import save_config
    inputs = cli_inputs(tmp)
    save_config(load_t12_config(), str(tmp / "conf.yaml"))
    return inputs


def cli_inputs(tmp: Path, n_train: int = 0) -> tuple:
    """The train list (the first ``n_train`` train-clean-100 WAVs, all 200
    with 0), the 16 dev-clean WAVs as the cv list, S3's 5002-symbol table
    and the global CMVN of the train WAVs by the port's
    compute_cmvn_stats → (shared CLI arguments, cv keys)."""
    from wenet_celoss_tpu_torch.bin import compute_cmvn_stats
    write_data_list(tmp / "train.list", TRAIN_DIR, n_train)
    cv_keys = write_data_list(tmp / "cv.list", DEV_DIR)
    write_units(tmp / "units.txt", 5002)
    compute_cmvn_stats.main(["--train_config", str(FLAGSHIP_YAML),
                             "--in_scp", str(tmp / "train.scp"),
                             "--out_cmvn", str(tmp / "global_cmvn"),
                             "--log_interval", "100000"])
    return ["--train_data", str(tmp / "train.list"), "--cv_data",
            str(tmp / "cv.list"), "--symbol_table", str(tmp / "units.txt"),
            "--cmvn", str(tmp / "global_cmvn")], cv_keys


def run_train_cli(train_cli, argv, probe=None):
    """One in-process run of the port's train CLI; mode-1 hotword sampling
    draws from the global ``random``, seeded here as for every run."""
    import random
    random.seed(0)
    with (probe.watch() if probe else contextlib.nullcontext()):
        train_cli.main(argv)


def read_records(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


def train_cli_child(argv: list, result: str, with_sha: bool = False) -> None:
    """T12's run, in a process of its own that ``train_cli_process``
    starts with ``python -c``: the train CLI in process under a CliProbe,
    every launch count set to 0 just before it and read just after, into
    the JSON file ``result``. The loader's spawned workers then import the
    CLI's data modules only (a ``-c`` main module is not re-imported), not
    this script and torch with it, as when a user runs ``python -m
    wenet_celoss_tpu_torch.bin.train``. ``with_sha``: the JSON also holds
    the trained model's ``state_sha``."""
    import logging
    from wenet_celoss_tpu_torch.bin import train as train_cli
    logging.basicConfig(level=logging.WARNING)
    register_counters()
    probe = CliProbe()
    reset_counts()
    t0 = time.perf_counter()
    run_train_cli(train_cli, argv, probe)
    if next(probe.model.parameters()).is_cuda:
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    Path(result).write_text(json.dumps(dict(
        launches=read_counts(), run_s=run_s, epoch_s=probe.epoch_s,
        cv_s=probe.cv_s, startup_s=probe.startup_s,
        cv_batches=probe.cv_batches,
        rnnt_impl=getattr(probe.model, "rnnt_impl", None),
        model_sha=state_sha(probe.model) if with_sha else None)))


def train_cli_process(argv: list, result: Path, timeout_s: int = 400):
    """``train_cli_child(argv, result)`` in a new process (and session, so
    that a run past ``timeout_s`` is killed with its loader workers) →
    (the process's seconds, the child's JSON). Raises if the process fails
    or runs past ``timeout_s``."""
    import signal
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; "
            "chip_smoke.train_cli_child(json.loads(sys.argv[2]), sys.argv[3])")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", code, str(ROOT), json.dumps(argv),
         str(result)], cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        _, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"train_cli: the CLI's process ran past "
                           f"{timeout_s} s and was killed")
    if proc.returncode != 0:
        raise RuntimeError(f"train_cli: the CLI's process exited "
                           f"{proc.returncode}: {err[-3000:]}")
    return time.perf_counter() - t0, json.loads(result.read_text())


# T12's epochs: one since PR 20 (two before), to keep the whole script
# inside its time budget.
T12_EPOCHS = 1


def phase_train_cli(t12_dir: Path, t12) -> dict:
    """T12: the port's train CLI on the yaml flagship as it stands (bf16,
    batch_norm, dither 0.1, speed perturb, spec_aug, context mode 1,
    dynamic batches of 6000 frames, accum_grad 4) plus two loader
    processes and a record a batch: the 200 train-clean-100 WAVs, cv on
    the 16 dev-clean WAVs, T12_EPOCHS epochs, --step_checkpoint_interval
    1, --profile_dir. One run, in a process of its own
    (``train_cli_process``: its loader workers import no torch, as a
    user's do): its files, its config, its records, its model's rnnt_impl
    and its launches against the counts derived from its batches, its
    epochs' seconds and loader start-up, and epoch 0's card busy time
    from the trace. Then average_model --num T12_EPOCHS and the recognize
    CLI (rnnt_greedy_search) on the average with the CLI's train.yaml.
    Returns the run's launches and the derived counts. Its inputs
    (``t12_inputs``, in ``t12_dir``) are D4's too."""
    from wenet_celoss_tpu_torch.bin import average_model, recognize
    from wenet_celoss_tpu_torch.utils import checkpoint as ckpt
    from wenet_celoss_tpu_torch.utils.config import load_config
    from wenet_celoss_tpu_torch.utils.scheduler import warmup_lr
    with contextlib.nullcontext(t12_dir) as tmp:
        base, cv_keys = t12
        cfg = load_t12_config()
        out = tmp / "exp"
        argv = ["--config", str(tmp / "conf.yaml"), "--model_dir", str(out),
                "--num_epochs", str(T12_EPOCHS),
                "--step_checkpoint_interval", "1",
                "--profile_dir", str(tmp / "prof")] + base
        torch.cuda.empty_cache()
        process_s, child = train_cli_process(argv, tmp / "child.json")
        launches = child["launches"]
        recs = read_records(out / "metrics.jsonl")
        epochs = range(T12_EPOCHS)
        per_epoch = [sum(r["epoch"] == e for r in recs) for e in epochs]
        want = {k: sum(per_epoch) * CLI_PER_BATCH[k]
                + sum(child["cv_batches"]) * CLI_PER_CV_BATCH[k]
                for k in NO_LAUNCHES}
        check(launches == want, f"train_cli: launches {launches}, want "
                                f"{want}")
        check(child["rnnt_impl"] == "scan",
              "train_cli: the built model's rnnt_impl is not scan")
        schedule = warmup_lr(cfg["optim_conf"]["lr"],
                             cfg["scheduler_conf"]["warmup_steps"])
        infos = [ckpt.load_checkpoint_infos(str(out / f"{e}.pt"))
                 for e in epochs]
        # A partial accumulation at an epoch's end is dropped.
        steps_by_epoch = [sum(n // cfg["accum_grad"]
                              for n in per_epoch[:e + 1]) for e in epochs]
        for e, info in enumerate(infos):
            check((out / f"{e}.pt").exists() and info.get("epoch") == e
                  and info.get("step") == steps_by_epoch[e]
                  and np.isfinite(info.get("cv_loss", np.nan))
                  and info.get("lr") == schedule(max(info["step"], 1)),
                  f"train_cli: {e}.pt infos {info}")
        last = f"{T12_EPOCHS - 1}.pt"
        check(os.readlink(out / "final.pt") == last,
              f"train_cli: final.pt does not link to {last}")
        states = sorted(p.name for p in out.glob("step_*.state"))
        check(states == [f"step_{n}.state" for n in
                         range(1, steps_by_epoch[-1] + 1)] and states,
              f"train_cli: step files {states}")
        written = dict(cfg, input_dim=80, output_dim=5002,
                       cmvn_file=str(tmp / "global_cmvn"),
                       is_json_cmvn=True)
        written["dataset_conf"]["batch_conf"]["round_to"] = 1
        check(load_config(str(out / "train.yaml")) == written,
              "train_cli: train.yaml differs from the config it was given")
        bad = [r for r in recs if not RECORD_KEYS | set(LOSS_KEYS) <= set(r)
               or not all(np.isfinite(r[k]) for k in LOSS_KEYS)]
        stepped = [r["batch"] for r in recs if "grad_norm" in r]
        check(len(recs) == sum(per_epoch) and not bad
              and len(stepped) == steps_by_epoch[-1],
              f"train_cli: {len(recs)} records, bad {bad[:2]}, "
              f"{len(stepped)} with grad_norm")

        t1 = time.perf_counter()
        average_model.main(["--dst_model", str(out / "avg.pt"),
                            "--src_path", str(out), "--num",
                            str(T12_EPOCHS)])
        avg_from = ckpt.load_checkpoint_infos(str(out / "avg.pt")).get(
            "averaged_from", [])
        recognize.main(["--config", str(out / "train.yaml"), "--test_data",
                        str(tmp / "cv.list"), "--checkpoint",
                        str(out / "avg.pt"), "--symbol_table",
                        str(tmp / "units.txt"), "--result_file",
                        str(tmp / "rec" / "text"), "--mode",
                        "rnnt_greedy_search", "--batch_size", "16"])
        lines = (tmp / "rec" / "text").read_text().splitlines()
        check(sorted(p.split()[0] for p in avg_from) ==
              sorted(str(out / f"{e}.pt") for e in epochs) and
              sorted(line.split(" ", 1)[0] for line in lines) ==
              sorted(cv_keys),
              f"train_cli: average of {avg_from}, {len(lines)} recognize "
              f"lines for {len(cv_keys)} dev-clean WAVs")
        tools_s = time.perf_counter() - t1

        epoch_s, startup_s = child["epoch_s"], child["startup_s"]
        busy_ms, intervals = trace_busy(tmp / "prof" / "trace.json")
        audio_s = [[r["audio_s_per_s"] for r in recs if r["epoch"] == e][-1]
                   for e in epochs]
        emit("train_cli", model="conformer_rnnt_bias (yaml)",
             dtype=cfg["dtype"], rnnt_impl=child["rnnt_impl"],
             accum_grad=cfg["accum_grad"],
             loader_processes=2, train_wavs=200, cv_wavs=len(cv_keys),
             micro_batches_per_epoch=per_epoch,
             cv_batches_per_epoch=child["cv_batches"],
             epochs=T12_EPOCHS, optimizer_steps=steps_by_epoch[-1],
             process_s=process_s, run_s=child["run_s"], epoch_s=epoch_s,
             cv_s=child["cv_s"], loader_startup_s=startup_s,
             cli_audio_s_per_s_last_record=audio_s,
             epoch0_busy_ms=busy_ms, epoch0_card_intervals=intervals,
             epoch0_idle_share=1 - busy_ms / (1e3 * epoch_s[0]),
             epoch0_idle_share_after_startup=1 - busy_ms / (
                 1e3 * (epoch_s[0] - startup_s[0])),
             epoch0_profiled=True, cv_loss=[i["cv_loss"] for i in infos],
             first_loss=recs[0]["loss"], last_loss=recs[-1]["loss"],
             launches=launches, want=want, avg_recognize_s=tools_s,
             recognize_lines=len(lines), step_files=states)
    return launches, want


# Tensors of the flagship (batch_norm conv modules) whose gradient is 0 in
# exact arithmetic: softmax ignores a shift shared by all keys, and the
# batch norm cancels the depthwise conv's bias.
ZERO_GRAD = ("linear_k.bias", "depthwise_conv.bias")


def compare_first_step(names, card, cpu, tx) -> dict:
    """T12-check's comparison of two runs' state after one optimizer step
    from the same weights: ``card`` and ``cpu`` are (0.pt's state_dict,
    step_1.state's payload). Adam's moments, tensor by tensor, to T3's
    gradient bounds (mu is (1 - b1) times the clipped gradient, nu
    (1 - b2) times its square): mu to 1e-3 relative Frobenius, nu to 2e-3;
    a ZERO_GRAD tensor's mu to 1e-6 of the global norm of mu, its nu left
    out (0.1 mu^2 at count 1). Each parameter to 1e-3 relative Frobenius
    once the difference that the two sides' own moments give through
    Adam's first update is taken out: a step moves an element by the
    learning rate times mu_hat / (sqrt(nu_hat) + eps), about the rate
    itself wherever the gradient is above eps, so a zero-initialised bias
    whose gradient is at rounding level in places can land either side
    of 0 on the two devices (the norm of the larger side is the scale).
    The running statistics to 1e-4 of each
    tensor's largest element. Returns the fields of the phase's line;
    ``ok`` is False if any bound is broken."""
    (card_p, card_s), (cpu_p, cpu_s) = card, cpu
    mom = {side: {tag: dict(zip(names, st["opt"][tag]))
                  for tag in ("mu", "nu")}
           for side, st in (("card", card_s), ("cpu", cpu_s))}
    g_mu = float(torch.linalg.vector_norm(torch.stack(
        [m.norm() for m in mom["cpu"]["mu"].values()])))
    lr = tx.schedule(0)

    def update(side, k):
        m_hat = mom[side]["mu"][k].double() / (1 - tx.b1)
        v_hat = mom[side]["nu"][k].double() / (1 - tx.b2)
        return lr * m_hat / (v_hat.sqrt() + tx.eps)

    worst = {"mu": (0.0, None), "nu": (0.0, None), "param": (0.0, None),
             "zero_grad_mu": (0.0, None)}

    def note(tag, ratio, k):
        if ratio > worst[tag][0]:
            worst[tag] = (ratio, k)
    for k in names:
        a, b = mom["card"]["mu"][k], mom["cpu"]["mu"][k]
        if k.endswith(ZERO_GRAD):
            note("zero_grad_mu", float((a - b).norm()) / (1e-6 * g_mu), k)
        else:
            note("mu", rel_fro(a, b) / 1e-3, k)
            note("nu", rel_fro(mom["card"]["nu"][k],
                               mom["cpu"]["nu"][k]) / 2e-3, k)
        # card - cpu = (p0 - lr u_card) - (p0 - lr u_cpu)
        explained = update("cpu", k) - update("card", k)
        rest = (card_p[k].double() - cpu_p[k].double()) - explained
        size = max(float(card_p[k].norm()), float(cpu_p[k].norm()), 1e-30)
        note("param", float(rest.norm()) / size / 1e-3, k)
    stats = [k for k in cpu_p if k.endswith(("running_mean", "running_var"))]
    stat_err = max(float((card_p[k] - cpu_p[k]).abs().max())
                   / float(cpu_p[k].abs().max()) for k in stats)
    raw = max((rel_fro(card_p[k], cpu_p[k]), k) for k in names)
    ok = all(r <= 1.0 for r, _ in worst.values()) and stat_err <= 1e-4 \
        and card_s["opt"]["count"] == cpu_s["opt"]["count"] == 1
    fields = {f"worst_{tag}_over_limit": r for tag, (r, _) in worst.items()}
    fields.update({f"worst_{tag}": k for tag, (_, k) in worst.items()})
    return dict(ok=ok, **fields, tensors=len(names),
                zero_grad_tensors=sum(k.endswith(ZERO_GRAD) for k in names),
                mu_global_norm=g_mu, step_lr=lr,
                worst_raw_param_rel_fro=raw[0], worst_raw_param=raw[1],
                running_stats=len(stats), running_stats_max_rel=stat_err)


def phase_train_cli_check() -> None:
    """T12-check: the train CLI on the card and with --device cpu over the
    first 16 train WAVs (one dynamic batch) and the 16 dev-clean WAVs,
    dtype float32, every dropout rate 0, accum_grad 1 (so that the one
    batch steps), 1 epoch, --step_checkpoint_interval 1; dither, speed
    perturb and spec_aug on (numpy, the same draws on both). Each record's
    loss terms and grad_norm within 1e-4 relative, the cv loss within
    1e-4, and 0.pt and step_1.state as ``compare_first_step`` holds
    them."""
    import tempfile
    from wenet_celoss_tpu_torch.bin import train as train_cli
    from wenet_celoss_tpu_torch.parallel import train
    from wenet_celoss_tpu_torch.utils import checkpoint as ckpt
    from wenet_celoss_tpu_torch.utils.config import load_config, save_config
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        base, _ = cli_inputs(tmp, n_train=16)
        cfg = no_dropout_rnnt(load_config(str(FLAGSHIP_YAML)))
        cfg.update(dtype="float32", accum_grad=1, log_interval=1)
        check(cfg["encoder_conf"]["cnn_module_norm"] == "batch_norm",
              "train_cli_check: ZERO_GRAD assumes batch_norm conv modules")
        save_config(cfg, str(tmp / "conf.yaml"))
        runs, secs = {}, {}
        probe = CliProbe()
        for dev in ("cuda", "cpu"):
            argv = ["--config", str(tmp / "conf.yaml"), "--model_dir",
                    str(tmp / dev), "--num_epochs", "1",
                    "--step_checkpoint_interval", "1"] + base
            t0 = time.perf_counter()
            run_train_cli(train_cli, argv + (["--device", "cpu"]
                                             if dev == "cpu" else []),
                          probe if dev == "cpu" else None)
            secs[dev] = time.perf_counter() - t0
            runs[dev] = (read_records(tmp / dev / "metrics.jsonl"),
                         ckpt.load_checkpoint_infos(str(tmp / dev / "0.pt")),
                         (ckpt.load_checkpoint(str(tmp / dev / "0.pt")),
                          torch.load(tmp / dev / "step_1.state",
                                     weights_only=True)))
        (card_r, card_i, card_st), (cpu_r, cpu_i, cpu_st) = \
            runs["cuda"], runs["cpu"]
        rec_err = max((abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                       for a, b in zip(card_r, cpu_r)
                       for k in LOSS_KEYS + ("grad_norm",)),
                      default=float("inf"))
        cv_err = abs(card_i["cv_loss"] - cpu_i["cv_loss"]) / abs(
            cpu_i["cv_loss"])
        names = [n for n, _ in probe.model.named_parameters()]
        tx, _ = train.make_optimizer(cfg)
        fields = compare_first_step(names, card_st, cpu_st, tx)
        ok = fields.pop("ok")
        check(len(card_r) == len(cpu_r) == 1 and
              [set(r) for r in card_r] == [set(r) for r in cpu_r]
              and "grad_norm" in card_r[0] and rec_err <= 1e-4
              and cv_err <= 1e-4 and ok
              and fields["running_stats"] == 24,
              f"train_cli_check: records {rec_err}, cv {cv_err}, {fields}")
        emit("train_cli_check", dtype="float32", dropout=0.0, accum_grad=1,
             train_wavs=16, batches=len(card_r), records_max_rel=rec_err,
             cv_loss_card=card_i["cv_loss"], cv_loss_cpu=cpu_i["cv_loss"],
             cv_rel=cv_err, **fields, card_s=secs["cuda"], cpu_s=secs["cpu"],
             tolerance="records and cv loss 1e-4 relative; Adam's mu 1e-3 "
                       "and nu 2e-3 relative Frobenius (the key and "
                       "batch-normed depthwise biases: mu 1e-6 of mu's "
                       "global norm); parameters 1e-3 relative Frobenius "
                       "after the difference of the two sides' Adam "
                       "updates; running statistics 1e-4 of each "
                       "tensor's largest element")


def phase_train_resume() -> None:
    """T12-resume: the yaml flagship at full width (bf16, dropout 0.1),
    the port's Dataset over 32 train WAVs in static batches of 8 (4
    batches), accum_grad 1, through the Executor. A trains all 4 batches,
    A' and A'' repeat it; B trains 2 and writes step_2.state through its
    checkpoint function; C, a model built with another seed, loads the
    state and the generator and trains batches 2-3. Step, Adam count and
    the generator state must equal A's; each parameter, moment and running
    statistic of C may differ from A's by no more than a repeat of A does
    (equal bits where the repeats are equal bitwise). Deterministic
    algorithms are on for the phase (warn only)."""
    import random
    import tempfile
    from wenet_celoss_tpu_torch.data.dataset import Dataset
    from wenet_celoss_tpu_torch.models.factory import init_model
    from wenet_celoss_tpu_torch.parallel import train
    from wenet_celoss_tpu_torch.parallel.executor import Executor
    from wenet_celoss_tpu_torch.utils import checkpoint as ckpt
    from wenet_celoss_tpu_torch.utils.config import load_config
    from wenet_celoss_tpu_torch.utils.file_utils import read_symbol_table
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_data_list(tmp / "train.list", TRAIN_DIR, 32)
        write_units(tmp / "units.txt", 5002)
        cfg = load_config(str(FLAGSHIP_YAML))
        cfg.update(input_dim=80, output_dim=5002, accum_grad=1)
        conf = dict(cfg["dataset_conf"],
                    batch_conf={"batch_type": "static", "batch_size": 8})
        random.seed(0)
        batches = list(Dataset("raw", str(tmp / "train.list"),
                               read_symbol_table(str(tmp / "units.txt")),
                               conf, partition=False))
        check(len(batches) == 4, f"train_resume: {len(batches)} batches")
        path = str(tmp / "step_2.state")

        def save(st, gen):
            if st.step == 2:
                ckpt.save_train_state(st, path, {"step": 2, "epoch": 0},
                                      gen=gen)

        def run(data, seed=0, resume=None, fn=None):
            model = init_model(cfg, seed=seed)
            tx, schedule = train.make_optimizer(cfg)
            state = train.create_train_state(model, tx)
            gen = torch.Generator().manual_seed(0)
            if resume:
                ckpt.load_train_state(state, resume, gen=gen)
            ex = Executor(model, tx, schedule, gen=gen,
                          checkpoint_every=1, checkpoint_fn=fn)
            ex.step = state.step
            state = ex.train_epoch(state, iter(data))
            torch.cuda.synchronize()
            out = state.state_dict()
            out["gen"] = gen.get_state()
            return out

        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            t0 = time.perf_counter()
            a = run(batches)
            repeats = [run(batches), run(batches)]
            run(batches[:2], fn=save)
            ckpt.wait_pending()
            c = run(batches[2:], seed=1, resume=path)
            seconds = time.perf_counter() - t0
        finally:
            torch.use_deterministic_algorithms(False)

        def tensors(sd):
            return {**{f"model.{k}": v for k, v in sd["model"].items()},
                    **{f"mu.{i}": v for i, v in enumerate(sd["opt"]["mu"])},
                    **{f"nu.{i}": v for i, v in enumerate(sd["opt"]["nu"])}}

        ta, tc = tensors(a), tensors(c)
        tr = [tensors(r) for r in repeats]
        worse, spread, diff = [], {}, {}
        for k, x in ta.items():
            spread[k] = max(float((r[k].double() - x.double()).abs().max())
                            for r in tr)
            diff[k] = float((tc[k].double() - x.double()).abs().max())
            same = all(torch.equal(r[k], x) for r in tr)
            if (same and not torch.equal(tc[k], x)) or diff[k] > spread[k]:
                worse.append((k, diff[k], spread[k]))
        counters = (a["step"] == c["step"] == 4
                    and a["opt"]["count"] == c["opt"]["count"] == 4
                    and torch.equal(a["gen"], c["gen"]))
        check(counters and not worse,
              f"train_resume: counters equal {counters}, C beyond the "
              f"repeats' spread in {len(worse)} tensors: {worse[:5]}")
        emit("train_resume", dtype=cfg["dtype"], dropout=0.1, batches=4,
             batch_size=8, tensors=len(ta),
             repeats_bitwise_equal=sum(spread[k] == 0 for k in ta),
             resumed_bitwise_equal=sum(diff[k] == 0 for k in ta),
             max_repeat_diff=max(spread.values()),
             max_resume_diff=max(diff.values()),
             worst=sorted(worse, key=lambda w: -w[1])[:5],
             counters_equal=counters, seconds=seconds)


@contextlib.contextmanager
def autograd_function_route(ffn, lnmm, conv):
    """The forward route the wrappers took before their registered
    operators: each kernel through its ``autograd.Function``'s apply (no
    gradient taken), to time the operators' dispatch against."""
    routes_ = ((ffn, "ln_ffn_residual_fwd", ffn._LnFfnResidual.apply),
               (ffn, "ffn_fused_fwd", ffn._FfnFused.apply),
               (lnmm, "ln_matmul_fwd", lnmm._LnMatmul.apply),
               (conv, "conv_block_fwd", conv._ConvBlockResidual.apply))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in routes_]
    for mod, name, fn in routes_:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_op_dispatch(b1, slice_run, ffn, lnmm, conv) -> None:
    """The registered operators' dispatch cost: B1 plain (bf16, B=64 ×
    512) and S1 plain (fp32, the 16 WAVs) decoded through the operators
    (the port's route) and through the autograd.Function route they
    replaced, in turns in this one call: median host ms of 5 synchronised
    decodes each, the K1 launches equal; and one K1 forward at a serving
    chunk's N = 16 rows called 200 times back to back by each route and by
    the bare launch (µs a call, synchronised at the end)."""
    out = {"card": smi()}
    for name, args in (("b1_plain", b1[:5]), ("s1_plain", slice_run[:5])):
        times = {"operator": [], "function": []}
        launches = {}
        for _ in range(5):
            for route in times:
                ctx = (autograd_function_route(ffn, lnmm, conv)
                       if route == "function" else contextlib.nullcontext())
                with ctx:
                    before = ffn.ln_ffn_residual.launches
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    decode(*args, "plain")
                    torch.cuda.synchronize()
                    times[route].append((time.perf_counter() - t0) * 1e3)
                    launches[route] = ffn.ln_ffn_residual.launches - before
        check(launches["operator"] == launches["function"]
              == K1_PER_ENCODER_PASS, f"op_dispatch {name}: K1 launches "
              f"{launches}, want {K1_PER_ENCODER_PASS} by both routes")
        for route, ts in times.items():
            ts = sorted(ts)
            out[f"{name}_{route}_ms"] = ts[2]
            out[f"{name}_{route}_ms_min_max"] = [ts[0], ts[-1]]
    args = k1_inputs(16, torch.bfloat16, 5)[0]
    cfg = ("swish", 0.5, 1e-5, 0.0, 0.0, 0)
    for route in ("operator", "function", "bare_launch"):
        fn = (ffn.forward_kernel if route == "bare_launch"
              else ffn.ln_ffn_residual)
        ctx = (autograd_function_route(ffn, lnmm, conv)
               if route == "function" else contextlib.nullcontext())
        with ctx, torch.no_grad():
            for _ in range(20):
                fn(*args, *cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn(*args, *cfg)
            torch.cuda.synchronize()
            out[f"k1_n16_{route}_us_per_call"] = \
                (time.perf_counter() - t0) / 200 * 1e6
    emit("op_dispatch", **out)


# ------------------------------------------------------ serving, export ---
# decoder_main and the wenet_tpu_core sources it links
# (runtime/core/CMakeLists.txt), built without CMake.
RUNTIME_CORE = ROOT / "runtime" / "core"
DECODER_MAIN_SOURCES = ("bin/decoder_main.cc",
                        "decoder/ctc_prefix_beam_search.cc",
                        "decoder/wfst_beam_search.cc",
                        "decoder/asr_decoder.cc", "frontend/flac.cc")
SERVE_CHUNK, SERVE_LEFT = 16, 4
# Frames a chunk consumes (chunk 16 × subsampling 4): each F of the
# client's stream carries one chunk's worth.
SERVE_PIECE = SERVE_CHUNK * 4
SERVE_LOG_TOL = 1e-3    # an O reply, card against CPU, fp32, max abs
SERVE_SCORE_RTOL = 1e-4  # an S reply, card against CPU, relative
EXPORT_TOL = 1e-4       # a .pt2 against the live model on the card, max abs
# E1 exports R1's configuration at a smaller depth (encoder blocks,
# decoder blocks, reverse decoder blocks), every check the same. Its
# programs hold a K1 operator node per FFN block.
E1_DEPTH = (3, 1, 1)
EXPORT_K1 = {"encoder_ctc": 2 * E1_DEPTH[0], "encoder_chunk_ctc":
             2 * E1_DEPTH[0], "decoder_scores": E1_DEPTH[1] + E1_DEPTH[2]}


def e1_config(u2pp_conformer) -> dict:
    """R1's configuration (the full-width U2++ conformer) at E1_DEPTH."""
    cfg = u2pp_conformer()
    cfg["encoder_conf"]["num_blocks"] = E1_DEPTH[0]
    cfg["decoder_conf"].update(num_blocks=E1_DEPTH[1],
                               r_num_blocks=E1_DEPTH[2])
    return cfg
# decoder_main's modes by served model (R1: the U2++ conformer, R2: the
# flagship).
SERVE_MODES = (("r1", "default"), ("r2", "rnnt_greedy_search"),
               ("r2", "rnnt_beam_search"), ("r2", "default"))
# Forwards the protocol between its stdin/stdout and the worker named by
# its arguments, logging every request and reply (a u32 length, then the
# bytes) to argv[1]: what decoder_main sent and got, for the comparison.
TEE_WORKER = '''\
import struct
import subprocess
import sys

log = open(sys.argv[1], "wb")
proc = subprocess.Popen(sys.argv[2:], stdin=subprocess.PIPE,
                        stdout=subprocess.PIPE)
src, dst, wout, win = (sys.stdin.buffer, sys.stdout.buffer, proc.stdout,
                       proc.stdin)


def take(f, n, out):
    data = b""
    while len(data) < n:
        part = f.read(n - len(data))
        if not part:
            raise EOFError
        data += part
    out.append(data)
    return data


def u32(f, out):
    return struct.unpack("<I", take(f, 4, out))[0]


def request():
    out = []
    try:
        tag = take(src, 1, out)
    except EOFError:
        return b""
    if tag == b"I":
        take(src, u32(src, out), out)
    elif tag == b"F":
        t, d = u32(src, out), u32(src, out)
        take(src, 4 * t * d, out)
    elif tag == b"B":
        u32(src, out)
    elif tag == b"R":
        n = u32(src, out)
        take(src, 4, out)
        for _ in range(n):
            take(src, 4 * u32(src, out), out)
    return b"".join(out)


def reply():
    out = []
    tag = take(wout, 1, out)
    if tag == b"M":
        take(wout, u32(wout, out), out)
    elif tag == b"O":
        t, v = u32(wout, out), u32(wout, out)
        take(wout, 4 * t * v, out)
    elif tag in (b"T", b"S"):
        take(wout, 4 * u32(wout, out), out)
    elif tag == b"N":
        for _ in range(u32(wout, out)):
            take(wout, 4 * u32(wout, out) + 4, out)
    return b"".join(out)


while True:
    req = request()
    if not req:
        break
    win.write(req)
    win.flush()
    if req == b"Q":
        break
    rep = reply()
    dst.write(rep)
    dst.flush()
    for part in (req, rep):
        log.write(struct.pack("<I", len(part)) + part)
win.close()
log.close()
sys.exit(proc.wait())
'''


def host_cxx() -> str:
    """The host C++ compiler that nvcc itself calls, found the way
    ``ops/_build.py`` finds nvcc: on PATH, then its usual place."""
    for cand in (shutil.which("g++"), "/usr/bin/g++"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("no g++: decoder_main is built with the host C++ "
                       "compiler that nvcc uses (put it on PATH)")


class DecoderMainBuild:
    """``decoder_main`` from the repo's sources: one ``g++ -std=c++17 -O2
    -c`` a source, all started together at construction, then the link
    with ``-lpthread`` in :meth:`wait`. The binary is
    ``wenet_celoss_tpu_torch/_build/decoder_main-<hash>``, the hash of
    runtime/core's sources and headers."""

    def __init__(self):
        from wenet_celoss_tpu_torch.ops._build import BUILD_DIR
        h = hashlib.sha1()
        for p in sorted(RUNTIME_CORE.rglob("*")):
            if p.suffix in (".cc", ".h"):
                h.update(str(p.relative_to(RUNTIME_CORE)).encode())
                h.update(p.read_bytes())
        self.out = BUILD_DIR / f"decoder_main-{h.hexdigest()[:12]}"
        self.t0 = time.perf_counter()
        self.procs = []
        self.seconds = 0.0
        if self.out.exists():
            return
        self.tmp = BUILD_DIR / f"decoder_main.{os.getpid()}.tmp"
        self.tmp.mkdir(parents=True, exist_ok=True)
        for src in DECODER_MAIN_SOURCES:
            obj = self.tmp / (Path(src).stem + ".o")
            self.procs.append((obj, subprocess.Popen(
                [host_cxx(), "-std=c++17", "-O2", "-I", str(RUNTIME_CORE),
                 "-c", str(RUNTIME_CORE / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))

    def wait(self) -> Path:
        if self.procs:
            logs = []
            for _, proc in self.procs:
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    logs.append(log)
            if logs:
                raise RuntimeError("decoder_main build failed:\n"
                                   + "\n".join(logs))
            binary = self.tmp / "decoder_main"
            res = subprocess.run(
                [host_cxx(), "-O2", "-o", str(binary),
                 *(str(obj) for obj, _ in self.procs), "-lpthread"],
                capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError("decoder_main link failed:\n"
                                   + res.stderr)
            os.replace(binary, self.out)
            shutil.rmtree(self.tmp)
            self.procs = []
            self.seconds = time.perf_counter() - self.t0
        return self.out


def serve_env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT), **extra)


def service_files(tmp: Path, cfg: dict, model) -> dict:
    """A served model's files: its weights saved as a .pt, its config
    (plus the 80-bin fbank) by save_config, the same config in bf16, a
    symbol table over its vocabulary, and a wav.scp of the 16 WAVs."""
    from wenet_celoss_tpu_torch.utils.checkpoint import save_checkpoint
    from wenet_celoss_tpu_torch.utils.config import save_config
    tmp.mkdir(parents=True, exist_ok=True)
    save_checkpoint(model, str(tmp / "final.pt"))
    cfg = dict(cfg, dataset_conf={"fbank_conf": {"num_mel_bins": 80}})
    save_config(cfg, str(tmp / "train.yaml"))
    save_config(dict(cfg, dtype="bfloat16"), str(tmp / "train_bf16.yaml"))
    write_units(tmp / "units.txt", cfg["output_dim"])
    (tmp / "wav.scp").write_text("".join(
        f"{p.stem} {p}\n" for p in sorted(WAV_DIR.glob("*.wav"))))
    return {"dir": tmp, "config": str(tmp / "train.yaml"),
            "checkpoint": str(tmp / "final.pt")}


def worker_cmd(files: dict, device: Optional[str] = None,
               config: Optional[str] = None) -> list:
    """The port's worker on ``files``: the card (no --device) or
    ``device``."""
    cmd = [sys.executable, "-m", "wenet_celoss_tpu_torch.bin.runtime_worker",
           "--config", config or files["config"], "--checkpoint",
           files["checkpoint"], "--chunk_size", str(SERVE_CHUNK),
           "--num_left_chunks", str(SERVE_LEFT)]
    return cmd + (["--device", device] if device else [])


def in_process_worker(files: dict, config: Optional[str] = None):
    from wenet_celoss_tpu_torch.bin import runtime_worker
    return runtime_worker.Worker(argparse.Namespace(
        config=config or files["config"], checkpoint=files["checkpoint"],
        chunk_size=SERVE_CHUNK, num_left_chunks=SERVE_LEFT, device=None))


class WorkerClient:
    """A worker subprocess spoken to over its pipes, as the C++ side's
    ``SubprocessAsrModel`` speaks to it. :meth:`start` sends the first
    'I'; ``startup_s``: from the start of the process to that reply (the
    model built and loaded)."""

    def __init__(self, cmd: list, log: Path, **env):
        self.t0 = time.perf_counter()
        self.log = log
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE,
                                     stderr=open(log, "wb"),
                                     env=serve_env(**env))

    def start(self) -> "WorkerClient":
        self.meta = self.request(b"I" + struct.pack("<I", 0))
        self.startup_s = time.perf_counter() - self.t0
        return self

    def _read(self, n: int) -> bytes:
        data = self.proc.stdout.read(n)
        if len(data) != n:
            raise RuntimeError(f"worker closed its pipe; its log:\n"
                               f"{self.log.read_text()[-3000:]}")
        return data

    def _u32(self) -> int:
        return struct.unpack("<I", self._read(4))[0]

    def request(self, msg: bytes):
        self.proc.stdin.write(msg)
        self.proc.stdin.flush()
        tag = self._read(1)
        if tag == b"M":
            return json.loads(self._read(self._u32()))
        if tag == b"O":
            t, v = self._u32(), self._u32()
            return np.frombuffer(self._read(4 * t * v), "<f4").reshape(t, v)
        if tag == b"T":
            return np.frombuffer(self._read(4 * self._u32()), "<i4").tolist()
        if tag == b"S":
            return np.frombuffer(self._read(4 * self._u32()), "<f4")
        if tag == b"N":
            out = []
            for _ in range(self._u32()):
                toks = np.frombuffer(self._read(4 * self._u32()),
                                     "<i4").tolist()
                out.append((toks, struct.unpack("<f", self._read(4))[0]))
            return out
        raise RuntimeError(f"unknown reply tag {tag!r}")

    def forward(self, feats: np.ndarray) -> np.ndarray:
        feats = np.ascontiguousarray(feats, "<f4")
        return self.request(b"F" + struct.pack("<II", *feats.shape)
                            + feats.tobytes())

    def rescore(self, hyps, rw: float) -> np.ndarray:
        msg = b"R" + struct.pack("<If", len(hyps), rw)
        for h in hyps:
            msg += struct.pack("<I", len(h)) + np.asarray(h, "<i4").tobytes()
        return self.request(msg)

    def close(self) -> None:
        self.proc.stdin.write(b"Q")
        self.proc.stdin.close()
        code = self.proc.wait(timeout=60)
        if code != 0:
            raise RuntimeError(f"worker exited {code}:\n"
                               f"{self.log.read_text()[-3000:]}")


def one_stream() -> np.ndarray:
    """The 16 WAVs' fbank frames end to end, one stream."""
    _, feats, lens = load_wavs()
    return np.concatenate([f[:n] for f, n in zip(feats, lens)])


def pieces(stream: np.ndarray):
    """The stream in F requests of one chunk's frames, then the flush."""
    return [stream[i:i + SERVE_PIECE]
            for i in range(0, len(stream), SERVE_PIECE)] + [stream[:0]]


def ms_stats(prefix: str, times) -> dict:
    """Median, p90 and max of a request's round trips."""
    times = sorted(times)
    return {f"{prefix}_ms_median": times[len(times) // 2],
            f"{prefix}_ms_p90": times[min(len(times) - 1,
                                          int(0.9 * len(times)))],
            f"{prefix}_ms_max": times[-1], f"{prefix}_requests": len(times)}


def ctc_greedy_ids(log_probs: np.ndarray, blank: int = 0) -> list:
    ids = log_probs.argmax(-1)
    return [int(t) for i, t in enumerate(ids)
            if t != blank and (i == 0 or t != ids[i - 1])]


def chunk_profile(worker, feats, want_k1: int, prefix: str = "chunk"):
    """One F request of the in-process worker: its synchronised host ms
    (median of 5 replays from the same state), then one profiled replay:
    the card's busy ms, idle share, K1's device ms and launches inside it,
    and its three largest kernels."""
    from torch.profiler import ProfilerActivity, profile
    state = copy.copy(worker.__dict__)

    def replay():
        worker.__dict__.update(copy.copy(state))
        worker.encoder_outs = list(state["encoder_outs"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        worker.forward_chunk(feats)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    med = sorted(replay() for _ in range(5))[2]
    reset_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        replay()
    k1 = read_counts()["k1"]
    busy, by_name = device_busy(prof)
    k1_ms = sum(ms for name, ms in by_name.items()
                if any(key in name for key in FFN_FWD_KERNELS))
    check(k1 == want_k1, f"{prefix} replay: {k1} K1 launches, want "
                         f"{want_k1}")
    check(busy > 0 and k1_ms > 0, f"{prefix} replay: the profile read "
          f"busy {busy} ms, K1 {k1_ms} ms")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return {f"{prefix}_host_ms": med, f"{prefix}_busy_ms": busy,
            f"{prefix}_idle_share": 1.0 - busy / med,
            f"{prefix}_k1_device_ms": k1_ms,
            f"{prefix}_k1_launches": k1,
            f"{prefix}_card_intervals": device_events(prof),
            f"{prefix}_top": [[name[:70], ms] for name, ms in top]}


def start_services(init_model, u2pp_conformer, conformer_rnnt_bias,
                   tmp: Path) -> dict:
    """R1's and R2's served files (R1: the full-width U2++ conformer, fp32,
    seed 0; R2: the full-width flagship, fp32, seed 0, S1's blank bias
    +3.0), their protocol clients started together (R1 on the card and on
    the CPU, R2 on the card; each one's start-up read by a thread of its
    own), and, while those start, the in-process card workers (R1 in fp32
    and in bf16, R2)."""
    cfg1, cfg2 = u2pp_conformer(), conformer_rnnt_bias()
    files = {"r1": service_files(tmp / "r1", cfg1, init_model(cfg1, seed=0)),
             "r2": service_files(tmp / "r2", cfg2, with_blank_bias(
                 init_model(cfg2, seed=0), SLICE_BLANK_BIAS))}
    clients = {
        "r1_card": WorkerClient(worker_cmd(files["r1"]), tmp / "r1c.log"),
        "r1_cpu": WorkerClient(worker_cmd(files["r1"], "cpu"),
                               tmp / "r1p.log", OMP_NUM_THREADS="2"),
        "r2_card": WorkerClient(worker_cmd(files["r2"]), tmp / "r2c.log")}
    threads = [threading.Thread(target=c.start) for c in clients.values()]
    for th in threads:
        th.start()
    workers = {"r1": in_process_worker(files["r1"]),
               "r1_bf16": in_process_worker(
                   files["r1"], str(tmp / "r1" / "train_bf16.yaml")),
               "r2": in_process_worker(files["r2"])}
    for th in threads:
        th.join()
    for name, c in clients.items():
        check(hasattr(c, "meta"), f"serve: the {name} worker did not start")
    return {"files": files, "clients": clients, "workers": workers}


def phase_serve_u2pp(svc: dict) -> dict:
    """R1, timed part (chunk 16, 4 left chunks): the client streams the 16
    WAVs' fbank as one stream, a chunk's frames an F, through the card
    worker (its O replies and one R kept for ``r1_cpu_compare``): the F
    round trips and start-up. Then the in-process card worker streams the
    same F requests (every count set to 0 just before, read just after:
    24 K1 launches a chunk, N = 16 rows), and one chunk is replayed under
    torch.profiler, fp32 and (for comparison) the bf16 worker's. Returns
    the launches."""
    t_phase = time.perf_counter()
    card = svc["clients"]["r1_card"]
    stream = one_stream()
    f_ms, outs = [], []
    for piece in pieces(stream):
        t0 = time.perf_counter()
        outs.append(card.forward(piece))
        f_ms.append((time.perf_counter() - t0) * 1e3)
    ids = ctc_greedy_ids(np.concatenate(outs))
    hyps = [ids, ids[:-1], ids[::2], []]
    t0 = time.perf_counter()
    s_card = card.rescore(hyps, 0.3)
    r_ms = (time.perf_counter() - t0) * 1e3
    card.close()
    svc["r1_card_replies"] = (outs, hyps, s_card)
    frames = sum(o.shape[0] for o in outs)
    client_s = time.perf_counter() - t_phase

    worker = svc["workers"]["r1"]
    reps = pieces(stream)
    reset_counts()
    n_out = sum(worker.forward_chunk(p).shape[0] for p in reps[:-1])
    torch.cuda.synchronize()
    launches = read_counts()
    chunks = n_out // SERVE_CHUNK
    want = {**NO_LAUNCHES, "k1": K1_PER_ENCODER_PASS * chunks}
    check(launches == want, f"serve_u2pp in-process stream: launches "
                            f"{launches}, want {want}")
    # A whole piece after the stream: the buffer's 3 to 66 frames plus 64
    # make one window, one chunk.
    prof = chunk_profile(worker, stream[:SERVE_PIECE], K1_PER_ENCODER_PASS)
    bf16 = svc["workers"]["r1_bf16"]
    for p in reps[:4]:
        bf16.forward_chunk(p)
    prof.update(chunk_profile(bf16, stream[:SERVE_PIECE],
                              K1_PER_ENCODER_PASS, prefix="bf16_chunk"))
    emit("serve_u2pp", part="client", model="u2pp_conformer",
         dtype="float32", chunk=SERVE_CHUNK, left_chunks=SERVE_LEFT,
         stream_frames=len(stream), out_frames=frames,
         worker_startup_s=card.startup_s,
         **ms_stats("f_round_trip", f_ms), r_round_trip_ms=r_ms,
         k1_launches_per_chunk=launches["k1"] / max(chunks, 1),
         k1_rows_per_launch=SERVE_CHUNK, **prof, card=smi(),
         client_s=client_s, seconds=time.perf_counter() - t_phase)
    return launches


def r1_cpu_compare(svc: dict) -> None:
    """R1's client, CPU side (untimed, while phase_serve_runs' processes
    run): the same stream and R through the --device cpu worker (two CPU
    threads), each O within SERVE_LOG_TOL of the card worker's, the S
    scores within SERVE_SCORE_RTOL."""
    cpu = svc["clients"]["r1_cpu"]
    outs, hyps, s_card = svc["r1_card_replies"]
    check(svc["clients"]["r1_card"].meta == cpu.meta,
          f"serve_u2pp meta {svc['clients']['r1_card'].meta} != "
          f"{cpu.meta}")
    err = 0.0
    for piece, got in zip(pieces(one_stream()), outs):
        want = cpu.forward(piece)
        check(got.shape == want.shape, f"serve_u2pp O shape {got.shape} "
                                       f"!= {want.shape}")
        if got.size:
            err = max(err, float(np.abs(got - want).max()))
    s_cpu = cpu.rescore(hyps, 0.3)
    s_rel = float(np.max(np.abs(s_card - s_cpu)
                         / np.maximum(np.abs(s_cpu), 1.0)))
    cpu.close()
    check(err <= SERVE_LOG_TOL and s_rel <= SERVE_SCORE_RTOL,
          f"serve_u2pp client: O max abs {err}, S relative {s_rel}")
    emit("serve_u2pp", part="client_card_vs_cpu",
         o_max_abs_card_vs_cpu=err, s_max_rel_card_vs_cpu=s_rel,
         tolerance=f"O max abs {SERVE_LOG_TOL}, S relative "
                   f"{SERVE_SCORE_RTOL}", cpu_worker_startup_s=cpu.startup_s,
         o_replies=len(outs))


def phase_serve_rnnt(svc: dict) -> dict:
    """R2, timed part: the flagship, whose non-causal conformer the worker
    serves by the chunk-masked prefix. The client streams the WAVs as one
    stream through the card worker (F then G a request, then B and R):
    round trips, start-up, greedy tokens an encoder frame. The in-process
    card worker: 24 K1 launches an F that runs the encoder (N = the
    prefix's frames), the flush (the whole prefix) replayed under
    torch.profiler. Returns the launches."""
    t_phase = time.perf_counter()
    card = svc["clients"]["r2_card"]
    stream = one_stream()
    f_ms, g_ms, frames, tokens = [], [], 0, 0
    for piece in pieces(stream):
        t0 = time.perf_counter()
        out = card.forward(piece)
        f_ms.append((time.perf_counter() - t0) * 1e3)
        frames += out.shape[0]
        t0 = time.perf_counter()
        tokens += len(card.request(b"G"))
        g_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    nbest = card.request(b"B" + struct.pack("<I", 4))
    b_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    scores = card.rescore([h for h, _ in nbest], 0.0)
    r_ms = (time.perf_counter() - t0) * 1e3
    card.close()
    check(len(nbest) > 0 and np.isfinite(scores).all(),
          f"serve_rnnt client: n-best {len(nbest)}, scores {scores}")

    worker = svc["workers"]["r2"]
    reset_counts()
    passes = 0
    for piece in pieces(stream)[:-1]:
        before = read_counts()["k1"]
        worker.forward_chunk(piece)
        passes += read_counts()["k1"] > before
    torch.cuda.synchronize()
    launches = read_counts()
    want = {**NO_LAUNCHES, "k1": K1_PER_ENCODER_PASS * passes}
    check(launches == want, f"serve_rnnt in-process stream: launches "
                            f"{launches}, want {want}")
    prof = chunk_profile(worker, stream[:0], K1_PER_ENCODER_PASS,
                         prefix="flush")
    emit("serve_rnnt", part="client", model="conformer_rnnt_bias",
         dtype="float32", blank_bias=SLICE_BLANK_BIAS, chunk=SERVE_CHUNK,
         stream_frames=len(stream), encoder_frames=frames,
         greedy_tokens=tokens, tokens_per_encoder_frame=tokens / frames,
         n_steps_cap=4, worker_startup_s=card.startup_s,
         **ms_stats("f_round_trip", f_ms), **ms_stats("g_round_trip", g_ms),
         b_round_trip_ms=b_ms, r_round_trip_ms=r_ms, nbest=len(nbest),
         encoder_passes=passes,
         k1_launches_per_f=launches["k1"] / max(passes, 1),
         flush_frames=len(stream), **prof, card=smi(),
         seconds=time.perf_counter() - t_phase)
    return launches


def tee_utterances(log: Path) -> list:
    """A TEE_WORKER log split into utterances at each 'I' that F requests
    follow: each one's O log-probs [T', V], R hypotheses and S scores."""
    data, pos, msgs = log.read_bytes(), 0, []
    while pos < len(data):
        (n,) = struct.unpack("<I", data[pos:pos + 4])
        msgs.append(data[pos + 4:pos + 4 + n])
        pos += 4 + n
    utts = []
    for req, rep in zip(msgs[0::2], msgs[1::2]):
        tag = req[:1]
        if tag == b"I":
            utts.append({"o": [], "hyps": [], "att": None})
        elif tag == b"F":
            t, v = struct.unpack("<II", rep[1:9])
            utts[-1]["o"].append(np.frombuffer(rep[9:], "<f4").reshape(t, v))
        elif tag == b"R":
            (n,) = struct.unpack("<I", req[1:5])
            at = 9
            for _ in range(n):
                (k,) = struct.unpack("<I", req[at:at + 4])
                utts[-1]["hyps"].append(
                    np.frombuffer(req[at + 4:at + 4 + 4 * k], "<i4").tolist())
                at += 4 + 4 * k
            utts[-1]["att"] = np.frombuffer(rep[5:], "<f4")
    return [u for u in utts if u["o"]]


CPP_LOG_ZERO = np.float32(-1e10)   # runtime/core/utils/utils.h kLogZero


def _cpp_log_add(a, b):
    """runtime/core/utils/utils.h LogAdd, in float32."""
    if a < b:
        a, b = b, a
    if b <= CPP_LOG_ZERO:
        return a
    return np.float32(a + np.log1p(np.exp(np.float32(b - a))))


def cpp_prefix_beam(logp: np.ndarray, beam: int = 10, blank: int = 0):
    """decoder_main's CTC prefix beam search
    (runtime/core/decoder/ctc_prefix_beam_search.cc, no context graph:
    the top ``beam`` tokens a frame, the best ``beam`` prefixes kept) in
    float32 on a worker's O log-probs → (the n-best [(prefix, score)]
    best first, and per frame (its top-k tokens, the prefixes kept, the
    margin at the top-k's edge, the margin at the beam's edge))."""
    beams = [((), np.float32(0.0), CPP_LOG_ZERO)]   # prefix, lp_b, lp_t
    trace = []
    for row in logp.astype(np.float32):
        order = np.argsort(-row, kind="stable")
        top = order[:beam]
        tok_margin = float(row[order[beam - 1]] - row[order[beam]])
        nxt = {}
        for prefix, pb, pt in beams:
            total = _cpp_log_add(pb, pt)
            last = prefix[-1] if prefix else -1
            for tok in top.tolist():
                lp = row[tok]
                if tok == blank:
                    e = nxt.setdefault(prefix, [CPP_LOG_ZERO, CPP_LOG_ZERO])
                    e[0] = _cpp_log_add(e[0], np.float32(total + lp))
                    continue
                if tok == last:
                    e = nxt.setdefault(prefix, [CPP_LOG_ZERO, CPP_LOG_ZERO])
                    e[1] = _cpp_log_add(e[1], np.float32(pt + lp))
                    src = pb
                else:
                    src = total
                x = nxt.setdefault(prefix + (tok,),
                                   [CPP_LOG_ZERO, CPP_LOG_ZERO])
                x[1] = _cpp_log_add(x[1], np.float32(src + lp))
        ranked = sorted(((_cpp_log_add(*v), p, v) for p, v in nxt.items()),
                        key=lambda r: -r[0])
        prune_margin = (float(ranked[beam - 1][0] - ranked[beam][0])
                        if len(ranked) > beam else float("inf"))
        beams = [(p, v[0], v[1]) for _, p, v in ranked[:beam]]
        trace.append((frozenset(top.tolist()),
                      frozenset(p for p, _, _ in beams), tok_margin,
                      prune_margin))
    return [(list(p), _cpp_log_add(pb, pt)) for p, pb, pt in beams], trace


def near_tie(card_u, cpu_u, ctc_weight: float = 0.5) -> dict:
    """Where decoder_main's default mode parted for one utterance between
    the card's and the CPU's worker: its search redone on each worker's O
    (``cpp_prefix_beam``, which must give each side's n-best as sent to
    R), the first decision that differs (a frame's top-k tokens, the
    prefixes a frame keeps, or the final ranking by attention score +
    ctc_weight × prefix score), and the CPU search's margin there."""
    card_nb, card_tr = cpp_prefix_beam(np.concatenate(card_u["o"]))
    cpu_nb, cpu_tr = cpp_prefix_beam(np.concatenate(cpu_u["o"]))
    rec = {"search_redone_matches": (
        [p for p, _ in card_nb] == card_u["hyps"]
        and [p for p, _ in cpu_nb] == cpu_u["hyps"])}
    for t, (a, b) in enumerate(zip(card_tr, cpu_tr)):
        if a[0] != b[0]:
            return {**rec, "parts_at": f"frame {t}: top-k tokens",
                    "cpu_margin": b[2]}
        if a[1] != b[1]:
            return {**rec, "parts_at": f"frame {t}: kept prefixes",
                    "cpu_margin": b[3]}
    totals = sorted((float(att) + ctc_weight * float(score)
                     for (_, score), att in zip(cpu_nb, cpu_u["att"])),
                    reverse=True)
    return {**rec, "parts_at": "final ranking",
            "cpu_margin": totals[0] - totals[1] if len(totals) > 1
            else float("inf")}


def decoder_main_diffs(card_lines, cpu_lines, logs, mode: str) -> list:
    """Each differing result line with what the two workers answered for
    it (the O difference, whether the n-best sent to R was the same) and,
    in the default mode, ``near_tie``."""
    card_u, cpu_u = (tee_utterances(log) for log in logs)
    out = []
    for i, (a, b) in enumerate(zip(card_lines, cpu_lines)):
        if a == b:
            continue
        rec = {"card": a, "cpu": b}
        if i < min(len(card_u), len(cpu_u)):
            cu, pu = card_u[i], cpu_u[i]
            o_card, o_cpu = np.concatenate(cu["o"]), np.concatenate(pu["o"])
            rec["o_max_abs"] = (float(np.abs(o_card - o_cpu).max())
                                if o_card.shape == o_cpu.shape else None)
            rec["same_nbest"] = cu["hyps"] == pu["hyps"]
            if mode == "default" and rec["o_max_abs"] is not None:
                rec.update(near_tie(cu, pu))
        out.append(rec)
    return out


def explained(diff: dict) -> bool:
    """A differing line that S1's rule allows: the O replies within
    SERVE_LOG_TOL, decoder_main's search redone to each side's n-best, and
    a CPU margin under NEAR_TIE where the two searches part."""
    return (diff.get("o_max_abs") is not None
            and diff["o_max_abs"] <= SERVE_LOG_TOL
            and diff.get("search_redone_matches", False)
            and diff.get("cpu_margin", float("inf")) < NEAR_TIE)


# The port's worker whose K1 launches are counted: at its exit it writes
# them to argv[1] as JSON; the worker's own arguments follow.
COUNTED_WORKER = '''\
import atexit
import json
import sys

from wenet_celoss_tpu_torch.bin import runtime_worker
from wenet_celoss_tpu_torch.ops import ffn


def dump():
    with open(sys.argv[1], "w") as f:
        json.dump({"k1": ffn.ln_ffn_residual.launches}, f)


atexit.register(dump)
runtime_worker.main(sys.argv[2:])
'''
W1_BLANK_SKIP = 1.1     # W1's --blank_skip_thresh: no frame skipped


def w1_lang(served: dict, tools: dict) -> Path:
    """W1's graph: ``python -m wenet_celoss_tpu_torch.bin.build_lg`` over
    R1's units (write_units: ▁ and A-Z), the transcripts' words and their
    unigram ARPA → lang/lg.bin and lang/words.txt beside R1's files."""
    lang = served["r1"]["dir"] / "lang"
    res = subprocess.run(
        [sys.executable, "-m", "wenet_celoss_tpu_torch.bin.build_lg",
         "--units", str(served["r1"]["dir"] / "units.txt"), "--arpa",
         tools["arpa"], "--wordlist", tools["wordlist"], "--out_dir",
         str(lang)], capture_output=True, text=True, env=serve_env(),
        timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"build_lg exited {res.returncode}:\n"
                           f"{res.stderr[-3000:]}")
    emit("tools", part="w1_graph", report=res.stdout.strip())
    return lang


def phase_serve_runs(binary: Path, served: dict, tmp: Path, during,
                     beside, lang: Path):
    """R1's and R2's decoder_main runs, started together after the timed
    parts: decoder_main over the 16 WAVs for each of SERVE_MODES with the
    card worker (one CPU thread) and with the --device cpu worker (two),
    each behind TEE_WORKER; ``during()`` (E1, and the checks beside its
    int8 export) runs in this process meanwhile, and ``beside()`` (R1's
    CPU client) in a thread. The
    result lines must be equal card against CPU, or differ only where
    S1's rule allows (``explained``: the CPU search's margin under
    NEAR_TIE where the two searches part). W1 beside them:
    decoder_main in WFST mode over ``lang`` (R1's card worker, its K1
    launches counted by COUNTED_WORKER, behind TEE_WORKER), judged by
    ``phase_w1``. Returns what ``during`` returns."""
    t0 = time.perf_counter()
    tee = tmp / "tee_worker.py"
    tee.write_text(TEE_WORKER)
    procs = {}
    for model, mode in SERVE_MODES:
        files = served[model]
        extra = [] if mode == "default" else ["--mode", mode]
        if mode == "rnnt_beam_search":
            extra += ["--beam", "4"]
        for side, dev, threads in (("card", None, "1"), ("cpu", "cpu", "2")):
            log = tmp / f"{model}_{mode}_{side}.tee"
            wcmd = [sys.executable, str(tee), str(log),
                    *worker_cmd(files, dev)]
            procs[(model, mode, side)] = subprocess.Popen(
                [str(binary), "--wav_scp", str(files["dir"] / "wav.scp"),
                 "--symbol_table", str(files["dir"] / "units.txt"),
                 "--worker_cmd", " ".join(wcmd), "--chunk_size",
                 str(SERVE_CHUNK), "--num_bins", "80", *extra],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=serve_env(OMP_NUM_THREADS=threads))
    counted = tmp / "counted_worker.py"
    counted.write_text(COUNTED_WORKER)
    wcmd = [sys.executable, str(tee), str(tmp / "w1.tee"), sys.executable,
            str(counted), str(tmp / "w1_counts.json"),
            *worker_cmd(served["r1"])[3:]]
    procs[("r1", "wfst", "card")] = subprocess.Popen(
        [str(binary), "--wav_scp", str(served["r1"]["dir"] / "wav.scp"),
         "--symbol_table", str(lang / "words.txt"), "--worker_cmd",
         " ".join(wcmd), "--chunk_size", str(SERVE_CHUNK), "--num_bins",
         "80", "--fst_path", str(lang / "lg.bin"), "--blank_skip_thresh",
         str(W1_BLANK_SKIP)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=serve_env(OMP_NUM_THREADS="1"))
    ended = {}

    def wait(key, proc):   # each run's own end, its pipes drained
        out, err = proc.communicate(timeout=900)
        ended[key] = (out, err, time.perf_counter() - t0)
    errors = []

    def run_beside():
        try:
            beside()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
    waiters = [threading.Thread(target=wait, args=kv)
               for kv in procs.items()] + [threading.Thread(target=run_beside)]
    for th in waiters:
        th.start()
    result = during()
    for th in waiters:
        th.join()
    if errors:
        raise errors[0]
    for key, proc in procs.items():
        if key not in ended or proc.returncode != 0:
            raise RuntimeError(f"decoder_main {key} exited "
                               f"{proc.returncode}:\n"
                               f"{ended.get(key, ('', ''))[1][-3000:]}")
    for model, mode in SERVE_MODES:
        card, cpu = (ended[(model, mode, side)][0].splitlines()
                     for side in ("card", "cpu"))
        same = sum(a == b for a, b in zip(card, cpu))
        phase = "serve_u2pp" if model == "r1" else "serve_rnnt"
        diffs = decoder_main_diffs(card, cpu, [
            tmp / f"{model}_{mode}_{side}.tee" for side in ("card", "cpu")],
            mode)
        check(len(card) == len(cpu) == 16 and all(map(explained, diffs)),
              f"{phase} decoder_main {mode}: {same} of {len(card)} lines "
              f"equal card against CPU, a difference away from a near "
              f"tie: {diffs}")
        emit(phase, part="decoder_main", mode=mode, lines_equal=same,
             lines=len(card), near_tie_flips=len(diffs), diffs=diffs,
             symbols=sum(len("".join(line.split()[1:])) for line in card),
             card_s=ended[(model, mode, "card")][2],
             cpu_s=ended[(model, mode, "cpu")][2])
    out, _, seconds = ended[("r1", "wfst", "card")]
    served["w1"] = {"lines": out.splitlines(), "card_s": seconds,
                    "tee": tmp / "w1.tee", "counts": tmp / "w1_counts.json",
                    "lang": lang}
    emit("serve_runs", seconds=time.perf_counter() - t0)
    return result


def phase_w1(w1: dict) -> dict:
    """W1: decoder_main's 16 WFST lines (R1's card worker; --beam 16,
    --lm_scale 1, --blank_skip_thresh W1_BLANK_SKIP, its default n-best
    of 10 rescored by the worker's attention scores: score = att +
    0.5·(−cost)) against the port's wfst_beam_decode over the log-probs
    the tee recorded, with the same options, its n-best ranked the same
    way by the attention scores decoder_main received: equal word lines
    and the same n-best, except where the Python decoder's two best
    finals (or the two best rescored scores) lie within NEAR_TIE. The
    worker's K1 launches: 24 a chunk step, 6 a rescoring. Returns them."""
    from wenet_celoss_tpu_torch.configs import u2pp_conformer
    from wenet_celoss_tpu_torch.lm.fst import (LgGraph, WfstDecodeOptions,
                                               wfst_beam_decode)
    lg = LgGraph.read(str(w1["lang"] / "lg.bin"))
    opts = WfstDecodeOptions(beam=16.0, lm_scale=1.0, max_active=7000,
                             nbest=10, blank_skip_thresh=W1_BLANK_SKIP)
    utts = tee_utterances(w1["tee"])
    lines = w1["lines"]
    check(len(lines) == len(utts) == 16, f"tools w1: {len(lines)} lines, "
                                         f"{len(utts)} utterances teed")
    same, ties, bad, words, t0 = 0, [], [], 0, time.perf_counter()
    frames = rescorings = 0
    for line, u in zip(lines, utts):
        key, _, text = line.partition(" ")
        frames += sum(o.shape[0] for o in u["o"])
        rescorings += bool(u["hyps"])
        hyps = wfst_beam_decode(lg, np.concatenate(u["o"]), opts)
        att = dict(zip(map(tuple, u["hyps"]), u["att"].tolist())) \
            if u["att"] is not None else {}
        totals = [att.get(tuple(h.units), float("-inf")) - 0.5 * h.cost
                  for h in hyps]
        rank = sorted(range(len(hyps)), key=lambda j: -totals[j])
        # decoder_main's post-processor lowercases latin words.
        mine = " ".join(lg.words[w] for w in hyps[rank[0]].words).lower() \
            if hyps else ""
        units = [h.units for h in hyps]
        words += len(mine.split())
        if mine == text.strip() and units == u["hyps"]:
            same += 1
            continue
        rec = {"utt": key, "decoder_main": text, "python": mine}
        ok = True
        if units != u["hyps"]:   # the first rank where the n-bests part
            k = next((j for j, (a, b) in enumerate(zip(units, u["hyps"]))
                      if a != b), min(len(units), len(u["hyps"])))
            rec["nbest_parts_at"] = k
            rec["nbest_cost_gap"] = abs(
                hyps[units.index(u["hyps"][k])].cost - hyps[k].cost) \
                if k < len(u["hyps"]) and k < len(units) and \
                u["hyps"][k] in units else float("inf")
            ok = rec["nbest_cost_gap"] < NEAR_TIE
        if mine != text.strip():
            rec["cost_gap"] = hyps[1].cost - hyps[0].cost \
                if len(hyps) > 1 else float("inf")
            rec["rescored_gap"] = totals[rank[0]] - totals[rank[1]] \
                if len(hyps) > 1 else float("inf")
            ok = ok and min(rec["cost_gap"], rec["rescored_gap"]) < NEAR_TIE
        (ties if ok else bad).append(rec)
    counts = json.loads(w1["counts"].read_text()) \
        if w1["counts"].exists() else {"k1": 0}
    launches = {**NO_LAUNCHES, "k1": counts["k1"]}
    # A window of SERVE_CHUNK encoder frames is one chunk step (24 K1); an
    # R request one pass of the left-to-right decoder over its n-best
    # (decoder_main's reverse_weight is 0).
    windows = frames // SERVE_CHUNK
    per_r = u2pp_conformer()["decoder_conf"]["num_blocks"]
    want_k1 = K1_PER_ENCODER_PASS * windows + per_r * rescorings
    check(not bad and counts["k1"] == want_k1,
          f"tools w1: lines differ from the port's WFST decode away from "
          f"a near tie {bad}; worker K1 {counts['k1']}, want {want_k1} (24 "
          f"a chunk step of {windows}, {per_r} a rescoring of "
          f"{rescorings})")
    emit("tools", part="w1", lines=len(lines), identical=same,
         near_tie_flips=ties, other_diffs=bad, words=words,
         encoder_frames=frames, chunk_steps=windows, rescorings=rescorings,
         decoder_main_s=w1["card_s"], python_decode_s=time.perf_counter()
         - t0, launches=launches, graph_states=lg.ngram.num_states,
         trie_nodes=lg.trie.num_nodes)
    return launches


def start_export(init_model, u2pp_conformer, tmp: Path,
                 dev: str = "cuda") -> dict:
    """E1's bundles: R1's model at E1_DEPTH (its weights seed 0, saved as
    service_files saves R1's) written by ``python -m
    wenet_celoss_tpu_torch.bin.export`` on the card, fp32 and --quantize
    int8, two processes started at once; ``phase_export`` checks them.
    Each process's seconds to its end are kept by a thread."""
    cfg = e1_config(u2pp_conformer)
    files = service_files(tmp / "e1_model", cfg, init_model(cfg, seed=0))
    runs = {}
    for quant in ("none", "int8"):
        argv = ["--config", files["config"], "--checkpoint",
                files["checkpoint"], "--output_dir", str(tmp / "e1" / quant),
                "--chunk_size", str(SERVE_CHUNK), "--num_left_chunks",
                str(SERVE_LEFT), "--quantize", quant, "--device", dev]
        proc = subprocess.Popen(
            [sys.executable, "-m", "wenet_celoss_tpu_torch.bin.export",
             *argv], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=serve_env())
        end: list = []

        def wait(proc=proc, end=end, t0=time.perf_counter()):
            end.append((proc.communicate(timeout=900),
                        time.perf_counter() - t0))
        waiter = threading.Thread(target=wait)
        waiter.start()
        runs[quant] = (proc, waiter, end)
    return {"cfg": cfg, "tmp": tmp, "runs": runs, "dev": dev}


def phase_export(init_model, started: dict, meanwhile=None):
    """E1: ``meanwhile()`` first (it runs while start_export's processes
    write the bundles), then each bundle's .pt2 programs are loaded back
    and run on the card against the live model's entry point on the same
    inputs (the int8 programs against the model loaded from
    params_int8.pt), within EXPORT_TOL; each graph's
    wenet_torch::ln_ffn_residual_fwd nodes counted against EXPORT_K1. The
    programs' runs are counted (every count set to 0 before the first,
    read after the last). Seconds a bundle, sizes and the int8 / fp32
    ratio. Returns the launches and what ``meanwhile`` returned."""
    from wenet_celoss_tpu_torch.bin import export
    from wenet_celoss_tpu_torch.utils.checkpoint import load_into
    from wenet_celoss_tpu_torch.utils.quantize import load_quantized
    t_meanwhile = time.perf_counter()
    beside = meanwhile() if meanwhile is not None else None
    t_meanwhile = time.perf_counter() - t_meanwhile
    t_phase = time.perf_counter()
    cfg, tmp, dev = started["cfg"], started["tmp"], started["dev"]
    op = torch.ops.wenet_torch.ln_ffn_residual_fwd.default
    rng = np.random.default_rng(11)
    feat_dim, vocab = cfg["input_dim"], cfg["output_dim"]
    feats = torch.as_tensor(rng.standard_normal((1, 2000, feat_dim)),
                            dtype=torch.float32, device=dev)
    lens = torch.tensor([1700], dtype=torch.int32, device=dev)
    window = (SERVE_CHUNK - 1) * 4 + 6 + 1
    xs = [torch.as_tensor(rng.standard_normal((1, window, feat_dim)),
                          dtype=torch.float32, device=dev) for _ in range(2)]
    n, u, t_sub = 10, 64, (2000 - 3) // 4
    memory = torch.as_tensor(rng.standard_normal(
        (n, t_sub, cfg["encoder_conf"]["output_size"])),
        dtype=torch.float32, device=dev)
    mask = torch.arange(t_sub, device=dev)[None] < torch.as_tensor(
        rng.integers(100, t_sub, (n, 1)), device=dev)
    hyps = torch.as_tensor(rng.integers(1, vocab - 2, (n, u + 1)),
                           dtype=torch.int32, device=dev)
    hyps[:, 0] = cfg["output_dim"] - 1
    hlens = torch.as_tensor(rng.integers(2, u + 2, (n,)), dtype=torch.int32,
                            device=dev)
    dec_args = (memory, mask, hyps, hlens, hyps.flip(1).contiguous())
    out = {"card": smi()}
    launches = dict(NO_LAUNCHES)
    live = init_model(cfg, seed=1, device=dev)
    for quant in ("none", "int8"):
        out_dir = tmp / "e1" / quant
        proc, waiter, end = started["runs"][quant]
        waiter.join()
        (_, err), seconds = end[0]
        if proc.returncode != 0:
            raise RuntimeError(f"export --quantize {quant} exited "
                               f"{proc.returncode}:\n{err[-3000:]}")
        out[f"{quant}_export_s"] = seconds
        manifest = (out_dir / "manifest.yaml").read_text()
        params = "params.pt" if quant == "none" else "params_int8.pt"
        check(f"quantize: {quant}" in manifest and params in manifest,
              f"export {quant}: manifest {manifest!r}")
        if quant == "none":
            load_into(live, str(out_dir / params))
        else:
            live.load_state_dict(load_quantized(str(out_dir / params)))
        out[f"{quant}_params_bytes"] = (out_dir / params).stat().st_size
        progs = {name: torch.export.load(str(out_dir / f"{name}.pt2"))
                 for name in EXPORT_K1}
        for name, prog in progs.items():
            nodes = sum(nd.target is op for nd in prog.graph.nodes)
            out[f"{quant}_{name}_k1_nodes"] = nodes
            out[f"{quant}_{name}_bytes"] = \
                (out_dir / f"{name}.pt2").stat().st_size
            check(nodes == EXPORT_K1[name], f"export {quant} {name}: "
                  f"{nodes} K1 nodes, want {EXPORT_K1[name]}")
        mods = {name: prog.module() for name, prog in progs.items()}
        cache = live.encoder_init_cache(1, SERVE_CHUNK * SERVE_LEFT)
        tcache = export.tensor_cache(cache)
        with torch.no_grad():
            want = [live.encode_ctc(feats, lens)]
            for x in xs:
                ys, lp, cache = live.encoder_forward_chunk_ctc(x, cache)
                want.append((ys, lp))
            want.append(live.decoder_scores(*dec_args, 1.0))
            reset_counts()
            got = [mods["encoder_ctc"](feats, lens)]
            for x in xs:
                ys, lp, tcache = mods["encoder_chunk_ctc"](x, tcache)
                got.append((ys, lp))
            got.append(mods["decoder_scores"](*dec_args))
            torch.cuda.synchronize()
            counts = read_counts()
        for k in launches:
            launches[k] += counts[k]
        errs = []
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                if a.dtype == torch.bool:
                    errs.append(0.0 if torch.equal(a, b) else float("inf"))
                else:
                    errs.append(float((a.float() - b.float()).abs().max()))
        out[f"{quant}_max_abs_vs_live"] = max(errs)
        check(max(errs) <= EXPORT_TOL, f"export {quant}: .pt2 against the "
              f"live model max abs {max(errs)}")
        want_k1 = {**NO_LAUNCHES, "k1": sum(EXPORT_K1.values())
                   + EXPORT_K1["encoder_chunk_ctc"]}
        check(counts == want_k1, f"export {quant}: launches {counts}, want "
                                 f"{want_k1}")
        del progs, mods
    out["int8_over_fp32_params"] = (out["int8_params_bytes"]
                                    / out["none_params_bytes"])
    emit("export", model="u2pp_conformer", depth=dict(zip(
        ("encoder_blocks", "decoder_blocks", "reverse_blocks"), E1_DEPTH)),
        tolerance=f"max abs {EXPORT_TOL}",
        check_seconds=time.perf_counter() - t_phase,
        meanwhile_s=t_meanwhile, **out)
    return launches, beside



# ------------------------------------------------------ scale-out (D) ---
D_RANKS = 2
# D4 trains on the first of T12's train WAVs (its 200 took 4 batches a
# rank; these 2): the same checks at a smaller depth.
D4_TRAIN_WAVS = 96
# D3's modes: a subset of S3's "mode2_off" run (context mode 2, "off"),
# whose card files it must equal byte for byte.
D3_MODES = ("ctc_greedy_search", "rnnt_greedy_search", "attention_rescoring")


def state_sha(module) -> str:
    """sha256 over every parameter's and buffer's bytes, in state_dict
    order (ranks holding the same state bit for bit hash alike)."""
    h = hashlib.sha256()
    for k, v in module.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().reshape(-1).cpu().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def d1_config(conformer_rnnt_bias):
    """D1's model: the full-width flagship with the yaml's batch_norm conv
    module, fp32, every dropout rate 0.1 (the config's own)."""
    return batch_norm_flagship(conformer_rnnt_bias)()


def d2_batch(v: int, b: int = 256, t: int = 512, u: int = 32):
    """T4's batch (phase_rnnt_train's, the same seed) as numpy arrays."""
    rng = np.random.default_rng(0)
    return {"feats": rng.standard_normal((b, t, 80)).astype(np.float32),
            "feat_lengths": np.full((b,), t, np.int64),
            "labels": rng.integers(1, v - 2, (b, u)),
            "label_lengths": np.full((b,), u, np.int64),
            "context_list": rng.integers(1, v - 2, (8, 4)),
            "context_lengths": np.full((8,), 4, np.int64),
            "hw_labels": rng.integers(0, 2, (b, u))}


def rank_batch(batch: dict, ctx, device) -> dict:
    """This rank's part of a whole batch at the step's agreed shape, on
    ``device``."""
    from wenet_celoss_tpu_torch.parallel import dist
    part = dist.agree_shapes(dist.split_batch(batch, ctx.rank, ctx.world),
                             ctx)
    return on({k: v for k, v in part.items() if k != "keys"}, device)


def d1_rank(ctx, spec: dict) -> dict:
    """D1 on one rank: one fp32 gradient step of the full-width batch_norm
    flagship on its half of T3's batch over the group (dropout 0.1, the
    generator seeded as the one-process step's), the gradients averaged
    over the ranks (timed), one Adam update; rank 0 saves the averaged
    gradients and the running statistics for the parent."""
    from wenet_celoss_tpu_torch.configs import conformer_rnnt_bias
    from wenet_celoss_tpu_torch.models.factory import init_model
    from wenet_celoss_tpu_torch.parallel import dist, train
    cfg = d1_config(conformer_rnnt_bias)
    model = init_model(cfg, device=ctx.device, seed=0)
    init_sha = state_sha(model)
    tx, _ = train.make_optimizer(cfg)
    state = train.create_train_state(model, tx)
    whole = dict(np.load(spec["d1_batch"]))
    batch = rank_batch(whole, ctx, ctx.device)
    gen = torch.Generator().manual_seed(0)
    reset_counts()
    grads, metrics = train.make_grad_fn(model, group=ctx)(state, batch, gen)
    torch.cuda.synchronize()
    launches = read_counts()
    t0 = time.perf_counter()
    avg = dist.all_reduce_mean_(grads, ctx)
    torch.cuda.synchronize()
    allreduce_ms = (time.perf_counter() - t0) * 1e3
    state, gnorm = train.make_apply_fn(tx)(state, avg)
    if ctx.rank == 0:
        torch.save({"grads": [g.cpu() for g in avg],
                    "buffers": {k: v.cpu() for k, v in
                                model.named_buffers()}}, spec["d1_out"])
    return dict(init_sha=init_sha, sha=state_sha(model), launches=launches,
                metrics={k: float(v) for k, v in metrics.items()},
                gnorm=float(gnorm), rows=len(batch["feat_lengths"]),
                allreduce_ms=allreduce_ms)


def d2_rank(ctx, spec: dict) -> dict:
    """D2 on one rank: T4's bf16 point (B = 256 × 512 frames, 32 labels, 8
    hotwords, dropout 0.1) split 128 + 128 over the group: 2 warm-up and
    5 timed synchronised steps, the gradient all-reduce alone (3 calls on
    the step's gradient shapes), one profiled step (this rank's card busy
    time)."""
    from wenet_celoss_tpu_torch.configs import conformer_rnnt_bias
    from wenet_celoss_tpu_torch.models.factory import init_model
    from wenet_celoss_tpu_torch.parallel import dist, train
    cfg = conformer_rnnt_bias()
    cfg["dtype"] = "bfloat16"
    model = init_model(cfg, device=ctx.device, seed=0)
    tx, _ = train.make_optimizer(cfg)
    state = train.create_train_state(model, tx)
    step = train.make_train_step(model, tx, group=ctx)
    batch = rank_batch(d2_batch(cfg["output_dim"]), ctx, ctx.device)
    gen = torch.Generator().manual_seed(0)
    reset_counts()
    state, losses, times, _, gnorm = timed_steps(step, state, batch, gen)
    peak = torch.cuda.max_memory_allocated() / 2**30
    grads = [torch.zeros_like(p) for p in state.params]
    ar = []
    for _ in range(3):
        dist.barrier(ctx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce_mean_(grads, ctx)
        torch.cuda.synchronize()
        ar.append((time.perf_counter() - t0) * 1e3)
    dist.barrier(ctx)
    wall_ms, busy_ms, _ = profile_step(state, step, batch, gen)
    launches = read_counts()
    return dict(rows=len(batch["feat_lengths"]), ms_per_step=sorted(
        times)[len(times) // 2], ms_min_max=[min(times), max(times)],
        allreduce_ms=sorted(ar)[1], allreduce_mb=sum(
            g.numel() for g in grads) * 4 / 2**20, losses=losses,
        gnorm=float(gnorm), profiled_wall_ms=wall_ms,
        profiled_busy_ms=busy_ms, peak_mem_gib=peak, launches=launches,
        steps=len(losses) + 1)


def d3_rank(ctx, spec: dict) -> dict:
    """D3 on one rank: the recognize CLI with --sharded on S3's inputs
    (the 16 test-clean WAVs, S1's checkpoint and hotwords, context mode 2,
    "off") in D3_MODES; only rank 0 writes."""
    from wenet_celoss_tpu_torch.bin import recognize
    out = Path(spec["d3_out"]) / f"rank{ctx.rank}" / "text"
    reset_counts()
    t0 = time.perf_counter()
    recognize.main(spec["d3_argv"] + [
        "--result_file", str(out), "--sharded", "--dist_backend",
        ctx.backend, "--device", str(ctx.device)])
    torch.cuda.synchronize()
    return dict(seconds=time.perf_counter() - t0, launches=read_counts(),
                wrote=out.parent.exists())


def dist_rank_child(spec_path: str, rank: int) -> None:
    """One rank of the D phases, in a process of its own that
    ``dist_ranks`` starts with ``python -c``: D1, D2 and D3 over a gloo
    (or nccl) group, then D4 (the train CLI joins a group of its own);
    the results into this rank's JSON file."""
    import logging
    from wenet_celoss_tpu_torch.parallel import dist
    logging.basicConfig(level=logging.WARNING)
    spec = json.loads(Path(spec_path).read_text())
    register_counters()
    ctx = dist.init_distributed(spec["backend"], spec["init"],
                                device=spec["devices"][rank], rank=rank,
                                world_size=D_RANKS)
    out = {}
    for name, fn in (("d1", d1_rank), ("d2", d2_rank), ("d3", d3_rank)):
        if name in spec["phases"]:
            t0 = time.perf_counter()
            out[name] = fn(ctx, spec)
            out[name]["phase_s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    if "d3" not in spec["phases"]:   # recognize shut the group down
        dist.barrier(ctx)
        dist.shutdown()
    if "d4" in spec["phases"]:
        result = Path(spec["d4_out"]) / f"rank{rank}.json"
        argv = spec["d4_argv"] + [
            "--model_dir", str(Path(spec["d4_out"]) / f"exp_rank{rank}"),
            "--distributed", "--dist_backend", spec["backend"],
            "--device", spec["devices"][rank], "--ddp.init_method",
            spec["init"] + "_d4"]
        train_cli_child(argv, str(result), with_sha=True)
        out["d4"] = json.loads(result.read_text())
    Path(spec["out"].format(rank=rank)).write_text(json.dumps(out))


def dist_ranks(spec: dict, tmp: Path, timeout_s: int = 400,
               meanwhile=None) -> list:
    """``dist_rank_child`` on D_RANKS processes started at once (torchrun's
    environment, a ``file://`` rendezvous under ``tmp``) → each rank's
    results; ``meanwhile()`` runs in this process while they do. Raises if
    a rank fails or runs past ``timeout_s``; every rank's process group
    (with its loader workers) is killed then."""
    import signal
    spec = dict(spec, init=f"file://{tmp}/rendezvous",
                out=str(tmp / "rank{rank}.json"))
    (tmp / "spec.json").write_text(json.dumps(spec))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; "
            "chip_smoke.dist_rank_child(sys.argv[2], int(sys.argv[3]))")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(ROOT), str(tmp / "spec.json"),
         str(r)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT), RANK=str(r),
                 WORLD_SIZE=str(D_RANKS), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True) for r in range(D_RANKS)]
    deadline = time.perf_counter() + timeout_s
    errs = []
    try:
        if meanwhile is not None:
            meanwhile()
        for p in procs:
            errs.append(p.communicate(
                timeout=max(deadline - time.perf_counter(), 1))[1])
    except subprocess.TimeoutExpired:
        errs.append(f"ran past {timeout_s} s")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"dist ranks {bad} failed: " + " | ".join(
            e[-2000:] for e in errs if e))
    return [json.loads(Path(spec["out"].format(rank=r)).read_text())
            for r in range(D_RANKS)]


def grad_errors(names, got, want, gnorm) -> dict:
    """T3's gradient bounds: each tensor within 1e-3 relative Frobenius
    (the norm floored at 1e-6 * gnorm for the key biases, whose exact
    gradient is 0), a batch-normed depthwise bias (also 0 exactly) under
    1e-6 * gnorm on both sides → {"worst": (name, error over its limit),
    "bad": [(name, error), ...]}."""
    worst, bad = ("", 0.0), []
    for name, a, b in zip(names, got, want):
        a, b = a.double(), b.double()
        if name.endswith("depthwise_conv.bias"):
            err = max(float(a.abs().max()), float(b.abs().max()))
            limit = 1e-6 * gnorm
        else:
            floor = 1e-6 * gnorm if name.endswith("linear_k.bias") else 0.0
            err = float((a - b).norm()) / max(float(b.norm()), floor, 1e-30)
            limit = 1e-3
        if err / limit > worst[1]:
            worst = (name, err / limit)
        if not err <= limit:
            bad.append((name, err))
    return {"worst": worst, "bad": bad}


def phase_dist(init_model, conformer_rnnt_bias, train, wavs, s3: dict,
               t12, work: Path, meanwhile=None) -> dict:
    """D1-D4, the data-parallel path over D_RANKS processes: both ranks on
    cuda:0 over gloo on a one-card machine (two ranks sharing a card
    measure the code path, not a speed-up), one rank a card otherwise.
    D1 against the one-process card step here first; then every rank
    runs D1, D2, D3 and D4 (``dist_rank_child``), ``meanwhile()`` in this
    process beside them (so that D2's and D4's times are taken beside it);
    with two cards or more, D1 again over nccl. Returns {path: (launches,
    want)} for the kernels line."""
    tmp = work / "dist"
    tmp.mkdir()
    # D1's one-process reference on the card: the whole of T3's batch.
    cfg = d1_config(conformer_rnnt_bias)
    batch = with_hotwords(head(wavs, 16))
    np.savez(tmp / "d1_batch.npz", **batch)
    model = init_model(cfg, seed=0)
    init_sha = state_sha(model)
    reset_counts()
    grads, metrics = train.make_grad_fn(model)(
        train.TrainState(0, model, None), on(batch, "cuda"),
        torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    one_launches = read_counts()
    names = [n for n, _ in model.named_parameters()]
    want_g = [g.cpu() for g in grads]
    want_buf = {k: v.cpu() for k, v in model.named_buffers()}
    gnorm = float(torch.linalg.vector_norm(torch.stack(
        [g.double().norm() for g in want_g])))
    want_m = {k: float(v) for k, v in metrics.items()}
    del model, grads, metrics
    torch.cuda.empty_cache()

    d3_argv = s3["base"] + s3["hot"] + [
        "--mode", ",".join(D3_MODES), "--context_mode", "2",
        "--context_filter_state", "off"]
    t12_base, _ = t12
    t12_cfg = work / "t12" / "conf.yaml"
    # accum_grad 1: each joined micro-batch is an optimizer step, so that
    # the epoch's steps all-reduce gradients (T12's 4 would leave its ~3
    # micro-batches a rank without a step).
    d4_base = list(t12_base)
    at = d4_base.index("--train_data") + 1
    lines = Path(d4_base[at]).read_text().splitlines()[:D4_TRAIN_WAVS]
    d4_base[at] = str(tmp / "d4_train.list")
    Path(d4_base[at]).write_text("".join(x + "\n" for x in lines))
    d4_argv = ["--config", str(t12_cfg), "--num_epochs", "1",
               "--override_config", "accum_grad 1"] + d4_base
    spec = dict(backend="gloo", devices=["cuda:0"] * D_RANKS,
                phases=["d1", "d2", "d3", "d4"],
                d1_batch=str(tmp / "d1_batch.npz"),
                d1_out=str(tmp / "d1_grads.pt"), d3_argv=d3_argv,
                d3_out=str(tmp / "d3"), d4_argv=d4_argv,
                d4_out=str(tmp / "d4"))
    (tmp / "d4").mkdir()
    t0 = time.perf_counter()
    ranks = dist_ranks(spec, tmp, meanwhile=meanwhile)
    spawn_s = time.perf_counter() - t0
    d1_check(ranks, tmp, names, want_g, want_buf, want_m, gnorm, init_sha,
             one_launches, backend="gloo",
             nccl="not run: one card" if torch.cuda.device_count() < 2
             else "below")
    if torch.cuda.device_count() >= 2:
        nccl_tmp = work / "dist_nccl"
        nccl_tmp.mkdir()
        nranks = dist_ranks(dict(spec, backend="nccl", phases=["d1"],
                                 devices=[f"cuda:{r}" for r in
                                          range(D_RANKS)],
                                 d1_out=str(nccl_tmp / "d1_grads.pt")),
                            nccl_tmp)
        d1_check(nranks, nccl_tmp, names, want_g, want_buf, want_m, gnorm,
                 init_sha, one_launches, backend="nccl",
                 nccl="one rank a card")
    d2 = [r["d2"] for r in ranks]
    want2 = {k: n * d2[0]["steps"] for k, n in RNNT_PER_STEP.items()}
    check(all(r["launches"] == want2 for r in d2) and all(
        np.isfinite(r["losses"]).all() for r in d2),
        f"d2: launches {[r['launches'] for r in d2]}, want {want2}; "
        f"losses {[r['losses'] for r in d2]}")
    step_ms = max(r["ms_per_step"] for r in d2)
    emit("d2", label="two ranks on one card (gloo, the gradients staged "
                     "through the host): the code path, not a speed-up",
         model="conformer_rnnt_bias", dtype="bfloat16", rows_per_rank=[
             r["rows"] for r in d2], frames=512, labels=32, dropout=0.1,
         ms_per_step_by_rank=[r["ms_per_step"] for r in d2],
         ms_min_max_by_rank=[r["ms_min_max"] for r in d2],
         allreduce_ms_by_rank=[r["allreduce_ms"] for r in d2],
         allreduce_mib=d2[0]["allreduce_mb"],
         audio_s_per_s_both_ranks=256 * 512 * 0.01 / (step_ms / 1e3),
         profiled_wall_ms_by_rank=[r["profiled_wall_ms"] for r in d2],
         profiled_busy_ms_by_rank=[r["profiled_busy_ms"] for r in d2],
         card_idle_share=max(0.0, 1 - sum(r["profiled_busy_ms"] for r in d2)
                             / step_ms),
         idle_share_how="1 - (both ranks' card busy ms in one profiled "
                        "step) / the slower rank's median ms a step (the "
                        "profiler slows the step it watches); the two "
                        "processes' kernels may overlap on the card",
         peak_mem_gib_by_rank=[r["peak_mem_gib"] for r in d2],
         launches=d2[0]["launches"], want=want2, phase_s=[
             r["phase_s"] for r in d2])

    d3 = [r["d3"] for r in ranks]
    got_dir = tmp / "d3" / "rank0"
    card_dir = s3["dir"] / "mode2_off" / "card"
    same = {m: (got_dir / f"text.{m}").read_bytes()
            == (card_dir / f"text.{m}").read_bytes() for m in D3_MODES}
    check(all(same.values()) and d3[0]["wrote"] and not d3[1]["wrote"],
          f"d3: files equal to S3's card run {same}; rank 1 wrote "
          f"{d3[1]['wrote']}")
    emit("d3", modes=list(D3_MODES), context_mode=2, state="off",
         utterances=16, byte_equal_to_s3_card=same,
         rank1_wrote_nothing=not d3[1]["wrote"],
         seconds_by_rank=[r["seconds"] for r in d3],
         launches_by_rank=[r["launches"] for r in d3])

    d4 = [r["d4"] for r in ranks]
    out = tmp / "d4" / "exp_rank0"
    recs = read_records(out / "metrics.jsonl")
    batches = [r["launches"]["k1_bwd"] // CLI_PER_BATCH["k1_bwd"]
               for r in d4]
    want4 = [{k: batches[i] * CLI_PER_BATCH[k]
              + sum(d4[i]["cv_batches"]) * CLI_PER_CV_BATCH[k]
              for k in NO_LAUNCHES} for i in range(D_RANKS)]
    info = ckpt_infos(out / "0.pt")
    steps = batches[0]   # accum_grad 1
    ok = (batches[0] == batches[1] == len(recs) > 0
          and all(d4[i]["launches"] == want4[i] for i in range(D_RANKS))
          and d4[0]["model_sha"] == d4[1]["model_sha"]
          and not (tmp / "d4" / "exp_rank1").exists()
          and info.get("step") == steps and os.readlink(
              out / "final.pt") == "0.pt")
    check(ok, f"d4: batches {batches}, records {len(recs)}, launches "
              f"{[r['launches'] for r in d4]}, want {want4}, shas equal "
              f"{d4[0]['model_sha'] == d4[1]['model_sha']}, infos {info}")
    emit("d4", model="conformer_rnnt_bias (yaml)", epochs=1,
         train_wavs=D4_TRAIN_WAVS, ranks=D_RANKS, backend="gloo",
         batches_per_rank=batches, optimizer_steps=steps,
         cv_batches_by_rank=[r["cv_batches"] for r in d4],
         epoch_s_by_rank=[r["epoch_s"] for r in d4],
         loader_startup_s_by_rank=[r["startup_s"] for r in d4],
         ranks_bitwise_equal=d4[0]["model_sha"] == d4[1]["model_sha"],
         rank1_wrote_nothing=not (tmp / "d4" / "exp_rank1").exists(),
         first_loss=recs[0]["loss"], last_loss=recs[-1]["loss"],
         launches=d4[0]["launches"], want=want4[0])
    emit("dist", spawn_s=spawn_s, ranks=D_RANKS,
         cards=torch.cuda.device_count())
    return {"d1": (ranks[0]["d1"]["launches"], RNNT_PER_STEP),
            "d2": (d2[0]["launches"], RNNT_PER_STEP),
            "d4": (d4[0]["launches"], CLI_PER_BATCH)}


def d1_check(ranks, tmp, names, want_g, want_buf, want_m, gnorm, init_sha,
             one_launches, backend, nccl) -> None:
    """D1's checks against the one-process card step: the ranks' mean
    loss terms (1e-5 relative), their averaged gradients (T3's bounds),
    the running statistics after the step (1e-4 of each tensor's
    largest element), the ranks bitwise equal after the Adam update, and
    each rank's launches one step's."""
    d1 = [r["d1"] for r in ranks]
    saved = torch.load(tmp / "d1_grads.pt", weights_only=False)
    errs = grad_errors(names, saved["grads"], want_g, gnorm)
    loss_err = {k: abs(d1[0]["metrics"][k] - want_m[k])
                / max(abs(want_m[k]), 1e-30) for k in LOSS_KEYS}
    buf_err = {k: float((saved["buffers"][k] - v).abs().max()
                        / max(float(v.abs().max()), 1e-30))
               for k, v in want_buf.items() if "running" in k}
    ok = (not errs["bad"] and all(e <= 1e-5 for e in loss_err.values())
          and all(e <= 1e-4 for e in buf_err.values())
          and d1[0]["sha"] == d1[1]["sha"]
          and d1[0]["init_sha"] == d1[1]["init_sha"] == init_sha
          and d1[0]["metrics"] == d1[1]["metrics"]
          and all(r["launches"] == RNNT_PER_STEP for r in d1)
          and one_launches == RNNT_PER_STEP)
    check(ok, f"d1 {backend}: gradients {errs}, losses {loss_err}, "
              f"running statistics {buf_err}, ranks equal "
              f"{d1[0]['sha'] == d1[1]['sha']}, launches "
              f"{[r['launches'] for r in d1]} / {one_launches}")
    emit("d1", backend=backend, nccl=nccl, ranks=D_RANKS,
         model="conformer_rnnt_bias (batch_norm)", dtype="float32",
         dropout=0.1, rows_per_rank=[r["rows"] for r in d1], ok=ok,
         worst_grad=errs["worst"], loss_rel_err=loss_err,
         worst_running_stat=max(buf_err.values()),
         ranks_bitwise_equal=d1[0]["sha"] == d1[1]["sha"],
         launches_by_rank=[r["launches"] for r in d1],
         one_process_launches=one_launches,
         allreduce_ms_by_rank=[r["allreduce_ms"] for r in d1],
         phase_s=[r["phase_s"] for r in d1],
         tolerance="against the one-process card step on the whole batch "
                   "(same weights, dropout seeds and masks): loss terms "
                   "1e-5 relative; each gradient 1e-3 relative Frobenius "
                   "(T3's, with its floors for the key and depthwise "
                   "biases); running statistics 1e-4 of each tensor's "
                   "largest element; the ranks' state after Adam bit for "
                   "bit")


def load_t12_config():
    from wenet_celoss_tpu_torch.utils.config import load_config
    cfg = load_config(str(FLAGSHIP_YAML))
    cfg["dataset_conf"]["loader_processes"] = 2
    cfg["log_interval"] = 1
    return cfg


def ckpt_infos(path: Path) -> dict:
    from wenet_celoss_tpu_torch.utils import checkpoint as ckpt
    return ckpt.load_checkpoint_infos(str(path))


def kernel_line(name, source, replaces, by_path, record) -> dict:
    """One kernel's entry; ``factor`` is its time (card time where it has
    one) over its yardstick's, null without a yardstick."""
    lib = record.get("library_ms")
    ms = record.get("device_ms", record.get("ms"))
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=sum(by_path.values()), launches_by_path=by_path,
                factor=ms / lib if lib else None, **record)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        return run(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(work: Path) -> int:
    """Every phase, with ``work`` as the scratch directory (removed after
    the run); see the module docstring."""
    sys.path.insert(0, str(ROOT))
    from wenet_celoss_tpu_torch.configs import (conformer_ctc_aed,
                                                conformer_rnnt_bias,
                                                u2pp_conformer)
    from wenet_celoss_tpu_torch.decode.api import Decoder
    from wenet_celoss_tpu_torch.models.factory import init_model
    from wenet_celoss_tpu_torch.ops import (_build, bounds, conv, dropout,
                                            ffn, ln_matmul, lstm, rnnt_loss)
    from wenet_celoss_tpu_torch.parallel import train

    register_counters()
    name = torch.cuda.get_device_name(0)
    card = smi()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=name, count=torch.cuda.device_count(), nvidia_smi=card,
         peaks="H100 SXM data sheet at 700 W; this card: " + card)

    t0 = time.perf_counter()
    decoder_main_build = DecoderMainBuild()   # g++ beside the nvcc runs
    _build.build_all(["ln_ffn_residual", "rnnt_joint", "lstm2_seq",
                      "rnnt_lattice", "conv_block", "ln_matmul"])
    decoder_main = decoder_main_build.wait()
    emit("build", seconds=time.perf_counter() - t0,
         per_source=_build.build_seconds,
         decoder_main=str(decoder_main.relative_to(ROOT)),
         decoder_main_s=decoder_main_build.seconds)
    s3 = s3_setup(work, init_model, conformer_rnnt_bias)
    refs = refs_setup(work, s3)
    try:
        return run_phases(work, s3, refs, decoder_main, name, card)
    finally:
        for proc in (s3["cpu_proc"], refs["proc"]):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def run_phases(work: Path, s3: dict, refs: dict, decoder_main: Path,
               name: str, card: str) -> int:
    """The phases after the build, S3's CPU side and the CPU references
    already running."""
    from wenet_celoss_tpu_torch.configs import (conformer_ctc_aed,
                                                conformer_rnnt_bias,
                                                u2pp_conformer)
    from wenet_celoss_tpu_torch.decode.api import Decoder
    from wenet_celoss_tpu_torch.models.factory import init_model
    from wenet_celoss_tpu_torch.ops import (bounds, conv, dropout, ffn,
                                            ln_matmul, lstm, rnnt_loss)
    from wenet_celoss_tpu_torch.parallel import train

    k1 = phase_k1(ffn, bounds)
    k1_bwd = phase_k1_bwd(ffn, bounds, dropout)
    k2, k3 = phase_k2_k3(rnnt_loss, bounds)
    k4, k4_bwd = phase_k4(lstm, bounds, dropout)
    k9 = phase_k9(rnnt_loss, bounds)
    phase_nbest_kernels(rnnt_loss, lstm, bounds)
    k8, k8_bwd = phase_k8(conv, bounds, dropout)
    k7, k7_bwd = phase_k7(ln_matmul, bounds)
    k6, k6_bwd = phase_k6(ffn, bounds, dropout)
    phase_row_base(ffn, lstm, conv, dropout)
    decode_launches, slice_run = phase_slice(init_model, Decoder,
                                             conformer_rnnt_bias, ffn, refs)
    to_profile = []
    for bias in BENCH_BLANK_BIASES:
        to_profile += phase_bench(init_model, Decoder, conformer_rnnt_bias,
                                  ffn, bias)
    lnmm_bench = phase_bench_lnmm(init_model, Decoder, conformer_rnnt_bias,
                                  BENCH_BLANK_BIASES[0])
    phase_op_dispatch(to_profile[0], slice_run, ffn, ln_matmul, conv)
    wavs, dropped = load_train_wavs()
    emit("train_wavs_loaded", utterances=len(wavs["feat_lengths"]),
         left_out_unalignable=dropped)

    def checks():
        """The card-against-CPU checks that run in this process while the
        serving runs' processes and E1's exports do (their CPU sides are
        the CPU references'): S1-conv, S1-lnmm, S1-modes, S2, A1, L1 and
        LM1, then the training steps T0-check to BN-check. → (the tools'
        launches, S1-conv's K8, S1-lnmm's K7 and S2's K1 launches)."""
        conv_decode = phase_conv_decode(slice_run, conv)
        lnmm_decode = phase_lnmm_decode(slice_run, ln_matmul, conv)
        lm1_cpu_nbest = phase_decode_modes(slice_run)
        stream = phase_stream_slice(init_model, Decoder, u2pp_conformer,
                                    slice_run)
        launches = phase_tools(s3, refs, slice_run, lm1_cpu_nbest)
        phase_train_check(init_model, train, wavs, refs, want=CTC_PER_STEP)
        phase_train_check(init_model, train, wavs, refs,
                          what="postnorm_train_check",
                          model_name="postnorm_transformer_aed",
                          want=POSTNORM_PER_STEP)
        phase_train_check(init_model, train, wavs, refs,
                          what="u2pp_train_check",
                          model_name="u2pp_conformer", want=U2PP_PER_STEP)
        phase_rnnt_train_check(init_model, train, wavs, refs)
        for what, env, want in (
                ("rnnt_pallas_train_check", {}, PALLAS_PER_STEP),
                ("conv_train_check", CONV, CONV_PER_STEP),
                ("lnmm_train_check", LNMM, LNMM_PER_STEP),
                ("bn_train_check", {}, RNNT_PER_STEP)):
            phase_rnnt_train_check(init_model, train, wavs, refs, what=what,
                                   env=env, want=want)
        return launches, (conv_decode, lnmm_decode, stream)

    with tempfile.TemporaryDirectory() as serve_tmp:
        serve_tmp = Path(serve_tmp)
        t_serve = time.perf_counter()
        exports = start_export(init_model, u2pp_conformer, serve_tmp)
        svc = start_services(init_model, u2pp_conformer,
                             conformer_rnnt_bias, serve_tmp)
        emit("serve_start", seconds=time.perf_counter() - t_serve)
        serve_u2pp = phase_serve_u2pp(svc)
        serve_rnnt = phase_serve_rnnt(svc)
        del svc["workers"]
        lang = w1_lang(svc["files"], refs["tools"])
        export_run, (tools_launches, (conv_decode, lnmm_decode,
                                      stream_decode)) = phase_serve_runs(
            decoder_main, svc["files"], serve_tmp,
            lambda: phase_export(init_model, exports, meanwhile=checks),
            lambda: r1_cpu_compare(svc), lang)
        emit("serve_all", seconds=time.perf_counter() - t_serve)
        tools_launches["wfst"] = phase_w1(svc["files"]["w1"])
    phase_f1()
    b3_paths, b3_profile = phase_bench_modes(
        init_model, Decoder, conformer_rnnt_bias, BENCH_BLANK_BIASES[0])
    b4_profile = phase_bench_stream(init_model, Decoder, u2pp_conformer)
    t12_dir = work / "t12"
    t12_dir.mkdir()
    t12 = t12_inputs(t12_dir)
    train_profile, t1 = phase_train(init_model, conformer_ctc_aed(), train,
                                    want=CTC_PER_STEP)
    phase_train_wavs(init_model, conformer_ctc_aed, train, wavs)
    bn_flagship = batch_norm_flagship(conformer_rnnt_bias)
    rnnt_profile, rnnt = phase_rnnt_train(init_model, conformer_rnnt_bias,
                                          train)
    conv_profile, conv_run = phase_rnnt_train(
        init_model, conformer_rnnt_bias, train, what="conv_train",
        env=CONV, want=CONV_PER_STEP, t4_ms_per_step=rnnt_profile[-1])
    lnmm_profile, lnmm_run = phase_rnnt_train(
        init_model, conformer_rnnt_bias, train, what="lnmm_train",
        env=LNMM, want=LNMM_PER_STEP, t4_ms_per_step=rnnt_profile[-1])
    bn_profile, bn_run = phase_rnnt_train(
        init_model, bn_flagship, train, what="bn_train",
        t4_ms_per_step=rnnt_profile[-1], cnn_module_norm="batch_norm")
    pallas_profile, pallas = phase_rnnt_train(
        init_model, conformer_rnnt_bias, train, b=64,
        what="rnnt_pallas_train", impl="pallas", want=PALLAS_PER_STEP)
    t_v = time.perf_counter()
    phase_variant_kernels(ffn, rnnt_loss)
    variant_runs = {v: phase_variant(v, overrides, frames, init_model,
                                     conformer_rnnt_bias, train, Decoder,
                                     refs)
                    for v, overrides, frames in VARIANTS}
    emit("variants", seconds=time.perf_counter() - t_v)
    postnorm_profile, t9 = phase_train(
        init_model, postnorm_aed(conformer_ctc_aed), train,
        what="postnorm_train", model_name="postnorm_transformer_aed",
        want=POSTNORM_PER_STEP)
    u2pp_profile, t11 = phase_train(
        init_model, u2pp_conformer(), train, what="u2pp_train",
        model_name="u2pp_conformer", want=U2PP_PER_STEP)
    u2pp_conv_profile, t11_conv = phase_train(
        init_model, u2pp_conformer(), train, what="u2pp_conv_train",
        model_name="u2pp_conformer", want=U2PP_CONV_PER_STEP, env=CONV)
    phase_rnnt_train_wavs(init_model, conformer_rnnt_bias, train, wavs)
    phase_rnnt_train_wavs(init_model, bn_flagship, train, wavs,
                          what="bn_train_wavs")
    # S3 and D this late: S3's CPU side, started after the build, has run
    # beside every phase before them. S3 and the T12 checks run beside the
    # D ranks (D3 is held to S3's card files after both).
    beside_dist = {}

    def beside_d():
        beside_dist["recognize"] = phase_recognize(
            init_model, Decoder, conformer_rnnt_bias, s3)
        phase_train_cli_check()
        phase_train_resume()
    dist_paths = phase_dist(init_model, conformer_rnnt_bias, train, wavs, s3,
                            t12, work, meanwhile=beside_d)
    recognize_launches = beside_dist["recognize"]
    train_cli = phase_train_cli(t12_dir, t12)
    phase_exact_bench(init_model, Decoder, conformer_rnnt_bias)
    for args in to_profile:
        phase_profile(*args)
    for args in b3_profile:
        phase_modes_profile(*args)
    phase_modes_profile(*b4_profile, prefix="b4_")
    for args in lnmm_bench:
        phase_profile(*args, env=LNMM)
    phase_train_profile(*train_profile)
    phase_train_profile(*postnorm_profile, mode="postnorm_train",
                        kernel="k6")
    phase_train_profile(*u2pp_profile, mode="u2pp_train")
    phase_train_profile(*u2pp_conv_profile, mode="u2pp_conv_train",
                        env=CONV)
    phase_rnnt_profile(*rnnt_profile)
    phase_int64_sites(*rnnt_profile[:4], dropout)
    phase_rnnt_profile(*conv_profile, mode="conv_train", env=CONV)
    phase_rnnt_profile(*lnmm_profile, mode="lnmm_train", env=LNMM)
    phase_rnnt_profile(*bn_profile, mode="bn_train")
    phase_rnnt_profile(*pallas_profile, mode="rnnt_pallas_train")
    for v, (_, run) in variant_runs.items():
        phase_train_profile(*run, mode=f"{v}_train")
    phase_k8_device(conv, bounds, k8, k8_bwd)
    phase_k8_causal_device(conv, bounds, k8, k8_bwd)
    phase_k6_k7_device(ffn, ln_matmul, (k6, k6_bwd), (k7, k7_bwd))
    paths = {"train": (t1, CTC_PER_STEP),
             "train_rnnt": (rnnt, RNNT_PER_STEP),
             "conv_train": (conv_run, CONV_PER_STEP),
             "lnmm_train": (lnmm_run, LNMM_PER_STEP),
             "train_rnnt_pallas": (pallas, PALLAS_PER_STEP),
             "postnorm_train": (t9, POSTNORM_PER_STEP),
             "bn_train": (bn_run, RNNT_PER_STEP),
             "u2pp_train": (t11, U2PP_PER_STEP),
             "u2pp_conv_train": (t11_conv, U2PP_CONV_PER_STEP),
             "recognize": (recognize_launches, RECOGNIZE_KERNELS),
             "train_cli": train_cli,
             "serve_u2pp": (serve_u2pp, SERVE_KERNELS),
             "serve_rnnt": (serve_rnnt, SERVE_KERNELS),
             "export": (export_run, SERVE_KERNELS),
             "tools_alignment": (tools_launches["a1"], SERVE_KERNELS),
             "tools_label_checker": (tools_launches["l1"], SERVE_KERNELS),
             "tools_lm_rescore": (tools_launches["lm1"], SERVE_KERNELS),
             "tools_wfst": (tools_launches["wfst"], SERVE_KERNELS),
             **{"decode_" + n: v for n, v in b3_paths.items()},
             **{n + "_train": v[0] for n, v in variant_runs.items()},
             **{"dist_" + n: v for n, v in dist_paths.items()}}
    idle = {path: sorted(k for k, n in want.items()
                         if n > 0 and launches[k] == 0)
            for path, (launches, want) in paths.items()}
    check(decode_launches > 0 and conv_decode > 0 and lnmm_decode > 0
          and stream_decode > 0 and not any(idle.values()),
          f"a kernel of a main path was not launched: decode "
          f"{decode_launches}, conv_decode {conv_decode}, lnmm_decode "
          f"{lnmm_decode}, stream_decode {stream_decode}, training paths "
          f"{idle}")

    if failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failures),
              file=sys.stderr)
        return 1
    csrc = "wenet_celoss_tpu_torch/csrc/"
    tpu = "wenet_celoss_tpu/ops/"

    def by_path(key, **more):
        return {**more, **{path: launches[key] for path, (launches, want)
                           in paths.items() if want[key] > 0}}
    print(card)
    print(json.dumps({"kernels": [
        kernel_line("ln_ffn_residual", csrc + "ln_ffn_residual.cu",
                    tpu + "ffn_pallas.py:384",
                    by_path("k1", decode=decode_launches,
                            stream_decode=stream_decode), k1),
        kernel_line("ln_ffn_residual_bwd", csrc + "ln_ffn_residual.cu",
                    tpu + "ffn_pallas.py:422", by_path("k1_bwd"), k1_bwd),
        kernel_line("streaming_joint_planes_fwd", csrc + "rnnt_joint.cu",
                    tpu + "rnnt_pallas.py:369", by_path("k2"), k2),
        kernel_line("streaming_joint_planes_bwd", csrc + "rnnt_joint.cu",
                    tpu + "rnnt_pallas.py:429", by_path("k3"), k3),
        kernel_line("lstm2_seq", csrc + "lstm2_seq.cu",
                    tpu + "lstm_pallas.py:289", by_path("k4"), k4),
        kernel_line("lstm2_seq_bwd", csrc + "lstm2_seq.cu",
                    tpu + "lstm_pallas.py:327", by_path("k4_bwd"), k4_bwd),
        kernel_line("ffn_fused", csrc + "ln_ffn_residual.cu",
                    tpu + "ffn_pallas.py:170", by_path("k6"), k6),
        kernel_line("ffn_fused_bwd", csrc + "ln_ffn_residual.cu",
                    tpu + "ffn_pallas.py:201", by_path("k6_bwd"), k6_bwd),
        kernel_line("ln_matmul", csrc + "ln_matmul.cu",
                    tpu + "ffn_pallas.py:559",
                    by_path("k7", lnmm_decode=lnmm_decode), k7),
        kernel_line("ln_matmul_bwd", csrc + "ln_matmul.cu",
                    tpu + "ffn_pallas.py:595", by_path("k7_bwd"), k7_bwd),
        kernel_line("conv_block_residual", csrc + "conv_block.cu",
                    tpu + "conv_pallas.py:285",
                    by_path("k8", conv_decode=conv_decode), k8),
        kernel_line("conv_block_residual_bwd", csrc + "conv_block.cu",
                    tpu + "conv_pallas.py:318", by_path("k8_bwd"), k8_bwd),
        kernel_line("alpha_beta", csrc + "rnnt_lattice.cu",
                    tpu + "rnnt_pallas.py:148", by_path("k9"), k9)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
