"""PyTorch/CUDA inference worker for the C++ serving runtime (port of
``wenet_celoss_tpu/bin/runtime_worker.py``).

The counterpart of ``runtime/core/decoder/subprocess_asr_model.h``: it
speaks the framed protocol over stdin/stdout, holds the streaming encoder
caches and the encoder outputs of the current utterance, and answers the
C++ side's requests (``decoder_main``, ``websocket_server_main``, the C
API and the gRPC front end run it through ``--worker_cmd`` or a model
directory's ``worker_cmd.txt``):

    python -m wenet_celoss_tpu_torch.bin.runtime_worker \\
        --config train.yaml --checkpoint final.ckpt --chunk_size 16

Protocol (little-endian):
  in : 'I' u32(len) cfg_json?   → out: 'M' u32(len) meta_json
  in : 'F' u32(T) u32(D) f32[T*D] → out: 'O' u32(T') u32(V) f32[T'*V]
  in : 'R' u32(N) f32(rw) { u32(L) i32[L] }*N → out: 'S' u32(N) f32[N]
  in : 'B' u32(beam) → out: 'N' u32(n) { u32(L) i32[L] f32(score) }*n
  in : 'G' → out: 'T' u32(n) i32[n]
  in : 'Q' → exit

The worker runs on the card unless given ``--device cpu``, and raises
without one. ``--checkpoint`` takes a JAX ``.ckpt`` or the port's ``.pt``,
so one file drives both workers. Standard output carries only protocol
bytes: ``main`` moves file descriptor 1 onto standard error before the
model loads, so logs, warnings and the kernel builds' messages go there.
The kernels build at their first launch (``ops/_build.py``), so a cold
worker builds inside its first request.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys

import numpy as np
import torch

from wenet_celoss_tpu_torch.decode.rescoring import score_hyps_with_decoder
from wenet_celoss_tpu_torch.decode.rnnt_beam import rnnt_prefix_beam_search
from wenet_celoss_tpu_torch.decode.rnnt_greedy import rnnt_greedy_chunk
from wenet_celoss_tpu_torch.models.factory import init_model, resolve_device
from wenet_celoss_tpu_torch.utils.checkpoint import load_into
from wenet_celoss_tpu_torch.utils.config import load_config


def read_exact(f, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = f.read(n - len(buf))
        if not chunk:
            raise EOFError
        buf += chunk
    return buf


def _bucket(n: int, size: int) -> int:
    return -(-n // size) * size


class Worker:
    """One stream's state and the model, on ``args.device``."""

    def __init__(self, args):
        self.device = resolve_device(args.device)
        self.configs = load_config(args.config)
        self.chunk_size = args.chunk_size
        self.num_left_chunks = args.num_left_chunks
        self.model = init_model(self.configs, device=self.device)
        if args.checkpoint:
            load_into(self.model, args.checkpoint)
        enc = self.model.encoder
        self.subsampling_rate = enc.subsampling_rate
        self.right_context = enc.right_context
        self.window = (self.chunk_size - 1) * self.subsampling_rate \
            + self.right_context + 1
        self.stride = self.chunk_size * self.subsampling_rate
        # A non-causal conformer has no conv-cache streaming form: it is
        # served by recomputing the chunk-masked prefix every chunk and
        # emitting only the new frames (exact, quadratic in the length).
        self.streamable = enc.streamable
        self.is_transducer = getattr(self.model, "predictor", None) \
            is not None
        self.reset()

    def _empty(self) -> np.ndarray:
        return np.zeros((0, self.configs["output_dim"]), np.float32)

    def reset(self) -> None:
        left = self.num_left_chunks
        self.cache = self.model.encoder_init_cache(
            1, self.chunk_size * left if left > 0 else self.chunk_size * 4)
        self.feat_buffer = np.zeros((0, self.configs["input_dim"]),
                                    np.float32)
        self.encoder_outs = []   # [T', D] tensors on the device
        self.greedy_carry = None
        self.greedy_consumed = 0
        # the non-streamable path's state
        self.full_buffer = np.zeros((0, self.configs["input_dim"]),
                                    np.float32)
        self.emitted = 0

    def meta(self) -> dict:
        return {"subsampling_rate": self.subsampling_rate,
                "right_context": self.right_context,
                "sos": self.model.sos, "eos": self.model.eos}

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.no_grad()
    def forward_chunk(self, feats: np.ndarray) -> np.ndarray:
        """Append raw frames, run every complete window, and return the
        new subsampled CTC log-probs. An empty ``feats`` flushes: the short
        tail is zero-padded to the window."""
        if not self.streamable:
            return self._forward_chunk_full(feats)
        if feats.shape[0] > 0:
            self.feat_buffer = np.concatenate(
                [self.feat_buffer, feats.reshape(feats.shape[0], -1)])
        outs = []
        flush = feats.shape[0] == 0
        while self.feat_buffer.shape[0] >= self.window or (
                flush and self.feat_buffer.shape[0] > self.right_context):
            win = self.feat_buffer[:self.window]
            if win.shape[0] < self.window:
                win = np.concatenate(
                    [win, np.zeros((self.window - win.shape[0],
                                    win.shape[1]), np.float32)])
            ys, ctc_lp, self.cache = self.model.encoder_forward_chunk_ctc(
                self._to_device(win[None]), self.cache)
            self.encoder_outs.append(ys[0])
            outs.append(ctc_lp[0].float().cpu().numpy())
            self.feat_buffer = self.feat_buffer[self.stride:]
            if flush and self.feat_buffer.shape[0] == 0:
                break
        return np.concatenate(outs) if outs else self._empty()

    def _forward_chunk_full(self, feats: np.ndarray) -> np.ndarray:
        """The non-streamable path: the chunk-masked forward of the whole
        prefix (padded to a multiple of the stride), emitting the frames
        past those already returned."""
        flush = feats.shape[0] == 0
        if not flush:
            self.full_buffer = np.concatenate(
                [self.full_buffer, feats.reshape(feats.shape[0], -1)])
        n = self.full_buffer.shape[0]
        # frames the subsampling can fully see (its right context read)
        usable = n if flush else n - self.right_context
        ready = usable - self.emitted * self.subsampling_rate >= self.stride
        if not (ready or (flush and n > self.right_context)):
            return self._empty()
        xs = np.zeros((1, _bucket(n, self.stride),
                       self.full_buffer.shape[1]), np.float32)
        xs[0, :n] = self.full_buffer
        left = self.num_left_chunks if self.num_left_chunks > 0 else -1
        ys, mask, ctc_lp = self.model.encode_ctc(
            self._to_device(xs),
            torch.tensor([n], device=self.device), self.chunk_size, left)
        valid = int(mask[0].sum())
        if not flush:
            # hold back frames whose conv window peeks past the buffer
            full_frames = max(
                (usable - self.right_context) // self.subsampling_rate, 0)
            valid = min(valid, full_frames)
        if valid <= self.emitted:
            return self._empty()
        new_lp = ctc_lp[0, self.emitted:valid].float().cpu().numpy()
        self.encoder_outs.append(ys[0, self.emitted:valid])
        self.emitted = valid
        return new_lp

    @torch.no_grad()
    def greedy_new_tokens(self) -> list:
        """Transducer greedy decode of the encoder frames produced since
        the last call (the serving form of the reference's streaming
        ``rnnt_greedy_search.cc``), four emissions a frame at most."""
        if not self.is_transducer or not self.encoder_outs:
            return []
        full = torch.cat(self.encoder_outs)
        new = full[self.greedy_consumed:]
        if new.shape[0] == 0:
            return []
        model = self.model
        if self.greedy_carry is None:
            state = model.predictor_init_state(1)
            self.greedy_carry = model.predictor_step(
                torch.full((1,), model.blank, dtype=torch.long,
                           device=self.device), state,
                torch.zeros((1,), dtype=torch.long, device=self.device))
        tokens, lens, self.greedy_carry = rnnt_greedy_chunk(
            model.predictor_step, model.joint_step, self.greedy_carry,
            new[None], blank=model.blank, n_steps=4)
        self.greedy_consumed = full.shape[0]
        return [int(x) for x in tokens[0, :int(lens[0])].cpu()]

    @torch.no_grad()
    def rnnt_beam(self, beam: int):
        """Utterance-final transducer prefix beam over every encoder frame
        of the utterance → [(tokens, score)] best first (entries scored
        below -1e20 dropped). T is padded to a multiple of 64, as the JAX
        worker pads it for its compile cache."""
        if not self.is_transducer or not self.encoder_outs:
            return []
        enc = torch.cat(self.encoder_outs)
        t = enc.shape[0]
        t_pad = max(64, _bucket(t, 64))
        enc = torch.nn.functional.pad(enc, (0, 0, 0, t_pad - t))
        model = self.model
        res = rnnt_prefix_beam_search(
            model.predictor_step, model.joint_step,
            model.predictor_init_state(beam), enc[None],
            torch.tensor([t], device=self.device), beam=beam,
            topk=min(beam, 10), blank=model.blank,
            state_gather=model.predictor_gather_state)
        toks, lens, scores = (res[k][0].cpu() for k in
                              ("tokens", "lens", "scores"))
        return [([int(x) for x in toks[i, :lens[i]]], float(scores[i]))
                for i in range(toks.shape[0]) if scores[i] >= -1e20]

    @torch.no_grad()
    def rescore(self, hyps, reverse_weight: float) -> np.ndarray:
        """Attention scores of an n-best list, one decoder pass over all
        of it. The shapes keep the JAX worker's buckets (T' to 64 frames,
        N to 16 hypotheses, U to 32 labels), so the masked reductions run
        over the same padded shapes."""
        if not self.encoder_outs:
            return np.zeros((len(hyps),), np.float32)
        enc = torch.cat(self.encoder_outs)
        t = enc.shape[0]
        t_pad = max(64, _bucket(t, 64))
        memory = torch.nn.functional.pad(enc, (0, 0, 0, t_pad - t))[None]
        mask = (torch.arange(t_pad, device=self.device) < t)[None]
        n = len(hyps)
        n_pad = _bucket(max(n, 1), 16)
        u_pad = _bucket(max(max((len(h) for h in hyps), default=1), 1), 32)
        toks = np.full((1, n_pad, u_pad), -1, np.int64)
        lens = np.zeros((1, n_pad), np.int64)
        for i, h in enumerate(hyps):
            toks[0, i, :len(h)] = h
            lens[0, i] = len(h)
        att = score_hyps_with_decoder(
            self.model.decoder_scores, memory, mask, self._to_device(toks),
            self._to_device(lens), self.model.sos, self.model.eos,
            reverse_weight)
        return att[0, :n].float().cpu().numpy()


def serve(worker: Worker, fin, fout) -> None:
    """Answer requests from ``fin`` on ``fout`` until 'Q' or the end of
    the input; every reply is flushed."""
    while True:
        try:
            tag = read_exact(fin, 1)
        except EOFError:
            return
        if tag == b"Q":
            return
        if tag == b"I":
            (cfg_len,) = struct.unpack("<I", read_exact(fin, 4))
            if cfg_len:
                read_exact(fin, cfg_len)
            worker.reset()
            meta = json.dumps(worker.meta()).encode()
            fout.write(b"M" + struct.pack("<I", len(meta)) + meta)
        elif tag == b"F":
            t, d = struct.unpack("<II", read_exact(fin, 8))
            data = np.frombuffer(read_exact(fin, 4 * t * d),
                                 "<f4").reshape(t, d)
            out = worker.forward_chunk(data.astype(np.float32))
            fout.write(b"O" + struct.pack("<II", *out.shape))
            fout.write(out.astype("<f4").tobytes())
        elif tag == b"G":
            toks = worker.greedy_new_tokens()
            fout.write(b"T" + struct.pack("<I", len(toks)))
            fout.write(np.asarray(toks, "<i4").tobytes())
        elif tag == b"B":
            (beam,) = struct.unpack("<I", read_exact(fin, 4))
            nbest = worker.rnnt_beam(int(beam))
            fout.write(b"N" + struct.pack("<I", len(nbest)))
            for toks, score in nbest:
                fout.write(struct.pack("<I", len(toks)))
                fout.write(np.asarray(toks, "<i4").tobytes())
                fout.write(struct.pack("<f", score))
        elif tag == b"R":
            (n,) = struct.unpack("<I", read_exact(fin, 4))
            (rw,) = struct.unpack("<f", read_exact(fin, 4))
            hyps = []
            for _ in range(n):
                (length,) = struct.unpack("<I", read_exact(fin, 4))
                hyps.append(np.frombuffer(read_exact(fin, 4 * length),
                                          "<i4").tolist())
            scores = worker.rescore(hyps, rw)
            fout.write(b"S" + struct.pack("<I", len(scores)))
            fout.write(scores.astype("<f4").tobytes())
        else:
            raise RuntimeError(f"unknown tag {tag!r}")
        fout.flush()


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="serving worker")
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--chunk_size", type=int, default=16)
    parser.add_argument("--num_left_chunks", type=int, default=-1)
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu for the plain "
                             "versions on the host")
    return parser


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    # Protocol bytes go to the original stdout; anything else written to
    # file descriptor 1 from here on (prints, native libraries) lands on
    # stderr.
    proto = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    worker = Worker(args)
    serve(worker, sys.stdin.buffer, proto)


if __name__ == "__main__":
    main()
