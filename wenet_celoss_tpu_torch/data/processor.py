"""The data pipeline's stages: composable generators over sample dicts
(port of ``wenet_celoss_tpu/data/processor.py``, numpy end to end).

Stages: ``url_opener`` and ``tar_file_and_group`` (shards), ``parse_raw``
(jsonl lists), ``tokenize``, ``filter``, ``resample``, ``speed_perturb``,
``fbank_one`` on ``ops/fbank.py compute_fbank_np``, ``spec_aug``,
``spec_sub``, ``shuffle``, ``sort``, ``static_batch``, ``dynamic_batch``,
``padding`` (bucketed shapes; context modes 1-4 through
``data/context.py``), ``parallel_map`` and ``prefetch``; ``fbank_one``
with dither and ``mfcc_one`` on ``ops/fbank.py``'s host front end, the
dither drawn from the caller's numpy generator.

Sample dict keys: key, wav [S] float32 int16-range, sample_rate, txt,
tokens, label (list[int]), feat [T, M].
"""

from __future__ import annotations

import json
import logging
import random
import subprocess
import tarfile
from typing import Dict, Iterable, Iterator, List, Optional
from urllib.parse import urlparse

import numpy as np

from wenet_celoss_tpu_torch.data.context import (ContextMaintainer,
                                                 batch_context_list,
                                                 hw_label_generate)
from wenet_celoss_tpu_torch.data.tokenizer import Tokenizer
from wenet_celoss_tpu_torch.data.wav import read_audio
from wenet_celoss_tpu_torch.ops.fbank import (FbankConfig, MfccConfig,
                                              compute_fbank_np,
                                              compute_mfcc_np)

AUDIO_FORMAT = ("flac", "mp3", "m4a", "ogg", "opus", "wav", "wma")


def url_opener(data: Iterable[Dict]) -> Iterator[Dict]:
    """{src: path_or_url} → {src, stream} (reference :34-62)."""
    for sample in data:
        url = sample["src"]
        try:
            pr = urlparse(url)
            if pr.scheme in ("", "file"):
                stream = open(pr.path or url, "rb")
            else:
                # http/s3/... via external downloader, matching the
                # reference's popen-based UIO access.
                proc = subprocess.Popen(["curl", "-s", "-L", url],
                                        stdout=subprocess.PIPE)
                stream = proc.stdout
            sample.update(stream=stream)
            yield sample
        except Exception:
            logging.warning("failed to open %s", url)


def tar_file_and_group(data: Iterable[Dict]) -> Iterator[Dict]:
    """Tar shard stream → grouped samples (reference :65-112)."""
    for sample in data:
        stream = tarfile.open(fileobj=sample["stream"], mode="r:*")
        prev_prefix = None
        example: Dict = {}
        valid = True
        for tarinfo in stream:
            name = tarinfo.name
            pos = name.rfind(".")
            if pos <= 0:
                continue
            prefix, postfix = name[:pos], name[pos + 1:]
            if prev_prefix is not None and prefix != prev_prefix:
                example["key"] = prev_prefix
                if valid:
                    yield example
                example, valid = {}, True
            try:
                file_obj = stream.extractfile(tarinfo)
                data_bytes = file_obj.read()
                if postfix == "txt":
                    example["txt"] = data_bytes.decode("utf8").strip()
                elif postfix in AUDIO_FORMAT:
                    wav, sr = read_audio(data_bytes)
                    if wav.ndim > 1:
                        wav = wav.mean(axis=1)
                    example["wav"] = wav
                    example["sample_rate"] = sr
                else:
                    example[postfix] = data_bytes
            except Exception:
                valid = False
                logging.warning("error parsing %s", name)
            prev_prefix = prefix
        if prev_prefix is not None:
            example["key"] = prev_prefix
            if valid:
                yield example
        stream.close()
        if sample.get("stream") is not None:
            sample["stream"].close()


def parse_raw(data: Iterable[Dict]) -> Iterator[Dict]:
    """jsonl {key, wav, txt[, start, end, speed]} lines → loaded samples
    (reference :115-153; start/end come from kaldi segments files, speed
    from the perturb_speed data-dir tool)."""
    for sample in data:
        obj = json.loads(sample["src"])
        try:
            wav, sr = read_audio(obj["wav"])
            if wav.ndim > 1:
                wav = wav.mean(axis=1)
            if "start" in obj or "end" in obj:
                start = int(float(obj.get("start", 0)) * sr)
                end = int(float(obj["end"]) * sr) if "end" in obj \
                    else len(wav)
                wav = wav[max(start, 0):end]
            speed = float(obj.get("speed", 1.0))
            if speed != 1.0:
                wav = _linear_resample(wav, sr * speed, sr)
            yield dict(key=obj["key"], txt=obj["txt"], wav=wav,
                       sample_rate=sr)
        except Exception:
            logging.warning("failed to read %s", obj.get("wav"))


def tokenize(data: Iterable[Dict], tokenizer: Tokenizer) -> Iterator[Dict]:
    for sample in data:
        tokens, label = tokenizer(sample["txt"])
        sample["tokens"] = tokens
        sample["label"] = label
        yield sample


def filter(data: Iterable[Dict], max_length: int = 10240,
           min_length: int = 10, token_max_length: int = 200,
           token_min_length: int = 1, min_output_input_ratio: float = 5e-4,
           max_output_input_ratio: float = 1.0) -> Iterator[Dict]:
    """Length/ratio filtering on frames-at-10ms (reference :156-202)."""
    for sample in data:
        num_frames = len(sample["wav"]) / sample["sample_rate"] * 100
        if not (min_length < num_frames < max_length):
            continue
        if "label" in sample:
            if not (token_min_length <= len(sample["label"])
                    <= token_max_length):
                continue
            if num_frames != 0:
                ratio = len(sample["label"]) / num_frames
                if not (min_output_input_ratio < ratio
                        < max_output_input_ratio):
                    continue
        yield sample


def _linear_resample(wav: np.ndarray, src_rate: float,
                     dst_rate: float) -> np.ndarray:
    if src_rate == dst_rate:
        return wav
    n_out = int(round(len(wav) * dst_rate / src_rate))
    # Uniform-grid lerp done directly (floor + gather + blend) instead of
    # np.interp, whose per-point searchsorted costs ~4 ms on a 12 s wav.
    pos = np.arange(n_out, dtype=np.float64) * (src_rate / dst_rate)
    i = pos.astype(np.int64)
    np.minimum(i, len(wav) - 1, out=i)
    j = np.minimum(i + 1, len(wav) - 1)
    frac = (pos - i).astype(np.float32)
    wav = np.asarray(wav, np.float32)
    return wav[i] + frac * (wav[j] - wav[i])


def resample(data: Iterable[Dict], resample_rate: int = 16000
             ) -> Iterator[Dict]:
    for sample in data:
        if sample["sample_rate"] != resample_rate:
            sample["wav"] = _linear_resample(
                sample["wav"], sample["sample_rate"], resample_rate)
            sample["sample_rate"] = resample_rate
        yield sample


def speed_perturb_one(sample: Dict, speed: float) -> Dict:
    """Apply one speed factor (reference :228-253); playback-rate
    resample = tempo+pitch shift, same as sox 'speed'."""
    if speed != 1.0:
        sr = sample["sample_rate"]
        sample["wav"] = _linear_resample(sample["wav"], sr * speed, sr)
    return sample


def speed_perturb(data: Iterable[Dict], speeds: Optional[List[float]] = None,
                  rng: Optional[random.Random] = None) -> Iterator[Dict]:
    """Random 0.9/1.0/1.1 speed change (reference :228-253)."""
    speeds = speeds or [0.9, 1.0, 1.1]
    rng = rng or random
    for sample in data:
        yield speed_perturb_one(sample, rng.choice(speeds))


def compute_fbank(data: Iterable[Dict], num_mel_bins: int = 23,
                  frame_length: int = 25, frame_shift: int = 10,
                  dither: float = 0.0,
                  np_rng: Optional[np.random.Generator] = None
                  ) -> Iterator[Dict]:
    for sample in data:
        yield fbank_one(sample, num_mel_bins, frame_length, frame_shift,
                        dither, np_rng)


def spec_aug(data: Iterable[Dict], num_t_mask: int = 2, num_f_mask: int = 2,
             max_t: int = 50, max_f: int = 10, max_w: int = 80,
             warp_for_time: bool = False,
             rng: Optional[random.Random] = None) -> Iterator[Dict]:
    """SpecAugment time/freq masking in place (reference :411-446).

    ``warp_for_time`` additionally applies SpecAugment's time warp: a
    random anchor in [max_w, T-max_w) is displaced by up to ±max_w and the
    two segments are linearly resampled (the reference yaml exposes the
    flag but its processor ignores it; here it is functional)."""
    rng = rng or random
    for sample in data:
        y = sample["feat"].copy()
        t_max, f_max = y.shape
        if warp_for_time and t_max > 2 * max_w:
            center = rng.randint(max_w, t_max - max_w - 1)
            warped = center + rng.randint(-max_w + 1, max_w - 1)
            src_pos = np.concatenate([
                np.linspace(0, center, warped, endpoint=False),
                np.linspace(center, t_max - 1, t_max - warped)])
            lo = np.floor(src_pos).astype(np.int64)
            hi = np.minimum(lo + 1, t_max - 1)
            frac = (src_pos - lo)[:, None].astype(y.dtype)
            y = y[lo] * (1.0 - frac) + y[hi] * frac
        for _ in range(num_t_mask):
            start = rng.randint(0, max(t_max - 1, 0))
            length = rng.randint(1, max_t)
            y[start:start + length, :] = 0.0
        for _ in range(num_f_mask):
            start = rng.randint(0, max(f_max - 1, 0))
            length = rng.randint(1, max_f)
            y[:, start:start + length] = 0.0
        sample["feat"] = y
        yield sample


def spec_sub(data: Iterable[Dict], max_t: int = 20, num_t_sub: int = 3,
             rng: Optional[random.Random] = None) -> Iterator[Dict]:
    """Time-substitution augmentation (reference :449-475)."""
    rng = rng or random
    for sample in data:
        y = sample["feat"].copy()
        t_len = y.shape[0]
        for _ in range(num_t_sub):
            start = rng.randint(0, max(t_len - 1, 0))
            length = rng.randint(1, max_t)
            end = min(t_len, start + length)
            pos = rng.randint(0, start) if start > 0 else 0
            y[start:end, :] = sample["feat"][pos:pos + (end - start), :]
        sample["feat"] = y
        yield sample


def shuffle(data: Iterable[Dict], shuffle_size: int = 10000,
            rng: Optional[random.Random] = None) -> Iterator[Dict]:
    rng = rng or random
    buf: List[Dict] = []
    for sample in data:
        buf.append(sample)
        if len(buf) >= shuffle_size:
            rng.shuffle(buf)
            yield from buf
            buf = []
    rng.shuffle(buf)
    yield from buf


def sort(data: Iterable[Dict], sort_size: int = 500) -> Iterator[Dict]:
    buf: List[Dict] = []
    for sample in data:
        buf.append(sample)
        if len(buf) >= sort_size:
            buf.sort(key=lambda x: x["feat"].shape[0])
            yield from buf
            buf = []
    buf.sort(key=lambda x: x["feat"].shape[0])
    yield from buf


def static_batch(data: Iterable[Dict], batch_size: int = 16
                 ) -> Iterator[List[Dict]]:
    buf: List[Dict] = []
    for sample in data:
        buf.append(sample)
        if len(buf) >= batch_size:
            yield buf
            buf = []
    if buf:
        yield buf


def dynamic_batch(data: Iterable[Dict], max_frames_in_batch: int = 12000,
                  round_to: int = 1) -> Iterator[List[Dict]]:
    """Frame-budget batching (reference :550-577).

    round_to: emit batch sizes that are multiples of this (the data-mesh
    size), carrying the remainder into the next batch — keeps the SPMD
    batch axis evenly shardable without loss-diluting pad rows.
    """
    buf: List[Dict] = []
    longest = 0
    for sample in data:
        frames = sample["feat"].shape[0]
        new_longest = max(longest, frames)
        if new_longest * (len(buf) + 1) > max_frames_in_batch and buf:
            emit_n = max((len(buf) // round_to) * round_to, 0)
            if emit_n:
                yield buf[:emit_n]
                buf = buf[emit_n:] + [sample]
            else:
                # batch smaller than round_to: keep accumulating.
                buf.append(sample)
            longest = max((s["feat"].shape[0] for s in buf), default=0)
        else:
            buf.append(sample)
            longest = new_longest
    while len(buf) >= round_to:
        emit_n = max((len(buf) // round_to) * round_to, round_to)
        yield buf[:emit_n]
        buf = buf[emit_n:]
    if buf and round_to == 1:
        yield buf


# ----------------------------------------------------------------------
# Padding to bucketed batch arrays
# ----------------------------------------------------------------------

def _bucket(n: int, buckets: Optional[List[int]], round_to: int = 1) -> int:
    """Bucketed padded length: explicit ladder if given, else round UP to
    a multiple of ``round_to``. XLA compiles one program per shape, so
    un-bucketed padding retraces the jitted train/decode step for every
    distinct (T, U) a corpus produces — multi-minute compiles each on a
    cold cache. Rounding caps the shape count while wasting <round_to
    frames of padding (masked out of every loss/search)."""
    if buckets:
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]
    return -(-n // round_to) * round_to


def padding(data: Iterable[List[Dict]], *,
            feat_buckets: Optional[List[int]] = None,
            label_buckets: Optional[List[int]] = None,
            context_mode: int = 0,
            context_conf: Optional[Dict] = None,
            num_labels: int = 2,
            ignore_id: int = -1) -> Iterator[Dict]:
    """Batch list → padded numpy arrays (reference padding:690-728 + the
    fork's 10-tuple extension). Emits a dict batch:
      keys, feats [B, T, M], feat_lengths, labels [B, U] (ignore_id pad),
      label_lengths (+ context_list, context_lengths, hw_labels when
      context_mode > 0).
    """
    context_conf = context_conf or {}
    maintainer = ContextMaintainer(context_conf.get("list_size", 30)) \
        if context_mode == 1 else None
    for batch in data:
        batch = sorted(batch, key=lambda x: x["feat"].shape[0],
                       reverse=True)
        keys = [x["key"] for x in batch]
        feats = [x["feat"] for x in batch]
        labels = [list(x["label"]) for x in batch]
        feat_lens = np.array([f.shape[0] for f in feats], np.int32)
        label_lens = np.array([len(l) for l in labels], np.int32)
        t_max = _bucket(int(feat_lens.max()), feat_buckets, round_to=64)
        u_max = max(_bucket(int(label_lens.max()), label_buckets,
                            round_to=8), 1)
        b = len(batch)
        m = feats[0].shape[1]
        feats_pad = np.zeros((b, t_max, m), np.float32)
        labels_pad = np.full((b, u_max), ignore_id, np.int32)
        for i, (f, l) in enumerate(zip(feats, labels)):
            feats_pad[i, :f.shape[0]] = f
            labels_pad[i, :len(l)] = l
        out = dict(keys=keys, feats=feats_pad, feat_lengths=feat_lens,
                   labels=labels_pad, label_lengths=label_lens)
        if context_mode > 0:
            ctx = batch_context_list(
                labels, context_mode,
                bpe_start_ids=context_conf.get("bpe_start_ids"),
                file_list=context_conf.get("file_list"),
                dict_entry=(context_conf.get("dict", {}).get(keys[0])
                            if context_mode == 4 else None),
                context_len_min=context_conf.get("context_len_min", 1),
                context_len_max=context_conf.get("context_len_max", 4),
                maintainer=maintainer)
            hw = hw_label_generate(labels, ctx, num_labels)
            dec = [[t if h else 0 for t, h in zip(y, hy)]
                   for y, hy in zip(labels, hw)]
            n_max = context_conf.get("max_phrases", 0) or len(ctx)
            ctx = ctx[:n_max]
            l_max = max(max(len(p) for p in ctx), 1)
            l_bucket = context_conf.get("phrase_len", 0) or l_max
            ctx_pad = np.full((n_max, l_bucket), ignore_id, np.int32)
            ctx_lens = np.zeros((n_max,), np.int32)
            for i, p in enumerate(ctx):
                p = p[:l_bucket]
                ctx_pad[i, :len(p)] = p
                ctx_lens[i] = len(p)
            hw_pad = np.full((b, u_max), ignore_id, np.int32)
            dec_pad = np.full((b, u_max), ignore_id, np.int32)
            for i, (h, d) in enumerate(zip(hw, dec)):
                hw_pad[i, :len(h)] = h
                dec_pad[i, :len(d)] = d
            out.update(context_list=ctx_pad, context_lengths=ctx_lens,
                       context_n_valid=np.int32(len(ctx)),
                       hw_labels=hw_pad, context_decoder_labels=dec_pad)
        yield out


def parallel_map(data: Iterable[Dict], fn, num_workers: int = 4,
                 lookahead: int = 16, chunk: int = 8) -> Iterator[Dict]:
    """Order-preserving thread-pool map over a 1:1 pipeline stage.

    The expensive numeric stages (fbank: FFT + mel matmul) release the
    GIL in numpy, so an in-process thread pool speeds them up without
    pickling. Samples go to the pool in chunks: each is a few ms of
    mostly GIL-free numpy, and per-sample futures spent more time in
    scheduling than in work.
    """
    from concurrent.futures import ThreadPoolExecutor
    from collections import deque
    from itertools import islice

    def run_chunk(items):
        return [fn(it) for it in items]

    it = iter(data)
    with ThreadPoolExecutor(num_workers) as ex:
        pending: deque = deque()
        while True:
            items = list(islice(it, chunk))
            if not items:
                break
            pending.append(ex.submit(run_chunk, items))
            if len(pending) >= max(2, lookahead // chunk):
                yield from pending.popleft().result()
        while pending:
            yield from pending.popleft().result()


def fbank_one(sample: Dict, num_mel_bins: int = 23, frame_length: int = 25,
              frame_shift: int = 10, dither: float = 0.0,
              np_rng: Optional[np.random.Generator] = None) -> Dict:
    """Single-sample fbank (the body of compute_fbank, exposed for
    parallel_map); ``np_rng`` draws the dither."""
    cfg = FbankConfig(sample_rate=sample["sample_rate"],
                      num_mel_bins=num_mel_bins,
                      frame_length_ms=frame_length,
                      frame_shift_ms=frame_shift, dither=dither)
    sample["feat"] = compute_fbank_np(
        sample["wav"], cfg, np_rng if dither > 0 else None)
    return sample


def mfcc_one(sample: Dict, num_mel_bins: int = 23, frame_length: int = 25,
             frame_shift: int = 10, dither: float = 0.0, num_ceps: int = 40,
             high_freq: float = 0.0, low_freq: float = 20.0,
             np_rng: Optional[np.random.Generator] = None) -> Dict:
    """Single-sample kaldi MFCC."""
    cfg = MfccConfig(sample_rate=sample["sample_rate"],
                     num_mel_bins=num_mel_bins,
                     frame_length_ms=frame_length,
                     frame_shift_ms=frame_shift, dither=dither,
                     num_ceps=num_ceps, high_freq=high_freq,
                     low_freq=low_freq)
    sample["feat"] = compute_mfcc_np(
        sample["wav"], cfg, np_rng if dither > 0 else None)
    return sample


def compute_mfcc(data: Iterable[Dict],
                 np_rng: Optional[np.random.Generator] = None,
                 **kwargs) -> Iterator[Dict]:
    for sample in data:
        yield mfcc_one(sample, np_rng=np_rng, **kwargs)


def prefetch(data: Iterable, buffer_size: int = 2) -> Iterator:
    """Background-thread prefetch with a bounded queue: overlaps host-side
    pipeline work (IO, fbank, padding) with device compute. Exceptions in
    the producer re-raise in the consumer."""
    import queue as _queue
    import threading

    q: "_queue.Queue" = _queue.Queue(maxsize=max(buffer_size, 1))
    END = object()

    def producer():
        try:
            for item in data:
                q.put((True, item))
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            q.put((False, e))
            return
        q.put((True, END))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        ok, item = q.get()
        if not ok:
            raise item
        if item is END:
            return
        yield item
