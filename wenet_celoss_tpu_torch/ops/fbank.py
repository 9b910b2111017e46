"""Kaldi-compatible log-mel filterbank on the host, in numpy (copy of the
numpy half of ``wenet_celoss_tpu/ops/fbank.py``: ``FbankConfig``,
``num_frames``, ``_window``, ``mel_banks`` and ``compute_fbank_np``).

The DSP chain matches kaldi: snip_edges framing, dither, DC removal, 0.97
preemphasis, povey window, pow2 rFFT, power spectrum, triangular mel bins
with low=20Hz/high=nyquist, natural log with an eps floor. It is the front
end for real requests; the on-device fbank comes with a later slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np


@dataclass(frozen=True)
class FbankConfig:
    sample_rate: int = 16000
    num_mel_bins: int = 80
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    dither: float = 0.0
    preemphasis: float = 0.97
    remove_dc_offset: bool = True
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0: offset from nyquist
    window_type: str = "povey"
    snip_edges: bool = True
    energy_floor: float = 0.0

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000)

    @property
    def fft_size(self) -> int:
        n = 1
        while n < self.frame_length:
            n *= 2
        return n


def num_frames(num_samples, cfg: FbankConfig):
    """Kaldi snip_edges frame count of ints or numpy arrays."""
    if cfg.snip_edges:
        n = (num_samples - cfg.frame_length) // cfg.frame_shift + 1
        return np.maximum(n, 0)
    return (num_samples + cfg.frame_shift // 2) // cfg.frame_shift


@lru_cache(maxsize=16)
def _window(cfg: FbankConfig) -> np.ndarray:
    n = cfg.frame_length
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n)
    if cfg.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif cfg.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif cfg.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif cfg.window_type == "rectangular":
        w = np.ones(n)
    else:
        raise ValueError(f"unknown window {cfg.window_type!r}")
    return w.astype(np.float32)


@lru_cache(maxsize=16)
def mel_banks(cfg: FbankConfig) -> np.ndarray:
    """[num_bins, fft/2+1] triangular mel weights, kaldi-style
    (reference `runtime/core/frontend/fbank.h:52-90`)."""
    nfft = cfg.fft_size
    nyquist = 0.5 * cfg.sample_rate
    high = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq

    def mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)

    mel_low, mel_high = mel(cfg.low_freq), mel(high)
    delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)
    bins = np.zeros((cfg.num_mel_bins, nfft // 2 + 1), dtype=np.float32)
    fft_freqs = np.arange(nfft // 2 + 1) * (cfg.sample_rate / nfft)
    mel_freqs = mel(fft_freqs)
    for m in range(cfg.num_mel_bins):
        left = mel_low + m * delta
        center = mel_low + (m + 1) * delta
        right = mel_low + (m + 2) * delta
        up = (mel_freqs - left) / (center - left)
        down = (right - mel_freqs) / (right - center)
        bins[m] = np.maximum(0.0, np.minimum(up, down))
    return bins


# scipy's pocketfft computes rfft natively in float32 (3.5× the
# throughput of np.fft, which always promotes to float64); numpy remains
# the fallback on a host without scipy.
try:
    from scipy.fft import rfft as _rfft_f32
except ImportError:  # pragma: no cover - image always has scipy
    _rfft_f32 = None


def compute_fbank_np(wav: np.ndarray,
                     cfg: FbankConfig = FbankConfig()) -> np.ndarray:
    """Host-side (numpy) kaldi fbank, [S] int16-range samples → [T, M].

    Framing is one sliding-window view + copy, the dc/preemphasis/window
    chain runs in place on that copy, and the FFT is scipy's float32 rfft
    where scipy is present. Dither, a training-time augmentation, comes
    with the training data pipeline."""
    if cfg.dither > 0.0:
        raise NotImplementedError("fbank dither is not ported")
    wav = np.asarray(wav, np.float32)
    n = int(num_frames(len(wav), cfg))
    if n <= 0:
        return np.zeros((0, cfg.num_mel_bins), np.float32)
    shift, length = cfg.frame_shift, cfg.frame_length
    frames = np.ascontiguousarray(
        np.lib.stride_tricks.sliding_window_view(wav, length)[::shift][:n])
    if cfg.remove_dc_offset:
        frames -= frames.mean(axis=1, keepdims=True)
    if cfg.preemphasis > 0.0:
        # In place: columns 1.. use the ORIGINAL left neighbor (the RHS
        # temporary is materialized before the subtraction lands), then
        # column 0 scales itself (kaldi convention).
        frames[:, 1:] -= cfg.preemphasis * frames[:, :-1]
        frames[:, 0] *= 1.0 - cfg.preemphasis
    frames *= _window(cfg)
    if _rfft_f32 is not None:
        spec = _rfft_f32(frames, n=cfg.fft_size, axis=1)
    else:
        spec = np.fft.rfft(frames, n=cfg.fft_size, axis=1)
    power = np.square(spec.real) + np.square(spec.imag)
    mel = power @ mel_banks(cfg).T
    return np.log(np.maximum(mel, np.finfo(np.float32).tiny)).astype(
        np.float32)
