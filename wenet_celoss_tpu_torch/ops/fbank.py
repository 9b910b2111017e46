"""Kaldi-compatible log-mel filterbank and MFCC: on the host in numpy
(copy of the numpy half of ``wenet_celoss_tpu/ops/fbank.py``:
``FbankConfig``, ``num_frames``, ``_window``, ``mel_banks``, the dither
noise table, ``compute_fbank_np``, ``MfccConfig`` and
``compute_mfcc_np``), and batched in torch on the tensors' device (its
device half: ``frame_signal``, ``compute_fbank``, ``compute_mfcc``).

The DSP chain matches kaldi: snip_edges framing, dither, DC removal, 0.97
preemphasis, povey window, pow2 rFFT, power spectrum, triangular mel bins
with low=20Hz/high=nyquist, natural log with an eps floor; MFCC is the
DCT-II of the log-mel energies, liftered. The numpy path is the front end
for real requests and for training; the batched path is a library
function (a padded [B, S] batch with lengths → [B, T, M], frames past
each utterance's count zero) that no config key selects. torch is
imported inside the batched functions only, so a loader worker that runs
the numpy path does not pay for it.
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
    """Kaldi snip_edges frame count of ints, numpy arrays or torch
    tensors."""
    if cfg.snip_edges:
        n = (num_samples - cfg.frame_length) // cfg.frame_shift + 1
        if hasattr(n, "clamp"):   # a torch tensor, on its device
            return n.clamp(min=0)
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


_NOISE_TABLE_BITS = 22  # 4M floats, 16 MB, built once per process


@lru_cache(maxsize=1)
def _noise_table() -> np.ndarray:
    """Shared gaussian table for dither noise. Drawing N(0, 1) per sample
    costs more than the FFT; dither only decorrelates quantisation, so a
    fixed-seed 4M-entry table is sliced at an offset drawn from the
    caller's generator (deterministic per epoch and sample)."""
    return np.random.default_rng(0x5EED_D17E).standard_normal(
        1 << _NOISE_TABLE_BITS, dtype=np.float32)


def _dither_noise(shape, rng: np.random.Generator) -> np.ndarray:
    count = int(np.prod(shape))
    table = _noise_table()
    if count > table.size:  # an utterance past 4M frame samples
        return rng.standard_normal(shape, dtype=np.float32)
    off = int(rng.integers(0, table.size - count + 1))
    return table[off:off + count].reshape(shape)


def compute_fbank_np(wav: np.ndarray, cfg: FbankConfig = FbankConfig(),
                     rng: np.random.Generator | None = None) -> np.ndarray:
    """Host-side (numpy) kaldi fbank, [S] int16-range samples → [T, M].

    Framing is one sliding-window view + copy, the dither/dc/preemphasis/
    window chain runs in place on that copy, and the FFT is scipy's
    float32 rfft where scipy is present. Dither (``cfg.dither > 0``) is
    drawn from ``rng``; without one there is none."""
    wav = np.asarray(wav, np.float32)
    n = int(num_frames(len(wav), cfg))
    if n <= 0:
        return np.zeros((0, cfg.num_mel_bins), np.float32)
    shift, length = cfg.frame_shift, cfg.frame_length
    frames = np.ascontiguousarray(
        np.lib.stride_tricks.sliding_window_view(wav, length)[::shift][:n])
    if cfg.dither > 0.0 and rng is not None:
        frames += cfg.dither * _dither_noise(frames.shape, rng)
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


@dataclass(frozen=True)
class MfccConfig(FbankConfig):
    """Kaldi MFCC on the mel chain: the DCT-II of the log-mel energies,
    ``num_ceps`` coefficients (c0 the DCT coefficient, not log energy, as
    torchaudio's kaldi.mfcc by default), then cepstral liftering."""
    num_ceps: int = 13
    cepstral_lifter: float = 22.0


def _dct_matrix(num_ceps: int, num_bins: int) -> np.ndarray:
    """Kaldi-style (orthonormal) DCT-II matrix [num_ceps, num_bins]."""
    n = np.arange(num_bins)
    mat = np.zeros((num_ceps, num_bins), dtype=np.float64)
    mat[0] = math.sqrt(1.0 / num_bins)
    for k in range(1, num_ceps):
        mat[k] = math.sqrt(2.0 / num_bins) * np.cos(
            math.pi / num_bins * (n + 0.5) * k)
    return mat.astype(np.float32)


def _lifter(cfg: MfccConfig) -> np.ndarray:
    if cfg.cepstral_lifter == 0.0:
        return np.ones(cfg.num_ceps, np.float32)
    i = np.arange(cfg.num_ceps)
    return (1.0 + 0.5 * cfg.cepstral_lifter * np.sin(
        math.pi * i / cfg.cepstral_lifter)).astype(np.float32)


def compute_mfcc_np(wav: np.ndarray, cfg: MfccConfig = MfccConfig(),
                    rng: np.random.Generator | None = None) -> np.ndarray:
    """Host-side MFCC: log-mel (the fbank chain) → DCT → lifter.
    [S] → [T, num_ceps]."""
    logmel = compute_fbank_np(wav, cfg, rng)
    ceps = logmel @ _dct_matrix(cfg.num_ceps, cfg.num_mel_bins).T
    return (ceps * _lifter(cfg)).astype(np.float32)


def frame_signal(wav, max_frames: int, cfg: FbankConfig):
    """[..., S] → [..., max_frames, frame_length]: frame t is samples
    [t·shift, t·shift + length); samples past S repeat the last one (the
    JAX path's edge padding)."""
    import torch
    need = (max_frames - 1) * cfg.frame_shift + cfg.frame_length
    s = wav.shape[-1]
    if need > s:
        wav = torch.cat([wav, wav[..., -1:].expand(
            *wav.shape[:-1], need - s)], dim=-1)
    return wav[..., :need].unfold(-1, cfg.frame_length, cfg.frame_shift)


def _fbank_batch(wav, lengths, cfg: FbankConfig, max_frames: int,
                 generator):
    import torch
    dev = wav.device
    frames = frame_signal(wav.to(torch.float32), max_frames, cfg)
    if cfg.dither > 0.0 and generator is not None:
        frames = frames + cfg.dither * torch.randn(
            frames.shape, generator=generator, dtype=torch.float32,
            device=dev)
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if cfg.preemphasis > 0.0:
        shifted = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - cfg.preemphasis * shifted
    frames = frames * torch.as_tensor(_window(cfg), device=dev)
    spec = torch.fft.rfft(frames, n=cfg.fft_size, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    mel = power @ torch.as_tensor(mel_banks(cfg), device=dev).T
    feats = torch.log(torch.clamp_min(mel, np.finfo(np.float32).tiny))
    feat_lens = num_frames(lengths, cfg)
    valid = torch.arange(max_frames, device=dev)[None, :] < \
        feat_lens[..., None]
    return torch.where(valid[..., None], feats, 0.0), feat_lens


def compute_fbank(wav, lengths=None, cfg: FbankConfig = FbankConfig(),
                  generator=None):
    """Batched log-mel features on ``wav``'s device (plain torch,
    ``torch.fft.rfft``).

    Args:
      wav: [S] or [B, S] float tensor of int16-range samples (kaldi
        convention), zero-padded past each length.
      lengths: [B] valid sample counts (default: the full length).
      generator: a ``torch.Generator`` on ``wav``'s device; dither
        (``cfg.dither > 0``) is drawn from it, and there is none without.

    Returns (feats [B, T, M] or [T, M], frame counts [B] or a scalar);
    frames past an utterance's count are 0.
    """
    import torch
    squeeze = wav.dim() == 1
    if squeeze:
        wav = wav[None]
    if lengths is None:
        lengths = torch.full((wav.shape[0],), wav.shape[-1],
                             dtype=torch.long, device=wav.device)
    max_frames = max(int(num_frames(wav.shape[-1], cfg)), 1)
    feats, feat_lens = _fbank_batch(wav, torch.as_tensor(
        lengths, device=wav.device), cfg, max_frames, generator)
    if squeeze:
        return feats[0], feat_lens[0]
    return feats, feat_lens


def compute_mfcc(wav, lengths=None, cfg: MfccConfig = MfccConfig(),
                 generator=None):
    """Batched MFCC on ``wav``'s device: :func:`compute_fbank`'s log-mel
    energies → DCT → lifter, M = ``cfg.num_ceps``."""
    import torch
    feats, feat_lens = compute_fbank(wav, lengths, cfg, generator)
    dev = feats.device
    dct = torch.as_tensor(_dct_matrix(cfg.num_ceps, cfg.num_mel_bins),
                          device=dev)
    return (feats @ dct.T) * torch.as_tensor(_lifter(cfg), device=dev), \
        feat_lens
