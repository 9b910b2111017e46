"""Waveform distortion augmentations, vectorized (a copy of
``wenet_celoss_tpu/data/wav_distortion.py``; numpy only).

Parity with reference ``wenet/dataset/wav_distortion.py:24-324`` (db-domain
polynomial/quad distortion, max distortion, fence distortion via amplitude
masks, jag distortion, amplitude masking) — re-designed as vectorized numpy
transforms over the whole waveform instead of the reference's per-sample
python closures. Waveforms here are float in [-1, 1] (the reference's
convention for this module); callers scale int16-range audio by 1/32768.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

import numpy as np


def db2amp(db):
    return np.power(10.0, np.asarray(db, np.float64) / 20.0)


def amp2db(amp):
    return 20.0 * np.log10(np.maximum(np.asarray(amp, np.float64), 1e-12))


def distort_poly(x: np.ndarray, a: int = 1, m: int = 1, n: int = 1
                 ) -> np.ndarray:
    """f(db_norm) = a * t^m * (1-t)^n + t in normalized-db domain."""
    abs_x = np.abs(x)
    small = abs_x < 1e-6
    db_norm = np.clip(amp2db(abs_x) / 100.0 + 1.0, 0.0, None)
    db_norm = a * np.power(db_norm, m) * np.power(1.0 - db_norm, n) + db_norm
    db_norm = np.minimum(db_norm, 1.0)
    amp = np.minimum(db2amp((db_norm - 1.0) * 100.0), 0.9997)
    out = np.where(x > 0, amp, -amp)
    return np.where(small, x, out).astype(np.float32)


def distort_quad(x: np.ndarray) -> np.ndarray:
    return distort_poly(x, 1, 1, 1)


def distort_max(x: np.ndarray, max_db: Optional[float] = None) -> np.ndarray:
    max_amp = float(db2amp(max_db)) if max_db else 0.997
    return np.where(x > 0, max_amp,
                    np.where(x < 0, -max_amp, 0.0)).astype(np.float32)


def make_amp_mask(db_mask: Optional[List[Tuple[float, float]]] = None):
    if db_mask is None:
        db_mask = [(-110, -95), (-90, -80), (-65, -60), (-50, -30),
                   (-15, 0)]
    return [(float(db2amp(lo)), float(db2amp(hi))) for lo, hi in db_mask]


def generate_amp_mask(mask_num: int, rng: Optional[random.Random] = None):
    rng = rng or random
    a = [0.0] * (2 * mask_num)
    for i in range(1, 2 * mask_num):
        a[i] = a[i - 1] + rng.uniform(0.5, 1)
    max_val = a[-1]
    db = [(((a[2 * i] - max_val) / max_val) * 100,
           ((a[2 * i + 1] - max_val) / max_val) * 100)
          for i in range(mask_num)]
    return make_amp_mask(db)


def _in_mask(abs_x: np.ndarray, mask: List[Tuple[float, float]]):
    hit = np.zeros(abs_x.shape, bool)
    for lo, hi in mask:
        hit |= (abs_x >= lo) & (abs_x <= hi)
    return hit


def distort_fence(x: np.ndarray, mask_number: int = 4,
                  max_db: float = -6.0,
                  rng: Optional[random.Random] = None) -> np.ndarray:
    """In-mask amplitudes snap to max, others to 0 (reference :143-178)."""
    max_amp = float(db2amp(max_db))
    mask = generate_amp_mask(mask_number, rng)
    hit = _in_mask(np.abs(x), mask)
    out = np.where(hit, np.sign(x) * max_amp, 0.0)
    return out.astype(np.float32)


def distort_jag(x: np.ndarray, mask_number: int = 5,
                rng: Optional[random.Random] = None) -> np.ndarray:
    """Keep in-mask amplitudes, zero the rest (reference jag distortion)."""
    mask = generate_amp_mask(mask_number, rng)
    hit = _in_mask(np.abs(x), mask)
    return np.where(hit, x, 0.0).astype(np.float32)


def distort_amp_mask(x: np.ndarray,
                     mask: Optional[List[Tuple[float, float]]] = None
                     ) -> np.ndarray:
    """Zero amplitudes inside the db mask slots."""
    mask = mask or make_amp_mask()
    hit = _in_mask(np.abs(x), mask)
    return np.where(hit, 0.0, x).astype(np.float32)


DISTORTIONS = {
    "poly_distortion": distort_poly,
    "quad_distortion": distort_quad,
    "max_distortion": distort_max,
    "fence_distortion": distort_fence,
    "jag_distortion": distort_jag,
    "amp_mask": distort_amp_mask,
}


def distort_wav(x: np.ndarray, distort_type: str, **kw) -> np.ndarray:
    if distort_type not in DISTORTIONS:
        raise ValueError(f"unknown distortion {distort_type!r}")
    return DISTORTIONS[distort_type](x, **kw)
