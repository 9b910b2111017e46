"""Global CMVN statistics: loading and application (numpy copy of
``wenet_celoss_tpu/models/cmvn.py`` plus the encoder's apply step)."""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np
import torch


def load_cmvn_json(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "r") as f:
        stats = json.load(f)
    means = np.array(stats["mean_stat"], dtype=np.float64)
    variance = np.array(stats["var_stat"], dtype=np.float64)
    count = stats["frame_num"]
    if count <= 0:
        raise ValueError(f"CMVN stats at {path} have zero frames")
    means = means / count
    variance = variance / count - means * means
    variance = np.maximum(variance, 1.0e-20)
    istd = 1.0 / np.sqrt(variance)
    return means.astype(np.float32), istd.astype(np.float32)


def load_cmvn_kaldi(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Kaldi text cmvn ark: two rows [sum..., count] and [sumsq..., 0]."""
    with open(path, "r") as f:
        text = f.read()
    body = text[text.index("[") + 1: text.index("]")].strip().split("\n")
    row1 = [float(x) for x in body[0].split()]
    row2 = [float(x) for x in body[1].split()]
    count = row1[-1]
    means = np.array(row1[:-1]) / count
    variance = np.array(row2[:-1]) / count - means * means
    variance = np.maximum(variance, 1.0e-20)
    istd = 1.0 / np.sqrt(variance)
    return means.astype(np.float32), istd.astype(np.float32)


def load_cmvn(path: str,
              is_json: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    return load_cmvn_json(path) if is_json else load_cmvn_kaldi(path)


def apply_cmvn(xs: torch.Tensor, mean: torch.Tensor,
               istd: torch.Tensor) -> torch.Tensor:
    """(xs - mean) * istd over the feature axis."""
    return (xs - mean) * istd
