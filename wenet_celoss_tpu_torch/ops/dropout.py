"""Counter-based dropout masks (port of
``wenet_celoss_tpu/models/fast_dropout.py`` and the mask of
``ops/ffn_pallas.py``).

A mask bit is a pure function of ``(seed, stream, index)``: the 32-bit
integer mix ``hash32`` of ``index XOR key(seed, stream)``, kept iff its
low 16 bits are below ``round(keep * 65536)`` (the JAX package's 1/2^16
quantisation, ``ffn_pallas._thresh``), and a kept value is scaled by
``1/keep``. The key mixes the 29-bit seed and the 3-bit stream, so no two
(seed, stream) pairs share a key. Nothing depends on tiling or device, so
the CUDA kernels (``csrc/ln_ffn_residual.cu``, ``csrc/lstm2_seq.cu`` and
``csrc/conv_block.cu``, which repeat ``hash32``), their backwards and the
plain versions here draw identical masks, and the CPU and the card agree
bit for bit. The TPU's own bits cannot be reproduced; tests compare
against these plain versions and against the keep rate.

``hash32`` multiplies by two constants below 2^31, so on an int64 tensor
every product of a 32-bit value is exact and ``& 0xFFFFFFFF`` takes its
low half, as a uint32 multiply in CUDA does.

Seeds come from the train step's explicit ``torch.Generator`` (a CPU
generator: drawing a seed never waits for the card).

A step split over several processes (``parallel/dist.py``) draws the
masks of the whole batch: each process holds part ``p`` of ``parts``
equal parts of it along the batch axis, and every site draws at the
indices its rows have in the whole batch's tensor. ``batch_part`` sets
the part for a step; ``dropout`` shifts a batch-major tensor's indices by
``p * numel``, and the kernels take the first global row (K4 also the
whole batch, its index being step-major).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch

M32 = 0xFFFFFFFF
_C1, _C2 = 0x21F0AAAD, 0x735A2D97
KEEP_ALL = 65536      # threshold meaning "no mask"
STREAM_PLAIN, STREAM_FFN_HIDDEN, STREAM_FFN_OUT = 0, 1, 2
# K4's inter-layer mask, drawn at index (t * B + b) * H + j (step t, batch
# row b, unit j), so that it does not depend on the kernel's batch blocks.
STREAM_LSTM_INTER = 3
# K8's output mask, drawn at index (b * T + t) * D + c (batch row b, frame
# t, channel c), so that it does not depend on the kernel's frame tiles.
STREAM_CONV_OUT = 4


def hash32(x):
    """32-bit integer mix (shifts 16/15/15 around two odd multiplies);
    works on Python ints and on int64 tensors holding values < 2^32."""
    x = x ^ (x >> 16)
    x = (x * _C1) & M32
    x = x ^ (x >> 15)
    x = (x * _C2) & M32
    return x ^ (x >> 15)


def stream_key(seed: int, stream: int) -> int:
    """The per-(seed, stream) key XORed into every index (seed < 2^29,
    stream < 8)."""
    return hash32(((int(seed) << 3) | stream) & M32)


def threshold(rate: float) -> Tuple[int, float]:
    """(keep threshold on 16 bits, scale) for a dropout rate; rate 0 gives
    (KEEP_ALL, 1.0). Raises outside [0, 1)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} must be in [0, 1)")
    if rate == 0.0:
        return KEEP_ALL, 1.0
    keep = 1.0 - rate
    return min(int(round(keep * 65536.0)), 65535), 1.0 / keep


def keep_mask(seed: int, stream: int, index: torch.Tensor,
              thresh: int) -> torch.Tensor:
    """Boolean keep mask for int64 element indices ``index``."""
    bits = hash32((index & M32) ^ stream_key(seed, stream))
    return (bits & 0xFFFF) < thresh


def apply_mask(x: torch.Tensor, seed: int, stream: int,
               rate: float, offset: int = 0) -> torch.Tensor:
    """``where(keep, x * (1/keep), 0)`` in ``x``'s dtype, the mask drawn at
    ``offset`` plus each element's flat index (``row * ncols + col`` for a
    [N, ncols] tensor)."""
    thresh, scale = threshold(rate)
    if thresh == KEEP_ALL:
        return x
    index = offset + torch.arange(x.numel(),
                                  device=x.device).reshape(x.shape)
    keep = keep_mask(seed, stream, index, thresh)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


_PART = (0, 1)   # (this process's part, parts) of the step's batch


@contextlib.contextmanager
def batch_part(part: int, parts: int) -> Iterator[None]:
    """Within the block, the batch every site sees is part ``part`` of
    ``parts`` equal parts of the step's batch (batch axis first)."""
    global _PART
    if not 0 <= part < parts:
        raise ValueError(f"part {part} of {parts}")
    old, _PART = _PART, (int(part), int(parts))
    try:
        yield
    finally:
        _PART = old


def current_part() -> Tuple[int, int]:
    """(part, parts) of the step's batch this process holds ((0, 1): the
    whole batch)."""
    return _PART


def row_base(rows: int) -> int:
    """The first global row of a batch-major tensor with ``rows`` local
    rows (``part * rows``)."""
    return _PART[0] * int(rows)


def draw_seed(generator: torch.Generator) -> int:
    """A 29-bit seed from the caller's (CPU) generator."""
    return int(torch.randint(0, 1 << 29, (), generator=generator))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Training dropout for every site outside the kernels; the identity
    when ``generator`` is None (deterministic) or ``rate`` is 0. ``x`` is
    batch-major: its mask is its rows' part of the whole batch's."""
    if generator is None or rate == 0.0:
        return x
    return apply_mask(x, draw_seed(generator), STREAM_PLAIN, rate,
                      offset=row_base(x.numel()))
