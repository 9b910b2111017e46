"""Simulated streaming encode: the chunk-by-chunk forward (port of
``wenet_celoss_tpu/decode/streaming.py``).

The chunk arithmetic of the reference's ``forward_chunk_by_chunk`` and its
C++ runtime:

  stride = subsampling_rate * chunk_size
  window = (chunk_size - 1) * subsampling_rate + right_context + 1

A chunk step runs while ``cur + window <= T``: frames after the last whole
window are dropped, as in the JAX package. Its ``lax.scan`` variant
computes the same thing; here one Python loop serves both (each step
queues its launches without a host sync).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def chunk_geometry(subsampling_rate: int, right_context: int,
                   decoding_chunk_size: int) -> Tuple[int, int]:
    """(stride, window) in input frames."""
    stride = subsampling_rate * decoding_chunk_size
    window = (decoding_chunk_size - 1) * subsampling_rate \
        + right_context + 1
    return stride, window


def num_chunks(num_frames: int, subsampling_rate: int, right_context: int,
               decoding_chunk_size: int) -> int:
    """Chunk steps over ``num_frames`` input frames (0 if too short)."""
    stride, window = chunk_geometry(subsampling_rate, right_context,
                                    decoding_chunk_size)
    return max((num_frames - window) // stride + 1, 0)


def _cat(outputs):
    """Concatenate per-chunk outputs along time, leaf-wise for tuples."""
    if isinstance(outputs[0], torch.Tensor):
        return torch.cat(outputs, dim=1)
    return type(outputs[0])(_cat(list(leaves)) for leaves in zip(*outputs))


def forward_chunk_by_chunk(forward_chunk_fn: Callable, init_cache,
                           feats: torch.Tensor, subsampling_rate: int,
                           right_context: int, decoding_chunk_size: int,
                           out_lens: Optional[torch.Tensor] = None):
    """Encode feats [B, T, F] chunk by chunk.

    ``forward_chunk_fn(xs [B, window, F], cache[, chunk_valid])`` returns
    (ys, cache), ys a tensor [B, chunk, ...] or a tuple of them (e.g.
    encoder output and CTC log-probs). ``out_lens`` [B]: each utterance's
    total subsampled frames; when given, every call gets ``chunk_valid``
    [B], that chunk's valid output frames. → (ys concatenated along time,
    the final cache). Raises when T is shorter than one window."""
    n = num_chunks(feats.shape[1], subsampling_rate, right_context,
                   decoding_chunk_size)
    if n == 0:
        raise ValueError(
            f"utterance too short for one chunk: {feats.shape[1]} frames")
    stride, window = chunk_geometry(subsampling_rate, right_context,
                                    decoding_chunk_size)
    cache, outputs = init_cache, []
    for k in range(n):
        chunk = feats[:, k * stride:k * stride + window]
        if out_lens is None:
            ys, cache = forward_chunk_fn(chunk, cache)
        else:
            valid = torch.clamp(out_lens - k * decoding_chunk_size, 0,
                                decoding_chunk_size)
            ys, cache = forward_chunk_fn(chunk, cache, valid)
        outputs.append(ys)
    return _cat(outputs), cache
