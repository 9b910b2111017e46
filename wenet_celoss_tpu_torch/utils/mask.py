"""Padding and chunk masks (port of ``wenet_celoss_tpu/utils/mask.py``).

Convention: masks are boolean, True = attend / valid. The chunk masks
serve U2/U2++ streaming: a fixed chunk at decode time, a static chunk, or
a chunk drawn anew for every training step (``use_dynamic_chunk``). The
draw comes from the caller's explicit ``torch.Generator`` (a CPU
generator, so the same seed draws the same chunk on the CPU and on the
card) and is kept apart from its mapping (:func:`dynamic_chunk`), which
follows the JAX package's rule.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, T] True at PADDED positions."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            >= lengths[:, None])


def make_non_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, T] True at VALID positions."""
    return ~make_pad_mask(lengths, max_len)


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """[size, size] lower-triangular causal mask."""
    i = torch.arange(size, device=device)
    return i[None, :] <= i[:, None]


def subsequent_chunk_mask(size: int, chunk_size, num_left_chunks,
                          device=None) -> torch.Tensor:
    """[size, size] chunk-causal mask: position i attends to j iff j lies
    in i's chunk or in one of the ``num_left_chunks`` chunks before it
    (< 0: every earlier chunk). ``chunk_size`` and ``num_left_chunks``
    are ints or 0-d tensors (read as ints: no scalar goes to the card)."""
    cs, nl = int(chunk_size), int(num_left_chunks)
    idx = torch.arange(size, device=device)
    chunk_of = idx // max(cs, 1)
    mask = idx[None, :] < (chunk_of[:, None] + 1) * cs
    if nl >= 0:
        mask &= idx[None, :] >= torch.clamp(chunk_of[:, None] - nl,
                                            min=0) * cs
    return mask


def dynamic_chunk(draw: int, t: int, use_dynamic_left_chunk: bool,
                  left_u: float = 0.0) -> Tuple[int, int]:
    """(chunk, left chunks) of a training step from its draws.

    ``draw`` in 1..t: above t // 2 the chunk is the full context t, else
    ``draw % 25 + 1``. With ``use_dynamic_left_chunk`` the left chunks are
    ``floor(left_u * (max_left + 1))`` for ``left_u`` in [0, 1), where
    max_left = max(ceil(t / chunk) - 1, 1); else -1 (unlimited)."""
    chunk = t if draw > t // 2 else draw % 25 + 1
    if not use_dynamic_left_chunk:
        return chunk, -1
    max_left = max((t + chunk - 1) // chunk - 1, 1)
    return chunk, min(int(left_u * (max_left + 1)), max_left)


def draw_dynamic_chunk(t: int, use_dynamic_left_chunk: bool,
                       gen: torch.Generator) -> Tuple[int, int]:
    """Draw a training step's (chunk, left chunks) from ``gen``."""
    draw = int(torch.randint(1, t + 1, (), generator=gen))
    left_u = (float(torch.rand((), generator=gen))
              if use_dynamic_left_chunk else 0.0)
    return dynamic_chunk(draw, t, use_dynamic_left_chunk, left_u)


def add_optional_chunk_mask(pad_mask: torch.Tensor, *,
                            use_dynamic_chunk: bool,
                            use_dynamic_left_chunk: bool,
                            decoding_chunk_size: int,
                            static_chunk_size: int,
                            num_decoding_left_chunks: int,
                            gen: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """The encoder's self-attention mask [B, T, T] from ``pad_mask``
    [B, T] (True = valid).

    ``use_dynamic_chunk`` (the caller passes it only while training):
    ``decoding_chunk_size`` < 0 is the full context, > 0 a fixed chunk
    with ``num_decoding_left_chunks``, 0 a chunk drawn from ``gen``
    (required then). Else a ``static_chunk_size`` > 0 masks by that chunk
    (or by ``decoding_chunk_size`` and its left chunks when that is > 0),
    and 0 leaves the full context."""
    t = pad_mask.shape[1]
    dev = pad_mask.device
    if use_dynamic_chunk:
        if decoding_chunk_size < 0:
            chunk, left = t, -1
        elif decoding_chunk_size > 0:
            chunk, left = decoding_chunk_size, num_decoding_left_chunks
        else:
            if gen is None:
                raise ValueError("dynamic chunk training needs a generator")
            chunk, left = draw_dynamic_chunk(t, use_dynamic_left_chunk, gen)
        chunk_mask = subsequent_chunk_mask(t, chunk, left, dev)
    elif static_chunk_size > 0:
        fixed = decoding_chunk_size > 0
        chunk_mask = subsequent_chunk_mask(
            t, decoding_chunk_size if fixed else static_chunk_size,
            num_decoding_left_chunks if fixed else -1, dev)
    else:
        return pad_mask[:, None, :] & pad_mask[:, :, None]
    return pad_mask[:, None, :] & chunk_mask[None, :, :]
