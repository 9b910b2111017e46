"""Weight-only int8 post-training quantization for export bundles (port of
``wenet_celoss_tpu/utils/quantize.py``).

Symmetric int8 with one fp32 scale per output channel: every floating
tensor of two or more axes is stored as ``{"__q8__": q int8, "scale":
fp32 [C]}`` and dequantized to fp32 at load; 1-D tensors (biases, norms)
and buffers of one axis stay fp32. The JAX package takes the scale over
every axis of the flax leaf but the last. The port's tensors are laid out
otherwise (``Linear`` [out, in], convolutions [out, in, ...], the LSTM's
gates stacked; embeddings and the rel-pos biases as in JAX), so each
tensor's channel axis is the one that the JAX leaf's last axis maps onto
under ``utils/convert.py`` (``jax_channel_axis``), and the scales, codes
and reconstructions are the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from wenet_celoss_tpu_torch.utils.checkpoint import msgpack_restore
from wenet_celoss_tpu_torch.utils.convert import (jax_channel_axis,
                                                  params_from_jax)

Q_KEY = "__q8__"


def _is_quantizable(t: torch.Tensor) -> bool:
    return t.dim() >= 2 and t.is_floating_point()


def _quantize(w: np.ndarray) -> Dict[str, np.ndarray]:
    """The JAX package's rule on a leaf whose last axis is the channel."""
    scale = np.max(np.abs(w), axis=tuple(range(w.ndim - 1))) / 127.0
    scale = np.maximum(scale, 1e-12).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return {Q_KEY: q, "scale": scale}


def _dequantize(entry: Dict[str, Any]) -> np.ndarray:
    return (np.asarray(entry[Q_KEY]).astype(np.float32)
            * np.asarray(entry["scale"], np.float32))


def quantize_params(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A port ``state_dict`` → the same keys with every tensor of two or
    more floating axes as ``{"__q8__": int8, "scale": fp32}``."""
    out: Dict[str, Any] = {}
    for key, t in sd.items():
        if not _is_quantizable(t):
            out[key] = t
            continue
        axis = jax_channel_axis(key, t.dim())
        w = np.moveaxis(t.detach().float().cpu().numpy(), axis, -1)
        entry = _quantize(w)
        out[key] = {Q_KEY: torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(entry[Q_KEY], -1, axis))),
            "scale": torch.from_numpy(entry["scale"])}
    return out


def dequantize_params(qsd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_params` (fp32 reconstruction)."""
    out = {}
    for key, v in qsd.items():
        if isinstance(v, dict) and Q_KEY in v:
            axis = jax_channel_axis(key, v[Q_KEY].dim())
            q = np.moveaxis(v[Q_KEY].numpy(), axis, -1)
            w = _dequantize({Q_KEY: q, "scale": v["scale"].numpy()})
            out[key] = torch.from_numpy(
                np.ascontiguousarray(np.moveaxis(w, -1, axis)))
        else:
            out[key] = v
    return out


def save_quantized(sd: Dict[str, torch.Tensor], path: str) -> None:
    """``torch.save`` of :func:`quantize_params` of ``sd`` (a ``.pt``)."""
    torch.save({k: v if isinstance(v, dict) else v.detach().cpu()
                for k, v in quantize_params(sd).items()}, path)


def _dequantize_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        if Q_KEY in tree:
            return _dequantize(tree)
        return {k: _dequantize_tree(v) for k, v in tree.items()}
    return tree


def load_quantized(path: str) -> Dict[str, torch.Tensor]:
    """An int8 bundle → an fp32 ``state_dict``: the port's ``.pt``, or the
    JAX package's flax msgpack (``params_int8.mspk``) through the weight
    bridge."""
    if str(path).endswith(".pt"):
        return dequantize_params(torch.load(path, map_location="cpu",
                                            weights_only=True))
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    return params_from_jax({"params": _dequantize_tree(tree)})
