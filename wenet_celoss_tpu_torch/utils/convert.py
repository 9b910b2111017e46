"""Weight bridge: the JAX package's variables → this port's ``state_dict``.

``params_from_jax(tree)`` takes the flax ``variables`` as nested dicts of
numpy arrays (``params``, plus ``batch_stats`` for the batch_norm conv
module) and inverts the layout facts of
``tools/convert_reference_checkpoint.py``:

- Dense kernel [in, out] → Linear weight [out, in];
- Conv2d kernel [KH, KW, I, O] → [O, I, KH, KW];
- depthwise Conv kernel [K, 1, C] → [C, 1, K];
- LSTM per-gate kernels ii/if/ig/io and hi/hf/hg/ho (bias on the hidden
  side) → ``wi`` [4H, E] and ``wh`` [4H, H] + bias [4H], gate order i,f,g,o;
- LayerNorm / BatchNorm scale → weight, batch_stats mean/var →
  running_mean/running_var;
- the subsampling output linear needs no permutation: the port flattens
  its conv output in the same (f, c) order as the JAX package's NHWC
  layout.

Every leaf must match a rule below; anything else raises, except the
subtrees of modules that are not ported yet (``NOT_PORTED``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

NOT_PORTED = ("decoder", "ctc")

_I = r"(\d+)"
_RULES = [
    # (module path regex, torch prefix template, kind)
    (r"encoder/embed/(conv1|conv2)", r"encoder.embed.\1", "conv2d"),
    (r"encoder/embed/out", "encoder.embed.out", "dense"),
    (rf"encoder/layer_{_I}/(feed_forward|feed_forward_macaron)/Dense_0",
     r"encoder.layers.\1.\2.w_1", "dense"),
    (rf"encoder/layer_{_I}/(feed_forward|feed_forward_macaron)/Dense_1",
     r"encoder.layers.\1.\2.w_2", "dense"),
    (rf"encoder/layer_{_I}/self_attn/"
     r"(linear_q|linear_k|linear_v|linear_out|linear_pos)",
     r"encoder.layers.\1.self_attn.\2", "dense"),
    (rf"encoder/layer_{_I}/self_attn", r"encoder.layers.\1.self_attn",
     "pos_bias"),
    (rf"encoder/layer_{_I}/"
     r"(norm_ff_macaron|norm_mha|norm_conv|norm_ff|norm_final)",
     r"encoder.layers.\1.\2", "norm"),
    (rf"encoder/layer_{_I}/conv_module/(pointwise_conv1|pointwise_conv2)",
     r"encoder.layers.\1.conv_module.\2", "dense"),
    (rf"encoder/layer_{_I}/conv_module/depthwise_conv",
     r"encoder.layers.\1.conv_module.depthwise_conv", "depthwise"),
    (rf"encoder/layer_{_I}/conv_module/norm_layer",
     r"encoder.layers.\1.conv_module.norm_layer", "norm"),
    (r"encoder/after_norm", "encoder.after_norm", "norm"),
    (r"predictor/embed", "predictor.embed", "embed"),
    (rf"predictor/rnn_{_I}", r"predictor.rnn.\1", "lstm"),
    (r"predictor/projection", "predictor.projection", "dense"),
    (r"joint/(enc_ffn|pred_ffn|post_ffn|ffn_out)", r"joint.\1", "dense"),
    (r"context_bias/extractor/embed", "context_bias.extractor.embed",
     "embed"),
    (rf"context_bias/extractor/(fwd|bwd)/lstm_{_I}",
     r"context_bias.extractor.\1.cells.\2", "lstm"),
    (r"context_bias/(context_proj|encoder_bias_combine|"
     r"predictor_bias_combine|hw_output_layer|hw_output_layer_enc|"
     r"hw_output_layer_dec)", r"context_bias.\1", "dense"),
    (r"context_bias/(context_norm|encoder_bias_bias_norm|"
     r"encoder_bias_out_norm|predictor_bias_bias_norm|"
     r"predictor_bias_out_norm|hw_bias_norm)", r"context_bias.\1", "norm"),
    (r"context_bias/(encoder_bias|predictor_bias|hw_bias)/"
     r"(linear_q|linear_k|linear_v|linear_out)", r"context_bias.\1.\2",
     "dense"),
]

# kind → {leaf name: (torch leaf name, transform)}
_LEAVES = {
    "dense": {"kernel": ("weight", lambda a: a.T), "bias": ("bias", None)},
    "conv2d": {"kernel": ("weight", lambda a: a.transpose(3, 2, 0, 1)),
               "bias": ("bias", None)},
    "depthwise": {"kernel": ("weight", lambda a: a.transpose(2, 1, 0)),
                  "bias": ("bias", None)},
    "norm": {"scale": ("weight", None), "bias": ("bias", None),
             "mean": ("running_mean", None), "var": ("running_var", None)},
    "embed": {"embedding": ("weight", None)},
    "pos_bias": {"pos_bias_u": ("pos_bias_u", None),
                 "pos_bias_v": ("pos_bias_v", None)},
}
_GATES = ("i", "f", "g", "o")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _lstm(prefix: str, leaves: Dict[str, np.ndarray]):
    """Per-gate flax kernels → {prefix.wi.weight, .wh.weight, .wh.bias}."""
    want = {f"{s}{g}/kernel" for s in "ih" for g in _GATES} | \
        {f"h{g}/bias" for g in _GATES}
    if set(leaves) != want:
        raise KeyError(f"LSTM {prefix}: leaves {sorted(leaves)} are not the "
                       f"per-gate set {sorted(want)}")
    return {
        f"{prefix}.wi.weight": np.concatenate(
            [leaves[f"i{g}/kernel"].T for g in _GATES]),
        f"{prefix}.wh.weight": np.concatenate(
            [leaves[f"h{g}/kernel"].T for g in _GATES]),
        f"{prefix}.wh.bias": np.concatenate(
            [leaves[f"h{g}/bias"] for g in _GATES]),
    }


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``variables`` (nested dicts of numpy arrays) → ``state_dict``.

    Raises KeyError on a collection or leaf no rule maps, other than the
    subtrees in ``NOT_PORTED``."""
    out: Dict[str, np.ndarray] = {}
    lstm_groups: Dict[str, Dict[str, np.ndarray]] = {}
    for collection, sub in tree.items():
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unknown variable collection {collection!r}")
        for path, arr in _flatten(sub).items():
            if path.split("/", 1)[0] in NOT_PORTED:
                continue
            for pattern, template, kind in _RULES:
                m = re.fullmatch(pattern + r"/(.+)", path)
                if m is None:
                    continue
                prefix = m.expand(template)
                leaf = m.group(m.re.groups)
                if kind == "lstm":
                    lstm_groups.setdefault(prefix, {})[leaf] = arr
                    break
                if leaf not in _LEAVES[kind]:
                    raise KeyError(f"{collection}/{path}: no mapping for "
                                   f"leaf {leaf!r} of a {kind} module")
                name, fn = _LEAVES[kind][leaf]
                out[f"{prefix}.{name}"] = fn(arr) if fn else arr
                break
            else:
                raise KeyError(f"{collection}/{path}: no rule maps this leaf")
    for prefix, leaves in lstm_groups.items():
        out.update(_lstm(prefix, leaves))
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in out.items()}
