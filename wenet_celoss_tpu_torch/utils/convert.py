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
- GRU kernels ir/iz/in (biased) and hr/hz/hn → ``wi`` [3H, E] + bias,
  ``wh`` [3H, H] and ``bhn`` (hn's bias), gate order r, z, n;
- every encoder tower (the model's, and the transformer extractor's and
  bias encoder's inside context_bias) by the same rules;
- LayerNorm / BatchNorm scale → weight, batch_stats mean/var →
  running_mean/running_var;
- the subsampling output linear needs no permutation: the port flattens
  its conv output in the same (f, c) order as the JAX package's NHWC
  layout.

Every leaf must match a rule below; anything else raises.
``jax_channel_axis`` reads the same rules backwards: which axis of a port
tensor the last axis of its JAX leaf lands on (``utils/quantize.py``
takes its per-channel scales over that axis).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_I = r"(\d+)"


def _encoder_rules(jax: str, port: str):
    """The rules of one encoder tower at JAX path ``jax`` (port prefix
    ``port``): the model's encoder, and the transformer extractor's and
    bias encoder's inside context_bias."""
    return [
        (rf"{jax}/embed/(conv1|conv2|conv3)", rf"{port}.embed.\1", "conv2d"),
        (rf"{jax}/embed/out", f"{port}.embed.out", "dense"),
        (rf"{jax}/embed/norm", f"{port}.embed.norm", "norm"),
        (rf"{jax}/layer_{_I}/(feed_forward|feed_forward_macaron)/Dense_0",
         rf"{port}.layers.\1.\2.w_1", "dense"),
        (rf"{jax}/layer_{_I}/(feed_forward|feed_forward_macaron)/Dense_1",
         rf"{port}.layers.\1.\2.w_2", "dense"),
        (rf"{jax}/layer_{_I}/self_attn/"
         r"(linear_q|linear_k|linear_v|linear_out|linear_pos)",
         rf"{port}.layers.\1.self_attn.\2", "dense"),
        (rf"{jax}/layer_{_I}/self_attn", rf"{port}.layers.\1.self_attn",
         "pos_bias"),
        (rf"{jax}/layer_{_I}/"
         r"(norm_ff_macaron|norm_mha|norm_conv|norm_ff|norm_final|norm1|"
         r"norm2)", rf"{port}.layers.\1.\2", "norm"),
        (rf"{jax}/layer_{_I}/concat_linear",
         rf"{port}.layers.\1.concat_linear", "dense"),
        (rf"{jax}/layer_{_I}/conv_module/(pointwise_conv1|pointwise_conv2)",
         rf"{port}.layers.\1.conv_module.\2", "dense"),
        (rf"{jax}/layer_{_I}/conv_module/depthwise_conv",
         rf"{port}.layers.\1.conv_module.depthwise_conv", "depthwise"),
        (rf"{jax}/layer_{_I}/conv_module/norm_layer",
         rf"{port}.layers.\1.conv_module.norm_layer", "norm"),
        (rf"{jax}/after_norm", f"{port}.after_norm", "norm"),
    ]


_RULES = [
    # (module path regex, torch prefix template, kind)
    *_encoder_rules("encoder", "encoder"),
    (r"predictor/embed", "predictor.embed", "embed"),
    (rf"predictor/rnn_{_I}", r"predictor.rnn.\1", "rnn"),
    (r"predictor/(projection|ffn)", r"predictor.\1", "dense"),
    (r"predictor/norm", "predictor.norm", "norm"),
    (r"predictor/conv", "predictor.conv", "depthwise"),
    (r"predictor", "predictor", "param"),
    (r"joint/(enc_ffn|pred_ffn|post_ffn|ffn_out)", r"joint.\1", "dense"),
    (r"(simple_am_proj|simple_lm_proj)", r"\1", "dense"),
    (r"decoder/(left|right)/embed_tokens", r"decoder.\1_decoder.embed_tokens",
     "embed"),
    (rf"decoder/(left|right)/layer_{_I}/(self_attn|src_attn)/"
     r"(linear_q|linear_k|linear_v|linear_out)",
     r"decoder.\1_decoder.decoders.\2.\3.\4", "dense"),
    (rf"decoder/(left|right)/layer_{_I}/feed_forward/Dense_0",
     r"decoder.\1_decoder.decoders.\2.feed_forward.w_1", "dense"),
    (rf"decoder/(left|right)/layer_{_I}/feed_forward/Dense_1",
     r"decoder.\1_decoder.decoders.\2.feed_forward.w_2", "dense"),
    (rf"decoder/(left|right)/layer_{_I}/(norm1|norm2|norm3)",
     r"decoder.\1_decoder.decoders.\2.\3", "norm"),
    (rf"decoder/(left|right)/layer_{_I}/(concat_linear1|concat_linear2)",
     r"decoder.\1_decoder.decoders.\2.\3", "dense"),
    (r"decoder/(left|right)/after_norm", r"decoder.\1_decoder.after_norm",
     "norm"),
    (r"decoder/(left|right)/output_layer",
     r"decoder.\1_decoder.output_layer", "dense"),
    (r"ctc/ctc_lo", "ctc.ctc_lo", "dense"),
    (r"context_bias/extractor/embed", "context_bias.extractor.embed",
     "embed"),
    (rf"context_bias/extractor/(fwd|bwd|rnn)/lstm_{_I}",
     r"context_bias.extractor.\1.cells.\2", "rnn"),
    (r"context_bias/extractor/linear", "context_bias.extractor.linear",
     "dense"),
    *_encoder_rules("context_bias/extractor/encoder",
                    "context_bias.extractor.encoder"),
    *_encoder_rules("context_bias/context_encoder",
                    "context_bias.context_encoder"),
    (r"context_bias/(context_proj|encoder_bias_combine|"
     r"predictor_bias_combine|hw_output_layer|hw_output_layer_enc|"
     r"hw_output_layer_dec|hw_pred_proj)", r"context_bias.\1", "dense"),
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
    "param": {"pos_embed": ("pos_embed", None)},
}
_GATES = ("i", "f", "g", "o")
_GRU_GATES = ("r", "z", "n")


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


def _gru(prefix: str, leaves: Dict[str, np.ndarray]):
    """flax GRUCell kernels ir/iz/in (with biases) and hr/hz/hn (hn with
    a bias) → {prefix.wi.weight, .wi.bias, .wh.weight, .bhn}, gate order
    r, z, n."""
    want = {f"{s}{g}/kernel" for s in "ih" for g in _GRU_GATES} | \
        {f"i{g}/bias" for g in _GRU_GATES} | {"hn/bias"}
    if set(leaves) != want:
        raise KeyError(f"GRU {prefix}: leaves {sorted(leaves)} are not the "
                       f"per-gate set {sorted(want)}")
    return {
        f"{prefix}.wi.weight": np.concatenate(
            [leaves[f"i{g}/kernel"].T for g in _GRU_GATES]),
        f"{prefix}.wi.bias": np.concatenate(
            [leaves[f"i{g}/bias"] for g in _GRU_GATES]),
        f"{prefix}.wh.weight": np.concatenate(
            [leaves[f"h{g}/kernel"].T for g in _GRU_GATES]),
        f"{prefix}.bhn": leaves["hn/bias"],
    }


def _rnn(prefix: str, leaves: Dict[str, np.ndarray]):
    """An LSTM's or a GRU's per-gate leaves (told apart by their gates)."""
    return (_gru if "ir/kernel" in leaves else _lstm)(prefix, leaves)


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``variables`` (nested dicts of numpy arrays) → ``state_dict``.

    Raises KeyError on a collection or leaf no rule maps."""
    out: Dict[str, np.ndarray] = {}
    rnn_groups: Dict[str, Dict[str, np.ndarray]] = {}
    for collection, sub in tree.items():
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unknown variable collection {collection!r}")
        for path, arr in _flatten(sub).items():
            for pattern, template, kind in _RULES:
                m = re.fullmatch(pattern + r"/(.+)", path)
                if m is None:
                    continue
                prefix = m.expand(template)
                leaf = m.group(m.re.groups)
                if kind == "rnn":
                    rnn_groups.setdefault(prefix, {})[leaf] = arr
                    break
                if leaf not in _LEAVES[kind]:
                    raise KeyError(f"{collection}/{path}: no mapping for "
                                   f"leaf {leaf!r} of a {kind} module")
                name, fn = _LEAVES[kind][leaf]
                out[f"{prefix}.{name}"] = fn(arr) if fn else arr
                break
            else:
                raise KeyError(f"{collection}/{path}: no rule maps this leaf")
    for prefix, leaves in rnn_groups.items():
        out.update(_rnn(prefix, leaves))
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in out.items()}


def _port_rules():
    """The rules' torch prefix templates as patterns over port keys (each
    back-reference replaced by its group of the JAX path pattern), with
    their kinds."""
    out = []
    for pattern, template, kind in _RULES:
        groups = re.findall(r"\(([^()]*)\)", pattern)
        parts = re.split(r"\\(\d)", template)
        pat = "".join(f"(?:{groups[int(p) - 1]})" if i % 2 else re.escape(p)
                      for i, p in enumerate(parts))
        out.append((re.compile(pat + r"\.(.+)"), kind))
    return out


def jax_channel_axis(key: str, ndim: int) -> int:
    """The axis of the port tensor ``key`` (``ndim`` axes) that the last
    axis of its JAX leaf maps onto under :func:`params_from_jax`: a probe
    whose values count along the JAX leaf's last axis goes through the
    leaf's transform, and the axis along which the result varies is the
    one. Raises KeyError on a key no rule maps."""
    for pat, kind in _port_rules():
        m = pat.fullmatch(key)
        if m is None:
            continue
        leaf = m.group(1)
        if kind == "rnn":
            # Per-gate kernels [E, H] and [H, H], the biases [H]: E=2, H=3.
            out = None
            for gates, biases, fn in ((_GATES, "h", _lstm),
                                      (_GRU_GATES, "i", _gru)):
                probe = {f"{s}{g}/kernel": np.broadcast_to(
                    np.arange(3), (2 if s == "i" else 3, 3))
                    for s in "ih" for g in gates}
                probe.update({f"{biases}{g}/bias": np.arange(3)
                              for g in gates})
                if fn is _gru:
                    probe["hn/bias"] = np.arange(3)
                out = fn("", probe).get(f".{leaf}")
                if out is not None and out.ndim == ndim:
                    break
        else:
            fns = dict(_LEAVES[kind].values())
            if leaf not in fns:
                continue
            fn = fns[leaf] or (lambda a: a)
            shape = tuple(range(2, 2 + ndim))
            out = fn(np.broadcast_to(np.arange(shape[-1]), shape))
        if out is None or out.ndim != ndim:
            continue
        varies = [a for a in range(ndim)
                  if np.any(np.diff(out, axis=a) != 0)]
        if len(varies) == 1:
            return varies[0]
    raise KeyError(f"{key}: no rule maps this port tensor")
