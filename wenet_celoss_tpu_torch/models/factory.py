"""Model factory, transducer branch (port of
``wenet_celoss_tpu/models/factory.py``).

``init_model(cfg)`` builds the RNN-T model with context bias from the same
config dicts as the JAX package, initialises its weights from a seeded
``torch.Generator`` and puts it on the card. The attention decoder and the
CTC head (used by other decode modes and by training) are not built yet.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from wenet_celoss_tpu_torch.models.cmvn import load_cmvn
from wenet_celoss_tpu_torch.models.context_bias import ContextBias
from wenet_celoss_tpu_torch.models.convolution import BatchNormEval
from wenet_celoss_tpu_torch.models.encoder import ConformerEncoder
from wenet_celoss_tpu_torch.models.joint import TransducerJoint
from wenet_celoss_tpu_torch.models.layers import LayerNorm, LSTMCellParams
from wenet_celoss_tpu_torch.models.predictor import RNNPredictor
from wenet_celoss_tpu_torch.models.transducer import Transducer

_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for another device. Raises when no
    card is present and the caller did not pass ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this port runs on the card; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def compute_dtype(cfg: Dict[str, Any]) -> Optional[torch.dtype]:
    """The model's compute dtype from ``cfg["dtype"]`` (None = fp32)."""
    name = cfg.get("dtype")
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return _DTYPES[name]


def build_model(cfg: Dict[str, Any]) -> Transducer:
    """The module tree for ``cfg`` (weights as the modules' defaults;
    :func:`init_params` replaces them)."""
    if "predictor" not in cfg:
        raise NotImplementedError("only the transducer branch is ported")
    if cfg.get("encoder", "conformer") != "conformer":
        raise NotImplementedError("only the conformer encoder is ported")
    if cfg.get("predictor", "rnn") != "rnn":
        raise NotImplementedError("only the RNN predictor is ported")
    dtype = compute_dtype(cfg)
    vocab = cfg["output_dim"]
    cmvn = None
    if cfg.get("cmvn_file"):
        cmvn = load_cmvn(cfg["cmvn_file"], cfg.get("is_json_cmvn", True))
    enc_conf = dict(cfg.get("encoder_conf", {}))
    encoder = ConformerEncoder(cfg["input_dim"], cmvn=cmvn, dtype=dtype,
                               **enc_conf)
    enc_out = enc_conf.get("output_size", 256)
    pred_conf = dict(cfg.get("predictor_conf", {}))
    predictor = RNNPredictor(voca_size=vocab, **pred_conf)
    joint = TransducerJoint(
        voca_size=vocab, enc_output_size=enc_out,
        pred_output_size=pred_conf.get("output_size", enc_out),
        dtype=dtype, **cfg.get("joint_conf", {}))
    context_bias = None
    if cfg.get("context", "nobias") != "nobias":
        ctx_conf = dict(cfg.get("context_conf", {}))
        ctx_conf.pop("bias_encoder", None)  # unused flag in the reference
        context_bias = ContextBias(output_size=enc_out, vocab_size=vocab,
                                   **ctx_conf)
    return Transducer(vocab, encoder, predictor, joint, context_bias,
                      blank=0)


def _normal(shape, std: float, g: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=g) * std


def _orthogonal(n: int, g: torch.Generator) -> torch.Tensor:
    q, r = torch.linalg.qr(torch.randn(n, n, generator=g))
    return q * torch.sign(torch.diagonal(r))


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0) -> None:
    """Initialise every parameter and norm buffer from one seeded CPU
    generator, with the JAX package's initialiser families: lecun-normal
    scale (std 1/sqrt(fan_in)) for dense and conv kernels, zero biases,
    unit norms, std 1/sqrt(vocab) embeddings, orthogonal per-gate
    recurrent kernels, xavier-uniform rel-pos biases."""
    g = torch.Generator().manual_seed(seed)
    lstm_parts = {id(m) for cell in model.modules()
                  if isinstance(cell, LSTMCellParams)
                  for m in cell.children()}
    for mod in model.modules():
        if id(mod) in lstm_parts:
            continue
        if isinstance(mod, LSTMCellParams):
            w = mod.wi.weight
            w.copy_(_normal(w.shape, 1.0 / math.sqrt(w.shape[1]), g))
            mod.wh.weight.copy_(torch.cat([_orthogonal(mod.hidden, g)
                                           for _ in range(4)]))
            mod.wh.bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            # weight[0] spans the fan-in: in, or I*KH*KW, or K (depthwise).
            fan_in = mod.weight[0].numel()
            mod.weight.copy_(_normal(mod.weight.shape,
                                     1.0 / math.sqrt(fan_in), g))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            w = mod.weight
            w.copy_(_normal(w.shape, 1.0 / math.sqrt(w.shape[0]), g))
        elif isinstance(mod, (LayerNorm, BatchNormEval)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BatchNormEval):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
    for name, p in model.named_parameters():
        if name.endswith(("pos_bias_u", "pos_bias_v")):
            limit = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * limit)


def init_model(cfg: Dict[str, Any], device=None, seed: int = 0
               ) -> Transducer:
    """Build the model for ``cfg`` with seeded random weights, in eval
    mode, on ``device`` (the card by default; see :func:`resolve_device`).

    On the card, fp32 matmuls and convolutions are kept in full fp32
    (cuDNN's default TF32 convolutions would break fp32 parity)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    # The modules' own default init would draw from the global generator;
    # keep the caller's stream untouched (init_params overwrites it all).
    with torch.random.fork_rng(devices=[]):
        model = build_model(cfg)
    init_params(model, seed)
    return model.to(dev).eval()
