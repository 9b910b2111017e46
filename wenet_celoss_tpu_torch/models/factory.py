"""Model factory (port of ``wenet_celoss_tpu/models/factory.py``).

``init_model(cfg)`` builds, from the same config dicts as the JAX package,
every model the JAX factory builds: the hybrid CTC/attention ``ASRModel``
(no ``predictor`` in the config) or the RNN-T ``Transducer`` (an RNN,
embedding or conv predictor; ``rnnt_impl`` streaming, scan, fused, pallas
or pruned) with or without context bias (a BLSTM, LSTM or transformer
phrase extractor; a linear or transformer bias encoder); both carry the
encoder (conformer or transformer, pre- or post-norm, any front end and
positional encoding, ``concat_after``), the attention decoder and the CTC
head, so a JAX weight tree maps onto either whole. It initialises the
weights from a seeded ``torch.Generator`` and puts the model on the card.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import torch
import torch.nn as nn

from wenet_celoss_tpu_torch.models.asr_model import ASRModel
from wenet_celoss_tpu_torch.models.cmvn import load_cmvn
from wenet_celoss_tpu_torch.models.context_bias import ContextBias
from wenet_celoss_tpu_torch.models.convolution import BatchNorm
from wenet_celoss_tpu_torch.models.ctc_head import CTC
from wenet_celoss_tpu_torch.models.decoder import BiTransformerDecoder
from wenet_celoss_tpu_torch.models.encoder import (ConformerEncoder,
                                                   TransformerEncoder)
from wenet_celoss_tpu_torch.models.joint import TransducerJoint
from wenet_celoss_tpu_torch.models.layers import (GRUCellParams, LayerNorm,
                                                  LSTMCellParams)
from wenet_celoss_tpu_torch.models.predictor import (EmbeddingPredictor,
                                                     PREDICTOR_CLASSES)
from wenet_celoss_tpu_torch.models.transducer import Transducer

_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}
# Conformer-only keys that shared configs may carry; the transformer
# encoder drops them, as the JAX factory does.
_CONFORMER_ONLY = ("positionwise_conv_kernel_size", "macaron_style",
                   "selfattention_layer_type", "activation_type",
                   "use_cnn_module", "cnn_module_kernel", "causal",
                   "cnn_module_norm")


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


Model = Union[ASRModel, Transducer]


def build_model(cfg: Dict[str, Any]) -> Model:
    """The module tree for ``cfg`` (weights as the modules' defaults;
    :func:`init_params` replaces them)."""
    enc_type = cfg.get("encoder", "conformer")
    if enc_type not in ("conformer", "transformer"):
        raise NotImplementedError(f"encoder {enc_type!r} is not ported")
    dec_type = cfg.get("decoder", "bitransformer")
    if dec_type not in ("bitransformer", "transformer"):
        raise NotImplementedError(f"decoder {dec_type!r} is not ported")
    dec_conf = dict(cfg.get("decoder_conf", {}))
    if dec_type == "transformer":   # the left-to-right decoder alone
        dec_conf.setdefault("r_num_blocks", 0)
    dtype = compute_dtype(cfg)
    vocab = cfg["output_dim"]
    cmvn = None
    if cfg.get("cmvn_file"):
        cmvn = load_cmvn(cfg["cmvn_file"], cfg.get("is_json_cmvn", True))
    enc_conf = dict(cfg.get("encoder_conf", {}))
    enc_cls = ConformerEncoder
    if enc_type == "transformer":
        enc_cls = TransformerEncoder
        for k in _CONFORMER_ONLY:
            enc_conf.pop(k, None)
    encoder = enc_cls(cfg["input_dim"], cmvn=cmvn, dtype=dtype, **enc_conf)
    enc_out = enc_conf.get("output_size", 256)
    decoder = BiTransformerDecoder(vocab, enc_out, dtype=dtype, **dec_conf)
    ctc = CTC(vocab, enc_out)
    if "predictor" not in cfg:
        model_conf = cfg.get("model_conf", {})
        return ASRModel(
            vocab, encoder, decoder, ctc,
            ctc_weight=model_conf.get("ctc_weight", 0.5),
            reverse_weight=model_conf.get("reverse_weight", 0.0),
            lsm_weight=model_conf.get("lsm_weight", 0.1),
            length_normalized_loss=model_conf.get("length_normalized_loss",
                                                  False))
    model_conf = cfg.get("model_conf", {})
    # fused_rnnt_loss is the JAX package's alias of rnnt_impl "fused".
    rnnt_impl = ("fused" if model_conf.get("fused_rnnt_loss", False)
                 else model_conf.get("rnnt_impl", "scan"))
    pred_type = cfg.get("predictor", "rnn")
    pred_conf = dict(cfg.get("predictor_conf", {}))
    if pred_type == "rnn":
        pred_out = pred_conf.get("output_size", enc_out)
        pred_conf["dtype"] = dtype
    else:
        # The stateless predictors drop the RNN's keys, and their output
        # is the embedding, as in the JAX factory.
        for k in ("output_size", "hidden_size", "num_layers", "rnn_type",
                  "dropout"):
            pred_conf.pop(k, None)
        pred_out = pred_conf.get("embed_size", enc_out)
    predictor = PREDICTOR_CLASSES[pred_type](voca_size=vocab, **pred_conf)
    joint = TransducerJoint(
        voca_size=vocab, enc_output_size=enc_out,
        pred_output_size=pred_out, dtype=dtype,
        **cfg.get("joint_conf", {}))
    context_bias = None
    if cfg.get("context", "nobias") != "nobias":
        ctx_conf = dict(cfg.get("context_conf", {}))
        ctx_conf.pop("bias_encoder", None)  # unused flag in the reference
        context_bias = ContextBias(
            output_size=enc_out, vocab_size=vocab,
            loss_mode=model_conf.get("loss_mode", "both"), **ctx_conf)
    tw = model_conf.get("transducer_weight", 1.0)
    cw = model_conf.get("ctc_weight", 0.0)
    aw = model_conf.get("attention_weight", 1.0 - tw - cw)
    if abs(tw + cw + aw - 1.0) >= 1e-6:
        raise ValueError("transducer + ctc + attention weights must sum "
                         "to 1")
    # No streaming_chunk: the JAX factory passes none, so its model keeps
    # the field default (16) whatever model_conf says.
    return Transducer(
        vocab, encoder, predictor, joint, context_bias, blank=0,
        decoder=decoder, ctc=ctc, transducer_weight=tw, ctc_weight=cw,
        hw_weight=model_conf.get("hw_weight", 0.4),
        loss_mode=model_conf.get("loss_mode", "both"),
        rnnt_impl=rnnt_impl,
        prune_range=model_conf.get("prune_range", 5),
        simple_loss_scale=model_conf.get("simple_loss_scale", 0.5),
        lsm_weight=model_conf.get("lsm_weight", 0.0),
        reverse_weight=model_conf.get("reverse_weight", 0.0),
        length_normalized_loss=model_conf.get("length_normalized_loss",
                                              False))


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
    recurrent kernels (LSTM and GRU), xavier-uniform rel-pos biases."""
    g = torch.Generator().manual_seed(seed)
    cells = (LSTMCellParams, GRUCellParams)
    cell_parts = {id(m) for cell in model.modules()
                  if isinstance(cell, cells) for m in cell.children()}
    for mod in model.modules():
        if id(mod) in cell_parts:
            continue
        if isinstance(mod, cells):
            w = mod.wi.weight
            w.copy_(_normal(w.shape, 1.0 / math.sqrt(w.shape[1]), g))
            gates = w.shape[0] // mod.hidden
            mod.wh.weight.copy_(torch.cat([_orthogonal(mod.hidden, g)
                                           for _ in range(gates)]))
            for b in (mod.wi.bias, mod.wh.bias, getattr(mod, "bhn", None)):
                if b is not None:
                    b.zero_()
        elif isinstance(mod, EmbeddingPredictor):
            # flax's lecun_normal over [n_head, C, E]: fan_in n_head * C.
            p = mod.pos_embed
            p.copy_(_normal(p.shape, 1.0 / math.sqrt(p.shape[0]
                                                     * p.shape[1]), g))
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
        elif isinstance(mod, (LayerNorm, BatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
    for name, p in model.named_parameters():
        if name.endswith(("pos_bias_u", "pos_bias_v")):
            limit = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * limit)


def init_model(cfg: Dict[str, Any], device=None, seed: int = 0) -> Model:
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
