"""Model export CLI (port of ``wenet_celoss_tpu/bin/export.py``, which
writes ``jax.export`` StableHLO artifacts). Each serving entry point is
traced by ``torch.export`` at static shapes and saved with
``torch.export.save``:

  encoder_ctc.pt2         full-context encode + CTC log-probs
  encoder_chunk_ctc.pt2   the streaming chunk step (fixed-size caches;
                          streamable encoders only)
  decoder_scores.pt2      n-best attention rescoring (reverse weight 1.0)
  params.pt               fp32 parameters (``params_int8.pt`` under
                          ``--quantize int8``)
  manifest.yaml           shapes and subsampling metadata

    python -m wenet_celoss_tpu_torch.bin.export --config train.yaml \\
        --checkpoint final.ckpt --output_dir exp/export

The graphs hold the port's kernels as registered operators
(``wenet_torch::ln_ffn_residual_fwd`` in every pre-norm FFN; the K6, K7
and K8 operators where the model or a switch routes them). Loading a
``.pt2`` needs ``import wenet_celoss_tpu_torch.ops`` first. The chunk
program takes the cache as a dict of tensors, ``att_len`` and ``offset``
as 0-d int32 tensors, and returns the next one. It runs on the card
unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch
import torch.nn as nn

import wenet_celoss_tpu_torch.ops  # noqa: F401  (registers the operators)
from wenet_celoss_tpu_torch.models.asr_model import ASRModel
from wenet_celoss_tpu_torch.models.factory import init_model, resolve_device
from wenet_celoss_tpu_torch.utils.checkpoint import load_into, save_checkpoint
from wenet_celoss_tpu_torch.utils.config import dump_yaml, load_config
from wenet_celoss_tpu_torch.utils.quantize import (dequantize_params,
                                                   quantize_params,
                                                   save_quantized)


class EncodeCtc(nn.Module):
    """(feats [B, T, F], feat_lens [B] int32) → (encoder_out, pad_mask,
    CTC log-probs), full context: ``ASRModel.encode_ctc`` over the
    encoder and the CTC head alone (a program keeps the weights of the
    modules it holds)."""
    encode = ASRModel.encode
    encode_ctc = ASRModel.encode_ctc

    def __init__(self, model):
        super().__init__()
        self.encoder, self.ctc = model.encoder, model.ctc

    def forward(self, feats, feat_lens):
        return self.encode_ctc(feats, feat_lens)


class ChunkCtc(nn.Module):
    """(xs [B, window, F], cache) → (encoder_out, CTC log-probs, cache):
    ``ASRModel.encoder_forward_chunk_ctc`` over the encoder and CTC head."""
    encoder_forward_chunk_ctc = ASRModel.encoder_forward_chunk_ctc

    def __init__(self, model):
        super().__init__()
        self.encoder, self.ctc = model.encoder, model.ctc

    def forward(self, xs, cache):
        return self.encoder_forward_chunk_ctc(xs, cache)


class DecoderScores(nn.Module):
    """Both decoders' teacher-forced log-probs, reverse weight 1.0:
    ``ASRModel.decoder_scores`` over the decoder alone."""
    decoder_scores = ASRModel.decoder_scores

    def __init__(self, model):
        super().__init__()
        self.decoder = model.decoder

    def forward(self, memory, memory_mask, hyps_in, hyps_lens, r_hyps_in):
        return self.decoder_scores(memory, memory_mask, hyps_in, hyps_lens,
                                   r_hyps_in, 1.0)


def tensor_cache(cache: dict) -> dict:
    """A model's chunk cache with its int entries as 0-d int32 tensors, the
    form the exported chunk program takes and returns."""
    dev = cache["att"].device
    return {k: torch.tensor(v, dtype=torch.int32, device=dev)
            if isinstance(v, int) else v for k, v in cache.items()}


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="export your model")
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--chunk_size", type=int, default=16)
    parser.add_argument("--num_left_chunks", type=int, default=4)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--max_frames", type=int, default=2000)
    parser.add_argument("--beam", type=int, default=10)
    parser.add_argument("--max_hyp_len", type=int, default=64)
    parser.add_argument("--quantize", default="none",
                        choices=["none", "int8"],
                        help="int8: weight-only per-channel int8; the "
                             "programs embed the dequantized weights and "
                             "the bundle ships as int8")
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu for the plain "
                             "versions on the host")
    return parser


def _save(module, args, path: str) -> None:
    with torch.no_grad():
        prog = torch.export.export(module, args)
    torch.export.save(prog, path)


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    dev = resolve_device(args.device)
    configs = load_config(args.config)
    model = init_model(configs, device=dev)
    load_into(model, args.checkpoint)
    if args.quantize == "int8":
        # Quantize and dequantize BEFORE tracing, so every program's
        # weights are exactly those the int8 bundle reconstructs.
        model.load_state_dict(dequantize_params(
            quantize_params(model.state_dict())))
    model.requires_grad_(False)
    feat_dim = configs["input_dim"]
    os.makedirs(args.output_dir, exist_ok=True)
    out = lambda name: os.path.join(args.output_dir, name)  # noqa: E731

    b, t = args.batch, args.max_frames
    sub = model.encoder.subsampling_rate
    rctx = model.encoder.right_context
    window = (args.chunk_size - 1) * sub + rctx + 1
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)

    # 1. Full-context encoder + CTC.
    _save(EncodeCtc(model), (torch.zeros(b, t, feat_dim, **f32),
                             torch.full((b,), t, **i32)),
          out("encoder_ctc.pt2"))

    # 2. The streaming chunk step (a non-causal conformer conv has no
    # cache form).
    can_stream = model.encoder.streamable
    if can_stream:
        cache = tensor_cache(model.encoder_init_cache(
            b, args.chunk_size * args.num_left_chunks))
        _save(ChunkCtc(model), (torch.zeros(b, window, feat_dim, **f32),
                                cache), out("encoder_chunk_ctc.pt2"))
    else:
        logging.warning("encoder is a non-causal conformer: skipping the "
                        "streaming chunk artifact (full-context only)")

    # 3. Attention rescoring scores.
    n, u = args.beam, args.max_hyp_len
    t_sub = (t - 3) // 4 if sub == 4 else t // sub
    d = model.encoder.output_size
    _save(DecoderScores(model),
          (torch.zeros(n, t_sub, d, **f32),
           torch.ones(n, t_sub, dtype=torch.bool, device=dev),
           torch.ones(n, u + 1, **i32), torch.ones(n, **i32),
           torch.ones(n, u + 1, **i32)), out("decoder_scores.pt2"))

    if args.quantize == "int8":
        params_name = "params_int8.pt"
        save_quantized(model.state_dict(), out(params_name))
    else:
        params_name = "params.pt"
        save_checkpoint(model, out(params_name))
    manifest = {
        "subsampling_rate": sub,
        "right_context": rctx,
        "chunk_size": args.chunk_size,
        "num_left_chunks": args.num_left_chunks,
        "window": window,
        "feat_dim": feat_dim,
        "vocab_size": configs["output_dim"],
        "sos": int(model.sos), "eos": int(model.eos),
        "quantize": args.quantize,
        "artifacts": (["encoder_ctc.pt2"]
                      + (["encoder_chunk_ctc.pt2"] if can_stream else [])
                      + ["decoder_scores.pt2", params_name]),
    }
    with open(out("manifest.yaml"), "w", encoding="utf8") as f:
        f.write(dump_yaml(manifest))
    print(f"exported to {args.output_dir}")


if __name__ == "__main__":
    main()
