"""Canonical model configs (mirroring the reference recipes' YAML).

A copy of ``wenet_celoss_tpu/configs.py``: the port keeps the same dicts
so that one config builds the same model in both packages.

- ``conformer_rnnt_bias``: the fork's flagship — 12-layer conformer-256
  RNN-T with BLSTM context bias + hotword CE loss (reference
  `examples/librispeech/s0/conf/encoder_bias_conformer_rnnt_4_head_bi_1_
  layer_2_Labels_both.yaml`).
- ``conformer_ctc_aed``: upstream LibriSpeech conformer (reference
  `conf/train_conformer.yaml`).
- ``u2pp_conformer``: U2++ streaming-capable conformer (reference
  `conf/train_u2++_conformer.yaml`).
"""

from __future__ import annotations

import copy


def conformer_rnnt_bias(input_dim: int = 80, vocab_size: int = 5002,
                        tiny: bool = False):
    d = 64 if tiny else 256
    blocks = 2 if tiny else 12
    heads = 2 if tiny else 4
    return {
        "input_dim": input_dim,
        "output_dim": vocab_size,
        "encoder": "conformer",
        "encoder_conf": {
            "output_size": d, "attention_heads": heads,
            "linear_units": d * 8, "num_blocks": blocks,
            "dropout_rate": 0.1, "positional_dropout_rate": 0.1,
            "attention_dropout_rate": 0.1, "input_layer": "conv2d",
            "normalize_before": True, "cnn_module_kernel": 15,
            "use_cnn_module": True, "activation_type": "swish",
            "cnn_module_norm": "layer_norm",
            "pos_enc_layer_type": "rel_pos",
        },
        "decoder": "bitransformer",
        "decoder_conf": {
            "attention_heads": heads, "linear_units": d * 8,
            "num_blocks": 1 if tiny else 3,
            "r_num_blocks": 1 if tiny else 3,
            "dropout_rate": 0.1, "positional_dropout_rate": 0.1,
            "self_attention_dropout_rate": 0.1,
            "src_attention_dropout_rate": 0.1,
        },
        "predictor": "rnn",
        "predictor_conf": {
            "embed_size": d, "output_size": d, "embed_dropout": 0.1,
            "hidden_size": d, "num_layers": 2, "bias": True,
            "rnn_type": "lstm", "dropout": 0.1,
        },
        "joint_conf": {
            "join_dim": 2 * d, "prejoin_linear": True,
            "postjoin_linear": False, "joint_mode": "add",
            "activation": "tanh",
        },
        "context": "nnbias_encoder_decoder",
        "context_conf": {
            "embedding_size": d, "num_layers": 1, "attention_heads": heads,
            "linear_units": 2 * d, "num_block": 2, "dropout_rate": 0.0,
            "bias_encoder_type": "linear", "context_extractor": "BLSTM",
            "num_labels": 2, "unified_hw_odim": 100,
            "unified_hw_heads": 4,
        },
        "model_conf": {
            "transducer_weight": 0.75, "ctc_weight": 0.1,
            "attention_weight": 0.15, "lsm_weight": 0.1,
            "length_normalized_loss": False, "reverse_weight": 0.3,
            "loss_mode": "both", "hw_weight": 0.4,
            # Exact streaming-V RNN-T loss: [B,T,U,V] never materializes.
            "rnnt_impl": "streaming",
        },
        "grad_clip": 4, "accum_grad": 4,
        "optim": "adam", "optim_conf": {"lr": 0.001},
        "scheduler_conf": {"warmup_steps": 25000},
    }


def conformer_ctc_aed(input_dim: int = 80, vocab_size: int = 5002,
                      tiny: bool = False):
    d = 64 if tiny else 256
    return {
        "input_dim": input_dim,
        "output_dim": vocab_size,
        "encoder": "conformer",
        "encoder_conf": {
            "output_size": d, "attention_heads": 2 if tiny else 4,
            "linear_units": d * 8, "num_blocks": 2 if tiny else 12,
            "dropout_rate": 0.1, "positional_dropout_rate": 0.1,
            "attention_dropout_rate": 0.0, "input_layer": "conv2d",
            "normalize_before": True, "cnn_module_kernel": 15,
            "use_cnn_module": True, "activation_type": "swish",
            "cnn_module_norm": "layer_norm",
            "pos_enc_layer_type": "rel_pos",
        },
        "decoder": "bitransformer",
        "decoder_conf": {
            "attention_heads": 2 if tiny else 4, "linear_units": d * 8,
            "num_blocks": 1 if tiny else 6, "r_num_blocks": 0,
            "dropout_rate": 0.1,
        },
        "model_conf": {"ctc_weight": 0.3, "lsm_weight": 0.1,
                       "reverse_weight": 0.0,
                       "length_normalized_loss": False},
        "grad_clip": 5, "accum_grad": 4,
        "optim": "adam", "optim_conf": {"lr": 0.002},
        "scheduler_conf": {"warmup_steps": 25000},
    }


def u2pp_conformer(input_dim: int = 80, vocab_size: int = 5002,
                   tiny: bool = False):
    cfg = conformer_ctc_aed(input_dim, vocab_size, tiny)
    cfg = copy.deepcopy(cfg)
    cfg["encoder_conf"].update({
        "causal": True, "use_dynamic_chunk": True,
        "use_dynamic_left_chunk": False, "cnn_module_norm": "layer_norm",
        "cnn_module_kernel": 15,
    })
    cfg["decoder_conf"].update(
        {"r_num_blocks": 1 if tiny else 3})
    cfg["model_conf"].update({"reverse_weight": 0.3})
    return cfg
