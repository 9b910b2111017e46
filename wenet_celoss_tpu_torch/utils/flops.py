"""Analytic model-FLOP counts for MFU reporting (copy of
``wenet_celoss_tpu/utils/flops.py``; pure Python).

A profiler's operation count cannot see FLOPs inside hand-written kernels
(the port runs its FFN tower and the streaming joint's vocab matmul in
them), so a measured MFU would undercount. This module counts the
model's matmul/conv FLOPs (2·MACs) straight from the config, the standard "model FLOPs" numerator: required algorithmic
matmuls only, no rematerialisation credit (that would be HFU), no
elementwise/softmax/normalisation ops.

Shapes follow the reference architecture (conformer encoder
`wenet/transformer/encoder.py`, bitransformer decoder `decoder.py`, RNN
predictor `wenet/transducer/predictor.py:58`, prejoin-linear joint
`joint.py:45-70`) as re-built in ``wenet_celoss_tpu_torch/models``.

Convention: ``forward`` FLOPs below; a train step is ``3×`` forward
(activation grads + weight grads each cost one forward's matmuls).
"""

from __future__ import annotations

from typing import Dict


def _conv_valid(n: int, k: int = 3, s: int = 2) -> int:
    return (n - k) // s + 1


def subsampled_len(t_in: int, input_layer: str = "conv2d") -> int:
    """Output frames of the conv frontend (VALID convs, models/subsampling)."""
    if input_layer == "linear":
        return t_in
    t = _conv_valid(t_in)
    if input_layer == "conv2d6":
        return _conv_valid(t, k=5, s=3)
    t = _conv_valid(t)
    if input_layer == "conv2d8":
        t = _conv_valid(t)
    return t


def _subsampling_macs(t_in: int, f_in: int, d: int,
                      input_layer: str) -> int:
    if input_layer == "linear":
        return t_in * f_in * d
    t1, f1 = _conv_valid(t_in), _conv_valid(f_in)
    macs = t1 * f1 * d * 9              # conv1: 1 → d channels, 3×3
    if input_layer == "conv2d6":
        t2, f2 = _conv_valid(t1, 5, 3), _conv_valid(f1, 5, 3)
        macs += t2 * f2 * d * d * 25    # conv2: 5×5 stride 3
    else:
        t2, f2 = _conv_valid(t1), _conv_valid(f1)
        macs += t2 * f2 * d * d * 9     # conv2: 3×3 stride 2
        if input_layer == "conv2d8":
            t2, f2 = _conv_valid(t2), _conv_valid(f2)
            macs += t2 * f2 * d * d * 9
    macs += t2 * (d * f2) * d           # flatten → Dense(d)
    return macs


def _mhsa_macs(t_q: int, t_kv: int, d: int, rel_pos: bool,
               t_pos: int = 0) -> int:
    """q/k/v/out projections + score & context matmuls (+ rel-pos path:
    linear_pos over the sinusoid table and the matrix_bd einsum — the
    reference's no-rel-shift formulation, attention.py:305-307)."""
    macs = (2 * t_q + 2 * t_kv) * d * d          # q,out on t_q; k,v on t_kv
    macs += 2 * t_q * t_kv * d                   # scores (ac) + context
    if rel_pos:
        t_pos = t_pos or t_kv
        macs += t_pos * d * d                    # linear_pos
        macs += t_q * t_pos * d                  # matrix_bd
    return macs


def _ffn_macs(t: int, d: int, hidden: int) -> int:
    return 2 * t * d * hidden


def _lstm_macs(steps: int, in_dim: int, hidden: int) -> int:
    return steps * (in_dim * 4 * hidden + hidden * 4 * hidden)


def encoder_forward_macs(cfg: Dict, t_in: int) -> int:
    ec = cfg["encoder_conf"]
    d = ec["output_size"]
    lu = ec["linear_units"]
    n = ec["num_blocks"]
    conformer = cfg.get("encoder", "conformer") == "conformer"
    rel_pos = ec.get("pos_enc_layer_type", "abs_pos") == "rel_pos"
    tp = subsampled_len(t_in, ec.get("input_layer", "conv2d"))
    macs = _subsampling_macs(t_in, cfg["input_dim"], d,
                             ec.get("input_layer", "conv2d"))
    per = _mhsa_macs(tp, tp, d, rel_pos)
    per += _ffn_macs(tp, d, lu) * (2 if conformer else 1)  # macaron pair
    if conformer and ec.get("use_cnn_module", True):
        k = ec.get("cnn_module_kernel", 15)
        per += 3 * tp * d * d + tp * d * k       # pw1(2d via GLU)+pw2+dw
    macs += n * per
    return macs


def aed_decoder_forward_macs(cfg: Dict, t_enc: int, u1: int) -> int:
    dc = cfg.get("decoder_conf")
    if not dc:
        return 0
    d = cfg["encoder_conf"]["output_size"]
    lu = dc["linear_units"]
    v = cfg["output_dim"]
    blocks = dc.get("num_blocks", 0) + dc.get("r_num_blocks", 0)
    n_dirs = (1 if dc.get("num_blocks", 0) else 0) + \
        (1 if dc.get("r_num_blocks", 0) else 0)
    per = _mhsa_macs(u1, u1, d, rel_pos=False)           # self-attn
    per += _mhsa_macs(u1, t_enc, d, rel_pos=False)       # cross-attn
    per += _ffn_macs(u1, d, lu)
    return blocks * per + n_dirs * u1 * d * v            # + output_layer


def predictor_forward_macs(cfg: Dict, u1: int) -> int:
    pc = cfg.get("predictor_conf")
    if not pc:
        return 0
    if cfg.get("predictor", "rnn") == "rnn":
        e, h = pc["embed_size"], pc["hidden_size"]
        macs = _lstm_macs(u1, e, h)
        for _ in range(pc.get("num_layers", 1) - 1):
            macs += _lstm_macs(u1, h, h)
        macs += u1 * h * pc["output_size"]               # final projection
        return macs
    # embedding / conv predictors: history-window mixes, ~one d² matmul
    e = pc.get("embed_size", 256)
    return u1 * e * pc.get("output_size", e)


def transducer_loss_forward_macs(cfg: Dict, t_enc: int, u1: int) -> int:
    """Prejoin projections + the full-lattice vocab matmul
    ([T',U+1] × join_dim × V — computed by every exact RNN-T loss,
    whether or not the [B,T,U,V] tensor materialises)."""
    jc = cfg.get("joint_conf")
    if not jc:
        return 0
    d = cfg["encoder_conf"]["output_size"]
    join = jc.get("join_dim", 2 * d)
    v = cfg["output_dim"]
    macs = t_enc * d * join + u1 * d * join
    macs += t_enc * u1 * join * v
    return macs


def context_bias_forward_macs(cfg: Dict, t_enc: int, u1: int,
                              n_ctx: int, l_ctx: int) -> int:
    """Hotword tower (extractor + bias encoder + enc/pred cross-attn +
    hw heads). Small next to the encoder/joint; counted to first order."""
    cc = cfg.get("context_conf")
    if not cc or cfg.get("context", "nobias") == "nobias":
        return 0
    d = cc.get("embedding_size", cfg["encoder_conf"]["output_size"])
    macs = 2 * _lstm_macs(n_ctx * l_ctx, d, d)           # BLSTM extractor
    macs += n_ctx * 2 * d * d                            # phrase proj
    # enc-side cross-attn + recombine; pred-side same over u1.
    for t_q in (t_enc, u1):
        macs += 2 * t_q * d * d + 2 * n_ctx * d * d
        macs += 2 * t_q * n_ctx * d
        macs += t_q * 2 * d * d                          # concat-recombine
    macs += (t_enc + u1) * d * cc.get("num_labels", 2)   # hw heads
    return macs


def forward_flops(cfg: Dict, batch: int, t_in: int, u: int,
                  n_ctx: int = 8, l_ctx: int = 4) -> Dict[str, float]:
    """Per-STEP forward model-FLOPs (2·MACs), by component."""
    u1 = u + 1
    tp = subsampled_len(t_in, cfg["encoder_conf"].get("input_layer",
                                                      "conv2d"))
    d = cfg["encoder_conf"]["output_size"]
    v = cfg["output_dim"]
    comps = {
        "encoder": encoder_forward_macs(cfg, t_in),
        "ctc_head": tp * d * v if cfg.get("model_conf", {}).get(
            "ctc_weight", 1.0) else 0,
        "aed_decoder": aed_decoder_forward_macs(cfg, tp, u1),
        "predictor": predictor_forward_macs(cfg, u1),
        "transducer_loss": transducer_loss_forward_macs(cfg, tp, u1),
        "context_bias": context_bias_forward_macs(cfg, tp, u1, n_ctx,
                                                  l_ctx),
    }
    out = {k: 2.0 * batch * m for k, m in comps.items()}
    out["total"] = sum(out.values())
    return out


def train_step_flops(cfg: Dict, batch: int, t_in: int, u: int,
                     **kw) -> float:
    """Model-FLOPs of one optimizer step: 3× forward (backward's two
    matmul families), the standard MFU numerator — rematerialised
    recompute inside custom VJPs is deliberately NOT credited."""
    return 3.0 * forward_flops(cfg, batch, t_in, u, **kw)["total"]
