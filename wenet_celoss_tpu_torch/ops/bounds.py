"""Least time an NVIDIA H100 could take for the work of each of the JAX
package's TPU kernels (a roofline bound), from shapes alone.

The bound is the larger of two times: the bytes the function must move
(each input read once, each output written once) over the card's memory
rate, and the operations it does over the card's peak rate for their
type. Peaks are the H100 SXM data sheet's (dense, 700 W).

    python -m wenet_celoss_tpu_torch.ops.bounds   # every kernel, flagship

prints one row per ``pallas_call`` of the JAX package at the flagship
shapes: the decode bench (B=64, 512 frames → T'=127 after subsampling)
for the encoder kernels' forwards, the train bench (B=256, T'=127, 32
labels → U+1=33) for the backwards and the loss and predictor kernels,
d=256, F=2048, join dim 512, vocab 5002, bf16; K1's and K6's forwards
also at the train bench's N.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12
ELT = {"bf16": 2, "fp32": 4}


def bound_ms(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def ln_ffn_residual(n: int, d: int, f: int, dtype: str):
    """K1 forward: x [N, D] in, y [N, D] out, W1/W2 [D, F], fp32 γ, β,
    b1, b2; two GEMMs of 2·N·D·F operations each."""
    e = ELT[dtype]
    return 4 * n * d * f, 2 * n * d * e + 2 * d * f * e + 4 * (3 * d + f)


def ln_ffn_residual_bwd(n: int, d: int, f: int, dtype: str):
    """K1 backward: x and dy [N, D] in, dx [N, D] out, W1/W2 [D, F] in and
    their gradients out (in the weights' dtype), fp32 γ, β, b1 in and
    dγ, dβ, db1, db2 out; the recomputed first GEMM and four gradient GEMMs
    of 2·N·D·F operations each."""
    e = ELT[dtype]
    return (10 * n * d * f,
            3 * n * d * e + 4 * d * f * e + 4 * (2 * d + f) + 4 * (3 * d + f))


def ffn_fused(n: int, d: int, f: int, dtype: str):
    """K6 forward: K1 without LN and residual (b1, b2 only)."""
    e = ELT[dtype]
    return 4 * n * d * f, 2 * n * d * e + 2 * d * f * e + 4 * (d + f)


def ffn_fused_bwd(n: int, d: int, f: int, dtype: str):
    """K6 backward: x and dy in, dx out, W1/W2 in and their gradients out,
    b1 in, db1 and db2 out; the recomputed first GEMM and four gradient
    GEMMs of 2·N·D·F each."""
    e = ELT[dtype]
    return (10 * n * d * f,
            3 * n * d * e + 4 * d * f * e + 4 * f + 4 * (d + f))


def ln_matmul(n: int, d: int, k: int, dtype: str):
    """K7 forward: (LN(x)·rowmask) W + b, x [N, D], W [D, K]."""
    e = ELT[dtype]
    return (2 * n * d * k,
            n * d * e + d * k * e + n * k * e + 4 * (2 * d + k + n))


def ln_matmul_bwd(n: int, d: int, k: int, dtype: str):
    """K7 backward: x [N, D] and dy [N, K] in, dx out; W [D, K] in, dW out
    (in W's dtype); γ, β, the row mask in; dγ, dβ, db out; two GEMMs of
    2·N·D·K (dx̂ = dy Wᵀ and dW = LN(x)ᵀ dy)."""
    e = ELT[dtype]
    return (4 * n * d * k,
            2 * n * d * e + n * k * e + 2 * d * k * e + 4 * (4 * d + k + n))


def conv_block_residual(n: int, d: int, kernel: int, dtype: str):
    """K8 forward: pointwise D→2D, depthwise K taps, pointwise D→D over
    N = B·T rows, x in and out, a row mask, the weights."""
    e = ELT[dtype]
    return (2 * n * d * (3 * d + kernel),
            2 * n * d * e + 4 * n + 3 * d * d * e + 4 * d * (kernel + 8))


def conv_block_residual_bwd(n: int, d: int, kernel: int, dtype: str):
    """K8 backward: the forward recomputed from x, then the input and
    weight gradients of each of its products (twice the forward's
    operations): three times the forward; x, dy, the row mask and the
    weights in, dx and the 10 parameter gradients out."""
    e = ELT[dtype]
    return (3 * 2 * n * d * (3 * d + kernel),
            3 * n * d * e + 4 * n + 2 * (3 * d * d * e + 4 * d * (kernel + 8)))


def alpha_beta(b: int, t: int, u1: int):
    """K9: α and β over the [B, T, U+1] lattice from the blank and emit
    log-prob planes (fp32); about 6 operations a cell a direction (two
    adds, a max, an exp, a log1p, an add)."""
    cells = b * t * u1
    return 2 * 6 * cells, 4 * cells * 4


def _joint_inputs(b: int, t: int, u1: int, h: int, v: int, e: int):
    """enc_j [B, T, H], pred_j [B, U1, H], W [V, H], bias [V] and the
    labels as int32 [B, U1 - 1] (the port's form; the TPU kernel reads a
    [B, U1, V] one-hot, which does not change the operations bound)."""
    return (b * t * h * e + b * u1 * h * e + h * v * e + 4 * v
            + 4 * b * (u1 - 1))


def joint_planes_fwd(b: int, t: int, u1: int, h: int, v: int, dtype: str):
    """K2: the [B·T·U1, H] × [H, V] joint GEMM; blank, emit and lse planes
    [B, T, U1] (fp32) out."""
    return (2 * b * t * u1 * h * v,
            _joint_inputs(b, t, u1, h, v, ELT[dtype]) + 3 * b * t * u1 * 4)


def joint_planes_bwd(b: int, t: int, u1: int, h: int, v: int, dtype: str):
    """K3: the logits recomputed, then dlogits·Wᵀ and the dW GEMM (three
    GEMMs of K2's size); K2's inputs plus the lse and two gradient planes
    in; denc, dpred, dW, db (fp32) out."""
    return (3 * 2 * b * t * u1 * h * v,
            _joint_inputs(b, t, u1, h, v, ELT[dtype]) + 3 * b * t * u1 * 4
            + 4 * (b * t * h + b * u1 * h + h * v + v))


def lstm2_seq(b: int, u1: int, h: int, dtype: str):
    """K4 forward: per step, layer 1's recurrent GEMM and layer 2's input
    and recurrent GEMMs, [B, H] × [H, 4H] each; xw1 and the three weights
    in, the top layer's outputs out. Neither bound sees the 2·U1 serial
    steps, which set the kernels' time."""
    e = ELT[dtype]
    return (3 * 2 * b * h * 4 * h * u1,
            b * u1 * 4 * h * e + 3 * h * 4 * h * e + 4 * 4 * h
            + b * u1 * h * e)


def lstm2_seq_bwd(b: int, u1: int, h: int, dtype: str):
    """K4 backward as the port runs it, from the forward's saved states:
    per step the three adjoint GEMMs (dh2, dh1 through Wi2, dh1 through
    Wh1) and, over all steps, the three weight-gradient GEMMs, [B, 4H] x
    [4H, H] each; dy, the weights and the saved states (gate
    pre-activations and cells in fp32, h and the dropped h in the compute
    dtype) in; dxw1 out in the compute dtype, the weight gradients in
    fp32. Neither bound sees the 2·U1 serial steps, which set the
    kernels' time."""
    e = ELT[dtype]
    flops = 6 * 2 * b * h * 4 * h * u1
    saved = b * u1 * (2 * 4 * h * 4 + 2 * h * 4 + 3 * h * e)
    return (flops, b * u1 * h * e + 3 * h * 4 * h * e + saved
            + b * u1 * 4 * h * e + 3 * h * 4 * h * 4 + 4 * 4 * h)


def lstm2_seq_port_bytes(b: int, u1: int, h: int, dtype: str):
    """The bytes K4's kernels move in device memory, forward (saving the
    states, as training runs it) and backward: what the bounds above
    count, plus what the port's design adds. Forward: the dropped d, the
    saved states (gate pre-activations and cells of both layers in fp32,
    the h each step read in the compute dtype) and, in bf16, layer 2's
    input pre-activations xw2 written and read in fp32 and d read by the
    xw2 GEMM. Backward: dxw1 read again and T(dz2) written and read twice
    (the gd GEMM, the weight pass) and, in bf16, gd written and read in
    fp32. The weight pass's split partials are left out. Reported beside
    the bounds, never in them."""
    e = ELT[dtype]
    rows = b * u1
    fwd = (rows * (4 * h * e + h * e + h * e + 2 * 4 * h * 4 + 2 * h * 4
                   + 2 * h * e)
           + 3 * h * 4 * h * e + 4 * 4 * h)
    saved = 2 * 4 * h * 4 + 2 * h * 4 + 2 * h * e + h * e
    bwd = (rows * (h * e + saved + 2 * 4 * h * e + 3 * 4 * h * e)
           + 3 * h * 4 * h * e + 3 * h * 4 * h * 4 + 4 * 4 * h)
    if dtype == "bf16":
        fwd += rows * (2 * 4 * h * 4 + h * e)
        bwd += rows * 2 * h * 4
    return fwd, bwd


def flagship() -> List[Dict]:
    n_dec, n_train = 64 * 127, 256 * 127
    joint = "B=256 T=127 U1=33 H=512 V=5002"
    rows = [
        ("K1 ln_ffn_residual", "ops/ffn_pallas.py:384",
         f"N={n_dec} D=256 F=2048",
         ln_ffn_residual(n_dec, 256, 2048, "bf16")),
        ("K1 ln_ffn_residual (training)", "ops/ffn_pallas.py:384",
         f"N={n_train} D=256 F=2048",
         ln_ffn_residual(n_train, 256, 2048, "bf16")),
        ("K1 ln_ffn_residual backward", "ops/ffn_pallas.py:422",
         f"N={n_train} D=256 F=2048",
         ln_ffn_residual_bwd(n_train, 256, 2048, "bf16")),
        ("K2 streaming_joint_planes_fwd", "ops/rnnt_pallas.py:369", joint,
         joint_planes_fwd(256, 127, 33, 512, 5002, "bf16")),
        ("K3 streaming_joint_planes_bwd", "ops/rnnt_pallas.py:429", joint,
         joint_planes_bwd(256, 127, 33, 512, 5002, "bf16")),
        ("K4 lstm2_seq", "ops/lstm_pallas.py:289",
         "B=256 U1=33 H=256", lstm2_seq(256, 33, 256, "bf16")),
        ("K4 lstm2_seq backward", "ops/lstm_pallas.py:327",
         "B=256 U1=33 H=256", lstm2_seq_bwd(256, 33, 256, "bf16")),
        ("K6 ffn_fused", "ops/ffn_pallas.py:170",
         f"N={n_dec} D=256 F=2048", ffn_fused(n_dec, 256, 2048, "bf16")),
        ("K6 ffn_fused (training)", "ops/ffn_pallas.py:170",
         f"N={n_train} D=256 F=2048", ffn_fused(n_train, 256, 2048, "bf16")),
        ("K6 ffn_fused backward", "ops/ffn_pallas.py:201",
         f"N={n_train} D=256 F=2048",
         ffn_fused_bwd(n_train, 256, 2048, "bf16")),
        ("K7 ln_matmul", "ops/ffn_pallas.py:559",
         f"N={n_dec} D=256 K=768 (QKV)",
         ln_matmul(n_dec, 256, 768, "bf16")),
        ("K7 ln_matmul backward", "ops/ffn_pallas.py:595",
         f"N={n_train} D=256 K=768 (QKV)",
         ln_matmul_bwd(n_train, 256, 768, "bf16")),
        ("K8 conv_block_residual", "ops/conv_pallas.py:285",
         f"N={n_dec} D=256 K=15", conv_block_residual(n_dec, 256, 15,
                                                      "bf16")),
        ("K8 conv_block_residual backward", "ops/conv_pallas.py:318",
         f"N={n_train} D=256 K=15",
         conv_block_residual_bwd(n_train, 256, 15, "bf16")),
        ("K9 alpha_beta_pallas", "ops/rnnt_pallas.py:148",
         "B=256 T=127 U1=33 fp32", alpha_beta(256, 127, 33)),
        ("K9 alpha_beta_pallas (rnnt_impl pallas)", "ops/rnnt_pallas.py:148",
         "B=64 T=127 U1=33 fp32", alpha_beta(64, 127, 33)),
    ]
    out = []
    for name, where, shape, (flops, nbytes) in rows:
        dtype = "fp32" if name.startswith("K9") else "bf16"
        ms, by = bound_ms(flops, nbytes, dtype)
        out.append({"kernel": name, "tpu_kernel": where, "shape": shape,
                    "dtype": dtype, "flops": flops, "bytes": nbytes,
                    "bound_ms": ms, "bound_by": by})
    return out


if __name__ == "__main__":
    for r in flagship():
        print(f"| {r['kernel']} | {r['tpu_kernel']} | {r['shape']} | "
              f"{r['dtype']} | {r['flops']:.4g} | {r['bytes']:.4g} | "
              f"{r['bound_ms']:.4g} ms ({r['bound_by']}) |")
