// Fused conformer convolution block for Hopper (sm_90a), forward and
// backward, with the output dropout:
//
//   y = x + drop(PW2(silu(LN2(DW(GLU(PW1(mask * LN1(x)))))))) * mask
//
// Replaces wenet_celoss_tpu/ops/conv_pallas.py::_conv_fwd_kernel and
// ::_conv_bwd_kernel (the pallas_calls of conv_block_residual). Rounding
// points are the Pallas kernels': LN1 in fp32, masked, cast to the compute
// type; PW1 and PW2 with fp32 accumulation and fp32 biases; the GLU, the
// depthwise taps, LN2 and silu in fp32, silu's output cast before PW2; the
// residual and dx summed in fp32 and cast once; dv, du cast to the compute
// type before their products, as the TPU kernel does.
//
// Padding (the module's): causal left-pads K - 1 raw frames before PW1
// (they carry GLU(bw1)); non-causal zero-pads (K - 1) / 2 hidden frames on
// each side after the GLU. With lo = K - 1 (causal) or (K - 1) / 2, output
// frame t reads the hidden of frames t - lo .. t - lo + K - 1.
//
// Dropout: the TPU seeds its on-core PRNG with seed + program id, which
// cannot be reproduced. Here a mask bit is hash32(index ^ key) with index
// (b * T + t) * D + c and the key of stream 4 (ops/dropout.py), so the
// forward, the backward and the plain version draw the same mask.
//
// What bounds it: at the flagship's shapes (D = 256, K = 15, N = B * T'
// rows) the three products are 2 * N * D * (3D + K) operations, against
// ~2 * N * D * 2 bytes: compute-bound on paper (ops/bounds.py). The TPU
// holds whole utterances in VMEM; one utterance's fp32 GLU hidden alone is
// 141 x 256 x 4 B = 144 KB, and a block has 227 KB.
//
// fp32: the first design, simple first. A block of 256 threads owns a tile of TT = 32 frames of one
// utterance and all D channels (LN2 needs whole rows after the depthwise
// conv). Forward: LN1 and PW1 run over the tile and its (K - 1)-frame
// halo (the halo's PW1 is recomputed by both neighbours), the hidden stays
// in shared memory in fp32, and the depthwise conv, LN2, silu, PW2 and the
// epilogue finish the tile. PW1 and PW2 are tile_mma.cuh's plain-FMA
// products (full fp32), B read from global memory (L2), A and C in shared
// memory. Backward: three passes and fixed-order sums (deterministic, no
// atomics):
//   A (output-frame tiles): recomputes the forward to z (halo included),
//     forms dv = drop(dy) * mask, dz = dv W2^T, dy1 = dz silu'(y1) and LN2's
//     VJP dy0; writes dy0 (fp32), z and dv (compute type) to a workspace;
//     per-block partials of dg2, db2, db_dw, dbw2.
//   B (PW1-input frame tiles, T + lp frames): recomputes LN1 and PW1 for
//     its own frames only; dh is the correlation of dy0 (read with a
//     (K - 1)-frame halo from A's workspace) with the flipped taps, dw_dw
//     the tap-shifted products of h and dy0; du = [dh s, dh a s (1 - s)],
//     dxe = du W1^T, LN1's VJP and dx = dy + dx_ln; writes LN1's output and
//     du (compute type) for pass C; partials of dg1, db1, dbw1, dw_dw.
//   C (64 x 64 output tiles x row splits): dW1 = xe^T du, dW2 = z^T dv.
//   R sums every partial in a fixed order (tile::sum_into).
//
// bf16 (namespace conv16, D = 256 and K = 15: every layer_norm conv
// module of the repo's configs), on the wgmma / TMA / cluster building
// blocks of sm90_gmma.cuh. What held the first design back: every product
// read its weights from L2 tile by tile, the halo's PW1 was computed 1.5
// times, the element-wise phases ran one block an SM in per-thread loops.
//   Forward and pass A (clu<BWD>): a cluster of 4 CTAs owns one utterance
//     at a time (persistent clusters walk the batch) and splits the hidden
//     channels: CTA c keeps W1's 64 a and 64 gate columns (64 KB) and 32 KB
//     of W2 resident in shared memory for the whole launch, so no weight
//     byte is read twice from L2 by one SM. The cluster walks the
//     utterance in steps of 128 frames: TMA brings x (as soon as the last
//     step is done with the A tile), each CTA takes LN1 of all 128 rows
//     (the A tile, K-major, 128B swizzle; the LN1 of a quarter of the rows
//     sent to the peers over DSMEM measured no faster), PW1 is one m64n128
//     wgmma chain a warpgroup, the GLU is applied on its
//     accumulator and the fp32 hidden of the CTA's channels goes to a
//     buffer that carries the last K - 1 frames to the next step: no PW1
//     row is computed twice. Non-causal output frames trail the PW1 rows
//     by (K - 1) / 2 when an utterance takes more than one step (step 0's
//     last 7 output rows are stored, then stored again by step 1). The
//     depthwise taps run per thread (one channel, 32 frames, the window in
//     registers); LN2's row statistics are each CTA's mean and centred sum
//     of squares over its 64 channels (transposing shuffle butterflies),
//     exchanged over DSMEM and combined in rank order (Chan), one cluster
//     barrier. Forward: z (bf16) goes into the A tile's chunk c and to the
//     peers by bulk DSMEM copies; PW2 (m64n64 a warpgroup) gives y's 64
//     columns of the CTA; the epilogue adds bw2, the mask, the dropout and
//     the residual (x brought by TMA into the staging tile) in fp32 and
//     leaves by a TMA store. Pass A: z goes to the workspace by TMA; dv
//     (the CTA's 64 columns of dy by TMA, masked and dropped in place) goes
//     to the workspace and to the peers, the A of dz = dv W2^T (m64n64, the
//     CTA's W2 rows K-major); LN2's VJP takes its two row sums over one
//     more DSMEM exchange; dy0 stays in an fp32 window over the A tile with
//     the previous step's last 14 frames, and dh = dy0 correlated with the
//     flipped taps (hidden frames f0 - lo ..) leaves by TMA from the hidden
//     buffer; dw_dw, db_dw, dg2, db2 and dbw2 are summed per thread over
//     the cluster's frames and written once per cluster. A split cluster
//     barrier orders the reuse of the A tile after each exchange: a CTA
//     arrives when it has its peers' chunks and waits, before the tile is
//     written again, until every peer has its own.
//   Pass B (bwd_b, 64 frames a block, all channels): LN1 (TMA store: xe for
//     pass C), PW1 again (m64n128 a and gate chains, W1 streamed through a
//     3-stage TMA ring), du = [dh s, dh a s (1 - s)] in registers (dh from
//     pass A), the du tile (TMA store for pass C) as the A of dxe = du W1^T
//     (W1's columns streamed K-major), LN1's VJP in the accumulator's
//     layout and dx by TMA store.
//   Pass C (wgrad): dW1 = xe^T du and dW2 = z^T dv in one launch, [128 x
//     256] tiles x row splits, TMA-fed m64n256 chains, partials per split.
//   The sums (sum_segs): every partial in a fixed order, one launch. The
//     same bits on every call.
//   TMA boxes never start below row 0: on the H100 a box at a negative
//     coordinate faulted. The causal padding's frames (xe = 0, hidden
//     GLU(bw1)) give dW1 nothing; pass A adds their share of dbw1.
// Weights: w1 [D, 2D], w2 [D, D] in the compute type, row-major (x @ w);
// w_dw [K, D]. Plain C interface, bound with ctypes; each launch returns
// cudaGetLastError().

#include "sm90_gmma.cuh"
#include "tile_mma.cuh"

namespace {

using tile::bf;
using tile::from_f;
using tile::to_f;
constexpr int kThreads = tile::kThreads;
constexpr int kWarps = tile::kWarps;
constexpr int TT = 32;        // frames a block owns
constexpr int kWTile = 64;    // pass C's output tile

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigm(float z) { return 1.0f / (1.0f + expf(-z)); }

// Shared-memory leading dimensions: 16 bytes of padding a row.
template <typename E> __host__ __device__ constexpr int ld_of(int cols) {
  return cols + 16 / (int)sizeof(E);
}

__host__ __device__ inline int halo_rows(int k) {
  return (TT + k - 1 + 15) / 16 * 16;
}

// Forward and pass A: XN [R][ldx] (E; pass A reuses it for dv), U
// [R][ldu] fp32 (PW1, the hidden; then PW2 or dz), Y [TT][ldy] fp32 (y0,
// then xhat2, then dy0), Z [TT][ldx] (E), rstd2 [TT].
struct FwdLayout {
  int R, ldx, ldu, ldy;
  size_t o_u, o_y, o_z, o_st, bytes;
};

template <typename E>
__host__ __device__ inline FwdLayout fwd_layout(int d, int k) {
  FwdLayout L;
  L.R = halo_rows(k);
  L.ldx = ld_of<E>(d);
  L.ldu = 2 * d + 4;
  L.ldy = d + 4;
  size_t o = tile::align128((size_t)L.R * L.ldx * sizeof(E));
  L.o_u = o;
  o += tile::align128((size_t)L.R * L.ldu * 4);
  L.o_y = o;
  o += tile::align128((size_t)TT * L.ldy * 4);
  L.o_z = o;
  o += tile::align128((size_t)TT * L.ldx * sizeof(E));
  L.o_st = o;
  o += tile::align128((size_t)TT * 4);
  L.bytes = o;
  return L;
}

// Pass B: XE [TT][ldx] (E), U [TT][ldu] fp32 (PW1; then dxe), W [W][ldy]
// fp32 (the dy0 window; then xhat1), DU [TT][lddu] (E), mu1, rstd1 [TT].
struct BLayout {
  int W, ldx, ldu, ldy, lddu;
  size_t o_u, o_w, o_du, o_st, bytes;
};

template <typename E>
__host__ __device__ inline BLayout b_layout(int d, int k) {
  BLayout L;
  L.W = TT + k - 1;
  L.ldx = ld_of<E>(d);
  L.ldu = 2 * d + 4;
  L.ldy = d + 4;
  L.lddu = ld_of<E>(2 * d);
  size_t o = tile::align128((size_t)TT * L.ldx * sizeof(E));
  L.o_u = o;
  o += tile::align128((size_t)TT * L.ldu * 4);
  L.o_w = o;
  o += tile::align128((size_t)L.W * L.ldy * 4);
  L.o_du = o;
  o += tile::align128((size_t)TT * L.lddu * sizeof(E));
  L.o_st = o;
  o += tile::align128((size_t)2 * TT * 4);
  L.bytes = o;
  return L;
}

struct Args {
  const void* x;
  const float* mask;
  const float *g1, *b1;
  const void* w1;
  const float *bw1, *wdw, *bdw, *g2, *b2;
  const void* w2;
  const float* bw2;
  int B, T, D, K, causal, lo, lp;
  float eps;
  tile::Drop dp;
};

// mean and 1/sqrt(var + eps) of one row (warp-collective).
template <typename E>
__device__ __forceinline__ void row_stats(const E* xr, int d, float eps,
                                          float* mu, float* rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  for (int c = lane; c < d; c += 32) s += to_f(xr[c]);
  const float m = warp_sum(s) / d;
  float v = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float xc = to_f(xr[c]) - m;
    v += xc * xc;
  }
  *mu = m;
  *rstd = rsqrtf(warp_sum(v) / d + eps);
}

// The forward through silu for output frames t0 .. t0 + TT - 1 of row b:
// XN, PW1, GLU (the hidden in U's first D columns), the depthwise conv into
// Y, LN2 and silu into Z; with keep_xhat, Y keeps xhat2 and rstd2 is kept.
template <typename E>
__device__ void front(const Args& a, const FwdLayout& L, unsigned char* smem,
                      int b, int t0, bool keep_xhat) {
  E* xn = reinterpret_cast<E*>(smem);
  float* u = reinterpret_cast<float*>(smem + L.o_u);
  float* y = reinterpret_cast<float*>(smem + L.o_y);
  E* z = reinterpret_cast<E*>(smem + L.o_z);
  float* rstd2 = reinterpret_cast<float*>(smem + L.o_st);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int d = a.D, T = a.T;
  const E* x = static_cast<const E*>(a.x);

  // LN1 over the tile and its halo; zero outside [0, T) and past the halo.
  for (int r = warp; r < L.R; r += kWarps) {
    const int tau = t0 - a.lo + r;
    E* out = xn + (size_t)r * L.ldx;
    if (tau < 0 || tau >= T || r >= TT + a.K - 1) {
      for (int c = lane; c < d; c += 32) out[c] = from_f<E>(0.0f);
      continue;
    }
    const E* xr = x + ((size_t)b * T + tau) * d;
    float mu, rs;
    row_stats(xr, d, a.eps, &mu, &rs);
    const float m = a.mask[(size_t)b * T + tau];
    for (int c = lane; c < d; c += 32)
      out[c] = from_f<E>(((to_f(xr[c]) - mu) * rs * a.g1[c] + a.b1[c]) * m);
  }
  __syncthreads();
  tile::mma_acc<true, true, false>(u, L.ldu, xn, L.ldx,
                                   static_cast<const E*>(a.w1), 2 * d, L.R,
                                   2 * d, d);
  __syncthreads();
  // GLU with the bias; zero hidden outside the signal (non-causal pad) and
  // past T (never read by a stored output).
  for (int i = tid; i < L.R * d; i += kThreads) {
    const int r = i / d, c = i % d, tau = t0 - a.lo + r;
    float h = 0.0f;
    if (tau < T && (tau >= 0 || a.causal))
      h = (u[r * L.ldu + c] + a.bw1[c]) *
          sigm(u[r * L.ldu + d + c] + a.bw1[d + c]);
    u[r * L.ldu + c] = h;
  }
  __syncthreads();
  // Depthwise taps in tap order, then the bias.
  for (int c = tid; c < d; c += kThreads) {
    float acc[TT];
    const float w0 = a.wdw[c];
#pragma unroll
    for (int i = 0; i < TT; ++i) acc[i] = u[i * L.ldu + c] * w0;
    for (int k = 1; k < a.K; ++k) {
      const float w = a.wdw[(size_t)k * d + c];
#pragma unroll
      for (int i = 0; i < TT; ++i) acc[i] = acc[i] + u[(i + k) * L.ldu + c] * w;
    }
    const float bias = a.bdw[c];
#pragma unroll
    for (int i = 0; i < TT; ++i) y[i * L.ldy + c] = acc[i] + bias;
  }
  __syncthreads();
  // LN2 and silu.
  for (int r = warp; r < TT; r += kWarps) {
    float* yr = y + r * L.ldy;
    float mu, rs;
    row_stats(yr, d, a.eps, &mu, &rs);
    for (int c = lane; c < d; c += 32) {
      const float xh = (yr[c] - mu) * rs;
      const float y1 = xh * a.g2[c] + a.b2[c];
      z[r * L.ldx + c] = from_f<E>(y1 * sigm(y1));
      if (keep_xhat) yr[c] = xh;
    }
    if (keep_xhat && lane == 0) rstd2[r] = rs;
  }
  __syncthreads();
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
conv_fwd(Args a, int tiles, E* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L = fwd_layout<E>(a.D, a.K);
  const int b = blockIdx.x / tiles, t0 = (blockIdx.x % tiles) * TT;
  front<E>(a, L, smem, b, t0, false);
  float* v = reinterpret_cast<float*>(smem + L.o_u);
  const E* z = reinterpret_cast<const E*>(smem + L.o_z);
  const int d = a.D, T = a.T;
  tile::mma_acc<true, true, false>(v, L.ldy, z, L.ldx,
                                   static_cast<const E*>(a.w2), d, TT, d, d);
  __syncthreads();
  const E* x = static_cast<const E*>(a.x);
  for (int i = threadIdx.x; i < TT * d; i += kThreads) {
    const int r = i / d, c = i % d, t = t0 + r;
    if (t >= T) continue;
    const size_t row = (size_t)b * T + t;
    const float vv = (v[r * L.ldy + c] + a.bw2[c]) * a.mask[row];
    const float kept = tile::drop(a.dp, (uint32_t)(row * d + c), vv);
    out[row * d + c] = from_f<E>(to_f(x[row * d + c]) + kept);
  }
}

// Pass A. Workspace rows are [B][Tp] (Tp = tiles * TT); rows past T hold 0.
template <typename E>
__global__ void __launch_bounds__(kThreads)
conv_bwd_a(Args a, int tiles, const E* __restrict__ dy,
           float* __restrict__ dy0g, E* __restrict__ zg, E* __restrict__ dvg,
           float* __restrict__ dg2p, float* __restrict__ db2p,
           float* __restrict__ dbdwp, float* __restrict__ dbw2p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L = fwd_layout<E>(a.D, a.K);
  const int b = blockIdx.x / tiles, t0 = (blockIdx.x % tiles) * TT;
  front<E>(a, L, smem, b, t0, true);
  E* dv = reinterpret_cast<E*>(smem);                // over XN
  float* dz = reinterpret_cast<float*>(smem + L.o_u);
  float* y = reinterpret_cast<float*>(smem + L.o_y);   // xhat2
  const E* z = reinterpret_cast<const E*>(smem + L.o_z);
  const float* rstd2 = reinterpret_cast<const float*>(smem + L.o_st);
  const int d = a.D, T = a.T, tid = threadIdx.x;
  const size_t part = (size_t)blockIdx.x * d;
  const size_t wrow = (size_t)b * tiles * TT + t0;     // workspace row of r=0

  // dv = drop(dy) * mask; its fp32 column sums are dbw2.
  for (int c = tid; c < d; c += kThreads) {
    float s = 0.0f;
    for (int r = 0; r < TT; ++r) {
      const int t = t0 + r;
      float v = 0.0f;
      if (t < T) {
        const size_t row = (size_t)b * T + t;
        v = tile::drop(a.dp, (uint32_t)(row * d + c), to_f(dy[row * d + c])) *
            a.mask[row];
      }
      s += v;
      const E ve = from_f<E>(v);
      dv[r * L.ldx + c] = ve;
      dvg[(wrow + r) * d + c] = ve;
      zg[(wrow + r) * d + c] = t < T ? z[r * L.ldx + c] : from_f<E>(0.0f);
    }
    dbw2p[part + c] = s;
  }
  __syncthreads();
  // dz = dv W2^T (B(k=j, n=i) = W2[i][j]: column-major).
  tile::mma_acc<true, false, false>(dz, L.ldy, dv, L.ldx,
                                    static_cast<const E*>(a.w2), d, TT, d, d);
  __syncthreads();
  // dy1 = dz silu'(y1) in place; dg2 and db2 column sums.
  for (int c = tid; c < d; c += kThreads) {
    float sg = 0.0f, sb = 0.0f;
    for (int r = 0; r < TT; ++r) {
      const float xh = y[r * L.ldy + c];
      const float y1 = xh * a.g2[c] + a.b2[c];
      const float s = sigm(y1);
      const float d1 = dz[r * L.ldy + c] * (s * (1.0f + y1 * (1.0f - s)));
      dz[r * L.ldy + c] = d1;
      sg += d1 * xh;
      sb += d1;
    }
    dg2p[part + c] = sg;
    db2p[part + c] = sb;
  }
  __syncthreads();
  // LN2's VJP per row: dy0 replaces xhat2 in Y.
  const int warp = tid / 32, lane = tid & 31;
  for (int r = warp; r < TT; r += kWarps) {
    float* yr = y + r * L.ldy;
    const float* dr = dz + r * L.ldy;
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float dxh = dr[c] * a.g2[c];
      s1 += dxh;
      s2 += dxh * yr[c];
    }
    const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
    const float rs = rstd2[r];
    for (int c = lane; c < d; c += 32) {
      const float dxh = dr[c] * a.g2[c];
      yr[c] = rs * (dxh - m1 - yr[c] * m2);
    }
  }
  __syncthreads();
  for (int c = tid; c < d; c += kThreads) {
    float s = 0.0f;
    for (int r = 0; r < TT; ++r) {
      const float v = t0 + r < T ? y[r * L.ldy + c] : 0.0f;
      s += v;
      dy0g[(wrow + r) * d + c] = v;
    }
    dbdwp[part + c] = s;
  }
}

// Pass B over PW1-input frames e = e0 .. e0 + TT - 1 (frame tau = e - lp);
// workspace rows [B][Tep] (Tep = tiles * TT); rows past T + lp hold 0.
template <typename E>
__global__ void __launch_bounds__(kThreads)
conv_bwd_b(Args a, int tiles, int tiles_a, const E* __restrict__ dy,
           const float* __restrict__ dy0g, E* __restrict__ dx,
           E* __restrict__ xeg, E* __restrict__ dug, float* __restrict__ dg1p,
           float* __restrict__ db1p, float* __restrict__ dbw1p,
           float* __restrict__ dwdwp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BLayout L = b_layout<E>(a.D, a.K);
  E* xe = reinterpret_cast<E*>(smem);
  float* u = reinterpret_cast<float*>(smem + L.o_u);
  float* win = reinterpret_cast<float*>(smem + L.o_w);
  E* du = reinterpret_cast<E*>(smem + L.o_du);
  float* mu1 = reinterpret_cast<float*>(smem + L.o_st);
  float* rstd1 = mu1 + TT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int d = a.D, T = a.T, K = a.K, text = T + a.lp;
  const int b = blockIdx.x / tiles, e0 = (blockIdx.x % tiles) * TT;
  const int tau0 = e0 - a.lp;
  const size_t wrow = (size_t)b * tiles * TT + e0;
  const size_t rows_a = (size_t)b * tiles_a * TT;   // dy0's row of t = 0
  const E* x = static_cast<const E*>(a.x);

  // LN1 of this tile's frames (0 for the causal pad and past T + lp).
  for (int r = warp; r < TT; r += kWarps) {
    const int tau = tau0 + r;
    E* out = xe + (size_t)r * L.ldx;
    if (tau < 0 || tau >= T) {
      for (int c = lane; c < d; c += 32) {
        out[c] = from_f<E>(0.0f);
        xeg[(wrow + r) * d + c] = out[c];
      }
      continue;
    }
    const E* xr = x + ((size_t)b * T + tau) * d;
    float mu, rs;
    row_stats(xr, d, a.eps, &mu, &rs);
    if (lane == 0) {
      mu1[r] = mu;
      rstd1[r] = rs;
    }
    const float m = a.mask[(size_t)b * T + tau];
    for (int c = lane; c < d; c += 32) {
      out[c] = from_f<E>(((to_f(xr[c]) - mu) * rs * a.g1[c] + a.b1[c]) * m);
      xeg[(wrow + r) * d + c] = out[c];
    }
  }
  // The dy0 window: t = tau0 + lo - (K - 1) + w.
  const int tw = tau0 + a.lo - (K - 1);
  for (int i = tid; i < L.W * d; i += kThreads) {
    const int w = i / d, c = i % d, t = tw + w;
    win[w * L.ldy + c] = t >= 0 && t < T ? dy0g[(rows_a + t) * d + c] : 0.0f;
  }
  __syncthreads();
  tile::mma_acc<true, true, false>(u, L.ldu, xe, L.ldx,
                                   static_cast<const E*>(a.w1), 2 * d, TT,
                                   2 * d, d);
  __syncthreads();
  // dh (flipped taps, tap K - 1 first as the TPU sums), dw_dw, du, dbw1.
  const size_t pblk = blockIdx.x;
  for (int c = tid; c < d; c += kThreads) {
    float h[TT], dh[TT];
#pragma unroll
    for (int r = 0; r < TT; ++r) {
      const float av = u[r * L.ldu + c] + a.bw1[c];
      const float sv = sigm(u[r * L.ldu + d + c] + a.bw1[d + c]);
      h[r] = e0 + r < text ? av * sv : 0.0f;
      dh[r] = 0.0f;
    }
    for (int k = K - 1; k >= 0; --k) {
      const float w = a.wdw[(size_t)k * d + c];
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < TT; ++r) {
        const float g = win[(r + K - 1 - k) * L.ldy + c];
        dh[r] = dh[r] + g * w;
        s += h[r] * g;
      }
      dwdwp[(pblk * K + k) * d + c] = s;
    }
    float sa = 0.0f, sg = 0.0f;
#pragma unroll
    for (int r = 0; r < TT; ++r) {
      const float av = u[r * L.ldu + c] + a.bw1[c];
      const float sv = sigm(u[r * L.ldu + d + c] + a.bw1[d + c]);
      const float g = e0 + r < text ? dh[r] : 0.0f;
      const float da = g * sv;
      const float dg = g * av * sv * (1.0f - sv);
      sa += da;
      sg += dg;
      const E dae = from_f<E>(da), dge = from_f<E>(dg);
      du[r * L.lddu + c] = dae;
      du[r * L.lddu + d + c] = dge;
      dug[(wrow + r) * 2 * d + c] = dae;
      dug[(wrow + r) * 2 * d + d + c] = dge;
    }
    dbw1p[pblk * 2 * d + c] = sa;
    dbw1p[pblk * 2 * d + d + c] = sg;
  }
  __syncthreads();
  // dxe = du W1^T (B(k=j, n=c) = W1[c][j]: column-major) over U.
  float* dxe = u;
  tile::mma_acc<true, false, false>(dxe, L.ldy, du, L.lddu,
                                    static_cast<const E*>(a.w1), 2 * d, TT, d,
                                    2 * d);
  __syncthreads();
  // LN1's VJP per row; dx = dy + dx_ln. win keeps xhat1, dxe keeps dxn.
  float* xh1 = win;
  for (int r = warp; r < TT; r += kWarps) {
    const int tau = tau0 + r;
    float* xr1 = xh1 + r * L.ldy;
    float* dr = dxe + r * L.ldy;
    if (tau < 0 || tau >= T) {
      for (int c = lane; c < d; c += 32) xr1[c] = dr[c] = 0.0f;
      continue;
    }
    const size_t row = (size_t)b * T + tau;
    const float m = a.mask[row], mu = mu1[r], rs = rstd1[r];
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float xh = (to_f(x[row * d + c]) - mu) * rs;
      const float dxn = dr[c] * m;
      xr1[c] = xh;
      dr[c] = dxn;
      const float dxh = dxn * a.g1[c];
      s1 += dxh;
      s2 += dxh * xh;
    }
    const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
    for (int c = lane; c < d; c += 32) {
      const float dxh = dr[c] * a.g1[c];
      dx[row * d + c] = from_f<E>(to_f(dy[row * d + c]) +
                                  rs * (dxh - m1 - xr1[c] * m2));
    }
  }
  __syncthreads();
  for (int c = tid; c < d; c += kThreads) {
    float sg = 0.0f, sb = 0.0f;
    for (int r = 0; r < TT; ++r) {
      sg += dxe[r * L.ldy + c] * xh1[r * L.ldy + c];
      sb += dxe[r * L.ldy + c];
    }
    dg1p[pblk * d + c] = sg;
    db1p[pblk * d + c] = sb;
  }
}

// Pass C: part[split][M][N] = A^T B over the split's rows, A [rows][M] and
// B [rows][N] row-major, one 64 x 64 tile a block.
__global__ void __launch_bounds__(kThreads)
wgrad_f32(const float* __restrict__ A, const float* __restrict__ Bm,
          float* __restrict__ part, int M, int N, int rows, int per) {
  __shared__ __align__(16) float c[kWTile * kWTile];
  const int tn = N / kWTile;
  const int i0 = (blockIdx.x / tn) * kWTile, j0 = (blockIdx.x % tn) * kWTile;
  const int r0 = blockIdx.y * per, r1 = min(rows, r0 + per);
  tile::mma_acc<false, true, false>(c, kWTile, A + (size_t)r0 * M + i0, M,
                                    Bm + (size_t)r0 * N + j0, N, kWTile,
                                    kWTile, r1 > r0 ? r1 - r0 : 0);
  __syncthreads();
  float* out = part + (size_t)blockIdx.y * M * N;
  for (int i = threadIdx.x; i < kWTile * kWTile; i += kThreads)
    out[(size_t)(i0 + i / kWTile) * N + j0 + i % kWTile] = c[i];
}

// Row splits of pass C: about two blocks an SM, each split a multiple of
// 16 rows.
inline int split_rows(int rows, int tiles) {
  int s = (2 * 132 + tiles - 1) / tiles;
  if (s < 1) s = 1;
  int per = (rows + s - 1) / s;
  per = (per + 15) / 16 * 16;
  return per < 16 ? 16 : per;
}

cudaError_t wgrad(const float* A, const float* Bm, float* part, float* out,
                  int M, int N, int rows, cudaStream_t s) {
  const int tiles = (M / kWTile) * (N / kWTile);
  const int per = split_rows(rows, tiles);
  const int splits = (rows + per - 1) / per;
  wgrad_f32<<<dim3(tiles, splits), kThreads, 0, s>>>(A, Bm, part, M, N, rows,
                                                      per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return tile::sum_into(part, out, 1, splits, M * N, s);
}

inline int wgrad_splits(int M, int N, int rows) {
  const int per = split_rows(rows, (M / kWTile) * (N / kWTile));
  return (rows + per - 1) / per;
}

// The backward's workspace, carved in this order (256-byte aligned).
struct Work {
  size_t dy0, z, dv, xe, du, pa, pb, pw1, pw2, bytes;
  int tiles_a, tiles_b;
};

inline size_t al256(size_t b) { return (b + 255) / 256 * 256; }

template <typename E>
Work work_of(int B, int T, int D, int K, int lp) {
  Work w;
  w.tiles_a = (T + TT - 1) / TT;
  w.tiles_b = (T + lp + TT - 1) / TT;
  const size_t ra = (size_t)B * w.tiles_a * TT, rb = (size_t)B * w.tiles_b * TT;
  const size_t na = (size_t)B * w.tiles_a, nb = (size_t)B * w.tiles_b;
  size_t o = 0;
  w.dy0 = o; o += al256(ra * D * 4);
  w.z = o;   o += al256(ra * D * sizeof(E));
  w.dv = o;  o += al256(ra * D * sizeof(E));
  w.xe = o;  o += al256(rb * D * sizeof(E));
  w.du = o;  o += al256(rb * 2 * D * sizeof(E));
  w.pa = o;  o += al256(4 * na * D * 4);                  // dg2 db2 dbdw dbw2
  w.pb = o;  o += al256(nb * (size_t)D * (4 + K) * 4);     // dg1 db1 dbw1 dwdw
  w.pw1 = o; o += al256((size_t)wgrad_splits(D, 2 * D, (int)rb) * 2 * D * D * 4);
  w.pw2 = o; o += al256((size_t)wgrad_splits(D, D, (int)ra) * D * D * 4);
  w.bytes = o;
  return w;
}

template <typename E> bool fits(int D, int K) {
  return fwd_layout<E>(D, K).bytes <= tile::kMaxSmem &&
         b_layout<E>(D, K).bytes <= tile::kMaxSmem;
}

Args make_args(const void* x, const void* mask, const void* g1,
               const void* b1, const void* w1, const void* bw1,
               const void* wdw, const void* bdw, const void* g2,
               const void* b2, const void* w2, const void* bw2, int B, int T,
               int D, int K, int causal, float eps, unsigned key, int thresh,
               float scale, unsigned row_base) {
  Args a;
  a.x = x;
  a.mask = static_cast<const float*>(mask);
  a.g1 = static_cast<const float*>(g1);
  a.b1 = static_cast<const float*>(b1);
  a.w1 = w1;
  a.bw1 = static_cast<const float*>(bw1);
  a.wdw = static_cast<const float*>(wdw);
  a.bdw = static_cast<const float*>(bdw);
  a.g2 = static_cast<const float*>(g2);
  a.b2 = static_cast<const float*>(b2);
  a.w2 = w2;
  a.bw2 = static_cast<const float*>(bw2);
  a.B = B;
  a.T = T;
  a.D = D;
  a.K = K;
  a.causal = causal;
  a.lo = causal ? K - 1 : (K - 1) / 2;
  a.lp = causal ? K - 1 : 0;
  a.eps = eps;
  // A process's rows start at row_base of the step's whole batch.
  a.dp = tile::make_drop(key, thresh, scale, row_base * (unsigned)T * D);
  return a;
}

template <typename E>
cudaError_t fwd(const Args& a, void* y, cudaStream_t s) {
  const size_t bytes = fwd_layout<E>(a.D, a.K).bytes;
  cudaError_t e = tile::set_smem(conv_fwd<E>, bytes);
  if (e != cudaSuccess) return e;
  const int tiles = (a.T + TT - 1) / TT;
  conv_fwd<E><<<a.B * tiles, kThreads, bytes, s>>>(a, tiles,
                                                   static_cast<E*>(y));
  return cudaGetLastError();
}

template <typename E>
cudaError_t bwd(const Args& a, const void* dy, void* dx, float* const* g,
                unsigned char* ws, cudaStream_t s) {
  const int D = a.D, K = a.K;
  const Work w = work_of<E>(a.B, a.T, D, K, a.lp);
  float* dy0 = reinterpret_cast<float*>(ws + w.dy0);
  E* z = reinterpret_cast<E*>(ws + w.z);
  E* dv = reinterpret_cast<E*>(ws + w.dv);
  E* xe = reinterpret_cast<E*>(ws + w.xe);
  E* du = reinterpret_cast<E*>(ws + w.du);
  const size_t na = (size_t)a.B * w.tiles_a, nb = (size_t)a.B * w.tiles_b;
  float* pa = reinterpret_cast<float*>(ws + w.pa);
  float* pb = reinterpret_cast<float*>(ws + w.pb);
  // g: dg1, db1, dw1, dbw1, dwdw, dbdw, dg2, db2, dw2, dbw2.
  const size_t abytes = fwd_layout<E>(D, K).bytes;
  const size_t bbytes = b_layout<E>(D, K).bytes;
  cudaError_t e;
  if ((e = tile::set_smem(conv_bwd_a<E>, abytes)) != cudaSuccess) return e;
  if ((e = tile::set_smem(conv_bwd_b<E>, bbytes)) != cudaSuccess) return e;
  conv_bwd_a<E><<<(unsigned)na, kThreads, abytes, s>>>(
      a, w.tiles_a, static_cast<const E*>(dy), dy0, z, dv, pa, pa + na * D,
      pa + 2 * na * D, pa + 3 * na * D);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  conv_bwd_b<E><<<(unsigned)nb, kThreads, bbytes, s>>>(
      a, w.tiles_b, w.tiles_a, static_cast<const E*>(dy), dy0,
      static_cast<E*>(dx), xe, du, pb, pb + nb * D, pb + 2 * nb * D,
      pb + 4 * nb * D);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = wgrad(xe, du, reinterpret_cast<float*>(ws + w.pw1), g[2], D,
                    2 * D, (int)(nb * TT), s)) != cudaSuccess)
    return e;
  if ((e = wgrad(z, dv, reinterpret_cast<float*>(ws + w.pw2), g[8], D, D,
                    (int)(na * TT), s)) != cudaSuccess)
    return e;
  const int n_a = (int)na, n_b = (int)nb;
  if ((e = tile::sum_into(pa, g[6], 1, n_a, D, s)) != cudaSuccess) return e;
  if ((e = tile::sum_into(pa + na * D, g[7], 1, n_a, D, s)) != cudaSuccess)
    return e;
  if ((e = tile::sum_into(pa + 2 * na * D, g[5], 1, n_a, D, s)) != cudaSuccess)
    return e;
  if ((e = tile::sum_into(pa + 3 * na * D, g[9], 1, n_a, D, s)) != cudaSuccess)
    return e;
  if ((e = tile::sum_into(pb, g[0], 1, n_b, D, s)) != cudaSuccess) return e;
  if ((e = tile::sum_into(pb + nb * D, g[1], 1, n_b, D, s)) != cudaSuccess)
    return e;
  if ((e = tile::sum_into(pb + 2 * nb * D, g[3], 1, n_b, 2 * D, s)) !=
      cudaSuccess)
    return e;
  return tile::sum_into(pb + 4 * nb * D, g[4], 1, n_b, K * D, s);
}

bool shape_ok(int D, int K, int causal) {
  return D > 0 && D % kWTile == 0 && K >= 1 && K <= 31 && (causal || K % 2);
}

// ------------------------------------------------------------ bf16 ---
namespace conv16 {

using namespace sm90;
using tile::Drop;

constexpr int D = 256;        // channels
constexpr int KW = 15;        // depthwise taps
constexpr int CL = 4;         // CTAs of a cluster
constexpr int CH = D / CL;    // hidden channels of a CTA
constexpr int TM = 128;       // frames of a step
constexpr int NT = 256;       // threads of a block (two warpgroups)
constexpr int HR = 152;       // rows of the hidden buffer
constexpr int WRW = 160;      // rows of pass A's dy0 / dh window
constexpr int DHR = 144;      // dh rows a step computes, 36 a thread
constexpr int RB = 64;        // pass B: PW1-input frames of a block
constexpr int RC = 64;        // pass C: rows of a chunk
constexpr int DH_PAD = 16;     // rows of dh's workspace before frame 0
constexpr int B_STAGES = 3;
constexpr int C_STAGES = 4;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ float sig(float z) {
  return __fdividef(1.0f, 1.0f + __expf(-z));
}

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// Byte offset of bf16 element (r, c) in a K-major 128B-swizzled tile of
// `rows` rows stored as [cols / 64][rows][64], the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B (the region starts on 1024 bytes).
__host__ __device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  const int cc = c & 63;
  return (uint32_t)((c >> 6) * rows * 128 + r * 128 +
                    (((cc >> 3) ^ (r & 7)) << 4) + (cc & 7) * 2);
}

// Byte offset of fp32 element (r, c), c < 64, in a [2][rows][32] buffer
// with the same 128-byte swizzle (TMA's for fp32 boxes 32 wide). Both the
// accumulator's layout (a float2 of 8 rows x 4 column pairs a warp) and a
// warp reading 32 channels of one row touch distinct banks.
__device__ __forceinline__ uint32_t swf(int rows, int r, int c) {
  return (uint32_t)((c >> 5) * rows * 128 + r * 128 +
                    ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4);
}

// One butterfly level over lane bit B: the lanes with the bit set keep
// values W .. 2W - 1, the others 0 .. W - 1, each added to its partner's.
// The levels are separate instances, so every index is a constant and v
// stays in registers (a loop over the levels left it in local memory).
template <int W, int B, int N>
__device__ __forceinline__ void fold(float (&v)[N], int lane) {
  const bool up = lane & B;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float keep = up ? v[i + W] : v[i];
    const float give = up ? v[i] : v[i + W];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, give, B);
  }
}

// v[j], j < 32, summed over the warp's lanes: lane l returns row l's sum
// (a transposing butterfly, 31 shuffles, the same order every call). v is
// consumed.
__device__ __forceinline__ float lane_rows_sum(float (&v)[32], int lane) {
  fold<16, 16>(v, lane);
  fold<8, 8>(v, lane);
  fold<4, 4>(v, lane);
  fold<2, 2>(v, lane);
  fold<1, 1>(v, lane);
  return v[0];
}

// The same over lane bits 4, 3, 2 for 64 values: lane l keeps the sums of
// values 32 b4 + 16 b3 + 8 b2 + i, i < 8 (b the bits of l) over the 8
// lanes that share l % 4, in v[0 .. 7].
__device__ __forceinline__ void lane_cols_sum(float (&v)[64], int lane) {
  fold<32, 16>(v, lane);
  fold<16, 8>(v, lane);
  fold<8, 4>(v, lane);
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.0f;
}

struct Par {
  const float *mask, *g1, *b1, *bw1, *wdw, *bdw, *g2, *b2, *bw2;
  int B, T, lo, r0, lp, lag, steps;
  float eps;
  Drop dp;
};

// LN1(x) * mask in place over the [4][ROWS][64] tile of frames t0 ..
// t0 + ROWS - 1 of utterance b: warp `wid` of 8 takes rows wid, wid + 8, ..,
// a lane 8 consecutive columns; two-pass statistics in fp32, the mask (0
// outside [0, T)), one bf16 cast. With mu / rstd, each row's statistics
// are kept.
template <int ROWS>
__device__ __forceinline__ void ln1_rows(unsigned char* xt, int wid,
                                         int lane, int b, int t0,
                                         const Par& p, float* mu,
                                         float* rstd) {
  const int c = 8 * lane;
  float gv[8], bv[8];
#pragma unroll
  for (int j = 0; j < 8; j += 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p.g1 + c + j));
    const float4 s = __ldg(reinterpret_cast<const float4*>(p.b1 + c + j));
    gv[j] = q.x; gv[j + 1] = q.y; gv[j + 2] = q.z; gv[j + 3] = q.w;
    bv[j] = s.x; bv[j + 1] = s.y; bv[j + 2] = s.z; bv[j + 3] = s.w;
  }
  // The mask of the warp's rows, lane k holding row wid + 8 k's, loaded
  // together (one row at a time, each load's latency stalled the loop).
  float mk_l = 0.0f;
  if (lane < ROWS / 8) {
    const int t = t0 + wid + 8 * lane;
    if (t >= 0 && t < p.T) mk_l = __ldg(p.mask + (size_t)b * p.T + t);
  }
  // Four rows at a time: their shuffle chains interleave (one row at a
  // time, each chain's latency stalled the warp).
#pragma unroll 4
  for (int k = 0; k < ROWS / 8; ++k) {
    const int r = wid + 8 * k;
    const float mk = __shfl_sync(0xffffffffu, mk_l, k);
    uint4* slot = reinterpret_cast<uint4*>(xt + swz(ROWS, r, c));
    const uint4 q = *slot;
    const uint32_t in[4] = {q.x, q.y, q.z, q.w};
    float v[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = unpack_bf16(in[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s += v[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float m = s / D;
    float var = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) var += (v[j] - m) * (v[j] - m);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      var += __shfl_xor_sync(0xffffffffu, var, o);
    const float rs = rsqrtf(var / D + p.eps);
    uint32_t out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[j] = pack_bf16(((v[2 * j] - m) * rs * gv[2 * j] + bv[2 * j]) * mk,
                         ((v[2 * j + 1] - m) * rs * gv[2 * j + 1] +
                          bv[2 * j + 1]) * mk);
    *slot = make_uint4(out[0], out[1], out[2], out[3]);
    if (mu != nullptr && lane == 0) {
      mu[r] = m;
      rstd[r] = rs;
    }
  }
}

// ------------------------------------------------- the cluster kernel ---
// Shared memory of the forward and pass A (byte offsets from a 1024-aligned
// base): the A tile ([4][128][64] bf16: LN1(x), then z (forward) or dv
// (pass A), then pass A's fp32 window [2][160][32]); W1's columns of the
// CTA's a and gate channels ([2][256][64], the MN-major B of PW1); 32 KB
// of W2 (forward: its columns [256][64], MN-major; pass A: its rows
// [4][64][64], K-major); the fp32 hidden [2][152][32]; a [128][64] bf16
// tile (forward: x, then y; pass A: z); pass A's dy0 carry; the two row
// statistics exchanges [4][128] float2 (STAT2 also holds the forward's
// and pass A's first in-CTA row sums, STAT pass A's second); barriers.
struct L {
  static constexpr uint32_t AT = 0;
  static constexpr uint32_t W1S = 65536;
  static constexpr uint32_t W2S = 131072;
  static constexpr uint32_t HB = 163840;
  static constexpr uint32_t ST = HB + 2 * HR * 128;
  static constexpr uint32_t CARRY = ST + TM * CH * 2;
  static constexpr uint32_t STAT = CARRY + 2 * (KW - 1) * 128;
  static constexpr uint32_t STAT2 = STAT + CL * TM * 8;
  static constexpr uint32_t BAR = STAT2 + CL * TM * 8;
  static constexpr uint32_t BYTES = BAR + 64;
};
static_assert(L::ST % 1024 == 0, "the staging tile is a TMA box");
static_assert(L::BYTES + 1024 <= tile::kMaxSmem, "shared memory");

// One utterance at a time per cluster of CL CTAs; CTA c owns hidden
// channels [64 c, 64 c + 64) (W1's and W2's slices stay resident) and walks
// the utterance in steps of 128 frames: PW1 of frames t0 .. t0 + 127 (none
// on a last step past T), the depthwise taps and LN2 for output frames f0
// = t0 - lag .. (f0 = 0 on step 0), so that every tap's hidden frame of
// the step's own frames f0 .. f1 - 1 is known (computed, or padding), the
// hidden of the last K - 1 frames carried to the next step.
// BWD = false: z is exchanged through DSMEM, PW2 and the epilogue give y's
// columns [64 c, 64 c + 64). BWD = true (pass A): dv, dz = dv W2^T, LN2's
// VJP, dy0, dw_dw, db_dw, and dh (the correlation of dy0 with the taps)
// for hidden frames f0 - lo ..; z, dv's columns and dh go to the
// workspace.
template <bool BWD>
__global__ void __launch_bounds__(NT, 1)
clu(const __grid_constant__ CUtensorMap x_map,
    const __grid_constant__ CUtensorMap w1_map,
    const __grid_constant__ CUtensorMap w2_map,
    const __grid_constant__ CUtensorMap io_map,
    const __grid_constant__ CUtensorMap z_map,
    const __grid_constant__ CUtensorMap dv_map,
    const __grid_constant__ CUtensorMap dh_map,
    const __grid_constant__ CUtensorMap dh16_map, const Par p,
    float* __restrict__ part, float* __restrict__ part_bw2,
    float* __restrict__ part_bw1) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t wbar = base + L::BAR, xbar = wbar + 8, obar = wbar + 16,
                 zbar = wbar + 24;
  const int c = (int)cluster_rank();
  const int tid = threadIdx.x, lane = tid & 31;
  const int wid = warp_uniform(tid / 32);
  const int wg = wid / 4, wq = wid % 4;
  const int ch = tid & 63, rg = tid >> 6, half = (tid >> 5) & 1;
  const int gch = c * CH + ch;
  const int T = p.T;
  const int rl = 64 * wg + 16 * wq + lane / 4;   // accumulator rows rl, rl + 8
  if (tid == 0) {
    mbar_init(wbar, 1);
    mbar_init(xbar, 1);
    mbar_init(obar, 1);
    mbar_init(zbar, 1);
    mbar_init_fence();
    mbar_expect_tx(wbar, 3 * 32768);
    tma_load_2d(base + L::W1S, &w1_map, wbar, c * CH, 0);
    tma_load_2d(base + L::W1S + 32768, &w1_map, wbar, D + c * CH, 0);
    if constexpr (!BWD)
      tma_load_2d(base + L::W2S, &w2_map, wbar, c * CH, 0);
    else
      for (int j = 0; j < 4; ++j)
        tma_load_2d(base + L::W2S + j * 8192, &w2_map, wbar, 64 * j, c * CH);
  }
  float wk[KW];
#pragma unroll
  for (int k = 0; k < KW; ++k) wk[k] = __ldg(p.wdw + k * D + gch);
  const float bdw = __ldg(p.bdw + gch), g2 = __ldg(p.g2 + gch),
              b2 = __ldg(p.b2 + gch);
  // The hidden before the signal: GLU(bw1) (causal), 0 (zero padding).
  const float hpad = p.lp ? __ldg(p.bw1 + gch) * sig(__ldg(p.bw1 + D + gch))
                          : 0.0f;
  // Hidden rows 142 .. 151 stay zero (frames past T, non-causal).
  for (int i = tid; i < 2 * (HR - TM - KW + 1) * 8; i += NT) {
    const int h = i / ((HR - TM - KW + 1) * 8), q = i % ((HR - TM - KW + 1) * 8);
    reinterpret_cast<uint4*>(smem + L::HB + h * HR * 128 +
                             (TM + KW - 1) * 128)[q] = make_uint4(0, 0, 0, 0);
  }
  // x rows of step i of utterance b into the A tile.
  auto load_x = [&](int b, int i) {
    mbar_expect_tx(xbar, 65536);
    for (int j = 0; j < 4; ++j)
      tma_load_3d(base + L::AT + j * 16384, &x_map, xbar, 64 * j, i * TM, b);
  };
  // x of the step after step i of utterance b (the A tile is free).
  auto load_next = [&](int b, int i) {
    const int ni = i + 1 < p.steps ? i + 1 : 0;
    const int nb = ni ? b : b + (int)(gridDim.x / CL);
    if (nb < p.B && ni * TM < p.T) load_x(nb, ni);
  };
  // A step's x is loaded as soon as the last step is done with the A
  // tile; the first here.
  if (tid == 0 && (int)(blockIdx.x / CL) < p.B) load_x(blockIdx.x / CL, 0);
  cluster_arrive();   // every CTA's barriers are set before any remote write
  cluster_wait();

  float dwdw[KW], sdg2 = 0.0f, sdb2 = 0.0f, sdbdw = 0.0f, sdbw2[8];
  float sdhpad = 0.0f;
  zero(dwdw);
  zero(sdbw2);
  uint32_t nx = 0, no = 0, nz = 0;
  bool wready = false;
  const int ncl = gridDim.x / CL;
  float* red = reinterpret_cast<float*>(smem + L::STAT2);   // [2][4][2][32]

  for (int b = blockIdx.x / CL; b < p.B; b += ncl) {
    for (int i = 0; i < p.steps; ++i) {
      // Output frames f0 .. f1 - 1 are this step's own; the tile's rows
      // past them (step 0 with a lag) are stored, and stored again right
      // by step 1, after step 0's stores are complete.
      const int t0 = i * TM, f0 = i == 0 ? 0 : t0 - p.lag;
      const int f1 = i + 1 < p.steps ? (i + 1) * TM - p.lag : T;
      const int own = f1 - f0;
      const bool pw = t0 < T, last = i == p.steps - 1;
      const int off = f0 - t0 + p.r0;   // hidden row of output row 0's tap 0
      if (tid == 0) {
        if (i == 1 && p.lag > 0)
          bulk_wait<0>();        // step 0's stores are done
        else
          bulk_wait_read<0>();   // the last step's stores have read AT, ST
        if constexpr (!BWD) {
          mbar_expect_tx(obar, TM * CH * 2);
          tma_load_3d(base + L::ST, &x_map, obar, c * CH, f0, b);
          mbar_expect_tx(zbar, (CL - 1) * TM * CH * 2);
        }
      }
      if (pw) {
        mbar_wait(xbar, nx & 1);
        ++nx;
        ln1_rows<TM>(smem + L::AT, wid, lane, b, t0, p, nullptr, nullptr);
        fence_async_smem();
      }
      __syncthreads();   // (and pass A's dh store has read the hidden)
      if (i == 0)   // the carried hidden of frames -14 .. -1: padding
        for (int r = rg; r < KW - 1; r += 4)
          *reinterpret_cast<float*>(smem + L::HB + swf(HR, r, ch)) = hpad;
      if (!pw)      // no PW1 rows: frames past T, zero padding
        for (int q = tid; q < 2 * TM * 8; q += NT)
          reinterpret_cast<uint4*>(smem + L::HB + (q / (TM * 8)) * HR * 128 +
                                   (KW - 1) * 128)[q % (TM * 8)] =
              make_uint4(0, 0, 0, 0);
      if (BWD && tid < 2 * 2 * 8) {   // rows 142, 143 held dh: zero again
        const int h = tid / 16, q = tid % 16;
        reinterpret_cast<uint4*>(smem + L::HB + h * HR * 128 +
                                 (TM + KW - 1) * 128)[q] = make_uint4(0, 0, 0, 0);
      }
      if (pw) {
        if (!wready) {
          mbar_wait(wbar, 0);
          wready = true;
        }
        // PW1 of the warpgroup's 64 rows: a channels in registers 0 .. 31,
        // their gates in 32 .. 63.
        float acc[64];
        const uint64_t ad = desc(base + L::AT + wg * 64 * 128, 16, 1024,
                                 kSwizzle128);
        const uint64_t bd = desc(base + L::W1S, 32768, 1024, kSwizzle128);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_ss_n128<0, 1>(acc,
                            desc_at(ad, (kk >> 2) * TM * 128 + (kk & 3) * 32),
                            desc_at(bd, kk * 2048), kk > 0);
        wg_commit();
        wg_wait0();
        fence_regs(acc);
        // The GLU with the bias; frames past T hold 0.
#pragma unroll
        for (int r = 0; r < 32; r += 2) {
          const int row = rl + 8 * ((r >> 1) & 1);
          const int col = 8 * (r >> 2) + 2 * (lane & 3);
          const float2 ba = ldg2(p.bw1 + c * CH + col);
          const float2 bg = ldg2(p.bw1 + D + c * CH + col);
          float h0 = (acc[r] + ba.x) * sig(acc[r + 32] + bg.x);
          float h1 = (acc[r + 1] + ba.y) * sig(acc[r + 33] + bg.y);
          if (t0 + row >= T) h0 = h1 = 0.0f;
          *reinterpret_cast<float2*>(smem + L::HB +
                                     swf(HR, KW - 1 + row, col)) =
              make_float2(h0, h1);
        }
      }
      __syncthreads();
      if constexpr (BWD) {   // dy's columns of chunk c, the peers' dv
        if (tid == 0) {
          mbar_expect_tx(obar, TM * CH * 2);
          tma_load_3d(base + L::AT + c * TM * 128, &io_map, obar, c * CH, f0,
                      b);
          mbar_expect_tx(zbar, (CL - 1) * TM * CH * 2);
        }
      }
      // The depthwise taps (tap order) and the bias: this thread's channel,
      // output rows 32 rg .. 32 rg + 31.
      float xh[32];
      {
        float hw[32 + KW - 1];
#pragma unroll
        for (int j = 0; j < 32 + KW - 1; ++j)
          hw[j] = *reinterpret_cast<const float*>(
              smem + L::HB + swf(HR, off + 32 * rg + j, ch));
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          float a = hw[j] * wk[0];
#pragma unroll
          for (int k = 1; k < KW; ++k) a = fmaf(hw[j + k], wk[k], a);
          xh[j] = a + bdw;
        }
      }
      // LN2's statistics over the cluster's 256 channels: each CTA's mean
      // and centred sum of squares over its 64 (two in-CTA rounds), then
      // Chan's combination of the four in rank order.
      {
        float v[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) v[j] = xh[j];
        red[(rg * 2 + half) * 32 + lane] = lane_rows_sum(v, lane);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float m = (red[rg * 64 + j] + red[rg * 64 + 32 + j]) *
                          (1.0f / CH);
          v[j] = (xh[j] - m) * (xh[j] - m);
        }
        red[256 + (rg * 2 + half) * 32 + lane] = lane_rows_sum(v, lane);
        __syncthreads();
        if (half == 0) {
          const int row = 32 * rg + lane;
          const float2 mine = make_float2(
              (red[rg * 64 + lane] + red[rg * 64 + 32 + lane]) * (1.0f / CH),
              red[256 + rg * 64 + lane] + red[256 + rg * 64 + 32 + lane]);
          const uint32_t slot = base + L::STAT + (c * TM + row) * 8;
#pragma unroll
          for (int q = 0; q < CL; ++q) st_cluster(mapa(slot, q), mine);
        }
      }
      cluster_arrive();
      cluster_wait();
      // Lane l combines row 32 rg + l; each of the warp's rows then
      // comes from its lane.
      float rs[32];
      {
        const float2* st = reinterpret_cast<const float2*>(smem + L::STAT);
        float2 s[CL];
#pragma unroll
        for (int q = 0; q < CL; ++q) s[q] = st[q * TM + 32 * rg + lane];
        const float m = (((s[0].x + s[1].x) + s[2].x) + s[3].x) * 0.25f;
        float m2 = ((s[0].y + s[1].y) + s[2].y) + s[3].y, dm = 0.0f;
#pragma unroll
        for (int q = 0; q < CL; ++q) dm += (s[q].x - m) * (s[q].x - m);
        m2 += CH * dm;
        const float r = rsqrtf(m2 * (1.0f / D) + p.eps);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          rs[j] = __shfl_sync(0xffffffffu, r, j);
          xh[j] = (xh[j] - __shfl_sync(0xffffffffu, m, j)) * rs[j];
        }
      }
      // z = silu(LN2) in bf16: the forward's A of PW2 (chunk c of the A
      // tile, the peers' chunks by DSMEM), pass A's workspace tile.
      {
        unsigned char* zt = BWD ? smem + L::ST : smem + L::AT;
        const int zc = BWD ? ch : gch;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float y1 = xh[j] * g2 + b2;
          *reinterpret_cast<bf*>(zt + swz(TM, 32 * rg + j, zc)) =
              __float2bfloat16(y1 * sig(y1));
        }
      }
      if constexpr (!BWD) {
        fence_async_smem();
        __syncthreads();
        if (tid == 0) {
          const uint32_t src = base + L::AT + c * TM * 128;
#pragma unroll
          for (int q = 1; q < CL; ++q) {
            const int peer = (c + q) % CL;
            bulk_copy_peer(mapa(src, peer), src, TM * CH * 2,
                           mapa(zbar, peer));
          }
        }
        // The carried hidden of the next step (rows 128 .. 141 -> 0 .. 13;
        // rows 8 apart share the swizzle, so 16-byte units copy as they
        // are).
        if (tid < 2 * (KW - 1) * 8) {
          const int h = tid / ((KW - 1) * 8), q = tid % ((KW - 1) * 8);
          uint4* hb = reinterpret_cast<uint4*>(smem + L::HB + h * HR * 128);
          hb[q] = hb[TM * 8 + q];
        }
        mbar_wait(zbar, nz & 1);
        ++nz;
        cluster_arrive();   // this CTA has its peers' z (waited before the
                            // A tile is loaded again)
        float acc[32];
        const uint64_t ad = desc(base + L::AT + wg * 64 * 128, 16, 1024,
                                 kSwizzle128);
        const uint64_t bd = desc(base + L::W2S, 32768, 1024, kSwizzle128);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_ss_n64<0, 1>(acc,
                           desc_at(ad, (kk >> 2) * TM * 128 + (kk & 3) * 32),
                           desc_at(bd, kk * 2048), kk > 0);
        wg_commit();
        wg_wait0();
        fence_regs(acc);
        cluster_wait();    // every peer has this CTA's z chunk
        __syncthreads();   // both warpgroups are done with the A tile
        if (tid == 0) load_next(b, i);
        // y = x + drop((v + bw2) * mask): x from the staging tile, y over
        // it; rows outside [0, T) are not stored.
        mbar_wait(obar, no & 1);
        ++no;
#pragma unroll
        for (int r = 0; r < 32; r += 2) {
          const int row = rl + 8 * ((r >> 1) & 1);
          const int col = 8 * (r >> 2) + 2 * (lane & 3);
          const int t = f0 + row;
          const size_t grow = (size_t)b * T + t;
          const float mk = t < T ? __ldg(p.mask + grow) : 0.0f;
          const float2 bb = ldg2(p.bw2 + c * CH + col);
          uint32_t* slot = reinterpret_cast<uint32_t*>(smem + L::ST +
                                                       swz(TM, row, col));
          const float2 xv = unpack_bf16(*slot);
          const uint32_t idx = (uint32_t)(grow * D + c * CH + col);
          const float v0 = tile::drop(p.dp, idx, (acc[r] + bb.x) * mk);
          const float v1 = tile::drop(p.dp, idx + 1, (acc[r + 1] + bb.y) * mk);
          *slot = pack_bf16(xv.x + v0, xv.y + v1);
        }
        fence_async_smem();
        __syncthreads();
        if (tid == 0) {
          tma_store_3d(&io_map, base + L::ST, c * CH, f0, b);
          bulk_commit();
        }
      } else {
        // dv = drop(dy) * mask over chunk c of the A tile (fp32 column
        // sums of the step's own frames are dbw2), sent to the peers by
        // DSMEM; z and dv's chunk go to the workspace.
        mbar_wait(obar, no & 1);
        ++no;
#pragma unroll
        for (int it = 0; it < 4; ++it) {
          const int r = 16 * wid + 4 * it + lane / 8;
          const int t = f0 + r, col = c * CH + 8 * (lane % 8);
          const size_t grow = (size_t)b * T + t;
          const float mk = t < T ? __ldg(p.mask + grow) : 0.0f;
          uint4* slot = reinterpret_cast<uint4*>(smem + L::AT +
                                                 swz(TM, r, col));
          const uint4 q = *slot;
          uint32_t w[4] = {q.x, q.y, q.z, q.w};
          const uint32_t idx = (uint32_t)(grow * D + col);
          const float mine = r < own ? 1.0f : 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = unpack_bf16(w[j]);
            const float d0 = tile::drop(p.dp, idx + 2 * j, f.x) * mk;
            const float d1 = tile::drop(p.dp, idx + 2 * j + 1, f.y) * mk;
            sdbw2[2 * j] += d0 * mine;
            sdbw2[2 * j + 1] += d1 * mine;
            w[j] = pack_bf16(d0, d1);
          }
          *slot = make_uint4(w[0], w[1], w[2], w[3]);
        }
        fence_async_smem();
        __syncthreads();
        if (tid == 0) {
          const uint32_t src = base + L::AT + c * TM * 128;
#pragma unroll
          for (int q = 1; q < CL; ++q) {
            const int peer = (c + q) % CL;
            bulk_copy_peer(mapa(src, peer), src, TM * CH * 2,
                           mapa(zbar, peer));
          }
          tma_store_3d(&z_map, base + L::ST, c * CH, f0, b);
          tma_store_3d(&dv_map, src, c * CH, f0, b);
          bulk_commit();
        }
        mbar_wait(zbar, nz & 1);
        ++nz;
        cluster_arrive();   // this CTA has its peers' dv (waited before the
                            // A tile is written again)
        // dz = dv W2^T for the CTA's channels.
        float acc[32];
        {
          const uint64_t ad = desc(base + L::AT + wg * 64 * 128, 16, 1024,
                                   kSwizzle128);
          const uint64_t bd = desc(base + L::W2S, 16, 1024, kSwizzle128);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            mma_ss_n64<0, 0>(
                acc, desc_at(ad, (kk >> 2) * TM * 128 + (kk & 3) * 32),
                desc_at(bd, (kk >> 2) * 8192 + (kk & 3) * 32), kk > 0);
          wg_commit();
          wg_wait0();
          fence_regs(acc);
        }
        if (tid == 0) bulk_wait_read<0>();   // dv's store has read the tile
        cluster_wait();                      // every peer has the chunk
        __syncthreads();
        // The window over the A tile, rows q <-> frames f0 - 16 + q: the
        // carried dy0 (rows 2 .. 15), dz then dy0 (16 .. 143), zeros.
        unsigned char* win = smem + L::AT;
#pragma unroll
        for (int r = 0; r < 32; r += 2) {
          const int row = rl + 8 * ((r >> 1) & 1);
          const int col = 8 * (r >> 2) + 2 * (lane & 3);
          *reinterpret_cast<float2*>(win + swf(WRW, 16 + row, col)) =
              make_float2(acc[r], acc[r + 1]);
        }
        {
          const float* carry = reinterpret_cast<const float*>(smem + L::CARRY);
          for (int r = rg; r < KW - 1; r += 4)
            *reinterpret_cast<float*>(win + swf(WRW, 2 + r, ch)) =
                i == 0 ? 0.0f : carry[r * CH + ch];
        }
        {
          const int h = tid / 128, q = tid % 128;
          reinterpret_cast<uint4*>(win + h * WRW * 128 + (TM + 16) * 128)[q] =
              make_uint4(0, 0, 0, 0);
        }
        __syncthreads();
        // LN2's VJP: dy1 = dz silu'(y1), the row means of dxhat and
        // dxhat * xhat over the cluster's channels (one exchange), dy0.
        float dxh[32];
        {
          float v[32], u[32];
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const float dz = *reinterpret_cast<const float*>(
                win + swf(WRW, 16 + 32 * rg + j, ch));
            const float y1 = xh[j] * g2 + b2;
            const float s = sig(y1);
            const float dy1 = dz * (s * (1.0f + y1 * (1.0f - s)));
            const float mine = 32 * rg + j < own ? dy1 : 0.0f;
            sdg2 += mine * xh[j];
            sdb2 += mine;
            dxh[j] = dy1 * g2;
            v[j] = dxh[j];
            u[j] = dxh[j] * xh[j];
          }
          float* red2 = reinterpret_cast<float*>(smem + L::STAT);
          red2[(rg * 2 + half) * 32 + lane] = lane_rows_sum(v, lane);
          red2[256 + (rg * 2 + half) * 32 + lane] = lane_rows_sum(u, lane);
          __syncthreads();
          if (half == 0) {
            const int row = 32 * rg + lane;
            const float2 mine = make_float2(
                red2[rg * 64 + lane] + red2[rg * 64 + 32 + lane],
                red2[256 + rg * 64 + lane] + red2[256 + rg * 64 + 32 + lane]);
            const uint32_t slot = base + L::STAT2 + (c * TM + row) * 8;
#pragma unroll
            for (int q = 0; q < CL; ++q) st_cluster(mapa(slot, q), mine);
          }
        }
        cluster_arrive();
        cluster_wait();
        float dy0[32];
        {
          const float2* st = reinterpret_cast<const float2*>(smem + L::STAT2);
          float2 s[CL];
#pragma unroll
          for (int q = 0; q < CL; ++q) s[q] = st[q * TM + 32 * rg + lane];
          const float m1l = (((s[0].x + s[1].x) + s[2].x) + s[3].x) *
                            (1.0f / D);
          const float m2l = (((s[0].y + s[1].y) + s[2].y) + s[3].y) *
                            (1.0f / D);
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int row = 32 * rg + j;
            const float m1 = __shfl_sync(0xffffffffu, m1l, j);
            const float m2 = __shfl_sync(0xffffffffu, m2l, j);
            const float g = rs[j] * (dxh[j] - m1 - xh[j] * m2);
            dy0[j] = row < own ? g : 0.0f;
            sdbdw += dy0[j];
            *reinterpret_cast<float*>(win + swf(WRW, 16 + row, ch)) = dy0[j];
          }
        }
        // dw_dw[k] += dy0[t] h[t - lo + k] over this step's frames.
        {
          float hw[32 + KW - 1];
#pragma unroll
          for (int j = 0; j < 32 + KW - 1; ++j)
            hw[j] = *reinterpret_cast<const float*>(
                smem + L::HB + swf(HR, off + 32 * rg + j, ch));
#pragma unroll
          for (int k = 0; k < KW; ++k) {
            float s = 0.0f;
#pragma unroll
            for (int j = 0; j < 32; ++j) s = fmaf(dy0[j], hw[j + k], s);
            dwdw[k] += s;
          }
        }
        __syncthreads();
        // Carries: dy0 of frames f1 - 14 .. f1 - 1 (window rows own + 2
        // ..), and the hidden rows 128 .. 141 (16-byte units, the same
        // swizzle rows 8 apart).
        {
          float* carry = reinterpret_cast<float*>(smem + L::CARRY);
          for (int r = rg; r < KW - 1; r += 4)
            carry[r * CH + ch] = *reinterpret_cast<const float*>(
                win + swf(WRW, own + 2 + r, ch));
        }
        if (tid < 2 * (KW - 1) * 8) {
          const int h = tid / ((KW - 1) * 8), q = tid % ((KW - 1) * 8);
          uint4* hb = reinterpret_cast<uint4*>(smem + L::HB + h * HR * 128);
          hb[q] = hb[TM * 8 + q];
        }
        // dh of hidden frames g0 = f0 - lo + p, p < 144 (36 a thread):
        // dh[p] = sum over k of dy0[f0 + p - k] w[k], tap K - 1 first.
        float dh[DHR / 4];
        {
          float dw[DHR / 4 + KW - 1];
#pragma unroll
          for (int j = 0; j < DHR / 4 + KW - 1; ++j)
            dw[j] = *reinterpret_cast<const float*>(
                win + swf(WRW, 36 * rg + 2 + j, ch));
#pragma unroll
          for (int j = 0; j < DHR / 4; ++j) {
            float a = dw[j] * wk[KW - 1];
#pragma unroll
            for (int k = KW - 2; k >= 0; --k)
              a = fmaf(dw[j + KW - 1 - k], wk[k], a);
            dh[j] = a;
          }
        }
        // The causal padding's hidden frames -14 .. -1 (GLU(bw1), step 0,
        // the first 14 dh rows): their share of dbw1, from dh's sum.
        if (i == 0 && p.lp > 0 && rg == 0) {
#pragma unroll
          for (int j = 0; j < KW - 1; ++j) sdhpad += dh[j];
        }
        __syncthreads();   // the window is read: the A tile is free
        if (tid == 0) load_next(b, i);
        // dh over the hidden buffer, whose frames the next step writes
        // anew: rows p < 128 at 16 + p; on the last step rows 128 .. 143
        // over the carry at 0 .. 15.
#pragma unroll
        for (int j = 0; j < DHR / 4; ++j) {
          const int q = 36 * rg + j;
          if (q < TM || last)
            *reinterpret_cast<float*>(
                smem + L::HB + swf(HR, q < TM ? 16 + q : q - TM, ch)) = dh[j];
        }
        fence_async_smem();
        __syncthreads();
        if (tid == 0) {
          // dh's workspace row of p = 0 (frame f0 - lo; rows 16 ahead)
          const int e0 = f0 - p.lo + DH_PAD;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            tma_store_3d(&dh_map, base + L::HB + h * HR * 128 + 16 * 128,
                         c * CH + 32 * h, e0, b);
            if (last)
              tma_store_3d(&dh16_map, base + L::HB + h * HR * 128,
                           c * CH + 32 * h, e0 + TM, b);
          }
          bulk_commit();
        }
      }
    }
  }
  if constexpr (BWD) {
    // This cluster's partials, each summed over the CTA's threads in a
    // fixed order: [dw_dw (15 x 256) | db_dw | dg2 | db2] and dbw2.
    if (tid == 0) bulk_wait_read<0>();
    __syncthreads();
    float* r = reinterpret_cast<float*>(smem + L::AT);
#pragma unroll
    for (int k = 0; k < KW; ++k) r[(rg * CH + ch) * 18 + k] = dwdw[k];
    r[(rg * CH + ch) * 18 + 15] = sdbdw;
    r[(rg * CH + ch) * 18 + 16] = sdg2;
    r[(rg * CH + ch) * 18 + 17] = sdb2;
    float* r2 = r + 4 * CH * 18;   // [32 row groups][64 columns of chunk c]
#pragma unroll
    for (int e = 0; e < 8; ++e)
      r2[(4 * wid + lane / 8) * CH + 8 * (lane % 8) + e] = sdbw2[e];
    __syncthreads();
    const size_t cl = blockIdx.x / CL;
    for (int q = tid; q < CH * 18; q += NT) {
      const int k = q / CH, cc = q % CH;
      float s = 0.0f;
#pragma unroll
      for (int g = 0; g < 4; ++g) s += r[(g * CH + cc) * 18 + k];
      part[cl * 18 * D + k * D + c * CH + cc] = s;
    }
    if (tid < CH) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < 32; ++w) s += r2[w * CH + tid];
      part_bw2[cl * D + c * CH + tid] = s;
      // rg == 0 here: this thread's sdhpad is channel gch's.
      const float a = __ldg(p.bw1 + gch), sg = sig(__ldg(p.bw1 + D + gch));
      part_bw1[cl * 2 * D + gch] = sdhpad * sg;
      part_bw1[cl * 2 * D + D + gch] = sdhpad * a * sg * (1.0f - sg);
    }
  } else {
    if (tid == 0) bulk_wait_read<0>();
  }
  cluster_arrive();   // no CTA leaves while a peer may still write into it
  cluster_wait();
}

// -------------------------------------------------------------- pass B ---
// Shared memory: x, then LN1(x) * mask (xe), then dx ([4][64][64] bf16);
// du ([8][64][64] bf16, the A of dxe); the ring of W1 chunks (32 KB each:
// PW1's rows [32][512] as [8][32][64], MN-major; dxe's columns [256][64],
// K-major); the row statistics; the row sums of both warpgroups; barriers.
struct LB {
  static constexpr uint32_t XT = 0;
  static constexpr uint32_t DU = 32768;
  static constexpr uint32_t RING = 98304;
  static constexpr uint32_t STAGE = 32768;
  static constexpr uint32_t MU = RING + B_STAGES * STAGE;
  static constexpr uint32_t RED = MU + 2 * RB * 4;
  static constexpr uint32_t FULL = RED + 2 * RB * 8;
  static constexpr uint32_t EMPTY = FULL + 8 * B_STAGES;
  static constexpr uint32_t XBAR = EMPTY + 8 * B_STAGES;
  static constexpr uint32_t BYTES = XBAR + 8;
};
static_assert(LB::BYTES + 1024 <= tile::kMaxSmem, "shared memory");

// W1 chunk q into stage s: q < 8, W1 rows 32 q .. (PW1's k); q >= 8, W1
// columns 64 (q - 8) .. (dxe's k).
__device__ __forceinline__ void b_load(uint32_t base, const CUtensorMap* w1a,
                                       const CUtensorMap* w1b, int s,
                                       int q) {
  const uint32_t st = base + LB::RING + s * LB::STAGE;
  const uint32_t full = base + LB::FULL + 8 * s;
  mbar_expect_tx(full, LB::STAGE);
  if (q < 8) {
#pragma unroll
    for (int a = 0; a < 8; ++a) tma_load_2d(st + a * 4096, w1a, full, 64 * a,
                                            32 * q);
  } else {
    tma_load_2d(st, w1b, full, 64 * (q - 8), 0);
  }
}

// Pass B (row-parallel): frames tau0 .. tau0 + 63 of utterance b, all
// channels. LN1 (written as xe for pass C), PW1 (warpgroup w: a and gate
// channels [128 w, 128 w + 128)), du = [dh s, dh a s (1 - s)] with dh
// from pass A (written for pass C), dxe = du W1^T (warpgroup w: columns
// [128 w, 128 w + 128)), LN1's VJP and dx = dy + dx_ln; partials of [dg1
// | db1] and dbw1. (The causal padding's frames, xe = 0, add nothing to
// dW1; pass A adds their share of dbw1.)
__global__ void __launch_bounds__(NT, 1)
bwd_b(const __grid_constant__ CUtensorMap x_map,
      const __grid_constant__ CUtensorMap w1a_map,
      const __grid_constant__ CUtensorMap w1b_map,
      const __grid_constant__ CUtensorMap xe_map,
      const __grid_constant__ CUtensorMap du_map,
      const __grid_constant__ CUtensorMap dx_map, const float* __restrict__ dh,
      const bf* __restrict__ x, const bf* __restrict__ dy, const Par p,
      int tiles, float* __restrict__ part_b1, float* __restrict__ part_bw1) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x, lane = tid & 31;
  const int wid = warp_uniform(tid / 32);
  const int wg = wid / 4, wq = wid % 4;
  const int b = blockIdx.x / tiles, tau0 = (blockIdx.x % tiles) * RB;
  const int T = p.T;
  float* mu = reinterpret_cast<float*>(smem + LB::MU);
  float* rstd = mu + RB;
  if (tid == 0) {
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(base + LB::FULL + 8 * s, 1);
      mbar_init(base + LB::EMPTY + 8 * s, 8);
    }
    mbar_init(base + LB::XBAR, 1);
    mbar_init_fence();
    mbar_expect_tx(base + LB::XBAR, RB * D * 2);
    for (int j = 0; j < 4; ++j)
      tma_load_3d(base + LB::XT + j * RB * 128, &x_map, base + LB::XBAR,
                  64 * j, tau0, b);
    for (int q = 0; q < B_STAGES; ++q) b_load(base, &w1a_map, &w1b_map, q, q);
  }
  __syncthreads();
  mbar_wait(base + LB::XBAR, 0);
  ln1_rows<RB>(smem + LB::XT, wid, lane, b, tau0, p, mu, rstd);
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < 4; ++j)
      tma_store_3d(&xe_map, base + LB::XT + j * RB * 128, 64 * j, tau0, b);
    bulk_commit();
  }
  // Chunk q's stage is released once both warpgroups' products of it are
  // done (wait1 after chunk q + 1's); thread 0 then loads chunk q + 3.
  auto release = [&](int q) {
    const int s = q % B_STAGES;
    if (lane == 0) mbar_arrive(base + LB::EMPTY + 8 * s);
    if (tid == 0 && q + B_STAGES < 16) {
      mbar_wait(base + LB::EMPTY + 8 * s, (q / B_STAGES) & 1);
      b_load(base, &w1a_map, &w1b_map, s, q + B_STAGES);
    }
  };
  float acca[64], accg[64];
  {
    const uint64_t ad = desc(base + LB::XT, 16, 1024, kSwizzle128);
    for (int q = 0; q < 8; ++q) {
      const int s = q % B_STAGES;
      mbar_wait(base + LB::FULL + 8 * s, (q / B_STAGES) & 1);
      const uint32_t st = base + LB::RING + s * LB::STAGE;
      const uint64_t ba = desc(st + 2 * wg * 4096, 4096, 1024, kSwizzle128);
      const uint64_t bg = desc(st + (4 + 2 * wg) * 4096, 4096, 1024,
                               kSwizzle128);
      fence_regs(acca);
      fence_regs(accg);
      wg_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = 2 * q + h;
        const uint64_t ak =
            desc_at(ad, (kk >> 2) * RB * 128 + (kk & 3) * 32);
        mma_ss_n128<0, 1>(acca, ak, desc_at(ba, h * 2048), kk > 0);
        mma_ss_n128<0, 1>(accg, ak, desc_at(bg, h * 2048), kk > 0);
      }
      wg_commit();
      if (q > 0) {
        wg_wait1();
        release(q - 1);
      }
    }
    wg_wait0();
    fence_regs(acca);
    fence_regs(accg);
    release(7);
  }
  // du in registers, then into the du tile; dbw1's column sums (fp32)
  // over the block's rows: this thread's two rows, then the 8 lanes that
  // share its columns (lane_cols_sum), then the 4 warps (at the end).
  const int rl = 16 * wq + lane / 4;
  float cs[64];
#pragma unroll
  for (int r = 0; r < 64; r += 4) {
    const int col = 8 * (r >> 2) + 2 * (lane & 3);   // of the warpgroup's 128
    const int chn = 128 * wg + col;
    const float2 ba = ldg2(p.bw1 + chn), bg = ldg2(p.bw1 + D + chn);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rl + 8 * hh, t = tau0 + row;
      float2 d = make_float2(0.0f, 0.0f);
      if (t < T) d = ldg2(dh + ((size_t)b * (T + DH_PAD) + DH_PAD + t) * D + chn);
      const int ri = r + 2 * hh;
      const float a0 = acca[ri] + ba.x, a1 = acca[ri + 1] + ba.y;
      const float s0 = sig(accg[ri] + bg.x), s1 = sig(accg[ri + 1] + bg.y);
      const float da0 = d.x * s0, da1 = d.y * s1;
      const float dg0 = d.x * a0 * s0 * (1.0f - s0);
      const float dg1 = d.y * a1 * s1 * (1.0f - s1);
      const int ci = 2 * (r >> 2);
      if (hh == 0) {
        cs[ci] = da0;
        cs[ci + 1] = da1;
        cs[32 + ci] = dg0;
        cs[32 + ci + 1] = dg1;
      } else {
        cs[ci] += da0;
        cs[ci + 1] += da1;
        cs[32 + ci] += dg0;
        cs[32 + ci + 1] += dg1;
      }
      *reinterpret_cast<uint32_t*>(smem + LB::DU + swz(RB, row, chn)) =
          pack_bf16(da0, da1);
      *reinterpret_cast<uint32_t*>(smem + LB::DU + swz(RB, row, D + chn)) =
          pack_bf16(dg0, dg1);
    }
  }
  lane_cols_sum(cs, lane);
  float sbw1[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sbw1[e] = cs[e];
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < 8; ++j)
      tma_store_3d(&du_map, base + LB::DU + j * RB * 128, 64 * j, tau0, b);
    bulk_commit();
  }
  // dxe = du W1^T (into acca).
  {
    const uint64_t ad = desc(base + LB::DU, 16, 1024, kSwizzle128);
    for (int q = 8; q < 16; ++q) {
      const int s = q % B_STAGES;
      mbar_wait(base + LB::FULL + 8 * s, (q / B_STAGES) & 1);
      const uint64_t bd = desc(base + LB::RING + s * LB::STAGE +
                                   128 * wg * 128,
                               16, 1024, kSwizzle128);
      fence_regs(acca);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss_n128<0, 0>(acca, desc_at(ad, (q - 8) * RB * 128 + kk * 32),
                          desc_at(bd, kk * 32), q > 8 || kk > 0);
      wg_commit();
      if (q > 8) {   // chunk 7 was released after PW1
        wg_wait1();
        release(q - 1);
      }
    }
    wg_wait0();
    fence_regs(acca);
  }
  // LN1's VJP in the accumulator's layout: rows rl, rl + 8, the
  // warpgroup's columns 128 w + 8 j + 2 (lane % 4) + {0, 1}.
  float dxn[64], xhv[64];
  float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
  float mk[2], rsv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = rl + 8 * hh, t = tau0 + row;
    const bool live = t < T;
    mk[hh] = live ? __ldg(p.mask + (size_t)b * T + t) : 0.0f;
    rsv[hh] = live ? rstd[row] : 0.0f;
    const float m = live ? mu[row] : 0.0f;
#pragma unroll
    for (int r = 2 * hh; r < 64; r += 4) {
      const int col = 128 * wg + 8 * (r >> 2) + 2 * (lane & 3);
      float2 xv = make_float2(0.0f, 0.0f);
      if (live)
        xv = unpack_bf16(__ldg(reinterpret_cast<const unsigned int*>(
            x + ((size_t)b * T + t) * D + col)));
      const float2 gv = ldg2(p.g1 + col);
      dxn[r] = acca[r] * mk[hh];
      dxn[r + 1] = acca[r + 1] * mk[hh];
      xhv[r] = (xv.x - m) * rsv[hh];
      xhv[r + 1] = (xv.y - m) * rsv[hh];
      const float d0 = dxn[r] * gv.x, d1 = dxn[r + 1] * gv.y;
      s1[hh] += d0 + d1;
      s2[hh] += d0 * xhv[r] + d1 * xhv[r + 1];
    }
  }
  float2* red = reinterpret_cast<float2*>(smem + LB::RED);   // [2][64]
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s1[hh] += __shfl_xor_sync(0xffffffffu, s1[hh], o);
      s2[hh] += __shfl_xor_sync(0xffffffffu, s2[hh], o);
    }
    if ((lane & 3) == 0) red[wg * RB + rl + 8 * hh] = make_float2(s1[hh], s2[hh]);
  }
  if (tid == 0) bulk_wait_read<0>();   // xe's store has read the tile
  __syncthreads();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = rl + 8 * hh, t = tau0 + row;
    const float2 q0 = red[row], q1 = red[RB + row];
    const float m1 = (q0.x + q1.x) * (1.0f / D), m2 = (q0.y + q1.y) * (1.0f / D);
    const bool live = t < T;
#pragma unroll
    for (int r = 2 * hh; r < 64; r += 4) {
      const int col = 128 * wg + 8 * (r >> 2) + 2 * (lane & 3);
      float2 dyv = make_float2(0.0f, 0.0f);
      if (live)
        dyv = unpack_bf16(__ldg(reinterpret_cast<const unsigned int*>(
            dy + ((size_t)b * T + t) * D + col)));
      const float2 gv = ldg2(p.g1 + col);
      const float o0 = dyv.x + rsv[hh] * (dxn[r] * gv.x - m1 - xhv[r] * m2);
      const float o1 =
          dyv.y + rsv[hh] * (dxn[r + 1] * gv.y - m1 - xhv[r + 1] * m2);
      *reinterpret_cast<uint32_t*>(smem + LB::XT + swz(RB, row, col)) =
          pack_bf16(o0, o1);
    }
  }
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < 4; ++j)
      tma_store_3d(&dx_map, base + LB::XT + j * RB * 128, 64 * j, tau0, b);
    bulk_commit();
  }
  // dg1 = sum dxn xhat1, db1 = sum dxn over the block's rows.
#pragma unroll
  for (int r = 0; r < 64; r += 4) {
    const int ci = 2 * (r >> 2);
    cs[ci] = dxn[r] * xhv[r] + dxn[r + 2] * xhv[r + 2];
    cs[ci + 1] = dxn[r + 1] * xhv[r + 1] + dxn[r + 3] * xhv[r + 3];
    cs[32 + ci] = dxn[r] + dxn[r + 2];
    cs[32 + ci + 1] = dxn[r + 1] + dxn[r + 3];
  }
  lane_cols_sum(cs, lane);
  // The warps' column sums (the ring is free): lane l holds values 32 b4
  // + 16 b3 + 8 b2 + i, i < 8, value v = 32 part + 2 jg + e standing for
  // column 8 jg + 2 (l % 4) + e of the warpgroup's 128 (part 0: dbw1's a
  // or dg1, part 1: dbw1's gate or db1).
  float* wr = reinterpret_cast<float*>(smem + LB::RING);   // [2][8 warps][256]
  const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int v = 16 * b3 + 8 * b2 + i;
    const int col = 8 * (v >> 1) + 2 * (lane & 3) + (v & 1);
    wr[wid * 256 + 128 * b4 + col] = sbw1[i];
    wr[2048 + wid * 256 + 128 * b4 + col] = cs[i];
  }
  __syncthreads();
  // dbw1 [a 256 | gate 256] and [dg1 | db1], the warpgroup's 4 warps in
  // order.
  const size_t blk = blockIdx.x;
  for (int j = tid; j < 2 * D; j += NT) {
    const int part = j / D, cc = j % D, w = cc / 128, col = cc % 128;
    float a = 0.0f, g = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a += wr[(4 * w + q) * 256 + 128 * part + col];
      g += wr[2048 + (4 * w + q) * 256 + 128 * part + col];
    }
    part_bw1[blk * 2 * D + j] = a;
    part_b1[blk * 2 * D + j] = g;
  }
  if (tid == 0) bulk_wait_read<0>();
}

// -------------------------------------------------------------- pass C ---
// dW1 = xe^T du [256 x 512] and dW2 = z^T dv [256 x 256] in one launch:
// block (tile, split), tiles 0 .. 3 dW1's [128 x 256] quarters, 4 .. 5
// dW2's halves; warpgroup w the tile's rows 64 w ..; per chunk of 64 rows
// TMA brings A's 128 columns (the transposed, MN-major A) and B's 256
// (MN-major), 48 KB a stage; the sum stays in registers over the split and
// is stored as the split's partial.
struct LC {
  static constexpr uint32_t A = 2 * RC * 128;
  static constexpr uint32_t STAGE = A + 4 * RC * 128;
  static constexpr uint32_t FULL = C_STAGES * STAGE;
  static constexpr uint32_t EMPTY = FULL + 8 * C_STAGES;
  static constexpr uint32_t BYTES = EMPTY + 8 * C_STAGES;
};
static_assert(LC::BYTES + 1024 <= tile::kMaxSmem, "shared memory");

__global__ void __launch_bounds__(NT, 1)
wgrad(const __grid_constant__ CUtensorMap a1_map,
      const __grid_constant__ CUtensorMap b1_map,
      const __grid_constant__ CUtensorMap a2_map,
      const __grid_constant__ CUtensorMap b2_map, float* __restrict__ part1,
      float* __restrict__ part2, int rows1, int rows2, int per1, int per2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x, lane = tid & 31;
  const int wid = warp_uniform(tid / 32);
  const int wg = wid / 4, wq = wid % 4;
  const int tile_ = blockIdx.x, split = blockIdx.y;
  const bool two = tile_ >= 4;
  const int mt = two ? tile_ - 4 : tile_ / 2, nt = two ? 0 : tile_ % 2;
  const CUtensorMap* am = two ? &a2_map : &a1_map;
  const CUtensorMap* bm = two ? &b2_map : &b1_map;
  const int rows = two ? rows2 : rows1, per = two ? per2 : per1;
  const int r0 = split * per, r1 = min(rows, r0 + per);
  const int chunks = r1 > r0 ? (r1 - r0 + RC - 1) / RC : 0;
  auto load = [&](int s, int i) {
    const uint32_t st = base + s * LC::STAGE, full = base + LC::FULL + 8 * s;
    mbar_expect_tx(full, LC::STAGE);
    const int row = r0 + i * RC;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      tma_load_2d(st + j * RC * 128, am, full, 128 * mt + 64 * j, row);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      tma_load_2d(st + LC::A + j * RC * 128, bm, full, 256 * nt + 64 * j,
                  row);
  };
  if (tid == 0) {
    for (int s = 0; s < C_STAGES; ++s) {
      mbar_init(base + LC::FULL + 8 * s, 1);
      mbar_init(base + LC::EMPTY + 8 * s, 8);
    }
    mbar_init_fence();
    for (int i = 0; i < C_STAGES && i < chunks; ++i) load(i, i);
  }
  __syncthreads();
  float acc[128];
  const uint64_t ad0 = desc(base + wg * RC * 128, RC * 128, 1024, kSwizzle128);
  const uint64_t bd0 = desc(base + LC::A, RC * 128, 1024, kSwizzle128);
  for (int i = 0; i < chunks; ++i) {
    const int s = i % C_STAGES;
    mbar_wait(base + LC::FULL + 8 * s, (i / C_STAGES) & 1);
    const uint64_t ad = desc_at(opaque(ad0), s * LC::STAGE);
    const uint64_t bd = desc_at(opaque(bd0), s * LC::STAGE);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < RC / 16; ++kk)
      mma_ss_n256<1, 1>(acc, desc_at(ad, kk * 2048), desc_at(bd, kk * 2048),
                        i > 0 || kk > 0);
    wg_commit();
    if (i == 0) continue;
    wg_wait1();
    const int sp = (i - 1) % C_STAGES;
    if (lane == 0) mbar_arrive(base + LC::EMPTY + 8 * sp);
    if (tid == 0 && i - 1 + C_STAGES < chunks) {
      mbar_wait(base + LC::EMPTY + 8 * sp, ((i - 1) / C_STAGES) & 1);
      load(sp, i - 1 + C_STAGES);
    }
  }
  wg_wait0();
  fence_regs(acc);
  if (chunks == 0) zero(acc);
  const int n = two ? D : 2 * D;
  float* out = (two ? part2 : part1) + (size_t)split * D * n;
  const int m = 128 * mt + 64 * wg + 16 * wq + lane / 4;
#pragma unroll
  for (int r = 0; r < 128; r += 2) {
    const int row = m + 8 * ((r >> 1) & 1);
    const int col = 256 * nt + 8 * (r >> 2) + 2 * (lane & 3);
    *reinterpret_cast<float2*>(out + (size_t)row * n + col) =
        make_float2(acc[r], acc[r + 1]);
  }
}

// The backward's fixed-order sums, one launch: segment g adds its s
// partials of m floats (m a multiple of 32) into out; a block takes 32
// columns, its 16 rows of threads every 16th partial, then the 16 sums in
// order.
struct Seg {
  const float* part;
  float* out;
  int s, m, first;   // first: the segment's first block
};
constexpr int kSegs = 6;
struct Segs {
  Seg g[kSegs];
};

__global__ void __launch_bounds__(512)
sum_segs(const Segs segs) {
  __shared__ float acc[16][33];
  int k = 0;
#pragma unroll
  for (int q = 1; q < kSegs; ++q)
    if ((int)blockIdx.x >= segs.g[q].first) k = q;
  const Seg sg = segs.g[k];
  const int j = (blockIdx.x - sg.first) * 32 + threadIdx.x;
  float v = 0.0f;
#pragma unroll 4
  for (int q = threadIdx.y; q < sg.s; q += 16)
    v += sg.part[(size_t)q * sg.m + j];
  acc[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0) {
    float t = 0.0f;
#pragma unroll
    for (int q = 0; q < 16; ++q) t += acc[q][threadIdx.x];
    sg.out[j] = t;
  }
}

}  // namespace conv16

// ----------------------------------------------------- bf16 launchers ---
namespace conv16 {

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms < 1)
      sms = 132;
  }
  return sms;
}

inline bool shape_ok(int d, int k) { return d == D && k == KW; }

inline Par make_par(const Args& a) {
  Par p;
  p.mask = a.mask;
  p.g1 = a.g1;
  p.b1 = a.b1;
  p.bw1 = a.bw1;
  p.wdw = a.wdw;
  p.bdw = a.bdw;
  p.g2 = a.g2;
  p.b2 = a.b2;
  p.bw2 = a.bw2;
  p.B = a.B;
  p.T = a.T;
  p.lo = a.lo;
  p.r0 = KW - 1 - a.lo;
  p.lp = a.lp;
  // Output frames trail the PW1 rows by r0 when the utterance takes more
  // than one step; one step computes every hidden frame it reads.
  p.lag = a.T <= TM ? 0 : p.r0;
  p.steps = (a.T + p.lag + TM - 1) / TM;
  p.eps = a.eps;
  p.dp = a.dp;
  return p;
}

template <bool BWD>
cudaLaunchConfig_t clu_config(int ncl, cudaStream_t s,
                              cudaLaunchAttribute* at) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * ncl);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = L::BYTES + 1024;
  cfg.stream = s;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = CL;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

// The clusters the card holds at once (the persistent grid), 0 when the
// kernel cannot run.
template <bool BWD>
int max_clusters() {
  static int n = -1;
  if (n < 0) {
    n = 0;
    if (tile::set_smem(clu<BWD>, L::BYTES + 1024) == cudaSuccess) {
      cudaLaunchAttribute at[1];
      const cudaLaunchConfig_t cfg = clu_config<BWD>(1, 0, at);
      int c = 0;
      if (cudaOccupancyMaxActiveClusters(&c, clu<BWD>, &cfg) == cudaSuccess)
        n = c;
    }
  }
  return n;
}

constexpr CUtensorMapSwizzle kSw128 = CU_TENSOR_MAP_SWIZZLE_128B;

cudaError_t fwd(const Args& a, void* y, cudaStream_t s) {
  const Par p = make_par(a);
  const int ncl = a.B < max_clusters<false>() ? a.B : max_clusters<false>();
  if (ncl < 1) return cudaErrorInvalidConfiguration;
  CUtensorMap xm, w1m, w2m, ym;
  if (!tensor_map_3d(&xm, a.x, D, a.T, a.B, 64, TM, kSw128) ||
      !tensor_map(&w1m, a.w1, D, 2 * D, 256, 64, kSw128) ||
      !tensor_map(&w2m, a.w2, D, D, 256, 64, kSw128) ||
      !tensor_map_3d(&ym, y, D, a.T, a.B, 64, TM, kSw128))
    return cudaErrorInvalidValue;
  cudaLaunchAttribute at[1];
  const cudaLaunchConfig_t cfg = clu_config<false>(ncl, s, at);
  return cudaLaunchKernelEx(&cfg, clu<false>, xm, w1m, w2m, ym, ym, ym, ym, ym,
                            p, (float*)nullptr, (float*)nullptr,
                            (float*)nullptr);
}

// The backward's workspace (byte offsets, 256-aligned) and schedule: z,
// dv [B, T, 256] bf16 and dh [B, 16 + T, 256] fp32 (frame t at row 16 +
// t) from pass A; xe [B, T, 256] and du [B, T, 512] bf16 from pass B; the
// partials of pass A (per cluster), pass B (per block; dbw1's rows then
// pass A's padding share) and pass C (per row split).
struct Work {
  size_t z, dv, dh, xe, du, pa, pa2, pb1, pbw1, p1, p2, bytes;
  int ncl, tiles, nb, splits, per1, per2, rows1, rows2;
};

inline size_t al256(size_t b) { return (b + 255) / 256 * 256; }

inline Work work_of(int B, int T) {
  Work w;
  const int mc = max_clusters<true>();
  w.ncl = B < mc ? B : mc;
  w.tiles = (T + RB - 1) / RB;
  w.nb = B * w.tiles;
  w.rows1 = B * T;
  w.rows2 = B * T;
  // Pass C: 6 tiles x splits fill about one wave; each split a whole
  // number of 64-row chunks.
  const int c1 = (w.rows1 + RC - 1) / RC, c2 = (w.rows2 + RC - 1) / RC;
  int s = sm_count() / 6;
  if (s > c2) s = c2;
  if (s < 1) s = 1;
  w.splits = s;
  w.per1 = (c1 + s - 1) / s * RC;
  w.per2 = (c2 + s - 1) / s * RC;
  size_t o = 0;
  w.z = o;    o += al256((size_t)w.rows2 * D * 2);
  w.dv = o;   o += al256((size_t)w.rows2 * D * 2);
  w.dh = o;   o += al256((size_t)B * (T + DH_PAD) * D * 4);
  w.xe = o;   o += al256((size_t)w.rows1 * D * 2);
  w.du = o;   o += al256((size_t)w.rows1 * 2 * D * 2);
  w.pa = o;   o += al256((size_t)w.ncl * 18 * D * 4);
  w.pa2 = o;  o += al256((size_t)w.ncl * D * 4);
  w.pb1 = o;  o += al256((size_t)w.nb * 2 * D * 4);
  w.pbw1 = o; o += al256((size_t)(w.nb + w.ncl) * 2 * D * 4);
  w.p1 = o;   o += al256((size_t)s * D * 2 * D * 4);
  w.p2 = o;   o += al256((size_t)s * D * D * 4);
  w.bytes = w.ncl > 0 ? o : 0;
  return w;
}

// g: dg1, db1, dw1, dbw1, dw_dw, db_dw, dg2, db2, dw2, dbw2, laid out one
// after another in one buffer (the sums write across neighbours).
cudaError_t bwd(const Args& a, const void* dy, void* dx, float* const* g,
                unsigned char* ws, cudaStream_t s) {
  const int sizes[9] = {D, D, 2 * D * D, 2 * D, KW * D, D, D, D, D * D};
  for (int i = 0; i < 9; ++i)
    if (g[i + 1] != g[i] + sizes[i]) return cudaErrorInvalidValue;
  const Par p = make_par(a);
  const Work w = work_of(a.B, a.T);
  if (w.ncl < 1) return cudaErrorInvalidConfiguration;
  const int B = a.B, T = a.T;
  void* z = ws + w.z;
  void* dv = ws + w.dv;
  float* dh = reinterpret_cast<float*>(ws + w.dh);
  void* xe = ws + w.xe;
  void* du = ws + w.du;
  float* pa = reinterpret_cast<float*>(ws + w.pa);
  float* pa2 = reinterpret_cast<float*>(ws + w.pa2);
  float* pb1 = reinterpret_cast<float*>(ws + w.pb1);
  float* pbw1 = reinterpret_cast<float*>(ws + w.pbw1);
  float* p1 = reinterpret_cast<float*>(ws + w.p1);
  float* p2 = reinterpret_cast<float*>(ws + w.p2);
  CUtensorMap xm, w1m, w2m, dym, zm, dvm, dhm, dh16m;
  CUtensorMap xb, w1a, xem, dum, dxm, a1, b1, a2, b2;
  if (!tensor_map_3d(&xm, a.x, D, T, B, 64, TM, kSw128) ||
      !tensor_map(&w1m, a.w1, D, 2 * D, 256, 64, kSw128) ||
      !tensor_map(&w2m, a.w2, D, D, 64, 64, kSw128) ||
      !tensor_map_3d(&dym, dy, D, T, B, 64, TM, kSw128) ||
      !tensor_map_3d(&zm, z, D, T, B, 64, TM, kSw128) ||
      !tensor_map_3d(&dvm, dv, D, T, B, 64, TM, kSw128) ||
      !tensor_map_3d(&dhm, dh, D, T + DH_PAD, B, 32, TM, kSw128, true) ||
      !tensor_map_3d(&dh16m, dh, D, T + DH_PAD, B, 32, 16, kSw128, true) ||
      !tensor_map_3d(&xb, a.x, D, T, B, 64, RB, kSw128) ||
      !tensor_map(&w1a, a.w1, D, 2 * D, 32, 64, kSw128) ||
      !tensor_map_3d(&xem, xe, D, T, B, 64, RB, kSw128) ||
      !tensor_map_3d(&dum, du, 2 * D, T, B, 64, RB, kSw128) ||
      !tensor_map_3d(&dxm, dx, D, T, B, 64, RB, kSw128) ||
      !tensor_map(&a1, xe, w.rows1, D, RC, 64, kSw128) ||
      !tensor_map(&b1, du, w.rows1, 2 * D, RC, 64, kSw128) ||
      !tensor_map(&a2, z, w.rows2, D, RC, 64, kSw128) ||
      !tensor_map(&b2, dv, w.rows2, D, RC, 64, kSw128))
    return cudaErrorInvalidValue;
  cudaError_t e;
  cudaLaunchAttribute at[1];
  const cudaLaunchConfig_t cfg = clu_config<true>(w.ncl, s, at);
  if ((e = cudaLaunchKernelEx(&cfg, clu<true>, xm, w1m, w2m, dym, zm, dvm,
                              dhm, dh16m, p, pa, pa2,
                              pbw1 + (size_t)w.nb * 2 * D)) != cudaSuccess)
    return e;
  if ((e = tile::set_smem(bwd_b, LB::BYTES + 1024)) != cudaSuccess) return e;
  bwd_b<<<w.nb, NT, LB::BYTES + 1024, s>>>(
      xb, w1a, w1m, xem, dum, dxm, dh, static_cast<const bf*>(a.x),
      static_cast<const bf*>(dy), p, w.tiles, pb1, pbw1);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = tile::set_smem(wgrad, LC::BYTES + 1024)) != cudaSuccess) return e;
  wgrad<<<dim3(6, w.splits), NT, LC::BYTES + 1024, s>>>(
      a1, b1, a2, b2, p1, p2, w.rows1, w.rows2, w.per1, w.per2);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  Segs sg;
  const Seg parts[kSegs] = {
      {pb1, g[0], w.nb, 2 * D, 0},      {p1, g[2], w.splits, 2 * D * D, 0},
      {pbw1, g[3], w.nb + w.ncl, 2 * D, 0}, {pa, g[4], w.ncl, 18 * D, 0},
      {p2, g[8], w.splits, D * D, 0},   {pa2, g[9], w.ncl, D, 0}};
  int blocks = 0;
  for (int i = 0; i < kSegs; ++i) {
    sg.g[i] = parts[i];
    sg.g[i].first = blocks;
    blocks += parts[i].m / 32;
  }
  sum_segs<<<blocks, dim3(32, 16), 0, s>>>(sg);
  return cudaGetLastError();
}

}  // namespace conv16

}  // namespace

extern "C" {

// dtype 0 = fp32, 1 = bf16 (conv16: D = 256, K = 15). Shape and alignment checks are the caller's
// (ops/conv.py); thresh >= 65536 turns the mask off; row_base is the first
// of this process's rows in the step's whole batch (0 for a batch of its
// own). Returns a cudaError_t code; 0 is success.
int conv_block_fwd(int dtype, const void* x, const void* mask, const void* g1,
                   const void* b1, const void* w1, const void* bw1,
                   const void* wdw, const void* bdw, const void* g2,
                   const void* b2, const void* w2, const void* bw2, void* y,
                   int B, int T, int D, int K, int causal, float eps,
                   unsigned key, int thresh, float scale, unsigned row_base,
                   void* stream) {
  if (dtype == 1 ? !conv16::shape_ok(D, K)
                 : !shape_ok(D, K, causal) || !fits<float>(D, K))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(x, mask, g1, b1, w1, bw1, wdw, bdw, g2, b2, w2,
                           bw2, B, T, D, K, causal, eps, key, thresh, scale,
                           row_base);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)conv16::fwd(a, y, s);
  return (int)fwd<float>(a, y, s);
}

// Bytes of workspace the backward needs, or 0 when its tiles do not fit
// shared memory for this width and kernel size.
long long conv_block_bwd_workspace(int dtype, int B, int T, int D, int K,
                                   int causal) {
  const int lp = causal ? K - 1 : 0;
  if (dtype == 1)
    return conv16::shape_ok(D, K)
               ? (long long)conv16::work_of(B, T).bytes
               : 0;
  if (!shape_ok(D, K, causal) || !fits<float>(D, K)) return 0;
  return (long long)work_of<float>(B, T, D, K, lp).bytes;
}

// dx in the compute type; the ten parameter gradients fp32, in the order
// dg1, db1, dw1 [D, 2D], dbw1, dw_dw [K, D], db_dw, dg2, db2, dw2 [D, D],
// dbw2 (dtype 1: one after another in one buffer). ws holds
// conv_block_bwd_workspace() bytes.
int conv_block_bwd(int dtype, const void* x, const void* mask,
                   const void* g1, const void* b1, const void* w1,
                   const void* bw1, const void* wdw, const void* bdw,
                   const void* g2, const void* b2, const void* w2,
                   const void* bw2, const void* dy, void* dx, float* dg1,
                   float* db1, float* dw1, float* dbw1, float* dwdw,
                   float* dbdw, float* dg2, float* db2, float* dw2,
                   float* dbw2, void* ws, int B, int T, int D, int K,
                   int causal, float eps, unsigned key, int thresh,
                   float scale, unsigned row_base, void* stream) {
  if (conv_block_bwd_workspace(dtype, B, T, D, K, causal) == 0)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(x, mask, g1, b1, w1, bw1, wdw, bdw, g2, b2, w2,
                           bw2, B, T, D, K, causal, eps, key, thresh, scale,
                           row_base);
  float* const g[10] = {dg1, db1, dw1, dbw1, dwdw, dbdw, dg2, db2, dw2, dbw2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* w = static_cast<unsigned char*>(ws);
  if (dtype == 1) return (int)conv16::bwd(a, dy, dx, g, w, s);
  return (int)bwd<float>(a, dy, dx, g, w, s);
}

}  // extern "C"
