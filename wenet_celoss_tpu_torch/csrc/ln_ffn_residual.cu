// Fused conformer FFN block for Hopper (sm_90a), forward and backward,
// with both dropout masks:
//
//   y = x + ff_scale * drop2(drop1(act(LN(x) @ W1^T + b1)) @ W2^T + b2)
//
// Replaces wenet_celoss_tpu/ops/ffn_pallas.py::_ln_ffn_fwd_kernel and
// ::_ln_ffn_bwd_kernel (the Pallas forward and backward of
// ln_ffn_residual), and, with no LayerNorm given (g == nullptr),
// ::_ffn_fwd_kernel and ::_ffn_bwd_kernel (ffn_fused, the post-norm FFN
//
//   y = drop1(act(x @ W1^T + b1)) @ W2^T + b2
//
// with no output mask and no residual): the same kernels, x staged where
// LN(x) was, the residual, the LN VJP and the LN partials skipped, and pass
// B reading x and dy directly (nothing to write for it). Rounding points
// are the Pallas kernels': LayerNorm in
// fp32, cast to the compute type; GEMMs with fp32 accumulation; the
// activation, its derivative and the dropout scaling in fp32, cast to the
// compute type before a GEMM; the LayerNorm VJP in fp32; the residual and
// dx summed in fp32, cast once on store.
//
// Dropout. The TPU seeds its on-core PRNG per program id, which ties the
// mask to its 128-row blocking. Here a mask bit is a pure function of
// (key, global row * ncols + column): keep iff the low 16 bits of
// hash32(index ^ key) are below the threshold, scale 1/keep. The key of
// each stream (1 = hidden, 2 = output) is computed on the host from the
// seed (ops/dropout.py, which repeats hash32 with torch integer ops), so
// the forward, both backward passes and the plain version draw the same
// mask whatever their tiling.
//
// What bounds it: at the main path's shapes (N = 256*127 or 256*33 rows,
// D = 256, F = 2048, bf16) the forward does 4*N*D*F operations and the
// backward 10*N*D*F (the recomputed first GEMM and four gradient GEMMs)
// against ~O(N*D + D*F) bytes, well past the H100's ~295 operations a byte:
// both are compute-bound (ops/bounds.py).
//
// fp32 forward: one CTA of 256 threads owns a block of ROWS rows; the TPU
// kernel holds the whole [rows, F] hidden in VMEM, which does not fit in
// shared memory, so the CTA loops over F in tiles of FT columns, stages
// W1[f0:f0+FT, :] and W2[:, f0:f0+FT] in shared memory, computes the
// hidden tile and adds its product with W2 into an fp32 [ROWS, D]
// accumulator in shared memory (plain FMA, so that it stays full fp32).
//
// bf16 forward (namespace fwd16), designed for Hopper. A block of two
// warpgroups (256 threads) holds A, the block's rows of LN(x) (fp32
// statistics, one warp a row, written as bf16 into a K-major 128B-swizzled
// tile) or of x (loaded by TMA), for the whole F loop. TMA keeps F tiles of
// FT = 64 columns, W1[f0:f0+64, :] and W2[:, f0:f0+64] (both K-major
// B operands, 128B swizzle), in flight through a ring of 2-4 stages (as
// many as fit); the last warp to release a stage refills it, so no
// producer warp caps the registers. Per F tile a warpgroup computes
// z1 = A W1t^T with wgmma (m64n64, both operands in shared memory), then in
// registers b1, the activation and the hidden mask (bits from the
// accumulator's row * F + col, computed while the product runs), rounds to
// bf16 and feeds the hidden as the register A operand of acc += h W2t^T
// (m64nD). acc, 128 registers a thread at D = 256, stays in registers over
// the whole F loop: the [rows, F] hidden never leaves the chip, as on the
// TPU. The epilogue sums the warpgroups' accumulators through shared
// memory once and, eight columns a thread, adds b2, the output mask, the
// scale and the residual in fp32 and casts once on store.
//
// The forward's schedule (fwd16_split) fills the card and bounds the
// weight traffic: every block streams all of W1 and W2 (2 MiB at D = 256,
// F = 2048) from L2 once, so the L2 -> shared memory bytes are blocks x
// 2 MiB. Below 132 blocks of 128 rows (N <= 16768) a block takes 64 rows
// and its two warpgroups split every F tile, 32 columns each (3 stages at
// D = 256), adding their sums at the end: 127 blocks at N = 8128 (one an
// SM), 266 MB. Above it each warpgroup owns 64 of a block's 128 rows and
// both read every tile (2 stages): 254 blocks at N = 32512, 533 MB, half
// the weight reads of 64-row blocks. chip_smoke.py's k1 phase times both
// schedules at both sizes.
//
// Backward: the TPU accumulates the weight gradients across a sequential
// grid; here blocks run concurrently, so the work is split in two passes
// and the cross-block sums are written as per-block partials that a third,
// small pass adds up in a fixed order (deterministic, no atomics):
//   A (row-parallel, owns dx): per block of rows, computes LN(x) and
//     dy2 = drop2(ff_scale * dy) once and also writes both ([N, D] each)
//     for pass B; loops over F tiles, recomputes z1 and dh = dy2 @ W2 per
//     tile, forms dz1 and accumulates dxn = dz1 @ W1; then the LayerNorm
//     VJP and dx; partials of dgamma, dbeta and db2.
//   B (F-tile-parallel, owns the weights): per tile of F and one of S row
//     splits, holds its W1/W2 tiles, loops over row chunks of A's LN(x)
//     and dy2 (so no F tile repeats the LayerNorm or the dy2 mask),
//     recomputes z1, the hidden and dz1 for its tile, and accumulates
//     dW1[tile] += dz1^T @ xn, dW2[:, tile] += dy2^T @ h and db1[tile];
//     partials per split.
//   R sums the partials.
// That is 14 N D F operations against the 10 N D F of the bound: the
// [N, F] hidden never touches device memory, as on the TPU.
//
// bf16 backward (namespace bwd16), designed for Hopper: in each pass TMA
// keeps 128B-swizzled tiles (64B for pass A's W2 tile) in flight through a
// ring of mbarrier-guarded stages, one thread refilling a stage as soon as
// every warp has released it, and 64-row warpgroups run wgmma with every
// sum in registers. Pass A's warpgroups keep LN(x) and dy2 of their rows in
// shared memory as the A operands; per F tile of 32 columns, z1 and dh
// come from wgmma, dz1 is formed in registers (bias, activation and its
// derivative, the mask of each element from its row and column) and fed
// back as the register A operand of dxn += dz1 W1t (an m64nD sum, 128
// registers a thread at D = 256). Pass B's two warpgroups split a row
// chunk: one computes z1^T and dW1, the other dh^T and dW2, trading the
// hidden and dh (bf16, in accumulator order) through shared memory under
// one named barrier a chunk; dW1 and dW2^T stay in registers over the
// whole split. The schedule fills the card from N (plan16). bf16 takes
// D in {64, 128, 256}; rows past N are zeros in the tiles, are masked out
// of the hidden, and are never stored or summed.
//
// The ragged row edge is masked in the kernels (rows past N are computed
// from zeros and never stored or summed).
//
// Weights arrive in torch.nn.Linear layout: W1 [F, D], W2 [D, F].
// Plain C interface, bound with ctypes; each launch returns
// cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_gmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // 227 KB usable by one block on sm_90
constexpr int kKeepAll = 65536;      // dropout threshold meaning "no mask"
constexpr int kBwdRows = 32;  // fp32: rows per pass-A block and pass-B chunk
constexpr int kBwdFtB = 32;   // fp32: F columns a pass-B block owns

// One dropout stream: keep iff (hash32((index + base) ^ key) & 0xFFFF) <
// thresh; base is the first row of this process's rows in the step's
// whole batch times the row's width (0 for a batch of its own).
struct Drop {
  uint32_t key;
  int thresh;
  float scale;
  uint32_t base;
};

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x21f0aaadu;
  x ^= x >> 15;
  x *= 0x735a2d97u;
  x ^= x >> 15;
  return x;
}

// v scaled by 1/keep where kept, 0 where dropped; index = row * ncols + col
// (mod 2^32, as the plain version computes it).
__device__ __forceinline__ float drop(const Drop& dp, uint32_t index,
                                      float v) {
  if (dp.thresh >= kKeepAll) return v;
  return (hash32((index + dp.base) ^ dp.key) & 0xFFFFu) < (uint32_t)dp.thresh
             ? v * dp.scale
             : 0.0f;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// act 0 = relu, 1 = swish (x * sigmoid(x)), both in fp32.
__device__ __forceinline__ float act_fn(float z, int act) {
  return act == 0 ? fmaxf(z, 0.0f) : z * (1.0f / (1.0f + expf(-z)));
}

__device__ __forceinline__ float act_deriv(float z, int act) {
  if (act == 0) return z > 0.0f ? 1.0f : 0.0f;
  const float s = 1.0f / (1.0f + expf(-z));
  return s * (1.0f + z * (1.0f - s));
}

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

// LayerNorm of rows [row0, row0 + rows) into xn (row stride ldx), one warp
// a row, two-pass mean/variance in fp32 as the Pallas kernel does. Rows at
// or past row_end are zero. With mu/rstd given, also stores each row's
// statistics.
template <typename T>
__device__ void layer_norm_rows(const T* __restrict__ x,
                                const float* __restrict__ g,
                                const float* __restrict__ bl, T* xn, int ldx,
                                int row0, int rows, int row_end, int d,
                                float eps, float* mu_out = nullptr,
                                float* rstd_out = nullptr) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    T* dst = xn + (size_t)r * ldx;
    const int gr = row0 + r;
    if (gr >= row_end) {
      for (int c = lane; c < d; c += 32) dst[c] = from_f<T>(0.0f);
      continue;
    }
    const T* src = x + (size_t)gr * d;
    float s = 0.0f;
    for (int c = lane; c < d; c += 32) s += to_f(src[c]);
    const float mu = warp_sum(s) / d;
    float v = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float t = to_f(src[c]) - mu;
      v += t * t;
    }
    const float rstd = rsqrtf(warp_sum(v) / d + eps);
    for (int c = lane; c < d; c += 32)
      dst[c] = from_f<T>((to_f(src[c]) - mu) * rstd * g[c] + bl[c]);
    if (mu_out != nullptr && lane == 0) {
      mu_out[r] = mu;
      rstd_out[r] = rstd;
    }
  }
}

// dyc[r, c] = cast(drop2(ff_scale * dy)) for rows [row0, row0 + rows);
// rows at or past row_end are zero. db2p takes the column sums of the
// fp32 drop2(ff_scale * dy) over the valid rows.
template <typename T>
__device__ void load_dy2(const T* __restrict__ dy, T* dyc, int ldx, int row0,
                         int rows, int row_end, int d, float ff_scale,
                         const Drop& dp2, float* __restrict__ db2p) {
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float colsum = 0.0f;
    for (int r = 0; r < rows; ++r) {
      const int gr = row0 + r;
      float v = 0.0f;
      if (gr < row_end) {
        v = drop(dp2, (uint32_t)gr * (uint32_t)d + (uint32_t)c,
                 to_f(dy[(size_t)gr * d + c]) * ff_scale);
        colsum += v;
      }
      dyc[r * ldx + c] = from_f<T>(v);
    }
    db2p[c] = colsum;
  }
}

// Copy rows [row0, row0 + rows) of src [*, d] into dst (row stride ld)
// element by element; rows at or past row_end are zero.
template <typename T>
__device__ void load_rows(const T* __restrict__ src, T* dst, int ld,
                          int row0, int rows, int row_end, int d) {
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, c = i % d, gr = row0 + r;
    dst[r * ld + c] = gr < row_end ? src[(size_t)gr * d + c] : from_f<T>(0.f);
  }
}

// The inverse: rows [row0, min(row0 + rows, n)) of src (row stride ld)
// into dst [*, d].
template <typename T>
__device__ void store_rows(const T* src, int ld, T* __restrict__ dst,
                           int row0, int rows, int n, int d) {
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, c = i % d, gr = row0 + r;
    if (gr < n) dst[(size_t)gr * d + c] = src[r * ld + c];
  }
}

// y = x + ff_scale * drop2(acc + b2), or acc + b2 without the residual.
template <typename T>
__device__ void store_residual(const T* __restrict__ x,
                               const float* __restrict__ b2, const float* acc,
                               int lda, T* __restrict__ y, int row0, int rows,
                               int n, int d, float ff_scale, const Drop& dp2,
                               bool residual) {
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, c = i % d, gr = row0 + r;
    if (gr < n) {
      const size_t o = (size_t)gr * d + c;
      const float y2 = drop(dp2, (uint32_t)o, acc[r * lda + c] + b2[c]);
      y[o] = from_f<T>(residual ? to_f(x[o]) + ff_scale * y2 : y2);
    }
  }
}

// dx = cast(acc) for rows [row0, min(row0 + rows, n)): ffn_fused's pass A,
// which has no LayerNorm to differentiate and no residual to add. Thread
// tid of the NT that share the rows.
template <typename T, int NT = kThreads>
__device__ void store_acc(int tid, const float* acc, int lda,
                          T* __restrict__ dx, int row0, int rows, int n,
                          int d) {
  for (int i = tid; i < rows * d; i += NT) {
    const int r = i / d, c = i % d, gr = row0 + r;
    if (gr < n) dx[(size_t)gr * d + c] = from_f<T>(acc[r * lda + c]);
  }
}

// After pass A's GEMMs: the LayerNorm VJP and dx (one warp a row), and the
// rows' partial column sums of dxn * xhat (dgamma) and dxn (dbeta). Thread
// tid of the NT that share the rows.
template <typename T, int NT = kThreads>
__device__ void ln_vjp_rows(int tid, const T* __restrict__ x,
                            const T* __restrict__ dy,
                            const float* __restrict__ g, const float* acc,
                            int lda, const float* mu, const float* rstd,
                            T* __restrict__ dx, float* __restrict__ dgp,
                            float* __restrict__ dblp, int row0, int rows,
                            int n, int d) {
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rows; r += NT / 32) {
    const int gr = row0 + r;
    if (gr >= n) continue;
    const float* a = acc + (size_t)r * lda;
    const T* xr = x + (size_t)gr * d;
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float dxhat = a[c] * g[c];
      s1 += dxhat;
      s2 += dxhat * (to_f(xr[c]) - mu[r]) * rstd[r];
    }
    const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
    for (int c = lane; c < d; c += 32) {
      const size_t o = (size_t)gr * d + c;
      const float xhat = (to_f(xr[c]) - mu[r]) * rstd[r];
      const float dx_ln = rstd[r] * (a[c] * g[c] - m1 - xhat * m2);
      dx[o] = from_f<T>(to_f(dy[o]) + dx_ln);
    }
  }
  for (int c = tid; c < d; c += NT) {
    float sg = 0.0f, sb = 0.0f;
    for (int r = 0; r < rows && row0 + r < n; ++r) {
      const float v = acc[r * lda + c];
      sg += v * (to_f(x[(size_t)(row0 + r) * d + c]) - mu[r]) * rstd[r];
      sb += v;
    }
    dgp[c] = sg;
    dblp[c] = sb;
  }
}

// ------------------------------------------------------ bf16 backward ---
// In both passes TMA keeps 128B-swizzled tiles in flight through a ring
// of stages guarded by mbarriers (full: the bytes arrived; empty: every
// warp is done with the stage, and one thread then loads the stage's next
// tile), and 64-row warpgroups run wgmma with the sums in registers. No
// separate producer warp: a 256-thread block keeps 255 registers a thread
// for the m64n256 sums (a ninth warp would cut that to 168, and ptxas then
// serialises the wgmma). No tile takes a round trip through shared memory
// between products of one F tile (pass A) or one row chunk (pass B) except
// the hidden and dh that pass B's two warpgroups trade. dh is rounded to
// bf16 before its mask and the activation's derivative, where the plain
// version's autograd rounds it (the cast of the hidden). The element-wise
// work between products is branch-free (the activation is chosen outside
// the unrolled loops, masks are selects) and the masks and biases are
// computed while the products run: with branches in them the loops split
// into serial blocks and took three quarters of the time.
namespace bwd16 {
using bf = __nv_bfloat16;
using namespace sm90;

constexpr int kWG = 128;      // threads of a warpgroup
constexpr int FT = 32;        // pass A: F columns of a weight tile
constexpr int FB = 64;        // pass B: F columns a block owns
constexpr int RC = 64;        // pass B: rows of a chunk
constexpr int kStagesB = 2;   // pass B: row chunks in flight

// Byte offset of element (r, c) in a K-major 128B-swizzled bf16 tile of
// `rows` rows stored as [cols / 64][rows][64], the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B (the region starts on 1024 bytes).
__device__ __forceinline__ uint32_t swz128(int rows, int r, int c) {
  const int cc = c & 63;
  return (uint32_t)((c >> 6) * rows * 128 + r * 128 +
                    (((cc >> 3) ^ (r & 7)) << 4) + (cc & 7) * 2);
}

// The activation ACT (0 relu, 1 swish) and its derivative at z, in fp32
// and without a branch, so that an unrolled loop of them stays one basic
// block the compiler can interleave; swish's sigmoid through the fast
// exponential and reciprocal (a few ulp from act_fn's, far below bf16's
// rounding).
template <int ACT>
__device__ __forceinline__ void act_pair(float z, float& a, float& da) {
  if constexpr (ACT == 0) {
    a = fmaxf(z, 0.0f);
    da = z > 0.0f ? 1.0f : 0.0f;
  } else {
    const float s = __fdividef(1.0f, 1.0f + __expf(-z));
    a = z * s;
    da = s * (1.0f + z * (1.0f - s));
  }
}

// Bit i of the result: the mask keeps index0 + i * step (drop()'s test,
// without its branch; a threshold of 65536 keeps every index).
template <int COUNT>
__device__ __forceinline__ uint32_t keep_bits(const Drop& dp,
                                              const uint32_t (&index)[COUNT]) {
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < COUNT; ++i)
    bits |= (uint32_t)((hash32((index[i] + dp.base) ^ dp.key) & 0xFFFFu) <
                       (uint32_t)dp.thresh) << i;
  return bits;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// acc (+)= A (registers) @ B (shared memory, MN-major; TB = 0: K-major),
// N = D.
template <int D, int TB = 1>
__device__ __forceinline__ void mma_rs_d(float (&acc)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (D == 64)
    mma_rs_n64<TB>(acc, a, b, 1);
  else if constexpr (D == 128)
    mma_rs_n128<TB>(acc, a, b, 1);
  else
    mma_rs_n256<TB>(acc, a, b, 1);
}

// Pass A's dz1 of one F tile in place of z1: drop1(bf16(dh)) act'(z1 + b1),
// bias[(r / 4) * 2 + r % 2] the bias of register r's column.
template <int ACT>
__device__ __forceinline__ void dz_tile(float (&z)[16], const float (&dh)[16],
                                        const float (&bias)[8], uint32_t kept,
                                        float scale) {
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    float a, da;
    act_pair<ACT>(z[r] + bias[(r >> 2) * 2 + (r & 1)], a, da);
    const float keep = (kept >> r) & 1u ? scale : 0.0f;
    z[r] = round_bf16(dh[r]) * keep * da;
  }
}

// Pass A shared memory, byte offsets from a 1024-aligned base: LN(x) (or
// x) and dy2 as K-major tiles [D/64][ROWS][64]; the ring of weight stages,
// each W1[f0:f0+FT, :] as [D/64][FT][64] (128B swizzle) then W2[:, f0:f0+FT]
// as [D][FT] (64B swizzle); the row statistics; the barriers. After the F
// loop the fp32 dxn [ROWS][D + 4] overlays the tiles and the ring.
struct LayoutA {
  uint32_t dy, ring, w2, stage, mu, rstd, full, empty, bytes;
};

__host__ __device__ inline LayoutA layout_a(int rows, int d, int stages) {
  LayoutA L;
  const uint32_t tile = (uint32_t)rows * d * 2;
  L.dy = tile;
  L.ring = 2 * tile;
  L.w2 = (uint32_t)FT * d * 2;
  L.stage = 2 * L.w2;
  uint32_t o = L.ring + stages * L.stage;
  const uint32_t acc = (uint32_t)rows * (d + 4) * 4;
  if (o < acc) o = acc;
  L.mu = o;
  L.rstd = L.mu + rows * 4;
  L.full = L.rstd + rows * 4;
  L.empty = L.full + 8 * stages;
  L.bytes = L.empty + 8 * stages;
  return L;
}

// Weight tile t into ring stage s: W1[t FT : t FT + FT, :] and
// W2[:, t FT : t FT + FT], completing the stage's full barrier.
template <int D>
__device__ __forceinline__ void load_w_tile(const LayoutA& L, uint32_t base,
                                            const CUtensorMap* w1,
                                            const CUtensorMap* w2, int s,
                                            int t) {
  const uint32_t st = base + L.ring + s * L.stage;
  const uint32_t full = base + L.full + 8 * s;
  mbar_expect_tx(full, L.stage);
  for (int c = 0; c < D / 64; ++c)
    tma_load_2d(st + c * FT * 128, w1, full, c * 64, t * FT);
  tma_load_2d(st + L.w2, w2, full, t * FT, 0);
}

// Pass A's warpgroups (see bwd_rows).
template <int D, int NWG, int STAGES>
__device__ __forceinline__ void rows_consumer(
    const LayoutA& L, unsigned char* smem, uint32_t base, int wid, int tid,
    const CUtensorMap* w1_map, const CUtensorMap* w2_map,
    const bf* __restrict__ x, const bf* __restrict__ dy,
    const float* __restrict__ g, const float* __restrict__ bl,
    const float* __restrict__ b1, bf* __restrict__ dx,
    bf* __restrict__ xn_out, bf* __restrict__ dy2_out,
    float* __restrict__ dgp, float* __restrict__ dblp,
    float* __restrict__ db2p, int n, int f, float ff_scale, float eps,
    int act, Drop dp1, Drop dp2) {
  constexpr int ROWS = 64 * NWG, LDA = D + 4;
  const int tiles = f / FT;
  const int w = wid / 4, t = tid % kWG, warp = wid % 4, lane = tid % 32;
  const int r0 = blockIdx.x * ROWS + 64 * w;  // this warpgroup's rows
  const size_t unit = (size_t)blockIdx.x * NWG + w;  // its partials' slot
  float* mu = reinterpret_cast<float*>(smem + L.mu) + 64 * w;
  float* rstd = reinterpret_cast<float*>(smem + L.rstd) + 64 * w;

  // LN(x) (or x), one warp a row, two-pass statistics in fp32.
  for (int r = warp; r < 64; r += 4) {
    const int gr = r0 + r;
    float v[D / 32];
#pragma unroll
    for (int j = 0; j < D / 32; ++j)
      v[j] = gr < n ? to_f(x[(size_t)gr * D + lane + 32 * j]) : 0.0f;
    if (g != nullptr && gr < n) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < D / 32; ++j) s += v[j];
      const float m = warp_sum(s) / D;
      float var = 0.0f;
#pragma unroll
      for (int j = 0; j < D / 32; ++j) var += (v[j] - m) * (v[j] - m);
      const float rs = rsqrtf(warp_sum(var) / D + eps);
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {
        const int c = lane + 32 * j;
        v[j] = (v[j] - m) * rs * g[c] + bl[c];
      }
      if (lane == 0) {
        mu[r] = m;
        rstd[r] = rs;
      }
    }
#pragma unroll
    for (int j = 0; j < D / 32; ++j) {
      const int c = lane + 32 * j;
      const bf b = __float2bfloat16(v[j]);
      *reinterpret_cast<bf*>(smem + swz128(ROWS, 64 * w + r, c)) = b;
      if (xn_out != nullptr && gr < n) xn_out[(size_t)gr * D + c] = b;
    }
  }
  // dy2 = drop2(ff_scale * dy), one thread a column; db2's partial.
  for (int c = t; c < D; c += kWG) {
    float colsum = 0.0f;
    for (int r = 0; r < 64; ++r) {
      const int gr = r0 + r;
      float v = 0.0f;
      if (gr < n) {
        v = drop(dp2, (uint32_t)gr * (uint32_t)D + (uint32_t)c,
                 to_f(dy[(size_t)gr * D + c]) * ff_scale);
        colsum += v;
      }
      const bf b = __float2bfloat16(v);
      *reinterpret_cast<bf*>(smem + L.dy + swz128(ROWS, 64 * w + r, c)) = b;
      if (dy2_out != nullptr && gr < n) dy2_out[(size_t)gr * D + c] = b;
    }
    db2p[unit * D + c] = colsum;
  }
  fence_async_smem();
  named_sync(1 + w, kWG);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float z[16], dh[16];
  uint32_t a0[4], a1[4];
  // Descriptors: LN(x) and dy2 K-major (A); per stage W1t K-major (z1's
  // B), W2t MN-major with 64B swizzle (dh's B), W1t MN-major (dxn's B).
  const uint64_t xd0 = desc(base + 64 * w * 128, 16, 1024, kSwizzle128);
  const uint64_t yd0 =
      desc(base + L.dy + 64 * w * 128, 16, 1024, kSwizzle128);
  const uint64_t w1k0 = desc(base + L.ring, 16, 1024, kSwizzle128);
  const uint64_t w2m0 = desc(base + L.ring + L.w2, 64, 512, kSwizzle64);
  const uint64_t w1m0 = desc(base + L.ring, FT * 128, 1024, kSwizzle128);
  for (int tt = 0; tt < tiles; ++tt) {
    const int s = tt % STAGES;
    mbar_wait(base + L.full + 8 * s, (tt / STAGES) & 1);
    const uint32_t so = s * L.stage;
    const uint64_t xd = opaque(xd0), yd = opaque(yd0);
    const uint64_t w1k = desc_at(opaque(w1k0), so);
    const uint64_t w2m = desc_at(opaque(w2m0), so);
    const uint64_t w1m = desc_at(opaque(w1m0), so);
    fence_regs(z);
    fence_regs(dh);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n32<0, 0>(
          z, desc_at(xd, (kk >> 2) * ROWS * 128 + (kk & 3) * 32),
          desc_at(w1k, (kk >> 2) * FT * 128 + (kk & 3) * 32), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n32<0, 1>(
          dh, desc_at(yd, (kk >> 2) * ROWS * 128 + (kk & 3) * 32),
          desc_at(w2m, kk * 1024), kk > 0);
    wg_commit();
    // While the products run: the tile's biases and hidden-mask bits.
    // Register r holds row 16 warp + lane / 4 + 8 ((r / 2) % 2) and column
    // f0 + 8 (r / 4) + 2 (lane % 4) + r % 2.
    const int f0 = tt * FT;
    float bias[8];
    uint32_t index[16];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      bias[q] = b1[f0 + 8 * (q >> 1) + 2 * (lane & 3) + (q & 1)];
#pragma unroll
    for (int r = 0; r < 16; ++r)
      index[r] = (uint32_t)(r0 + 16 * warp + lane / 4 + 8 * ((r >> 1) & 1)) *
                     (uint32_t)f +
                 f0 + 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
    const uint32_t kept = keep_bits<16>(dp1, index);
    wg_wait0();
    fence_regs(z);
    fence_regs(dh);
    if (act == 0)
      dz_tile<0>(z, dh, bias, kept, dp1.scale);
    else
      dz_tile<1>(z, dh, bias, kept, dp1.scale);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a0[q] = pack_bf16(z[2 * q], z[2 * q + 1]);
      a1[q] = pack_bf16(z[8 + 2 * q], z[8 + 2 * q + 1]);
    }
    fence_regs(a0);
    fence_regs(a1);
    fence_regs(acc);
    wg_fence();
    mma_rs_d<D>(acc, a0, w1m);
    mma_rs_d<D>(acc, a1, desc_at(w1m, 2048));
    wg_commit();
    wg_wait0();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(base + L.empty + 8 * s);
    if (tid == 0 && tt + STAGES < tiles) {
      mbar_wait(base + L.empty + 8 * s, (tt / STAGES) & 1);
      load_w_tile<D>(L, base, w1_map, w2_map, s, tt + STAGES);
    }
  }

  // Every warpgroup is past its last product: dxn overlays the tiles.
  named_sync(NWG + 1, NWG * kWG);
  float* accs = reinterpret_cast<float*>(smem) + 64 * w * LDA;
#pragma unroll
  for (int r = 0; r < D / 2; r += 2) {
    const int row = 16 * warp + lane / 4 + 8 * ((r >> 1) & 1);
    const int col = 8 * (r >> 2) + 2 * (lane & 3);
    *reinterpret_cast<float2*>(accs + row * LDA + col) =
        make_float2(acc[r], acc[r + 1]);
  }
  named_sync(1 + w, kWG);
  if (g == nullptr)
    store_acc<bf, kWG>(t, accs, LDA, dx, r0, 64, n, D);
  else
    ln_vjp_rows<bf, kWG>(t, x, dy, g, accs, LDA, mu, rstd, dx,
                         dgp + unit * D, dblp + unit * D, r0, 64, n, D);
}

// Pass A (row-parallel, owns dx): NWG warpgroups of 64 rows each. Each
// stages LN(x) (or x) and dy2 = drop2(ff_scale * dy) of its rows in bf16
// once (also into rows_buf for pass B), then per F tile of FT columns:
// z1 = xn W1t^T and dh = dy2 W2t (wgmma, shared-memory operands), dz1 =
// drop1(bf16(dh)) act'(z1 + b1) in registers, and dxn += dz1 W1t with dz1
// as register A fragments; after the loop the LayerNorm VJP (or the cast,
// for ffn_fused) and the partials of dgamma, dbeta and db2 of its 64-row
// unit. Thread 0 keeps the weight ring STAGES tiles ahead: it refills a
// stage once every warp has released it.
template <int D, int NWG, int STAGES>
__global__ void __launch_bounds__(NWG * kWG, 1)
bwd_rows(const __grid_constant__ CUtensorMap w1_map,
         const __grid_constant__ CUtensorMap w2_map, const bf* __restrict__ x,
         const bf* __restrict__ dy, const float* __restrict__ g,
         const float* __restrict__ bl, const float* __restrict__ b1,
         bf* __restrict__ dx, bf* __restrict__ xn_out,
         bf* __restrict__ dy2_out, float* __restrict__ dgp,
         float* __restrict__ dblp, float* __restrict__ db2p, int n, int f,
         float ff_scale, float eps, int act, Drop dp1, Drop dp2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const LayoutA L = layout_a(64 * NWG, D, STAGES);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(base + L.full + 8 * s, 1);
      mbar_init(base + L.empty + 8 * s, 4 * NWG);
    }
    mbar_init_fence();
    for (int t = 0; t < STAGES && t < f / FT; ++t)
      load_w_tile<D>(L, base, &w1_map, &w2_map, t, t);
  }
  __syncthreads();
  rows_consumer<D, NWG, STAGES>(L, smem, base, warp_uniform(tid / 32), tid,
                                &w1_map, &w2_map, x, dy, g, bl, b1, dx,
                                xn_out, dy2_out, dgp, dblp, db2p, n, f,
                                ff_scale, eps, act, dp1, dp2);
}

// Pass B shared memory: W1[f0:f0+FB, :] as [D/64][FB][64] and W2[:,
// f0:f0+FB] as [D][FB] (both 128B swizzle, resident), the ring of row
// chunks (xn then dy2, each [D/64][RC][64]), the two exchange buffers
// (bf16 pairs in the accumulator's order, [2][16][128] words each), the
// barriers.
struct LayoutB {
  uint32_t w2, ring, dyo, stage, xh, xd, full, empty, wbar, bytes;
};

__host__ __device__ inline LayoutB layout_b(int d) {
  LayoutB L;
  L.w2 = (uint32_t)FB * d * 2;
  L.ring = 2 * L.w2;
  L.dyo = (uint32_t)RC * d * 2;
  L.stage = 2 * L.dyo;
  L.xh = L.ring + kStagesB * L.stage;
  L.xd = L.xh + 2 * 16 * kWG * 4;
  L.full = L.xd + 2 * 16 * kWG * 4;
  L.empty = L.full + 8 * kStagesB;
  L.wbar = L.empty + 8 * kStagesB;
  L.bytes = L.wbar + 8;
  return L;
}

// Pass B's hidden of one chunk from z1^T in p: h = drop1(act(z1 + b1)) as
// bf16 pairs into out[q * kWG] (q = r / 2), and p = keep * act'(z1 + b1),
// bias[(r / 2) % 2] the bias of register r's F column.
template <int ACT>
__device__ __forceinline__ void hidden_tile(float (&p)[32], uint32_t* out,
                                            const float (&bias)[2],
                                            uint32_t kept, float scale) {
#pragma unroll
  for (int r = 0; r < 32; r += 2) {
    float h[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float a, da;
      act_pair<ACT>(p[r + e] + bias[(r >> 1) & 1], a, da);
      const float keep = (kept >> (r + e)) & 1u ? scale : 0.0f;
      h[e] = a * keep;
      p[r + e] = keep * da;
    }
    out[(r / 2) * kWG] = pack_bf16(h[0], h[1]);
  }
}

// Row chunk i of the split (rows row .. row + RC of xn and dy2) into ring
// stage s, completing the stage's full barrier; rows past N read as zeros.
template <int D>
__device__ __forceinline__ void load_chunk(const LayoutB& L, uint32_t base,
                                           const CUtensorMap* xn,
                                           const CUtensorMap* dy, int s,
                                           int row) {
  const uint32_t st = base + L.ring + s * L.stage;
  const uint32_t full = base + L.full + 8 * s;
  mbar_expect_tx(full, L.stage);
  for (int c = 0; c < D / 64; ++c) {
    tma_load_2d(st + c * RC * 128, xn, full, c * 64, row);
    tma_load_2d(st + L.dyo + c * RC * 128, dy, full, c * 64, row);
  }
}

// One warpgroup of pass B (ROLE 0: z1^T, the hidden, dW1 and db1; ROLE 1:
// dh^T and dW2, and its thread 0 refills the row ring) over every chunk
// of the block's row split.
template <int D, int ROLE>
__device__ __forceinline__ void weights_role(
    const LayoutB& L, unsigned char* smem, uint32_t base, int t, int warp,
    int lane, const CUtensorMap* xn_map, const CUtensorMap* dy_map,
    const float* __restrict__ b1, float* __restrict__ dw1p,
    float* __restrict__ dw2p, float* __restrict__ db1p, int f, int f0,
    int split, int r_begin, int r_end, int chunks, int act, Drop dp1) {
  uint32_t* xh = reinterpret_cast<uint32_t*>(smem + L.xh);
  uint32_t* xd = reinterpret_cast<uint32_t*>(smem + L.xd);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float p[32];
  uint32_t a[4][4];
  float db1s[2] = {0.0f, 0.0f};
  // Descriptors. A: W1t K-major (ROLE 0) or W2t MN-major (ROLE 1); B of
  // the first product: the chunk's xn or dy2, K-major; of the second: the
  // same, MN-major.
  const uint32_t rows = base + L.ring + (ROLE == 0 ? 0 : L.dyo);
  const uint64_t a0 = ROLE == 0
      ? desc(base, 16, 1024, kSwizzle128)
      : desc(base + L.w2, FB * 128, 1024, kSwizzle128);
  const uint64_t bk0 = desc(rows, 16, 1024, kSwizzle128);
  const uint64_t bm0 = desc(rows, RC * 128, 1024, kSwizzle128);
  // ROLE 0's registers hold F columns fc(r) = f0 + 16 warp + lane / 4 +
  // 8 ((r / 2) % 2) and chunk rows 8 (r / 4) + 2 (lane % 4) + r % 2.
  const int fc0 = f0 + 16 * warp + lane / 4;
  const float bias[2] = {ROLE == 0 ? b1[fc0] : 0.0f,
                         ROLE == 0 ? b1[fc0 + 8] : 0.0f};
  mbar_wait(base + L.wbar, 0);
  for (int i = 0; i < chunks; ++i) {
    const int s = i % kStagesB, buf = i & 1, row0 = r_begin + i * RC;
    mbar_wait(base + L.full + 8 * s, (i / kStagesB) & 1);
    const uint32_t so = s * L.stage;
    const uint64_t ad = opaque(a0);
    const uint64_t bk = desc_at(opaque(bk0), so);
    const uint64_t bm = desc_at(opaque(bm0), so);
    fence_regs(p);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t kb = (kk >> 2) * RC * 128 + (kk & 3) * 32;
      if constexpr (ROLE == 0)
        mma_ss_n64<0, 0>(
            p, desc_at(ad, (kk >> 2) * FB * 128 + (kk & 3) * 32),
            desc_at(bk, kb), kk > 0);
      else
        mma_ss_n64<1, 0>(p, desc_at(ad, kk * 2048), desc_at(bk, kb),
                         kk > 0);
    }
    wg_commit();
    // While the product runs: the hidden-mask bits, none past the split.
    uint32_t kept = 0;
    if constexpr (ROLE == 0) {
      uint32_t index[32];
#pragma unroll
      for (int r = 0; r < 32; ++r)
        index[r] = (uint32_t)(row0 + 8 * (r >> 2) + 2 * (lane & 3) +
                              (r & 1)) * (uint32_t)f +
                   fc0 + 8 * ((r >> 1) & 1);
      kept = keep_bits<32>(dp1, index);
#pragma unroll
      for (int r = 0; r < 32; ++r)
        kept &= ~((uint32_t)(row0 + 8 * (r >> 2) + 2 * (lane & 3) +
                             (r & 1) >= r_end) << r);
    }
    wg_wait0();
    fence_regs(p);

    if constexpr (ROLE == 0) {
      // p: z1^T (F rows, chunk rows as columns) -> keep * act'(z1 + b1).
      if (act == 0)
        hidden_tile<0>(p, xh + buf * 16 * kWG + t, bias, kept, dp1.scale);
      else
        hidden_tile<1>(p, xh + buf * 16 * kWG + t, bias, kept, dp1.scale);
    } else {
#pragma unroll
      for (int r = 0; r < 32; r += 2)
        xd[(buf * 16 + r / 2) * kWG + t] = pack_bf16(p[r], p[r + 1]);
    }
    named_sync(1, 2 * kWG);
    if constexpr (ROLE == 0) {
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const float2 d2 = unpack_bf16(xd[(buf * 16 + q) * kWG + t]);
        const float lo = d2.x * p[2 * q], hi = d2.y * p[2 * q + 1];
        db1s[q & 1] += lo + hi;
        a[q >> 2][q & 3] = pack_bf16(lo, hi);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 16; ++q)
        a[q >> 2][q & 3] = xh[(buf * 16 + q) * kWG + t];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs_d<D>(acc, a[kk], desc_at(bm, kk * 2048));
    wg_commit();
    wg_wait0();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(base + L.empty + 8 * s);
    if (ROLE == 1 && t == 0 && i + kStagesB < chunks) {
      mbar_wait(base + L.empty + 8 * s, (i / kStagesB) & 1);
      load_chunk<D>(L, base, xn_map, dy_map, s, row0 + kStagesB * RC);
    }
  }

  // The split's partials. acc: rows = F columns of the tile, cols = D.
  const int fr = 16 * warp + lane / 4;
  if constexpr (ROLE == 0) {
    float* p1 = dw1p + ((size_t)split * f + f0) * D;
#pragma unroll
    for (int r = 0; r < D / 2; r += 2) {
      const int m = fr + 8 * ((r >> 1) & 1);
      const int c = 8 * (r >> 2) + 2 * (lane & 3);
      *reinterpret_cast<float2*>(p1 + (size_t)m * D + c) =
          make_float2(acc[r], acc[r + 1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = db1s[h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((lane & 3) == 0) db1p[(size_t)split * f + f0 + fr + 8 * h] = v;
    }
  } else {
    float* p2 = dw2p + (size_t)split * D * f + f0;
#pragma unroll
    for (int r = 0; r < D / 2; ++r) {
      const int m = fr + 8 * ((r >> 1) & 1);
      const int c = 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
      p2[(size_t)c * f + m] = acc[r];
    }
  }
}

// Pass B (F-parallel, owns dW1, dW2 and db1): block (F tile, row split),
// two warpgroups. Per chunk of RC rows, warpgroup 0 computes z1^T = W1t
// xn^T, hands h^T = drop1(act(z1 + b1)) (zero past the split's rows) to
// warpgroup 1 and takes dh^T from it, forms dz1^T = drop1(dh^T) act'(z1 +
// b1) and adds dW1t += dz1^T xn and db1; warpgroup 1 computes dh^T =
// W2t^T dy2^T and adds dW2t^T += h^T dy2. Both weight sums stay in
// registers over the whole split and are written as the split's partials.
template <int D>
__global__ void __launch_bounds__(2 * kWG, 1)
bwd_weights(const __grid_constant__ CUtensorMap w1_map,
            const __grid_constant__ CUtensorMap w2_map,
            const __grid_constant__ CUtensorMap xn_map,
            const __grid_constant__ CUtensorMap dy_map,
            const float* __restrict__ b1, float* __restrict__ dw1p,
            float* __restrict__ dw2p, float* __restrict__ db1p, int n,
            int f, int rows_per_split, int act, Drop dp1) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const LayoutB L = layout_b(D);
  const int f0 = blockIdx.x * FB, split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);
  const int chunks = (r_end - r_begin + RC - 1) / RC;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStagesB; ++s) {
      mbar_init(base + L.full + 8 * s, 1);
      mbar_init(base + L.empty + 8 * s, 8);
    }
    mbar_init(base + L.wbar, 1);
    mbar_init_fence();
    const uint32_t wb = base + L.wbar;
    mbar_expect_tx(wb, 2 * L.w2);
    for (int c = 0; c < D / 64; ++c) {
      tma_load_2d(base + c * FB * 128, &w1_map, wb, c * 64, f0);
      tma_load_2d(base + L.w2 + c * 64 * 128, &w2_map, wb, f0, c * 64);
    }
    for (int i = 0; i < kStagesB && i < chunks; ++i)
      load_chunk<D>(L, base, &xn_map, &dy_map, i, r_begin + i * RC);
  }
  __syncthreads();
  const int wid = warp_uniform(tid / 32);
  if (wid < 4)
    weights_role<D, 0>(L, smem, base, tid % kWG, wid, tid % 32, &xn_map,
                       &dy_map, b1, dw1p, dw2p, db1p, f, f0, split, r_begin,
                       r_end, chunks, act, dp1);
  else
    weights_role<D, 1>(L, smem, base, tid % kWG, wid - 4, tid % 32, &xn_map,
                       &dy_map, b1, dw1p, dw2p, db1p, f, f0, split, r_begin,
                       r_end, chunks, act, dp1);
}
}  // namespace bwd16

// ------------------------------------------------------- bf16 forward ---
// Two warpgroups a block, one block an SM (see the note at the top). TMA
// keeps the weight tiles of FT columns in flight through a ring of
// mbarrier-guarded stages; the last warp to release a stage refills it. Per
// F tile a warpgroup computes z1 = A W1t^T (wgmma, both operands in shared
// memory), forms the hidden in registers (bias, activation, mask, bf16) and
// feeds it as the register A operand of acc += h W2t^T, whose [64, D] sum
// stays in registers over the whole F loop. The element-wise work is
// branch-free inside the unrolled loops, and the biases and mask bits are
// formed while z1's product runs.
namespace fwd16 {
using bf = __nv_bfloat16;
using namespace sm90;
using bwd16::act_pair;
using bwd16::keep_bits;
using bwd16::kWG;
using bwd16::mma_rs_d;
using bwd16::swz128;

constexpr int FT = 64;   // F columns of a weight tile

// Rows of a block: SPLIT, two warpgroups share 64 rows and split each F
// tile's columns; else each warpgroup owns 64 of 128 rows.
__host__ __device__ constexpr int rows_of(int split) {
  return split ? 64 : 128;
}

__host__ __device__ constexpr uint32_t stage_bytes(int d) {
  return 2u * FT * d * 2;
}

// As many stages as fit beside the A tile, at most 4.
__host__ __device__ constexpr int stages(int d, int split) {
  const long long s = ((long long)kMaxSmem - 1024 - 128 -
                       (long long)rows_of(split) * d * 2) /
                      stage_bytes(d);
  return s > 4 ? 4 : (int)s;
}

// Shared memory, byte offsets from a 1024-aligned base: the A tile (LN(x)
// or x, K-major, [D/64][ROWS][64], 128B swizzle); the ring, each stage
// W1[f0:f0+FT, :] as [D/64][FT][64] then W2[:, f0:f0+FT] as [D][64] (both
// K-major B operands, 128B swizzle); after the F loop the two warpgroups'
// fp32 sums [2][64][D + 4] overlay both; then the full barriers, the
// barrier of x's load and the release counts.
struct Layout {
  uint32_t ring, w2, stage, full, xbar, count, bytes;
};

__host__ __device__ inline Layout layout(int d, int split) {
  Layout L;
  L.ring = (uint32_t)rows_of(split) * d * 2;
  L.w2 = (uint32_t)FT * d * 2;
  L.stage = stage_bytes(d);
  uint32_t o = L.ring + stages(d, split) * L.stage;
  const uint32_t sums = 2u * 64 * (d + 4) * 4;
  if (o < sums) o = sums;
  L.full = o;
  L.xbar = L.full + 8 * 4;
  L.count = L.xbar + 8;
  L.bytes = L.count + 4 * 4;
  return L;
}

// Weight tile t into ring stage s, completing the stage's full barrier.
template <int D>
__device__ __forceinline__ void load_tile(const Layout& L, uint32_t base,
                                          const CUtensorMap* w1,
                                          const CUtensorMap* w2, int s,
                                          int t) {
  const uint32_t st = base + L.ring + s * L.stage;
  const uint32_t full = base + L.full + 8 * s;
  mbar_expect_tx(full, L.stage);
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_2d(st + c * FT * 128, w1, full, c * 64, t * FT);
  tma_load_2d(st + L.w2, w2, full, t * FT, 0);
}

// LN(x) of the block's rows into the A tile as bf16: one warp a row, D / 32
// consecutive columns a lane, two-pass statistics in fp32 as the Pallas
// kernel takes them; rows at or past n are zeros.
template <int D, int ROWS>
__device__ __forceinline__ void ln_tile(unsigned char* smem,
                                        const bf* __restrict__ x,
                                        const float* __restrict__ g,
                                        const float* __restrict__ bl,
                                        int row0, int n, float eps) {
  constexpr int V = D / 32, W = V / 2;   // values and bf16 pairs a lane
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = lane * V;
  for (int r = warp; r < ROWS; r += 2 * kWG / 32) {
    const int gr = row0 + r;
    uint32_t w[W];
#pragma unroll
    for (int j = 0; j < W; ++j) w[j] = 0u;
    if (gr < n) {
      const bf* src = x + (size_t)gr * D + c0;
      if constexpr (W == 4) {
        const uint4 q = *reinterpret_cast<const uint4*>(src);
        w[0] = q.x;
        w[1] = q.y;
        w[2] = q.z;
        w[3] = q.w;
      } else if constexpr (W == 2) {
        const uint2 q = *reinterpret_cast<const uint2*>(src);
        w[0] = q.x;
        w[1] = q.y;
      } else {
        w[0] = *reinterpret_cast<const uint32_t*>(src);
      }
      float v[V];
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const float2 p = unpack_bf16(w[j]);
        v[2 * j] = p.x;
        v[2 * j + 1] = p.y;
      }
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < V; ++j) s += v[j];
      const float m = warp_sum(s) / D;
      float var = 0.0f;
#pragma unroll
      for (int j = 0; j < V; ++j) var += (v[j] - m) * (v[j] - m);
      const float rs = rsqrtf(warp_sum(var) / D + eps);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int c = c0 + 2 * j;
        w[j] = pack_bf16((v[2 * j] - m) * rs * g[c] + bl[c],
                         (v[2 * j + 1] - m) * rs * g[c + 1] + bl[c + 1]);
      }
    }
    unsigned char* dst = smem + swz128(ROWS, r, c0);
    if constexpr (W == 4)
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    else if constexpr (W == 2)
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(dst) = w[0];
  }
}

// The hidden of a warpgroup's NC = 2 NR columns of one F tile from z1:
// bf16(drop1(act(z1 + b1))), packed as the register A fragments of the
// NC / 16 k-steps of the second product; bias[(r / 4) * 2 + r % 2] is the
// bias of register r's column.
template <int ACT, int NR>
__device__ __forceinline__ void hidden_tile(const float (&z)[NR],
                                            const float (&bias)[NR / 2],
                                            uint32_t kept, float scale,
                                            uint32_t (&a)[NR / 8][4]) {
#pragma unroll
  for (int r = 0; r < NR; r += 2) {
    float h[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v, dv;   // dv unused: the compiler drops it
      act_pair<ACT>(z[r + e] + bias[(r >> 2) * 2 + e], v, dv);
      h[e] = v * ((kept >> (r + e)) & 1u ? scale : 0.0f);
    }
    a[r >> 3][(r >> 1) & 3] = pack_bf16(h[0], h[1]);
  }
}

// z (+)= A @ B, both K-major in shared memory, N = NR * 2.
template <int NR>
__device__ __forceinline__ void mma_ss_z(float (&z)[NR], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (NR == 16)
    mma_ss_n32<0, 0>(z, a, b, scale_d);
  else
    mma_ss_n64<0, 0>(z, a, b, scale_d);
}

// y for the block's rows, ln_ffn_residual (g given) or ffn_fused (g ==
// nullptr: x arrives in the A tile by TMA; no output mask, no residual).
// Both warpgroups take every F tile: with SPLIT each its 32 of the tile's
// 64 columns over the block's 64 rows, else all 64 over its own 64 rows.
template <int D, int SPLIT>
__global__ void __launch_bounds__(2 * kWG, 1)
ffn_fwd(const __grid_constant__ CUtensorMap w1_map,
        const __grid_constant__ CUtensorMap w2_map,
        const __grid_constant__ CUtensorMap x_map, const bf* __restrict__ x,
        const float* __restrict__ g, const float* __restrict__ bl,
        const float* __restrict__ b1, const float* __restrict__ b2,
        bf* __restrict__ y, int n, int f, float ff_scale, float eps, int act,
        Drop dp1, Drop dp2) {
  constexpr int ROWS = rows_of(SPLIT), STAGES = stages(D, SPLIT);
  constexpr int LD = D + 4, NC = SPLIT ? FT / 2 : FT, NR = NC / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const Layout L = layout(D, SPLIT);
  int* count = reinterpret_cast<int*>(smem + L.count);
  const int tid = threadIdx.x, row0 = blockIdx.x * ROWS, tiles = f / FT;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(base + L.full + 8 * s, 1);
      count[s] = 0;
    }
    mbar_init(base + L.xbar, 1);
    mbar_init_fence();
    for (int t = 0; t < STAGES && t < tiles; ++t)
      load_tile<D>(L, base, &w1_map, &w2_map, t, t);
    if (g == nullptr) {
      // x's 64-row boxes that hold a row below n (rows past n read as
      // zeros; a box wholly past it is not loaded, and its rows, never
      // stored, keep whatever the tile held).
      const int boxes = min(ROWS / 64, (n - row0 + 63) / 64);
      mbar_expect_tx(base + L.xbar, boxes * 64 * D * 2);
      for (int rb = 0; rb < boxes; ++rb)
        for (int c = 0; c < D / 64; ++c)
          tma_load_2d(base + c * ROWS * 128 + rb * 64 * 128, &x_map,
                      base + L.xbar, c * 64, row0 + rb * 64);
    }
  }
  if (g != nullptr) {
    ln_tile<D, ROWS>(smem, x, g, bl, row0, n, eps);
    fence_async_smem();
  }
  __syncthreads();
  if (g == nullptr) mbar_wait(base + L.xbar, 0);

  const int wid = warp_uniform(tid / 32);
  const int wg = wid / 4, warp = wid % 4, lane = tid % 32;
  const int r_wg = SPLIT ? 0 : 64 * wg;    // the warpgroup's rows ...
  const int c_wg = SPLIT ? NC * wg : 0;    // ... and columns of a tile
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float z[NR];
  uint32_t a[NR / 8][4];
  // Descriptors, all K-major: the warpgroup's rows of the A tile, its
  // columns of each stage's W1t (z1's B: rows of W1) and its k-steps of
  // W2t (the second product's B).
  const uint64_t ad0 = desc(base + r_wg * 128, 16, 1024, kSwizzle128);
  const uint64_t w1d0 =
      desc(base + L.ring + c_wg * 128, 16, 1024, kSwizzle128);
  const uint64_t w2d0 =
      desc(base + L.ring + L.w2 + c_wg * 2, 16, 1024, kSwizzle128);
  // Register r of z1 holds row `row` + 8 ((r / 2) % 2) and column `col` +
  // 8 (r / 4) + r % 2 of the tile.
  const uint32_t row = (uint32_t)(row0 + r_wg + 16 * warp + lane / 4);
  for (int i = 0; i < tiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(base + L.full + 8 * s, (i / STAGES) & 1);
    const uint32_t so = s * L.stage;
    const uint64_t ad = opaque(ad0);
    const uint64_t w1d = desc_at(opaque(w1d0), so);
    const uint64_t w2d = desc_at(opaque(w2d0), so);
    fence_regs(z);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_z<NR>(z, desc_at(ad, (kk >> 2) * ROWS * 128 + (kk & 3) * 32),
                   desc_at(w1d, (kk >> 2) * FT * 128 + (kk & 3) * 32),
                   kk > 0);
    wg_commit();
    // While the product runs: the biases and hidden-mask bits.
    const int col = i * FT + c_wg + 2 * (lane & 3);
    float bias[NR / 2];
#pragma unroll
    for (int q = 0; q < NR / 2; ++q)
      bias[q] = b1[col + 8 * (q >> 1) + (q & 1)];
    uint32_t kept = 0xFFFFFFFFu;
    if (dp1.thresh < kKeepAll) {
      uint32_t index[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r)
        index[r] = (row + 8 * ((r >> 1) & 1)) * (uint32_t)f + col +
                   8 * (r >> 2) + (r & 1);
      kept = keep_bits<NR>(dp1, index);
    }
    wg_wait0();
    fence_regs(z);
    if (act == 0)
      hidden_tile<0, NR>(z, bias, kept, dp1.scale, a);
    else
      hidden_tile<1, NR>(z, bias, kept, dp1.scale, a);
#pragma unroll
    for (int kk = 0; kk < NR / 8; ++kk) fence_regs(a[kk]);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NR / 8; ++kk)
      mma_rs_d<D, 0>(acc, a[kk], desc_at(w2d, kk * 32));
    wg_commit();
    wg_wait0();
    fence_regs(acc);
    // The warp is done with the stage. The last of the eight warps to say
    // so loads tile i + STAGES into it; counts only grow, so the stage's
    // k-th tile is released when its count reaches 8 (k + 1).
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&count[s], 1) == 8 * (i / STAGES + 1) - 1 &&
          i + STAGES < tiles) {
        __threadfence_block();
        load_tile<D>(L, base, &w1_map, &w2_map, s, i + STAGES);
      }
    }
  }

  // Every warpgroup is past its last product: the sums overlay the tiles.
  __syncthreads();
  float* sums = reinterpret_cast<float*>(smem);
  float* mine = sums + wg * 64 * LD;
#pragma unroll
  for (int r = 0; r < D / 2; r += 2) {
    const int rr = 16 * warp + lane / 4 + 8 * ((r >> 1) & 1);
    const int cc = 8 * (r >> 2) + 2 * (lane & 3);
    *reinterpret_cast<float2*>(mine + rr * LD + cc) =
        make_float2(acc[r], acc[r + 1]);
  }
  __syncthreads();
  // Eight columns a thread, rows in order: + b2, and for ln_ffn_residual
  // the output mask, the scale and the residual in fp32; one cast.
  for (int i = tid; i < ROWS * (D / 8); i += 2 * kWG) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8, gr = row0 + r;
    if (gr >= n) break;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; j += 4) {
      float4 p = *reinterpret_cast<const float4*>(sums + r * LD + c + j);
      if (SPLIT) {
        const float4 q =
            *reinterpret_cast<const float4*>(sums + (64 + r) * LD + c + j);
        p.x += q.x;
        p.y += q.y;
        p.z += q.z;
        p.w += q.w;
      }
      v[j] = p.x + b2[c + j];
      v[j + 1] = p.y + b2[c + j + 1];
      v[j + 2] = p.z + b2[c + j + 2];
      v[j + 3] = p.w + b2[c + j + 3];
    }
    const size_t o = (size_t)gr * D + c;
    if (g != nullptr) {
      const uint4 q = *reinterpret_cast<const uint4*>(x + o);
      const uint32_t xw[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 xv = unpack_bf16(xw[j]);
        v[2 * j] = xv.x + ff_scale * drop(dp2, (uint32_t)(o + 2 * j),
                                          v[2 * j]);
        v[2 * j + 1] =
            xv.y + ff_scale * drop(dp2, (uint32_t)(o + 2 * j + 1),
                                   v[2 * j + 1]);
      }
    }
    *reinterpret_cast<uint4*>(y + o) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}
}  // namespace fwd16

// ---------------------------------------------------------------- fp32 ---
namespace f32k {
constexpr int FT = 32;

struct Layout {
  int ldx, ldw1, ldw2, ldh, lda;
  size_t o_w1, o_w2, o_h, o_acc, bytes;
};

__host__ __device__ inline Layout layout(int rows, int d) {
  Layout L;
  L.ldx = d + 1;        // odd strides: lanes that walk rows hit distinct banks
  L.ldw1 = d + 1;
  L.ldw2 = FT + 1;
  L.ldh = FT + 1;
  L.lda = d;
  size_t o = align128((size_t)rows * L.ldx * 4);
  L.o_w1 = o;
  o += align128((size_t)FT * L.ldw1 * 4);
  L.o_w2 = o;
  o += align128((size_t)d * L.ldw2 * 4);
  L.o_h = o;
  o += align128((size_t)rows * L.ldh * 4);
  L.o_acc = o;
  o += align128((size_t)rows * L.lda * 4);
  L.bytes = o;
  return L;
}

__device__ void stage_weights(const float* __restrict__ w1,
                              const float* __restrict__ w2, float* w1s,
                              int ldw1, float* w2s, int ldw2, int f0, int ft,
                              int d, int f) {
  const int vec_w1 = d / 4, vec_w2 = ft / 4;
  for (int i = threadIdx.x; i < ft * vec_w1; i += kThreads) {
    const int j = i / vec_w1, v = i % vec_w1;
    const float4 q =
        *reinterpret_cast<const float4*>(w1 + (size_t)(f0 + j) * d + v * 4);
    float* dst = w1s + j * ldw1 + v * 4;
    dst[0] = q.x; dst[1] = q.y; dst[2] = q.z; dst[3] = q.w;
  }
  for (int i = threadIdx.x; i < d * vec_w2; i += kThreads) {
    const int c = i / vec_w2, v = i % vec_w2;
    const float4 q =
        *reinterpret_cast<const float4*>(w2 + (size_t)c * f + f0 + v * 4);
    float* dst = w2s + c * ldw2 + v * 4;
    dst[0] = q.x; dst[1] = q.y; dst[2] = q.z; dst[3] = q.w;
  }
}

__device__ __forceinline__ float dot_rows(const float* a, const float* b,
                                          int k) {
  float s = 0.0f;
  for (int i = 0; i < k; ++i) s = fmaf(a[i], b[i], s);
  return s;
}

__device__ __forceinline__ float dot_col(const float* a, const float* b,
                                         int ldb, int k) {
  float s = 0.0f;
  for (int i = 0; i < k; ++i) s = fmaf(a[i], b[i * ldb], s);
  return s;
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
ln_ffn_fwd(const float* __restrict__ x, const float* __restrict__ g,
           const float* __restrict__ bl, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ w2,
           const float* __restrict__ b2, float* __restrict__ y, int n, int d,
           int f, float ff_scale, float eps, int act, Drop dp1, Drop dp2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(ROWS, d);
  float* xn = reinterpret_cast<float*>(smem);
  float* w1s = reinterpret_cast<float*>(smem + L.o_w1);
  float* w2s = reinterpret_cast<float*>(smem + L.o_w2);
  float* h = reinterpret_cast<float*>(smem + L.o_h);
  float* acc = reinterpret_cast<float*>(smem + L.o_acc);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;

  if (g != nullptr)
    layer_norm_rows<float>(x, g, bl, xn, L.ldx, row0, ROWS, n, d, eps);
  else
    load_rows<float>(x, xn, L.ldx, row0, ROWS, n, d);
  for (int i = tid; i < ROWS * L.lda; i += kThreads) acc[i] = 0.0f;

  for (int f0 = 0; f0 < f; f0 += FT) {
    stage_weights(w1, w2, w1s, L.ldw1, w2s, L.ldw2, f0, FT, d, f);
    __syncthreads();

    // GEMM1 + bias + activation + dropout: one output a thread per pass.
    for (int i = tid; i < ROWS * FT; i += kThreads) {
      const int r = i / FT, j = i % FT;
      const float z = dot_rows(xn + r * L.ldx, w1s + j * L.ldw1, d);
      h[r * L.ldh + j] =
          drop(dp1, (uint32_t)(row0 + r) * (uint32_t)f + f0 + j,
               act_fn(z + b1[f0 + j], act));
    }
    __syncthreads();

    // GEMM2: acc[ROWS, D] += h[ROWS, FT] @ W2_tile^T.
    for (int i = tid; i < ROWS * d; i += kThreads) {
      const int r = i / d, c = i % d;
      acc[r * L.lda + c] += dot_rows(h + r * L.ldh, w2s + c * L.ldw2, FT);
    }
    __syncthreads();
  }
  store_residual<float>(x, b2, acc, L.lda, y, row0, ROWS, n, d, ff_scale,
                        dp2, g != nullptr);
}

// Pass A: the forward's layout plus dy2 [ROWS][ldx] and row statistics;
// the h tile holds dz1.
struct LayoutA {
  Layout f;
  size_t o_dy, o_mu, o_rstd, bytes;
};

__host__ __device__ inline LayoutA layout_a(int rows, int d) {
  LayoutA L;
  L.f = layout(rows, d);
  size_t o = L.f.bytes;
  L.o_dy = o;
  o += align128((size_t)rows * L.f.ldx * 4);
  L.o_mu = o;
  o += align128((size_t)rows * 4);
  L.o_rstd = o;
  o += align128((size_t)rows * 4);
  L.bytes = o;
  return L;
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
ln_ffn_bwd_rows(const float* __restrict__ x, const float* __restrict__ dy,
                const float* __restrict__ g, const float* __restrict__ bl,
                const float* __restrict__ w1, const float* __restrict__ b1,
                const float* __restrict__ w2, float* __restrict__ dx,
                float* __restrict__ xn_out, float* __restrict__ dy2_out,
                float* __restrict__ dgp, float* __restrict__ dblp,
                float* __restrict__ db2p, int n, int d, int f,
                float ff_scale, float eps, int act, Drop dp1, Drop dp2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LayoutA LA = layout_a(ROWS, d);
  const Layout& L = LA.f;
  float* xn = reinterpret_cast<float*>(smem);
  float* w1s = reinterpret_cast<float*>(smem + L.o_w1);
  float* w2s = reinterpret_cast<float*>(smem + L.o_w2);
  float* dz = reinterpret_cast<float*>(smem + L.o_h);
  float* acc = reinterpret_cast<float*>(smem + L.o_acc);
  float* dyc = reinterpret_cast<float*>(smem + LA.o_dy);
  float* mu = reinterpret_cast<float*>(smem + LA.o_mu);
  float* rstd = reinterpret_cast<float*>(smem + LA.o_rstd);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const size_t part = (size_t)blockIdx.x * d;

  if (g != nullptr)
    layer_norm_rows<float>(x, g, bl, xn, L.ldx, row0, ROWS, n, d, eps, mu,
                           rstd);
  else
    load_rows<float>(x, xn, L.ldx, row0, ROWS, n, d);
  load_dy2<float>(dy, dyc, L.ldx, row0, ROWS, n, d, ff_scale, dp2,
                  db2p + part);
  for (int i = tid; i < ROWS * L.lda; i += kThreads) acc[i] = 0.0f;
  __syncthreads();
  if (xn_out != nullptr) {
    store_rows<float>(xn, L.ldx, xn_out, row0, ROWS, n, d);
    store_rows<float>(dyc, L.ldx, dy2_out, row0, ROWS, n, d);
  }

  for (int f0 = 0; f0 < f; f0 += FT) {
    stage_weights(w1, w2, w1s, L.ldw1, w2s, L.ldw2, f0, FT, d, f);
    __syncthreads();

    // dz1 = drop1(dy2 @ W2_tile) * act'(xn @ W1_tile^T + b1).
    for (int i = tid; i < ROWS * FT; i += kThreads) {
      const int r = i / FT, j = i % FT;
      const float z =
          dot_rows(xn + r * L.ldx, w1s + j * L.ldw1, d) + b1[f0 + j];
      const float dh = dot_col(dyc + r * L.ldx, w2s + j, L.ldw2, d);
      dz[r * L.ldh + j] =
          drop(dp1, (uint32_t)(row0 + r) * (uint32_t)f + f0 + j, dh) *
          act_deriv(z, act);
    }
    __syncthreads();

    // acc[ROWS, D] += dz[ROWS, FT] @ W1_tile[FT, D].
    for (int i = tid; i < ROWS * d; i += kThreads) {
      const int r = i / d, c = i % d;
      acc[r * L.lda + c] += dot_col(dz + r * L.ldh, w1s + c, L.ldw1, FT);
    }
    __syncthreads();
  }
  if (g != nullptr)
    ln_vjp_rows<float>(threadIdx.x, x, dy, g, acc, L.lda, mu, rstd, dx,
                       dgp + part, dblp + part, row0, ROWS, n, d);
  else
    store_acc<float>(threadIdx.x, acc, L.lda, dx, row0, ROWS, n, d);
}

struct LayoutB {
  int ldx, ldw1, ldw2, ldt, ld2;
  size_t o_w1, o_w2, o_dy, o_h, o_dz, o_a1, o_a2, o_b1, bytes;
};

__host__ __device__ inline LayoutB layout_b(int d) {
  constexpr int RB = kBwdRows, FB = kBwdFtB;
  LayoutB L;
  L.ldx = d + 1;
  L.ldw1 = d + 1;
  L.ldw2 = FB + 1;
  L.ldt = FB + 1;
  L.ld2 = FB + 1;
  size_t o = align128((size_t)RB * L.ldx * 4);
  L.o_w1 = o;
  o += align128((size_t)FB * L.ldw1 * 4);
  L.o_w2 = o;
  o += align128((size_t)d * L.ldw2 * 4);
  L.o_dy = o;
  o += align128((size_t)RB * L.ldx * 4);
  L.o_h = o;
  o += align128((size_t)RB * L.ldt * 4);
  L.o_dz = o;
  o += align128((size_t)RB * L.ldt * 4);
  L.o_a1 = o;
  o += align128((size_t)FB * d * 4);
  L.o_a2 = o;
  o += align128((size_t)d * L.ld2 * 4);
  L.o_b1 = o;
  o += align128((size_t)FB * 4);
  L.bytes = o;
  return L;
}

__global__ void __launch_bounds__(kThreads)
ln_ffn_bwd_weights(const float* __restrict__ xn_g,
                   const float* __restrict__ dy2_g,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, float* __restrict__ dw1p,
                   float* __restrict__ dw2p, float* __restrict__ db1p, int n,
                   int d, int f, int rows_per_split, int act, Drop dp1) {
  constexpr int RB = kBwdRows, FB = kBwdFtB;
  extern __shared__ __align__(128) unsigned char smem[];
  const LayoutB L = layout_b(d);
  float* xn = reinterpret_cast<float*>(smem);
  float* w1s = reinterpret_cast<float*>(smem + L.o_w1);
  float* w2s = reinterpret_cast<float*>(smem + L.o_w2);
  float* dyc = reinterpret_cast<float*>(smem + L.o_dy);
  float* hc = reinterpret_cast<float*>(smem + L.o_h);
  float* dz = reinterpret_cast<float*>(smem + L.o_dz);
  float* a1 = reinterpret_cast<float*>(smem + L.o_a1);
  float* a2 = reinterpret_cast<float*>(smem + L.o_a2);
  float* sb1 = reinterpret_cast<float*>(smem + L.o_b1);
  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * FB, split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);

  stage_weights(w1, w2, w1s, L.ldw1, w2s, L.ldw2, f0, FB, d, f);
  for (int i = tid; i < FB * d; i += kThreads) a1[i] = 0.0f;
  for (int i = tid; i < d * L.ld2; i += kThreads) a2[i] = 0.0f;
  for (int i = tid; i < FB; i += kThreads) sb1[i] = 0.0f;
  // The write-out below maps a2 to threads otherwise than the zeroing.
  __syncthreads();

  for (int row0 = r_begin; row0 < r_end; row0 += RB) {
    load_rows<float>(xn_g, xn, L.ldx, row0, RB, r_end, d);
    load_rows<float>(dy2_g, dyc, L.ldx, row0, RB, r_end, d);
    __syncthreads();

    for (int i = tid; i < RB * FB; i += kThreads) {
      const int r = i / FB, j = i % FB, gr = row0 + r;
      float hv = 0.0f, dzv = 0.0f;
      if (gr < r_end) {
        const uint32_t idx = (uint32_t)gr * (uint32_t)f + f0 + j;
        const float z =
            dot_rows(xn + r * L.ldx, w1s + j * L.ldw1, d) + b1[f0 + j];
        const float dh = dot_col(dyc + r * L.ldx, w2s + j, L.ldw2, d);
        const float keep = drop(dp1, idx, 1.0f);    // 1/keep or 0
        hv = act_fn(z, act) * keep;
        dzv = dh * keep * act_deriv(z, act);
      }
      hc[r * L.ldt + j] = hv;
      dz[r * L.ldt + j] = dzv;
    }
    __syncthreads();

    // a1[FB, D] += dz^T @ xn; a2[D, FB] += dy2^T @ h; db1 += sum dz.
    for (int i = tid; i < FB * d; i += kThreads) {
      const int j = i / d, c = i % d;
      float s = 0.0f;
      for (int r = 0; r < RB; ++r)
        s = fmaf(dz[r * L.ldt + j], xn[r * L.ldx + c], s);
      a1[i] += s;
    }
    for (int i = tid; i < d * FB; i += kThreads) {
      const int c = i / FB, j = i % FB;
      float s = 0.0f;
      for (int r = 0; r < RB; ++r)
        s = fmaf(dyc[r * L.ldx + c], hc[r * L.ldt + j], s);
      a2[c * L.ld2 + j] += s;
    }
    for (int j = tid; j < FB; j += kThreads) {
      float s = 0.0f;
      for (int r = 0; r < RB; ++r) s += dz[r * L.ldt + j];
      sb1[j] += s;
    }
    __syncthreads();
  }
  float* p1 = dw1p + (size_t)split * f * d;
  float* p2 = dw2p + (size_t)split * d * f;
  for (int i = tid; i < FB * d; i += kThreads) {
    const int j = i / d, c = i % d;
    p1[(size_t)(f0 + j) * d + c] = a1[i];
  }
  for (int i = tid; i < d * FB; i += kThreads) {
    const int c = i / FB, j = i % FB;
    p2[(size_t)c * f + f0 + j] = a2[c * L.ld2 + j];
  }
  for (int j = tid; j < FB; j += kThreads)
    db1p[(size_t)split * f + f0 + j] = sb1[j];
}
}  // namespace f32k

// out[j] = sum over s of part[s * m + j], in order of s; block (32, 8):
// threadIdx.y strides over s, the 8 partial sums are added in a fixed
// order.
__global__ void sum_partials(const float* __restrict__ part,
                             float* __restrict__ out, int s_count, int m) {
  __shared__ float tile[8][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (j < m)
    for (int k = threadIdx.y; k < s_count; k += 8)
      s += part[(size_t)k * m + j];
  tile[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < m) {
    float t = 0.0f;
    for (int k = 0; k < 8; ++k) t += tile[k][threadIdx.x];
    out[j] = t;
  }
}

cudaError_t sum_into(const float* part, float* out, int s_count, int m,
                     cudaStream_t stream) {
  sum_partials<<<(m + 31) / 32, dim3(32, 8), 0, stream>>>(part, out, s_count,
                                                          m);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

Drop make_drop(unsigned key, int thresh, float scale, unsigned base) {
  Drop dp;
  dp.key = key;
  dp.thresh = thresh;
  dp.scale = scale;
  dp.base = base;
  return dp;
}

// fp32 pass B: rows of one split, enough splits for about two blocks per
// SM, each a whole number of kChunkF32-row chunks.
constexpr int kChunkF32 = 64;

int bwd_rows_per_split(int n, int f) {
  const int tiles = f / kBwdFtB;
  int s = (2 * 132 + tiles - 1) / tiles;
  const int chunks = (n + kChunkF32 - 1) / kChunkF32;
  if (s > chunks) s = chunks;
  if (s < 1) s = 1;
  const int per = (chunks + s - 1) / s;
  return per * kChunkF32;
}

// Row splits of pass B, counted after the rounding above, so that every
// split holds at least one row.
int bwd_splits(int n, int f) {
  const int per = bwd_rows_per_split(n, f);
  const int s = (n + per - 1) / per;
  return s < 1 ? 1 : s;
}

// The bf16 backward's schedule. Pass A: two 64-row warpgroups a block
// while that still gives a block to every SM, else one (N = 8448 fills
// 132 SMs only with 64-row blocks). Pass B: F / 64 tiles times as many
// row splits as fill one wave of one block an SM, each split a whole
// number of RC-row chunks; every split holds at least one row.
struct Plan16 {
  int nwg, units, rows_per_split, splits;
};

Plan16 plan16(int n, int f) {
  Plan16 p;
  p.nwg = (n + 127) / 128 >= 132 ? 2 : 1;
  const int rows = 64 * p.nwg;
  p.units = (n + rows - 1) / rows * p.nwg;
  const int tiles = f / bwd16::FB;
  const int chunks = (n + bwd16::RC - 1) / bwd16::RC;
  int s = 132 / tiles;
  if (s > chunks) s = chunks;
  if (s < 1) s = 1;
  p.rows_per_split = (chunks + s - 1) / s * bwd16::RC;
  p.splits = (n + p.rows_per_split - 1) / p.rows_per_split;
  return p;
}

bool bf16_width(int d) { return d == 64 || d == 128 || d == 256; }

// The bf16 forward's schedule (fwd16): two warpgroups split the columns
// of every F tile over 64 rows (SPLIT) while 128-row blocks would not give
// every SM one, else each takes 64 of a block's 128 rows (as plan16's
// pass A).
// fwd16_force >= 0 forces it (ln_ffn_residual_fwd_schedule, for timing
// both schedules).
int fwd16_force = -1;

int fwd16_split(int n) {
  if (fwd16_force >= 0) return fwd16_force;
  return (n + 127) / 128 >= 132 ? 0 : 1;
}

// Rows a block of the fp32 forward takes: 32 when its layout fits, else
// 16; 0 when neither fits this width.
int fwd_rows_f32(int d) {
  for (int rows = 32; rows >= 16; rows /= 2)
    if (f32k::layout(rows, d).bytes <= kMaxSmem) return rows;
  return 0;
}

// The fp32 forward; g == nullptr selects ffn_fused (bl and ff_scale
// unused, dp2 keeps everything).
int launch_fwd_f32(const float* x, const float* g, const float* bl,
                   const float* w1, const float* b1, const float* w2,
                   const float* b2, float* y, int n, int d, int f,
                   float ff_scale, float eps, int act, Drop dp1, Drop dp2,
                   cudaStream_t s) {
  const int rows = fwd_rows_f32(d);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  auto kernel = rows == 32 ? f32k::ln_ffn_fwd<32> : f32k::ln_ffn_fwd<16>;
  const size_t bytes = f32k::layout(rows, d).bytes;
  cudaError_t e;
  if ((e = set_smem(kernel, bytes)) != cudaSuccess) return (int)e;
  kernel<<<(n + rows - 1) / rows, kThreads, bytes, s>>>(
      x, g, bl, w1, b1, w2, b2, y, n, d, f, ff_scale, eps, act, dp1, dp2);
  return (int)cudaGetLastError();
}

// fp32 workspace of the backward (floats): per pass-A block (bf16: per
// 64-row unit) the db2 partials (and with the LayerNorm the dgamma and
// dbeta ones), per pass-B split dW1, dW2 and db1; 0 when the kernels do
// not take this width.
long long bwd_workspace(int dtype, int n, int d, int f, bool ln) {
  long long units, splits;
  if (dtype == 1) {
    if (!bf16_width(d) || f % bwd16::FB) return 0;
    const Plan16 p = plan16(n, f);
    units = p.units;
    splits = p.splits;
  } else {
    if (f32k::layout_a(kBwdRows, d).bytes > kMaxSmem ||
        f32k::layout_b(d).bytes > kMaxSmem)
      return 0;
    units = (n + kBwdRows - 1) / kBwdRows;
    splits = bwd_splits(n, f);
  }
  return (ln ? 3 : 1) * units * d + splits * (2LL * f * d + f);
}

// The cross-block sums, each in a fixed order.
int sum_all(bool ln, float* dgp, float* dblp, float* db2p, float* dw1p,
            float* dw2p, float* db1p, float* dg, float* dbl, float* dw1,
            float* db1, float* dw2, float* db2, int units, int splits, int d,
            int f, cudaStream_t s) {
  cudaError_t e;
  if (ln) {
    if ((e = sum_into(dgp, dg, units, d, s)) != cudaSuccess) return (int)e;
    if ((e = sum_into(dblp, dbl, units, d, s)) != cudaSuccess) return (int)e;
  }
  if ((e = sum_into(db2p, db2, units, d, s)) != cudaSuccess) return (int)e;
  if ((e = sum_into(dw1p, dw1, splits, f * d, s)) != cudaSuccess)
    return (int)e;
  if ((e = sum_into(dw2p, dw2, splits, f * d, s)) != cudaSuccess)
    return (int)e;
  return (int)sum_into(db1p, db1, splits, f, s);
}

// The fp32 backward; g == nullptr selects ffn_fused (bl, dg, dbl,
// rows_buf and ff_scale unused, dp2 keeps everything): pass B then reads x
// and dy, which are its LN(x) and dy2.
int launch_bwd_f32(const float* x, const float* dy, const float* g,
                   const float* bl, const float* w1, const float* b1,
                   const float* w2, float* dx, float* dg, float* dbl,
                   float* dw1, float* db1, float* dw2, float* db2, float* ws,
                   float* rows_buf, int n, int d, int f, float ff_scale,
                   float eps, int act, Drop dp1, Drop dp2, cudaStream_t s) {
  const bool ln = g != nullptr;
  if (bwd_workspace(0, n, d, f, ln) == 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kBwdRows - 1) / kBwdRows;
  const int splits = bwd_splits(n, f);
  const int rows_per_split = bwd_rows_per_split(n, f);
  float* db2p = ws;
  float* dgp = ln ? db2p + (size_t)blocks * d : nullptr;
  float* dblp = ln ? dgp + (size_t)blocks * d : nullptr;
  float* dw1p = db2p + (size_t)(ln ? 3 : 1) * blocks * d;
  float* dw2p = dw1p + (size_t)splits * f * d;
  float* db1p = dw2p + (size_t)splits * f * d;
  float* xn_out = ln ? rows_buf : nullptr;
  float* dy2_out = ln ? rows_buf + (size_t)n * d : nullptr;
  const size_t a_bytes = f32k::layout_a(kBwdRows, d).bytes;
  const size_t b_bytes = f32k::layout_b(d).bytes;
  auto ka = f32k::ln_ffn_bwd_rows<kBwdRows>;
  auto kb = f32k::ln_ffn_bwd_weights;
  cudaError_t e;
  if ((e = set_smem(ka, a_bytes)) != cudaSuccess) return (int)e;
  if ((e = set_smem(kb, b_bytes)) != cudaSuccess) return (int)e;
  ka<<<blocks, kThreads, a_bytes, s>>>(x, dy, g, bl, w1, b1, w2, dx, xn_out,
                                       dy2_out, dgp, dblp, db2p, n, d, f,
                                       ff_scale, eps, act, dp1, dp2);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  kb<<<dim3(f / kBwdFtB, splits), kThreads, b_bytes, s>>>(
      ln ? xn_out : x, ln ? dy2_out : dy, w1, b1, w2, dw1p, dw2p, db1p, n, d,
      f, rows_per_split, act, dp1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return sum_all(ln, dgp, dblp, db2p, dw1p, dw2p, db1p, dg, dbl, dw1, db1,
                 dw2, db2, blocks, splits, d, f, s);
}

using sm90::tensor_map;

// The bf16 backward at width D (see launch_bwd_f32 for g == nullptr).
template <int D>
int launch_bwd_bf16(const bwd16::bf* x, const bwd16::bf* dy, const float* g,
                    const float* bl, const bwd16::bf* w1, const float* b1,
                    const bwd16::bf* w2, bwd16::bf* dx, float* dg,
                    float* dbl, float* dw1, float* db1, float* dw2,
                    float* db2, float* ws, bwd16::bf* rows_buf, int n, int f,
                    float ff_scale, float eps, int act, Drop dp1, Drop dp2,
                    cudaStream_t s) {
  using bf = bwd16::bf;
  constexpr int d = D;
  const bool ln = g != nullptr;
  const Plan16 p = plan16(n, f);
  float* db2p = ws;
  float* dgp = ln ? db2p + (size_t)p.units * d : nullptr;
  float* dblp = ln ? dgp + (size_t)p.units * d : nullptr;
  float* dw1p = db2p + (size_t)(ln ? 3 : 1) * p.units * d;
  float* dw2p = dw1p + (size_t)p.splits * f * d;
  float* db1p = dw2p + (size_t)p.splits * f * d;
  bf* xn_out = ln ? rows_buf : nullptr;
  bf* dy2_out = ln ? rows_buf + (size_t)n * d : nullptr;
  CUtensorMap w1a, w2a, w1b, w2b, xm, dm;
  const CUtensorMapSwizzle sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map(&w1a, w1, f, d, bwd16::FT, 64, sw128) ||
      !tensor_map(&w2a, w2, d, f, d, bwd16::FT, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !tensor_map(&w1b, w1, f, d, bwd16::FB, 64, sw128) ||
      !tensor_map(&w2b, w2, d, f, 64, bwd16::FB, sw128) ||
      !tensor_map(&xm, ln ? xn_out : x, n, d, bwd16::RC, 64, sw128) ||
      !tensor_map(&dm, ln ? dy2_out : dy, n, d, bwd16::RC, 64, sw128))
    return (int)cudaErrorInvalidValue;
  const int stages = p.nwg == 2 ? 3 : 4;
  const size_t a_bytes =
      bwd16::layout_a(64 * p.nwg, d, stages).bytes + 1024;
  const size_t b_bytes = bwd16::layout_b(d).bytes + 1024;
  auto ka = p.nwg == 2 ? bwd16::bwd_rows<D, 2, 3> : bwd16::bwd_rows<D, 1, 4>;
  auto kb = bwd16::bwd_weights<D>;
  cudaError_t e;
  if ((e = set_smem(ka, a_bytes)) != cudaSuccess) return (int)e;
  if ((e = set_smem(kb, b_bytes)) != cudaSuccess) return (int)e;
  ka<<<p.units / p.nwg, p.nwg * bwd16::kWG, a_bytes, s>>>(
      w1a, w2a, x, dy, g, bl, b1, dx, xn_out, dy2_out, dgp, dblp, db2p, n,
      f, ff_scale, eps, act, dp1, dp2);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  kb<<<dim3(f / bwd16::FB, p.splits), 2 * bwd16::kWG, b_bytes, s>>>(
      w1b, w2b, xm, dm, b1, dw1p, dw2p, db1p, n, f, p.rows_per_split, act,
      dp1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return sum_all(ln, dgp, dblp, db2p, dw1p, dw2p, db1p, dg, dbl, dw1, db1,
                 dw2, db2, p.units, p.splits, d, f, s);
}

int launch_bwd_any(int dtype, const void* x, const void* dy, const void* g,
                   const void* bl, const void* w1, const void* b1,
                   const void* w2, void* dx, float* dg, float* dbl,
                   float* dw1, float* db1, float* dw2, float* db2, float* ws,
                   void* rows_buf, int n, int d, int f, float ff_scale,
                   float eps, int act, Drop dp1, Drop dp2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* blf = static_cast<const float*>(bl);
  const float* b1f = static_cast<const float*>(b1);
  if (dtype == 0)
    return launch_bwd_f32(
        static_cast<const float*>(x), static_cast<const float*>(dy), gf, blf,
        static_cast<const float*>(w1), b1f, static_cast<const float*>(w2),
        static_cast<float*>(dx), dg, dbl, dw1, db1, dw2, db2, ws,
        static_cast<float*>(rows_buf), n, d, f, ff_scale, eps, act, dp1, dp2,
        s);
  using bf = bwd16::bf;
  if (bwd_workspace(1, n, d, f, gf != nullptr) == 0)
    return (int)cudaErrorInvalidValue;
  auto run = d == 64 ? launch_bwd_bf16<64>
             : d == 128 ? launch_bwd_bf16<128> : launch_bwd_bf16<256>;
  return run(static_cast<const bf*>(x), static_cast<const bf*>(dy), gf, blf,
             static_cast<const bf*>(w1), b1f, static_cast<const bf*>(w2),
             static_cast<bf*>(dx), dg, dbl, dw1, db1, dw2, db2, ws,
             static_cast<bf*>(rows_buf), n, f, ff_scale, eps, act, dp1, dp2,
             s);
}

// The bf16 forward at width D (see launch_fwd_f32 for g == nullptr).
template <int D>
int launch_fwd_bf16(const bwd16::bf* x, const float* g, const float* bl,
                    const bwd16::bf* w1, const float* b1,
                    const bwd16::bf* w2, const float* b2, bwd16::bf* y,
                    int n, int f, float ff_scale, float eps, int act,
                    Drop dp1, Drop dp2, cudaStream_t s) {
  const int split = fwd16_split(n);
  CUtensorMap w1m, w2m, xm = {};
  const CUtensorMapSwizzle sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map(&w1m, w1, f, D, fwd16::FT, 64, sw128) ||
      !tensor_map(&w2m, w2, D, f, D, fwd16::FT, sw128) ||
      (g == nullptr && !tensor_map(&xm, x, n, D, 64, 64, sw128)))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = fwd16::layout(D, split).bytes + 1024;
  auto kernel = split ? fwd16::ffn_fwd<D, 1> : fwd16::ffn_fwd<D, 0>;
  cudaError_t e;
  if ((e = set_smem(kernel, bytes)) != cudaSuccess) return (int)e;
  const int rows = fwd16::rows_of(split);
  kernel<<<(n + rows - 1) / rows, 2 * bwd16::kWG, bytes, s>>>(
      w1m, w2m, xm, x, g, bl, b1, b2, y, n, f, ff_scale, eps, act, dp1,
      dp2);
  return (int)cudaGetLastError();
}

// The forward of both functions; g == nullptr selects ffn_fused.
int launch_fwd(int dtype, const void* x, const void* g, const void* bl,
               const void* w1, const void* b1, const void* w2,
               const void* b2, void* y, int n, int d, int f, float ff_scale,
               float eps, int act, Drop dp1, Drop dp2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* blf = static_cast<const float*>(bl);
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  if (dtype == 0)
    return launch_fwd_f32(static_cast<const float*>(x), gf, blf,
                          static_cast<const float*>(w1), b1f,
                          static_cast<const float*>(w2), b2f,
                          static_cast<float*>(y), n, d, f, ff_scale, eps,
                          act, dp1, dp2, s);
  using bf = bwd16::bf;
  if (!bf16_width(d) || f % fwd16::FT) return (int)cudaErrorInvalidValue;
  auto run = d == 64 ? launch_fwd_bf16<64>
             : d == 128 ? launch_fwd_bf16<128> : launch_fwd_bf16<256>;
  return run(static_cast<const bf*>(x), gf, blf, static_cast<const bf*>(w1),
             b1f, static_cast<const bf*>(w2), b2f, static_cast<bf*>(y), n,
             f, ff_scale, eps, act, dp1, dp2, s);
}

}  // namespace

extern "C" {

// The bf16 forward's schedule: -1 chooses from N, 1 forces two warpgroups
// over 64 rows, 0 one warpgroup a 64-row half of 128 rows. Returns the
// schedule this N gets under the setting.
int ln_ffn_residual_fwd_schedule(int force, int n) {
  fwd16_force = force;
  return fwd16_split(n);
}

// Shape and alignment checks are the caller's (ops/ffn.py). Returns a
// cudaError_t code; 0 is success. thresh >= 65536 turns a mask off.
int ln_ffn_residual_fwd(int dtype, const void* x, const void* g,
                        const void* bl, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* y, int n, int d,
                        int f, float ff_scale, float eps, int act,
                        unsigned key1, int thresh1, float scale1,
                        unsigned key2, int thresh2, float scale2,
                        unsigned row_base, void* stream) {
  return launch_fwd(dtype, x, g, bl, w1, b1, w2, b2, y, n, d, f, ff_scale,
                    eps, act, make_drop(key1, thresh1, scale1, row_base * f),
                    make_drop(key2, thresh2, scale2, row_base * d), stream);
}

// ffn_fused's forward: drop1(act(x W1^T + b1)) W2^T + b2.
int ffn_fused_fwd(int dtype, const void* x, const void* w1, const void* b1,
                  const void* w2, const void* b2, void* y, int n, int d,
                  int f, int act, unsigned key1, int thresh1, float scale1,
                  unsigned row_base, void* stream) {
  return launch_fwd(dtype, x, nullptr, nullptr, w1, b1, w2, b2, y, n, d, f,
                    1.0f, 0.0f, act,
                    make_drop(key1, thresh1, scale1, row_base * f),
                    make_drop(0u, kKeepAll, 1.0f, 0u), stream);
}

// fp32 workspace the backward needs (floats), or 0 when its layouts do not
// fit this width in shared memory.
long long ln_ffn_residual_bwd_workspace(int dtype, int n, int d, int f) {
  return bwd_workspace(dtype, n, d, f, true);
}

long long ffn_fused_bwd_workspace(int dtype, int n, int d, int f) {
  return bwd_workspace(dtype, n, d, f, false);
}

// dx in the compute dtype; dg, dbl, dw1 [F, D], db1, dw2 [D, F], db2 in
// fp32. ws holds ln_ffn_residual_bwd_workspace() floats; rows_buf holds
// 2 * n * d values of the compute dtype (pass A's LN(x) and dy2 for
// pass B).
int ln_ffn_residual_bwd(int dtype, const void* x, const void* dy,
                        const void* g, const void* bl, const void* w1,
                        const void* b1, const void* w2, void* dx, float* dg,
                        float* dbl, float* dw1, float* db1, float* dw2,
                        float* db2, float* ws, void* rows_buf, int n, int d,
                        int f,
                        float ff_scale, float eps, int act, unsigned key1,
                        int thresh1, float scale1, unsigned key2,
                        int thresh2, float scale2, unsigned row_base,
                        void* stream) {
  return launch_bwd_any(dtype, x, dy, g, bl, w1, b1, w2, dx, dg, dbl, dw1,
                        db1, dw2, db2, ws, rows_buf, n, d, f, ff_scale, eps,
                        act, make_drop(key1, thresh1, scale1, row_base * f),
                        make_drop(key2, thresh2, scale2, row_base * d),
                        stream);
}

// ffn_fused's backward: dx in the compute dtype; dw1 [F, D], db1, dw2
// [D, F], db2 in fp32; ws holds ffn_fused_bwd_workspace() floats.
int ffn_fused_bwd(int dtype, const void* x, const void* dy, const void* w1,
                  const void* b1, const void* w2, void* dx, float* dw1,
                  float* db1, float* dw2, float* db2, float* ws, int n, int d,
                  int f, int act, unsigned key1, int thresh1, float scale1,
                  unsigned row_base, void* stream) {
  return launch_bwd_any(dtype, x, dy, nullptr, nullptr, w1, b1, w2, dx,
                        nullptr, nullptr, dw1, db1, dw2, db2, ws, nullptr, n,
                        d, f, 1.0f, 0.0f, act,
                        make_drop(key1, thresh1, scale1, row_base * f),
                        make_drop(0u, kKeepAll, 1.0f, 0u), stream);
}

}  // extern "C"
