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
// Design, simple first. Forward: one CTA of 256 threads owns a block of
// ROWS rows; the TPU kernel holds the whole [rows, F] hidden in VMEM, which
// does not fit in shared memory, so the CTA loops over F in tiles of FT
// columns, stages W1[f0:f0+FT, :] and W2[:, f0:f0+FT] in shared memory,
// computes the hidden tile and adds its product with W2 into an fp32
// [ROWS, D] accumulator in shared memory.
//
// Backward: the TPU accumulates the weight gradients across a sequential
// grid; here blocks run concurrently, so the work is split in two passes
// and the cross-block sums are written as per-block partials that a third,
// small pass adds up in a fixed order (deterministic, no atomics):
//   A (row-parallel, owns dx): per ROWS rows, computes LN(x) and
//     dy2 = drop2(ff_scale * dy) once and also writes both ([N, D] each)
//     for pass B; loops over F tiles as the forward does, recomputes z1
//     and dh = dy2 @ W2 per tile, forms dz1 and accumulates dxn = dz1 @ W1
//     in shared memory; then the LayerNorm VJP and dx; partials of
//     dgamma, dbeta and db2 per block.
//   B (F-tile-parallel, owns the weights): per FTB columns of F and one of
//     S row splits, stages its W1/W2 tiles once, loops over row chunks of
//     A's LN(x) and dy2 (staged in 16-byte vectors by all threads at
//     once, so no F-tile repeats the LayerNorm or the dy2 mask),
//     recomputes z1, the hidden and dz1 for its tile, and accumulates
//     dW1[tile] += dz1^T @ xn, dW2[:, tile] += dy2^T @ h and db1[tile] in
//     shared memory; partials per split.
//   R sums the partials.
// The [N, F] hidden never touches device memory. bf16 runs the GEMMs on
// the tensor cores with WMMA 16x16x16 fragments; fp32 uses plain FMA so
// that it stays full fp32 (no TF32). The ragged row edge is masked in the
// kernels (rows past N are computed from zeros and never stored or
// summed). Later work: wgmma, TMA staging, a persistent schedule.
//
// Weights arrive in torch.nn.Linear layout: W1 [F, D], W2 [D, F].
// Plain C interface, bound with ctypes; each launch returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // 227 KB usable by one block on sm_90
constexpr int kKeepAll = 65536;      // dropout threshold meaning "no mask"
constexpr int kBwdRows = 32;  // rows per pass-A block and fp32 pass-B chunk
constexpr int kBwdFtB = 32;          // F columns a pass-B block owns

// One dropout stream: keep iff (hash32(index ^ key) & 0xFFFF) < thresh.
struct Drop {
  uint32_t key;
  int thresh;
  float scale;
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
  return (hash32(index ^ dp.key) & 0xFFFFu) < (uint32_t)dp.thresh
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

// Copy rows [row0, row0 + rows) of src [*, d] into dst (row stride ld, a
// multiple of 16 bytes) in 16-byte vectors, all threads at once; rows at
// or past row_end are zero.
template <typename T>
__device__ void stage_rows(const T* __restrict__ src, T* dst, int ld,
                           int row0, int rows, int row_end, int d) {
  constexpr int kVec = 16 / sizeof(T);
  const int vecs = d / kVec;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs, v = i % vecs, gr = row0 + r;
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (gr < row_end)
      q = *reinterpret_cast<const uint4*>(src + (size_t)gr * d + v * kVec);
    *reinterpret_cast<uint4*>(dst + r * ld + v * kVec) = q;
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
// which has no LayerNorm to differentiate and no residual to add.
template <typename T>
__device__ void store_acc(const float* acc, int lda, T* __restrict__ dx,
                          int row0, int rows, int n, int d) {
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, c = i % d, gr = row0 + r;
    if (gr < n) dx[(size_t)gr * d + c] = from_f<T>(acc[r * lda + c]);
  }
}

// After pass A's GEMMs: the LayerNorm VJP and dx (one warp a row), and the
// block's partial column sums of dxn * xhat (dgamma) and dxn (dbeta).
template <typename T>
__device__ void ln_vjp_rows(const T* __restrict__ x, const T* __restrict__ dy,
                            const float* __restrict__ g, const float* acc,
                            int lda, const float* mu, const float* rstd,
                            T* __restrict__ dx, float* __restrict__ dgp,
                            float* __restrict__ dblp, int row0, int rows,
                            int n, int d) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
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
  for (int c = threadIdx.x; c < d; c += kThreads) {
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

// ---------------------------------------------------------------- bf16 ---
namespace bf16k {
using bf = __nv_bfloat16;
using namespace nvcuda;
constexpr int FT = 64;

// C[16x16 tile] (+)= A @ B over depth k, A and B in shared memory.
template <typename LA, typename LB>
__device__ __forceinline__ void mma_tile(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>& c, const bf* a,
    int lda_step, int lda, const bf* b, int ldb_step, int ldb, int depth) {
  for (int k = 0; k < depth; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf, LA> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf, LB> fb;
    wmma::load_matrix_sync(fa, a + (size_t)k * lda_step, lda);
    wmma::load_matrix_sync(fb, b + (size_t)k * ldb_step, ldb);
    wmma::mma_sync(c, fa, fb, c);
  }
}

struct Layout {
  int ldx, ldw1, ldw2, ldhf, ldh, lda;
  size_t o_w1, o_w2, o_hf, o_h, o_acc, bytes;
};

__host__ __device__ inline Layout layout(int rows, int d) {
  Layout L;
  L.ldx = d + 8;        // bf16: rows stay 16-byte aligned, banks shift
  L.ldw1 = d + 8;
  L.ldw2 = FT + 8;
  L.ldhf = FT + 4;      // fp32
  L.ldh = FT + 8;
  L.lda = d + 4;        // fp32
  size_t o = align128((size_t)rows * L.ldx * 2);
  L.o_w1 = o;
  o += align128((size_t)FT * L.ldw1 * 2);
  L.o_w2 = o;
  o += align128((size_t)d * L.ldw2 * 2);
  L.o_hf = o;
  o += align128((size_t)rows * L.ldhf * 4);
  L.o_h = o;
  o += align128((size_t)rows * L.ldh * 2);
  L.o_acc = o;
  o += align128((size_t)rows * L.lda * 4);
  L.bytes = o;
  return L;
}

// Stage W1[f0:f0+ft, :] as [ft][ldw1] and W2[:, f0:f0+ft] as [d][ldw2].
__device__ void stage_weights(const bf* __restrict__ w1,
                              const bf* __restrict__ w2, bf* w1s, int ldw1,
                              bf* w2s, int ldw2, int f0, int ft, int d,
                              int f) {
  const int vec_w1 = d / 8, vec_w2 = ft / 8;   // 16-byte vectors
  for (int i = threadIdx.x; i < ft * vec_w1; i += kThreads) {
    const int j = i / vec_w1, v = i % vec_w1;
    *reinterpret_cast<uint4*>(w1s + j * ldw1 + v * 8) =
        *reinterpret_cast<const uint4*>(w1 + (size_t)(f0 + j) * d + v * 8);
  }
  for (int i = threadIdx.x; i < d * vec_w2; i += kThreads) {
    const int c = i / vec_w2, v = i % vec_w2;
    *reinterpret_cast<uint4*>(w2s + c * ldw2 + v * 8) =
        *reinterpret_cast<const uint4*>(w2 + (size_t)c * f + f0 + v * 8);
  }
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
ln_ffn_fwd(const bf* __restrict__ x, const float* __restrict__ g,
           const float* __restrict__ bl, const bf* __restrict__ w1,
           const float* __restrict__ b1, const bf* __restrict__ w2,
           const float* __restrict__ b2, bf* __restrict__ y, int n, int d,
           int f, float ff_scale, float eps, int act, Drop dp1, Drop dp2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(ROWS, d);
  bf* xn = reinterpret_cast<bf*>(smem);
  bf* w1s = reinterpret_cast<bf*>(smem + L.o_w1);
  bf* w2s = reinterpret_cast<bf*>(smem + L.o_w2);
  float* hf = reinterpret_cast<float*>(smem + L.o_hf);
  bf* h = reinterpret_cast<bf*>(smem + L.o_h);
  float* acc = reinterpret_cast<float*>(smem + L.o_acc);
  const int tid = threadIdx.x, warp = tid / 32;
  const int row0 = blockIdx.x * ROWS;

  if (g != nullptr)
    layer_norm_rows<bf>(x, g, bl, xn, L.ldx, row0, ROWS, n, d, eps);
  else
    stage_rows<bf>(x, xn, L.ldx, row0, ROWS, n, d);
  for (int i = tid; i < ROWS * L.lda; i += kThreads) acc[i] = 0.0f;

  constexpr int rt_n = ROWS / 16, ct_n = FT / 16;
  const int dt_n = d / 16;

  for (int f0 = 0; f0 < f; f0 += FT) {
    stage_weights(w1, w2, w1s, L.ldw1, w2s, L.ldw2, f0, FT, d, f);
    __syncthreads();

    // GEMM1: hf[ROWS, FT] = xn[ROWS, D] @ W1_tile^T (W1_tile^T is
    // column-major in w1s).
    for (int t = warp; t < rt_n * ct_n; t += kWarps) {
      const int rt = t / ct_n, ct = t % ct_n;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
      mma_tile<wmma::row_major, wmma::col_major>(
          c, xn + rt * 16 * L.ldx, 1, L.ldx, w1s + ct * 16 * L.ldw1, 1,
          L.ldw1, d);
      wmma::store_matrix_sync(hf + rt * 16 * L.ldhf + ct * 16, c, L.ldhf,
                              wmma::mem_row_major);
    }
    __syncthreads();

    for (int i = tid; i < ROWS * FT; i += kThreads) {
      const int r = i / FT, j = i % FT;
      const float hv = act_fn(hf[r * L.ldhf + j] + b1[f0 + j], act);
      h[r * L.ldh + j] = __float2bfloat16(
          drop(dp1, (uint32_t)(row0 + r) * (uint32_t)f + f0 + j, hv));
    }
    __syncthreads();

    // GEMM2: acc[ROWS, D] += h[ROWS, FT] @ W2_tile^T.
    for (int t = warp; t < rt_n * dt_n; t += kWarps) {
      const int rt = t / dt_n, ct = t % dt_n;
      float* cp = acc + rt * 16 * L.lda + ct * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::load_matrix_sync(c, cp, L.lda, wmma::mem_row_major);
      mma_tile<wmma::row_major, wmma::col_major>(
          c, h + rt * 16 * L.ldh, 1, L.ldh, w2s + ct * 16 * L.ldw2, 1,
          L.ldw2, FT);
      wmma::store_matrix_sync(cp, c, L.lda, wmma::mem_row_major);
    }
    __syncthreads();
  }
  store_residual<bf>(x, b2, acc, L.lda, y, row0, ROWS, n, d, ff_scale, dp2,
                     g != nullptr);
}

// Pass A: the forward's layout plus dy2 [ROWS][ldx], a second fp32 tile
// for dh and the row statistics.
struct LayoutA {
  Layout f;
  size_t o_dy, o_dh, o_mu, o_rstd, bytes;
};

__host__ __device__ inline LayoutA layout_a(int rows, int d) {
  LayoutA L;
  L.f = layout(rows, d);
  size_t o = L.f.bytes;
  L.o_dy = o;
  o += align128((size_t)rows * L.f.ldx * 2);
  L.o_dh = o;
  o += align128((size_t)rows * L.f.ldhf * 4);
  L.o_mu = o;
  o += align128((size_t)rows * 4);
  L.o_rstd = o;
  o += align128((size_t)rows * 4);
  L.bytes = o;
  return L;
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
ln_ffn_bwd_rows(const bf* __restrict__ x, const bf* __restrict__ dy,
                const float* __restrict__ g, const float* __restrict__ bl,
                const bf* __restrict__ w1, const float* __restrict__ b1,
                const bf* __restrict__ w2, bf* __restrict__ dx,
                bf* __restrict__ xn_out, bf* __restrict__ dy2_out,
                float* __restrict__ dgp, float* __restrict__ dblp,
                float* __restrict__ db2p, int n, int d, int f,
                float ff_scale, float eps, int act, Drop dp1, Drop dp2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LayoutA LA = layout_a(ROWS, d);
  const Layout& L = LA.f;
  bf* xn = reinterpret_cast<bf*>(smem);
  bf* w1s = reinterpret_cast<bf*>(smem + L.o_w1);
  bf* w2s = reinterpret_cast<bf*>(smem + L.o_w2);
  float* zf = reinterpret_cast<float*>(smem + L.o_hf);
  bf* dz = reinterpret_cast<bf*>(smem + L.o_h);
  float* acc = reinterpret_cast<float*>(smem + L.o_acc);
  bf* dyc = reinterpret_cast<bf*>(smem + LA.o_dy);
  float* dhf = reinterpret_cast<float*>(smem + LA.o_dh);
  float* mu = reinterpret_cast<float*>(smem + LA.o_mu);
  float* rstd = reinterpret_cast<float*>(smem + LA.o_rstd);
  const int tid = threadIdx.x, warp = tid / 32;
  const int row0 = blockIdx.x * ROWS;
  const size_t part = (size_t)blockIdx.x * d;

  if (g != nullptr)
    layer_norm_rows<bf>(x, g, bl, xn, L.ldx, row0, ROWS, n, d, eps, mu,
                        rstd);
  else
    stage_rows<bf>(x, xn, L.ldx, row0, ROWS, n, d);
  load_dy2<bf>(dy, dyc, L.ldx, row0, ROWS, n, d, ff_scale, dp2, db2p + part);
  for (int i = tid; i < ROWS * L.lda; i += kThreads) acc[i] = 0.0f;
  __syncthreads();
  if (xn_out != nullptr) {
    store_rows<bf>(xn, L.ldx, xn_out, row0, ROWS, n, d);
    store_rows<bf>(dyc, L.ldx, dy2_out, row0, ROWS, n, d);
  }

  constexpr int rt_n = ROWS / 16, ct_n = FT / 16;
  const int dt_n = d / 16;

  for (int f0 = 0; f0 < f; f0 += FT) {
    stage_weights(w1, w2, w1s, L.ldw1, w2s, L.ldw2, f0, FT, d, f);
    __syncthreads();

    // zf = xn @ W1_tile^T and dhf = dy2 @ W2_tile, [ROWS, FT] each.
    for (int t = warp; t < 2 * rt_n * ct_n; t += kWarps) {
      const int which = t / (rt_n * ct_n), u = t % (rt_n * ct_n);
      const int rt = u / ct_n, ct = u % ct_n;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
      if (which == 0) {
        mma_tile<wmma::row_major, wmma::col_major>(
            c, xn + rt * 16 * L.ldx, 1, L.ldx, w1s + ct * 16 * L.ldw1, 1,
            L.ldw1, d);
        wmma::store_matrix_sync(zf + rt * 16 * L.ldhf + ct * 16, c, L.ldhf,
                                wmma::mem_row_major);
      } else {
        mma_tile<wmma::row_major, wmma::row_major>(
            c, dyc + rt * 16 * L.ldx, 1, L.ldx, w2s + ct * 16, L.ldw2,
            L.ldw2, d);
        wmma::store_matrix_sync(dhf + rt * 16 * L.ldhf + ct * 16, c, L.ldhf,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();

    for (int i = tid; i < ROWS * FT; i += kThreads) {
      const int r = i / FT, j = i % FT;
      const float z = zf[r * L.ldhf + j] + b1[f0 + j];
      const float dh = drop(dp1, (uint32_t)(row0 + r) * (uint32_t)f + f0 + j,
                            dhf[r * L.ldhf + j]);
      dz[r * L.ldh + j] = __float2bfloat16(dh * act_deriv(z, act));
    }
    __syncthreads();

    // acc[ROWS, D] += dz[ROWS, FT] @ W1_tile[FT, D].
    for (int t = warp; t < rt_n * dt_n; t += kWarps) {
      const int rt = t / dt_n, ct = t % dt_n;
      float* cp = acc + rt * 16 * L.lda + ct * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::load_matrix_sync(c, cp, L.lda, wmma::mem_row_major);
      mma_tile<wmma::row_major, wmma::row_major>(
          c, dz + rt * 16 * L.ldh, 1, L.ldh, w1s + ct * 16, L.ldw1, L.ldw1,
          FT);
      wmma::store_matrix_sync(cp, c, L.lda, wmma::mem_row_major);
    }
    __syncthreads();
  }
  if (g != nullptr)
    ln_vjp_rows<bf>(x, dy, g, acc, L.lda, mu, rstd, dx, dgp + part,
                    dblp + part, row0, ROWS, n, d);
  else
    store_acc<bf>(acc, L.lda, dx, row0, ROWS, n, d);
}

// Pass B layout: the block's W1/W2 tiles, one row chunk of xn and dy2, the
// [RB, FTB] tiles, and the fp32 dW1 [FTB][D] / dW2 [D][FTB] / db1 sums.
struct LayoutB {
  int ldx, ldw1, ldw2, ldt, ldh, ld1, ld2;
  size_t o_w1, o_w2, o_dy, o_z, o_dh, o_h, o_dz, o_a1, o_a2, o_b1, bytes;
};

// Pass B's chunk: 64 rows in bf16 (more GEMM depth per pass over the
// shared-memory dW sums), 32 in fp32 (shared memory).
constexpr int kChunkB = 64;

__host__ __device__ inline LayoutB layout_b(int d) {
  constexpr int RB = kChunkB, FB = kBwdFtB;
  LayoutB L;
  L.ldx = d + 8;
  L.ldw1 = d + 8;
  L.ldw2 = FB + 8;
  L.ldt = FB + 4;       // fp32 tiles
  L.ldh = FB + 8;       // bf16 tiles
  L.ld1 = d + 4;        // dW1 sums
  L.ld2 = FB + 4;       // dW2 sums
  size_t o = align128((size_t)RB * L.ldx * 2);
  L.o_w1 = o;
  o += align128((size_t)FB * L.ldw1 * 2);
  L.o_w2 = o;
  o += align128((size_t)d * L.ldw2 * 2);
  L.o_dy = o;
  o += align128((size_t)RB * L.ldx * 2);
  L.o_z = o;
  o += align128((size_t)RB * L.ldt * 4);
  L.o_dh = o;
  o += align128((size_t)RB * L.ldt * 4);
  L.o_h = o;
  o += align128((size_t)RB * L.ldh * 2);
  L.o_dz = o;
  o += align128((size_t)RB * L.ldh * 2);
  L.o_a1 = o;
  o += align128((size_t)FB * L.ld1 * 4);
  L.o_a2 = o;
  o += align128((size_t)d * L.ld2 * 4);
  L.o_b1 = o;
  o += align128((size_t)FB * 4);
  L.bytes = o;
  return L;
}

__global__ void __launch_bounds__(kThreads)
ln_ffn_bwd_weights(const bf* __restrict__ xn_g, const bf* __restrict__ dy2_g,
                   const bf* __restrict__ w1, const float* __restrict__ b1,
                   const bf* __restrict__ w2, float* __restrict__ dw1p,
                   float* __restrict__ dw2p, float* __restrict__ db1p, int n,
                   int d, int f, int rows_per_split, int act, Drop dp1) {
  constexpr int RB = kChunkB, FB = kBwdFtB;
  extern __shared__ __align__(128) unsigned char smem[];
  const LayoutB L = layout_b(d);
  bf* xn = reinterpret_cast<bf*>(smem);
  bf* w1s = reinterpret_cast<bf*>(smem + L.o_w1);
  bf* w2s = reinterpret_cast<bf*>(smem + L.o_w2);
  bf* dyc = reinterpret_cast<bf*>(smem + L.o_dy);
  float* zf = reinterpret_cast<float*>(smem + L.o_z);
  float* dhf = reinterpret_cast<float*>(smem + L.o_dh);
  bf* hc = reinterpret_cast<bf*>(smem + L.o_h);
  bf* dz = reinterpret_cast<bf*>(smem + L.o_dz);
  float* a1 = reinterpret_cast<float*>(smem + L.o_a1);
  float* a2 = reinterpret_cast<float*>(smem + L.o_a2);
  float* sb1 = reinterpret_cast<float*>(smem + L.o_b1);
  const int tid = threadIdx.x, warp = tid / 32;
  const int f0 = blockIdx.x * FB, split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);

  stage_weights(w1, w2, w1s, L.ldw1, w2s, L.ldw2, f0, FB, d, f);
  for (int i = tid; i < FB * L.ld1; i += kThreads) a1[i] = 0.0f;
  for (int i = tid; i < d * L.ld2; i += kThreads) a2[i] = 0.0f;
  for (int i = tid; i < FB; i += kThreads) sb1[i] = 0.0f;
  // The write-out below maps a1/a2 to threads otherwise than the zeroing.
  __syncthreads();

  constexpr int rt_n = RB / 16, ct_n = FB / 16;
  const int dt_n = d / 16;
  for (int row0 = r_begin; row0 < r_end; row0 += RB) {
    stage_rows<bf>(xn_g, xn, L.ldx, row0, RB, r_end, d);
    stage_rows<bf>(dy2_g, dyc, L.ldx, row0, RB, r_end, d);
    __syncthreads();

    // zf = xn @ W1_tile^T and dhf = dy2 @ W2_tile, [RB, FB] each.
    for (int t = warp; t < 2 * rt_n * ct_n; t += kWarps) {
      const int which = t / (rt_n * ct_n), u = t % (rt_n * ct_n);
      const int rt = u / ct_n, ct = u % ct_n;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
      if (which == 0) {
        mma_tile<wmma::row_major, wmma::col_major>(
            c, xn + rt * 16 * L.ldx, 1, L.ldx, w1s + ct * 16 * L.ldw1, 1,
            L.ldw1, d);
        wmma::store_matrix_sync(zf + rt * 16 * L.ldt + ct * 16, c, L.ldt,
                                wmma::mem_row_major);
      } else {
        mma_tile<wmma::row_major, wmma::row_major>(
            c, dyc + rt * 16 * L.ldx, 1, L.ldx, w2s + ct * 16, L.ldw2,
            L.ldw2, d);
        wmma::store_matrix_sync(dhf + rt * 16 * L.ldt + ct * 16, c, L.ldt,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();

    // The hidden and dz1 of the tile; dhf keeps the fp32 dz1 for db1.
    for (int i = tid; i < RB * FB; i += kThreads) {
      const int r = i / FB, j = i % FB, gr = row0 + r;
      float hv = 0.0f, dzv = 0.0f;
      if (gr < r_end) {
        const uint32_t idx = (uint32_t)gr * (uint32_t)f + f0 + j;
        const float z = zf[r * L.ldt + j] + b1[f0 + j];
        const float keep = drop(dp1, idx, 1.0f);    // 1/keep or 0
        hv = act_fn(z, act) * keep;
        dzv = dhf[r * L.ldt + j] * keep * act_deriv(z, act);
      }
      hc[r * L.ldh + j] = __float2bfloat16(hv);
      dz[r * L.ldh + j] = __float2bfloat16(dzv);
      dhf[r * L.ldt + j] = dzv;
    }
    __syncthreads();

    // a1[FB, D] += dz^T @ xn and a2[D, FB] += dy2^T @ h (depth RB).
    for (int t = warp; t < 2 * ct_n * dt_n; t += kWarps) {
      const int which = t / (ct_n * dt_n), u = t % (ct_n * dt_n);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (which == 0) {
        const int jt = u / dt_n, dtile = u % dt_n;
        float* cp = a1 + jt * 16 * L.ld1 + dtile * 16;
        wmma::load_matrix_sync(c, cp, L.ld1, wmma::mem_row_major);
        mma_tile<wmma::col_major, wmma::row_major>(
            c, dz + jt * 16, L.ldh, L.ldh, xn + dtile * 16, L.ldx, L.ldx,
            RB);
        wmma::store_matrix_sync(cp, c, L.ld1, wmma::mem_row_major);
      } else {
        const int dtile = u / ct_n, jt = u % ct_n;
        float* cp = a2 + dtile * 16 * L.ld2 + jt * 16;
        wmma::load_matrix_sync(c, cp, L.ld2, wmma::mem_row_major);
        mma_tile<wmma::col_major, wmma::row_major>(
            c, dyc + dtile * 16, L.ldx, L.ldx, hc + jt * 16, L.ldh, L.ldh,
            RB);
        wmma::store_matrix_sync(cp, c, L.ld2, wmma::mem_row_major);
      }
    }
    for (int j = tid; j < FB; j += kThreads) {
      float s = 0.0f;
      for (int r = 0; r < RB; ++r) s += dhf[r * L.ldt + j];
      sb1[j] += s;
    }
    __syncthreads();
  }
  float* p1 = dw1p + (size_t)split * f * d;
  float* p2 = dw2p + (size_t)split * d * f;
  for (int i = tid; i < FB * d; i += kThreads) {
    const int j = i / d, c = i % d;
    p1[(size_t)(f0 + j) * d + c] = a1[j * L.ld1 + c];
  }
  for (int i = tid; i < d * FB; i += kThreads) {
    const int c = i / FB, j = i % FB;
    p2[(size_t)c * f + f0 + j] = a2[c * L.ld2 + j];
  }
  for (int j = tid; j < FB; j += kThreads)
    db1p[(size_t)split * f + f0 + j] = sb1[j];
}
}  // namespace bf16k

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
    ln_vjp_rows<float>(x, dy, g, acc, L.lda, mu, rstd, dx, dgp + part,
                       dblp + part, row0, ROWS, n, d);
  else
    store_acc<float>(acc, L.lda, dx, row0, ROWS, n, d);
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

Drop make_drop(unsigned key, int thresh, float scale) {
  Drop dp;
  dp.key = key;
  dp.thresh = thresh;
  dp.scale = scale;
  return dp;
}

// Rows of one pass-B split: enough splits for about two blocks per SM,
// each a whole number of kChunkB-row chunks.
int bwd_rows_per_split(int n, int f) {
  const int tiles = f / kBwdFtB;
  int s = (2 * 132 + tiles - 1) / tiles;
  const int chunks = (n + bf16k::kChunkB - 1) / bf16k::kChunkB;
  if (s > chunks) s = chunks;
  if (s < 1) s = 1;
  const int per = (chunks + s - 1) / s;
  return per * bf16k::kChunkB;
}

// Row splits of pass B, counted after the rounding above, so that every
// split holds at least one row.
int bwd_splits(int n, int f) {
  const int per = bwd_rows_per_split(n, f);
  const int s = (n + per - 1) / per;
  return s < 1 ? 1 : s;
}

size_t bwd_a_bytes(int dtype, int d) {
  return dtype == 1 ? bf16k::layout_a(kBwdRows, d).bytes
                    : f32k::layout_a(kBwdRows, d).bytes;
}

size_t bwd_b_bytes(int dtype, int d) {
  return dtype == 1 ? bf16k::layout_b(d).bytes : f32k::layout_b(d).bytes;
}

int fwd_rows(int dtype, int d) {
  for (int rows = 32; rows >= 16; rows /= 2) {
    const size_t b = dtype == 1 ? bf16k::layout(rows, d).bytes
                                : f32k::layout(rows, d).bytes;
    if (b <= kMaxSmem) return rows;
  }
  return 0;
}

// The forward of both functions; g == nullptr selects ffn_fused (bl and
// ff_scale unused, dp2 keeps everything).
int launch_fwd(int dtype, const void* x, const void* g, const void* bl,
               const void* w1, const void* b1, const void* w2,
               const void* b2, void* y, int n, int d, int f, float ff_scale,
               float eps, int act, Drop dp1, Drop dp2, void* stream) {
  const int rows = fwd_rows(dtype, d);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (n + rows - 1) / rows;
  cudaError_t e;
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    auto kernel = rows == 32 ? bf16k::ln_ffn_fwd<32> : bf16k::ln_ffn_fwd<16>;
    const size_t bytes = bf16k::layout(rows, d).bytes;
    if ((e = set_smem(kernel, bytes)) != cudaSuccess) return (int)e;
    kernel<<<grid, kThreads, bytes, s>>>(
        static_cast<const bf*>(x), static_cast<const float*>(g),
        static_cast<const float*>(bl), static_cast<const bf*>(w1),
        static_cast<const float*>(b1), static_cast<const bf*>(w2),
        static_cast<const float*>(b2), static_cast<bf*>(y), n, d, f,
        ff_scale, eps, act, dp1, dp2);
  } else {
    auto kernel = rows == 32 ? f32k::ln_ffn_fwd<32> : f32k::ln_ffn_fwd<16>;
    const size_t bytes = f32k::layout(rows, d).bytes;
    if ((e = set_smem(kernel, bytes)) != cudaSuccess) return (int)e;
    kernel<<<grid, kThreads, bytes, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(bl), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(y), n, d, f,
        ff_scale, eps, act, dp1, dp2);
  }
  return (int)cudaGetLastError();
}

// fp32 workspace of the backward (floats): per pass-A block the db2
// partials (and with the LayerNorm the dgamma and dbeta ones), per pass-B
// split dW1, dW2 and db1; 0 when the layouts do not fit this width.
long long bwd_workspace(int dtype, int n, int d, int f, bool ln) {
  if (bwd_a_bytes(dtype, d) > kMaxSmem || bwd_b_bytes(dtype, d) > kMaxSmem)
    return 0;
  const long long blocks = (n + kBwdRows - 1) / kBwdRows;
  const long long splits = bwd_splits(n, f);
  return (ln ? 3 : 1) * blocks * d + splits * (2LL * f * d + f);
}

// The backward of both functions; g == nullptr selects ffn_fused (bl, dg,
// dbl, rows_buf and ff_scale unused, dp2 keeps everything): pass B then
// reads x and dy, which are its LN(x) and dy2.
template <typename T, typename KA, typename KB>
int launch_bwd(KA ka, KB kb, const T* x, const T* dy, const float* g,
               const float* bl, const T* w1, const float* b1, const T* w2,
               T* dx, float* dg, float* dbl, float* dw1, float* db1,
               float* dw2, float* db2, float* ws, T* rows_buf, int n, int d,
               int f, float ff_scale, float eps, int act, Drop dp1, Drop dp2,
               cudaStream_t s) {
  const bool ln = g != nullptr;
  const int dtype = sizeof(T) == 2 ? 1 : 0;
  if (bwd_workspace(dtype, n, d, f, ln) == 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kBwdRows - 1) / kBwdRows;
  const int splits = bwd_splits(n, f);
  const int rows_per_split = bwd_rows_per_split(n, f);
  float* db2p = ws;
  float* dgp = ln ? db2p + (size_t)blocks * d : nullptr;
  float* dblp = ln ? dgp + (size_t)blocks * d : nullptr;
  float* dw1p = db2p + (size_t)(ln ? 3 : 1) * blocks * d;
  float* dw2p = dw1p + (size_t)splits * f * d;
  float* db1p = dw2p + (size_t)splits * f * d;
  T* xn_out = ln ? rows_buf : nullptr;
  T* dy2_out = ln ? rows_buf + (size_t)n * d : nullptr;
  const size_t a_bytes = bwd_a_bytes(dtype, d), b_bytes = bwd_b_bytes(dtype, d);
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
  if (ln) {
    if ((e = sum_into(dgp, dg, blocks, d, s)) != cudaSuccess) return (int)e;
    if ((e = sum_into(dblp, dbl, blocks, d, s)) != cudaSuccess) return (int)e;
  }
  if ((e = sum_into(db2p, db2, blocks, d, s)) != cudaSuccess) return (int)e;
  if ((e = sum_into(dw1p, dw1, splits, f * d, s)) != cudaSuccess)
    return (int)e;
  if ((e = sum_into(dw2p, dw2, splits, f * d, s)) != cudaSuccess)
    return (int)e;
  return (int)sum_into(db1p, db1, splits, f, s);
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
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    return launch_bwd<bf>(
        bf16k::ln_ffn_bwd_rows<kBwdRows>, bf16k::ln_ffn_bwd_weights,
        static_cast<const bf*>(x), static_cast<const bf*>(dy), gf, blf,
        static_cast<const bf*>(w1), b1f, static_cast<const bf*>(w2),
        static_cast<bf*>(dx), dg, dbl, dw1, db1, dw2, db2, ws,
        static_cast<bf*>(rows_buf), n, d, f, ff_scale, eps, act, dp1, dp2, s);
  }
  return launch_bwd<float>(
      f32k::ln_ffn_bwd_rows<kBwdRows>, f32k::ln_ffn_bwd_weights,
      static_cast<const float*>(x), static_cast<const float*>(dy), gf, blf,
      static_cast<const float*>(w1), b1f, static_cast<const float*>(w2),
      static_cast<float*>(dx), dg, dbl, dw1, db1, dw2, db2, ws,
      static_cast<float*>(rows_buf), n, d, f, ff_scale, eps, act, dp1, dp2, s);
}

}  // namespace

extern "C" {

// Rows a forward CTA takes for this dtype (0 = fp32, 1 = bf16) and width:
// 32 when the shared-memory layout fits, else 16; 0 when neither fits.
int ln_ffn_residual_rows(int dtype, int d) { return fwd_rows(dtype, d); }

// Shape and alignment checks are the caller's (ops/ffn.py). Returns a
// cudaError_t code; 0 is success. thresh >= 65536 turns a mask off.
int ln_ffn_residual_fwd(int dtype, const void* x, const void* g,
                        const void* bl, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* y, int n, int d,
                        int f, float ff_scale, float eps, int act,
                        unsigned key1, int thresh1, float scale1,
                        unsigned key2, int thresh2, float scale2,
                        void* stream) {
  return launch_fwd(dtype, x, g, bl, w1, b1, w2, b2, y, n, d, f, ff_scale,
                    eps, act, make_drop(key1, thresh1, scale1),
                    make_drop(key2, thresh2, scale2), stream);
}

// ffn_fused's forward: drop1(act(x W1^T + b1)) W2^T + b2.
int ffn_fused_fwd(int dtype, const void* x, const void* w1, const void* b1,
                  const void* w2, const void* b2, void* y, int n, int d,
                  int f, int act, unsigned key1, int thresh1, float scale1,
                  void* stream) {
  return launch_fwd(dtype, x, nullptr, nullptr, w1, b1, w2, b2, y, n, d, f,
                    1.0f, 0.0f, act, make_drop(key1, thresh1, scale1),
                    make_drop(0u, kKeepAll, 1.0f), stream);
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
                        int thresh2, float scale2, void* stream) {
  return launch_bwd_any(dtype, x, dy, g, bl, w1, b1, w2, dx, dg, dbl, dw1,
                        db1, dw2, db2, ws, rows_buf, n, d, f, ff_scale, eps,
                        act, make_drop(key1, thresh1, scale1),
                        make_drop(key2, thresh2, scale2), stream);
}

// ffn_fused's backward: dx in the compute dtype; dw1 [F, D], db1, dw2
// [D, F], db2 in fp32; ws holds ffn_fused_bwd_workspace() floats.
int ffn_fused_bwd(int dtype, const void* x, const void* dy, const void* w1,
                  const void* b1, const void* w2, void* dx, float* dw1,
                  float* db1, float* dw2, float* db2, float* ws, int n, int d,
                  int f, int act, unsigned key1, int thresh1, float scale1,
                  void* stream) {
  return launch_bwd_any(dtype, x, dy, nullptr, nullptr, w1, b1, w2, dx,
                        nullptr, nullptr, dw1, db1, dw2, db2, ws, nullptr, n,
                        d, f, 1.0f, 0.0f, act,
                        make_drop(key1, thresh1, scale1),
                        make_drop(0u, kKeepAll, 1.0f), stream);
}

}  // extern "C"
