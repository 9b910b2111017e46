// Fused conformer FFN block, forward only, for Hopper (sm_90a):
//
//   y = x + ff_scale * (act(LN(x) @ W1^T + b1) @ W2^T + b2)
//
// Replaces wenet_celoss_tpu/ops/ffn_pallas.py::_ln_ffn_fwd_kernel (the
// Pallas forward of ln_ffn_residual) with both dropout rates 0. Rounding
// points are the Pallas kernel's: LayerNorm in fp32, cast to the compute
// type; GEMM1 with fp32 accumulation plus b1; the activation in fp32, cast
// to the compute type; GEMM2 with fp32 accumulation plus b2; the scaled
// residual in fp32, cast once on store.
//
// What bounds it: at the main path's shape (N = 64*127 rows, D = 256,
// F = 2048) the work is 4*N*D*F = 17.05 GFLOP against 10.4 MB of traffic
// in bf16 (x, y, W1, W2 once each), about 1600 operations a byte, well
// past the H100's ~295: the kernel is compute-bound, 17.2 us at the bf16
// tensor-core peak (0.25 ms at the fp32 FMA peak); ops/bounds.py.
//
// Design, simple first. One CTA of 256 threads owns a block of ROWS rows.
// The TPU kernel holds the whole [rows, F] hidden in VMEM; here that is
// 8 KB a row in fp32 and does not fit in shared memory, so the CTA loops
// over F in tiles of FT columns instead: per tile it stages W1[f0:f0+FT, :]
// and W2[:, f0:f0+FT] in shared memory, computes act(xn @ W1_tile^T + b1)
// into a [ROWS, FT] shared tile, and adds h_tile @ W2_tile^T into an fp32
// [ROWS, D] accumulator that also lives in shared memory. Only x, the
// weights and y touch device memory. bf16 runs the two GEMMs on the tensor
// cores with WMMA 16x16x16 fragments; fp32 uses plain FMA so that it stays
// bit-faithful to fp32 (no TF32). The ragged row edge is masked in the
// kernel (rows past N are computed from zeros and never stored). Later
// work: wgmma, TMA staging and a persistent schedule.
//
// Weights arrive in torch.nn.Linear layout: W1 [F, D], W2 [D, F].
// Plain C interface, bound with ctypes; the launch returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // 227 KB usable by one block on sm_90

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

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

// LayerNorm of rows [row0, row0 + ROWS) into xn (row stride ldx), one warp
// a row, two-pass mean/variance in fp32 as the Pallas kernel does. Rows
// past n are zero.
template <typename T>
__device__ void layer_norm_rows(const T* __restrict__ x,
                                const float* __restrict__ g,
                                const float* __restrict__ bl, T* xn, int ldx,
                                int row0, int rows, int n, int d, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    T* dst = xn + (size_t)r * ldx;
    const int gr = row0 + r;
    if (gr >= n) {
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
  }
}

template <typename T>
__device__ void store_residual(const T* __restrict__ x,
                               const float* __restrict__ b2, const float* acc,
                               int lda, T* __restrict__ y, int row0, int rows,
                               int n, int d, float ff_scale) {
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, c = i % d, gr = row0 + r;
    if (gr < n) {
      const size_t o = (size_t)gr * d + c;
      y[o] = from_f<T>(to_f(x[o]) + ff_scale * (acc[r * lda + c] + b2[c]));
    }
  }
}

// ---------------------------------------------------------------- bf16 ---
namespace bf16k {
constexpr int FT = 64;

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

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
ln_ffn_fwd(const __nv_bfloat16* __restrict__ x, const float* __restrict__ g,
           const float* __restrict__ bl, const __nv_bfloat16* __restrict__ w1,
           const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
           const float* __restrict__ b2, __nv_bfloat16* __restrict__ y, int n,
           int d, int f, float ff_scale, float eps, int act) {
  using namespace nvcuda;
  using bf = __nv_bfloat16;
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

  layer_norm_rows<bf>(x, g, bl, xn, L.ldx, row0, ROWS, n, d, eps);
  for (int i = tid; i < ROWS * L.lda; i += kThreads) acc[i] = 0.0f;

  const int vec_w1 = d / 8;          // 16-byte vectors in a W1 row
  constexpr int vec_w2 = FT / 8;     // ... in a W2 row's F-tile
  constexpr int rt_n = ROWS / 16, ct_n = FT / 16;
  const int dt_n = d / 16;

  for (int f0 = 0; f0 < f; f0 += FT) {
    for (int i = tid; i < FT * vec_w1; i += kThreads) {
      const int j = i / vec_w1, v = i % vec_w1;
      *reinterpret_cast<uint4*>(w1s + j * L.ldw1 + v * 8) =
          *reinterpret_cast<const uint4*>(w1 + (size_t)(f0 + j) * d + v * 8);
    }
    for (int i = tid; i < d * vec_w2; i += kThreads) {
      const int c = i / vec_w2, v = i % vec_w2;
      *reinterpret_cast<uint4*>(w2s + c * L.ldw2 + v * 8) =
          *reinterpret_cast<const uint4*>(w2 + (size_t)c * f + f0 + v * 8);
    }
    __syncthreads();

    // GEMM1: hf[ROWS, FT] = xn[ROWS, D] @ W1_tile^T  (W1_tile^T is
    // column-major in w1s).
    for (int t = warp; t < rt_n * ct_n; t += kWarps) {
      const int rt = t / ct_n, ct = t % ct_n;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
      for (int k = 0; k < d; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf, wmma::col_major> b;
        wmma::load_matrix_sync(a, xn + rt * 16 * L.ldx + k, L.ldx);
        wmma::load_matrix_sync(b, w1s + ct * 16 * L.ldw1 + k, L.ldw1);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(hf + rt * 16 * L.ldhf + ct * 16, c, L.ldhf,
                              wmma::mem_row_major);
    }
    __syncthreads();

    for (int i = tid; i < ROWS * FT; i += kThreads) {
      const int r = i / FT, j = i % FT;
      h[r * L.ldh + j] =
          __float2bfloat16(act_fn(hf[r * L.ldhf + j] + b1[f0 + j], act));
    }
    __syncthreads();

    // GEMM2: acc[ROWS, D] += h[ROWS, FT] @ W2_tile^T.
    for (int t = warp; t < rt_n * dt_n; t += kWarps) {
      const int rt = t / dt_n, ct = t % dt_n;
      float* cp = acc + rt * 16 * L.lda + ct * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::load_matrix_sync(c, cp, L.lda, wmma::mem_row_major);
      for (int k = 0; k < FT; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf, wmma::col_major> b;
        wmma::load_matrix_sync(a, h + rt * 16 * L.ldh + k, L.ldh);
        wmma::load_matrix_sync(b, w2s + ct * 16 * L.ldw2 + k, L.ldw2);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(cp, c, L.lda, wmma::mem_row_major);
    }
    __syncthreads();
  }
  store_residual<bf>(x, b2, acc, L.lda, y, row0, ROWS, n, d, ff_scale);
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

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
ln_ffn_fwd(const float* __restrict__ x, const float* __restrict__ g,
           const float* __restrict__ bl, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ w2,
           const float* __restrict__ b2, float* __restrict__ y, int n, int d,
           int f, float ff_scale, float eps, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(ROWS, d);
  float* xn = reinterpret_cast<float*>(smem);
  float* w1s = reinterpret_cast<float*>(smem + L.o_w1);
  float* w2s = reinterpret_cast<float*>(smem + L.o_w2);
  float* h = reinterpret_cast<float*>(smem + L.o_h);
  float* acc = reinterpret_cast<float*>(smem + L.o_acc);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;

  layer_norm_rows<float>(x, g, bl, xn, L.ldx, row0, ROWS, n, d, eps);
  for (int i = tid; i < ROWS * L.lda; i += kThreads) acc[i] = 0.0f;

  const int vec_w1 = d / 4;
  constexpr int vec_w2 = FT / 4;
  for (int f0 = 0; f0 < f; f0 += FT) {
    for (int i = tid; i < FT * vec_w1; i += kThreads) {
      const int j = i / vec_w1, v = i % vec_w1;
      const float4 q =
          *reinterpret_cast<const float4*>(w1 + (size_t)(f0 + j) * d + v * 4);
      float* dst = w1s + j * L.ldw1 + v * 4;
      dst[0] = q.x; dst[1] = q.y; dst[2] = q.z; dst[3] = q.w;
    }
    for (int i = tid; i < d * vec_w2; i += kThreads) {
      const int c = i / vec_w2, v = i % vec_w2;
      const float4 q =
          *reinterpret_cast<const float4*>(w2 + (size_t)c * f + f0 + v * 4);
      float* dst = w2s + c * L.ldw2 + v * 4;
      dst[0] = q.x; dst[1] = q.y; dst[2] = q.z; dst[3] = q.w;
    }
    __syncthreads();

    // GEMM1 + bias + activation: one output a thread per pass.
    for (int i = tid; i < ROWS * FT; i += kThreads) {
      const int r = i / FT, j = i % FT;
      const float* a = xn + r * L.ldx;
      const float* b = w1s + j * L.ldw1;
      float s = 0.0f;
      for (int k = 0; k < d; ++k) s = fmaf(a[k], b[k], s);
      h[r * L.ldh + j] = act_fn(s + b1[f0 + j], act);
    }
    __syncthreads();

    // GEMM2: acc[ROWS, D] += h[ROWS, FT] @ W2_tile^T.
    for (int i = tid; i < ROWS * d; i += kThreads) {
      const int r = i / d, c = i % d;
      const float* a = h + r * L.ldh;
      const float* b = w2s + c * L.ldw2;
      float s = 0.0f;
      for (int k = 0; k < FT; ++k) s = fmaf(a[k], b[k], s);
      acc[r * L.lda + c] += s;
    }
    __syncthreads();
  }
  store_residual<float>(x, b2, acc, L.lda, y, row0, ROWS, n, d, ff_scale);
}
}  // namespace f32k

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, typename Kernel>
int launch(Kernel kernel, int rows, size_t bytes, const void* x,
           const void* g, const void* bl, const void* w1, const void* b1,
           const void* w2, const void* b2, void* y, int n, int d, int f,
           float ff_scale, float eps, int act, cudaStream_t stream) {
  cudaError_t e = set_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n + rows - 1) / rows;
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(bl), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<T*>(y), n, d, f, ff_scale,
      eps, act);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows a CTA takes for this dtype (0 = fp32, 1 = bf16) and width: 32 when
// the shared-memory layout fits, else 16; 0 when neither fits.
int ln_ffn_residual_rows(int dtype, int d) {
  for (int rows = 32; rows >= 16; rows /= 2) {
    const size_t b = dtype == 1 ? bf16k::layout(rows, d).bytes
                                : f32k::layout(rows, d).bytes;
    if (b <= kMaxSmem) return rows;
  }
  return 0;
}

// Shape and alignment checks are the caller's (ops/ffn.py). Returns a
// cudaError_t code; 0 is success.
int ln_ffn_residual_fwd(int dtype, const void* x, const void* g,
                        const void* bl, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* y, int n, int d,
                        int f, float ff_scale, float eps, int act,
                        void* stream) {
  const int rows = ln_ffn_residual_rows(dtype, d);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const size_t bytes = bf16k::layout(rows, d).bytes;
    return rows == 32
               ? launch<__nv_bfloat16>(bf16k::ln_ffn_fwd<32>, 32, bytes, x, g,
                                       bl, w1, b1, w2, b2, y, n, d, f,
                                       ff_scale, eps, act, s)
               : launch<__nv_bfloat16>(bf16k::ln_ffn_fwd<16>, 16, bytes, x, g,
                                       bl, w1, b1, w2, b2, y, n, d, f,
                                       ff_scale, eps, act, s);
  }
  const size_t bytes = f32k::layout(rows, d).bytes;
  return rows == 32
             ? launch<float>(f32k::ln_ffn_fwd<32>, 32, bytes, x, g, bl, w1,
                             b1, w2, b2, y, n, d, f, ff_scale, eps, act, s)
             : launch<float>(f32k::ln_ffn_fwd<16>, 16, bytes, x, g, bl, w1,
                             b1, w2, b2, y, n, d, f, ff_scale, eps, act, s);
}

}  // extern "C"
