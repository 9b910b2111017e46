// Helpers shared by the hand-written kernels of the conv block
// (conv_block.cu), ln_matmul.cu, the 2-layer LSTM (lstm2_seq.cu) and the
// RNN-T joint's fp32 form (rnnt_joint.cu): element conversions, the
// dropout hash, the fixed-order partial sums, and one block-wide tile
// product
//
//   C[M x N] (fp32, row-major, ldc) += A[M x K] * B[K x N]
//
// with the accumulator in shared memory. A is row-major (A(i,k) =
// A[i*lda + k]) or column-major (A[k*lda + i]); B row-major (B(k,j) =
// B[k*ldb + j]) or column-major (B[j*ldb + k]). A and B may lie in shared
// or global memory. It runs plain FMA in 4x4 register tiles per thread (M
// and N multiples of 4), so it stays full fp32 (no TF32). Each output tile
// always goes to the same thread for the same (M, N), so two calls
// on the same C need no barrier between them; the caller synchronises
// before reading C elsewhere. With LOAD = false the product starts from 0
// instead of C's contents (C = A * B).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tile {

using bf = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // 227 KB usable by one block on sm_90
constexpr int kKeepAll = 65536;      // dropout threshold meaning "no mask"

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf from_f<bf>(float v) {
  return __float2bfloat16(v);
}
// v rounded to T and back: one rounding point of the compute dtype.
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float sigmoidf_(float z) {
  return 1.0f / (1.0f + expf(-z));
}

// The dropout hash of ops/dropout.py::hash32.
__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x21f0aaadu;
  x ^= x >> 15;
  x *= 0x735a2d97u;
  x ^= x >> 15;
  return x;
}

// One dropout stream: keep iff (hash32((index + base) ^ key) & 0xFFFF) <
// thresh. A process that holds rows of a larger batch draws the whole
// batch's mask: base shifts a row-major index by its first row times the
// row's width. K4 draws at (t * rows + row0 + b) * H + j instead: rows is
// the whole batch and row0 the process's first row (base stays 0).
struct Drop {
  uint32_t key;
  int thresh;
  float scale;
  uint32_t base;
  uint32_t rows;
  uint32_t row0;
};

__device__ __forceinline__ float drop(const Drop& dp, uint32_t index,
                                      float v) {
  if (dp.thresh >= kKeepAll) return v;
  return (hash32((index + dp.base) ^ dp.key) & 0xFFFFu) < (uint32_t)dp.thresh
             ? v * dp.scale
             : 0.0f;
}

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

template <bool A_ROW, bool B_ROW, bool LOAD = true>
__device__ void mma_acc(float* C, int ldc, const float* A, int lda,
                        const float* B, int ldb, int M, int N, int K) {
  const int tn = N / 4, tiles = (M / 4) * tn;
  for (int tile = threadIdx.x; tile < tiles; tile += blockDim.x) {
    const int i0 = (tile / tn) * 4, j0 = (tile % tn) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = LOAD ? C[(size_t)(i0 + i) * ldc + j0 + j] : 0.0f;
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = A_ROW ? A[(size_t)(i0 + i) * lda + k]
                     : A[(size_t)k * lda + i0 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = B_ROW ? B[(size_t)k * ldb + j0 + j]
                     : B[(size_t)(j0 + j) * ldb + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) C[(size_t)(i0 + i) * ldc + j0 + j] = acc[i][j];
  }
}

// out[o * m + j] = sum over k < s of part[(o * s + k) * stride + j], k in
// order; grid (ceil(m / 32), outer), block (32, 8): threadIdx.y strides
// over k and the 8 partial sums are added in a fixed order. Deterministic.
__global__ void sum_partials(const float* __restrict__ part,
                             float* __restrict__ out, int s, int m,
                             size_t stride) {
  __shared__ float acc[8][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  const size_t o = blockIdx.y;
  float v = 0.0f;
  if (j < m)
    for (int k = threadIdx.y; k < s; k += 8)
      v += part[(o * s + k) * stride + j];
  acc[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && j < m) {
    float t = 0.0f;
    for (int k = 0; k < 8; ++k) t += acc[k][threadIdx.x];
    out[o * m + j] = t;
  }
}

// Partials spaced `stride` floats apart (stride 0: packed, m apart).
inline cudaError_t sum_into(const float* part, float* out, int outer, int s,
                            int m, cudaStream_t stream, size_t stride = 0) {
  sum_partials<<<dim3((m + 31) / 32, outer), dim3(32, 8), 0, stream>>>(
      part, out, s, m, stride ? stride : (size_t)m);
  return cudaGetLastError();
}

// The kernel's dynamic shared memory, with the SM's carveout at its
// largest so that as many blocks fit as the bytes allow.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

inline Drop make_drop(unsigned key, int thresh, float scale,
                      unsigned base = 0, unsigned rows = 0,
                      unsigned row0 = 0) {
  Drop dp;
  dp.key = key;
  dp.thresh = thresh;
  dp.scale = scale;
  dp.base = base;
  dp.rows = rows;
  dp.row0 = row0;
  return dp;
}

}  // namespace tile
