// LayerNorm fused into a matmul for Hopper (sm_90a), forward and backward:
//
//   y = (LN(x) * rowmask) @ W^T + b
//
// Replaces wenet_celoss_tpu/ops/ffn_pallas.py::_ln_mm_fwd_kernel and
// ::_ln_mm_bwd_kernel (the Pallas forward and backward of ln_matmul): the
// conformer layer's LN_mha -> merged QKV projection (K = 3D) and LN_conv ->
// row-masked pointwise conv1 (K = 2D), and the decoder's self-attention
// projection. Rounding points are the Pallas kernels': LayerNorm in fp32,
// times the row mask, cast to the compute type once before the GEMM; fp32
// accumulation; the fp32 bias added before the output's one cast; the
// backward's dxn = (dy W) * mask and the LayerNorm VJP in fp32, dW from the
// cast LN(x) and dy.
//
// What bounds it: at the main path's shapes (D = 256, K = 768 or 512, bf16)
// the forward does 2*N*D*K operations against N*(D + K) elements moved,
// about 200 operations a byte, below the H100's ~295: the forward is
// bound by bytes, the backward (4*N*D*K operations) by operations
// (ops/bounds.py). The design keeps LN(x) out of device memory in the
// forward (its one round trip is what the TPU kernel removes) and reads x
// and dy once per pass.
//
// Design, simple first. Forward: a block of 256 threads owns kRows rows,
// computes their LayerNorm (one warp a row, two-pass mean and variance)
// into shared memory in the compute type, then walks K in tiles of kCols
// rows of W ([K, D] torch.nn.Linear layout, so a tile is contiguous and
// needs no transpose), each staged in shared memory, multiplied and written
// out with the bias.
//
// Backward: the TPU accumulates dg/dbl/dW/db with += over its sequential
// grid; CUDA blocks run at once, so the work is split in two passes with
// per-block partials summed in a fixed order afterwards (the same bits on
// every call, no atomics), K1's structure (ln_ffn_residual.cu):
//   A (row-parallel, owns dx): per kRows rows, the LayerNorm statistics,
//     LN(x) * mask written once in the compute type for pass B, dxn =
//     dy W accumulated over K chunks in shared memory, then the mask, the
//     LayerNorm VJP and dx; partials of dgamma = sum dxn * xhat and dbeta =
//     sum dxn per block.
//   B (K-tile x row split, owns the weights): dW[tile] = dy[:, tile]^T
//     LN(x) and db[tile] = sum dy over its rows; the split count fills
//     whole waves of the card's blocks.
// bf16 runs the GEMMs on the tensor cores (WMMA, tile_mma.cuh), fp32 plain
// FMA so that it stays full fp32. Later work: wgmma, TMA staging.
//
// Plain C interface, bound with ctypes; each launch returns
// cudaGetLastError().

#include "tile_mma.cuh"

namespace {

using namespace tile;

constexpr int kRows = 64;   // rows of a forward or pass-A block
constexpr int kCols = 64;   // W rows a step takes: forward, pass A, pass B
constexpr int kChunk = 64;  // pass B's row chunk
constexpr int kMaxSplits = 64;

// Shared-memory row padding: bf16 rows stay 16-byte aligned (WMMA and
// vector stores) with their banks shifted; fp32 rows take an odd stride so
// that the FMA tiles' column walks hit distinct banks.
template <typename T> __host__ __device__ constexpr int pad() {
  return sizeof(T) == 2 ? 8 : 1;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst[r * ldd + c] = src[(row0 + r) * lds + col0 + c] for r < rows,
// c < cols; rows at or past row_end are zero. bf16 moves 16-byte vectors
// (cols, lds and col0 multiples of 8).
template <typename T>
__device__ void stage(const T* __restrict__ src, int lds, int row0,
                      int row_end, int col0, T* dst, int ldd, int rows,
                      int cols) {
  if constexpr (sizeof(T) == 2) {
    const int vecs = cols / 8;
    for (int i = threadIdx.x; i < rows * vecs; i += blockDim.x) {
      const int r = i / vecs, v = i % vecs, gr = row0 + r;
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (gr < row_end)
        q = *reinterpret_cast<const uint4*>(src + (size_t)gr * lds + col0 +
                                            v * 8);
      *reinterpret_cast<uint4*>(dst + r * ldd + v * 8) = q;
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, c = i % cols, gr = row0 + r;
      dst[r * ldd + c] =
          gr < row_end ? src[(size_t)gr * lds + col0 + c] : 0.0f;
    }
  }
}

// LN(x) * mask of rows [row0, row0 + rows) into dst (row stride ldd), one
// warp a row, in fp32, cast once. Rows at or past row_end are zero when
// zero_tail, else left alone. With mu/rstd given, stores each row's
// statistics (0 past row_end).
template <typename T>
__device__ void ln_rows(const T* __restrict__ x, const float* __restrict__ g,
                        const float* __restrict__ bl,
                        const float* __restrict__ mask, T* dst, int ldd,
                        int row0, int rows, int row_end, int d, float eps,
                        bool zero_tail, float* mu_out, float* rstd_out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int r = warp; r < rows; r += nwarps) {
    const int gr = row0 + r;
    float mu = 0.0f, rstd = 0.0f;
    if (gr < row_end) {
      const T* src = x + (size_t)gr * d;
      float s = 0.0f;
      for (int c = lane; c < d; c += 32) s += to_f(src[c]);
      mu = warp_sum(s) / d;
      float v = 0.0f;
      for (int c = lane; c < d; c += 32) {
        const float t = to_f(src[c]) - mu;
        v += t * t;
      }
      rstd = rsqrtf(warp_sum(v) / d + eps);
      const float m = mask != nullptr ? mask[gr] : 1.0f;
      for (int c = lane; c < d; c += 32)
        dst[(size_t)r * ldd + c] =
            from_f<T>(((to_f(src[c]) - mu) * rstd * g[c] + bl[c]) * m);
    } else if (zero_tail) {
      for (int c = lane; c < d; c += 32)
        dst[(size_t)r * ldd + c] = from_f<T>(0.0f);
    }
    if (mu_out != nullptr && lane == 0) {
      mu_out[r] = mu;
      rstd_out[r] = rstd;
    }
  }
}

// ------------------------------------------------------------- forward ---
struct FwdLayout {
  int ldx, ldw, ldc;
  size_t o_w, o_c, bytes;
};

template <typename T>
__host__ __device__ inline FwdLayout fwd_layout(int d) {
  FwdLayout L;
  L.ldx = d + pad<T>();
  L.ldw = d + pad<T>();
  L.ldc = kCols + 4;
  size_t o = align128((size_t)kRows * L.ldx * sizeof(T));
  L.o_w = o;
  o += align128((size_t)kCols * L.ldw * sizeof(T));
  L.o_c = o;
  o += align128((size_t)kRows * L.ldc * 4);
  L.bytes = o;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_mm_fwd(const T* __restrict__ x, const float* __restrict__ g,
          const float* __restrict__ bl, const T* __restrict__ w,
          const float* __restrict__ b, const float* __restrict__ mask,
          T* __restrict__ y, int n, int d, int k, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L = fwd_layout<T>(d);
  T* xn = reinterpret_cast<T*>(smem);
  T* ws = reinterpret_cast<T*>(smem + L.o_w);
  float* c = reinterpret_cast<float*>(smem + L.o_c);
  const int row0 = blockIdx.x * kRows;

  ln_rows<T>(x, g, bl, mask, xn, L.ldx, row0, kRows, n, d, eps, true,
             nullptr, nullptr);
  for (int k0 = 0; k0 < k; k0 += kCols) {
    // The barrier after staging also keeps the last step's epilogue from
    // reading c while this step's product overwrites it.
    stage<T>(w, d, k0, k, 0, ws, L.ldw, kCols, d);
    __syncthreads();
    // c[kRows, kCols] = xn[kRows, D] @ W_tile^T (column-major in ws).
    mma_acc<true, false, false>(c, L.ldc, xn, L.ldx, ws, L.ldw, kRows, kCols,
                                d);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, j = i % kCols, gr = row0 + r;
      if (gr < n)
        y[(size_t)gr * k + k0 + j] = from_f<T>(c[r * L.ldc + j] + b[k0 + j]);
    }
  }
}

// -------------------------------------------------------------- pass A ---
struct ALayout {
  int ldd, ldw, ldc;
  size_t o_w, o_c, o_mu, o_rstd, bytes;
};

template <typename T>
__host__ __device__ inline ALayout a_layout(int d) {
  ALayout L;
  L.ldd = kCols + pad<T>();
  L.ldw = d + pad<T>();
  L.ldc = d + 4;
  size_t o = align128((size_t)kRows * L.ldd * sizeof(T));
  L.o_w = o;
  o += align128((size_t)kCols * L.ldw * sizeof(T));
  L.o_c = o;
  o += align128((size_t)kRows * L.ldc * 4);
  L.o_mu = o;
  o += align128((size_t)kRows * 4);
  L.o_rstd = o;
  o += align128((size_t)kRows * 4);
  L.bytes = o;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_mm_bwd_rows(const T* __restrict__ x, const T* __restrict__ dy,
               const float* __restrict__ g, const float* __restrict__ bl,
               const T* __restrict__ w, const float* __restrict__ mask,
               T* __restrict__ dx, T* __restrict__ xn_out,
               float* __restrict__ dgp, float* __restrict__ dblp, int n,
               int d, int k, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ALayout L = a_layout<T>(d);
  T* dyt = reinterpret_cast<T*>(smem);
  T* ws = reinterpret_cast<T*>(smem + L.o_w);
  float* c = reinterpret_cast<float*>(smem + L.o_c);
  float* mu = reinterpret_cast<float*>(smem + L.o_mu);
  float* rstd = reinterpret_cast<float*>(smem + L.o_rstd);
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // LN(x) * mask for pass B, straight to device memory.
  ln_rows<T>(x, g, bl, mask, xn_out + (size_t)row0 * d, d, row0, kRows, n, d,
             eps, false, mu, rstd);
  // c[kRows, D] = dy[rows, :] @ W, K in chunks of kCols.
  for (int k0 = 0; k0 < k; k0 += kCols) {
    stage<T>(dy, k, row0, n, k0, dyt, L.ldd, kRows, kCols);
    stage<T>(w, d, k0, k, 0, ws, L.ldw, kCols, d);
    __syncthreads();
    if (k0 == 0)
      mma_acc<true, true, false>(c, L.ldc, dyt, L.ldd, ws, L.ldw, kRows, d,
                                 kCols);
    else
      mma_acc<true, true, true>(c, L.ldc, dyt, L.ldd, ws, L.ldw, kRows, d,
                                kCols);
    __syncthreads();
  }
  // dxn = c * mask (kept in c for the partials), then the LayerNorm VJP.
  for (int r = warp; r < kRows; r += kWarps) {
    const int gr = row0 + r;
    if (gr >= n) continue;
    const float m = mask != nullptr ? mask[gr] : 1.0f;
    const T* xr = x + (size_t)gr * d;
    float* cr = c + (size_t)r * L.ldc;
    float s1 = 0.0f, s2 = 0.0f;
    for (int col = lane; col < d; col += 32) {
      const float dxn = cr[col] * m;
      cr[col] = dxn;
      const float dxhat = dxn * g[col];
      s1 += dxhat;
      s2 += dxhat * (to_f(xr[col]) - mu[r]) * rstd[r];
    }
    const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
    for (int col = lane; col < d; col += 32) {
      const float xhat = (to_f(xr[col]) - mu[r]) * rstd[r];
      dx[(size_t)gr * d + col] =
          from_f<T>(rstd[r] * (cr[col] * g[col] - m1 - xhat * m2));
    }
  }
  __syncthreads();
  const size_t part = (size_t)blockIdx.x * d;
  for (int col = threadIdx.x; col < d; col += kThreads) {
    float sg = 0.0f, sb = 0.0f;
    for (int r = 0; r < kRows && row0 + r < n; ++r) {
      const float v = c[(size_t)r * L.ldc + col];
      sg += v * (to_f(x[(size_t)(row0 + r) * d + col]) - mu[r]) * rstd[r];
      sb += v;
    }
    dgp[part + col] = sg;
    dblp[part + col] = sb;
  }
}

// -------------------------------------------------------------- pass B ---
struct BLayout {
  int ldd, ldx, ldc;
  size_t o_x, o_c, o_db, bytes;
};

template <typename T>
__host__ __device__ inline BLayout b_layout(int d) {
  BLayout L;
  L.ldd = kCols + pad<T>();
  L.ldx = d + pad<T>();
  L.ldc = d + 4;
  size_t o = align128((size_t)kChunk * L.ldd * sizeof(T));
  L.o_x = o;
  o += align128((size_t)kChunk * L.ldx * sizeof(T));
  L.o_c = o;
  o += align128((size_t)kCols * L.ldc * 4);
  L.o_db = o;
  o += align128((size_t)kCols * 4);
  L.bytes = o;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_mm_bwd_weights(const T* __restrict__ xn_g, const T* __restrict__ dy,
                  float* __restrict__ dwp, float* __restrict__ dbp, int n,
                  int d, int k, int rows_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BLayout L = b_layout<T>(d);
  T* dyt = reinterpret_cast<T*>(smem);
  T* xt = reinterpret_cast<T*>(smem + L.o_x);
  float* c = reinterpret_cast<float*>(smem + L.o_c);
  float* sdb = reinterpret_cast<float*>(smem + L.o_db);
  const int k0 = blockIdx.x * kCols, split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);

  for (int i = threadIdx.x; i < kCols * L.ldc; i += kThreads) c[i] = 0.0f;
  for (int j = threadIdx.x; j < kCols; j += kThreads) sdb[j] = 0.0f;
  // mma_acc maps c to threads otherwise than the zeroing.
  __syncthreads();
  for (int row0 = r_begin; row0 < r_end; row0 += kChunk) {
    stage<T>(dy, k, row0, r_end, k0, dyt, L.ldd, kChunk, kCols);
    stage<T>(xn_g, d, row0, r_end, 0, xt, L.ldx, kChunk, d);
    __syncthreads();
    // c[kCols, D] += dy_chunk^T (column-major in dyt) @ xn_chunk.
    mma_acc<false, true, true>(c, L.ldc, dyt, L.ldd, xt, L.ldx, kCols, d,
                               kChunk);
    for (int j = threadIdx.x; j < kCols; j += kThreads) {
      float s = 0.0f;
      for (int r = 0; r < kChunk; ++r) s += to_f(dyt[r * L.ldd + j]);
      sdb[j] += s;
    }
    __syncthreads();
  }
  float* out = dwp + ((size_t)split * k + k0) * d;
  for (int i = threadIdx.x; i < kCols * d; i += kThreads)
    out[i] = c[(i / d) * L.ldc + i % d];
  for (int j = threadIdx.x; j < kCols; j += kThreads)
    dbp[(size_t)split * k + k0 + j] = sdb[j];
}

// ---------------------------------------------------------------- host ---
template <typename T>
bool fits(int d) {
  return fwd_layout<T>(d).bytes <= kMaxSmem &&
         a_layout<T>(d).bytes <= kMaxSmem && b_layout<T>(d).bytes <= kMaxSmem;
}

// Pass B's grid: K / kCols tiles x S row splits, each split a whole number
// of kChunk-row chunks, none empty. A block's time is about proportional to
// its rows, so the run takes about ceil(tiles * S / slots) waves of N / S
// rows each (slots: the blocks the card holds at once); S is the smallest
// that minimises that.
template <typename T>
cudaError_t splits_for(int n, int d, int k, int* splits,
                       int* rows_per_split) {
  auto kb = ln_mm_bwd_weights<T>;
  const size_t bytes = b_layout<T>(d).bytes;
  cudaError_t e = set_smem(kb, bytes);
  int dev = 0, sms = 1, per_sm = 1;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kb, kThreads,
                                                      bytes);
  if (e != cudaSuccess) return e;
  const int slots = sms * (per_sm > 0 ? per_sm : 1);
  const int tiles = k / kCols;
  const int chunks = (n + kChunk - 1) / kChunk;
  int best = 1;
  long long best_num = 1, best_den = 0;  // waves / splits, as a fraction
  for (int s = 1; s <= kMaxSplits && s <= chunks; ++s) {
    const long long waves = ((long long)tiles * s + slots - 1) / slots;
    if (best_den == 0 || waves * best_den < best_num * s) {
      best = s;
      best_num = waves;
      best_den = s;
    }
  }
  const int per = (chunks + best - 1) / best;
  *rows_per_split = per * kChunk;
  *splits = (n + *rows_per_split - 1) / *rows_per_split;
  if (*splits < 1) *splits = 1;
  return cudaSuccess;
}

template <typename T>
int launch_fwd(const void* x, const void* g, const void* bl, const void* w,
               const void* b, const void* mask, void* y, int n, int d, int k,
               float eps, cudaStream_t s) {
  if (!fits<T>(d)) return (int)cudaErrorInvalidValue;
  auto kernel = ln_mm_fwd<T>;
  const size_t bytes = fwd_layout<T>(d).bytes;
  cudaError_t e;
  if ((e = set_smem(kernel, bytes)) != cudaSuccess) return (int)e;
  kernel<<<(n + kRows - 1) / kRows, kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(bl), static_cast<const T*>(w),
      static_cast<const float*>(b), static_cast<const float*>(mask),
      static_cast<T*>(y), n, d, k, eps);
  return (int)cudaGetLastError();
}

template <typename T>
long long workspace(int n, int d, int k) {
  int splits = 0, rows = 0;
  if (!fits<T>(d)) return 0;
  if (splits_for<T>(n, d, k, &splits, &rows) != cudaSuccess) return -1;
  const long long blocks = (n + kRows - 1) / kRows;
  return 2 * blocks * d + (long long)splits * ((long long)k * d + k);
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const void* g, const void* bl,
               const void* w, const void* mask, void* dx, float* dg,
               float* dbl, float* dw, float* db, float* ws, void* xn_buf,
               int n, int d, int k, float eps, cudaStream_t s) {
  int splits = 0, rows_per_split = 0;
  cudaError_t e;
  if (!fits<T>(d)) return (int)cudaErrorInvalidValue;
  if ((e = splits_for<T>(n, d, k, &splits, &rows_per_split)) != cudaSuccess)
    return (int)e;
  const int blocks = (n + kRows - 1) / kRows;
  float* dgp = ws;
  float* dblp = dgp + (size_t)blocks * d;
  float* dwp = dblp + (size_t)blocks * d;
  float* dbp = dwp + (size_t)splits * k * d;
  auto ka = ln_mm_bwd_rows<T>;
  const size_t a_bytes = a_layout<T>(d).bytes;
  if ((e = set_smem(ka, a_bytes)) != cudaSuccess) return (int)e;
  T* xn = static_cast<T*>(xn_buf);
  ka<<<blocks, kThreads, a_bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(g), static_cast<const float*>(bl),
      static_cast<const T*>(w), static_cast<const float*>(mask),
      static_cast<T*>(dx), xn, dgp, dblp, n, d, k, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // splits_for set pass B's shared-memory attribute.
  ln_mm_bwd_weights<T><<<dim3(k / kCols, splits), kThreads,
                         b_layout<T>(d).bytes, s>>>(
      xn, static_cast<const T*>(dy), dwp, dbp, n, d, k, rows_per_split);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((e = sum_into(dgp, dg, 1, blocks, d, s)) != cudaSuccess) return (int)e;
  if ((e = sum_into(dblp, dbl, 1, blocks, d, s)) != cudaSuccess)
    return (int)e;
  if ((e = sum_into(dwp, dw, 1, splits, k * d, s)) != cudaSuccess)
    return (int)e;
  return (int)sum_into(dbp, db, 1, splits, k, s);
}

}  // namespace

extern "C" {

// dtype 0 = fp32, 1 = bf16. Shape and alignment checks are the caller's
// (ops/ln_matmul.py): D a multiple of 16, K of 64. mask is [N] fp32 or
// null. Returns a cudaError_t code; 0 is success.
int ln_matmul_fwd(int dtype, const void* x, const void* g, const void* bl,
                  const void* w, const void* b, const void* mask, void* y,
                  int n, int d, int k, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch_fwd<bf>(x, g, bl, w, b, mask, y, n, d, k, eps, s)
             : launch_fwd<float>(x, g, bl, w, b, mask, y, n, d, k, eps, s);
}

// fp32 workspace the backward needs (floats); 0 when this width does not
// fit the kernels' shared memory, -1 on a CUDA error.
long long ln_matmul_bwd_workspace(int dtype, int n, int d, int k) {
  return dtype == 1 ? workspace<bf>(n, d, k) : workspace<float>(n, d, k);
}

// dx in the compute dtype; dg, dbl, dw [K, D], db in fp32. ws holds
// ln_matmul_bwd_workspace() floats; xn_buf n * d values of the compute
// dtype (pass A's LN(x) * mask for pass B).
int ln_matmul_bwd(int dtype, const void* x, const void* dy, const void* g,
                  const void* bl, const void* w, const void* mask, void* dx,
                  float* dg, float* dbl, float* dw, float* db, float* ws,
                  void* xn_buf, int n, int d, int k, float eps,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch_bwd<bf>(x, dy, g, bl, w, mask, dx, dg, dbl, dw, db, ws,
                              xn_buf, n, d, k, eps, s)
             : launch_bwd<float>(x, dy, g, bl, w, mask, dx, dg, dbl, dw, db,
                                 ws, xn_buf, n, d, k, eps, s);
}

}  // extern "C"
