// LayerNorm fused into a matmul for Hopper (sm_90a), forward and backward:
//
//   y = (LN(x) * rowmask) @ W^T + b
//
// Replaces wenet_celoss_tpu/ops/ffn_pallas.py::_ln_mm_fwd_kernel and
// ::_ln_mm_bwd_kernel (the Pallas forward and backward of ln_matmul): the
// conformer layer's LN_mha -> merged QKV projection (K = 3D) and LN_conv ->
// row-masked pointwise conv1 (K = 2D), and the decoder's self-attention
// projection. Rounding points are the Pallas kernels': LayerNorm in fp32
// (two-pass statistics), times the row mask, cast to the compute type once
// before the GEMM; fp32 accumulation; the fp32 bias added before the
// output's one cast; the backward's dxn = (dy W) * mask and the LayerNorm
// VJP in fp32, dW from the cast LN(x) and dy.
//
// What bounds it: at the main path's shapes (D = 256, K = 768 or 512, bf16)
// the forward does 2*N*D*K operations against N*(D + K) elements moved,
// about 200 operations a byte, below the H100's ~295: the forward is
// bound by bytes, y's above all (12.5 of the 17 MB at N = 8128, K = 768).
// The backward (4*N*D*K operations) sits at its operations bound and its
// bytes bound alike (ops/bounds.py). LN(x) never makes a round trip
// through device memory in the forward (what the TPU kernel removes); the
// backward writes it once, in bf16, for its weight pass.
//
// Backward structure: the TPU accumulates dg/dbl/dW/db with += over its
// sequential grid; CUDA blocks run at once, so the work is split in two
// passes with per-block partials summed in a fixed order afterwards (the
// same bits on every call, no atomics), K1's structure
// (ln_ffn_residual.cu):
//   A (row-parallel, owns dx): the LayerNorm statistics, LN(x) * mask
//     written once in the compute type for pass B, dxn = dy W summed over
//     K, then the mask, the LayerNorm VJP and dx; partials of dgamma =
//     sum dxn * xhat and dbeta = sum dxn per 64-row unit.
//   B (K-tile x row split, owns the weights): dW[tile] = dy[:, tile]^T
//     LN(x) and db[tile] = sum dy over its rows.
// Pass B reads LN(x) * mask from pass A rather than recomputing it from
// per-row statistics: each of its K / 128 column tiles would redo the
// LayerNorm of every row and put an element-wise pass between TMA and
// wgmma in every chunk, where the write costs one N x D bf16 store.
//
// bf16 (namespace lnmm16, D in {64, 128, 256}, K a multiple of 64), on
// the wgmma and TMA building blocks of sm90_gmma.cuh, 64-row warpgroups,
// every sum in registers, TMA rings guarded by mbarriers (full: the bytes
// arrived; empty: every warp is done with the stage, and thread 0 then
// loads the stage's next tile):
//   forward (fwd): a block of two warpgroups owns 128 rows and a group of
//     the K / 64 output tiles. TMA brings the block's rows of x into a
//     K-major 128B-swizzled tile; each warpgroup takes the LayerNorm of its
//     64 rows in place (fp32, the mask applied, one bf16 cast; rows past N
//     zero, so a masked row comes out as exactly the bias). TMA streams
//     W[K, D] tiles of 64 rows (already the K-major B operand). The
//     warpgroups take the tiles in turn, each all 128 rows (two m64n64
//     sums), and hand each other the turn to issue products, so that one's
//     epilogue (the bias in fp32, one cast, the tile written to shared
//     memory and stored by TMA) runs while the other's products do. The
//     column groups (fwd_groups) split K while the rows alone leave SMs
//     idle (N = 8128: 64 row blocks x 2).
//   pass A (bwd_rows): NWG warpgroups of 64 rows; TMA brings x (held for
//     the VJP) and per K chunk of 64 a dy tile [rows x 64] (K-major A)
//     and W[k0:k0+64, :] (MN-major B); dxn is an m64nD sum in registers
//     over all of K; the statistics, the mask, the VJP and the dgamma /
//     dbeta partials are taken in the accumulator's own layout (row sums
//     over the four lanes that share a row, column sums by shuffles and
//     one pass through shared memory); dx overwrites x in shared memory
//     and TMA stores it.
//   pass B (bwd_weights): a block of two warpgroups owns 128 K rows of dW
//     (64 each) over a row split; per chunk of 64 rows TMA brings dy[rows,
//     tile] (the transposed, MN-major A) and LN(x) (MN-major B); dW stays
//     in registers (m64nD) over the whole split; db is taken from the
//     staged dy tile, eight columns a thread, while the products run.
//     Splits fill one wave of the card.
// y and dx leave through shared memory and TMA stores, in whole 128-byte
// rows, not in the accumulator's layout (4 bytes a thread, 16 bytes of a
// row apart), which the memory system takes far below its bandwidth.
// fp32 (namespace f32k) keeps the simple kernels: a block of 256 threads
// stages tiles in shared memory and multiplies in plain FMA
// (tile_mma.cuh), so that it stays full fp32.
//
// Plain C interface, bound with ctypes; each launch returns
// cudaGetLastError().

#include "sm90_gmma.cuh"
#include "tile_mma.cuh"

namespace {

using namespace tile;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------- fp32 ---
namespace f32k {

constexpr int kRows = 64;   // rows of a forward or pass-A block
constexpr int kCols = 64;   // W rows a step takes: forward, pass A, pass B
constexpr int kChunk = 64;  // pass B's row chunk
constexpr int kMaxSplits = 64;

// Shared-memory rows take an odd stride so that the FMA tiles' column
// walks hit distinct banks.
__host__ __device__ constexpr int ld(int cols) { return cols + 1; }

// dst[r * ldd + c] = src[(row0 + r) * lds + col0 + c] for r < rows,
// c < cols; rows at or past row_end are zero.
__device__ void stage(const float* __restrict__ src, int lds, int row0,
                      int row_end, int col0, float* dst, int ldd, int rows,
                      int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i % cols, gr = row0 + r;
    dst[r * ldd + c] = gr < row_end ? src[(size_t)gr * lds + col0 + c] : 0.0f;
  }
}

// LN(x) * mask of rows [row0, row0 + rows) into dst (row stride ldd), one
// warp a row. Rows at or past row_end are zero when zero_tail, else left
// alone. With mu/rstd given, stores each row's statistics (0 past
// row_end).
__device__ void ln_rows(const float* __restrict__ x,
                        const float* __restrict__ g,
                        const float* __restrict__ bl,
                        const float* __restrict__ mask, float* dst, int ldd,
                        int row0, int rows, int row_end, int d, float eps,
                        bool zero_tail, float* mu_out, float* rstd_out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int r = warp; r < rows; r += nwarps) {
    const int gr = row0 + r;
    float mu = 0.0f, rstd = 0.0f;
    if (gr < row_end) {
      const float* src = x + (size_t)gr * d;
      float s = 0.0f;
      for (int c = lane; c < d; c += 32) s += src[c];
      mu = warp_sum(s) / d;
      float v = 0.0f;
      for (int c = lane; c < d; c += 32) {
        const float t = src[c] - mu;
        v += t * t;
      }
      rstd = rsqrtf(warp_sum(v) / d + eps);
      const float m = mask != nullptr ? mask[gr] : 1.0f;
      for (int c = lane; c < d; c += 32)
        dst[(size_t)r * ldd + c] = ((src[c] - mu) * rstd * g[c] + bl[c]) * m;
    } else if (zero_tail) {
      for (int c = lane; c < d; c += 32) dst[(size_t)r * ldd + c] = 0.0f;
    }
    if (mu_out != nullptr && lane == 0) {
      mu_out[r] = mu;
      rstd_out[r] = rstd;
    }
  }
}

struct FwdLayout {
  int ldx, ldw, ldc;
  size_t o_w, o_c, bytes;
};

__host__ __device__ inline FwdLayout fwd_layout(int d) {
  FwdLayout L;
  L.ldx = ld(d);
  L.ldw = ld(d);
  L.ldc = kCols + 4;
  size_t o = align128((size_t)kRows * L.ldx * 4);
  L.o_w = o;
  o += align128((size_t)kCols * L.ldw * 4);
  L.o_c = o;
  o += align128((size_t)kRows * L.ldc * 4);
  L.bytes = o;
  return L;
}

__global__ void __launch_bounds__(kThreads)
ln_mm_fwd(const float* __restrict__ x, const float* __restrict__ g,
          const float* __restrict__ bl, const float* __restrict__ w,
          const float* __restrict__ b, const float* __restrict__ mask,
          float* __restrict__ y, int n, int d, int k, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L = fwd_layout(d);
  float* xn = reinterpret_cast<float*>(smem);
  float* ws = reinterpret_cast<float*>(smem + L.o_w);
  float* c = reinterpret_cast<float*>(smem + L.o_c);
  const int row0 = blockIdx.x * kRows;

  ln_rows(x, g, bl, mask, xn, L.ldx, row0, kRows, n, d, eps, true, nullptr,
          nullptr);
  for (int k0 = 0; k0 < k; k0 += kCols) {
    // The barrier after staging also keeps the last step's epilogue from
    // reading c while this step's product overwrites it.
    stage(w, d, k0, k, 0, ws, L.ldw, kCols, d);
    __syncthreads();
    // c[kRows, kCols] = xn[kRows, D] @ W_tile^T (column-major in ws).
    mma_acc<true, false, false>(c, L.ldc, xn, L.ldx, ws, L.ldw, kRows, kCols,
                                d);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, j = i % kCols, gr = row0 + r;
      if (gr < n) y[(size_t)gr * k + k0 + j] = c[r * L.ldc + j] + b[k0 + j];
    }
  }
}

struct ALayout {
  int ldd, ldw, ldc;
  size_t o_w, o_c, o_mu, o_rstd, bytes;
};

__host__ __device__ inline ALayout a_layout(int d) {
  ALayout L;
  L.ldd = ld(kCols);
  L.ldw = ld(d);
  L.ldc = d + 4;
  size_t o = align128((size_t)kRows * L.ldd * 4);
  L.o_w = o;
  o += align128((size_t)kCols * L.ldw * 4);
  L.o_c = o;
  o += align128((size_t)kRows * L.ldc * 4);
  L.o_mu = o;
  o += align128((size_t)kRows * 4);
  L.o_rstd = o;
  o += align128((size_t)kRows * 4);
  L.bytes = o;
  return L;
}

__global__ void __launch_bounds__(kThreads)
ln_mm_bwd_rows(const float* __restrict__ x, const float* __restrict__ dy,
               const float* __restrict__ g, const float* __restrict__ bl,
               const float* __restrict__ w, const float* __restrict__ mask,
               float* __restrict__ dx, float* __restrict__ xn_out,
               float* __restrict__ dgp, float* __restrict__ dblp, int n,
               int d, int k, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ALayout L = a_layout(d);
  float* dyt = reinterpret_cast<float*>(smem);
  float* ws = reinterpret_cast<float*>(smem + L.o_w);
  float* c = reinterpret_cast<float*>(smem + L.o_c);
  float* mu = reinterpret_cast<float*>(smem + L.o_mu);
  float* rstd = reinterpret_cast<float*>(smem + L.o_rstd);
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // LN(x) * mask for pass B, straight to device memory.
  ln_rows(x, g, bl, mask, xn_out + (size_t)row0 * d, d, row0, kRows, n, d,
          eps, false, mu, rstd);
  // c[kRows, D] = dy[rows, :] @ W, K in chunks of kCols.
  for (int k0 = 0; k0 < k; k0 += kCols) {
    stage(dy, k, row0, n, k0, dyt, L.ldd, kRows, kCols);
    stage(w, d, k0, k, 0, ws, L.ldw, kCols, d);
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
    const float* xr = x + (size_t)gr * d;
    float* cr = c + (size_t)r * L.ldc;
    float s1 = 0.0f, s2 = 0.0f;
    for (int col = lane; col < d; col += 32) {
      const float dxn = cr[col] * m;
      cr[col] = dxn;
      const float dxhat = dxn * g[col];
      s1 += dxhat;
      s2 += dxhat * (xr[col] - mu[r]) * rstd[r];
    }
    const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
    for (int col = lane; col < d; col += 32) {
      const float xhat = (xr[col] - mu[r]) * rstd[r];
      dx[(size_t)gr * d + col] =
          rstd[r] * (cr[col] * g[col] - m1 - xhat * m2);
    }
  }
  __syncthreads();
  const size_t part = (size_t)blockIdx.x * d;
  for (int col = threadIdx.x; col < d; col += kThreads) {
    float sg = 0.0f, sb = 0.0f;
    for (int r = 0; r < kRows && row0 + r < n; ++r) {
      const float v = c[(size_t)r * L.ldc + col];
      sg += v * (x[(size_t)(row0 + r) * d + col] - mu[r]) * rstd[r];
      sb += v;
    }
    dgp[part + col] = sg;
    dblp[part + col] = sb;
  }
}

struct BLayout {
  int ldd, ldx, ldc;
  size_t o_x, o_c, o_db, bytes;
};

__host__ __device__ inline BLayout b_layout(int d) {
  BLayout L;
  L.ldd = ld(kCols);
  L.ldx = ld(d);
  L.ldc = d + 4;
  size_t o = align128((size_t)kChunk * L.ldd * 4);
  L.o_x = o;
  o += align128((size_t)kChunk * L.ldx * 4);
  L.o_c = o;
  o += align128((size_t)kCols * L.ldc * 4);
  L.o_db = o;
  o += align128((size_t)kCols * 4);
  L.bytes = o;
  return L;
}

__global__ void __launch_bounds__(kThreads)
ln_mm_bwd_weights(const float* __restrict__ xn_g,
                  const float* __restrict__ dy, float* __restrict__ dwp,
                  float* __restrict__ dbp, int n, int d, int k,
                  int rows_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BLayout L = b_layout(d);
  float* dyt = reinterpret_cast<float*>(smem);
  float* xt = reinterpret_cast<float*>(smem + L.o_x);
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
    stage(dy, k, row0, r_end, k0, dyt, L.ldd, kChunk, kCols);
    stage(xn_g, d, row0, r_end, 0, xt, L.ldx, kChunk, d);
    __syncthreads();
    // c[kCols, D] += dy_chunk^T (column-major in dyt) @ xn_chunk.
    mma_acc<false, true, true>(c, L.ldc, dyt, L.ldd, xt, L.ldx, kCols, d,
                               kChunk);
    for (int j = threadIdx.x; j < kCols; j += kThreads) {
      float s = 0.0f;
      for (int r = 0; r < kChunk; ++r) s += dyt[r * L.ldd + j];
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

bool fits(int d) {
  return fwd_layout(d).bytes <= kMaxSmem && a_layout(d).bytes <= kMaxSmem &&
         b_layout(d).bytes <= kMaxSmem;
}

}  // namespace f32k

// ------------------------------------------------------------ bf16 ---
namespace lnmm16 {

using namespace sm90;

constexpr int kWG = 128;      // threads of a warpgroup
constexpr int TN = 64;        // W rows of a forward tile or a K chunk
constexpr int RC = 64;        // pass B: rows of a chunk
constexpr int kFwdRows = 128; // forward: rows of a block (two warpgroups)
constexpr int kMaxStages = 6;

// Byte offset of element (r, c) in a K-major 128B-swizzled bf16 tile of
// `rows` rows stored as [cols / 64][rows][64], the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B (the region starts on 1024 bytes).
__host__ __device__ __forceinline__ uint32_t swz128(int rows, int r, int c) {
  const int cc = c & 63;
  return (uint32_t)((c >> 6) * rows * 128 + r * 128 +
                    (((cc >> 3) ^ (r & 7)) << 4) + (cc & 7) * 2);
}

__host__ __device__ constexpr int stages_for(long long room, long long stage,
                                             int most) {
  return room / stage > most ? most : (int)(room / stage);
}

// acc (+)= A @ B, both from shared memory (TA / TB = 1: MN-major), N = D.
template <int D, int TA, int TB>
__device__ __forceinline__ void mma_ss_d(float (&acc)[D / 2], uint64_t a,
                                         uint64_t b) {
  if constexpr (D == 64)
    mma_ss_n64<TA, TB>(acc, a, b, 1);
  else if constexpr (D == 128)
    mma_ss_n128<TA, TB>(acc, a, b, 1);
  else
    mma_ss_n256<TA, TB>(acc, a, b, 1);
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.0f;
}

// LN(x) * mask of a warpgroup's 64 rows, tile rows t0 .. t0 + 63 of the
// [D/64][ROWS][64] 128B-swizzled x tile (global rows g0 ..), warp `warp`
// taking 16 of them: D / 8 lanes a row, 8 consecutive columns a lane,
// two-pass statistics in fp32 as the Pallas kernel takes them, the mask
// applied, one bf16 cast. IN_PLACE writes the result over x (rows at or
// past n zero); else it goes to xn_out (rows below n) and x stays, and
// each row's statistics go to mu[r], rstd[r] (r = 0 .. 63).
template <int D, int ROWS, bool IN_PLACE>
__device__ __forceinline__ void ln_rows(unsigned char* xt, int t0, int g0,
                                        int warp, int lane,
                                        const float* __restrict__ g,
                                        const float* __restrict__ bl,
                                        const float* __restrict__ mask,
                                        int n, float eps,
                                        bf* __restrict__ xn_out, float* mu,
                                        float* rstd) {
  constexpr int LPR = D / 8, RPP = 32 / LPR;  // lanes a row, rows a pass
  const int c = (lane % LPR) * 8, sub = lane / LPR;
  float gv[8], bv[8];
#pragma unroll
  for (int j = 0; j < 8; j += 4) {
    const float4 p = *reinterpret_cast<const float4*>(g + c + j);
    const float4 q = *reinterpret_cast<const float4*>(bl + c + j);
    gv[j] = p.x; gv[j + 1] = p.y; gv[j + 2] = p.z; gv[j + 3] = p.w;
    bv[j] = q.x; bv[j + 1] = q.y; bv[j + 2] = q.z; bv[j + 3] = q.w;
  }
  for (int p = 0; p < 16 / RPP; ++p) {
    const int r = 16 * warp + p * RPP + sub, gr = g0 + r;
    uint4* slot = reinterpret_cast<uint4*>(xt + swz128(ROWS, t0 + r, c));
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
    for (int o = LPR / 2; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    const float m = s / D;
    float var = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) var += (v[j] - m) * (v[j] - m);
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
      var += __shfl_xor_sync(0xffffffffu, var, o);
    const float rs = rsqrtf(var / D + eps);
    const bool live = gr < n;
    const float mk = live ? (mask != nullptr ? mask[gr] : 1.0f) : 0.0f;
    uint32_t out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[j] = pack_bf16(((v[2 * j] - m) * rs * gv[2 * j] + bv[2 * j]) * mk,
                         ((v[2 * j + 1] - m) * rs * gv[2 * j + 1] +
                          bv[2 * j + 1]) * mk);
    if constexpr (IN_PLACE) {
      *slot = live ? make_uint4(out[0], out[1], out[2], out[3])
                   : make_uint4(0u, 0u, 0u, 0u);
    } else {
      if (live)
        *reinterpret_cast<uint4*>(xn_out + (size_t)gr * D + c) =
            make_uint4(out[0], out[1], out[2], out[3]);
      if (lane % LPR == 0) {
        mu[r] = m;
        rstd[r] = rs;
      }
    }
  }
}

// ------------------------------------------------------------- forward ---
// Shared memory, byte offsets from a 1024-aligned base: the A tile (x,
// then LN(x) * mask; [D/64][128][64], 128B swizzle); each warpgroup's
// output tile ([128][64] bf16, 128B swizzle), which a TMA store writes
// out; the ring of W tiles ([D/64][64][64] each, 128B swizzle; an even
// number of stages, so that stage s only ever holds tiles of warpgroup
// s % 2 and no warpgroup skips a phase of its barriers), the barriers.
template <int D>
struct Fwd {
  static constexpr uint32_t A = kFwdRows * D * 2;
  static constexpr uint32_t OUT = A;
  static constexpr uint32_t OUT_TILE = kFwdRows * TN * 2;
  static constexpr uint32_t RING = OUT + 2 * OUT_TILE;
  static constexpr uint32_t STAGE = TN * D * 2;
  static constexpr int STAGES =
      stages_for((long long)kMaxSmem - 1024 - 256 - RING, STAGE,
                 kMaxStages) & ~1;
  static constexpr uint32_t FULL = RING + STAGES * STAGE;
  static constexpr uint32_t EMPTY = FULL + 8 * STAGES;
  static constexpr uint32_t XBAR = EMPTY + 8 * STAGES;
  static constexpr uint32_t BYTES = XBAR + 8;
};

constexpr int kTurn = 3;   // named barriers 3, 4: warpgroup 0's, 1's turn

// W tile t of the block's group (W rows (t0 + t) * 64 ..) into stage s.
template <int D>
__device__ __forceinline__ void fwd_load(uint32_t base, const CUtensorMap* w,
                                         int s, int wrow) {
  using L = Fwd<D>;
  const uint32_t st = base + L::RING + s * L::STAGE;
  const uint32_t full = base + L::FULL + 8 * s;
  mbar_expect_tx(full, L::STAGE);
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_2d(st + c * TN * 128, w, full, c * 64, wrow);
}

// The bias in fp32 and one cast, into the output tile: rows r and r + 8
// from acc (registers 4 j, 4 j + 1 and 4 j + 2, 4 j + 3), columns 8 j +
// 2 (lane % 4) + {0, 1}. The swizzle puts the 8 rows a store instruction
// covers on distinct banks.
__device__ __forceinline__ void fwd_stage(const float (&acc)[32],
                                          const float2 (&bias)[8],
                                          unsigned char* out, int r,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(out + swz128(kFwdRows, r, c)) =
        pack_bf16(acc[4 * j] + bias[j].x, acc[4 * j + 1] + bias[j].y);
    *reinterpret_cast<uint32_t*>(out + swz128(kFwdRows, r + 8, c)) =
        pack_bf16(acc[4 * j + 2] + bias[j].x, acc[4 * j + 3] + bias[j].y);
  }
}

// y for the block's 128 rows and its group of `tiles` output tiles
// (starting at tile blockIdx.y * tiles). Warpgroup w takes the tiles i = w
// (mod 2), all 128 rows (two m64n64 sums); the warpgroups take turns at
// issuing their products (named barriers kTurn + w), so that one's
// epilogue runs while the other's products do, and no accumulator is read
// while a product into it may still be in flight. The epilogue writes the
// tile into the warpgroup's output tile and one thread stores it with
// TMA (rows past n are not written).
template <int D>
__global__ void __launch_bounds__(2 * kWG, 1)
fwd(const __grid_constant__ CUtensorMap x_map,
    const __grid_constant__ CUtensorMap w_map,
    const __grid_constant__ CUtensorMap y_map, const float* __restrict__ g,
    const float* __restrict__ bl, const float* __restrict__ b,
    const float* __restrict__ mask, int n, int tiles, float eps) {
  using L = Fwd<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x, row0 = blockIdx.x * kFwdRows;
  const int t0 = blockIdx.y * tiles;
  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(base + L::FULL + 8 * s, 1);
      mbar_init(base + L::EMPTY + 8 * s, 4);
    }
    mbar_init(base + L::XBAR, 1);
    mbar_init_fence();
    // x's box of 128 rows holds a row below n (row0 < n); rows past n
    // read as zeros.
    mbar_expect_tx(base + L::XBAR, L::A);
    for (int c = 0; c < D / 64; ++c)
      tma_load_2d(base + c * kFwdRows * 128, &x_map, base + L::XBAR, c * 64,
                  row0);
    for (int t = 0; t < L::STAGES && t < tiles; ++t)
      fwd_load<D>(base, &w_map, t, (t0 + t) * TN);
  }
  __syncthreads();
  const int wid = warp_uniform(tid / 32);
  const int w = wid / 4, warp = wid % 4, lane = tid % 32, t = tid % kWG;
  mbar_wait(base + L::XBAR, 0);
  ln_rows<D, kFwdRows, true>(smem, 64 * w, row0 + 64 * w, warp, lane, g, bl,
                             mask, n, eps, nullptr, nullptr, nullptr);
  fence_async_smem();
  __syncthreads();   // each warpgroup multiplies all 128 rows

  // Descriptors, both K-major: the A tile (rows 64 .. 127 8 KB further);
  // each stage's W tile. Register r of lo holds row rl + 8 ((r / 2) % 2)
  // and column 8 (r / 4) + 2 (lane % 4) + r % 2 of the tile; hi the same
  // 64 rows further.
  const uint64_t ad0 = desc(base, 16, 1024, kSwizzle128);
  const uint64_t wd0 = desc(base + L::RING, 16, 1024, kSwizzle128);
  const int rl = 16 * warp + lane / 4;
  unsigned char* out = smem + L::OUT + w * L::OUT_TILE;
  float lo[32], hi[32];
  for (int i = w; i < tiles; i += 2) {
    const int s = i % L::STAGES;
    mbar_wait(base + L::FULL + 8 * s, (i / L::STAGES) & 1);
    if (i > 0) named_sync(kTurn + w, 2 * kWG);  // tile i - 1 is issued
    const uint64_t ad = opaque(ad0);
    const uint64_t wd = desc_at(opaque(wd0), s * L::STAGE);
    fence_regs(lo);
    fence_regs(hi);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t ka = (kk >> 2) * kFwdRows * 128 + (kk & 3) * 32;
      const uint64_t wk = desc_at(wd, (kk >> 2) * TN * 128 + (kk & 3) * 32);
      mma_ss_n64<0, 0>(lo, desc_at(ad, ka), wk, kk > 0);
      mma_ss_n64<0, 0>(hi, desc_at(ad, ka + 64 * 128), wk, kk > 0);
    }
    wg_commit();
    if (i + 1 < tiles) named_arrive(kTurn + 1 - w, 2 * kWG);
    const int col0 = (t0 + i) * TN;
    float2 bias[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bias[j] = *reinterpret_cast<const float2*>(b + col0 + 8 * j +
                                                 2 * (lane & 3));
    wg_wait0();
    fence_regs(lo);
    fence_regs(hi);
    if (lane == 0) mbar_arrive(base + L::EMPTY + 8 * s);
    if (t == 0 && i + L::STAGES < tiles) {
      mbar_wait(base + L::EMPTY + 8 * s, (i / L::STAGES) & 1);
      fwd_load<D>(base, &w_map, s, (t0 + i + L::STAGES) * TN);
    }
    // The output tile is free once the store of the warpgroup's last
    // tile has read it.
    if (t == 0) bulk_wait_read<0>();
    named_sync(1 + w, kWG);
    fwd_stage(lo, bias, out, rl, lane);
    fwd_stage(hi, bias, out, rl + 64, lane);
    fence_async_smem();
    named_sync(1 + w, kWG);
    if (t == 0) {
      tma_store_2d(&y_map, smem_u32(out), col0, row0);
      bulk_commit();
    }
  }
  if (t == 0) bulk_wait_read<0>();
}

// -------------------------------------------------------------- pass A ---
// Shared memory: x [D/64][ROWS][64] (128B swizzle, held to the end); the
// ring, each stage dy[rows, k0:k0+64] as [ROWS][64] then W[k0:k0+64, :]
// as [D/64][64][64] (both 128B swizzle); the column partials [NWG][4][2][D]
// fp32; the row statistics; the barriers.
template <int D, int NWG>
struct BwdA {
  static constexpr int ROWS = 64 * NWG;
  static constexpr uint32_t X = ROWS * D * 2;
  static constexpr uint32_t DY = ROWS * TN * 2;
  static constexpr uint32_t STAGE = DY + TN * D * 2;
  static constexpr uint32_t RED = NWG * 4 * 2 * D * 4;
  static constexpr uint32_t TAIL = RED + 2 * ROWS * 4 + 256;
  static constexpr int STAGES =
      stages_for((long long)kMaxSmem - 1024 - X - TAIL, STAGE, 4);
  static constexpr uint32_t RING = X;
  static constexpr uint32_t REDO = RING + STAGES * STAGE;
  static constexpr uint32_t MU = REDO + RED;
  static constexpr uint32_t RSTD = MU + ROWS * 4;
  static constexpr uint32_t FULL = RSTD + ROWS * 4;
  static constexpr uint32_t EMPTY = FULL + 8 * STAGES;
  static constexpr uint32_t XBAR = EMPTY + 8 * STAGES;
  static constexpr uint32_t BYTES = XBAR + 8;
};

// K chunk c (dy columns and W rows c * 64 ..) into stage s.
template <int D, int NWG>
__device__ __forceinline__ void a_load(uint32_t base, const CUtensorMap* dy,
                                       const CUtensorMap* w, int s, int c,
                                       int row0) {
  using L = BwdA<D, NWG>;
  const uint32_t st = base + L::RING + s * L::STAGE;
  const uint32_t full = base + L::FULL + 8 * s;
  mbar_expect_tx(full, L::STAGE);
  tma_load_2d(st, dy, full, c * TN, row0);
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
    tma_load_2d(st + L::DY + cb * TN * 128, w, full, cb * 64, c * TN);
}

// Pass A (row-parallel, owns dx): NWG warpgroups of 64 rows each. Each
// takes its rows' statistics and writes LN(x) * mask for pass B, then sums
// dxn = dy W over the K chunks in registers (m64nD), and ends with the
// mask, the LayerNorm VJP and dx, and the dgamma / dbeta partials of its
// 64-row unit. dx overwrites x in shared memory (each thread's values
// where it read them) and TMA stores the warpgroup's rows.
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * kWG, 1)
bwd_rows(const __grid_constant__ CUtensorMap x_map,
         const __grid_constant__ CUtensorMap dy_map,
         const __grid_constant__ CUtensorMap w_map,
         const __grid_constant__ CUtensorMap dx_map,
         const float* __restrict__ g, const float* __restrict__ bl,
         const float* __restrict__ mask, bf* __restrict__ xn_out,
         float* __restrict__ dgp, float* __restrict__ dblp, int n, int k,
         float eps) {
  using L = BwdA<D, NWG>;
  constexpr int ROWS = L::ROWS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x, row0 = blockIdx.x * ROWS, chunks = k / TN;
  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(base + L::FULL + 8 * s, 1);
      mbar_init(base + L::EMPTY + 8 * s, 4 * NWG);
    }
    mbar_init(base + L::XBAR, 1);
    mbar_init_fence();
    mbar_expect_tx(base + L::XBAR, L::X);
    for (int c = 0; c < D / 64; ++c)
      tma_load_2d(base + c * ROWS * 128, &x_map, base + L::XBAR, c * 64,
                  row0);
    for (int c = 0; c < L::STAGES && c < chunks; ++c)
      a_load<D, NWG>(base, &dy_map, &w_map, c, c, row0);
  }
  __syncthreads();
  const int wid = warp_uniform(tid / 32);
  const int w = wid / 4, warp = wid % 4, lane = tid % 32, t = tid % kWG;
  float* mu = reinterpret_cast<float*>(smem + L::MU) + 64 * w;
  float* rstd = reinterpret_cast<float*>(smem + L::RSTD) + 64 * w;
  mbar_wait(base + L::XBAR, 0);
  ln_rows<D, ROWS, false>(smem, 64 * w, row0 + 64 * w, warp, lane, g, bl,
                          mask, n, eps, xn_out, mu, rstd);

  // dxn = dy W: A the warpgroup's rows of the dy tile (K-major), B the W
  // chunk (MN-major, N = D), both in each stage.
  float acc[D / 2];
  zero(acc);
  const uint64_t yd0 =
      desc(base + L::RING + 64 * w * 128, 16, 1024, kSwizzle128);
  const uint64_t wm0 =
      desc(base + L::RING + L::DY, TN * 128, 1024, kSwizzle128);
  for (int c = 0; c < chunks; ++c) {
    const int s = c % L::STAGES;
    mbar_wait(base + L::FULL + 8 * s, (c / L::STAGES) & 1);
    const uint64_t yd = desc_at(opaque(yd0), s * L::STAGE);
    const uint64_t wm = desc_at(opaque(wm0), s * L::STAGE);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < TN / 16; ++kk)
      mma_ss_d<D, 0, 1>(acc, desc_at(yd, kk * 32), desc_at(wm, kk * 2048));
    wg_commit();
    if (c == 0) continue;
    wg_wait1();
    const int sp = (c - 1) % L::STAGES;
    if (lane == 0) mbar_arrive(base + L::EMPTY + 8 * sp);
    if (tid == 0 && c - 1 + L::STAGES < chunks) {
      mbar_wait(base + L::EMPTY + 8 * sp, ((c - 1) / L::STAGES) & 1);
      a_load<D, NWG>(base, &dy_map, &w_map, sp, c - 1 + L::STAGES, row0);
    }
  }
  wg_wait0();
  fence_regs(acc);
  named_sync(1 + w, kWG);   // the warpgroup's row statistics

  // The VJP in the accumulator's layout: this thread holds rows rl and
  // rl + 8 of the warpgroup, columns 8 j + 2 (lane % 4) + {0, 1}, j < D / 8
  // (registers 4 j .. 4 j + 3: row rl's pair, then row rl + 8's).
  const int rl = 16 * warp + lane / 4, ta = 64 * w + rl, ga = row0 + ta;
  const bool la = ga < n, lb = ga + 8 < n;
  const float ma = la ? (mask != nullptr ? mask[ga] : 1.0f) : 0.0f;
  const float mb = lb ? (mask != nullptr ? mask[ga + 8] : 1.0f) : 0.0f;
  const float mua = mu[rl], rsa = rstd[rl], mub = mu[rl + 8],
              rsb = rstd[rl + 8];
  unsigned char* xt = smem;
  float* red =
      reinterpret_cast<float*>(smem + L::REDO) + (w * 4 + warp) * 2 * D;
  float s1a = 0.0f, s2a = 0.0f, s1b = 0.0f, s2b = 0.0f;
  // Column partials over the warp's 16 rows, two column groups j at a
  // time: v[4 h + e] holds, for group 2 q + h, the dgamma (e = 0, 1) and
  // dbeta (e = 2, 3) terms of columns c + e % 2 summed over this thread's
  // two rows. A transposing butterfly over lane bits 4, 3, 2 (7 shuffles
  // for 8 values) leaves lane l the sum over the 8 lanes of value l / 4.
  const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
  const int mine = lane >> 2;
#pragma unroll
  for (int q = 0; q < D / 16; ++q) {
    float v[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * q + h;
      const int c = 8 * j + 2 * (lane & 3);
      const float2 gv = *reinterpret_cast<const float2*>(g + c);
      const float2 xa = unpack_bf16(
          *reinterpret_cast<const uint32_t*>(xt + swz128(ROWS, ta, c)));
      const float2 xb = unpack_bf16(
          *reinterpret_cast<const uint32_t*>(xt + swz128(ROWS, ta + 8, c)));
      acc[4 * j] *= ma;
      acc[4 * j + 1] *= ma;
      acc[4 * j + 2] *= mb;
      acc[4 * j + 3] *= mb;
      const float ha0 = (xa.x - mua) * rsa, ha1 = (xa.y - mua) * rsa;
      const float hb0 = (xb.x - mub) * rsb, hb1 = (xb.y - mub) * rsb;
      const float da0 = acc[4 * j] * gv.x, da1 = acc[4 * j + 1] * gv.y;
      const float db0 = acc[4 * j + 2] * gv.x, db1 = acc[4 * j + 3] * gv.y;
      s1a += da0 + da1;
      s2a += da0 * ha0 + da1 * ha1;
      s1b += db0 + db1;
      s2b += db0 * hb0 + db1 * hb1;
      v[4 * h] = acc[4 * j] * ha0 + acc[4 * j + 2] * hb0;
      v[4 * h + 1] = acc[4 * j + 1] * ha1 + acc[4 * j + 3] * hb1;
      v[4 * h + 2] = acc[4 * j] + acc[4 * j + 2];
      v[4 * h + 3] = acc[4 * j + 1] + acc[4 * j + 3];
    }
    float u[4], z[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float keep = b4 ? v[4 + i] : v[i], give = b4 ? v[i] : v[4 + i];
      u[i] = keep + __shfl_xor_sync(0xffffffffu, give, 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float keep = b3 ? u[2 + i] : u[i], give = b3 ? u[i] : u[2 + i];
      z[i] = keep + __shfl_xor_sync(0xffffffffu, give, 8);
    }
    const float sum = (b2 ? z[1] : z[0]) +
                      __shfl_xor_sync(0xffffffffu, b2 ? z[0] : z[1], 4);
    // Value `mine`: group 2 q + mine / 4, term mine % 4.
    const int c = 8 * (2 * q + (mine >> 2)) + 2 * (lane & 3) + (mine & 1);
    red[(mine & 2 ? D : 0) + c] = sum;
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    s1a += __shfl_xor_sync(0xffffffffu, s1a, o);
    s2a += __shfl_xor_sync(0xffffffffu, s2a, o);
    s1b += __shfl_xor_sync(0xffffffffu, s1b, o);
    s2b += __shfl_xor_sync(0xffffffffu, s2b, o);
  }
  const float m1a = s1a / D, m2a = s2a / D, m1b = s1b / D, m2b = s2b / D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    const float2 gv = *reinterpret_cast<const float2*>(g + c);
    uint32_t* pa = reinterpret_cast<uint32_t*>(xt + swz128(ROWS, ta, c));
    uint32_t* pb = reinterpret_cast<uint32_t*>(xt + swz128(ROWS, ta + 8, c));
    const float2 xa = unpack_bf16(*pa), xb = unpack_bf16(*pb);
    *pa = pack_bf16(
        rsa * (acc[4 * j] * gv.x - m1a - (xa.x - mua) * rsa * m2a),
        rsa * (acc[4 * j + 1] * gv.y - m1a - (xa.y - mua) * rsa * m2a));
    *pb = pack_bf16(
        rsb * (acc[4 * j + 2] * gv.x - m1b - (xb.x - mub) * rsb * m2b),
        rsb * (acc[4 * j + 3] * gv.y - m1b - (xb.y - mub) * rsb * m2b));
  }
  fence_async_smem();
  named_sync(1 + w, kWG);
  // dx of the warpgroup's rows (none past n is written).
  if (t == 0 && row0 + 64 * w < n) {
    for (int cb = 0; cb < D / 64; ++cb)
      tma_store_2d(&dx_map, base + cb * ROWS * 128 + 64 * w * 128, cb * 64,
                   row0 + 64 * w);
    bulk_commit();
  }
  // The unit's partials: the four warps' column sums in order.
  const float* wred = reinterpret_cast<const float*>(smem + L::REDO) +
                      w * 4 * 2 * D;
  const size_t unit = (size_t)blockIdx.x * NWG + w;
  for (int c = t; c < D; c += kWG) {
    float sg = 0.0f, sb = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sg += wred[q * 2 * D + c];
      sb += wred[q * 2 * D + D + c];
    }
    dgp[unit * D + c] = sg;
    dblp[unit * D + c] = sb;
  }
  if (t == 0) bulk_wait_read<0>();
}

// -------------------------------------------------------------- pass B ---
// Shared memory: the ring, each stage dy[rows, k0:k0+128] as [2][RC][64]
// then LN(x) rows as [D/64][RC][64] (all 128B swizzle); the db partials
// [2][4][64] fp32; the barriers.
template <int D>
struct BwdB {
  static constexpr uint32_t DY = 2 * RC * 128;
  static constexpr uint32_t STAGE = DY + RC * D * 2;
  static constexpr uint32_t RED = 2 * 4 * 64 * 4;
  static constexpr int STAGES =
      stages_for((long long)kMaxSmem - 1024 - RED - 256, STAGE, 4);
  static constexpr uint32_t REDO = STAGES * STAGE;
  static constexpr uint32_t FULL = REDO + RED;
  static constexpr uint32_t EMPTY = FULL + 8 * STAGES;
  static constexpr uint32_t BYTES = EMPTY + 8 * STAGES;
};

// Row chunk at `row` into stage s: dy's two 64-column boxes (the second
// only when the block's second 64 columns exist) and LN(x)'s D / 64.
template <int D>
__device__ __forceinline__ void b_load(uint32_t base, const CUtensorMap* dy,
                                       const CUtensorMap* xn, int s, int k0,
                                       bool two, int row) {
  using L = BwdB<D>;
  const uint32_t st = base + s * L::STAGE;
  const uint32_t full = base + L::FULL + 8 * s;
  mbar_expect_tx(full, (two ? 2 : 1) * RC * 128 + RC * D * 2);
  tma_load_2d(st, dy, full, k0, row);
  if (two) tma_load_2d(st + RC * 128, dy, full, k0 + 64, row);
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
    tma_load_2d(st + L::DY + cb * RC * 128, xn, full, cb * 64, row);
}

// Pass B (owns dW and db): block (128 K rows, row split), warpgroup w
// taking K rows k0 + 64 w ..; dW[rows] += dy[chunk, rows]^T LN(x)[chunk]
// over the split's chunks, in registers, and db from the staged dy. A
// warpgroup whose 64 K rows lie past K (K / 64 odd) computes on a tile no
// load wrote and stores nothing.
template <int D>
__global__ void __launch_bounds__(2 * kWG, 1)
bwd_weights(const __grid_constant__ CUtensorMap dy_map,
            const __grid_constant__ CUtensorMap xn_map,
            float* __restrict__ dwp, float* __restrict__ dbp, int n, int k,
            int rows_per_split) {
  using L = BwdB<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const int k0 = blockIdx.x * 128, split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);
  const int chunks = (r_end - r_begin + RC - 1) / RC;
  const bool two = k0 + 64 < k;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(base + L::FULL + 8 * s, 1);
      mbar_init(base + L::EMPTY + 8 * s, 8);
    }
    mbar_init_fence();
    for (int i = 0; i < L::STAGES && i < chunks; ++i)
      b_load<D>(base, &dy_map, &xn_map, i, k0, two, r_begin + i * RC);
  }
  __syncthreads();
  const int wid = warp_uniform(tid / 32);
  const int w = wid / 4, warp = wid % 4, lane = tid % 32, t = tid % kWG;
  float acc[D / 2];
  zero(acc);
  float dbs[8];
  zero(dbs);
  // A: the warpgroup's dy box, transposed (MN-major, M = its 64 columns);
  // B: the LN(x) rows (MN-major, N = D). A k-step is 16 rows of both.
  const uint64_t ad0 = desc(base + w * RC * 128, RC * 128, 1024, kSwizzle128);
  const uint64_t bd0 = desc(base + L::DY, RC * 128, 1024, kSwizzle128);
  const int jj = t & 7;   // this thread's db columns: 8 jj .. 8 jj + 7
  for (int i = 0; i < chunks; ++i) {
    const int s = i % L::STAGES;
    mbar_wait(base + L::FULL + 8 * s, (i / L::STAGES) & 1);
    const uint64_t ad = desc_at(opaque(ad0), s * L::STAGE);
    const uint64_t bd = desc_at(opaque(bd0), s * L::STAGE);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < RC / 16; ++kk)
      mma_ss_d<D, 1, 1>(acc, desc_at(ad, kk * 2048), desc_at(bd, kk * 2048));
    wg_commit();
    // While the products run: db's column sums of the staged dy tile
    // (rows past N are zeros).
    const unsigned char* dyt = smem + s * L::STAGE + w * RC * 128;
#pragma unroll
    for (int q = 0; q < RC / 16; ++q) {
      const int r = (t >> 3) + 16 * q;
      const uint4 v = *reinterpret_cast<const uint4*>(
          dyt + r * 128 + ((jj ^ (r & 7)) << 4));
      const uint32_t in[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16(in[e]);
        dbs[2 * e] += f.x;
        dbs[2 * e + 1] += f.y;
      }
    }
    if (i == 0) continue;
    wg_wait1();
    const int sp = (i - 1) % L::STAGES;
    if (lane == 0) mbar_arrive(base + L::EMPTY + 8 * sp);
    if (tid == 0 && i - 1 + L::STAGES < chunks) {
      mbar_wait(base + L::EMPTY + 8 * sp, ((i - 1) / L::STAGES) & 1);
      b_load<D>(base, &dy_map, &xn_map, sp, k0, two,
                r_begin + (i - 1 + L::STAGES) * RC);
    }
  }
  wg_wait0();
  fence_regs(acc);

  // The split's partials. acc: rows = the warpgroup's 64 K rows, cols = D.
  const bool mine = w == 0 || two;
  if (mine) {
    float* p = dwp + ((size_t)split * k + k0 + 64 * w) * D;
    const int m = 16 * warp + lane / 4;
#pragma unroll
    for (int r = 0; r < D / 2; r += 2) {
      const int row = m + 8 * ((r >> 1) & 1);
      const int c = 8 * (r >> 2) + 2 * (lane & 3);
      *reinterpret_cast<float2*>(p + (size_t)row * D + c) =
          make_float2(acc[r], acc[r + 1]);
    }
  }
  // db: the 16 threads of each column group, then the four warps, in
  // order.
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    dbs[e] += __shfl_xor_sync(0xffffffffu, dbs[e], 8);
    dbs[e] += __shfl_xor_sync(0xffffffffu, dbs[e], 16);
  }
  float* red = reinterpret_cast<float*>(smem + L::REDO) + w * 4 * 64;
  if (lane < 8) {
#pragma unroll
    for (int e = 0; e < 8; ++e) red[warp * 64 + 8 * lane + e] = dbs[e];
  }
  named_sync(1 + w, kWG);
  if (mine && t < 64)
    dbp[(size_t)split * k + k0 + 64 * w + t] =
        red[t] + red[64 + t] + red[128 + t] + red[192 + t];
}

// out[j] = sum over s < s_count of part[s * m + j], s in order, four
// columns a thread (m a multiple of 4), each thread's loads in flight
// together: the bf16 backward's sums of its row splits' partials, a few
// dozen rows of K x D floats.
__global__ void sum_splits(const float4* __restrict__ part,
                           float4* __restrict__ out, int s_count, int m4) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m4) return;
  float4 acc = part[j];
#pragma unroll 4
  for (int s = 1; s < s_count; ++s) {
    const float4 v = part[(size_t)s * m4 + j];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  out[j] = acc;
}

inline cudaError_t sum4(const float* part, float* out, int s_count, int m,
                        cudaStream_t st) {
  const int m4 = m / 4;
  sum_splits<<<(m4 + 255) / 256, 256, 0, st>>>(
      reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(out),
      s_count, m4);
  return cudaGetLastError();
}

}  // namespace lnmm16

// ---------------------------------------------------------------- host ---
bool bf16_width(int d) { return d == 64 || d == 128 || d == 256; }

int sm_count() {
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

// The bf16 forward's column groups: a divisor G of the K / 64 output tiles
// such that ceil(row blocks x G / SMs) waves of (tiles / G + 2) tile-times
// (the 2 for x's load and the LayerNorm) is least, the smallest G on a
// tie. N = 8128, K = 768: 64 row blocks x 2 groups of 6 tiles; N = 32512:
// 254 blocks, each the whole of K. fwd_force > 0 forces G where it
// divides the tiles (ln_matmul_fwd_schedule, for timing the schedules).
int fwd_force = -1;

int fwd_groups(int n, int k) {
  const int tiles = k / lnmm16::TN;
  if (fwd_force > 0 && tiles % fwd_force == 0) return fwd_force;
  const long long blocks = (n + lnmm16::kFwdRows - 1) / lnmm16::kFwdRows;
  const int sms = sm_count();
  int best = 1;
  long long best_cost = -1;
  for (int gr = 1; gr <= tiles; ++gr) {
    if (tiles % gr) continue;
    const long long cost =
        (blocks * gr + sms - 1) / sms * (tiles / gr + 2);
    if (best_cost < 0 || cost < best_cost) {
      best = gr;
      best_cost = cost;
    }
  }
  return best;
}

// The bf16 backward's schedule. Pass A: two 64-row warpgroups a block
// while that still gives a block to every SM, else one (N = 8448 fills
// 132 SMs only with 64-row blocks). Pass B: ceil(K / 128) tiles times as
// many row splits as fill one wave of one block an SM, each split a whole
// number of RC-row chunks; every split holds at least one row.
struct Plan16 {
  int nwg, units, rows_per_split, splits;
};

Plan16 plan16(int n, int k) {
  Plan16 p;
  const int sms = sm_count();
  p.nwg = (n + 127) / 128 >= sms ? 2 : 1;
  const int rows = 64 * p.nwg;
  p.units = (n + rows - 1) / rows * p.nwg;
  const int tiles = (k + 127) / 128;
  const int chunks = (n + lnmm16::RC - 1) / lnmm16::RC;
  int s = sms / tiles;
  if (s > chunks) s = chunks;
  if (s < 1) s = 1;
  p.rows_per_split = (chunks + s - 1) / s * lnmm16::RC;
  p.splits = (n + p.rows_per_split - 1) / p.rows_per_split;
  return p;
}

// fp32 pass B's grid: K / kCols tiles x S row splits, each split a whole
// number of kChunk-row chunks, none empty. A block's time is about
// proportional to its rows, so the run takes about ceil(tiles * S / slots)
// waves of N / S rows each (slots: the blocks the card holds at once); S
// is the smallest that minimises that.
cudaError_t f32_splits(int n, int d, int k, int* splits,
                       int* rows_per_split) {
  using namespace f32k;
  auto kb = ln_mm_bwd_weights;
  const size_t bytes = b_layout(d).bytes;
  cudaError_t e = set_smem(kb, bytes);
  int per_sm = 1;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kb, kThreads,
                                                      bytes);
  if (e != cudaSuccess) return e;
  const int slots = sm_count() * (per_sm > 0 ? per_sm : 1);
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

int launch_fwd_f32(const float* x, const float* g, const float* bl,
                   const float* w, const float* b, const float* mask,
                   float* y, int n, int d, int k, float eps,
                   cudaStream_t s) {
  if (!f32k::fits(d)) return (int)cudaErrorInvalidValue;
  auto kernel = f32k::ln_mm_fwd;
  const size_t bytes = f32k::fwd_layout(d).bytes;
  cudaError_t e;
  if ((e = set_smem(kernel, bytes)) != cudaSuccess) return (int)e;
  kernel<<<(n + f32k::kRows - 1) / f32k::kRows, kThreads, bytes, s>>>(
      x, g, bl, w, b, mask, y, n, d, k, eps);
  return (int)cudaGetLastError();
}

using sm90::tensor_map;

template <int D>
int launch_fwd_bf16(const bf* x, const float* g, const float* bl,
                    const bf* w, const float* b, const float* mask, bf* y,
                    int n, int k, float eps, cudaStream_t s) {
  const int groups = fwd_groups(n, k);
  const CUtensorMapSwizzle sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap xm, wm, ym;
  if (!tensor_map(&xm, x, n, D, lnmm16::kFwdRows, 64, sw128) ||
      !tensor_map(&wm, w, k, D, lnmm16::TN, 64, sw128) ||
      !tensor_map(&ym, y, n, k, lnmm16::kFwdRows, lnmm16::TN, sw128))
    return (int)cudaErrorInvalidValue;
  auto kernel = lnmm16::fwd<D>;
  const size_t bytes = lnmm16::Fwd<D>::BYTES + 1024;
  cudaError_t e;
  if ((e = set_smem(kernel, bytes)) != cudaSuccess) return (int)e;
  const dim3 grid((n + lnmm16::kFwdRows - 1) / lnmm16::kFwdRows, groups);
  kernel<<<grid, 2 * lnmm16::kWG, bytes, s>>>(
      xm, wm, ym, g, bl, b, mask, n, k / lnmm16::TN / groups, eps);
  return (int)cudaGetLastError();
}

long long workspace(int dtype, int n, int d, int k) {
  if (dtype == 1) {
    if (!bf16_width(d) || k % lnmm16::TN) return 0;
    const Plan16 p = plan16(n, k);
    return 2LL * p.units * d + (long long)p.splits * ((long long)k * d + k);
  }
  int splits = 0, rows = 0;
  if (!f32k::fits(d)) return 0;
  if (f32_splits(n, d, k, &splits, &rows) != cudaSuccess) return -1;
  const long long blocks = (n + f32k::kRows - 1) / f32k::kRows;
  return 2 * blocks * d + (long long)splits * ((long long)k * d + k);
}

// The cross-block sums, each in a fixed order.
int sum_all(const float* dgp, const float* dblp, const float* dwp,
            const float* dbp, float* dg, float* dbl, float* dw, float* db,
            int units, int splits, int d, int k, cudaStream_t s) {
  cudaError_t e;
  if ((e = sum_into(dgp, dg, 1, units, d, s)) != cudaSuccess) return (int)e;
  if ((e = sum_into(dblp, dbl, 1, units, d, s)) != cudaSuccess) return (int)e;
  if ((e = sum_into(dwp, dw, 1, splits, k * d, s)) != cudaSuccess)
    return (int)e;
  return (int)sum_into(dbp, db, 1, splits, k, s);
}

int launch_bwd_f32(const float* x, const float* dy, const float* g,
                   const float* bl, const float* w, const float* mask,
                   float* dx, float* dg, float* dbl, float* dw, float* db,
                   float* ws, float* xn, int n, int d, int k, float eps,
                   cudaStream_t s) {
  using namespace f32k;
  int splits = 0, rows_per_split = 0;
  cudaError_t e;
  if (!fits(d)) return (int)cudaErrorInvalidValue;
  if ((e = f32_splits(n, d, k, &splits, &rows_per_split)) != cudaSuccess)
    return (int)e;
  const int blocks = (n + kRows - 1) / kRows;
  float* dgp = ws;
  float* dblp = dgp + (size_t)blocks * d;
  float* dwp = dblp + (size_t)blocks * d;
  float* dbp = dwp + (size_t)splits * k * d;
  auto ka = ln_mm_bwd_rows;
  const size_t a_bytes = a_layout(d).bytes;
  if ((e = set_smem(ka, a_bytes)) != cudaSuccess) return (int)e;
  ka<<<blocks, kThreads, a_bytes, s>>>(x, dy, g, bl, w, mask, dx, xn, dgp,
                                       dblp, n, d, k, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // f32_splits set pass B's shared-memory attribute.
  ln_mm_bwd_weights<<<dim3(k / kCols, splits), kThreads,
                      b_layout(d).bytes, s>>>(xn, dy, dwp, dbp, n, d, k,
                                              rows_per_split);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return sum_all(dgp, dblp, dwp, dbp, dg, dbl, dw, db, blocks, splits, d, k,
                 s);
}

template <int D>
int launch_bwd_bf16(const bf* x, const bf* dy, const float* g,
                    const float* bl, const bf* w, const float* mask, bf* dx,
                    float* dg, float* dbl, float* dw, float* db, float* ws,
                    bf* xn, int n, int k, float eps, cudaStream_t s) {
  const Plan16 p = plan16(n, k);
  float* dgp = ws;
  float* dblp = dgp + (size_t)p.units * D;
  float* dwp = dblp + (size_t)p.units * D;
  float* dbp = dwp + (size_t)p.splits * k * D;
  const int rows = 64 * p.nwg;
  const CUtensorMapSwizzle sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap xa, dya, wa, dxa, dyb, xnb;
  if (!tensor_map(&xa, x, n, D, rows, 64, sw128) ||
      !tensor_map(&dxa, dx, n, D, 64, 64, sw128) ||
      !tensor_map(&dya, dy, n, k, rows, lnmm16::TN, sw128) ||
      !tensor_map(&wa, w, k, D, lnmm16::TN, 64, sw128) ||
      !tensor_map(&dyb, dy, n, k, lnmm16::RC, 64, sw128) ||
      !tensor_map(&xnb, xn, n, D, lnmm16::RC, 64, sw128))
    return (int)cudaErrorInvalidValue;
  auto ka = p.nwg == 2 ? lnmm16::bwd_rows<D, 2> : lnmm16::bwd_rows<D, 1>;
  const size_t a_bytes = (p.nwg == 2 ? lnmm16::BwdA<D, 2>::BYTES
                                     : lnmm16::BwdA<D, 1>::BYTES) + 1024;
  auto kb = lnmm16::bwd_weights<D>;
  const size_t b_bytes = lnmm16::BwdB<D>::BYTES + 1024;
  cudaError_t e;
  if ((e = set_smem(ka, a_bytes)) != cudaSuccess) return (int)e;
  if ((e = set_smem(kb, b_bytes)) != cudaSuccess) return (int)e;
  ka<<<p.units / p.nwg, p.nwg * lnmm16::kWG, a_bytes, s>>>(
      xa, dya, wa, dxa, g, bl, mask, xn, dgp, dblp, n, k, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  kb<<<dim3((k + 127) / 128, p.splits), 2 * lnmm16::kWG, b_bytes, s>>>(
      dyb, xnb, dwp, dbp, n, k, p.rows_per_split);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // The units' partials: hundreds of rows of D columns (tile's sums, eight
  // threads a column); the splits': a few dozen rows of K x D (four columns
  // a thread).
  if ((e = sum_into(dgp, dg, 1, p.units, D, s)) != cudaSuccess) return (int)e;
  if ((e = sum_into(dblp, dbl, 1, p.units, D, s)) != cudaSuccess)
    return (int)e;
  if ((e = lnmm16::sum4(dwp, dw, p.splits, k * D, s)) != cudaSuccess)
    return (int)e;
  return (int)lnmm16::sum4(dbp, db, p.splits, k, s);
}

}  // namespace

extern "C" {

// The bf16 forward's column groups: -1 chooses from N and K, g > 0 forces
// g groups where g divides K / 64. Returns the groups this N and K get
// under the setting.
int ln_matmul_fwd_schedule(int force, int n, int k) {
  fwd_force = force;
  return fwd_groups(n, k);
}

// dtype 0 = fp32, 1 = bf16. Shape and alignment checks are the caller's
// (ops/ln_matmul.py): D a multiple of 16 (bf16: 64, 128 or 256), K of 64.
// mask is [N] fp32 or null. Returns a cudaError_t code; 0 is success.
int ln_matmul_fwd(int dtype, const void* x, const void* g, const void* bl,
                  const void* w, const void* b, const void* mask, void* y,
                  int n, int d, int k, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* blf = static_cast<const float*>(bl);
  const float* bf_ = static_cast<const float*>(b);
  const float* mf = static_cast<const float*>(mask);
  if (dtype == 0)
    return launch_fwd_f32(static_cast<const float*>(x), gf, blf,
                          static_cast<const float*>(w), bf_, mf,
                          static_cast<float*>(y), n, d, k, eps, s);
  if (!bf16_width(d) || k % lnmm16::TN) return (int)cudaErrorInvalidValue;
  auto run = d == 64 ? launch_fwd_bf16<64>
             : d == 128 ? launch_fwd_bf16<128> : launch_fwd_bf16<256>;
  return run(static_cast<const bf*>(x), gf, blf, static_cast<const bf*>(w),
             bf_, mf, static_cast<bf*>(y), n, k, eps, s);
}

// fp32 workspace the backward needs (floats); 0 when the kernels do not
// take this width, -1 on a CUDA error.
long long ln_matmul_bwd_workspace(int dtype, int n, int d, int k) {
  return workspace(dtype, n, d, k);
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
  const float* gf = static_cast<const float*>(g);
  const float* blf = static_cast<const float*>(bl);
  const float* mf = static_cast<const float*>(mask);
  if (dtype == 0)
    return launch_bwd_f32(static_cast<const float*>(x),
                          static_cast<const float*>(dy), gf, blf,
                          static_cast<const float*>(w), mf,
                          static_cast<float*>(dx), dg, dbl, dw, db, ws,
                          static_cast<float*>(xn_buf), n, d, k, eps, s);
  if (workspace(1, n, d, k) == 0) return (int)cudaErrorInvalidValue;
  auto run = d == 64 ? launch_bwd_bf16<64>
             : d == 128 ? launch_bwd_bf16<128> : launch_bwd_bf16<256>;
  return run(static_cast<const bf*>(x), static_cast<const bf*>(dy), gf, blf,
             static_cast<const bf*>(w), mf, static_cast<bf*>(dx), dg, dbl, dw,
             db, ws, static_cast<bf*>(xn_buf), n, k, eps, s);
}

}  // extern "C"
