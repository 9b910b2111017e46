// Two stacked LSTM layers over a whole label sequence for Hopper (sm_90a),
// forward and backward, with the inter-layer dropout (K4).
//
// Replaces wenet_celoss_tpu/ops/lstm_pallas.py::_lstm2_fwd_kernel and
// ::_lstm2_bwd_kernel (lstm2_seq and its custom VJP). From a zero state,
// with gate order i, f, g, o and the layer-1 input projection hoisted out
// (xw1 = x @ Wi1^T + bh1, computed by the caller):
//
//   z1 = xw1[t] + h1 @ Wh1^T            c1 = s(f1) c1 + s(i1) tanh(g1)
//   h1 = s(o1) tanh(c1)                 d  = T(drop(h1))
//   z2 = bh2 + d @ Wi2^T + h2 @ Wh2^T   (c2, h2 likewise)    y[t] = T(h2)
//
// h is carried in the compute type T, c and the gates in fp32, the GEMMs
// take T operands and accumulate in fp32 (the Pallas kernel's rounding
// points). Weights arrive in torch.nn.Linear layout [4H, H].
//
// Dropout: a mask bit is a pure function of (key, (t*B + b)*H + j) (stream
// 3 of ops/dropout.py), so forward, backward and the plain version draw
// the same mask whatever the batch blocking.
//
// What bounds it: 3 GEMMs of [B, H] x [H, 4H] per step forward and 3 more
// backward (plus the weight gradients), O(B*U*4H + 3*4H*H) bytes: tiny at
// the flagship shape (ops/bounds.py); the U sequential steps set the pace.
//
// Design, simple first. The TPU holds the weights in VMEM; here the three
// [4H, H] matrices (1.5 MB in bf16 at H = 256) exceed a block's shared
// memory, so each step streams them from L2 straight into WMMA fragments.
// A block owns RB = 16 batch rows for all steps, with its states in shared
// memory; rows are independent, so no grid-wide sync is needed (most SMs
// idle at B = 256: splitting the 4H columns over a cluster is later work).
// The forward, when a backward will follow, saves every step's gate
// pre-activations and cell states in fp32 and the carried h and the
// dropped d in T, in device memory (the TPU recomputes them into bf16
// VMEM scratch, which costs accuracy; nothing is recomputed here).
// Backward: a recurrence kernel per block of rows runs the adjoint in
// reverse, writes dxw1 = T(dz1) and T(dz2) for every step and per-block
// partials of dbh2; a weight pass then forms dWh1 = sum T(dz1)^T h1[t-1],
// dWi2 = sum T(dz2)^T d[t], dWh2 = sum T(dz2)^T h2[t-1] over all (b, t) in
// row splits, and a fixed-order sum adds the partials (deterministic, no
// atomics). bf16 runs the GEMMs on the tensor cores (WMMA); fp32 runs
// plain FMA (tile_mma.cuh).
//
// Plain C interface, bound with ctypes; each entry point returns
// cudaGetLastError().

#include "tile_mma.cuh"

namespace {

using namespace tile;

constexpr int kRB = 16;   // batch rows a recurrence block owns
constexpr int kMT = 64;   // 4H rows of a weight-pass block
constexpr int kKC = 64;   // (b, t) rows a weight-pass block stages at once

template <typename T> __host__ __device__ constexpr int pad() {
  return 16 / (int)sizeof(T);
}

struct Gates {
  float i, f, g, o;
};

__device__ __forceinline__ Gates gates(float zi, float zf, float zg,
                                       float zo) {
  Gates q;
  q.i = sigmoidf_(zi);
  q.f = sigmoidf_(zf);
  q.g = tanhf(zg);
  q.o = sigmoidf_(zo);
  return q;
}

// ------------------------------------------------------------ forward ---
struct FwdLayout {
  int ldz, ldh;
  size_t o_h1, o_h2, o_d, o_c1, o_c2, bytes;
};

template <typename T>
__host__ __device__ inline FwdLayout fwd_layout(int h) {
  FwdLayout L;
  L.ldz = 4 * h + 4;
  L.ldh = h + pad<T>();
  size_t o = align128((size_t)kRB * L.ldz * 4);
  L.o_h1 = o;
  o += align128((size_t)kRB * L.ldh * sizeof(T));
  L.o_h2 = o;
  o += align128((size_t)kRB * L.ldh * sizeof(T));
  L.o_d = o;
  o += align128((size_t)kRB * L.ldh * sizeof(T));
  L.o_c1 = o;
  o += align128((size_t)kRB * h * 4);
  L.o_c2 = o;
  o += align128((size_t)kRB * h * 4);
  L.bytes = o;
  return L;
}

// zs [2, B, U, 4H] and cs [2, B, U, H] fp32, hs [2, B, U+1, H] (slot 0
// zero) and ds [B, U, H] in T: the states the backward reads; all null when
// no backward follows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm2_fwd(const T* __restrict__ xw1, const T* __restrict__ wh1,
          const T* __restrict__ wi2, const float* __restrict__ bh2,
          const T* __restrict__ wh2, T* __restrict__ y, float* __restrict__ zs,
          float* __restrict__ cs, T* __restrict__ hs, T* __restrict__ ds,
          int b_count, int u_count, int h, Drop dp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L = fwd_layout<T>(h);
  const int g4 = 4 * h;
  float* z = reinterpret_cast<float*>(smem);
  T* h1 = reinterpret_cast<T*>(smem + L.o_h1);
  T* h2 = reinterpret_cast<T*>(smem + L.o_h2);
  T* d = reinterpret_cast<T*>(smem + L.o_d);
  float* c1 = reinterpret_cast<float*>(smem + L.o_c1);
  float* c2 = reinterpret_cast<float*>(smem + L.o_c2);
  const int b0 = blockIdx.x * kRB;
  const bool save = zs != nullptr;
  const size_t zplane = (size_t)b_count * u_count * g4;
  const size_t cplane = (size_t)b_count * u_count * h;
  const size_t hplane = (size_t)b_count * (u_count + 1) * h;
  for (int i = threadIdx.x; i < kRB * h; i += kThreads) {
    const int r = i / h, j = i % h, b = b0 + r;
    h1[r * L.ldh + j] = h2[r * L.ldh + j] = d[r * L.ldh + j] =
        from_f<T>(0.0f);
    c1[i] = c2[i] = 0.0f;
    if (save && b < b_count) {
      hs[(size_t)b * (u_count + 1) * h + j] = from_f<T>(0.0f);
      hs[hplane + (size_t)b * (u_count + 1) * h + j] = from_f<T>(0.0f);
    }
  }
  for (int i = threadIdx.x; i < kRB * g4; i += kThreads) {
    const int r = i / g4, g = i % g4, b = b0 + r;
    z[r * L.ldz + g] =
        b < b_count ? to_f(xw1[(size_t)b * u_count * g4 + g]) : 0.0f;
  }
  for (int t = 0; t < u_count; ++t) {
    __syncthreads();
    mma_acc<true, false>(z, L.ldz, h1, L.ldh, wh1, h, kRB, g4, h);
    __syncthreads();
    for (int i = threadIdx.x; i < kRB * h; i += kThreads) {
      const int r = i / h, j = i % h, b = b0 + r;
      float* zr = z + r * L.ldz;
      if (b < b_count) {
        const size_t bt = (size_t)b * u_count + t;
        if (save)
          for (int k = 0; k < 4; ++k) zs[bt * g4 + k * h + j] = zr[k * h + j];
        const Gates q = gates(zr[j], zr[h + j], zr[2 * h + j], zr[3 * h + j]);
        const float c = q.f * c1[i] + q.i * q.g;
        const float hn = q.o * tanhf(c);
        c1[i] = c;
        h1[r * L.ldh + j] = from_f<T>(hn);
        const T dv = from_f<T>(
            drop(dp, ((uint32_t)t * b_count + b) * (uint32_t)h + j, hn));
        d[r * L.ldh + j] = dv;
        if (save) {
          cs[bt * h + j] = c;
          hs[((size_t)b * (u_count + 1) + t + 1) * h + j] = from_f<T>(hn);
          ds[bt * h + j] = dv;
        }
      }
      for (int k = 0; k < 4; ++k) zr[k * h + j] = bh2[k * h + j];
    }
    __syncthreads();
    mma_acc<true, false>(z, L.ldz, d, L.ldh, wi2, h, kRB, g4, h);
    mma_acc<true, false>(z, L.ldz, h2, L.ldh, wh2, h, kRB, g4, h);
    __syncthreads();
    for (int i = threadIdx.x; i < kRB * h; i += kThreads) {
      const int r = i / h, j = i % h, b = b0 + r;
      float* zr = z + r * L.ldz;
      if (b < b_count) {
        const size_t bt = (size_t)b * u_count + t;
        if (save)
          for (int k = 0; k < 4; ++k)
            zs[zplane + bt * g4 + k * h + j] = zr[k * h + j];
        const Gates q = gates(zr[j], zr[h + j], zr[2 * h + j], zr[3 * h + j]);
        const float c = q.f * c2[i] + q.i * q.g;
        const T hn = from_f<T>(q.o * tanhf(c));
        c2[i] = c;
        h2[r * L.ldh + j] = hn;
        y[bt * h + j] = hn;
        if (save) {
          cs[cplane + bt * h + j] = c;
          hs[hplane + ((size_t)b * (u_count + 1) + t + 1) * h + j] = hn;
        }
      }
      for (int k = 0; k < 4; ++k)
        zr[k * h + j] = (b < b_count && t + 1 < u_count)
                            ? to_f(xw1[((size_t)b * u_count + t + 1) * g4 +
                                       k * h + j])
                            : 0.0f;
    }
  }
}

// ---------------------------------------------------- backward, steps ---
struct BwdLayout {
  int ldz, ldzc, ldq;
  size_t o_zc, o_dh1, o_dc1, o_dh2, o_dc2, o_gd, o_db, bytes;
};

template <typename T>
__host__ __device__ inline BwdLayout bwd_layout(int h) {
  BwdLayout L;
  L.ldz = 4 * h + 4;
  L.ldzc = 4 * h + pad<T>();
  L.ldq = h + 4;
  const size_t q = align128((size_t)kRB * L.ldq * 4);
  size_t o = align128((size_t)kRB * L.ldz * 4);
  L.o_zc = o;
  o += align128((size_t)kRB * L.ldzc * sizeof(T));
  L.o_dh1 = o;
  o += q;
  L.o_dc1 = o;
  o += q;
  L.o_dh2 = o;
  o += q;
  L.o_dc2 = o;
  o += q;
  L.o_gd = o;
  o += q;
  L.o_db = o;
  o += align128((size_t)4 * h * 4);
  L.bytes = o;
  return L;
}

// dy [B, U, H] in T; writes dxw1 = T(dz1) and dz2c = T(dz2) [B, U, 4H]
// and this block's column sums of dz2 (fp32) into dbh2_part[block].
template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm2_bwd_steps(const T* __restrict__ dy, const T* __restrict__ wh1,
                const T* __restrict__ wi2, const T* __restrict__ wh2,
                const float* __restrict__ zs, const float* __restrict__ cs,
                T* __restrict__ dxw1, T* __restrict__ dz2c,
                float* __restrict__ dbh2_part, int b_count, int u_count,
                int h, Drop dp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout L = bwd_layout<T>(h);
  const int g4 = 4 * h;
  float* dz = reinterpret_cast<float*>(smem);
  T* zc = reinterpret_cast<T*>(smem + L.o_zc);
  float* dh1 = reinterpret_cast<float*>(smem + L.o_dh1);
  float* dc1 = reinterpret_cast<float*>(smem + L.o_dc1);
  float* dh2 = reinterpret_cast<float*>(smem + L.o_dh2);
  float* dc2 = reinterpret_cast<float*>(smem + L.o_dc2);
  float* gd = reinterpret_cast<float*>(smem + L.o_gd);
  float* db = reinterpret_cast<float*>(smem + L.o_db);
  const int b0 = blockIdx.x * kRB;
  const size_t zplane = (size_t)b_count * u_count * g4;
  const size_t cplane = (size_t)b_count * u_count * h;
  for (int i = threadIdx.x; i < kRB * h; i += kThreads) {
    const int q = (i / h) * L.ldq + i % h;
    dh1[q] = dc1[q] = dh2[q] = dc2[q] = gd[q] = 0.0f;
  }
  for (int g = threadIdx.x; g < g4; g += kThreads) db[g] = 0.0f;
  for (int t = u_count - 1; t >= 0; --t) {
    __syncthreads();
    // Layer 2's adjoint; dh2 is read and cleared for the next product.
    for (int i = threadIdx.x; i < kRB * h; i += kThreads) {
      const int r = i / h, j = i % h, b = b0 + r, q = r * L.ldq + j;
      float dzv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const size_t bt = (size_t)b * u_count + t;
      if (b < b_count) {
        const float* zr = zs + zplane + bt * g4;
        const Gates s = gates(zr[j], zr[h + j], zr[2 * h + j], zr[3 * h + j]);
        const float ct = cs[cplane + bt * h + j];
        const float cp = t > 0 ? cs[cplane + (bt - 1) * h + j] : 0.0f;
        const float dht = to_f(dy[bt * h + j]) + dh2[q];
        const float tc = tanhf(ct);
        const float dct = dc2[q] + dht * s.o * (1.0f - tc * tc);
        dzv[0] = dct * s.g * s.i * (1.0f - s.i);
        dzv[1] = dct * cp * s.f * (1.0f - s.f);
        dzv[2] = dct * s.i * (1.0f - s.g * s.g);
        dzv[3] = dht * tc * s.o * (1.0f - s.o);
        dc2[q] = dct * s.f;
      }
      dh2[q] = 0.0f;
      for (int k = 0; k < 4; ++k) {
        const T c = from_f<T>(dzv[k]);
        dz[r * L.ldz + k * h + j] = dzv[k];
        zc[r * L.ldzc + k * h + j] = c;
        if (b < b_count) dz2c[bt * g4 + k * h + j] = c;
      }
    }
    __syncthreads();
    for (int g = threadIdx.x; g < g4; g += kThreads) {
      float s = db[g];
      for (int r = 0; r < kRB; ++r) s += dz[r * L.ldz + g];
      db[g] = s;
    }
    mma_acc<true, true>(dh2, L.ldq, zc, L.ldzc, wh2, h, kRB, h, g4);
    mma_acc<true, true>(gd, L.ldq, zc, L.ldzc, wi2, h, kRB, h, g4);
    __syncthreads();
    // Layer 1's adjoint; gd and dh1 are read and cleared.
    for (int i = threadIdx.x; i < kRB * h; i += kThreads) {
      const int r = i / h, j = i % h, b = b0 + r, q = r * L.ldq + j;
      float dzv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const size_t bt = (size_t)b * u_count + t;
      if (b < b_count) {
        const float* zr = zs + bt * g4;
        const Gates s = gates(zr[j], zr[h + j], zr[2 * h + j], zr[3 * h + j]);
        const float ct = cs[bt * h + j];
        const float cp = t > 0 ? cs[(bt - 1) * h + j] : 0.0f;
        const float dht =
            drop(dp, ((uint32_t)t * b_count + b) * (uint32_t)h + j, gd[q]) +
            dh1[q];
        const float tc = tanhf(ct);
        const float dct = dc1[q] + dht * s.o * (1.0f - tc * tc);
        dzv[0] = dct * s.g * s.i * (1.0f - s.i);
        dzv[1] = dct * cp * s.f * (1.0f - s.f);
        dzv[2] = dct * s.i * (1.0f - s.g * s.g);
        dzv[3] = dht * tc * s.o * (1.0f - s.o);
        dc1[q] = dct * s.f;
      }
      gd[q] = dh1[q] = 0.0f;
      for (int k = 0; k < 4; ++k) {
        const T c = from_f<T>(dzv[k]);
        zc[r * L.ldzc + k * h + j] = c;
        if (b < b_count) dxw1[bt * g4 + k * h + j] = c;
      }
    }
    __syncthreads();
    mma_acc<true, true>(dh1, L.ldq, zc, L.ldzc, wh1, h, kRB, h, g4);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < g4; g += kThreads)
    dbh2_part[(size_t)blockIdx.x * g4 + g] = db[g];
}

// ---------------------------------------------- backward, weight pass ---
struct WLayout {
  int lda, ldb, ldc;
  size_t o_a, o_b, bytes;
};

template <typename T>
__host__ __device__ inline WLayout w_layout(int h) {
  WLayout L;
  L.ldc = h + 4;
  L.lda = kMT + pad<T>();
  L.ldb = h + pad<T>();
  size_t o = align128((size_t)kMT * L.ldc * 4);
  L.o_a = o;
  o += align128((size_t)kKC * L.lda * sizeof(T));
  L.o_b = o;
  o += align128((size_t)kKC * L.ldb * sizeof(T));
  L.bytes = o;
  return L;
}

// Block (m-tile, gradient x, split s): part[s][x][m0:m0+kMT][:] = sum over
// its rows n = b*U + t of dz_x[n][m0:m0+kMT]^T a_x[n] with
//   x = 0: dz = dxw1, a = h1[t-1];  x = 1: dz = dz2c, a = d[t];
//   x = 2: dz = dz2c, a = h2[t-1]   (h[-1] = 0: hs slot 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm2_bwd_weights(const T* __restrict__ dxw1, const T* __restrict__ dz2c,
                  const T* __restrict__ hs, const T* __restrict__ ds,
                  float* __restrict__ part, int b_count, int u_count, int h,
                  int rows_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WLayout L = w_layout<T>(h);
  const int g4 = 4 * h;
  float* acc = reinterpret_cast<float*>(smem);
  T* as = reinterpret_cast<T*>(smem + L.o_a);
  T* bs = reinterpret_cast<T*>(smem + L.o_b);
  const int m0 = blockIdx.x * kMT, x = blockIdx.y, split = blockIdx.z;
  const int n_rows = b_count * u_count;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n_rows, r_begin + rows_per_split);
  const T* dz = x == 0 ? dxw1 : dz2c;
  const size_t hplane = (size_t)b_count * (u_count + 1) * h;
  const T* a = x == 0 ? hs : (x == 1 ? ds : hs + hplane);
  const bool shifted = x != 1;
  for (int i = threadIdx.x; i < kMT * h; i += kThreads)
    acc[(i / h) * L.ldc + i % h] = 0.0f;
  for (int n0 = r_begin; n0 < r_end; n0 += kKC) {
    __syncthreads();
    for (int i = threadIdx.x; i < kKC * kMT; i += kThreads) {
      const int k = i / kMT, m = i % kMT, n = n0 + k;
      as[k * L.lda + m] =
          n < r_end ? dz[(size_t)n * g4 + m0 + m] : from_f<T>(0.0f);
    }
    for (int i = threadIdx.x; i < kKC * h; i += kThreads) {
      const int k = i / h, j = i % h, n = n0 + k;
      T v = from_f<T>(0.0f);
      if (n < r_end) {
        const size_t row = shifted ? (size_t)n + n / u_count : (size_t)n;
        v = a[row * h + j];
      }
      bs[k * L.ldb + j] = v;
    }
    __syncthreads();
    mma_acc<false, true>(acc, L.ldc, as, L.lda, bs, L.ldb, kMT, h, kKC);
  }
  __syncthreads();
  float* out = part + (((size_t)split * 3 + x) * g4 + m0) * h;
  for (int i = threadIdx.x; i < kMT * h; i += kThreads)
    out[i] = acc[(i / h) * L.ldc + i % h];
}

template <typename T>
bool fits(int h) {
  return fwd_layout<T>(h).bytes <= kMaxSmem &&
         bwd_layout<T>(h).bytes <= kMaxSmem &&
         w_layout<T>(h).bytes <= kMaxSmem;
}

bool fits_dtype(int dtype, int h) {
  return h % 16 == 0 && (dtype == 1 ? fits<bf>(h) : fits<float>(h));
}

// Row splits of the weight pass: about two blocks per SM, whole chunks.
void w_splits(int n_rows, int h, int* splits, int* rows_per_split) {
  const int tiles = 3 * (4 * h / kMT);
  const int chunks = (n_rows + kKC - 1) / kKC;
  int s = (2 * 132 + tiles - 1) / tiles;
  if (s > chunks) s = chunks;
  if (s < 1) s = 1;
  const int per = (chunks + s - 1) / s;
  *rows_per_split = per * kKC;
  *splits = (n_rows + *rows_per_split - 1) / *rows_per_split;
  if (*splits < 1) *splits = 1;
}

template <typename T>
cudaError_t launch_fwd(const void* xw1, const void* wh1, const void* wi2,
                       const float* bh2, const void* wh2, void* y, float* zs,
                       float* cs, void* hs, void* ds, int b, int u, int h,
                       Drop dp, cudaStream_t s) {
  auto kernel = lstm2_fwd<T>;
  const size_t bytes = fwd_layout<T>(h).bytes;
  cudaError_t e = set_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<(b + kRB - 1) / kRB, kThreads, bytes, s>>>(
      static_cast<const T*>(xw1), static_cast<const T*>(wh1),
      static_cast<const T*>(wi2), bh2, static_cast<const T*>(wh2),
      static_cast<T*>(y), zs, cs, static_cast<T*>(hs), static_cast<T*>(ds),
      b, u, h, dp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* dy, const void* wh1, const void* wi2,
                       const void* wh2, const float* zs, const float* cs,
                       const void* hs, const void* ds, void* dxw1, float* dwh1,
                       float* dbh2, float* ws, void* dz2c, int b, int u,
                       int h, Drop dp, cudaStream_t s) {
  const int blocks = (b + kRB - 1) / kRB;
  int splits, rows_per_split;
  w_splits(b * u, h, &splits, &rows_per_split);
  float* db_part = ws;
  float* w_part = ws + (size_t)blocks * 4 * h;
  auto ks = lstm2_bwd_steps<T>;
  auto kw = lstm2_bwd_weights<T>;
  const size_t s_bytes = bwd_layout<T>(h).bytes;
  const size_t w_bytes = w_layout<T>(h).bytes;
  cudaError_t e;
  if ((e = set_smem(ks, s_bytes)) != cudaSuccess) return e;
  if ((e = set_smem(kw, w_bytes)) != cudaSuccess) return e;
  ks<<<blocks, kThreads, s_bytes, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(wh1),
      static_cast<const T*>(wi2), static_cast<const T*>(wh2), zs, cs,
      static_cast<T*>(dxw1), static_cast<T*>(dz2c), db_part, b, u, h, dp);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  kw<<<dim3(4 * h / kMT, 3, splits), kThreads, w_bytes, s>>>(
      static_cast<const T*>(dxw1), static_cast<const T*>(dz2c),
      static_cast<const T*>(hs), static_cast<const T*>(ds), w_part, b, u, h,
      rows_per_split);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = sum_into(w_part, dwh1, 1, splits, 3 * 4 * h * h, s)) !=
      cudaSuccess)
    return e;
  return sum_into(db_part, dbh2, 1, blocks, 4 * h, s);
}

}  // namespace

extern "C" {

// 1 when the kernels take this width H for dtype 0 = fp32, 1 = bf16.
int lstm2_seq_fits(int dtype, int h) { return fits_dtype(dtype, h) ? 1 : 0; }

// Shape checks are the caller's (ops/lstm.py). xw1 [B, U, 4H], weights
// [4H, H] in the compute type, bh2 [4H] fp32, y [B, U, H]. zs, cs, hs, ds
// (see lstm2_fwd) may all be null (no backward follows).
int lstm2_seq_fwd(int dtype, const void* xw1, const void* wh1,
                  const void* wi2, const float* bh2, const void* wh2, void* y,
                  float* zs, float* cs, void* hs, void* ds, int b, int u,
                  int h, unsigned key, int thresh, float scale,
                  void* stream) {
  if (!fits_dtype(dtype, h)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Drop dp = make_drop(key, thresh, scale);
  return (int)(dtype == 1
                   ? launch_fwd<bf>(xw1, wh1, wi2, bh2, wh2, y, zs, cs, hs,
                                    ds, b, u, h, dp, s)
                   : launch_fwd<float>(xw1, wh1, wi2, bh2, wh2, y, zs, cs,
                                       hs, ds, b, u, h, dp, s));
}

// fp32 workspace of the backward (floats).
long long lstm2_seq_bwd_workspace(int b, int u, int h) {
  int splits, rows_per_split;
  w_splits(b * u, h, &splits, &rows_per_split);
  const long long blocks = (b + kRB - 1) / kRB;
  return blocks * 4 * h + (long long)splits * 3 * 4 * h * h;
}

// dy [B, U, H]; the forward's saved states; dxw1 [B, U, 4H] and dz2c (a
// [B, U, 4H] scratch) in the compute type; dw [3, 4H, H] (dWh1, dWi2,
// dWh2) and dbh2 [4H] fp32; ws holds lstm2_seq_bwd_workspace() floats.
int lstm2_seq_bwd(int dtype, const void* dy, const void* wh1, const void* wi2,
                  const void* wh2, const float* zs, const float* cs,
                  const void* hs, const void* ds, void* dxw1, float* dw,
                  float* dbh2, float* ws, void* dz2c, int b, int u, int h,
                  unsigned key, int thresh, float scale, void* stream) {
  if (!fits_dtype(dtype, h)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Drop dp = make_drop(key, thresh, scale);
  return (int)(dtype == 1
                   ? launch_bwd<bf>(dy, wh1, wi2, wh2, zs, cs, hs, ds, dxw1,
                                    dw, dbh2, ws, dz2c, b, u, h, dp, s)
                   : launch_bwd<float>(dy, wh1, wi2, wh2, zs, cs, hs, ds,
                                       dxw1, dw, dbh2, ws, dz2c, b, u, h, dp,
                                       s));
}

}  // extern "C"
