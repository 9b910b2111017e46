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
// the same mask whatever the batch blocking. B and b are the step's whole
// batch and a row of it: a process holding rows [row_base, row_base + b)
// of a global_b-row batch draws that batch's mask (global_b 0: its own).
//
// What bounds it: the op count is 3 GEMMs of [B, H] x [H, 4H] a step each
// way (plus the weight gradients), and the bytes are the inputs, outputs
// and saved states (ops/bounds.py); both are far below what the U1 serial
// steps cost. A step's products are too small to fill the card, so the
// time is the latency of the step chain: what the design shortens.
//
// The forward, when a backward will follow, saves every step's gate
// pre-activations and cell states in fp32 and the carried h and the
// dropped d in T (the TPU recomputes them into bf16 VMEM scratch, which
// costs accuracy; nothing is recomputed here). The backward runs the
// adjoint in reverse from them; the weight gradients are
// dWh1 = sum T(dz1)^T h1[t-1], dWi2 = sum T(dz2)^T d[t],
// dWh2 = sum T(dz2)^T h2[t-1] over all (b, t), in row splits whose
// partials a fixed-order sum adds (the same bits every call, no atomics).
//
// bf16 (namespace lstm16, H in {64, 128, 256}). The TPU holds the weights
// in VMEM; one SM's shared memory cannot hold a [4H, H] matrix beside its
// states, so a cluster of 8 CTAs holds one, split by hidden unit:
//   - a cluster owns 64 batch rows (one wgmma M; rows past B compute on
//     zeros and store nothing); CTA k of it owns hidden units
//     [k H/8, (k+1) H/8) and keeps their 4 gate rows of the recurrent
//     matrix, [H/2, H] bf16 (64 KB at H = 256), resident in shared memory,
//     loaded once by TMA;
//   - forward step: one wgmma of the group's h [64, H] (shared memory,
//     MN-major, 128B swizzle) by the resident rows, m64n(H/2), onto the
//     step's input pre-activations; the gates, c and the new h of the
//     CTA's units stay in registers, in
//     the accumulator's layout (a thread holds all four gates of its
//     units). The CTA writes its h slice into its own next-step buffer,
//     where the slice is one contiguous block (h is stored unit-major),
//     and one thread copies that block into the 7 peers' buffers with
//     bulk copies that complete on the peer's mbarrier; h is
//     double-buffered, so a step waits only on that barrier.
//   - layer 2's input product leaves the recurrence: layer 1 runs all
//     steps (writing d), one GEMM forms xw2 = bh2 + d Wi2^T in fp32 (the
//     plain version's fp32 sum, never rounded to T), and layer 2 runs on
//     xw2 with only Wh2 resident. Each recurrence holds one matrix;
//   - backward, the same shape in reverse: layer 2's recurrence (Wh2
//     resident) writes T(dz2) and per-cluster partials of dbh2 (fp32 dz);
//     one GEMM forms gd = T(dz2) Wi2 in fp32; layer 1's recurrence (Wh1
//     resident) takes gd through the mask and writes dxw1 = T(dz1). In a
//     reverse step each CTA forms dz of its own units, multiplies its
//     [64, H/2] slice of T(dz) (registers, the accumulator's layout) by
//     its resident rows into a partial [64, H] in fp32, and scatters the
//     partial's column slices into the owning CTAs' shared memory (16-byte
//     stores over distributed shared memory; two cluster barriers a step,
//     one after the stores, one after every CTA has summed, so one set of
//     slots suffices); each CTA adds the 8 slices in rank order (the same
//     bits every call);
//   - a step's inputs (xw; z, c, dy or gd) and what it writes (z, c, h,
//     d or y; T(dz)) go through swizzled shared-memory boxes [64 rows x
//     H/8 units] and TMA, loaded a step ahead and stored off the step's
//     critical path: read and written 4 or 8 bytes a thread from the
//     accumulator's layout (8 rows a warp instruction), these accesses
//     took most of a step;
//   - the GEMMs inside K4 (xw2, gd and the weight pass) are one wgmma
//     kernel fed by a TMA ring, 128 x BN tiles, fp32 out; the weight pass
//     runs in row splits and a vectorised fixed-order sum adds them.
// fp32 keeps the simple kernels: a block owns RB = 16 batch rows for all
// steps and streams the weights from L2 each step, plain FMA
// (tile_mma.cuh), so that it stays full fp32.
//
// Plain C interface, bound with ctypes; each entry point returns
// cudaGetLastError() or the first launch's error.

#include <utility>

#include "sm90_gmma.cuh"
#include "tile_mma.cuh"

namespace {

using namespace tile;

// ---------------------------------------------------------------- fp32 ---

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

// zs [2, B, U, 4H] and cs [2, B, U, H] fp32, hs [2, B, U, H] (slot t: the
// h that step t read, h[t - 1]; slot 0 zero) and ds [B, U, H] in T: the
// states the backward reads; all null when no backward follows.
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
  for (int i = threadIdx.x; i < kRB * h; i += kThreads) {
    const int r = i / h, j = i % h, b = b0 + r;
    h1[r * L.ldh + j] = h2[r * L.ldh + j] = d[r * L.ldh + j] =
        from_f<T>(0.0f);
    c1[i] = c2[i] = 0.0f;
    if (save && b < b_count) {
      hs[(size_t)b * u_count * h + j] = from_f<T>(0.0f);
      hs[cplane + (size_t)b * u_count * h + j] = from_f<T>(0.0f);
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
            drop(dp, ((uint32_t)t * dp.rows + dp.row0 + b) * (uint32_t)h + j,
                 hn));
        d[r * L.ldh + j] = dv;
        if (save) {
          cs[bt * h + j] = c;
          if (t + 1 < u_count) hs[(bt + 1) * h + j] = from_f<T>(hn);
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
          if (t + 1 < u_count) hs[cplane + (bt + 1) * h + j] = hn;
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
            drop(dp, ((uint32_t)t * dp.rows + dp.row0 + b) * (uint32_t)h + j,
                 gd[q]) +
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
//   x = 2: dz = dz2c, a = h2[t-1]   (hs slot t; h[-1] = 0).
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
  const T* a = x == 0 ? hs : (x == 1 ? ds : hs + (size_t)n_rows * h);
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
      bs[k * L.ldb + j] = n < r_end ? a[(size_t)n * h + j] : from_f<T>(0.0f);
    }
    __syncthreads();
    mma_acc<false, true>(acc, L.ldc, as, L.lda, bs, L.ldb, kMT, h, kKC);
  }
  __syncthreads();
  float* out = part + (((size_t)split * 3 + x) * g4 + m0) * h;
  for (int i = threadIdx.x; i < kMT * h; i += kThreads)
    out[i] = acc[(i / h) * L.ldc + i % h];
}


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

// A weight pass's row splits: `tiles` blocks a split, as many splits as
// make `per_sm` blocks an SM, each a whole number of `chunk`-row chunks,
// none empty.
void w_splits(int rows, int tiles, int chunk, int per_sm, int* splits,
              int* rows_per_split) {
  const int chunks = (rows + chunk - 1) / chunk;
  int s = per_sm * sm_count() / tiles;
  if (s > chunks) s = chunks;
  if (s < 1) s = 1;
  *rows_per_split = (chunks + s - 1) / s * chunk;
  *splits = (rows + *rows_per_split - 1) / *rows_per_split;
}

// ---------------------------------------------------------------- bf16 ---
namespace lstm16 {

using namespace sm90;

constexpr int kCluster = 8;   // CTAs of a cluster: the hidden units split 8 ways
constexpr int kGroup = 64;    // batch rows of a cluster (one wgmma M)
constexpr int kWG = 128;      // threads of a recurrence CTA: one warpgroup
constexpr int kGemmRows = 128;  // GEMM tile rows (two warpgroups)

// Shared memory of a recurrence CTA (offsets from a 1024-aligned base).
template <int H>
struct Rec {
  static constexpr int NU = H / kCluster;  // hidden units a CTA owns
  static constexpr int G = 4 * NU;         // their gate columns
  static constexpr int NP = NU / 4;        // register pairs a gate, a thread
  // The resident gate rows, K-major for the forward ([H/64][G][64], 128B
  // swizzle), which is the MN-major [G x H] operand of the backward.
  static constexpr uint32_t W = G * H * 2;
  // A step's [64 rows x NU units] box of an fp32 or a bf16 tensor, as TMA
  // stores it (row-major, swizzled over its row of NU * 4 or NU * 2 bytes).
  static constexpr uint32_t T32 = kGroup * NU * 4;
  static constexpr uint32_t T16 = kGroup * NU * 2;
  // Forward: h of the group [H][64] (unit-major, 128B swizzle), twice; a
  // CTA's slice is SLICE contiguous bytes. The step's outputs: z of the 4
  // gates and c (fp32), the h it read, and d or y (bf16), then a zero box
  // (the h of step -1); the next step's inputs (4 gate boxes of xw).
  // Barriers: W's load, h's two, the inputs'.
  static constexpr uint32_t HB = H * 128;
  static constexpr uint32_t SLICE = NU * 128;
  static constexpr uint32_t OUT = W + 2 * HB;
  static constexpr uint32_t O_C = OUT + 4 * T32;
  static constexpr uint32_t O_H = O_C + T32;
  static constexpr uint32_t O_Y = O_H + T16;
  static constexpr uint32_t O_ZERO = O_Y + T16;
  static constexpr uint32_t F_IN = O_ZERO + T16;
  static constexpr uint32_t F_BAR = F_IN + 4 * T32;
  static constexpr uint32_t F_BYTES = F_BAR + 32;
  // Backward: the partial slices from the 7 peers, each [NU/8] float4 per
  // thread (item-major); the step's T(dz) boxes of the 4 gates (bf16); the
  // next step's inputs (z of the 4 gates, c[t - 1], dy or gd). Barriers:
  // W's load, the inputs'.
  static constexpr uint32_t SLOT = NU * 256;
  static constexpr uint32_t RECV = W;
  static constexpr uint32_t DZ = RECV + (kCluster - 1) * SLOT;
  static constexpr uint32_t B_IN = DZ + 4 * T16;
  static constexpr uint32_t B_BAR = B_IN + 6 * T32;
  static constexpr uint32_t B_BYTES = B_BAR + 16;
};

// Byte offset of element (row, col) in a box whose rows are `pitch`
// bytes (16, 32, 64 or 128) under the matching TMA swizzle: the 16-byte
// chunk index XOR the 128-byte line index, over as many bits as a row
// has chunks (boxes start on 1024 bytes).
template <int PITCH>
__device__ __forceinline__ uint32_t box_off(int row, uint32_t col_bytes) {
  const uint32_t o = row * PITCH + col_bytes;
  return o ^ (((o >> 7) & (PITCH / 16 - 1)) << 4);
}

// The TMA swizzle of such a box.
constexpr CUtensorMapSwizzle box_swizzle(int pitch) {
  return pitch >= 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : pitch == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
         : pitch == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                       : CU_TENSOR_MAP_SWIZZLE_NONE;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// The gates' activations in fp32 from the ex2-based exponential and a
// fast divide (__expf, __fdividef: a few ulp), without the branches and
// the IEEE division of expf, tanhf and 1 / x, which double a step's time
// (a step's element-wise work is on its critical path). tanh z =
// 1 - 2 / (1 + e^2z), exact to about 1e-7 absolute.
__device__ __forceinline__ float sig(float z) {
  return __fdividef(1.0f, 1.0f + __expf(-z));
}

__device__ __forceinline__ float tanh_(float z) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * z));
}

// The dropout of ops/dropout.py without a branch: rate 0 keeps all
// (threshold 65536) at scale 1.
__device__ __forceinline__ float drop_nb(const Drop& dp, uint32_t index,
                                         float v) {
  return (hash32(index ^ dp.key) & 0xFFFFu) < (uint32_t)dp.thresh
             ? v * dp.scale
             : 0.0f;
}

// The CTA's gate rows g H + k NU .. + NU - 1 (g = i, f, g, o) of W [4H, H]
// into the resident tile, rows g NU .. of each 64-column block.
template <int H>
__device__ __forceinline__ void load_w(uint32_t base, const CUtensorMap* w,
                                       uint32_t bar, int k) {
  using R = Rec<H>;
  mbar_expect_tx(bar, R::W);
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int cb = 0; cb < H / 64; ++cb)
      tma_load_2d(base + cb * R::G * 128 + g * R::NU * 128, w, bar, cb * 64,
                  g * H + k * R::NU);
}

// acc (+)= A B over one k-step, N = the accumulator's columns.
template <int N, int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&acc)[N / 2], uint64_t a,
                                       uint64_t b) {
  if constexpr (N == 32)
    mma_ss_n32<TA, TB>(acc, a, b, 1);
  else if constexpr (N == 64)
    mma_ss_n64<TA, TB>(acc, a, b, 1);
  else if constexpr (N == 128)
    mma_ss_n128<TA, TB>(acc, a, b, 1);
  else
    mma_ss_n256<TA, TB>(acc, a, b, 1);
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.0f;
}

// A thread's place in the accumulator layout of a [64 x G] tile: register
// g NU/2 + 2 q + e holds row row0 + 8 (q % 2), gate g of local unit
// 8 (q / 2) + uq + e, so a thread holds all four gates of its units.
struct Place {
  int row0, uq;
  __device__ __forceinline__ Place() {
    const int lane = threadIdx.x & 31;
    row0 = 16 * warp_uniform(threadIdx.x / 32) + lane / 4;
    uq = 2 * (lane & 3);
  }
  __device__ __forceinline__ int row(int q) const { return row0 + 8 * (q & 1); }
  __device__ __forceinline__ int unit(int q) const {
    return 8 * (q >> 1) + uq;
  }
};

// Launch kWG-thread CTAs on clusters of kCluster along x.
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), int ctas, size_t bytes,
                           cudaStream_t s, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kWG);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = kCluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

// ------------------------------------------------------------ forward ---
// One layer over all steps. L2 = false: layer 1 on xw = xw1 (bf16
// [B, U, 4H]), out = ds = T(drop(h1)); L2 = true: layer 2 on xw = xw2
// (fp32 [B, U, 4H]), out = y = T(h2). The maps are 2-D views [B, U * 4H]
// (xw, zs) and [B, U * H] (cs, hp, out) read and written in the step's
// [64 x NU] boxes; zs, cs, hp are this layer's planes of the saved
// states, z and c in fp32 and hp[b, t] = the h that step t read (slot 0
// zero), written only when save.
template <int H, bool L2>
__global__ void __launch_bounds__(kWG, 1)
fwd_rec(const __grid_constant__ CUtensorMap w_map,
        const __grid_constant__ CUtensorMap xw_map,
        const __grid_constant__ CUtensorMap z_map,
        const __grid_constant__ CUtensorMap c_map,
        const __grid_constant__ CUtensorMap h_map,
        const __grid_constant__ CUtensorMap out_map, int save, int nb,
        int nu, Drop dp) {
  using R = Rec<H>;
  constexpr int NU = R::NU, NP = R::NP, G = R::G;
  constexpr uint32_t TX = L2 ? R::T32 : R::T16;   // an input box
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t wbar = base + R::F_BAR, hbar = wbar + 8;  // + 8 p: buffer p
  const uint32_t inbar = wbar + 24;
  const int k = (int)cluster_rank();
  const int b0 = (blockIdx.x / kCluster) * kGroup;
  const int tid = threadIdx.x;
  const int g4 = 4 * H;
  // Step s's input pre-activations, the 4 gate boxes of xw.
  auto load_in = [&](int s) {
    mbar_expect_tx(inbar, 4 * TX);
#pragma unroll 1
    for (int g = 0; g < 4; ++g)
      tma_load_2d(base + R::F_IN + g * TX, &xw_map, inbar,
                  s * g4 + g * H + k * NU, b0);
  };
  if (tid == 0) {
    mbar_init(wbar, 1);
    mbar_init(hbar, 1);
    mbar_init(hbar + 8, 1);
    mbar_init(inbar, 1);
    mbar_init_fence();
    load_w<H>(base, &w_map, wbar, k);
    load_in(0);
  }
  // h[-1] = 0: buffer 1, which step 0 reads; and the zero box.
  uint4* h1buf = reinterpret_cast<uint4*>(smem + R::W + R::HB);
  for (int i = tid; i < (int)(R::HB / 16); i += kWG)
    h1buf[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < (int)(R::T16 / 16); i += kWG)
    reinterpret_cast<uint4*>(smem + R::O_ZERO)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_async_smem();
  cluster_arrive();   // every CTA's barriers are set before any copy
  cluster_wait();
  const Place pl;
  float acc[G / 2], c[NU / 2], hv[NU / 2];
  zero(c);
  // A: h [H][64] unit-major (MN-major, one 64-row atom), a k-step 16
  // units = 2048 bytes; B: the resident rows, K-major.
  const uint64_t ad0 = desc(base + R::W, R::HB, 1024, kSwizzle128);
  const uint64_t wd0 = desc(base, 16, 1024, kSwizzle128);
  mbar_wait(wbar, 0);
  for (int s = 0; s < nu; ++s) {
    const int cur = s & 1;
    mbar_wait(inbar, s & 1);
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const unsigned char* in = smem + R::F_IN + g * TX;
        float2 v;
        if constexpr (L2)
          v = *reinterpret_cast<const float2*>(
              in + box_off<NU * 4>(pl.row(q), pl.unit(q) * 4));
        else
          v = unpack_bf16(*reinterpret_cast<const uint32_t*>(
              in + box_off<NU * 2>(pl.row(q), pl.unit(q) * 2)));
        acc[g * NU / 2 + 2 * q] = v.x;
        acc[g * NU / 2 + 2 * q + 1] = v.y;
      }
    if (s > 0) mbar_wait(hbar + 8 * (cur ^ 1), ((s - 1) >> 1) & 1);
    const uint64_t ad = desc_at(opaque(ad0), (cur ^ 1) * R::HB);
    const uint64_t wd = opaque(wd0);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk)
      mma_ss<G, 1, 0>(acc, desc_at(ad, kk * 2048),
                      desc_at(wd, (kk >> 2) * G * 128 + (kk & 3) * 32));
    wg_commit();
    wg_wait0();
    fence_regs(acc);
    // The product is the whole warpgroup's, so every warp has read the
    // input boxes: they take the next step's.
    if (tid == 0 && s + 1 < nu) load_in(s + 1);
    // The cell, and h into this step's buffer at (unit, row).
    unsigned char* hb = smem + R::W + cur * R::HB;
#pragma unroll
    for (int r = 0; r < NU / 2; ++r) {
      const float cc =
          sig(acc[NU / 2 + r]) * c[r] + sig(acc[r]) * tanh_(acc[NU + r]);
      c[r] = cc;
      hv[r] = sig(acc[3 * NU / 2 + r]) * tanh_(cc);
      const int q = r >> 1, row = pl.row(q);
      const int j = k * NU + pl.unit(q) + (r & 1);
      *reinterpret_cast<bf*>(hb + j * 128 + (((row >> 3) ^ (j & 7)) << 4) +
                             (row & 7) * 2) = __float2bfloat16(hv[r]);
    }
    // The output boxes are free once the last step's stores have read them.
    if (tid == 0) bulk_wait_read<0>();
    fence_async_smem();
    named_sync(1, kWG);
    if (tid == 0 && s + 1 < nu) {
      const uint32_t bar = hbar + 8 * cur;
      const uint32_t src = base + R::W + cur * R::HB + k * R::SLICE;
      mbar_expect_tx(bar, (kCluster - 1) * R::SLICE);
#pragma unroll 1
      for (int p = 1; p < kCluster; ++p) {
        const uint32_t peer = (uint32_t)((k + p) % kCluster);
        bulk_copy_peer(mapa(src, peer), src, R::SLICE, mapa(bar, peer));
      }
    }
    // Outputs and saved states into their boxes, stored by TMA, off the
    // step's critical path.
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int row = pl.row(q), u = pl.unit(q);
      const uint32_t o32 = box_off<NU * 4>(row, u * 4);
      const uint32_t o16 = box_off<NU * 2>(row, u * 2);
      if constexpr (L2) {
        *reinterpret_cast<uint32_t*>(smem + R::O_Y + o16) =
            pack_bf16(hv[2 * q], hv[2 * q + 1]);
      } else {
        const uint32_t ix = ((uint32_t)s * dp.rows + dp.row0 + b0 + row) *
                                (uint32_t)H +
                            k * NU + u;
        *reinterpret_cast<uint32_t*>(smem + R::O_Y + o16) =
            pack_bf16(drop_nb(dp, ix, hv[2 * q]),
                      drop_nb(dp, ix + 1, hv[2 * q + 1]));
      }
      if (save) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
          *reinterpret_cast<float2*>(smem + R::OUT + g * R::T32 + o32) =
              make_float2(acc[g * NU / 2 + 2 * q], acc[g * NU / 2 + 2 * q + 1]);
        *reinterpret_cast<float2*>(smem + R::O_C + o32) =
            make_float2(c[2 * q], c[2 * q + 1]);
        *reinterpret_cast<uint32_t*>(smem + R::O_H + o16) =
            pack_bf16(hv[2 * q], hv[2 * q + 1]);
      }
    }
    fence_async_smem();
    named_sync(1, kWG);
    if (tid == 0) {
      const int col = s * H + k * NU;
      tma_store_2d(&out_map, base + R::O_Y, col, b0);
      if (save) {
#pragma unroll 1
        for (int g = 0; g < 4; ++g)
          tma_store_2d(&z_map, base + R::OUT + g * R::T32, s * g4 + g * H +
                       k * NU, b0);
        tma_store_2d(&c_map, base + R::O_C, col, b0);
        if (s + 1 < nu) tma_store_2d(&h_map, base + R::O_H, col + H, b0);
        if (s == 0) tma_store_2d(&h_map, base + R::O_ZERO, col, b0);
      }
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_read<0>();
  cluster_arrive();   // no CTA leaves while a copy may touch its memory
  cluster_wait();
}

// ----------------------------------------------------------- backward ---
// One layer's adjoint over all steps, in reverse. L2 = true: layer 2, gin
// = dy (bf16 [B, U, H]), dz = T(dz2), and this cluster's column sums of
// dz2 (fp32) into db_part[cluster]; L2 = false: layer 1, gin = gd (fp32
// [B, U, H], through the mask), dz = dxw1. The maps are 2-D views read and
// written in the step's [64 x NU] boxes: z_map [B, U * 4H] and c_map
// [B, U * H] of this layer's planes of the forward's saved states (cs,
// the same plane, for the last step's c), g_map [B, U * H] of gin, dz_map
// [B, U * 4H] of dz.
template <int H, bool L2>
__global__ void __launch_bounds__(kWG, 1)
bwd_rec(const __grid_constant__ CUtensorMap w_map,
        const __grid_constant__ CUtensorMap z_map,
        const __grid_constant__ CUtensorMap c_map,
        const __grid_constant__ CUtensorMap g_map,
        const __grid_constant__ CUtensorMap dz_map,
        const float* __restrict__ cs, float* __restrict__ db_part, int nb,
        int nu, Drop dp) {
  using R = Rec<H>;
  constexpr int NU = R::NU, NP = R::NP, G = R::G;
  constexpr uint32_t TG = L2 ? R::T16 : R::T32;   // the dy or gd box
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t wbar = base + R::B_BAR, inbar = wbar + 8;
  const int k = (int)cluster_rank();
  const int cl = blockIdx.x / kCluster, b0 = cl * kGroup;
  const int tid = threadIdx.x;
  const int g4 = 4 * H;
  // Step t's inputs: z of the 4 gates, c[t - 1] (none at t = 0: zeros),
  // dy or gd.
  const uint32_t in_c = base + R::B_IN + 4 * R::T32, in_g = in_c + R::T32;
  auto load_in = [&](int t) {
    mbar_expect_tx(inbar, 4 * R::T32 + (t > 0 ? R::T32 : 0) + TG);
#pragma unroll 1
    for (int g = 0; g < 4; ++g)
      tma_load_2d(base + R::B_IN + g * R::T32, &z_map, inbar,
                  t * g4 + g * H + k * NU, b0);
    if (t > 0) tma_load_2d(in_c, &c_map, inbar, (t - 1) * H + k * NU, b0);
    tma_load_2d(in_g, &g_map, inbar, t * H + k * NU, b0);
  };
  if (tid == 0) {
    mbar_init(wbar, 1);
    mbar_init(inbar, 1);
    mbar_init_fence();
    load_w<H>(base, &w_map, wbar, k);
    load_in(nu - 1);
  }
  const Place pl;
  const bool ok0 = b0 + pl.row(0) < nb, ok1 = b0 + pl.row(1) < nb;
  float cur_c[NU / 2], dc[NU / 2], own[NU / 2];
  float db[L2 ? NU : 1];
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const bool ok = (q & 1) ? ok1 : ok0;
    const size_t bt = (size_t)(b0 + pl.row(q)) * nu + nu - 1;
    const float2 v = ok ? *reinterpret_cast<const float2*>(
                              cs + bt * H + k * NU + pl.unit(q))
                        : make_float2(0.0f, 0.0f);
    cur_c[2 * q] = v.x;
    cur_c[2 * q + 1] = v.y;
  }
  zero(dc);
  zero(own);
  zero(db);
  uint32_t peer_recv[kCluster];
#pragma unroll
  for (int c = 0; c < kCluster; ++c) peer_recv[c] = mapa(base + R::RECV, c);
  // B: the resident rows as [G x H], MN-major: atoms of 64 columns G * 128
  // bytes apart, a k-step 16 rows = 2048 bytes.
  const uint64_t wd0 = desc(base, R::G * 128, 1024, kSwizzle128);
  cluster_arrive();   // peers may store into this CTA from here on
  cluster_wait();
  mbar_wait(wbar, 0);
  // Each step passes the cluster barrier twice: after the slices have
  // landed (the stores' release, before the sum) and after every CTA has
  // summed them (before the next step's stores overwrite the slots).
  for (int i = 0; i < nu; ++i) {
    const int t = nu - 1 - i;
    // dh of this step: the 8 slices of the last step's partials, in rank
    // order (this CTA's own from registers).
    float dh[NU / 2];
    zero(dh);
    if (i > 0) {
      cluster_wait();
      const unsigned char* rb = smem + R::RECV;
#pragma unroll
      for (int src = 0; src < kCluster; ++src) {
        if (src == k) {
#pragma unroll
          for (int r = 0; r < NU / 2; ++r) dh[r] += own[r];
        } else {
          const int slot = src < k ? src : src - 1;
          const float4* p =
              reinterpret_cast<const float4*>(rb + slot * R::SLOT) + tid;
#pragma unroll
          for (int it = 0; it < NU / 8; ++it) {
            const float4 v = p[it * kWG];
            dh[4 * it] += v.x;
            dh[4 * it + 1] += v.y;
            dh[4 * it + 2] += v.z;
            dh[4 * it + 3] += v.w;
          }
        }
      }
      cluster_arrive();
    }
    mbar_wait(inbar, i & 1);
    // The adjoint of the cell, pair by pair; T(dz) packed in the
    // accumulator's layout, which is the A fragment of the product, and
    // into the step's boxes.
    uint32_t a[G / 16][4];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int row = pl.row(q), u = pl.unit(q);
      const uint32_t o32 = box_off<NU * 4>(row, u * 4);
      float2 z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        z[g] = *reinterpret_cast<const float2*>(smem + R::B_IN +
                                                g * R::T32 + o32);
      const float2 cp =
          t > 0 ? *reinterpret_cast<const float2*>(smem + R::B_IN +
                                                   4 * R::T32 + o32)
                : make_float2(0.0f, 0.0f);
      float2 gv;
      if constexpr (L2) {
        gv = unpack_bf16(*reinterpret_cast<const uint32_t*>(
            smem + R::B_IN + 5 * R::T32 + box_off<NU * 2>(row, u * 2)));
      } else {
        gv = *reinterpret_cast<const float2*>(smem + R::B_IN + 5 * R::T32 +
                                              o32);
        const uint32_t ix = ((uint32_t)t * dp.rows + dp.row0 + b0 + row) *
                                (uint32_t)H +
                            k * NU + u;
        gv = make_float2(drop_nb(dp, ix, gv.x), drop_nb(dp, ix + 1, gv.y));
      }
      float dzv[4][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 2 * q + e;
        const float zi = e ? z[0].y : z[0].x, zf = e ? z[1].y : z[1].x;
        const float zg = e ? z[2].y : z[2].x, zo = e ? z[3].y : z[3].x;
        const float si = sig(zi), sf = sig(zf), sg = tanh_(zg), so = sig(zo);
        const float tc = tanh_(cur_c[r]);
        const float cprev = e ? cp.y : cp.x;
        const float dht = (e ? gv.y : gv.x) + dh[r];
        const float dct = dc[r] + dht * so * (1.0f - tc * tc);
        dzv[0][e] = dct * sg * si * (1.0f - si);
        dzv[1][e] = dct * cprev * sf * (1.0f - sf);
        dzv[2][e] = dct * si * (1.0f - sg * sg);
        dzv[3][e] = dht * tc * so * (1.0f - so);
        dc[r] = dct * sf;
        cur_c[r] = cprev;
      }
      const uint32_t o16 = box_off<NU * 2>(row, u * 2);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int reg = g * NU / 2 + 2 * q;
        const uint32_t v = pack_bf16(dzv[g][0], dzv[g][1]);
        a[reg / 8][(reg % 8) / 2] = v;
        *reinterpret_cast<uint32_t*>(smem + R::DZ + g * R::T16 + o16) = v;
        if constexpr (L2) {
          db[g * NU / 4 + (q >> 1) * 2] += dzv[g][0];
          db[g * NU / 4 + (q >> 1) * 2 + 1] += dzv[g][1];
        }
      }
    }
    fence_async_smem();
    named_sync(1, kWG);
    if (tid == 0) {   // every thread is done with the inputs and dz boxes
#pragma unroll 1
      for (int g = 0; g < 4; ++g)
        tma_store_2d(&dz_map, base + R::DZ + g * R::T16,
                     t * g4 + g * H + k * NU, b0);
      bulk_commit();
      if (t > 0) load_in(t - 1);
    }
    // The partials of dh[t - 1]: T(dz) [64 x G] times the resident rows
    // [G x H], 64 columns at a time into two accumulators in turn, so that
    // one's slices go out while the next product runs; columns c NU .. of
    // CTA c go to its slot k (this CTA's own stay in registers), once
    // every CTA has summed the last step's.
    const uint32_t slot_off = tid * 16;
    float acc[2][32];
    auto mma_chunk = [&](int ch, float (&ac)[32]) {
      const uint64_t wd = desc_at(opaque(wd0), ch * G * 128);
      fence_regs(ac);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < G / 16; ++ks)
        mma_rs_n64<1>(ac, a[ks], desc_at(wd, ks * 2048), ks > 0);
      wg_commit();
    };
    auto scatter = [&](int ch, const float (&ac)[32]) {
#pragma unroll
      for (int d = 0; d < 64 / NU; ++d) {
        const int c = ch * (64 / NU) + d;
        if (c == k) {
#pragma unroll
          for (int r = 0; r < NU / 2; ++r) own[r] = ac[d * NU / 2 + r];
        } else {
          const uint32_t dst =
              peer_recv[c] + slot_off + (k < c ? k : k - 1) * R::SLOT;
#pragma unroll
          for (int it = 0; it < NU / 8; ++it)
            st_cluster(dst + it * kWG * 16,
                       make_float4(ac[d * NU / 2 + 4 * it],
                                   ac[d * NU / 2 + 4 * it + 1],
                                   ac[d * NU / 2 + 4 * it + 2],
                                   ac[d * NU / 2 + 4 * it + 3]));
        }
      }
    };
    mma_chunk(0, acc[0]);
    if (i > 0) cluster_wait();
#pragma unroll
    for (int ch = 0; ch < H / 64; ++ch) {
      if (ch + 1 < H / 64) {
        mma_chunk(ch + 1, acc[(ch + 1) & 1]);
        wg_wait1();
      } else {
        wg_wait0();
      }
      fence_regs(acc[ch & 1]);
      scatter(ch, acc[ch & 1]);
    }
    // The dz boxes are free for the next step once their stores have read
    // them (the next step writes them after the cluster barrier).
    if (tid == 0) bulk_wait_read<0>();
    cluster_arrive();
  }
  cluster_wait();   // the last step's stores have landed everywhere
  if constexpr (L2) {
    // db: the 8 lanes of each column group, then the 4 warps, in order.
#pragma unroll
    for (int e = 0; e < NU; ++e) {
      db[e] += __shfl_xor_sync(0xffffffffu, db[e], 4);
      db[e] += __shfl_xor_sync(0xffffffffu, db[e], 8);
      db[e] += __shfl_xor_sync(0xffffffffu, db[e], 16);
    }
    float* red = reinterpret_cast<float*>(smem + R::RECV);
    const int warp = tid / 32, lane = tid & 31;
    if (lane < 4) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int e = 0; e < NU / 4; ++e)
          red[warp * G + g * NU + 8 * (e >> 1) + 2 * lane + (e & 1)] =
              db[g * NU / 4 + e];
    }
    named_sync(1, kWG);
    if (tid < G)
      db_part[(size_t)cl * g4 + (tid / NU) * H + k * NU + tid % NU] =
          red[tid] + red[G + tid] + red[2 * G + tid] + red[3 * G + tid];
  }
}

// --------------------------------------------------------------- GEMMs ---
// C[m0 + 128 rows, n0 + BN cols] (fp32, row-major, ldc; rows past m not
// stored) = A B (+ bias[col]) over `chunks` K chunks of 64 from k_begin.
// TA = 0: A from a [M, K] bf16 tensor (K-major); TA = 1: A = X^T for X
// [K, M] (MN-major). TB = 0: B given as [N, K] (K-major); TB = 1: B
// [K, N] (MN-major). Two warpgroups of 64 rows; a TMA ring of full/empty
// mbarriers (thread 0 refills the stage every warp has released).
template <int BN>
struct Gemm {
  static constexpr uint32_t A = kGemmRows * 64 * 2;
  static constexpr uint32_t B = BN * 64 * 2;
  static constexpr uint32_t STAGE = A + B;
  static constexpr int STAGES =
      (kMaxSmem - 1024 - 256) / STAGE > 4 ? 4
                                          : (int)((kMaxSmem - 1024 - 256) /
                                                  STAGE);
  static constexpr uint32_t FULL = STAGES * STAGE;
  static constexpr uint32_t EMPTY = FULL + 8 * STAGES;
  static constexpr uint32_t BYTES = EMPTY + 8 * STAGES;
};

template <int BN, int TA, int TB>
__device__ __forceinline__ void g_load(uint32_t st, uint32_t full,
                                       const CUtensorMap* a,
                                       const CUtensorMap* b, int m0, int n0,
                                       int kc) {
  mbar_expect_tx(full, Gemm<BN>::STAGE);
  if constexpr (TA == 0) {
    tma_load_2d(st, a, full, kc, m0);
  } else {
    tma_load_2d(st, a, full, m0, kc);
    tma_load_2d(st + 8192, a, full, m0 + 64, kc);
  }
  const uint32_t sb = st + Gemm<BN>::A;
  if constexpr (TB == 0) {
    tma_load_2d(sb, b, full, kc, n0);
  } else {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      tma_load_2d(sb + j * 8192, b, full, n0 + 64 * j, kc);
  }
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void gemm(const CUtensorMap* am,
                                     const CUtensorMap* bm,
                                     float* __restrict__ c, int ldc,
                                     const float* __restrict__ bias, int m,
                                     int m0, int n0, int k_begin,
                                     int chunks) {
  using L = Gemm<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(base + L::FULL + 8 * s, 1);
      mbar_init(base + L::EMPTY + 8 * s, 8);
    }
    mbar_init_fence();
    for (int i = 0; i < L::STAGES && i < chunks; ++i)
      g_load<BN, TA, TB>(base + i * L::STAGE, base + L::FULL + 8 * i, am, bm,
                         m0, n0, k_begin + 64 * i);
  }
  __syncthreads();
  const int wid = warp_uniform(tid / 32);
  const int w = wid / 4, warp = wid % 4, lane = tid % 32;
  float acc[BN / 2];
  zero(acc);
  // A: the warpgroup's 64 rows (K-major rows, or one MN-major atom) 8 KB
  // in; B: K-major rows, or MN-major atoms 8 KB apart.
  const uint64_t ad0 =
      desc(base + w * 8192, TA ? 8192 : 16, 1024, kSwizzle128);
  const uint64_t bd0 = desc(base + L::A, TB ? 8192 : 16, 1024, kSwizzle128);
  for (int i = 0; i < chunks; ++i) {
    const int s = i % L::STAGES;
    mbar_wait(base + L::FULL + 8 * s, (i / L::STAGES) & 1);
    const uint64_t ad = desc_at(opaque(ad0), s * L::STAGE);
    const uint64_t bd = desc_at(opaque(bd0), s * L::STAGE);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss<BN, TA, TB>(acc, desc_at(ad, TA ? kk * 2048 : kk * 32),
                         desc_at(bd, TB ? kk * 2048 : kk * 32));
    wg_commit();
    if (i == 0) continue;
    wg_wait1();
    const int sp = (i - 1) % L::STAGES;
    if (lane == 0) mbar_arrive(base + L::EMPTY + 8 * sp);
    if (tid == 0 && i - 1 + L::STAGES < chunks) {
      mbar_wait(base + L::EMPTY + 8 * sp, ((i - 1) / L::STAGES) & 1);
      g_load<BN, TA, TB>(base + sp * L::STAGE, base + L::FULL + 8 * sp, am,
                         bm, m0, n0, k_begin + 64 * (i - 1 + L::STAGES));
    }
  }
  wg_wait0();
  fence_regs(acc);
  const int rb = m0 + 64 * w + 16 * warp + lane / 4;
#pragma unroll
  for (int r = 0; r < BN / 2; r += 2) {
    const int row = rb + 8 * ((r >> 1) & 1);
    const int col = n0 + 8 * (r >> 2) + 2 * (lane & 3);
    float2 v = make_float2(acc[r], acc[r + 1]);
    if (bias != nullptr) {
      v.x += bias[col];
      v.y += bias[col + 1];
    }
    if (row < m) *reinterpret_cast<float2*>(c + (size_t)row * ldc + col) = v;
  }
}

// xw2 [BU, 4H] = bh2 + ds Wi2^T (ds [BU, H] and Wi2 [4H, H], both K-major).
template <int BN>
__global__ void __launch_bounds__(2 * 128, 1)
xw2_gemm(const __grid_constant__ CUtensorMap a,
         const __grid_constant__ CUtensorMap b, float* __restrict__ c,
         const float* __restrict__ bias, int m, int n, int k) {
  gemm<BN, 0, 0>(&a, &b, c, n, bias, m, blockIdx.x * kGemmRows,
                 blockIdx.y * BN, 0, k / 64);
}

// gd [BU, H] = T(dz2) Wi2 (dz2 [BU, 4H] K-major, Wi2 [4H, H] MN-major).
template <int BN>
__global__ void __launch_bounds__(2 * 128, 1)
gd_gemm(const __grid_constant__ CUtensorMap a,
        const __grid_constant__ CUtensorMap b, float* __restrict__ c, int m,
        int n, int k) {
  gemm<BN, 0, 1>(&a, &b, c, n, nullptr, m, blockIdx.x * kGemmRows,
                 blockIdx.y * BN, 0, k / 64);
}

// The weight pass, block (128 gate rows, gradient x, row split):
// part[split][x] = sum over the split's rows of dz_x^T a_x, with (dz, a) =
// (dxw1, h1[t-1]), (T(dz2), d), (T(dz2), h2[t-1]) for x = 0, 1, 2.
template <int H>
__global__ void __launch_bounds__(2 * 128, 1)
dw_gemm(const __grid_constant__ CUtensorMap a0,
        const __grid_constant__ CUtensorMap a1,
        const __grid_constant__ CUtensorMap b0,
        const __grid_constant__ CUtensorMap b1,
        const __grid_constant__ CUtensorMap b2, float* __restrict__ part,
        int rows, int rows_per_split) {
  const int x = blockIdx.y, split = blockIdx.z, g4 = 4 * H;
  const int r_begin = split * rows_per_split;
  const int r_end = min(rows, r_begin + rows_per_split);
  gemm<H, 1, 1>(x == 0 ? &a0 : &a1, x == 0 ? &b0 : (x == 1 ? &b1 : &b2),
                part + ((size_t)split * 3 + x) * g4 * H, H, nullptr, g4,
                blockIdx.x * kGemmRows, 0, r_begin, (r_end - r_begin + 63) / 64);
}

// out[j] = sum over s < s_count of part[s * m + j], s in order, four
// columns a thread.
__global__ void bwd_sums(const float4* __restrict__ part,
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

// ------------------------------------------------------------- launch ---
// The weight pass's splits: one wave of its 3 (4H / 128) tiles a split.
void dw_splits(int rows, int h, int* splits, int* rows_per_split) {
  w_splits(rows, 3 * (4 * h / kGemmRows), 64, 1, splits, rows_per_split);
}

long long bwd_workspace(int b, int u, int h) {
  int splits, rows_per_split;
  dw_splits(b * u, h, &splits, &rows_per_split);
  const long long groups = (b + kGroup - 1) / kGroup;
  return (long long)b * u * h + groups * 4 * h +
         (long long)splits * 3 * 4 * h * h;
}

inline cudaError_t sum4(const float* part, float* out, int s_count, int m,
                        cudaStream_t st) {
  const int m4 = m / 4;
  bwd_sums<<<(m4 + 255) / 256, 256, 0, st>>>(
      reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(out),
      s_count, m4);
  return cudaGetLastError();
}

constexpr CUtensorMapSwizzle kSw128 = CU_TENSOR_MAP_SWIZZLE_128B;

// The [64 x NU] step boxes of a [B, cols] tensor (fp32 or bf16).
template <int H>
bool box_map(CUtensorMap* m, const void* p, int b, long long cols,
             bool f32) {
  constexpr int NU = Rec<H>::NU;
  return tensor_map(m, p, b, cols, kGroup, NU,
                    box_swizzle(NU * (f32 ? 4 : 2)), f32);
}

template <int H>
cudaError_t fwd(const bf* xw1, const bf* wh1, const bf* wi2,
                const float* bh2, const bf* wh2, bf* y, float* zs, float* cs,
                bf* hp, bf* ds, float* xw2, int b, int u, Drop dp,
                cudaStream_t s) {
  using R = Rec<H>;
  constexpr int BN = 128;
  const int rows = b * u, ctas = (b + kGroup - 1) / kGroup * kCluster;
  const long long g4u = (long long)u * 4 * H, hu = (long long)u * H;
  const size_t zp = (size_t)rows * 4 * H, cp = (size_t)rows * H;
  const bool save = zs != nullptr;
  CUtensorMap w1m, w2m, dsm, wim, x1, x2, z1, z2, c1, c2, h1, h2, dso, yo;
  bool ok = tensor_map(&w1m, wh1, 4 * H, H, R::NU, 64, kSw128) &&
            tensor_map(&w2m, wh2, 4 * H, H, R::NU, 64, kSw128) &&
            tensor_map(&dsm, ds, rows, H, kGemmRows, 64, kSw128) &&
            tensor_map(&wim, wi2, 4 * H, H, BN, 64, kSw128) &&
            box_map<H>(&x1, xw1, b, g4u, false) &&
            box_map<H>(&x2, xw2, b, g4u, true) &&
            box_map<H>(&dso, ds, b, hu, false) &&
            box_map<H>(&yo, y, b, hu, false);
  if (save)   // unused (and left unset) without saved states
    ok = ok && box_map<H>(&z1, zs, b, g4u, true) &&
         box_map<H>(&z2, zs + zp, b, g4u, true) &&
         box_map<H>(&c1, cs, b, hu, true) &&
         box_map<H>(&c2, cs + cp, b, hu, true) &&
         box_map<H>(&h1, hp, b, hu, false) &&
         box_map<H>(&h2, hp + cp, b, hu, false);
  if (!ok) return cudaErrorInvalidValue;
  auto k1 = fwd_rec<H, false>;
  auto k2 = fwd_rec<H, true>;
  auto kg = xw2_gemm<BN>;
  const size_t rb = R::F_BYTES + 1024, gb = Gemm<BN>::BYTES + 1024;
  cudaError_t e;
  if ((e = set_smem(k1, rb)) != cudaSuccess) return e;
  if ((e = set_smem(k2, rb)) != cudaSuccess) return e;
  if ((e = set_smem(kg, gb)) != cudaSuccess) return e;
  if ((e = launch_cluster(k1, ctas, rb, s, w1m, x1, z1, c1, h1, dso,
                          (int)save, b, u, dp)) != cudaSuccess)
    return e;
  kg<<<dim3((rows + kGemmRows - 1) / kGemmRows, 4 * H / BN), 256, gb, s>>>(
      dsm, wim, xw2, bh2, rows, 4 * H, H);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return launch_cluster(k2, ctas, rb, s, w2m, x2, z2, c2, h2, yo,
                        (int)save, b, u, dp);
}

template <int H>
cudaError_t bwd(const bf* dy, const bf* wh1, const bf* wi2, const bf* wh2,
                const float* zs, const float* cs, const bf* hp, const bf* ds,
                bf* dxw1, float* dw, float* dbh2, float* ws, bf* dz2c, int b,
                int u, Drop dp, cudaStream_t s) {
  using R = Rec<H>;
  constexpr int BG = H < 128 ? H : 128;   // gd's column tile
  const int rows = b * u, groups = (b + kGroup - 1) / kGroup;
  const int ctas = groups * kCluster;
  const long long g4u = (long long)u * 4 * H, hu = (long long)u * H;
  int splits, rows_per_split;
  dw_splits(rows, H, &splits, &rows_per_split);
  float* gd = ws;
  float* db_part = gd + (size_t)rows * H;
  float* w_part = db_part + (size_t)groups * 4 * H;
  const size_t zp = (size_t)rows * 4 * H, cp = (size_t)rows * H;
  CUtensorMap w1m, w2m, z1, z2, c1, c2, dyi, gdi, dz2o, dx1o, dza, wib, x0,
      x1, hb0, dsb, hb1;
  if (!tensor_map(&w1m, wh1, 4 * H, H, R::NU, 64, kSw128) ||
      !tensor_map(&w2m, wh2, 4 * H, H, R::NU, 64, kSw128) ||
      !box_map<H>(&z1, zs, b, g4u, true) ||
      !box_map<H>(&z2, zs + zp, b, g4u, true) ||
      !box_map<H>(&c1, cs, b, hu, true) ||
      !box_map<H>(&c2, cs + cp, b, hu, true) ||
      !box_map<H>(&dyi, dy, b, hu, false) ||
      !box_map<H>(&gdi, gd, b, hu, true) ||
      !box_map<H>(&dz2o, dz2c, b, g4u, false) ||
      !box_map<H>(&dx1o, dxw1, b, g4u, false) ||
      !tensor_map(&dza, dz2c, rows, 4 * H, kGemmRows, 64, kSw128) ||
      !tensor_map(&wib, wi2, 4 * H, H, 64, 64, kSw128) ||
      !tensor_map(&x0, dxw1, rows, 4 * H, 64, 64, kSw128) ||
      !tensor_map(&x1, dz2c, rows, 4 * H, 64, 64, kSw128) ||
      !tensor_map(&hb0, hp, rows, H, 64, 64, kSw128) ||
      !tensor_map(&dsb, ds, rows, H, 64, 64, kSw128) ||
      !tensor_map(&hb1, hp + cp, rows, H, 64, 64, kSw128))
    return cudaErrorInvalidValue;
  auto k2 = bwd_rec<H, true>;
  auto k1 = bwd_rec<H, false>;
  auto kg = gd_gemm<BG>;
  auto kw = dw_gemm<H>;
  const size_t rb = R::B_BYTES + 1024;
  const size_t gb = Gemm<BG>::BYTES + 1024, wb = Gemm<H>::BYTES + 1024;
  cudaError_t e;
  if ((e = set_smem(k2, rb)) != cudaSuccess) return e;
  if ((e = set_smem(k1, rb)) != cudaSuccess) return e;
  if ((e = set_smem(kg, gb)) != cudaSuccess) return e;
  if ((e = set_smem(kw, wb)) != cudaSuccess) return e;
  if ((e = launch_cluster(k2, ctas, rb, s, w2m, z2, c2, dyi, dz2o,
                          cs + cp, db_part, b, u, dp)) != cudaSuccess)
    return e;
  kg<<<dim3((rows + kGemmRows - 1) / kGemmRows, H / BG), 256, gb, s>>>(
      dza, wib, gd, rows, H, 4 * H);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = launch_cluster(k1, ctas, rb, s, w1m, z1, c1, gdi, dx1o, cs,
                          static_cast<float*>(nullptr), b, u, dp)) !=
      cudaSuccess)
    return e;
  kw<<<dim3(4 * H / kGemmRows, 3, splits), 256, wb, s>>>(
      x0, x1, hb0, dsb, hb1, w_part, rows, rows_per_split);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = sum4(w_part, dw, splits, 3 * 4 * H * H, s)) != cudaSuccess)
    return e;
  return sum4(db_part, dbh2, groups, 4 * H, s);
}

}  // namespace lstm16

// ---------------------------------------------------------------- fp32 ---
bool fits_f32(int h) {
  return h % 16 == 0 && fwd_layout<float>(h).bytes <= kMaxSmem &&
         bwd_layout<float>(h).bytes <= kMaxSmem &&
         w_layout<float>(h).bytes <= kMaxSmem;
}

bool bf16_width(int h) { return h == 64 || h == 128 || h == 256; }

bool fits_dtype(int dtype, int h) {
  return dtype == 1 ? bf16_width(h) : fits_f32(h);
}

// Row splits of the fp32 weight pass: about two blocks an SM.
void f32_splits(int rows, int h, int* splits, int* rows_per_split) {
  w_splits(rows, 3 * (4 * h / kMT), kKC, 2, splits, rows_per_split);
}

cudaError_t launch_fwd_f32(const float* xw1, const float* wh1,
                           const float* wi2, const float* bh2,
                           const float* wh2, float* y, float* zs, float* cs,
                           float* hs, float* ds, int b, int u, int h, Drop dp,
                           cudaStream_t s) {
  auto kernel = lstm2_fwd<float>;
  const size_t bytes = fwd_layout<float>(h).bytes;
  cudaError_t e = set_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<(b + kRB - 1) / kRB, kThreads, bytes, s>>>(
      xw1, wh1, wi2, bh2, wh2, y, zs, cs, hs, ds, b, u, h, dp);
  return cudaGetLastError();
}

cudaError_t launch_bwd_f32(const float* dy, const float* wh1,
                           const float* wi2, const float* wh2,
                           const float* zs, const float* cs, const float* hs,
                           const float* ds, float* dxw1, float* dwh1,
                           float* dbh2, float* ws, float* dz2c, int b, int u,
                           int h, Drop dp, cudaStream_t s) {
  const int blocks = (b + kRB - 1) / kRB;
  int splits, rows_per_split;
  f32_splits(b * u, h, &splits, &rows_per_split);
  float* db_part = ws;
  float* w_part = ws + (size_t)blocks * 4 * h;
  auto ks = lstm2_bwd_steps<float>;
  auto kw = lstm2_bwd_weights<float>;
  const size_t s_bytes = bwd_layout<float>(h).bytes;
  const size_t w_bytes = w_layout<float>(h).bytes;
  cudaError_t e;
  if ((e = set_smem(ks, s_bytes)) != cudaSuccess) return e;
  if ((e = set_smem(kw, w_bytes)) != cudaSuccess) return e;
  ks<<<blocks, kThreads, s_bytes, s>>>(dy, wh1, wi2, wh2, zs, cs, dxw1, dz2c,
                                       db_part, b, u, h, dp);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  kw<<<dim3(4 * h / kMT, 3, splits), kThreads, w_bytes, s>>>(
      dxw1, dz2c, hs, ds, w_part, b, u, h, rows_per_split);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = sum_into(w_part, dwh1, 1, splits, 3 * 4 * h * h, s)) !=
      cudaSuccess)
    return e;
  return sum_into(db_part, dbh2, 1, blocks, 4 * h, s);
}

}  // namespace

extern "C" {

// 1 when the kernels take this width H for dtype 0 = fp32 (a multiple of
// 16 whose states fit shared memory), 1 = bf16 (64, 128 or 256).
int lstm2_seq_fits(int dtype, int h) { return fits_dtype(dtype, h) ? 1 : 0; }

// fp32 workspace of the forward (floats): bf16's xw2 [B, U, 4H].
long long lstm2_seq_fwd_workspace(int dtype, int b, int u, int h) {
  return dtype == 1 ? (long long)b * u * 4 * h : 0;
}

// Shape checks are the caller's (ops/lstm.py). xw1 [B, U, 4H], weights
// [4H, H] in the compute type, bh2 [4H] fp32, y [B, U, H]. zs [2, B, U,
// 4H] and cs [2, B, U, H] fp32, hs and ds in the compute type: the states
// the backward reads, all null when no backward follows, except that the
// bf16 forward always writes ds: hs [2, B, U, H] (slot t holds the h that
// step t read, h[t - 1]; slot 0 zero), ds [B, U, H] (d[t]); ws holds
// lstm2_seq_fwd_workspace() floats.
int lstm2_seq_fwd(int dtype, const void* xw1, const void* wh1,
                  const void* wi2, const float* bh2, const void* wh2, void* y,
                  float* zs, float* cs, void* hs, void* ds, float* ws, int b,
                  int u, int h, unsigned key, int thresh, float scale,
                  unsigned row_base, int global_b, void* stream) {
  if (!fits_dtype(dtype, h)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Drop dp = make_drop(key, thresh, scale, 0u,
                            (unsigned)(global_b > 0 ? global_b : b), row_base);
  if (dtype == 0)
    return (int)launch_fwd_f32(
        static_cast<const float*>(xw1), static_cast<const float*>(wh1),
        static_cast<const float*>(wi2), bh2, static_cast<const float*>(wh2),
        static_cast<float*>(y), zs, cs, static_cast<float*>(hs),
        static_cast<float*>(ds), b, u, h, dp, s);
  auto run = h == 64    ? lstm16::fwd<64>
             : h == 128 ? lstm16::fwd<128>
                        : lstm16::fwd<256>;
  return (int)run(static_cast<const bf*>(xw1), static_cast<const bf*>(wh1),
                  static_cast<const bf*>(wi2), bh2,
                  static_cast<const bf*>(wh2), static_cast<bf*>(y), zs, cs,
                  static_cast<bf*>(hs), static_cast<bf*>(ds), ws, b, u, dp,
                  s);
}

// fp32 workspace of the backward (floats).
long long lstm2_seq_bwd_workspace(int dtype, int b, int u, int h) {
  if (dtype == 1) return lstm16::bwd_workspace(b, u, h);
  int splits, rows_per_split;
  f32_splits(b * u, h, &splits, &rows_per_split);
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
                  unsigned key, int thresh, float scale, unsigned row_base,
                  int global_b, void* stream) {
  if (!fits_dtype(dtype, h)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Drop dp = make_drop(key, thresh, scale, 0u,
                            (unsigned)(global_b > 0 ? global_b : b), row_base);
  if (dtype == 0)
    return (int)launch_bwd_f32(
        static_cast<const float*>(dy), static_cast<const float*>(wh1),
        static_cast<const float*>(wi2), static_cast<const float*>(wh2), zs,
        cs, static_cast<const float*>(hs), static_cast<const float*>(ds),
        static_cast<float*>(dxw1), dw, dbh2, ws, static_cast<float*>(dz2c),
        b, u, h, dp, s);
  auto run = h == 64    ? lstm16::bwd<64>
             : h == 128 ? lstm16::bwd<128>
                        : lstm16::bwd<256>;
  return (int)run(static_cast<const bf*>(dy), static_cast<const bf*>(wh1),
                  static_cast<const bf*>(wi2), static_cast<const bf*>(wh2),
                  zs, cs, static_cast<const bf*>(hs),
                  static_cast<const bf*>(ds), static_cast<bf*>(dxw1), dw,
                  dbh2, ws, static_cast<bf*>(dz2c), b, u, dp, s);
}

}  // extern "C"
