// RNN-T lattice for Hopper (sm_90a): alpha over the ascending
// anti-diagonals, then beta over the descending ones, in one launch.
//
// Replaces wenet_celoss_tpu/ops/rnnt_pallas.py::_lattice_kernel (the
// pallas_call of alpha_beta_pallas), with its semantics:
//
//   alpha[t,u] = lae(alpha[t-1,u] + blank[t-1,u], alpha[t,u-1] + emit[t,u-1])
//   alpha[0,0] = 0; masked by t < T only (not by the lengths);
//   beta[t,u]  = lae(blank[t,u] + beta[t+1,u]  if t + 1 < T_b,
//                    emit[t,u]  + beta[t,u+1]  if u + 1 <= U_b)
//   beta[T_b-1, U_b] = blank[T_b-1, U_b] (the final blank); masked by
//   t < T_b and u <= U_b;
//
// every invalid cell exactly LOG_ZERO (-1e6) and
// lae(a, b) = max(a, b) + log1p(exp(-|a - b|)).
//
// What bounds it: the bytes are 16 a cell (two planes in, two out), 4.3 MB
// at B=256, T=127, U1=33, so 0.0051 ms at 3.35 TB/s (ops/bounds.py). The
// work, though, is a chain of T + U1 - 1 dependent diagonal steps each way
// (2 x 159 at that shape), so the latency of one step (a shuffle, an exp, a
// log1p and a select) times the steps sets the time, not the bytes.
//
// Design: the TPU skews the planes to [t+u, b, u] and pads them to (8, 128)
// tiles so that a diagonal is one VPU tile; none of that is carried over.
// One warp owns one batch row (rows are independent: no cross-warp
// reduction) and reads and writes the unskewed [B, T, U1] planes directly.
// Lane l holds columns u = l + 32 j (j < NC = ceil(U1 / 32)) of the current
// diagonal in registers; the u - 1 (alpha) and u + 1 (beta) neighbours
// come by warp shuffle, across the 32-column seam from lane 31 or lane 0
// of the neighbouring register. The plane values of the next diagonal are
// loaded while the current one is computed, so the loads' latency leaves
// the dependent chain.
//
// Rows wider than a warp's 256 columns (U1 > 256): one block a batch row,
// ceil(U1 / 256) warps, warp k holding columns [256 k, 256 k + 256) as
// above. The column that crosses a warp seam (alpha's u - 1, beta's u + 1
// from the previous diagonal) goes through shared memory: each warp
// publishes its edge value of a diagonal into one of two buffers (by the
// diagonal's parity) and one block barrier a diagonal orders the writes
// before the neighbour's read. A block holds at most 32 warps, so U1 <=
// 8192. Plain C interface, bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kLogZero = -1.0e6f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 2;     // batch rows per block
constexpr int kMaxNC = 8;     // columns per lane: 256 a warp
constexpr int kMaxWarps = 32; // warps of a wide row: U1 <= 8192

__device__ __forceinline__ float lae(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

// Alpha's inputs of diagonal d at column u (t = d - u): blank[t-1, u] and
// emit[t, u-1], LOG_ZERO off the plane.
template <int NC>
__device__ __forceinline__ void load_alpha(const float* bl, const float* em,
                                           int d, int lane, int T, int U1,
                                           float (&cb)[NC], float (&ce)[NC]) {
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int u = lane + 32 * j, t = d - u;
    const bool col = u < U1;
    cb[j] = col && t >= 1 && t <= T ? __ldg(bl + (t - 1) * U1 + u)
                                    : kLogZero;
    ce[j] = col && u >= 1 && t >= 0 && t < T ? __ldg(em + t * U1 + u - 1)
                                             : kLogZero;
  }
}

// Beta's inputs of diagonal d at column u: blank[t, u] and emit[t, u].
template <int NC>
__device__ __forceinline__ void load_beta(const float* bl, const float* em,
                                          int d, int lane, int T, int U1,
                                          float (&cb)[NC], float (&ce)[NC]) {
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int u = lane + 32 * j, t = d - u;
    const bool in = u < U1 && t >= 0 && t < T;
    cb[j] = in ? __ldg(bl + t * U1 + u) : kLogZero;
    ce[j] = in ? __ldg(em + t * U1 + u) : kLogZero;
  }
}

template <int NC>
__global__ void __launch_bounds__(32 * kWarps)
lattice(const float* __restrict__ blank, const float* __restrict__ emit,
        const int* __restrict__ tlen, const int* __restrict__ ulen,
        float* __restrict__ alpha, float* __restrict__ beta, int B, int T,
        int U1) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + threadIdx.x / 32;
  if (b >= B) return;  // whole warps leave together
  const size_t base = (size_t)b * T * U1;
  const float* bl = blank + base;
  const float* em = emit + base;
  float* al = alpha + base;
  float* be = beta + base;
  const int D = T + U1 - 1;
  float cur[NC], cb[NC], ce[NC], nb[NC], ne[NC];

  // ---- alpha: diagonal 0 holds the one cell (0, 0) = 0.
#pragma unroll
  for (int j = 0; j < NC; ++j) cur[j] = lane + 32 * j == 0 ? 0.0f : kLogZero;
  if (lane == 0) al[0] = 0.0f;
  if (D > 1) load_alpha<NC>(bl, em, 1, lane, T, U1, nb, ne);
  for (int d = 1; d < D; ++d) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      cb[j] = nb[j];
      ce[j] = ne[j];
    }
    if (d + 1 < D) load_alpha<NC>(bl, em, d + 1, lane, T, U1, nb, ne);
    float left[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float up = __shfl_up_sync(kFull, cur[j], 1);
      const float seam = __shfl_sync(kFull, j > 0 ? cur[j - 1] : kLogZero,
                                     31);
      left[j] = lane == 0 ? seam : up;
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int u = lane + 32 * j, t = d - u;
      const bool valid = u < U1 && t >= 0 && t < T;
      const float v = lae(cur[j] + cb[j], left[j] + ce[j]);
      cur[j] = valid ? v : kLogZero;
      if (valid) al[t * U1 + u] = cur[j];
    }
  }

  // ---- beta: descending; the diagonal past the last is all LOG_ZERO.
  const int tb = tlen[b], ub = ulen[b];
#pragma unroll
  for (int j = 0; j < NC; ++j) cur[j] = kLogZero;
  load_beta<NC>(bl, em, D - 1, lane, T, U1, nb, ne);
  for (int d = D - 1; d >= 0; --d) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      cb[j] = nb[j];
      ce[j] = ne[j];
    }
    if (d > 0) load_beta<NC>(bl, em, d - 1, lane, T, U1, nb, ne);
    float right[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float down = __shfl_down_sync(kFull, cur[j], 1);
      const float seam =
          __shfl_sync(kFull, j + 1 < NC ? cur[j + 1] : kLogZero, 0);
      right[j] = lane == 31 ? seam : down;
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int u = lane + 32 * j, t = d - u;
      const float vb = t + 1 < tb ? cb[j] + cur[j] : kLogZero;
      const float ve = u + 1 <= ub ? ce[j] + right[j] : kLogZero;
      float v = t == tb - 1 && u == ub ? cb[j] : lae(vb, ve);
      const bool valid = u < U1 && t >= 0 && t < tb && u <= ub;
      cur[j] = valid ? v : kLogZero;
      if (u < U1 && t >= 0 && t < T) be[t * U1 + u] = cur[j];
    }
  }
}

// A batch row wider than 256 columns: block b, blockDim.x / 32 warps, warp
// k holding columns [256 k, 256 k + 256); the seam columns cross between
// warps through `edge` (see the header). load_alpha / load_beta take the
// lane's first column in place of the lane.
__global__ void __launch_bounds__(32 * kMaxWarps)
lattice_wide(const float* __restrict__ blank, const float* __restrict__ emit,
             const int* __restrict__ tlen, const int* __restrict__ ulen,
             float* __restrict__ alpha, float* __restrict__ beta, int T,
             int U1) {
  constexpr int NC = kMaxNC;
  __shared__ float edge[2][kMaxWarps];
  const int lane = threadIdx.x & 31, k = threadIdx.x / 32;
  const int warps = blockDim.x / 32, col = 32 * NC * k + lane;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * T * U1;
  const float* bl = blank + base;
  const float* em = emit + base;
  float* al = alpha + base;
  float* be = beta + base;
  const int D = T + U1 - 1;
  float cur[NC], cb[NC], ce[NC], nb[NC], ne[NC];

  // ---- alpha: diagonal 0 holds the one cell (0, 0) = 0.
#pragma unroll
  for (int j = 0; j < NC; ++j) cur[j] = col + 32 * j == 0 ? 0.0f : kLogZero;
  if (threadIdx.x == 0) al[0] = 0.0f;
  if (lane == 31) edge[0][k] = cur[NC - 1];
  __syncthreads();
  if (D > 1) load_alpha<NC>(bl, em, 1, col, T, U1, nb, ne);
  for (int d = 1; d < D; ++d) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      cb[j] = nb[j];
      ce[j] = ne[j];
    }
    if (d + 1 < D) load_alpha<NC>(bl, em, d + 1, col, T, U1, nb, ne);
    const float in = k > 0 ? edge[(d - 1) & 1][k - 1] : kLogZero;
    float left[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float up = __shfl_up_sync(kFull, cur[j], 1);
      const float seam = j > 0 ? __shfl_sync(kFull, cur[j > 0 ? j - 1 : 0],
                                             31)
                               : in;
      left[j] = lane == 0 ? seam : up;
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int u = col + 32 * j, t = d - u;
      const bool valid = u < U1 && t >= 0 && t < T;
      const float v = lae(cur[j] + cb[j], left[j] + ce[j]);
      cur[j] = valid ? v : kLogZero;
      if (valid) al[t * U1 + u] = cur[j];
    }
    if (lane == 31) edge[d & 1][k] = cur[NC - 1];
    __syncthreads();
  }

  // ---- beta: descending; the diagonal past the last is all LOG_ZERO.
  const int tb = tlen[b], ub = ulen[b];
#pragma unroll
  for (int j = 0; j < NC; ++j) cur[j] = kLogZero;
  if (lane == 0) edge[D & 1][k] = kLogZero;
  __syncthreads();
  load_beta<NC>(bl, em, D - 1, col, T, U1, nb, ne);
  for (int d = D - 1; d >= 0; --d) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      cb[j] = nb[j];
      ce[j] = ne[j];
    }
    if (d > 0) load_beta<NC>(bl, em, d - 1, col, T, U1, nb, ne);
    const float in = k + 1 < warps ? edge[(d + 1) & 1][k + 1] : kLogZero;
    float right[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float down = __shfl_down_sync(kFull, cur[j], 1);
      const float seam =
          j + 1 < NC ? __shfl_sync(kFull, cur[j + 1 < NC ? j + 1 : j], 0)
                     : in;
      right[j] = lane == 31 ? seam : down;
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int u = col + 32 * j, t = d - u;
      const float vb = t + 1 < tb ? cb[j] + cur[j] : kLogZero;
      const float ve = u + 1 <= ub ? ce[j] + right[j] : kLogZero;
      float v = t == tb - 1 && u == ub ? cb[j] : lae(vb, ve);
      const bool valid = u < U1 && t >= 0 && t < tb && u <= ub;
      cur[j] = valid ? v : kLogZero;
      if (u < U1 && t >= 0 && t < T) be[t * U1 + u] = cur[j];
    }
    if (lane == 0) edge[d & 1][k] = cur[0];
    __syncthreads();
  }
}

template <int NC>
cudaError_t launch(const float* blank, const float* emit, const int* tlen,
                   const int* ulen, float* alpha, float* beta, int B, int T,
                   int U1, cudaStream_t s) {
  lattice<NC><<<(B + kWarps - 1) / kWarps, 32 * kWarps, 0, s>>>(
      blank, emit, tlen, ulen, alpha, beta, B, T, U1);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// blank, emit, alpha, beta: [B, T, U1] fp32 contiguous; tlen, ulen: [B]
// int32; U1 <= 8192. Shape checks are the caller's (ops/rnnt_loss.py).
// Returns a cudaError_t code; 0 is success.
int rnnt_lattice(const float* blank, const float* emit, const int* tlen,
                 const int* ulen, float* alpha, float* beta, int B, int T,
                 int U1, void* stream) {
  if (B < 0 || T < 1 || U1 < 1 || U1 > 32 * kMaxNC * kMaxWarps)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (U1 > 32 * kMaxNC) {
    const int warps = (U1 + 32 * kMaxNC - 1) / (32 * kMaxNC);
    lattice_wide<<<B, 32 * warps, 0, s>>>(blank, emit, tlen, ulen, alpha,
                                          beta, T, U1);
    return (int)cudaGetLastError();
  }
  switch ((U1 + 31) / 32) {
    case 1: return (int)launch<1>(blank, emit, tlen, ulen, alpha, beta, B, T, U1, s);
    case 2: return (int)launch<2>(blank, emit, tlen, ulen, alpha, beta, B, T, U1, s);
    case 3: return (int)launch<3>(blank, emit, tlen, ulen, alpha, beta, B, T, U1, s);
    case 4: return (int)launch<4>(blank, emit, tlen, ulen, alpha, beta, B, T, U1, s);
    case 5: return (int)launch<5>(blank, emit, tlen, ulen, alpha, beta, B, T, U1, s);
    case 6: return (int)launch<6>(blank, emit, tlen, ulen, alpha, beta, B, T, U1, s);
    case 7: return (int)launch<7>(blank, emit, tlen, ulen, alpha, beta, B, T, U1, s);
    default: return (int)launch<8>(blank, emit, tlen, ulen, alpha, beta, B, T, U1, s);
  }
}

}  // extern "C"
