// RNN-T lattice for Hopper (sm_90a): alpha over the ascending
// anti-diagonals and beta over the descending ones, side by side.
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
// work, though, is a chain of T + U1 - 1 dependent diagonal steps for each
// of alpha and beta, and a step's instructions on one warp (about 70 at
// four cycles each, measured) set the time, not the bytes.
//
// Design. The TPU skews the planes to [t+u, b, u] so that a diagonal is one
// VPU tile; none of that is carried over. A lane holds columns u = c + 32 j
// (j < NC) of one chain's current diagonal in registers; the u - 1
// (alpha) and u + 1 (beta) neighbours come by warp shuffle.
//  1. Alpha and beta run at the same time, on warps of their own, so the
//     dependent chain is T + U1 - 1 steps, not twice that.
//  2. A step reads its plane values from shared memory, never from device
//     memory, by one of two plans, which rnnt_lattice() picks from the
//     row's size:
//     - staged, where a row's two planes and its alpha and beta fit
//       kStageMaxBytes and both directions' warps fit a block (the
//       training lattice: 70 KB a row, two rows an SM): one block a batch
//       row loads the row's planes into shared memory with coalesced
//       4-byte cp.async (a row starts 4-byte aligned only: no TMA) at an
//       even pitch P, so that a diagonal (a stride of P - 1 words) meets
//       32 banks, with a LOG_ZERO row -1 and column -1 so that alpha reads
//       its edges without a select. Its alpha and beta are written there
//       too and stored coalesced at the end: stored from the chain, one
//       32-byte sector a lane, they took 1.9x as long;
//     - ring, for the rest (wide rows, long T'; at the training shape it
//       took 1.9x the staged plan's time): one block a (batch row,
//       direction). Each lane keeps a ring of R = 8 diagonals of its own
//       inputs in shared memory (3 above U1 = 3200), filled by predicated
//       4-byte cp.async R - 1 steps ahead; a lane reads only what it
//       copied itself, so cp.async's per-thread wait_group orders it
//       without a barrier. Results go out from the chain.
//  3. A step has no branch: whatever does not depend on the diagonal is
//     computed before the loop, loads are clamped rather than skipped,
//     and lae runs on the MUFU's exp2 and log2. A lone warp pays for each
//     branch in full: the first version of this kernel spent ~1000 cycles
//     a step in about 25 of them.
//  4. Rows wider than 64 columns run a chain on W = ceil(U1 / 64) warps
//     (32 at most; columns split evenly). A warp takes the column across
//     its seam from its neighbour a block of kBlock steps late, through a
//     ring of values in shared memory: one handshake a block (progress
//     and acknowledgement counters), plain loads in between. A
//     warp with no cell of the plane in a block (a wide row's band is T
//     columns) skips its arithmetic.
//
// Plain C interface, bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr float kLogZero = -1.0e6f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxNC = 8;       // columns a lane: 256 a warp
constexpr int kMaxWarps = 32;   // warps of a chain: U1 <= 8192
constexpr int kWarpCols = 64;   // columns a warp while U1 <= 2048
constexpr int kBlock = 8;       // steps between two seam handshakes
constexpr int kSeamSlots = 32;  // seam values in flight between two warps
constexpr int kRingMaxBytes = 200 * 1024;   // ring of 8, else of 3
constexpr int kStageMaxBytes = 104 * 1024;  // two staged rows an SM

// lae on the MUFU's exp2 and log2 (flushing subnormals, which only
// arise where exp2 underflows to 0 anyway): with libm's expf and log1pf
// (log1pf branches) the training lattice takes 1.8x as long. Within the
// tolerances over chains of T' + U1 steps (PERF.md, K9's findings).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lae(float a, float b) {
  constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;
  return fmaf(kLn2, lg2(1.0f + ex2(-kLog2e * fabsf(a - b))), fmaxf(a, b));
}

// 4-byte cp.async into shared memory where p, predicated (no branch).
__device__ __forceinline__ void cp4(float* dst, const float* src, bool p) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q cp.async.ca.shared.global [%0], [%1], 4;\n}\n" ::"r"(
          (unsigned)__cvta_generic_to_shared(dst)),
      "l"(src), "r"((int)p)
      : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Seams {  // one direction's seam values, progress and acks
  float (*value)[kSeamSlots];  // [warp][step % kSeamSlots]
  int* done;  // [warp]: the last step whose seam value is published
  int* ack;   // [warp]: the last step it has consumed
};

// One chain (alpha if !BETA, else beta) of one batch row on warp k of W
// (MULTI: W > 1). Step s runs diagonal d = s (alpha) or D - s (beta); step
// 0 is the start (alpha: the cell (0, 0) = 0; beta: the all-LOG_ZERO
// diagonal D). R > 0: inputs from this chain's ring `ring` [R][2][32 NC W],
// filled from the row's planes gb / ge; R == 0: from the staged planes
// sb / se, cell (t, u) at t * P + u, row -1 and column -1 LOG_ZERO, and
// results into the staged plane `so` (same layout); R > 0: into `gout`.
template <int NC, int R, bool BETA, bool MULTI>
__device__ __forceinline__ void chain(
    const float* __restrict__ gb, const float* __restrict__ ge,
    const float* sb, const float* se, float* ring, float* __restrict__ gout,
    float* so, int P, int T, int U1, int tb, int ub, int k, int W,
    Seams seams) {
  constexpr int RR = R > 0 ? R : 1;  // ring slots (R == 0: unused)
  const int lane = threadIdx.x & 31;
  const int D = T + U1 - 1;
  const int last = BETA ? D : D - 1;
  const int d0 = BETA ? D : 0;  // step 0's diagonal
  const int ds = BETA ? -1 : 1; // d = d0 + ds * s
  const int cw = 32 * NC * W;
  const int up = BETA ? k + 1 : k - 1;    // warp the seam column comes from
  const int down = BETA ? k - 1 : k + 1;  // warp it goes to
  const bool has_up = up >= 0 && up < W, has_down = down >= 0 && down < W;
  const int tmin = min(T, tb);  // beta's valid rows
  // The warp's columns [c0, c0 + 32 NC) hold a cell of the plane on d iff
  // 0 <= d - c0 < wspan.
  const int c0 = 32 * NC * k;
  const int wspan = c0 < U1 ? T + min(c0 + 32 * NC - 1, U1 - 1) - c0 : 0;

  int u[NC], dterm[NC], o0[NC], g0[NC];
  bool col[NC], uok[NC], eok[NC], uterm[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    u[j] = c0 + 32 * j + lane;
    col[j] = u[j] < U1;
    uok[j] = col[j] && u[j] <= ub;   // beta: a valid column
    eok[j] = u[j] + 1 <= ub;         // beta: the emit edge to u + 1
    uterm[j] = u[j] == ub;           // beta: the terminal column
    dterm[j] = tb - 1 + u[j];        // beta: the diagonal of row tb - 1
    o0[j] = d0 * P - u[j] * (P - 1);    // t * P + u at step 0
    g0[j] = d0 * U1 - u[j] * (U1 - 1);  // t * U1 + u at step 0
  }
  auto in_plane = [&](int j, int d) {
    return (unsigned)(d - u[j]) < (unsigned)T && col[j];
  };

  // Copies step q's inputs into the ring: what the lane reads at step q
  // (alpha: blank[t-1, u], emit[t, u-1]; beta: blank[t, u], emit[t, u]
  // of its valid cells). Steps past the last copy nothing.
  auto issue = [&](int q) {
    const int d = d0 + ds * q;
    float* slot = ring + (q % RR) * 2 * cw;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int t = d - u[j];
      const bool live = q <= last;
      const bool p = live && (BETA ? (unsigned)t < (unsigned)tmin && uok[j]
                                   : in_plane(j, d));
      const int g = p ? g0[j] + ds * q * U1 : U1;  // U1: a safe address
      cp4(slot + u[j], gb + (BETA ? g : g - U1), p && (BETA || t >= 1));
      cp4(slot + cw + u[j], ge + (BETA ? g : g - 1),
          p && (BETA || u[j] >= 1));
    }
  };
  // Step q's inputs from the staged planes (alpha: blank[t-1, u] and
  // emit[t, u-1], LOG_ZERO off the plane's edge by the padding; beta:
  // blank[t, u], emit[t, u]); a lane off the plane reads the padding.
  auto fetch = [&](int q, float (&cb)[NC], float (&ce)[NC]) {
    const int d = d0 + ds * q;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int o = in_plane(j, d) ? o0[j] + ds * q * P : 0;
      cb[j] = sb[BETA ? o : o - P];
      ce[j] = se[BETA ? o : o - 1];
    }
  };
  auto put = [&](int j, int s, float v) {
    if constexpr (R == 0)
      so[o0[j] + ds * s * P] = v;
    else
      gout[g0[j] + ds * s * U1] = v;
  };
  auto spin_until = [](const int* flag, int at_least) {
    const volatile int* f = flag;
    while (*f < at_least) {
    }
    __threadfence_block();
  };

  float cur[NC], nb[NC], ne[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j)
    cur[j] = !BETA && u[j] == 0 ? 0.0f : kLogZero;
  if (!BETA && u[0] == 0) put(0, 0, 0.0f);
  if (MULTI && has_down && lane == (BETA ? 0 : 31))
    seams.value[k][0] = BETA ? cur[0] : cur[NC - 1];

  if constexpr (R > 0) {
#pragma unroll 1
    for (int q = 1; q < R; ++q) {
      issue(q);
      cp_commit();
    }
  } else {
    fetch(1, nb, ne);
  }

  // Blocks of kBlock steps; the steps past the last write nothing. A warp
  // takes its seam column from the one before it a block late: it waits
  // once a block for that warp's whole block, then reads plain values.
  const int blocks = (last + kBlock - 1) / kBlock;
#pragma unroll 1
  for (int bk = 0; bk < blocks; ++bk) {
    const int s0 = bk * kBlock + 1;
    bool act = true;
    if constexpr (MULTI) {
      if (has_up) spin_until(seams.done + up, s0 + kBlock - 1);
      // The slots this block writes were read a block after they were
      // written, kSeamSlots - kBlock steps ago.
      if (has_down) spin_until(seams.ack + down, s0 - kSeamSlots + kBlock);
      // A warp with no cell of the plane in the block (a wide row's band
      // is T columns) skips the arithmetic: its stale values reach no
      // valid cell.
      const int dlo = d0 + ds * (BETA ? s0 + kBlock - 1 : s0);
      act = (unsigned)(dlo - c0 + kBlock - 1) <
            (unsigned)(wspan + kBlock - 1);
    }
    // The block's steps, with (compute) or without their arithmetic.
    auto run_block = [&](auto compute) {
#pragma unroll
      for (int i = 0; i < kBlock; ++i) {
        const int s = s0 + i;
        const int d = d0 + ds * s;
        float in = kLogZero;
        if constexpr (MULTI)
          if (has_up) in = seams.value[up][(s - 1) & (kSeamSlots - 1)];
        float cb[NC], ce[NC];
        if constexpr (R > 0) {
          issue(s + R - 1);
          cp_commit();
          cp_wait<R - 1>();
          const float* slot = ring + (s % RR) * 2 * cw;
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            cb[j] = slot[u[j]];
            ce[j] = slot[cw + u[j]];
            if (!BETA) {  // off the plane's top row / first column
              cb[j] = d - u[j] >= 1 ? cb[j] : kLogZero;
              ce[j] = u[j] >= 1 ? ce[j] : kLogZero;
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            cb[j] = nb[j];
            ce[j] = ne[j];
          }
          fetch(s + 1, nb, ne);
        }
        if constexpr (decltype(compute)::value) {
          // Neighbours from the previous diagonal (alpha: u - 1; beta:
          // u + 1).
          float nbr[NC];
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            if (BETA) {
              const float down_ = __shfl_down_sync(kFull, cur[j], 1);
              const float seam =
                  j + 1 < NC
                      ? __shfl_sync(kFull, cur[j + 1 < NC ? j + 1 : j], 0)
                      : in;
              nbr[j] = lane == 31 ? seam : down_;
            } else {
              const float up_ = __shfl_up_sync(kFull, cur[j], 1);
              const float seam =
                  j > 0 ? __shfl_sync(kFull, cur[j > 0 ? j - 1 : 0], 31)
                        : in;
              nbr[j] = lane == 0 ? seam : up_;
            }
          }
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            const bool p = in_plane(j, d);
            float v;
            if (BETA) {
              const float vb = d < dterm[j] ? cb[j] + cur[j] : kLogZero;
              const float ve = eok[j] ? ce[j] + nbr[j] : kLogZero;
              const float l = lae(vb, ve);
              v = d == dterm[j] && uterm[j] ? cb[j] : l;
              v = (unsigned)(d - u[j]) < (unsigned)tmin && uok[j] ? v
                                                                 : kLogZero;
            } else {
              const float l = lae(cur[j] + cb[j], nbr[j] + ce[j]);
              v = p ? l : kLogZero;
            }
            cur[j] = v;
            if (p) put(j, s, v);
          }
        }
        if (MULTI && has_down && lane == (BETA ? 0 : 31))
          seams.value[k][s & (kSeamSlots - 1)] = BETA ? cur[0] : cur[NC - 1];
      }
    };
    if (act)
      run_block(std::true_type{});
    else
      run_block(std::false_type{});
    if constexpr (MULTI) {
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();  // the block's seam values before `done`
        const int s_end = s0 + kBlock - 1;
        if (has_down) *(volatile int*)(seams.done + k) = s_end;
        if (has_up) *(volatile int*)(seams.ack + k) = s_end;
      }
    }
  }
  if constexpr (R > 0) cp_wait<0>();
}

namespace k9 {

// Staged plan (R == 0): block b = one batch row; warps [0, W) alpha,
// [W, 2W) beta, the rest help load and store the planes. A staged plane
// (blank, emit, alpha, beta) holds (t, u) at P + 1 + t * P + u, its row -1
// and column -1 LOG_ZERO, in PL = (T + 1) P + 2 floats.
// Ring plan (R > 0): block 2 b + dir = one direction of row b on W warps.
template <int NC, int R, bool MULTI>
__global__ void __launch_bounds__(1024)
lattice(const float* __restrict__ blank, const float* __restrict__ emit,
        const int* __restrict__ tlen, const int* __restrict__ ulen,
        float* __restrict__ alpha, float* __restrict__ beta, int T, int U1,
        int W, int P) {
  extern __shared__ float4 dyn[];
  float* sm = reinterpret_cast<float*>(dyn);
  __shared__ float seamv[2][kMaxWarps][kSeamSlots];
  __shared__ int done[2][kMaxWarps], acks[2][kMaxWarps];
  const int b = R > 0 ? blockIdx.x >> 1 : blockIdx.x;
  const int warp = threadIdx.x / 32;
  const size_t base = (size_t)b * T * U1;
  const float* gb = blank + base;
  const float* ge = emit + base;
  const int n = T * U1, PL = (T + 1) * P + 2;
  if constexpr (MULTI) {
    for (int i = threadIdx.x; i < 2 * kMaxWarps; i += blockDim.x)
      (&done[0][0])[i] = (&acks[0][0])[i] = 0;
  }
  // (t, u) of flat index i = threadIdx.x, advanced by blockDim.x a turn.
  const int t0 = threadIdx.x / U1, u0 = threadIdx.x - t0 * U1;
  const int qt = blockDim.x / U1, qu = blockDim.x - qt * U1;
  float* sb = sm + P + 1;  // (0, 0) of each staged plane
  float* se = sb + PL;
  if constexpr (R == 0) {
    for (int i = threadIdx.x; i <= P; i += blockDim.x)  // row -1
      sm[i] = sm[PL + i] = kLogZero;
    for (int t = threadIdx.x; t < T; t += blockDim.x)   // column -1
      sm[(t + 1) * P] = sm[PL + (t + 1) * P] = kLogZero;
    int t = t0, u = u0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      cp4(sb + t * P + u, gb + i, true);
      cp4(se + t * P + u, ge + i, true);
      t += qt;
      u += qu;
      if (u >= U1) {
        u -= U1;
        ++t;
      }
    }
    cp_commit();
    cp_wait<0>();
  }
  __syncthreads();

  const int dir = R > 0 ? blockIdx.x & 1 : warp / W;
  const int k = R > 0 ? warp : warp - dir * W;
  if (dir < 2 && k < W) {
    Seams seams{seamv[dir], done[dir], acks[dir]};
    if (dir == 0)
      chain<NC, R, false, MULTI>(gb, ge, sb, se, sm, alpha + base,
                                      sb + 2 * PL, P, T, U1, 0, 0, k, W,
                                      seams);
    else
      chain<NC, R, true, MULTI>(gb, ge, sb, se, sm, beta + base,
                                     sb + 3 * PL, P, T, U1, tlen[b], ulen[b],
                                     k, W, seams);
  }
  if constexpr (R == 0) {
    __syncthreads();
    const float* sa = sb + 2 * PL;
    const float* sbt = sb + 3 * PL;
    float* ga = alpha + base;
    float* gbt = beta + base;
    int t = t0, u = u0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      ga[i] = sa[t * P + u];
      gbt[i] = sbt[t * P + u];
      t += qt;
      u += qu;
      if (u >= U1) {
        u -= U1;
        ++t;
      }
    }
  }
}

}  // namespace k9

template <typename K>
cudaError_t start(K kern, int R, const float* blank, const float* emit,
                  const int* tlen, const int* ulen, float* alpha, float* beta,
                  int B, int T, int U1, int W, int P, size_t smem,
                  cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int threads = R > 0 ? 32 * W : (2 * W < 4 ? 128 : 64 * W);
  kern<<<R > 0 ? 2 * B : B, threads, smem, s>>>(blank, emit, tlen, ulen,
                                                alpha, beta, T, U1, W, P);
  return cudaGetLastError();
}

template <int NC, int R>
cudaError_t go(const float* blank, const float* emit, const int* tlen,
               const int* ulen, float* alpha, float* beta, int B, int T,
               int U1, int W, int P, size_t smem, cudaStream_t s) {
  if constexpr (NC <= 2) {  // W == 1 takes U1 <= 64, so NC <= 2
    if (W == 1)
      return start(k9::lattice<NC, R, false>, R, blank, emit, tlen,
                   ulen, alpha, beta, B, T, U1, W, P, smem, s);
  }
  return start(k9::lattice<NC, R, true>, R, blank, emit, tlen, ulen,
               alpha, beta, B, T, U1, W, P, smem, s);
}

template <int NC>
cudaError_t launch(bool staged, const float* blank, const float* emit,
                   const int* tlen, const int* ulen, float* alpha,
                   float* beta, int B, int T, int U1, int W, int P,
                   cudaStream_t s) {
  const size_t plane = ((size_t)(T + 1) * P + 2) * sizeof(float);
  const size_t ring8 = (size_t)8 * 2 * 32 * NC * W * sizeof(float);
  const size_t ring3 = (size_t)3 * 2 * 32 * NC * W * sizeof(float);
  if constexpr (NC <= 2) {  // staged takes W <= 16, so U1 <= 1024, NC <= 2
    if (staged)
      return go<NC, 0>(blank, emit, tlen, ulen, alpha, beta, B, T, U1, W, P,
                       4 * plane, s);
  }
  if (ring8 <= (size_t)kRingMaxBytes)
    return go<NC, 8>(blank, emit, tlen, ulen, alpha, beta, B, T, U1, W, P,
                     ring8, s);
  return go<NC, 3>(blank, emit, tlen, ulen, alpha, beta, B, T, U1, W, P,
                   ring3, s);
}

}  // namespace

extern "C" {

// blank, emit, alpha, beta: [B, T, U1] fp32 contiguous; tlen, ulen: [B]
// int32; U1 <= 8192. Shape checks are the caller's. Returns a cudaError_t
// code; 0 is success.
int rnnt_lattice(const float* blank, const float* emit, const int* tlen,
                 const int* ulen, float* alpha, float* beta, int B, int T,
                 int U1, void* stream) {
  if (B < 0 || T < 1 || U1 < 1 || U1 > 32 * kMaxNC * kMaxWarps)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int W = min(kMaxWarps, (U1 + kWarpCols - 1) / kWarpCols);
  const int NC = (U1 + 32 * W - 1) / (32 * W);
  const int P = (U1 + 2) & ~1;  // even, and >= U1 + 1 for column -1
  // Staged where both directions' warps fit a block and the four planes
  // (with row -1 and column -1) fit kStageMaxBytes; W <= 16 keeps NC <= 2.
  const bool staged =
      2 * W <= kMaxWarps &&
      4 * ((size_t)(T + 1) * P + 2) * sizeof(float) <= (size_t)kStageMaxBytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (NC) {
    case 1: return (int)launch<1>(staged, blank, emit, tlen, ulen, alpha, beta, B, T, U1, W, P, s);
    case 2: return (int)launch<2>(staged, blank, emit, tlen, ulen, alpha, beta, B, T, U1, W, P, s);
    case 3: return (int)launch<3>(staged, blank, emit, tlen, ulen, alpha, beta, B, T, U1, W, P, s);
    case 4: return (int)launch<4>(staged, blank, emit, tlen, ulen, alpha, beta, B, T, U1, W, P, s);
    case 5: return (int)launch<5>(staged, blank, emit, tlen, ulen, alpha, beta, B, T, U1, W, P, s);
    case 6: return (int)launch<6>(staged, blank, emit, tlen, ulen, alpha, beta, B, T, U1, W, P, s);
    case 7: return (int)launch<7>(staged, blank, emit, tlen, ulen, alpha, beta, B, T, U1, W, P, s);
    default: return (int)launch<8>(staged, blank, emit, tlen, ulen, alpha, beta, B, T, U1, W, P, s);
  }
}

}  // extern "C"
