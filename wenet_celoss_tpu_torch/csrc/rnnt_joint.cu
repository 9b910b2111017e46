// Streaming RNN-T joint for Hopper (sm_90a): forward planes (K2) and their
// backward (K3).
//
// Replaces wenet_celoss_tpu/ops/rnnt_pallas.py::_joint_fwd_kernel
// (streaming_joint_planes_fwd) and ::_joint_bwd_kernel
// (streaming_joint_planes_bwd). For every lattice cell (b, t, u):
//
//   hidden = act(enc[b,t] + pred[b,u])                       [H]
//   logits = hidden @ W^T + bias                              [V]
//   K2:  lse = logsumexp(logits), blank_lp = logits[blank] - lse,
//        emit_lp = logits[label[b,u]] - lse                   (fp32)
//   K3:  p = exp(logits - lse),
//        dlogits = (gb + ge) p - gb 1[v = blank] - ge 1[v = label]
//        dpre = (T(dlogits) @ W) * act'(pre)
//        denc[b,t] = sum_u dpre,  dpred[b,u] = sum_t dpre,
//        dW = sum T(dlogits)^T hidden,  db = sum dlogits      (fp32)
//
// Rounding points are the JAX package's (ops/rnnt_loss.py, the XLA chunk
// scan the Pallas kernels were held to): pre = T(enc + pred) and every
// step of act and act' rounds to the compute type T (tanh' = T(1 - T(h*h))
// from the activation h); the GEMMs take T operands and accumulate in
// fp32; the softmax, dlogits and every sum stay fp32; dlogits is cast to T
// before its two GEMMs. Labels arrive as int32 [B, U] (the TPU kernel reads
// a [B, U1, V] one-hot); row U has no label and its emit_lp is left for
// the caller to overwrite. W arrives in torch.nn.Linear layout [V, H], so a
// V-tile is contiguous; dW leaves in the same layout.
//
// What bounds it: 2*N*H*V operations for K2 and three times that for K3
// (N = B*T*U1 cells) against O(N*H + H*V) bytes: both compute-bound
// (ops/bounds.py).
//
// Design, simple first. Cells are flattened as row = (b*T + t)*U1 + u.
// K2: a block owns R rows; it stages their hidden once in shared memory,
// then walks all V-tiles of VT columns: stages W[v0:v0+VT, :], computes
// the [R, VT] logits tile and folds it into a running max and sum of
// exponentials per row, picking up the blank and label columns as their
// tile passes. The [rows, V] logits never leave shared memory.
// K3: the TPU accumulates dW, db and dpred over a sequential grid; blocks
// here run at once, so the work is split in passes, with partials summed
// in a fixed order (deterministic, no atomics):
//   A (row-parallel): a block owns batch row b and TT frames, i.e. the
//     TT*U1 contiguous rows of those cells, in chunks of R rows: per chunk
//     it recomputes the logits V-tile by V-tile, forms T(dlogits) and
//     accumulates dpre = T(dlogits) @ W; then scales by act' and adds the
//     rows into denc[b, t] (owned) and into its own t-tile's partial of
//     dpred[b, u]. It also writes every row's hidden ([B*T*U1, H] in T,
//     a workspace) for pass B.
//   B (V-tile-parallel): a block owns VT columns and one of S row splits:
//     it stages W[v0:v0+VT] once, and per chunk of R rows copies the
//     hidden from pass A's workspace (no activation recomputed per
//     V-tile), recomputes the logits tile and dlogits, and accumulates
//     dW[v0:v0+VT] += T(dlogits)^T @ hidden and db. S is chosen so that
//     the blocks fill whole waves of the card's SMs.
//   R sums the dpred, dW and db partials in order.
// Rows past the end of the batch or of a block's range are zeros (p is
// forced to 0 there), so no padded frame is read. Tiles are staged with
// asynchronous 16-byte copies (cp.async), all in flight at once. bf16
// runs the GEMMs on the tensor cores (WMMA), with the dpre and dW
// accumulators held in registers across V-tiles or row chunks and the
// tiles sized so that two blocks share an SM; fp32 runs plain FMA with the
// accumulators in shared memory (tile_mma.cuh). Later work: wgmma, TMA
// with double-buffered tiles, computing the logits once for both passes.
//
// Plain C interface, bound with ctypes; each entry point returns
// cudaGetLastError().

#include "tile_mma.cuh"

namespace {

using namespace tile;

constexpr int kTT = 16;  // frames a pass-A block owns

// act: 0 tanh, 1 relu, 2 swish, each step rounded to T.
template <typename T>
__device__ __forceinline__ float act_fwd(float pre, int act) {
  if (act == 0) return rnd<T>(tanhf(pre));
  if (act == 1) return fmaxf(pre, 0.0f);
  const float s = rnd<T>(sigmoidf_(pre));
  return rnd<T>(pre * s);
}

// d act / d pre from pre and the activation h, each step rounded to T.
template <typename T>
__device__ __forceinline__ float act_grad(float pre, float h, int act) {
  if (act == 0) return rnd<T>(1.0f - rnd<T>(h * h));
  if (act == 1) return pre > 0.0f ? 1.0f : 0.0f;
  const float s = rnd<T>(sigmoidf_(pre));
  return rnd<T>(s * rnd<T>(1.0f + rnd<T>(pre * rnd<T>(1.0f - s))));
}

// Row padding (elements) that keeps rows 16-byte aligned and shifts banks.
template <typename T> __host__ __device__ constexpr int pad() {
  return 16 / (int)sizeof(T);
}

// 16 bytes from global to shared memory without passing through
// registers; src_bytes 0 writes zeros (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Copy rows [r0, r0 + rows) of src [*, h] into dst (row stride ld) in
// 16-byte asynchronous copies, all in flight at once; rows at or past
// r_end are zero. The caller's barrier makes them visible to the block.
template <typename T>
__device__ void stage_rows(const T* __restrict__ src, T* dst, int ld, int r0,
                           int rows, int r_end, int h) {
  constexpr int vec = 16 / sizeof(T);
  const int per = h / vec;
  for (int i = threadIdx.x; i < rows * per; i += kThreads) {
    const int r = i / per, k = (i % per) * vec;
    const bool in = r0 + r < r_end;
    cp_async16(dst + (size_t)r * ld + k,
               in ? src + (size_t)(r0 + r) * h + k : src, in ? 16 : 0);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// hidden of rows [row0, row0 + rows) of the flattened lattice into hid
// (row stride ld); rows at or past row_end are zero. With hid_out the
// hidden of each row also goes to hid_out[row, :].
template <typename T>
__device__ void stage_hidden(const T* __restrict__ enc,
                             const T* __restrict__ pred, T* hid,
                             T* __restrict__ hid_out, int ld, int row0,
                             int rows, int row_end, int t_max, int u1, int h,
                             int act) {
  for (int i = threadIdx.x; i < rows * h; i += kThreads) {
    const int r = i / h, k = i % h, row = row0 + r;
    float val = 0.0f;
    if (row < row_end) {
      const int u = row % u1, bt = row / u1, b = bt / t_max;
      const float pre = rnd<T>(to_f(enc[(size_t)bt * h + k]) +
                               to_f(pred[((size_t)b * u1 + u) * h + k]));
      val = act_fwd<T>(pre, act);
      if (hid_out != nullptr) hid_out[(size_t)row * h + k] = from_f<T>(val);
    }
    hid[(size_t)r * ld + k] = from_f<T>(val);
  }
}

// Per-row label (-1 for row U and past row_end) and, with gb given, the
// row's gb, ge and lse (0 past row_end).
__device__ void stage_meta(const int* __restrict__ labels,
                           const float* __restrict__ gb,
                           const float* __restrict__ ge,
                           const float* __restrict__ lse, int* lab,
                           float* gbs, float* ges, float* lses, int row0,
                           int rows, int row_end, int t_max, int u1) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int row = row0 + r;
    int l = -1;
    float a = 0.0f, e = 0.0f, s = 0.0f;
    if (row < row_end) {
      const int u = row % u1, b = row / u1 / t_max;
      if (u < u1 - 1) l = labels[(size_t)b * (u1 - 1) + u];
      if (gb != nullptr) {
        a = gb[row];
        e = ge[row];
        s = lse[row];
      }
    }
    lab[r] = l;
    if (gb != nullptr) {
      gbs[r] = a;
      ges[r] = e;
      lses[r] = s;
    }
  }
}

// Running (max, sum of exp(x - max)) merged with another such pair.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
    return;
  }
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// dlogits of one element (fp32); 0 for a row outside the range.
__device__ __forceinline__ float dlogit(float logit, float lse, float gb,
                                        float ge, int col, int blank,
                                        int label) {
  float d = (gb + ge) * expf(logit - lse);
  if (col == blank) d -= gb;
  if (col == label) d -= ge;
  return d;
}

// c[R x VT] = hid[R x H] * wt[VT x H]^T, a fresh product (fp32).
template <typename T, int R, int VT>
__device__ void logits_tile(float* c, int ldc, const T* hid, const T* wt,
                            int ldh, int h) {
  if constexpr (std::is_same<T, bf>::value) {
    constexpr int NF = frags_needed(R, VT);
    Acc acc[NF];
    frags_zero(acc);
    mma_frags<NF, true, false>(acc, hid, ldh, wt, ldh, R, VT, h);
    frags_store(acc, c, ldc, R, VT);
  } else {
    mma_acc<true, false, false>(c, ldc, hid, ldh, wt, ldh, R, VT, h);
  }
}

// Register-resident accumulator tiles per warp in the bf16 backward
// passes: an [R or VT, H] accumulator of 16-row tiles takes H <= 512.
constexpr int kMaxFrags = 8;

// ------------------------------------------------------------------ K2 ---
struct FwdLayout {
  int ldh, ldc;
  size_t o_w, o_c, o_lab, bytes;
};

template <typename T>
__host__ __device__ inline FwdLayout fwd_layout(int rows, int vt, int h) {
  FwdLayout L;
  L.ldh = h + pad<T>();
  L.ldc = vt + 4;
  size_t o = align128((size_t)rows * L.ldh * sizeof(T));
  L.o_w = o;
  o += align128((size_t)vt * L.ldh * sizeof(T));
  L.o_c = o;
  o += align128((size_t)rows * L.ldc * 4);
  L.o_lab = o;
  o += align128((size_t)rows * 4);
  L.bytes = o;
  return L;
}

template <typename T, int R, int VT>
__global__ void __launch_bounds__(kThreads, 2)
joint_fwd(const T* __restrict__ enc, const T* __restrict__ pred,
          const T* __restrict__ w, const float* __restrict__ bias,
          const int* __restrict__ labels, float* __restrict__ blank_lp,
          float* __restrict__ emit_lp, float* __restrict__ lse_out,
          int n_rows, int t_max, int u1, int h, int v, int blank, int act) {
  static_assert(kThreads % R == 0, "rows must divide the block");
  constexpr int Q = kThreads / R;  // threads per row in the softmax
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L = fwd_layout<T>(R, VT, h);
  T* hid = reinterpret_cast<T*>(smem);
  T* wt = reinterpret_cast<T*>(smem + L.o_w);
  float* c = reinterpret_cast<float*>(smem + L.o_c);
  int* lab = reinterpret_cast<int*>(smem + L.o_lab);
  const int row0 = blockIdx.x * R;
  stage_meta(labels, nullptr, nullptr, nullptr, lab, nullptr, nullptr,
             nullptr, row0, R, n_rows, t_max, u1);
  stage_hidden<T>(enc, pred, hid, nullptr, L.ldh, row0, R, n_rows, t_max,
                  u1, h, act);
  const int r = threadIdx.x / Q, q = threadIdx.x % Q;
  float m = -INFINITY, s = 0.0f, lb = 0.0f, le = 0.0f;
  for (int v0 = 0; v0 < v; v0 += VT) {
    __syncthreads();  // hidden staged; the last tile's logits read
    stage_rows<T>(w, wt, L.ldh, v0, VT, v, h);
    __syncthreads();
    logits_tile<T, R, VT>(c, L.ldc, hid, wt, L.ldh, h);
    __syncthreads();
    const int my_lab = lab[r];
    float tmax = -INFINITY;
    for (int j = q; j < VT && v0 + j < v; j += Q) {
      const float l = c[r * L.ldc + j] + bias[v0 + j];
      tmax = fmaxf(tmax, l);
      if (v0 + j == blank) lb = l;
      if (v0 + j == my_lab) le = l;
    }
    float ts = 0.0f;
    for (int j = q; j < VT && v0 + j < v; j += Q)
      ts += expf(c[r * L.ldc + j] + bias[v0 + j] - tmax);
    lse_merge(m, s, tmax, ts);
  }
  for (int o = Q / 2; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    lb += __shfl_xor_sync(0xffffffffu, lb, o);
    le += __shfl_xor_sync(0xffffffffu, le, o);
    lse_merge(m, s, m2, s2);
  }
  const int row = row0 + r;
  if (q == 0 && row < n_rows) {
    const float l = m + logf(s);
    lse_out[row] = l;
    blank_lp[row] = lb - l;
    emit_lp[row] = le - l;
  }
}

// ---------------------------------------------------------- K3 pass A ---
struct RowsLayout {
  int ldh, ldc, ldd, ldp;
  size_t o_w, o_c, o_d, o_p, o_meta, bytes;
};

// bf16 holds dpre in registers and writes it out once per chunk, into the
// W tile's space (free by then); fp32 accumulates it in a region of its
// own.
template <typename T>
__host__ __device__ inline RowsLayout rows_layout(int rows, int vt, int h) {
  RowsLayout L;
  L.ldh = h + pad<T>();
  L.ldc = vt + 4;
  L.ldd = vt + pad<T>();
  L.ldp = h + 4;
  size_t o = align128((size_t)rows * L.ldh * sizeof(T));
  L.o_w = o;
  const size_t w_bytes = align128((size_t)vt * L.ldh * sizeof(T));
  o += w_bytes;
  L.o_c = o;
  o += align128((size_t)rows * L.ldc * 4);
  L.o_d = o;
  o += align128((size_t)rows * L.ldd * sizeof(T));
  const size_t p_bytes = align128((size_t)rows * L.ldp * 4);
  if (sizeof(T) == 2 && p_bytes <= w_bytes) {
    L.o_p = L.o_w;
  } else {
    L.o_p = o;
    o += p_bytes;
  }
  L.o_meta = o;
  o += align128((size_t)rows * 16);
  L.bytes = o;
  return L;
}

template <typename T, int R, int VT>
__global__ void __launch_bounds__(kThreads, 2)
joint_bwd_rows(const T* __restrict__ enc, const T* __restrict__ pred,
               const T* __restrict__ w, const float* __restrict__ bias,
               const int* __restrict__ labels, const float* __restrict__ gb,
               const float* __restrict__ ge, const float* __restrict__ lse,
               float* __restrict__ denc, float* __restrict__ dpred_part,
               T* __restrict__ hid_out, int t_max, int u1, int h, int v,
               int blank, int act) {
  constexpr bool kBf = std::is_same<T, bf>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsLayout L = rows_layout<T>(R, VT, h);
  T* hid = reinterpret_cast<T*>(smem);
  T* wt = reinterpret_cast<T*>(smem + L.o_w);
  float* c = reinterpret_cast<float*>(smem + L.o_c);
  T* dlc = reinterpret_cast<T*>(smem + L.o_d);
  float* dpre = reinterpret_cast<float*>(smem + L.o_p);
  int* lab = reinterpret_cast<int*>(smem + L.o_meta);
  float* gbs = reinterpret_cast<float*>(lab + R);
  float* ges = gbs + R;
  float* lses = ges + R;
  const int tt = blockIdx.x, b = blockIdx.y, n_tt = gridDim.x;
  const int t0 = tt * kTT;
  const int tcount = min(kTT, t_max - t0);
  const int rows = tcount * u1;
  const int base = (b * t_max + t0) * u1;  // first flattened row
  float* denc_b = denc + ((size_t)b * t_max + t0) * h;
  float* dpred_b = dpred_part + ((size_t)b * n_tt + tt) * u1 * h;
  Acc acc[kBf ? kMaxFrags : 1];  // dpre's tiles (bf16)
  for (int i = threadIdx.x; i < tcount * h; i += kThreads) denc_b[i] = 0.0f;
  for (int i = threadIdx.x; i < u1 * h; i += kThreads) dpred_b[i] = 0.0f;
  for (int c0 = 0; c0 < rows; c0 += R) {
    __syncthreads();  // the last chunk's sums done
    stage_hidden<T>(enc, pred, hid, hid_out, L.ldh, base + c0, R,
                    base + rows, t_max, u1, h, act);
    stage_meta(labels, gb, ge, lse, lab, gbs, ges, lses, base + c0, R,
               base + rows, t_max, u1);
    if constexpr (kBf) {
      frags_zero(acc);
    } else {
      for (int i = threadIdx.x; i < R * h; i += kThreads)
        dpre[(i / h) * L.ldp + i % h] = 0.0f;
    }
    for (int v0 = 0; v0 < v; v0 += VT) {
      __syncthreads();  // the last tile's products done
      stage_rows<T>(w, wt, L.ldh, v0, VT, v, h);
      __syncthreads();
      logits_tile<T, R, VT>(c, L.ldc, hid, wt, L.ldh, h);
      __syncthreads();
      for (int i = threadIdx.x; i < R * VT; i += kThreads) {
        const int r = i / VT, j = i % VT, col = v0 + j;
        float d = 0.0f;
        if (c0 + r < rows && col < v)
          d = dlogit(c[r * L.ldc + j] + bias[col], lses[r], gbs[r], ges[r],
                     col, blank, lab[r]);
        dlc[r * L.ldd + j] = from_f<T>(d);
      }
      __syncthreads();
      if constexpr (kBf)
        mma_frags<kMaxFrags, true, true>(acc, dlc, L.ldd, wt, L.ldh, R, h,
                                         VT);
      else
        mma_acc<true, true>(dpre, L.ldp, dlc, L.ldd, wt, L.ldh, R, h, VT);
    }
    if constexpr (kBf) {
      __syncthreads();  // the W tile is read no more: dpre may use its space
      frags_store(acc, dpre, L.ldp, R, h);
    }
    __syncthreads();
    // dpre * act' into denc (a run of rows shares t) and dpred's partial;
    // each column belongs to one thread, rows added in order. The
    // pre-activation is recomputed (one rounding, as staged).
    const T* enc_b = enc + ((size_t)b * t_max + t0) * h;
    const T* pred_b = pred + (size_t)b * u1 * h;
    for (int k = threadIdx.x; k < h; k += kThreads) {
      int cur_t = -1;
      float run = 0.0f;
      for (int r = 0; r < R && c0 + r < rows; ++r) {
        const int i = c0 + r, tl = i / u1, u = i % u1;
        const float pre = rnd<T>(to_f(enc_b[(size_t)tl * h + k]) +
                                 to_f(pred_b[(size_t)u * h + k]));
        const float val = dpre[r * L.ldp + k] *
                          act_grad<T>(pre, to_f(hid[r * L.ldh + k]), act);
        if (tl != cur_t) {
          if (cur_t >= 0) denc_b[(size_t)cur_t * h + k] += run;
          cur_t = tl;
          run = 0.0f;
        }
        run += val;
        dpred_b[(size_t)u * h + k] += val;
      }
      if (cur_t >= 0) denc_b[(size_t)cur_t * h + k] += run;
    }
  }
}

// ---------------------------------------------------------- K3 pass B ---
struct WtsLayout {
  int ldh, ldc, ldd, ldp;
  size_t o_h, o_c, o_d, o_dw, o_db, o_meta, bytes;
};

// The fp32 form keeps its dW accumulator in shared memory; the bf16 form
// holds it in registers and has no such region.
template <typename T>
__host__ __device__ inline WtsLayout wts_layout(int rows, int vt, int h) {
  WtsLayout L;
  L.ldh = h + pad<T>();
  L.ldc = vt + 4;
  L.ldd = vt + pad<T>();
  L.ldp = h + 4;
  size_t o = align128((size_t)vt * L.ldh * sizeof(T));
  L.o_h = o;
  o += align128((size_t)rows * L.ldh * sizeof(T));
  L.o_c = o;
  o += align128((size_t)rows * L.ldc * 4);
  L.o_d = o;
  o += align128((size_t)rows * L.ldd * sizeof(T));
  L.o_dw = o;
  if (sizeof(T) == 4) o += align128((size_t)vt * L.ldp * 4);
  L.o_db = o;
  o += align128((size_t)vt * 4);
  L.o_meta = o;
  o += align128((size_t)rows * 16);
  L.bytes = o;
  return L;
}

template <typename T, int R, int VT>
__global__ void __launch_bounds__(kThreads, 2)
joint_bwd_weights(const T* __restrict__ hid_in, const T* __restrict__ w,
                  const float* __restrict__ bias,
                  const int* __restrict__ labels,
                  const float* __restrict__ gb, const float* __restrict__ ge,
                  const float* __restrict__ lse, float* __restrict__ dw_part,
                  float* __restrict__ db_part, int n_rows,
                  int rows_per_split, int t_max, int u1, int h, int v,
                  int v_pad, int blank) {
  constexpr bool kBf = std::is_same<T, bf>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const WtsLayout L = wts_layout<T>(R, VT, h);
  T* wt = reinterpret_cast<T*>(smem);
  T* hid = reinterpret_cast<T*>(smem + L.o_h);
  float* c = reinterpret_cast<float*>(smem + L.o_c);
  T* dlc = reinterpret_cast<T*>(smem + L.o_d);
  float* dw = reinterpret_cast<float*>(smem + L.o_dw);  // fp32 only
  float* db = reinterpret_cast<float*>(smem + L.o_db);
  int* lab = reinterpret_cast<int*>(smem + L.o_meta);
  float* gbs = reinterpret_cast<float*>(lab + R);
  float* ges = gbs + R;
  float* lses = ges + R;
  const int v0 = blockIdx.x * VT, split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n_rows, r_begin + rows_per_split);
  Acc acc[kBf ? kMaxFrags : 1];  // dW's tiles (bf16)
  stage_rows<T>(w, wt, L.ldh, v0, VT, v, h);
  if constexpr (kBf) {
    frags_zero(acc);
  } else {
    for (int i = threadIdx.x; i < VT * h; i += kThreads)
      dw[(i / h) * L.ldp + i % h] = 0.0f;
  }
  for (int j = threadIdx.x; j < VT; j += kThreads) db[j] = 0.0f;
  for (int row0 = r_begin; row0 < r_end; row0 += R) {
    __syncthreads();  // the last chunk's products done
    stage_rows<T>(hid_in, hid, L.ldh, row0, R, r_end, h);
    stage_meta(labels, gb, ge, lse, lab, gbs, ges, lses, row0, R, r_end,
               t_max, u1);
    __syncthreads();
    logits_tile<T, R, VT>(c, L.ldc, hid, wt, L.ldh, h);
    __syncthreads();
    for (int i = threadIdx.x; i < R * VT; i += kThreads) {
      const int r = i / VT, j = i % VT, col = v0 + j;
      float d = 0.0f;
      if (row0 + r < r_end && col < v)
        d = dlogit(c[r * L.ldc + j] + bias[col], lses[r], gbs[r], ges[r],
                   col, blank, lab[r]);
      c[r * L.ldc + j] = d;
      dlc[r * L.ldd + j] = from_f<T>(d);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < VT; j += kThreads) {
      float s = db[j];
      for (int r = 0; r < R; ++r) s += c[r * L.ldc + j];
      db[j] = s;
    }
    if constexpr (kBf)
      mma_frags<kMaxFrags, false, true>(acc, dlc, L.ldd, hid, L.ldh, VT, h,
                                        R);
    else
      mma_acc<false, true>(dw, L.ldp, dlc, L.ldd, hid, L.ldh, VT, h, R);
  }
  __syncthreads();
  // This split's dW rows [v0, v0 + VT) of a [v_pad, H] partial; rows past
  // V are zero and never summed.
  float* out = dw_part + ((size_t)split * v_pad + v0) * h;
  if constexpr (kBf) {
    frags_store(acc, out, h, VT, h);
  } else {
    for (int i = threadIdx.x; i < VT * h; i += kThreads)
      out[i] = dw[(i / h) * L.ldp + i % h];
  }
  for (int j = threadIdx.x; j < VT; j += kThreads)
    if (v0 + j < v) db_part[(size_t)split * v + v0 + j] = db[j];
}

// Tile shapes per compute type: rows and V-columns of K2, pass A, pass B.
template <typename T> struct Tiles;
template <> struct Tiles<bf> {
  static constexpr int kFwdR = 64, kFwdVT = 32;
  static constexpr int kRowsR = 32, kRowsVT = 64;
  static constexpr int kWtsR = 64, kWtsVT = 32;
};
template <> struct Tiles<float> {
  static constexpr int kFwdR = 32, kFwdVT = 32;
  static constexpr int kRowsR = 16, kRowsVT = 32;
  static constexpr int kWtsR = 32, kWtsVT = 16;
};

template <typename T>
bool fits(int h) {
  using K = Tiles<T>;
  if (std::is_same<T, bf>::value &&
      (frags_needed(K::kRowsR, h) > kMaxFrags ||
       frags_needed(K::kWtsVT, h) > kMaxFrags))
    return false;
  return fwd_layout<T>(K::kFwdR, K::kFwdVT, h).bytes <= kMaxSmem &&
         rows_layout<T>(K::kRowsR, K::kRowsVT, h).bytes <= kMaxSmem &&
         wts_layout<T>(K::kWtsR, K::kWtsVT, h).bytes <= kMaxSmem;
}

// Pass B's grid: V-tiles x S row splits, each split a whole number of
// R-row chunks, none empty. A block's time is about proportional to its
// rows, so the run takes about ceil(tiles * S / slots) waves of N / S
// rows each (slots: the blocks the card holds at once); S <= 16 minimises
// that, the smallest S on a tie.
struct Splits {
  int splits, rows_per_split, v_pad;
};

template <typename T>
cudaError_t wts_splits(int n_rows, int h, int v, Splits* sp) {
  using K = Tiles<T>;
  auto kb = joint_bwd_weights<T, K::kWtsR, K::kWtsVT>;
  const size_t bytes = wts_layout<T>(K::kWtsR, K::kWtsVT, h).bytes;
  cudaError_t e = set_smem(kb, bytes);  // also pass B's launch setting
  int dev = 0, sms = 1, per_sm = 1;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kb, kThreads,
                                                      bytes);
  if (e != cudaSuccess) return e;
  const int slots = sms * (per_sm > 0 ? per_sm : 1);
  const int tiles = (v + K::kWtsVT - 1) / K::kWtsVT;
  const int chunks = (n_rows + K::kWtsR - 1) / K::kWtsR;
  int best = 1;
  long long best_num = 1, best_den = 0;  // waves / splits, as a fraction
  for (int s = 1; s <= 16 && s <= chunks; ++s) {
    const long long waves = ((long long)tiles * s + slots - 1) / slots;
    if (best_den == 0 || waves * best_den < best_num * s) {
      best = s;
      best_num = waves;
      best_den = s;
    }
  }
  const int per = (chunks + best - 1) / best;
  sp->rows_per_split = per * K::kWtsR;
  sp->splits = (n_rows + sp->rows_per_split - 1) / sp->rows_per_split;
  if (sp->splits < 1) sp->splits = 1;
  sp->v_pad = tiles * K::kWtsVT;
  return cudaSuccess;
}

// The backward's fp32 workspace, in floats, each part 256-byte aligned:
// the hidden [B*T*U1, H] in T, dpred's partials, dW's and db's.
struct Workspace {
  size_t hid, dpred, dw, db, total;
};

inline size_t round64(size_t n) { return (n + 63) / 64 * 64; }

template <typename T>
Workspace workspace(int b, int t, int u1, int h, int v, const Splits& sp) {
  const size_t n_rows = (size_t)b * t * u1;
  const size_t n_tt = (t + kTT - 1) / kTT;
  Workspace W;
  W.hid = 0;
  W.dpred = round64((n_rows * h * sizeof(T) + 3) / 4);
  W.dw = W.dpred + round64((size_t)b * n_tt * u1 * h);
  W.db = W.dw + round64((size_t)sp.splits * sp.v_pad * h);
  W.total = W.db + round64((size_t)sp.splits * v);
  return W;
}

template <typename T>
cudaError_t launch_fwd(const void* enc, const void* pred, const void* w,
                       const float* bias, const int* labels, float* blank_lp,
                       float* emit_lp, float* lse, int b, int t, int u1,
                       int h, int v, int blank, int act, cudaStream_t s) {
  using K = Tiles<T>;
  const int n_rows = b * t * u1;
  auto kernel = joint_fwd<T, K::kFwdR, K::kFwdVT>;
  const size_t bytes = fwd_layout<T>(K::kFwdR, K::kFwdVT, h).bytes;
  cudaError_t e = set_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<(n_rows + K::kFwdR - 1) / K::kFwdR, kThreads, bytes, s>>>(
      static_cast<const T*>(enc), static_cast<const T*>(pred),
      static_cast<const T*>(w), bias, labels, blank_lp, emit_lp, lse,
      n_rows, t, u1, h, v, blank, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* enc, const void* pred, const void* w,
                       const float* bias, const int* labels, const float* gb,
                       const float* ge, const float* lse, float* denc,
                       float* dpred, float* dw, float* db, float* ws, int b,
                       int t, int u1, int h, int v, int blank, int act,
                       cudaStream_t s) {
  using K = Tiles<T>;
  const int n_rows = b * t * u1;
  const int n_tt = (t + kTT - 1) / kTT;
  Splits sp;
  cudaError_t e = wts_splits<T>(n_rows, h, v, &sp);
  if (e != cudaSuccess) return e;
  const Workspace W = workspace<T>(b, t, u1, h, v, sp);
  T* hid = reinterpret_cast<T*>(ws + W.hid);
  float* dpred_part = ws + W.dpred;
  float* dw_part = ws + W.dw;
  float* db_part = ws + W.db;
  auto ka = joint_bwd_rows<T, K::kRowsR, K::kRowsVT>;
  auto kb = joint_bwd_weights<T, K::kWtsR, K::kWtsVT>;
  const size_t a_bytes = rows_layout<T>(K::kRowsR, K::kRowsVT, h).bytes;
  const size_t b_bytes = wts_layout<T>(K::kWtsR, K::kWtsVT, h).bytes;
  if ((e = set_smem(ka, a_bytes)) != cudaSuccess) return e;
  const T* enc_t = static_cast<const T*>(enc);
  const T* pred_t = static_cast<const T*>(pred);
  const T* w_t = static_cast<const T*>(w);
  ka<<<dim3(n_tt, b), kThreads, a_bytes, s>>>(enc_t, pred_t, w_t, bias,
                                              labels, gb, ge, lse, denc,
                                              dpred_part, hid, t, u1, h, v,
                                              blank, act);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  kb<<<dim3(sp.v_pad / K::kWtsVT, sp.splits), kThreads, b_bytes, s>>>(
      hid, w_t, bias, labels, gb, ge, lse, dw_part, db_part, n_rows,
      sp.rows_per_split, t, u1, h, v, sp.v_pad, blank);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = sum_into(dpred_part, dpred, b, n_tt, u1 * h, s)) != cudaSuccess)
    return e;
  if ((e = sum_into(dw_part, dw, 1, sp.splits, v * h, s,
                    (size_t)sp.v_pad * h)) != cudaSuccess)
    return e;
  return sum_into(db_part, db, 1, sp.splits, v, s);
}

}  // namespace

extern "C" {

// fp32 workspace of the backward (floats) for dtype 0 = fp32, 1 = bf16;
// 0 when the tiles of this width H do not fit, -1 on a CUDA error.
long long rnnt_joint_bwd_workspace(int dtype, int b, int t, int u1, int h,
                                   int v) {
  if (!(dtype == 1 ? fits<bf>(h) : fits<float>(h))) return 0;
  Splits sp;
  const cudaError_t e = dtype == 1 ? wts_splits<bf>(b * t * u1, h, v, &sp)
                                   : wts_splits<float>(b * t * u1, h, v, &sp);
  if (e != cudaSuccess) return -1;
  return (long long)(dtype == 1 ? workspace<bf>(b, t, u1, h, v, sp)
                                : workspace<float>(b, t, u1, h, v, sp))
      .total;
}

// Shape checks are the caller's (ops/rnnt_loss.py). act: 0 tanh, 1 relu,
// 2 swish. labels int32 [B, U1 - 1]; planes [B, T, U1] fp32.
int rnnt_joint_fwd(int dtype, int act, const void* enc, const void* pred,
                   const void* w, const float* bias, const int* labels,
                   float* blank_lp, float* emit_lp, float* lse, int b, int t,
                   int u1, int h, int v, int blank, void* stream) {
  if (!(dtype == 1 ? fits<bf>(h) : fits<float>(h)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
                   ? launch_fwd<bf>(enc, pred, w, bias, labels, blank_lp,
                                    emit_lp, lse, b, t, u1, h, v, blank, act,
                                    s)
                   : launch_fwd<float>(enc, pred, w, bias, labels, blank_lp,
                                       emit_lp, lse, b, t, u1, h, v, blank,
                                       act, s));
}

// gb, ge [B, T, U1] fp32 (0 on invalid cells), lse from the forward; denc
// [B, T, H], dpred [B, U1, H], dw [V, H], db [V] fp32; ws holds
// rnnt_joint_bwd_workspace() floats.
int rnnt_joint_bwd(int dtype, int act, const void* enc, const void* pred,
                   const void* w, const float* bias, const int* labels,
                   const float* gb, const float* ge, const float* lse,
                   float* denc, float* dpred, float* dw, float* db, float* ws,
                   int b, int t, int u1, int h, int v, int blank,
                   void* stream) {
  if (rnnt_joint_bwd_workspace(dtype, b, t, u1, h, v) <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
                   ? launch_bwd<bf>(enc, pred, w, bias, labels, gb, ge, lse,
                                    denc, dpred, dw, db, ws, b, t, u1, h, v,
                                    blank, act, s)
                   : launch_bwd<float>(enc, pred, w, bias, labels, gb, ge,
                                       lse, denc, dpred, dw, db, ws, b, t, u1,
                                       h, v, blank, act, s));
}

}  // extern "C"
