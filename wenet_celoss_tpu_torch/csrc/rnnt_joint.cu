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
// What bounds it: K2 is one GEMM of 2*N*H*V operations (N = B*T*U1
// cells), K3 three (ops/bounds.py), against O(N*H + H*V) bytes: both are
// compute-bound (5.49 TFLOP for K2 at B=256, T=127, U1=33, H=512,
// V=5002). Beside the products every logit takes an exponential and a few
// fp32 operations, and every block reads all of W (or, in K3's pass B, a
// row split of the hidden) from L2.
//
// bf16 (namespace j16, H in {128, 512}): wgmma and TMA (sm90_gmma.cuh),
// every sum in registers. Cells are flattened as row = (b*T + t)*U1 + u.
// V is padded to the tile: TMA reads W's rows past V as zeros and their
// bias is -inf, so their p is exactly 0 with no branch, no one-hot reaches
// them, and no gradient row past V is summed.
//
// K2 (j16::joint_fwd): a block of two warpgroups owns 128 rows and forms
// their hidden once, bf16 in a K-major 128B-swizzled tile (128 KB at
// H = 512). TMA streams W in [128 x 64] k-chunks through a ring of
// mbarrier-guarded stages; the last warp to release a stage refills it (a
// producer warp would cap the registers). Each warpgroup computes its 64
// rows' logits of a 128-column V tile with m64n128 wgmma, both operands in
// shared memory, and on the accumulator in registers adds the bias, keeps
// a running max and sum of exponentials per row and thread (merged over
// the row's four threads once, at the end) and picks the blank and label
// logits by a compare and select that only the thread holding the column
// takes. The logits never leave the registers. The warpgroups take turns
// to issue a tile's products (a ping-pong on two named barriers, as in
// FlashAttention-3), so that they are at least two k-chunks apart and one's
// softmax can run while the other's products do. Every block reads all of W
// from L2: 43 GB at the training shape (8382 blocks x 5.1 MB).
//
// K3: the TPU accumulates dW, db and dpred over a sequential grid; blocks
// here run at once, so the work is split in two passes whose partials are
// summed in a fixed order (deterministic, no atomics). Both passes share
// one core: a 64 x H operand X held in shared memory and 64 x H tiles Y
// streamed by TMA through the ring. Per tile each of two warpgroups
// computes half of the 64 x 64 logits, X Y_half^T (m64n32, K = H), forms
// dlogits on the accumulator (fp32, then T once: the Pallas kernel's
// dlog2), trades its bf16 half with the other warpgroup through shared
// memory (one named barrier) and adds dlogits, as the register A operand,
// times Y (read MN-major: no transpose of the tile) into an m64n(H/2) sum
// that stays in registers: each warpgroup owns half of H (128 registers a
// thread at H = 512, which the whole of H would exceed).
//   A (j16::joint_bwd_rows, row-parallel): a block owns batch row b and TT
//     frames. Per chunk of 64 rows X is their hidden (formed in shared
//     memory, and written to a bf16 workspace [N, H] for pass B), Y walks
//     W's V tiles and the sum is dpre. After each chunk dpre goes to
//     shared memory over the ring, and one thread a column multiplies it by
//     act'(pre) and adds the rows into denc[b, t] (owned) and its frame
//     tile's partial of dpred[b, u]. TT minimises waves x chunks a block.
//   B (j16::joint_bwd_weights, V-tile-parallel): a block owns a V tile of
//     W as X (loaded once, so its logits come transposed: W_vt hid^T) and
//     one of S row splits; Y walks the split's 64-row chunks of the hidden
//     workspace and the sum is dW[v0:v0+64]; db sums the fp32 dlogits in
//     registers. Each row's gb, ge, lse and label come from a 16-byte
//     record pass A writes (reading them from the planes and labels took a
//     third of pass B's time in integer divisions and dependent loads). The
//     grid is rastered V tile first, so the blocks in flight sweep one
//     split and L2 serves its hidden.
//   R sums the dpred, dW and db partials in order (tile::sum_into).
// The ring has two stages at H = 512, so tile i + 1's logits are not
// issued ahead of tile i's sum: its tile would then have too little time
// to arrive (measured slower). The logits are computed in both passes:
// keeping T(dlogits) from pass A
// instead would save one GEMM of four (5.5 TFLOP) for a [N, V] bf16 round
// trip through device memory (10.7 GB each way) and 10.7 GB of workspace.
// Rows past N or past a block's range are zeros in X or Y, with gb = ge =
// 0 and lse = +inf, so their p and dlogits are exactly 0.
//
// fp32 (namespace f32k): the plain-FMA tile products of tile_mma.cuh (no
// TF32). K2 stages a block's hidden and walks the V tiles through shared
// memory; K3 runs the same two passes and sums with its accumulators in
// shared memory.
//
// Plain C interface, bound with ctypes; each entry point returns
// cudaGetLastError().

#include "sm90_gmma.cuh"
#include "tile_mma.cuh"

namespace {

using namespace tile;

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

// ================================================================ fp32 ===
namespace f32k {

constexpr int kTT = 16;   // frames a pass-A block owns
constexpr int kPad = 4;   // row padding (floats): 16-byte rows, other banks
// Rows and V columns of a tile: K2, pass A, pass B.
constexpr int kFwdR = 32, kFwdVT = 32;
constexpr int kRowsR = 16, kRowsVT = 32;
constexpr int kWtsR = 32, kWtsVT = 16;

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
__device__ void stage_rows(const float* __restrict__ src, float* dst, int ld,
                           int r0, int rows, int r_end, int h) {
  const int per = h / 4;
  for (int i = threadIdx.x; i < rows * per; i += kThreads) {
    const int r = i / per, k = (i % per) * 4;
    const bool in = r0 + r < r_end;
    cp_async16(dst + (size_t)r * ld + k,
               in ? src + (size_t)(r0 + r) * h + k : src, in ? 16 : 0);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// hidden of rows [row0, row0 + rows) of the flattened lattice into hid
// (row stride ld); rows at or past row_end are zero. With hid_out the
// hidden of each row also goes to hid_out[row, :].
__device__ void stage_hidden(const float* __restrict__ enc,
                             const float* __restrict__ pred, float* hid,
                             float* __restrict__ hid_out, int ld, int row0,
                             int rows, int row_end, int t_max, int u1, int h,
                             int act) {
  for (int i = threadIdx.x; i < rows * h; i += kThreads) {
    const int r = i / h, k = i % h, row = row0 + r;
    float val = 0.0f;
    if (row < row_end) {
      const int u = row % u1, bt = row / u1, b = bt / t_max;
      val = act_fwd<float>(enc[(size_t)bt * h + k] +
                               pred[((size_t)b * u1 + u) * h + k],
                           act);
      if (hid_out != nullptr) hid_out[(size_t)row * h + k] = val;
    }
    hid[(size_t)r * ld + k] = val;
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

// dlogits of one element (fp32).
__device__ __forceinline__ float dlogit(float logit, float lse, float gb,
                                        float ge, int col, int blank,
                                        int label) {
  float d = (gb + ge) * expf(logit - lse);
  if (col == blank) d -= gb;
  if (col == label) d -= ge;
  return d;
}

// ------------------------------------------------------------------ K2 ---
struct FwdLayout {
  int ldh, ldc;
  size_t o_w, o_c, o_lab, bytes;
};

__host__ __device__ inline FwdLayout fwd_layout(int rows, int vt, int h) {
  FwdLayout L;
  L.ldh = h + kPad;
  L.ldc = vt + 4;
  size_t o = align128((size_t)rows * L.ldh * 4);
  L.o_w = o;
  o += align128((size_t)vt * L.ldh * 4);
  L.o_c = o;
  o += align128((size_t)rows * L.ldc * 4);
  L.o_lab = o;
  o += align128((size_t)rows * 4);
  L.bytes = o;
  return L;
}

template <int R, int VT>
__global__ void __launch_bounds__(kThreads, 2)
joint_fwd(const float* __restrict__ enc, const float* __restrict__ pred,
          const float* __restrict__ w, const float* __restrict__ bias,
          const int* __restrict__ labels, float* __restrict__ blank_lp,
          float* __restrict__ emit_lp, float* __restrict__ lse_out,
          int n_rows, int t_max, int u1, int h, int v, int blank, int act) {
  static_assert(kThreads % R == 0, "rows must divide the block");
  constexpr int Q = kThreads / R;  // threads per row in the softmax
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L = fwd_layout(R, VT, h);
  float* hid = reinterpret_cast<float*>(smem);
  float* wt = reinterpret_cast<float*>(smem + L.o_w);
  float* c = reinterpret_cast<float*>(smem + L.o_c);
  int* lab = reinterpret_cast<int*>(smem + L.o_lab);
  const int row0 = blockIdx.x * R;
  stage_meta(labels, nullptr, nullptr, nullptr, lab, nullptr, nullptr,
             nullptr, row0, R, n_rows, t_max, u1);
  stage_hidden(enc, pred, hid, nullptr, L.ldh, row0, R, n_rows, t_max, u1,
               h, act);
  const int r = threadIdx.x / Q, q = threadIdx.x % Q;
  float m = -INFINITY, s = 0.0f, lb = 0.0f, le = 0.0f;
  for (int v0 = 0; v0 < v; v0 += VT) {
    __syncthreads();  // hidden staged; the last tile's logits read
    stage_rows(w, wt, L.ldh, v0, VT, v, h);
    __syncthreads();
    mma_acc<true, false, false>(c, L.ldc, hid, L.ldh, wt, L.ldh, R, VT, h);
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

__host__ __device__ inline RowsLayout rows_layout(int rows, int vt, int h) {
  RowsLayout L;
  L.ldh = h + kPad;
  L.ldc = vt + 4;
  L.ldd = vt + kPad;
  L.ldp = h + 4;
  size_t o = align128((size_t)rows * L.ldh * 4);
  L.o_w = o;
  o += align128((size_t)vt * L.ldh * 4);
  L.o_c = o;
  o += align128((size_t)rows * L.ldc * 4);
  L.o_d = o;
  o += align128((size_t)rows * L.ldd * 4);
  L.o_p = o;
  o += align128((size_t)rows * L.ldp * 4);
  L.o_meta = o;
  o += align128((size_t)rows * 16);
  L.bytes = o;
  return L;
}

template <int R, int VT>
__global__ void __launch_bounds__(kThreads, 2)
joint_bwd_rows(const float* __restrict__ enc, const float* __restrict__ pred,
               const float* __restrict__ w, const float* __restrict__ bias,
               const int* __restrict__ labels, const float* __restrict__ gb,
               const float* __restrict__ ge, const float* __restrict__ lse,
               float* __restrict__ denc, float* __restrict__ dpred_part,
               float* __restrict__ hid_out, int t_max, int u1, int h, int v,
               int blank, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsLayout L = rows_layout(R, VT, h);
  float* hid = reinterpret_cast<float*>(smem);
  float* wt = reinterpret_cast<float*>(smem + L.o_w);
  float* c = reinterpret_cast<float*>(smem + L.o_c);
  float* dlc = reinterpret_cast<float*>(smem + L.o_d);
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
  for (int i = threadIdx.x; i < tcount * h; i += kThreads) denc_b[i] = 0.0f;
  for (int i = threadIdx.x; i < u1 * h; i += kThreads) dpred_b[i] = 0.0f;
  for (int c0 = 0; c0 < rows; c0 += R) {
    __syncthreads();  // the last chunk's sums done
    stage_hidden(enc, pred, hid, hid_out, L.ldh, base + c0, R, base + rows,
                 t_max, u1, h, act);
    stage_meta(labels, gb, ge, lse, lab, gbs, ges, lses, base + c0, R,
               base + rows, t_max, u1);
    for (int i = threadIdx.x; i < R * h; i += kThreads)
      dpre[(i / h) * L.ldp + i % h] = 0.0f;
    for (int v0 = 0; v0 < v; v0 += VT) {
      __syncthreads();  // the last tile's products done
      stage_rows(w, wt, L.ldh, v0, VT, v, h);
      __syncthreads();
      mma_acc<true, false, false>(c, L.ldc, hid, L.ldh, wt, L.ldh, R, VT,
                                  h);
      __syncthreads();
      for (int i = threadIdx.x; i < R * VT; i += kThreads) {
        const int r = i / VT, j = i % VT, col = v0 + j;
        float d = 0.0f;
        if (c0 + r < rows && col < v)
          d = dlogit(c[r * L.ldc + j] + bias[col], lses[r], gbs[r], ges[r],
                     col, blank, lab[r]);
        dlc[r * L.ldd + j] = d;
      }
      __syncthreads();
      mma_acc<true, true>(dpre, L.ldp, dlc, L.ldd, wt, L.ldh, R, h, VT);
    }
    __syncthreads();
    // dpre * act' into denc (a run of rows shares t) and dpred's partial;
    // each column belongs to one thread, rows added in order.
    const float* enc_b = enc + ((size_t)b * t_max + t0) * h;
    const float* pred_b = pred + (size_t)b * u1 * h;
    for (int k = threadIdx.x; k < h; k += kThreads) {
      int cur_t = -1;
      float run = 0.0f;
      for (int r = 0; r < R && c0 + r < rows; ++r) {
        const int i = c0 + r, tl = i / u1, u = i % u1;
        const float pre = enc_b[(size_t)tl * h + k] + pred_b[(size_t)u * h + k];
        const float val = dpre[r * L.ldp + k] *
                          act_grad<float>(pre, hid[r * L.ldh + k], act);
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

__host__ __device__ inline WtsLayout wts_layout(int rows, int vt, int h) {
  WtsLayout L;
  L.ldh = h + kPad;
  L.ldc = vt + 4;
  L.ldd = vt + kPad;
  L.ldp = h + 4;
  size_t o = align128((size_t)vt * L.ldh * 4);
  L.o_h = o;
  o += align128((size_t)rows * L.ldh * 4);
  L.o_c = o;
  o += align128((size_t)rows * L.ldc * 4);
  L.o_d = o;
  o += align128((size_t)rows * L.ldd * 4);
  L.o_dw = o;
  o += align128((size_t)vt * L.ldp * 4);
  L.o_db = o;
  o += align128((size_t)vt * 4);
  L.o_meta = o;
  o += align128((size_t)rows * 16);
  L.bytes = o;
  return L;
}

template <int R, int VT>
__global__ void __launch_bounds__(kThreads, 2)
joint_bwd_weights(const float* __restrict__ hid_in,
                  const float* __restrict__ w,
                  const float* __restrict__ bias,
                  const int* __restrict__ labels,
                  const float* __restrict__ gb, const float* __restrict__ ge,
                  const float* __restrict__ lse, float* __restrict__ dw_part,
                  float* __restrict__ db_part, int n_rows,
                  int rows_per_split, int t_max, int u1, int h, int v,
                  int v_pad, int blank) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WtsLayout L = wts_layout(R, VT, h);
  float* wt = reinterpret_cast<float*>(smem);
  float* hid = reinterpret_cast<float*>(smem + L.o_h);
  float* c = reinterpret_cast<float*>(smem + L.o_c);
  float* dlc = reinterpret_cast<float*>(smem + L.o_d);
  float* dw = reinterpret_cast<float*>(smem + L.o_dw);
  float* db = reinterpret_cast<float*>(smem + L.o_db);
  int* lab = reinterpret_cast<int*>(smem + L.o_meta);
  float* gbs = reinterpret_cast<float*>(lab + R);
  float* ges = gbs + R;
  float* lses = ges + R;
  const int v0 = blockIdx.x * VT, split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n_rows, r_begin + rows_per_split);
  stage_rows(w, wt, L.ldh, v0, VT, v, h);
  for (int i = threadIdx.x; i < VT * h; i += kThreads)
    dw[(i / h) * L.ldp + i % h] = 0.0f;
  for (int j = threadIdx.x; j < VT; j += kThreads) db[j] = 0.0f;
  for (int row0 = r_begin; row0 < r_end; row0 += R) {
    __syncthreads();  // the last chunk's products done
    stage_rows(hid_in, hid, L.ldh, row0, R, r_end, h);
    stage_meta(labels, gb, ge, lse, lab, gbs, ges, lses, row0, R, r_end,
               t_max, u1);
    __syncthreads();
    mma_acc<true, false, false>(c, L.ldc, hid, L.ldh, wt, L.ldh, R, VT, h);
    __syncthreads();
    for (int i = threadIdx.x; i < R * VT; i += kThreads) {
      const int r = i / VT, j = i % VT, col = v0 + j;
      float d = 0.0f;
      if (row0 + r < r_end && col < v)
        d = dlogit(c[r * L.ldc + j] + bias[col], lses[r], gbs[r], ges[r],
                   col, blank, lab[r]);
      c[r * L.ldc + j] = d;
      dlc[r * L.ldd + j] = d;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < VT; j += kThreads) {
      float s = db[j];
      for (int r = 0; r < R; ++r) s += c[r * L.ldc + j];
      db[j] = s;
    }
    mma_acc<false, true>(dw, L.ldp, dlc, L.ldd, hid, L.ldh, VT, h, R);
  }
  __syncthreads();
  // This split's dW rows [v0, v0 + VT) of a [v_pad, H] partial; rows past
  // V are zero and never summed.
  float* out = dw_part + ((size_t)split * v_pad + v0) * h;
  for (int i = threadIdx.x; i < VT * h; i += kThreads)
    out[i] = dw[(i / h) * L.ldp + i % h];
  for (int j = threadIdx.x; j < VT; j += kThreads)
    if (v0 + j < v) db_part[(size_t)split * v + v0 + j] = db[j];
}

}  // namespace f32k

// ================================================================ bf16 ===
// See the note at the top. Both kernels keep every element-wise loop
// between products free of runtime branches (the blank and label picks of
// K2 run only in the thread that holds the column) and form the biases and
// row data while the logits' product runs.
namespace j16 {
using bf = __nv_bfloat16;
using namespace sm90;

constexpr int kWG = 128;   // threads of a warpgroup
constexpr int RT = 64;     // K3: rows of X and of a streamed tile Y
constexpr int VT = 128;    // K2: V columns of a tile
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr bool width_ok(int h) {
  return h == 128 || h == 512;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of element (r, c) in a K-major 128B-swizzled bf16 tile of
// `rows` rows stored as [cols / 64][rows][64], the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B (the region starts on 1024 bytes).
__device__ __forceinline__ uint32_t swz128(int rows, int r, int c) {
  const int cc = c & 63;
  return (uint32_t)((c >> 6) * rows * 128 + r * 128 +
                    (((cc >> 3) ^ (r & 7)) << 4) + (cc & 7) * 2);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// A bf16 pair of the hidden from bf16 pairs of enc and pred.
__device__ __forceinline__ uint32_t hidden_pair(uint32_t e, uint32_t p,
                                                int act) {
  const float2 a = unpack_bf16(e), b = unpack_bf16(p);
  return pack_bf16(act_fwd<bf>(rnd<bf>(a.x + b.x), act),
                   act_fwd<bf>(rnd<bf>(a.y + b.y), act));
}

// The hidden of rows [row0, row0 + ROWS) as bf16 into the K-major
// 128B-swizzled tile at smem ([H/64][ROWS][64]), 8 columns (16 bytes) a
// step; rows at or past row_end are zeros. With out given, the rows below
// row_end also go to out[row, :].
template <int H, int ROWS>
__device__ __forceinline__ void form_hidden(unsigned char* smem,
                                            const bf* __restrict__ enc,
                                            const bf* __restrict__ pred,
                                            bf* __restrict__ out, int row0,
                                            int row_end, int t_max, int u1,
                                            int act) {
  constexpr int VEC = H / 8;
  for (int i = threadIdx.x; i < ROWS * VEC; i += 2 * kWG) {
    const int r = i / VEC, c = (i % VEC) * 8, row = row0 + r;
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (row < row_end) {
      const int u = row % u1, bt = row / u1, b = bt / t_max;
      const uint4 e =
          *reinterpret_cast<const uint4*>(enc + (size_t)bt * H + c);
      const uint4 p = *reinterpret_cast<const uint4*>(
          pred + ((size_t)b * u1 + u) * H + c);
      o = make_uint4(hidden_pair(e.x, p.x, act), hidden_pair(e.y, p.y, act),
                     hidden_pair(e.z, p.z, act), hidden_pair(e.w, p.w, act));
      if (out != nullptr)
        *reinterpret_cast<uint4*>(out + (size_t)row * H + c) = o;
    }
    *reinterpret_cast<uint4*>(smem + swz128(ROWS, r, c)) = o;
  }
}

// Lane 0 of a warp that is done with use `use` of ring stage s: true for
// the last of the block's eight warps to say so, which then refills the
// stage. Counts only grow: the use is released at 8 (use + 1).
__device__ __forceinline__ bool release_last(int* count, int s, int use) {
  __threadfence_block();
  const bool last = atomicAdd(&count[s], 1) == 8 * (use + 1) - 1;
  if (last) __threadfence_block();
  return last;
}

// ------------------------------------------------------------------ K2 ---
// Shared memory, byte offsets from a 1024-aligned base: the hidden tile,
// the ring of W k-chunks ([VT][64] each, 128B swizzle), the full barriers
// and the release counts. HAND is the chunk of a tile after which a
// warpgroup lets the other issue its products (joint_fwd). It must be
// below STAGES: the chunks after it may need stages that only the other
// warpgroup's reads of the same tile free. At H = 512 the ring (6 stages)
// holds less than a tile (8 chunks), and each chunk a warpgroup waits
// before the hand-over leaves the refills that much less time; in a sweep
// on the card the second chunk was the fastest hand-over.
template <int H>
struct Fwd {
  static constexpr int ROWS = 128, KC = H / 64;
  static constexpr uint32_t kHid = ROWS * H * 2;
  static constexpr uint32_t kStage = VT * 64 * 2;
  static constexpr int kFit = (int)((kMaxSmem - 1024 - 256 - kHid) / kStage);
  static constexpr int STAGES = kFit > 8 ? 8 : kFit;
  static constexpr int HAND = 1;
  static constexpr uint32_t kFull = kHid + STAGES * kStage;
  static constexpr uint32_t kCount = kFull + 8 * 8;
  static constexpr uint32_t kBytes = kCount + 8 * 4;
  static_assert(HAND < KC && HAND < STAGES, "a hand-over the ring allows");
};

// k-chunk g (V tile g / KC, H columns 64 (g % KC) ..) into its stage.
template <int H>
__device__ __forceinline__ void fwd_load(uint32_t base, const CUtensorMap* w,
                                         int g) {
  using C = Fwd<H>;
  const int s = g % C::STAGES;
  const uint32_t full = base + C::kFull + 8 * s;
  mbar_expect_tx(full, C::kStage);
  tma_load_2d(base + C::kHid + s * C::kStage, w, full, (g % C::KC) * 64,
              (g / C::KC) * VT);
}

// Rows [128 blockIdx.x, + 128); warpgroup wg takes 64 of them.
template <int H>
__global__ void __launch_bounds__(2 * kWG, 1)
joint_fwd(const __grid_constant__ CUtensorMap w_map,
          const bf* __restrict__ enc, const bf* __restrict__ pred,
          const float* __restrict__ bias, const int* __restrict__ labels,
          float* __restrict__ blank_lp, float* __restrict__ emit_lp,
          float* __restrict__ lse_out, int n_rows, int t_max, int u1, int v,
          int blank, int act) {
  using C = Fwd<H>;
  constexpr int KC = C::KC, S = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  int* count = reinterpret_cast<int*>(smem + C::kCount);
  const int tid = threadIdx.x, row0 = blockIdx.x * C::ROWS;
  const int tiles = (v + VT - 1) / VT, total = tiles * KC;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(base + C::kFull + 8 * s, 1);
      count[s] = 0;
    }
    mbar_init_fence();
    for (int g = 0; g < S && g < total; ++g) fwd_load<H>(base, &w_map, g);
  }
  form_hidden<H, C::ROWS>(smem, enc, pred, nullptr, row0, n_rows, t_max, u1,
                          act);
  fence_async_smem();
  __syncthreads();

  const int wid = warp_uniform(tid / 32);
  const int wg = wid / 4, warp = wid % 4, lane = tid % 32;
  // Register r of the accumulator holds row rl + 8 ((r / 2) % 2) and
  // column 8 (r / 4) + 2 (lane % 4) + r % 2 of the tile.
  const int rl = 64 * wg + 16 * warp + lane / 4;
  int lab[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + rl + 8 * h;
    lab[h] = -1;
    if (row < n_rows) {
      const int u = row % u1, b = row / u1 / t_max;
      if (u < u1 - 1) lab[h] = labels[(size_t)b * (u1 - 1) + u];
    }
  }
  float m[2] = {-INFINITY, -INFINITY}, s[2] = {0.0f, 0.0f};
  float lb[2] = {0.0f, 0.0f}, le[2] = {0.0f, 0.0f};
  float acc[64];
  const uint64_t ad0 = desc(base + 64 * wg * 128, 16, 1024, kSwizzle128);
  const uint64_t bd0 = desc(base + C::kHid, 16, 1024, kSwizzle128);
  // Ping-pong (FlashAttention-3): the warpgroups take turns to issue their
  // products, so that one's softmax runs under the other's. Warpgroup wg
  // waits at named barrier 1 + wg before a tile's first chunk, and after
  // chunk HAND lets the other start (arrives at its barrier). Warpgroup 0
  // starts; warpgroup 1 makes no hand-over after its last tile, so each
  // barrier completes as often as it is waited at.
  if (wg == 1) named_arrive(1, 2 * kWG);
  for (int i = 0; i < tiles; ++i) {
    named_sync(1 + wg, 2 * kWG);
#pragma unroll 1
    for (int c = 0; c < KC; ++c) {
      const int g = i * KC + c, st = g % S;
      mbar_wait(base + C::kFull + 8 * st, (g / S) & 1);
      const uint64_t ad = desc_at(opaque(ad0), c * C::ROWS * 128);
      const uint64_t bd = desc_at(opaque(bd0), st * C::kStage);
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss_n128<0, 0>(acc, desc_at(ad, kk * 32), desc_at(bd, kk * 32),
                          c > 0 || kk > 0);
      wg_commit();
      if (c == C::HAND && (wg == 0 || i + 1 < tiles))
        named_arrive(2 - wg, 2 * kWG);
      if (c > 0) {  // the chunk before is read: release its stage
        wg_wait1();
        __syncwarp();
        const int gp = g - 1;
        if (lane == 0 && release_last(count, gp % S, gp / S) && gp + S < total)
          fwd_load<H>(base, &w_map, gp + S);
      }
    }
    // While the last chunk's product runs: the tile's biases (-inf past V).
    const int cb = i * VT + 2 * (lane & 3);
    float bs[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int col = cb + 8 * (q >> 1) + (q & 1);
      const float bv = __ldg(bias + min(col, v - 1));
      bs[q] = col < v ? bv : -INFINITY;
    }
    wg_wait0();
    fence_regs(acc);
    __syncwarp();
    {
      const int gp = i * KC + KC - 1;
      if (lane == 0 && release_last(count, gp % S, gp / S) && gp + S < total)
        fwd_load<H>(base, &w_map, gp + S);
    }
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] += bs[(r >> 2) * 2 + (r & 1)];
    // Running max and sum of exponentials of each of the thread's rows.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
      const float mb = (mx == -INFINITY ? 0.0f : mx) * kLog2e;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        sum += ex2(fmaf(acc[4 * j + 2 * h], kLog2e, -mb)) +
               ex2(fmaf(acc[4 * j + 2 * h + 1], kLog2e, -mb));
      s[h] = s[h] * ex2(fmaf(m[h], kLog2e, -mb)) + sum;
      m[h] = mx;
    }
    // The blank and label logits, in the one thread that holds each.
    const int ob = blank - cb;
    if (ob >= 0 && ob < VT && (ob & 6) == 0) {
#pragma unroll
      for (int q = 0; q < 32; ++q)
        if (8 * (q >> 1) + (q & 1) == ob) {
          lb[0] = acc[4 * (q >> 1) + (q & 1)];
          lb[1] = acc[4 * (q >> 1) + 2 + (q & 1)];
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ol = lab[h] - cb;
      if (ol >= 0 && ol < VT && (ol & 6) == 0) {
#pragma unroll
        for (int q = 0; q < 32; ++q)
          if (8 * (q >> 1) + (q & 1) == ol)
            le[h] = acc[4 * (q >> 1) + 2 * h + (q & 1)];
      }
    }
  }
  // Merge each row's four threads, then write its planes.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mm = m[h], ss = s[h], pb = lb[h], pe = le[h];
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, mm, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, ss, o);
      pb += __shfl_xor_sync(0xffffffffu, pb, o);
      pe += __shfl_xor_sync(0xffffffffu, pe, o);
      lse_merge(mm, ss, m2, s2);
    }
    const int row = row0 + rl + 8 * h;
    if ((lane & 3) == 0 && row < n_rows) {
      const float l = mm + logf(ss);
      lse_out[row] = l;
      blank_lp[row] = pb - l;
      emit_lp[row] = pe - l;
    }
  }
}

// ------------------------------------------------------------------ K3 ---
// Shared memory of both passes, byte offsets from a 1024-aligned base: X
// ([H/64][64][64], 128B swizzle), the ring of Y tiles (the same layout;
// pass A stages dpre [64][H] fp32 over it after each chunk), the dlogits
// exchange ([2 buffers][2 warpgroups][8 words][128 threads]; pass B's db
// over it at the end), the full barriers, X's barrier, the release counts.
template <int H>
struct Bwd {
  static constexpr int KC = H / 64;
  static constexpr uint32_t kTile = RT * H * 2;
  static constexpr uint32_t kXch = 2 * 2 * 8 * kWG * 4;
  static constexpr int kFit =
      (int)((kMaxSmem - 1024 - 256 - kTile - kXch) / kTile);
  static constexpr int STAGES = kFit > 4 ? 4 : kFit;
  static constexpr uint32_t kRing = kTile;
  static constexpr uint32_t kXb = kRing + STAGES * kTile;
  static constexpr uint32_t kFull = kXb + kXch;
  static constexpr uint32_t kXbar = kFull + 8 * 4;
  static constexpr uint32_t kCount = kXbar + 8;
  static constexpr uint32_t kBytes = kCount + 4 * 4;
  static_assert(STAGES >= 2, "two stages at least");
  static_assert(STAGES * kTile >= (uint32_t)RT * H * 4,
                "dpre fits over the ring");
};

// Rows [row, row + 64) of map ([*, H], boxes of 64 x 64) into stage s.
template <int H>
__device__ __forceinline__ void bwd_load(uint32_t base, const CUtensorMap* map,
                                         int s, int row) {
  using C = Bwd<H>;
  const uint32_t st = base + C::kRing + s * C::kTile;
  const uint32_t full = base + C::kFull + 8 * s;
  mbar_expect_tx(full, C::kTile);
#pragma unroll
  for (int c = 0; c < C::KC; ++c)
    tma_load_2d(st + c * RT * 128, map, full, c * 64, row);
}

// acc1 = X Y_w^T: X [64, H] and the warpgroup's 32 rows of Y, both K-major
// (m64n32, K = H).
template <int H>
__device__ __forceinline__ void logits_half(float (&acc1)[16], uint64_t xd,
                                            uint64_t yd) {
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    const uint32_t o = (kk >> 2) * RT * 128 + (kk & 3) * 32;
    mma_ss_n32<0, 0>(acc1, desc_at(xd, o), desc_at(yd, o), kk > 0);
  }
}

// acc2 [64, H/2] += a (one k-step of 16 rows of Y) @ Y (MN-major).
template <int H>
__device__ __forceinline__ void mma_half(float (&acc2)[H / 4],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (H == 512)
    mma_rs_n256<1>(acc2, a, b, 1);
  else
    mma_rs_n64<1>(acc2, a, b, 1);
}

// The warpgroup's dlogits d (its 32 columns, accumulator order) rounded to
// bf16 as the A fragments of its own two k-steps, and the other
// warpgroup's two, traded through exchange buffer buf.
__device__ __forceinline__ void trade(const float (&d)[16],
                                      uint32_t (&own)[2][4],
                                      uint32_t (&oth)[2][4], uint32_t* xb,
                                      int buf, int w, int t) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    own[q >> 2][q & 3] = pack_bf16(d[2 * q], d[2 * q + 1]);
    xb[((buf * 2 + w) * 8 + q) * kWG + t] = own[q >> 2][q & 3];
  }
  named_sync(1, 2 * kWG);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    oth[q >> 2][q & 3] = xb[((buf * 2 + 1 - w) * 8 + q) * kWG + t];
}

// The loop of both passes over n streamed tiles Y_i (use g0 + i of ring
// stage (g0 + i) % S): per tile the warpgroup's half of the logits X Y^T,
// P's dlogits on them, the trade, and acc2 += dlogits Y_i over all 64
// rows of Y_i (the warpgroup's own k-steps first); then the stage is
// released, and refilled by P::refill.
template <int H, class P>
__device__ __forceinline__ void bwd_loop(float (&acc2)[H / 4], P& pass,
                                         uint32_t base, int* count,
                                         uint32_t* xb, int w, int t,
                                         int lane, int g0, int n,
                                         uint64_t xd0, uint64_t yk0,
                                         uint64_t ym0) {
  using C = Bwd<H>;
  constexpr int S = C::STAGES;
  for (int i = 0; i < n; ++i) {
    const int g = g0 + i, s = g % S;
    mbar_wait(base + C::kFull + 8 * s, (g / S) & 1);
    const uint32_t so = s * C::kTile;
    float acc1[16];
    fence_regs(acc1);
    wg_fence();
    logits_half<H>(acc1, opaque(xd0), desc_at(opaque(yk0), so));
    wg_commit();
    pass.prepare(i);
    wg_wait0();
    fence_regs(acc1);
    pass.dlogits(acc1, i);
    uint32_t own[2][4], oth[2][4];
    trade(acc1, own, oth, xb, i & 1, w, t);
    const uint64_t ym = desc_at(opaque(ym0), so);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      fence_regs(own[k]);
      fence_regs(oth[k]);
    }
    fence_regs(acc2);
    wg_fence();
    mma_half<H>(acc2, own[0], desc_at(ym, (2 * w) * 2048));
    mma_half<H>(acc2, own[1], desc_at(ym, (2 * w + 1) * 2048));
    mma_half<H>(acc2, oth[0], desc_at(ym, (2 - 2 * w) * 2048));
    mma_half<H>(acc2, oth[1], desc_at(ym, (3 - 2 * w) * 2048));
    wg_commit();
    wg_wait0();
    fence_regs(acc2);
    __syncwarp();
    if (lane == 0 && release_last(count, s, g / S) && i + S < n)
      pass.template refill<H>(s, i + S);
  }
}

// Pass A's tile work: V tile i of W is Y_i; the warpgroup's columns are
// cb + 8 j + e, its rows (gb, ge, lse in log2 units, label) h = 0, 1.
struct RowsTile {
  const CUtensorMap* w_map;
  const float* bias;
  uint32_t base;
  int v, blank, w, lane;
  float gbr[2], ger[2], l2[2];
  int lab[2];
  float bs[8];

  __device__ __forceinline__ int cb(int i) const {
    return i * RT + 32 * w + 2 * (lane & 3);
  }
  // The biases of the columns (-inf past V).
  __device__ __forceinline__ void prepare(int i) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = cb(i) + 8 * (q >> 1) + (q & 1);
      const float x = __ldg(bias + min(col, v - 1));
      bs[q] = col < v ? x : -INFINITY;
    }
  }
  __device__ __forceinline__ void dlogits(float (&a)[16], int i) const {
    const int ob = blank - cb(i);
    const int ol[2] = {lab[0] - cb(i), lab[1] - cb(i)};
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int h = (r >> 1) & 1, k = 8 * (r >> 2) + (r & 1);
      const float p =
          ex2(fmaf(a[r] + bs[2 * (r >> 2) + (r & 1)], kLog2e, -l2[h]));
      a[r] = (gbr[h] + ger[h]) * p - (ob == k ? gbr[h] : 0.0f) -
             (ol[h] == k ? ger[h] : 0.0f);
    }
  }
  template <int H>
  __device__ __forceinline__ void refill(int s, int k) const {
    bwd_load<H>(base, w_map, s, k * RT);
  }
};

// Pass B's tile work: chunk i of the split's hidden rows is Y_i; the
// warpgroup's columns are its rows n = 32 w + 8 j + 2 (lane % 4) + e (q =
// 2 j + e), read from pass A's row records; its V rows vv[h] of the tile.
struct WtsTile {
  const CUtensorMap* h_map;
  const float4* rec;
  uint32_t base;
  int n_rows, r_begin, r_end, blank, w, lane;
  int vv[2];
  float bv[2], dbs[2];
  float gbr[8], ger[8], l2[8];
  int lab[8];

  // The rows' gb, ge, lse (log2 units) and label; past the split gb = ge
  // = 0 and lse = +inf, so their p and dlogits are 0.
  __device__ __forceinline__ void prepare(int i) {
    const int row0 = r_begin + i * RT + 32 * w + 2 * (lane & 3);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int row = row0 + 8 * (q >> 1) + (q & 1);
      const float4 m = __ldg(rec + min(row, n_rows - 1));
      const bool in = row < r_end;
      gbr[q] = in ? m.x : 0.0f;
      ger[q] = in ? m.y : 0.0f;
      l2[q] = in ? m.z : INFINITY;
      lab[q] = in ? __float_as_int(m.w) : -1;
    }
  }
  __device__ __forceinline__ void dlogits(float (&a)[16], int) {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int h = (r >> 1) & 1, q = 2 * (r >> 2) + (r & 1);
      const float p = ex2(fmaf(a[r] + bv[h], kLog2e, -l2[q]));
      const float d = (gbr[q] + ger[q]) * p -
                      (vv[h] == blank ? gbr[q] : 0.0f) -
                      (lab[q] == vv[h] ? ger[q] : 0.0f);
      dbs[h] += d;
      a[r] = d;
    }
  }
  template <int H>
  __device__ __forceinline__ void refill(int s, int k) const {
    bwd_load<H>(base, h_map, s, r_begin + k * RT);
  }
};

// Pass A: block (frame tile, b), rows [(b T + t0) U1, + tcount U1). Also
// writes each row's record (gb, ge, lse in log2 units, label) for pass B.
template <int H>
__global__ void __launch_bounds__(2 * kWG, 1)
joint_bwd_rows(const __grid_constant__ CUtensorMap w_map,
               const bf* __restrict__ enc, const bf* __restrict__ pred,
               const float* __restrict__ bias, const int* __restrict__ labels,
               const float* __restrict__ gb, const float* __restrict__ ge,
               const float* __restrict__ lse, float* __restrict__ denc,
               float* __restrict__ dpred_part, bf* __restrict__ hid_out,
               float4* __restrict__ rec_out, int t_max, int u1, int v,
               int frames, int blank, int act) {
  using C = Bwd<H>;
  constexpr int S = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  int* count = reinterpret_cast<int*>(smem + C::kCount);
  uint32_t* xb = reinterpret_cast<uint32_t*>(smem + C::kXb);
  float* dp = reinterpret_cast<float*>(smem + C::kRing);
  const int tid = threadIdx.x;
  const int wid = warp_uniform(tid / 32);
  const int w = wid / 4, warp = wid % 4, lane = tid % 32, t = tid % kWG;
  const int tt = blockIdx.x, b = blockIdx.y, n_tt = gridDim.x;
  const int t0 = tt * frames, tcount = min(frames, t_max - t0);
  const int rows = tcount * u1, row_base = (b * t_max + t0) * u1;
  const int tiles = (v + RT - 1) / RT;
  float* denc_b = denc + ((size_t)b * t_max + t0) * H;
  float* dpred_b = dpred_part + ((size_t)b * n_tt + tt) * u1 * H;
  const bf* enc_b = enc + ((size_t)b * t_max + t0) * H;
  const bf* pred_b = pred + (size_t)b * u1 * H;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(base + C::kFull + 8 * s, 1);
      count[s] = 0;
    }
    mbar_init_fence();
  }
  for (int k = tid; k < H; k += 2 * kWG) {
    for (int r = 0; r < tcount; ++r) denc_b[(size_t)r * H + k] = 0.0f;
    for (int u = 0; u < u1; ++u) dpred_b[(size_t)u * H + k] = 0.0f;
  }
  RowsTile pass;
  pass.w_map = &w_map;
  pass.bias = bias;
  pass.base = base;
  pass.v = v;
  pass.blank = blank;
  pass.w = w;
  pass.lane = lane;
  // Descriptors: X (the hidden, A of the logits), the warpgroup's 32 rows
  // of a W tile (their B, K-major) and its H half of the tile (dpre's B,
  // MN-major).
  const uint64_t xd0 = desc(base, 16, 1024, kSwizzle128);
  const uint64_t yk0 =
      desc(base + C::kRing + 32 * w * 128, 16, 1024, kSwizzle128);
  const uint64_t ym0 = desc(base + C::kRing + (H / 128) * w * RT * 128,
                            RT * 128, 1024, kSwizzle128);
  int g0 = 0;  // ring uses before this chunk
  for (int c0 = 0; c0 < rows; c0 += RT, g0 += tiles) {
    __syncthreads();  // the barriers set; the last chunk's sums done
    if (tid == 0)
      for (int k = 0; k < S && k < tiles; ++k)
        bwd_load<H>(base, &w_map, (g0 + k) % S, k * RT);
    form_hidden<H, RT>(smem, enc, pred, hid_out, row_base + c0,
                       row_base + rows, t_max, u1, act);
    // The thread's rows m = 16 warp + lane / 4 + 8 h of the chunk; past
    // the range gb = ge = 0 and lse = +inf, where p is then 0.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = c0 + 16 * warp + lane / 4 + 8 * h, row = row_base + m;
      pass.gbr[h] = pass.ger[h] = 0.0f;
      pass.l2[h] = INFINITY;
      pass.lab[h] = -1;
      if (m < rows) {
        const int u = row % u1;
        pass.gbr[h] = gb[row];
        pass.ger[h] = ge[row];
        pass.l2[h] = lse[row] * kLog2e;
        if (u < u1 - 1) pass.lab[h] = labels[(size_t)b * (u1 - 1) + u];
        if (w == 0 && (lane & 3) == 0)
          rec_out[row] = make_float4(pass.gbr[h], pass.ger[h], pass.l2[h],
                                     __int_as_float(pass.lab[h]));
      }
    }
    fence_async_smem();
    __syncthreads();

    float acc2[H / 4];
#pragma unroll
    for (int i = 0; i < H / 4; ++i) acc2[i] = 0.0f;
    bwd_loop<H>(acc2, pass, base, count, xb, w, t, lane, g0, tiles, xd0,
                yk0, ym0);

    // dpre [64, H] in fp32 over the ring (every tile of the chunk is read);
    // row r's columns are XORed with 8 (r % 4), so that the eight rows of
    // a warp's store meet in two banks, not eight.
    __syncthreads();
#pragma unroll
    for (int r = 0; r < H / 4; r += 2) {
      const int row = 16 * warp + lane / 4 + 8 * ((r >> 1) & 1);
      const int col = w * (H / 2) + 8 * (r >> 2) + 2 * (lane & 3);
      *reinterpret_cast<float2*>(dp + row * H + (col ^ (8 * (row & 3)))) =
          make_float2(acc2[r], acc2[r + 1]);
    }
    __syncthreads();
    // dpre * act' into denc (a run of rows shares t) and dpred's partial;
    // each column belongs to one thread (KPT of them, walked together),
    // rows added in order. act' comes from the hidden in X (tanh' from h;
    // relu's pre > 0 is h > 0), and for swish from pre, recomputed (one
    // rounding).
    constexpr int KPT = H > 2 * kWG ? H / (2 * kWG) : 1;
    const int nr = min(RT, rows - c0), nu = min(u1, nr), u0 = c0 % u1;
    if (tid < H) {
      float run[KPT];
#pragma unroll
      for (int kk = 0; kk < KPT; ++kk) run[kk] = 0.0f;
      int tl = c0 / u1, u = u0;
      for (int r = 0; r < nr; ++r) {
#pragma unroll
        for (int kk = 0; kk < KPT; ++kk) {
          const int k = tid + kk * 2 * kWG;
          const float hv =
              to_f(*reinterpret_cast<const bf*>(smem + swz128(RT, r, k)));
          const float pre =
              act == 2 ? rnd<bf>(to_f(enc_b[(size_t)tl * H + k]) +
                                 to_f(pred_b[(size_t)u * H + k]))
                       : hv;
          float* cell = dp + r * H + (k ^ (8 * (r & 3)));
          const float val = *cell * act_grad<bf>(pre, hv, act);
          *cell = val;
          run[kk] += val;
        }
        if (++u == u1 || r == nr - 1) {
#pragma unroll
          for (int kk = 0; kk < KPT; ++kk) {
            denc_b[(size_t)tl * H + tid + kk * 2 * kWG] += run[kk];
            run[kk] = 0.0f;
          }
          if (u == u1) {
            u = 0;
            ++tl;
          }
        }
      }
      // dpred: the chunk's rows of each u summed in order, then one
      // read-modify-write a u, eight u a column at a time so that their
      // loads are in flight together (one add chain through memory would
      // wait a load's latency a row).
      for (int j0 = 0; j0 < nu; j0 += 8) {
        float sum[KPT][8], old[KPT][8];
        int off[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = j0 + jj, uj = u0 + j >= u1 ? u0 + j - u1 : u0 + j;
          off[jj] = uj * H + tid;
#pragma unroll
          for (int kk = 0; kk < KPT; ++kk) {
            const int k = tid + kk * 2 * kWG;
            sum[kk][jj] = 0.0f;
            if (j < nu)
              for (int r = j; r < nr; r += u1)
                sum[kk][jj] += dp[r * H + (k ^ (8 * (r & 3)))];
          }
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int kk = 0; kk < KPT; ++kk)
            if (j0 + jj < nu)
              old[kk][jj] = dpred_b[off[jj] + kk * 2 * kWG];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int kk = 0; kk < KPT; ++kk)
            if (j0 + jj < nu)
              dpred_b[off[jj] + kk * 2 * kWG] = old[kk][jj] + sum[kk][jj];
      }
    }
    fence_async_smem();  // the ring's generic accesses before TMA reuses it
  }
}

// Pass B: block (V tile, row split).
template <int H>
__global__ void __launch_bounds__(2 * kWG, 1)
joint_bwd_weights(const __grid_constant__ CUtensorMap w_map,
                  const __grid_constant__ CUtensorMap h_map,
                  const float* __restrict__ bias,
                  const float4* __restrict__ rec, float* __restrict__ dw_part,
                  float* __restrict__ db_part, int n_rows,
                  int rows_per_split, int v, int v_pad, int blank) {
  using C = Bwd<H>;
  constexpr int S = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  int* count = reinterpret_cast<int*>(smem + C::kCount);
  uint32_t* xb = reinterpret_cast<uint32_t*>(smem + C::kXb);
  const int tid = threadIdx.x;
  const int wid = warp_uniform(tid / 32);
  const int w = wid / 4, warp = wid % 4, lane = tid % 32, t = tid % kWG;
  const int v0 = blockIdx.x * RT, split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n_rows, r_begin + rows_per_split);
  const int chunks = (r_end - r_begin + RT - 1) / RT;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(base + C::kFull + 8 * s, 1);
      count[s] = 0;
    }
    mbar_init(base + C::kXbar, 1);
    mbar_init_fence();
    mbar_expect_tx(base + C::kXbar, C::kTile);
    for (int c = 0; c < C::KC; ++c)
      tma_load_2d(base + c * RT * 128, &w_map, base + C::kXbar, c * 64, v0);
    for (int k = 0; k < S && k < chunks; ++k)
      bwd_load<H>(base, &h_map, k, r_begin + k * RT);
  }
  __syncthreads();
  WtsTile pass;
  pass.h_map = &h_map;
  pass.rec = rec;
  pass.base = base;
  pass.n_rows = n_rows;
  pass.r_begin = r_begin;
  pass.r_end = r_end;
  pass.blank = blank;
  pass.w = w;
  pass.lane = lane;
  // The thread's V rows v0 + 16 warp + lane / 4 + 8 h and their biases
  // (-inf past V).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pass.vv[h] = v0 + 16 * warp + lane / 4 + 8 * h;
    const float x = __ldg(bias + min(pass.vv[h], v - 1));
    pass.bv[h] = pass.vv[h] < v ? x : -INFINITY;
    pass.dbs[h] = 0.0f;
  }
  float acc2[H / 4];
#pragma unroll
  for (int i = 0; i < H / 4; ++i) acc2[i] = 0.0f;
  // Descriptors: X (the W tile, A of the transposed logits), the
  // warpgroup's 32 rows of a hidden chunk (their B, K-major) and its H half
  // of the chunk (dW's B, MN-major).
  const uint64_t xd0 = desc(base, 16, 1024, kSwizzle128);
  const uint64_t yk0 =
      desc(base + C::kRing + 32 * w * 128, 16, 1024, kSwizzle128);
  const uint64_t ym0 = desc(base + C::kRing + (H / 128) * w * RT * 128,
                            RT * 128, 1024, kSwizzle128);
  mbar_wait(base + C::kXbar, 0);
  bwd_loop<H>(acc2, pass, base, count, xb, w, t, lane, 0, chunks, xd0, yk0,
              ym0);

  // This split's dW rows [v0, v0 + 64) of a [v_pad, H] partial (rows past
  // V are zero and never summed): the warpgroup's H half.
  float* out = dw_part + ((size_t)split * v_pad + v0) * H;
#pragma unroll
  for (int r = 0; r < H / 4; r += 2) {
    const int row = 16 * warp + lane / 4 + 8 * ((r >> 1) & 1);
    const int col = w * (H / 2) + 8 * (r >> 2) + 2 * (lane & 3);
    *reinterpret_cast<float2*>(out + (size_t)row * H + col) =
        make_float2(acc2[r], acc2[r + 1]);
  }
  // db: each row's four threads, then the two warpgroups, in order.
  float dbs[2] = {pass.dbs[0], pass.dbs[1]};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    dbs[h] += __shfl_xor_sync(0xffffffffu, dbs[h], 1);
    dbs[h] += __shfl_xor_sync(0xffffffffu, dbs[h], 2);
  }
  __syncthreads();  // every exchange done: its buffers take db
  float* red = reinterpret_cast<float*>(xb);
  if ((lane & 3) == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      red[w * RT + 16 * warp + lane / 4 + 8 * h] = dbs[h];
  __syncthreads();
  if (tid < RT && v0 + tid < v)
    db_part[(size_t)split * v + v0 + tid] = red[tid] + red[RT + tid];
}

}  // namespace j16

// ================================================================ host ===
inline size_t round64(size_t n) { return (n + 63) / 64 * 64; }

// fp32 tiles fit this width in shared memory.
bool fits_f32(int h) {
  using namespace f32k;
  return fwd_layout(kFwdR, kFwdVT, h).bytes <= kMaxSmem &&
         rows_layout(kRowsR, kRowsVT, h).bytes <= kMaxSmem &&
         wts_layout(kWtsR, kWtsVT, h).bytes <= kMaxSmem;
}

// Pass B's row splits: V tiles x S row splits, each split a whole number
// of R-row chunks, none empty. A block's time is about proportional to its
// rows, so the run takes about ceil(tiles * S / slots) waves of N / S rows
// each (slots: the blocks the card holds at once); S <= smax minimises
// that, the smallest S on a tie.
struct Splits {
  int splits, rows_per_split, v_pad;
};

Splits splits_for(int n_rows, int v, int rows, int vt, int slots, int smax) {
  const int tiles = (v + vt - 1) / vt;
  const int chunks = (n_rows + rows - 1) / rows;
  int best = 1;
  long long best_num = 1, best_den = 0;  // waves / splits, as a fraction
  for (int s = 1; s <= smax && s <= chunks; ++s) {
    const long long waves = ((long long)tiles * s + slots - 1) / slots;
    if (best_den == 0 || waves * best_den < best_num * s) {
      best = s;
      best_num = waves;
      best_den = s;
    }
  }
  Splits sp;
  sp.rows_per_split = (chunks + best - 1) / best * rows;
  sp.splits = (n_rows + sp.rows_per_split - 1) / sp.rows_per_split;
  if (sp.splits < 1) sp.splits = 1;
  sp.v_pad = tiles * vt;
  return sp;
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

// The fp32 pass B's splits (the occupancy query also sets its launch
// attributes).
cudaError_t splits_f32(int n_rows, int h, int v, Splits* sp) {
  using namespace f32k;
  auto kb = joint_bwd_weights<kWtsR, kWtsVT>;
  const size_t bytes = wts_layout(kWtsR, kWtsVT, h).bytes;
  cudaError_t e = set_smem(kb, bytes);
  int sms = 1, per_sm = 1;
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kb, kThreads,
                                                      bytes);
  if (e != cudaSuccess) return e;
  *sp = splits_for(n_rows, v, kWtsR, kWtsVT, sms * (per_sm > 0 ? per_sm : 1),
                   16);
  return cudaSuccess;
}

// The backward's schedule: pass A's frames a block and blocks along T
// (bf16: TT minimising waves x chunks a block, the largest TT on a tie,
// which leaves fewer dpred partials; fp32: kTT) and pass B's splits.
struct BwdPlan {
  int frames, n_tt;
  Splits sp;
};

BwdPlan plan16(int b, int t, int u1, int v, int sms) {
  BwdPlan p;
  long long best = -1;
  for (int tt = 1; tt <= t; ++tt) {
    const long long blocks = (long long)b * ((t + tt - 1) / tt);
    const long long cost = (blocks + sms - 1) / sms *
                           ((tt * u1 + j16::RT - 1) / j16::RT);
    if (best < 0 || cost <= best) {
      best = cost;
      p.frames = tt;
    }
  }
  p.n_tt = (t + p.frames - 1) / p.frames;
  p.sp = splits_for(b * t * u1, v, j16::RT, j16::RT, sms, 32);
  return p;
}

// The backward's fp32 workspace, in floats, each part 256-byte aligned:
// the hidden [B*T*U1, H] in the compute type, bf16's row records (a
// float4 a row), dpred's, dW's and db's partials.
struct Workspace {
  size_t hid, rec, dpred, dw, db, total;
};

Workspace workspace(int b, int t, int u1, int h, int v, size_t elem,
                    int n_tt, const Splits& sp) {
  const size_t n_rows = (size_t)b * t * u1;
  Workspace W;
  W.hid = 0;
  W.rec = round64((n_rows * h * elem + 3) / 4);
  W.dpred = W.rec + (elem == 2 ? round64(4 * n_rows) : 0);
  W.dw = W.dpred + round64((size_t)b * n_tt * u1 * h);
  W.db = W.dw + round64((size_t)sp.splits * sp.v_pad * h);
  W.total = W.db + round64((size_t)sp.splits * v);
  return W;
}

// The workspace of either type and the plan behind it; total 0 when the
// kernels do not take this width.
cudaError_t bwd_plan(int dtype, int b, int t, int u1, int h, int v,
                     BwdPlan* p, Workspace* W) {
  W->total = 0;
  if (dtype == 1) {
    if (!j16::width_ok(h)) return cudaSuccess;
    int sms = 1;
    const cudaError_t e = sm_count(&sms);
    if (e != cudaSuccess) return e;
    *p = plan16(b, t, u1, v, sms);
    *W = workspace(b, t, u1, h, v, 2, p->n_tt, p->sp);
    return cudaSuccess;
  }
  if (!fits_f32(h)) return cudaSuccess;
  const cudaError_t e = splits_f32(b * t * u1, h, v, &p->sp);
  if (e != cudaSuccess) return e;
  p->n_tt = (t + f32k::kTT - 1) / f32k::kTT;
  *W = workspace(b, t, u1, h, v, 4, p->n_tt, p->sp);
  return cudaSuccess;
}

cudaError_t launch_fwd_f32(const float* enc, const float* pred,
                           const float* w, const float* bias,
                           const int* labels, float* blank_lp,
                           float* emit_lp, float* lse, int b, int t, int u1,
                           int h, int v, int blank, int act,
                           cudaStream_t s) {
  using namespace f32k;
  const int n_rows = b * t * u1;
  auto kernel = joint_fwd<kFwdR, kFwdVT>;
  const size_t bytes = fwd_layout(kFwdR, kFwdVT, h).bytes;
  cudaError_t e = set_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<(n_rows + kFwdR - 1) / kFwdR, kThreads, bytes, s>>>(
      enc, pred, w, bias, labels, blank_lp, emit_lp, lse, n_rows, t, u1, h,
      v, blank, act);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_fwd16(const j16::bf* enc, const j16::bf* pred,
                         const j16::bf* w, const float* bias,
                         const int* labels, float* blank_lp, float* emit_lp,
                         float* lse, int b, int t, int u1, int v, int blank,
                         int act, cudaStream_t s) {
  CUtensorMap wm;
  if (!sm90::tensor_map(&wm, w, v, H, j16::VT, 64,
                        CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const int n_rows = b * t * u1;
  auto kernel = j16::joint_fwd<H>;
  const size_t bytes = j16::Fwd<H>::kBytes + 1024;
  cudaError_t e = set_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<(n_rows + j16::Fwd<H>::ROWS - 1) / j16::Fwd<H>::ROWS,
           2 * j16::kWG, bytes, s>>>(wm, enc, pred, bias, labels, blank_lp,
                                     emit_lp, lse, n_rows, t, u1, v, blank,
                                     act);
  return cudaGetLastError();
}

// The cross-block sums, each in a fixed order.
cudaError_t sum_all(const Workspace& W, const BwdPlan& p, float* ws,
                    float* dpred, float* dw, float* db, int b, int u1, int h,
                    int v, cudaStream_t s) {
  cudaError_t e = sum_into(ws + W.dpred, dpred, b, p.n_tt, u1 * h, s);
  if (e != cudaSuccess) return e;
  e = sum_into(ws + W.dw, dw, 1, p.sp.splits, v * h, s,
               (size_t)p.sp.v_pad * h);
  if (e != cudaSuccess) return e;
  return sum_into(ws + W.db, db, 1, p.sp.splits, v, s);
}

cudaError_t launch_bwd_f32(const float* enc, const float* pred,
                           const float* w, const float* bias,
                           const int* labels, const float* gb,
                           const float* ge, const float* lse, float* denc,
                           float* dpred, float* dw, float* db, float* ws,
                           const BwdPlan& p, const Workspace& W, int b, int t,
                           int u1, int h, int v, int blank, int act,
                           cudaStream_t s) {
  using namespace f32k;
  const int n_rows = b * t * u1;
  auto ka = joint_bwd_rows<kRowsR, kRowsVT>;
  auto kb = joint_bwd_weights<kWtsR, kWtsVT>;
  const size_t a_bytes = rows_layout(kRowsR, kRowsVT, h).bytes;
  const size_t b_bytes = wts_layout(kWtsR, kWtsVT, h).bytes;
  cudaError_t e = set_smem(ka, a_bytes);
  if (e != cudaSuccess) return e;
  float* hid = ws + W.hid;
  ka<<<dim3(p.n_tt, b), kThreads, a_bytes, s>>>(
      enc, pred, w, bias, labels, gb, ge, lse, denc, ws + W.dpred, hid, t,
      u1, h, v, blank, act);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  kb<<<dim3(p.sp.v_pad / kWtsVT, p.sp.splits), kThreads, b_bytes, s>>>(
      hid, w, bias, labels, gb, ge, lse, ws + W.dw, ws + W.db, n_rows,
      p.sp.rows_per_split, t, u1, h, v, p.sp.v_pad, blank);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return sum_all(W, p, ws, dpred, dw, db, b, u1, h, v, s);
}

template <int H>
cudaError_t launch_bwd16(const j16::bf* enc, const j16::bf* pred,
                         const j16::bf* w, const float* bias,
                         const int* labels, const float* gb,
                         const float* ge, const float* lse, float* denc,
                         float* dpred, float* dw, float* db, float* ws,
                         const BwdPlan& p, const Workspace& W, int b, int t,
                         int u1, int v, int blank, int act, cudaStream_t s) {
  const int n_rows = b * t * u1;
  j16::bf* hid = reinterpret_cast<j16::bf*>(ws + W.hid);
  CUtensorMap wm, hm;
  const CUtensorMapSwizzle sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!sm90::tensor_map(&wm, w, v, H, j16::RT, 64, sw128) ||
      !sm90::tensor_map(&hm, hid, n_rows, H, j16::RT, 64, sw128))
    return cudaErrorInvalidValue;
  auto ka = j16::joint_bwd_rows<H>;
  auto kb = j16::joint_bwd_weights<H>;
  const size_t bytes = j16::Bwd<H>::kBytes + 1024;
  cudaError_t e = set_smem(ka, bytes);
  if (e == cudaSuccess) e = set_smem(kb, bytes);
  if (e != cudaSuccess) return e;
  float4* rec = reinterpret_cast<float4*>(ws + W.rec);
  ka<<<dim3(p.n_tt, b), 2 * j16::kWG, bytes, s>>>(
      wm, enc, pred, bias, labels, gb, ge, lse, denc, ws + W.dpred, hid, rec,
      t, u1, v, p.frames, blank, act);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  kb<<<dim3(p.sp.v_pad / j16::RT, p.sp.splits), 2 * j16::kWG, bytes, s>>>(
      wm, hm, bias, rec, ws + W.dw, ws + W.db, n_rows, p.sp.rows_per_split,
      v, p.sp.v_pad, blank);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return sum_all(W, p, ws, dpred, dw, db, b, u1, H, v, s);
}

}  // namespace

extern "C" {

// fp32 workspace of the backward (floats) for dtype 0 = fp32, 1 = bf16;
// 0 when the kernels do not take this width H (bf16: H in {128, 512}),
// -1 on a CUDA error.
long long rnnt_joint_bwd_workspace(int dtype, int b, int t, int u1, int h,
                                   int v) {
  BwdPlan p;
  Workspace W;
  if (bwd_plan(dtype, b, t, u1, h, v, &p, &W) != cudaSuccess) return -1;
  return (long long)W.total;
}

// Shape checks are the caller's (ops/rnnt_loss.py). act: 0 tanh, 1 relu,
// 2 swish. labels int32 [B, U1 - 1]; planes [B, T, U1] fp32.
int rnnt_joint_fwd(int dtype, int act, const void* enc, const void* pred,
                   const void* w, const float* bias, const int* labels,
                   float* blank_lp, float* emit_lp, float* lse, int b, int t,
                   int u1, int h, int v, int blank, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (!fits_f32(h)) return (int)cudaErrorInvalidValue;
    return (int)launch_fwd_f32(
        static_cast<const float*>(enc), static_cast<const float*>(pred),
        static_cast<const float*>(w), bias, labels, blank_lp, emit_lp, lse,
        b, t, u1, h, v, blank, act, s);
  }
  if (!j16::width_ok(h)) return (int)cudaErrorInvalidValue;
  using bf = j16::bf;
  auto run = h == 512 ? launch_fwd16<512> : launch_fwd16<128>;
  return (int)run(static_cast<const bf*>(enc), static_cast<const bf*>(pred),
                  static_cast<const bf*>(w), bias, labels, blank_lp, emit_lp,
                  lse, b, t, u1, v, blank, act, s);
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
  BwdPlan p;
  Workspace W;
  cudaError_t e = bwd_plan(dtype, b, t, u1, h, v, &p, &W);
  if (e != cudaSuccess) return (int)e;
  if (W.total == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd_f32(
        static_cast<const float*>(enc), static_cast<const float*>(pred),
        static_cast<const float*>(w), bias, labels, gb, ge, lse, denc, dpred,
        dw, db, ws, p, W, b, t, u1, h, v, blank, act, s);
  using bf = j16::bf;
  auto run = h == 512 ? launch_bwd16<512> : launch_bwd16<128>;
  return (int)run(static_cast<const bf*>(enc), static_cast<const bf*>(pred),
                  static_cast<const bf*>(w), bias, labels, gb, ge, lse, denc,
                  dpred, dw, db, ws, p, W, b, t, u1, v, blank, act, s);
}

}  // extern "C"
