// Whole-solve batched simplex for Hopper (sm_90a): one thread block per LP.
//
// Replaces the Pallas TPU kernel `_simplex_kernel` of
// src/repro/kernels/simplex_tile.py (launched by `simplex_pallas`).  It
// computes the same function as the port's plain engine
// (src/repro_torch/core/simplex.py, `solve_two_phase`): loop 1 runs the
// combined two-phase step on the full (m+2) x (n+2m+1) tableau until the LP
// leaves phase 1, loop 2 runs phase-2 steps on the phase-compacted view
// (rows <= m, columns < n+m plus the right-hand side), and only x, the
// objective, status, iterations, y and z are written back.
//
// Design (the paper's, Sec. 5): one CTA per LP, the tableau resident in
// dynamic shared memory together with the bound, flip, basis and weight
// rows, sentinel min-ratio and Dantzig/steepest-edge/devex pricing as block
// reductions, per-block early exit.  Phase compaction restricts the loops
// to the kept rows and columns in place, so nothing moves.  An LP whose
// tableau does not fit in shared memory runs the same body on its own slice
// of the device-memory tableau (`kSmemTableau = false`).
//
// What bounds it: each pivot is a rank-1 update of (m+2)(n+2m+1) entries
// (2 flops each) framed by two block reductions and a handful of barriers.
// From shared memory the update is cheap; the barriers and reductions
// (latency, not bandwidth) dominate a pivot at the paper's sizes, and the
// card is filled by running one LP per SM at a time.  The device-memory
// variant moves the tableau through L2 every pivot and is bound by bytes.
//
// Parity with the reference (every rule holds bit for bit against the
// plain engine):
//  * ties in the argmax/argmin reductions go to the lowest index and NaN
//    beats every number, as jnp.argmax/torch.argmax do (f32 tableaux that
//    blow up, sc205_like, reach NaN weights);
//  * `t - f * p` updates round once (__fmaf_rn), as the reference's CPU
//    build contracts them; other arithmetic uses the _rn intrinsics and the
//    file is built with -fmad=false, never with fast math (the ratio test
//    needs IEEE division);
//  * the pivot row is replaced by the scaled row, not re-added;
//  * bound lookups select, never sum (inf * 0 would poison a sum);
//  * phase 2 pins basic artificials at zero;
//  * loops 1 and 2 share one max_iters budget, counted per LP;
//  * steepest-edge norms accumulate rows in order, one rounding per term.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr float kBig = 1e30f;       // the paper's sentinel (core/lp.py BIG)
constexpr float kHalfBig = 5e29f;   // BIG / 2: no row bounds the ratio
constexpr float kDevexReset = 1e7f;
constexpr int kRunning = -1;
constexpr int kOptimal = 0;
constexpr int kUnbounded = 1;
constexpr int kInfeasible = 2;
constexpr int kIterationLimit = 3;
constexpr int kDantzig = 0;
constexpr int kSteepestEdge = 1;
constexpr int kDevex = 2;
constexpr int kRedSlots = 32;       // one per warp, up to 1024 threads
// Work counters per LP: pivots in phase 1 (full tableau), pivots in phase
// 2 (compacted view) and entering-bound flips.
constexpr int kWorkPivots1 = 0;
constexpr int kWorkPivots2 = 1;
constexpr int kWorkFlips = 2;
constexpr int kWorkCounters = 3;

// Where each buffer of one block's dynamic shared memory starts, in 4-byte
// words: the reduction scratch, the entering-column and pivot-row buffers,
// the bound, flip and basis rows, the weights of a weighted rule and, when
// it fits, the (m+2) x (n+2m+1) tableau.  The kernel carves its buffers and
// the launcher sizes the allocation from this one layout.
struct Layout {
  size_t red_i, colbuf, rowbuf, ub, flip, basis, w, T, words;
};

__host__ __device__ inline Layout layout(int m, int n, int rule,
                                         bool tableau) {
  const size_t R = m + 2, C = n + 2 * m + 1;
  Layout L;
  L.red_i = kRedSlots;
  L.colbuf = 2 * kRedSlots;
  L.rowbuf = L.colbuf + R;
  L.ub = L.rowbuf + C;
  L.flip = L.ub + n;
  L.basis = L.flip + n;
  L.w = L.basis + m;
  L.T = L.w + (rule != kDantzig ? (size_t)n + m : 0);
  L.words = L.T + (tableau ? R * C : 0);
  return L;
}

struct ArgVal {
  float v;
  int i;
};

// Does (v, i) beat (bv, bi)?  NaN beats every number and ties go to the
// lower index, as torch.argmax/argmin (and jnp's) treat them.
__device__ __forceinline__ bool wins(bool is_max, float v, int i, float bv,
                                     int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return (is_max ? v > bv : v < bv) || (v == bv && i < bi);
}

// torch.maximum: NaN if either side is NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) || isnan(b) ? a + b : fmaxf(a, b);
}

// Block-wide argmax (argmin) under `wins`, broadcast to every thread.
// Starts and ends with the block in step.
template <bool kMax>
__device__ ArgVal block_arg(ArgVal a, float* red_v, int* red_i) {
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(full, a.v, off);
    const int oi = __shfl_down_sync(full, a.i, off);
    if (wins(kMax, ov, oi, a.v, a.i)) {
      a.v = ov;
      a.i = oi;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (lane == 0) {
    red_v[warp] = a.v;
    red_i[warp] = a.i;
  }
  __syncthreads();
  if (warp == 0) {
    a.v = lane < nwarps ? red_v[lane] : (kMax ? -INFINITY : INFINITY);
    a.i = lane < nwarps ? red_i[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(full, a.v, off);
      const int oi = __shfl_down_sync(full, a.i, off);
      if (wins(kMax, ov, oi, a.v, a.i)) {
        a.v = ov;
        a.i = oi;
      }
    }
    if (lane == 0) {
      red_v[0] = a.v;
      red_i[0] = a.i;
    }
  }
  __syncthreads();
  const ArgVal r{red_v[0], red_i[0]};
  __syncthreads();
  return r;
}

// sum_{i<m} T[i][k]^2, rows in order, one rounding per term.
__device__ __forceinline__ float colsum_sq(const float* T, int C, int k,
                                           int m) {
  float acc = 0.f;
  for (int i = 0; i < m; ++i) {
    const float v = T[(size_t)i * C + k];
    acc = __fmaf_rn(v, v, acc);
  }
  return acc;
}

struct Block {
  float* T;       // (m+2) x C, row-major, rhs in column C-1
  float* colbuf;  // entering column (rows)
  float* rowbuf;  // scaled pivot row (stage columns)
  float* ub;      // n structural bounds (+inf = none)
  int* flip;      // n complement flags
  int* basis;     // m basic columns (full-tableau indices)
  float* w;       // n+m pricing weights (steepest edge, devex)
  float* red_v;
  int* red_i;
};

// One step of the LP's solve.  kFull: the full tableau (loop 1); otherwise
// the compacted view (rows <= m, columns < n+m and the rhs).  Every thread
// makes the same decisions from block-broadcast values, so control flow
// stays uniform across the block.
template <int kRule, bool kFull>
__device__ void step(const Block& s, int m, int n, float tol, float thr,
                     int& phase, int& status, int& iters, int* work) {
  const int C = n + 2 * m + 1, NP = n + m;
  const int rows = kFull ? m + 2 : m + 1;
  const int ncols = kFull ? C : NP + 1;
  const int tid = threadIdx.x, NT = blockDim.x;
  float* T = s.T;

  // ---- Step 1: entering column ------------------------------------------
  const float* cost = T + (size_t)((kFull && phase == 1) ? m + 1 : m) * C;
  ArgVal best{-INFINITY, INT_MAX};
  int not_opt = 0;  // max reduced cost <= tol fails (NaN included)
  for (int k = tid; k < NP; k += NT) {
    const float d = cost[k];
    not_opt |= !(d <= tol);
    float score = d;
    if (kRule != kDantzig)
      score = d > tol ? __fdiv_rn(__fmul_rn(d, d), s.w[k]) : -kBig;
    if (wins(true, score, k, best.v, best.i)) {
      best.v = score;
      best.i = k;
    }
  }
  if (!__syncthreads_or(not_opt)) {  // optimal for the current row
    if (kFull && phase == 1) {
      if (T[(size_t)(m + 1) * C + C - 1] > thr) {
        status = kInfeasible;
      } else {
        phase = 2;
        iters += 1;
      }
    } else {
      status = kOptimal;
    }
    return;
  }
  const int e = block_arg<true>(best, s.red_v, s.red_i).i;

  // ---- Step 2: leaving row, sentinel min-ratio ----------------------------
  for (int i = tid; i < rows; i += NT) s.colbuf[i] = T[(size_t)i * C + e];
  ArgVal lo{INFINITY, INT_MAX};
  for (int i = tid; i < m; i += NT) {
    const float col = T[(size_t)i * C + e];
    const float rhs = T[(size_t)i * C + C - 1];
    float r = col > tol ? __fdiv_rn(rhs, col) : kBig;
    const int bi = s.basis[i];
    if (bi < n && col < -tol && isfinite(s.ub[bi]))
      r = __fdiv_rn(__fsub_rn(s.ub[bi], rhs), -col);
    if (phase == 2 && bi >= NP && col < -tol) r = 0.f;
    if (wins(false, r, i, lo.v, lo.i)) {
      lo.v = r;
      lo.i = i;
    }
  }
  const ArgVal lr = block_arg<false>(lo, s.red_v, s.red_i);
  const int l = lr.i;
  const float min_ratio = lr.v;

  // ---- Step 3a: entering-bound flip --------------------------------------
  const float ub_e = e < n ? s.ub[e] : INFINITY;
  if (ub_e < min_ratio) {
    for (int i = tid; i < rows; i += NT) {
      float* row = T + (size_t)i * C;
      row[C - 1] = __fmaf_rn(-ub_e, s.colbuf[i], row[C - 1]);
      row[e] = -row[e];
    }
    if (tid == 0) s.flip[e] ^= 1;
    work[kWorkFlips] += 1;
    iters += 1;
    __syncthreads();
    return;
  }
  if (min_ratio >= kHalfBig) {  // no bounding row
    status = phase == 2 ? kUnbounded : kIterationLimit;
    iters += 1;
    return;
  }

  // ---- Step 3b: pivot (leaving-at-upper complement folded into the row) --
  float pe = s.colbuf[l];
  const int jl = s.basis[l];
  const bool comp = pe < 0.f && jl < n;
  const float ub_jl = comp ? s.ub[jl] : 0.f;
  if (comp) pe = -pe;
  const float w_e = kRule == kDevex ? s.w[e] : 0.f;
  for (int k = tid; k < ncols; k += NT) {
    const int j = k < ncols - 1 ? k : C - 1;
    float v = T[(size_t)l * C + j];
    if (comp) {
      v = -v;
      if (j == C - 1) v = __fadd_rn(v, ub_jl);
      if (j == jl) v = 1.f;
    }
    s.rowbuf[k] = __fdiv_rn(v, pe);
  }
  __syncthreads();
  if (tid == 0 && comp) s.flip[jl] ^= 1;
  for (int r = tid / ncols, k = tid % ncols; r < rows;) {
    const int j = k < ncols - 1 ? k : C - 1;
    float* t = T + (size_t)r * C + j;
    *t = r == l ? s.rowbuf[k] : __fmaf_rn(-s.colbuf[r], s.rowbuf[k], *t);
    k += NT;
    while (k >= ncols) {
      k -= ncols;
      ++r;
    }
  }
  __syncthreads();

  if (kRule == kSteepestEdge) {
    for (int k = tid; k < NP; k += NT)
      s.w[k] = __fadd_rn(1.f, colsum_sq(T, C, k, m));
  } else if (kRule == kDevex) {
    const float w_leave = max_nan(__fdiv_rn(w_e, __fmul_rn(pe, pe)), 1.f);
    int over = 0, has_nan = 0;
    for (int k = tid; k < NP; k += NT) {
      float v;
      if (k == e) {
        v = 1.f;
      } else if (k == jl) {
        v = w_leave;
      } else {
        const float p = s.rowbuf[k];
        v = max_nan(s.w[k], __fmul_rn(__fmul_rn(p, p), w_e));
      }
      s.w[k] = v;
      over |= v > kDevexReset;
      has_nan |= isnan(v);
    }
    // reset when max(w) > DEVEX_RESET; a NaN max compares false
    const bool any_nan = __syncthreads_or(has_nan);
    if (__syncthreads_or(over) && !any_nan)
      for (int k = tid; k < NP; k += NT) s.w[k] = 1.f;
  }
  if (tid == 0) s.basis[l] = e;
  work[kFull ? kWorkPivots1 : kWorkPivots2] += 1;
  iters += 1;
  __syncthreads();
}

template <int kRule, bool kSmemTableau>
__global__ void __launch_bounds__(1024)
    simplex_tile_kernel(float* __restrict__ Tg, const int* __restrict__ basis0,
                        const int* __restrict__ phase0,
                        const float* __restrict__ thr0,
                        const float* __restrict__ ubg, float* __restrict__ x_out,
                        float* __restrict__ obj_out, int* __restrict__ status_out,
                        int* __restrict__ iters_out, float* __restrict__ y_out,
                        float* __restrict__ z_out, int* __restrict__ work_out,
                        int m, int n, int max_iters, float tol) {
  extern __shared__ __align__(16) float smem[];
  const int R = m + 2, C = n + 2 * m + 1, NP = n + m;
  const int tid = threadIdx.x, NT = blockDim.x;
  const size_t lp = blockIdx.x;

  const Layout L = layout(m, n, kRule, kSmemTableau);
  Block s;
  s.red_v = smem;
  s.red_i = reinterpret_cast<int*>(smem + L.red_i);
  s.colbuf = smem + L.colbuf;
  s.rowbuf = smem + L.rowbuf;
  s.ub = smem + L.ub;
  s.flip = reinterpret_cast<int*>(smem + L.flip);
  s.basis = reinterpret_cast<int*>(smem + L.basis);
  s.w = smem + L.w;
  float* Tg_lp = Tg + lp * (size_t)R * C;
  s.T = kSmemTableau ? smem + L.T : Tg_lp;

  if (kSmemTableau)
    for (int i = tid; i < R * C; i += NT) s.T[i] = Tg_lp[i];
  for (int j = tid; j < n; j += NT) {
    s.ub[j] = ubg[lp * n + j];
    s.flip[j] = 0;
  }
  for (int i = tid; i < m; i += NT) s.basis[i] = basis0[lp * m + i];
  int phase = phase0[lp];
  const float thr = thr0[lp];
  int status = kRunning, iters = 0;
  int work[kWorkCounters] = {0, 0, 0};
  __syncthreads();
  if (kRule == kSteepestEdge)
    for (int k = tid; k < NP; k += NT)
      s.w[k] = __fadd_rn(1.f, colsum_sq(s.T, C, k, m));
  if (kRule == kDevex)
    for (int k = tid; k < NP; k += NT) s.w[k] = 1.f;
  __syncthreads();

  while (status == kRunning && phase == 1 && iters < max_iters)
    step<kRule, true>(s, m, n, tol, thr, phase, status, iters, work);
  if (status == kRunning && phase == 1) status = kIterationLimit;
  while (status == kRunning && iters < max_iters)
    step<kRule, false>(s, m, n, tol, thr, phase, status, iters, work);
  if (status == kRunning) status = kIterationLimit;
  __syncthreads();

  // ---- extraction: x staged in rowbuf, duals off the objective row -------
  for (int j = tid; j < n; j += NT) s.rowbuf[j] = 0.f;
  __syncthreads();
  for (int i = tid; i < m; i += NT) {
    const int bi = s.basis[i];
    if (bi < n) s.rowbuf[bi] = s.T[(size_t)i * C + C - 1];
  }
  __syncthreads();
  const bool opt = status == kOptimal;
  const float nan = __int_as_float(0x7fc00000);
  const float* obj_row = s.T + (size_t)m * C;
  for (int j = tid; j < n; j += NT) {
    const float xv = s.rowbuf[j];
    x_out[lp * n + j] = s.flip[j] ? __fsub_rn(s.ub[j], xv) : xv;
    const float zv = obj_row[j];
    z_out[lp * n + j] = opt ? (s.flip[j] ? -zv : zv) : nan;
  }
  for (int i = tid; i < m; i += NT)
    y_out[lp * m + i] = opt ? -obj_row[n + i] : nan;
  if (tid == 0) {
    obj_out[lp] = opt ? -obj_row[C - 1] : nan;
    status_out[lp] = status;
    iters_out[lp] = iters;
    if (work_out != nullptr)
      for (int k = 0; k < kWorkCounters; ++k)
        work_out[lp * kWorkCounters + k] = work[k];
  }
}

template <int kRule, bool kSmemTableau>
cudaError_t launch(float* T, const int* basis, const int* phase,
                   const float* thr, const float* ub, float* x, float* obj,
                   int* status, int* iters, float* y, float* z, int* work,
                   int B, int m, int n, int max_iters, float tol, int threads,
                   cudaStream_t stream) {
  auto kernel = simplex_tile_kernel<kRule, kSmemTableau>;
  const size_t smem = sizeof(float) * layout(m, n, kRule, kSmemTableau).words;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, smem, stream>>>(T, basis, phase, thr, ub, x, obj,
                                       status, iters, y, z, work, m, n,
                                       max_iters, tol);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block takes, with the tableau in
// shared memory (tableau != 0) or left in device memory.
extern "C" long long simplex_tile_smem_bytes(int m, int n, int rule,
                                             int tableau) {
  return (long long)(sizeof(float) * layout(m, n, rule, tableau != 0).words);
}

// Whether the launcher keeps the tableau in shared memory on the current
// device: 1 or 0, or minus a CUDA error code.
extern "C" int simplex_tile_tableau_in_smem(int m, int n, int rule) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  return simplex_tile_smem_bytes(m, n, rule, 1) <= limit;
}

// Launches one block per LP on `stream`; allocates nothing and does not
// synchronise.  The tableau stays in shared memory when it fits on the
// current device; otherwise T (B, m+2, n+2m+1) is updated in place.  `work`
// (B, 3), when not null, receives each LP's phase-1 pivots, phase-2 pivots
// and bound flips.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int simplex_tile_launch(void* T, const void* basis,
                                   const void* phase, const void* thr,
                                   const void* ub, void* x, void* obj,
                                   void* status, void* iters, void* y, void* z,
                                   void* work, int B, int m, int n,
                                   int max_iters, float tol, int rule,
                                   int threads, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (m < 1 || n < 1 || threads < 32 || threads > 1024 || threads % 32 ||
      rule < kDantzig || rule > kDevex)
    return cudaErrorInvalidValue;
  const int in_smem = simplex_tile_tableau_in_smem(m, n, rule);
  if (in_smem < 0) return -in_smem;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* Tf = static_cast<float*>(T);
  auto* bi = static_cast<const int*>(basis);
  auto* ph = static_cast<const int*>(phase);
  auto* th = static_cast<const float*>(thr);
  auto* u = static_cast<const float*>(ub);
  auto* xo = static_cast<float*>(x);
  auto* oo = static_cast<float*>(obj);
  auto* so = static_cast<int*>(status);
  auto* io = static_cast<int*>(iters);
  auto* yo = static_cast<float*>(y);
  auto* zo = static_cast<float*>(z);
  auto* wo = static_cast<int*>(work);
#define SIMPLEX_TILE_LAUNCH(RULE, SMEM)                                      \
  return launch<RULE, SMEM>(Tf, bi, ph, th, u, xo, oo, so, io, yo, zo, wo, \
                            B, m, n, max_iters, tol, threads, st)
  if (in_smem) {
    if (rule == kDantzig) SIMPLEX_TILE_LAUNCH(kDantzig, true);
    if (rule == kSteepestEdge) SIMPLEX_TILE_LAUNCH(kSteepestEdge, true);
    SIMPLEX_TILE_LAUNCH(kDevex, true);
  }
  if (rule == kDantzig) SIMPLEX_TILE_LAUNCH(kDantzig, false);
  if (rule == kSteepestEdge) SIMPLEX_TILE_LAUNCH(kSteepestEdge, false);
  SIMPLEX_TILE_LAUNCH(kDevex, false);
#undef SIMPLEX_TILE_LAUNCH
}
