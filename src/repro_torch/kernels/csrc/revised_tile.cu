// Batched revised simplex for Hopper (sm_90a): one thread block per LP.
//
// `revised_segment_kernel` replaces the Pallas TPU kernel
// `_revised_segment_kernel` of src/repro/kernels/revised_tile.py (launched
// by `revised_segment_pallas`, driven by the `revised_pallas` host loop and
// `RevisedPallasBackend`).  It computes the port's plain segment
// (src/repro_torch/core/revised.py, `revised_segment`): state in, at most
// `steps` revised steps per LP, state out.  Stage p1 steps an LP while it is
// running, in phase 1 and under its cap; stage p2 while it is running and
// under its cap.  The whole solve is one launch of stage p2 with `steps` =
// `max_iters` (`revised_tile` in kernels/revised_tile.py).  A block whose LP
// has nothing to do returns before it loads anything.
//
// One step (the reference's `revised_step`): BTRAN y = Binv^T c_B; pricing
// d_j = c_j - y . a_j over the n+m candidates (Dantzig, or partial: a
// rotating block first, every column only when the block prices out); FTRAN
// u = Binv a_e; the sentinel ratio test with bounded columns; then a bound
// flip, a pivot or a terminal status.  A pivot applies its eta to the dense
// inverse at once (the pivot row divided by u_l, every other row minus u_i
// times it) instead of appending it to a file that BTRAN would replay as a
// chain of K fixed-order dot products.
//
// Where the port leaves the TPU design on purpose: Pallas cannot lower an
// LU, so the reference refactorizes on the host between launches.  Here the
// block refactorizes its own basis matrix by Gauss-Jordan with partial
// pivoting (the plain `_gauss_solve`, step for step) at its first step in
// a segment and whenever K = `refactor_period` pivots have passed since the
// last one (the eta clock, per LP).  That is the reference's schedule at
// tile_b = 1, and the whole solve needs no host round trip.
//
// Layout: the Gauss-Jordan workspace [B | I] (m x 2m), whose right half is
// Binv, sits in dynamic shared memory with the vectors (80 KB at 100x100,
// so two blocks share an SM); `Abar` (m x (n+2m)) stays in device memory
// and is read through L2, a column per thread while pricing.  A basis too
// large for shared memory (sc205_like, 246x159: 484 KB) keeps the workspace
// in the block's own slice of a device-memory scratch buffer and runs the
// same body.
//
// What bounds it: operations per step of BTRAN (2m^2), pricing (2m per
// priced column), FTRAN (2m^2) and the eta update (2m^2), plus about 2m^3
// per refactorization; every dot product is summed by one thread in a fixed
// order (in double), so a step is a few dependent chains of m adds framed
// by barriers and two block reductions: latency, not bandwidth or flops,
// at the paper's sizes.  The design keeps everything but `Abar` in shared
// memory, fills the card with one LP per block, and prices a partial block
// before the rest.  No wgmma, no TMA: a first version, right and simple.
//
// Parity with the plain version (bit for bit):
//  * every dot product adds exact products in index order in double and
//    rounds once to float (core/fp.py `sum_products`); every `a - b * c`
//    update rounds once (__fmaf_rn; the file is built with -fmad=false);
//    row sums add in index order in float;
//  * argmax/argmin ties go to the lowest index and NaN beats every number,
//    as torch.argmax/argmin do;
//  * bound lookups select, never sum; phase 2 pins basic artificials;
//  * the ratio test reads a basic value below its bound as at the bound.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr float kBig = 1e30f;      // the paper's sentinel (core/lp.py BIG)
constexpr float kHalfBig = 5e29f;  // BIG / 2: no row bounds the ratio
constexpr int kRunning = -1;
constexpr int kOptimal = 0;
constexpr int kUnbounded = 1;
constexpr int kInfeasible = 2;
constexpr int kIterationLimit = 3;
constexpr int kDantzig = 0;
constexpr int kPartial = 1;
constexpr int kPartialBlock = 64;  // core/pricing.py PARTIAL_BLOCK
constexpr int kRedSlots = 32;
// Work counters per LP (core/revised.py WORK_FIELDS).
constexpr int kWorkSteps = 0;
constexpr int kWorkPivots = 1;
constexpr int kWorkFlips = 2;
constexpr int kWorkRefactors = 3;
constexpr int kWorkPriced = 4;
constexpr int kWorkCounters = 5;

// One block's dynamic shared memory in 4-byte words: reduction scratch,
// the vectors, and (when it fits) the m x 2m Gauss-Jordan workspace.
struct Layout {
  size_t red_i, cvec, ub, onub, basis, basic, xB, cB, y, ae, u, d, colbuf,
      rowbuf, aug, words;
};

__host__ __device__ inline Layout layout(int m, int n, bool aug_smem) {
  const size_t NP = (size_t)n + m;
  Layout L;
  L.red_i = kRedSlots;
  L.cvec = 2 * kRedSlots;
  L.ub = L.cvec + NP;
  L.onub = L.ub + n;
  L.basis = L.onub + n;
  L.basic = L.basis + m;
  L.xB = L.basic + NP;
  L.cB = L.xB + m;
  L.y = L.cB + m;
  L.ae = L.y + m;
  L.u = L.ae + m;
  L.d = L.u + m;
  L.colbuf = L.d + NP;
  L.rowbuf = L.colbuf + m;
  L.aug = L.rowbuf + 2 * (size_t)m;
  L.words = L.aug + (aug_smem ? 2 * (size_t)m * m : 0);
  return L;
}

struct ArgVal {
  float v;
  int i;
};

// Does (v, i) beat (bv, bi)?  NaN beats every number and ties go to the
// lower index, as torch.argmax/argmin treat them.
__device__ __forceinline__ bool wins(bool is_max, float v, int i, float bv,
                                     int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return (is_max ? v > bv : v < bv) || (v == bv && i < bi);
}

// v where it is positive, else 0 (NaN and -0 included): a basic value a
// rounding put below its bound counts as at the bound in the ratio test.
__device__ __forceinline__ float nonneg(float v) { return v > 0.f ? v : 0.f; }

// Block-wide argmax (argmin) under `wins`, broadcast to every thread.
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

// The state a segment reads and writes, one row per LP (see
// src/repro_torch/core/revised.py, `RevisedState`).  Abar, cvec, ub and thr
// are read-only; onub is one byte per structural column; `it` receives the
// steps each LP took; `aug` is the device-memory workspace (B x m x 2m) of
// the variant that needs one, else null.
struct SegmentState {
  const float* Abar;
  const float* cvec;
  const float* ub;
  const float* thr;
  float* xB;
  int* basis;
  bool* onub;
  int* phase;
  int* status;
  int* iters;
  float* y;
  int* work;
  int* it;
  float* aug;
};

struct Block {
  const float* Abar;  // m x (n+2m), device memory
  float* aug;         // m x 2m Gauss-Jordan workspace; Binv = aug + m
  float* cvec;
  float* ub;
  int* onub;
  int* basis;
  int* basic;  // candidate column is basic
  float *xB, *cB, *y, *ae, *u, *d, *colbuf, *rowbuf;
  float* red_v;
  int* red_i;
};

__device__ inline Block carve(float* smem, const Layout& L, const float* Abar,
                              float* aug_g, bool aug_smem) {
  Block s;
  s.Abar = Abar;
  s.red_v = smem;
  s.red_i = reinterpret_cast<int*>(smem + L.red_i);
  s.cvec = smem + L.cvec;
  s.ub = smem + L.ub;
  s.onub = reinterpret_cast<int*>(smem + L.onub);
  s.basis = reinterpret_cast<int*>(smem + L.basis);
  s.basic = reinterpret_cast<int*>(smem + L.basic);
  s.xB = smem + L.xB;
  s.cB = smem + L.cB;
  s.y = smem + L.y;
  s.ae = smem + L.ae;
  s.u = smem + L.u;
  s.d = smem + L.d;
  s.colbuf = smem + L.colbuf;
  s.rowbuf = smem + L.rowbuf;
  s.aug = aug_smem ? smem + L.aug : aug_g;
  return s;
}

// Binv of the current basis, by Gauss-Jordan on [B | I] with partial
// pivoting: the plain `_gauss_solve` step for step.  Columns left of the
// pivot are never read again, so each step updates columns k..2m-1.
__device__ void refactor(const Block& s, int m, int n) {
  const int tid = threadIdx.x, NT = blockDim.x;
  const int LD = 2 * m, NC = n + 2 * m;
  float* aug = s.aug;
  for (int idx = tid; idx < m * LD; idx += NT) {
    const int i = idx / LD, j = idx % LD;
    aug[idx] = j < m ? s.Abar[(size_t)i * NC + s.basis[j]]
                     : (j - m == i ? 1.f : 0.f);
  }
  __syncthreads();
  for (int k = 0; k < m; ++k) {
    ArgVal best{-INFINITY, INT_MAX};
    for (int i = k + tid; i < m; i += NT) {
      const float v = fabsf(aug[(size_t)i * LD + k]);
      if (wins(true, v, i, best.v, best.i)) {
        best.v = v;
        best.i = i;
      }
    }
    const int p = block_arg<true>(best, s.red_v, s.red_i).i;
    const int W = LD - k;
    if (p != k) {
      for (int j = tid; j < W; j += NT) {
        float* a = aug + (size_t)k * LD + k + j;
        float* b = aug + (size_t)p * LD + k + j;
        const float t = *a;
        *a = *b;
        *b = t;
      }
      __syncthreads();
    }
    const float piv = aug[(size_t)k * LD + k];
    for (int i = tid; i < m; i += NT) s.colbuf[i] = aug[(size_t)i * LD + k];
    for (int j = tid; j < W; j += NT)
      s.rowbuf[j] = __fdiv_rn(aug[(size_t)k * LD + k + j], piv);
    __syncthreads();
    for (int idx = tid; idx < m * W; idx += NT) {
      const int i = idx / W, j = idx % W;
      float* a = aug + (size_t)i * LD + k + j;
      *a = i == k ? s.rowbuf[j] : __fmaf_rn(-s.colbuf[i], s.rowbuf[j], *a);
    }
    __syncthreads();
  }
}

// acc + a * b with the product exact in double and one double rounding:
// one term of core/fp.py `sum_products`.
__device__ __forceinline__ double add_product(double acc, float a, float b) {
  return __dadd_rn(acc, __dmul_rn((double)a, (double)b));
}

// sum_i Binv[i][j] * v[i] for every j < m, rows in order, into out.
__device__ inline void btran(const Block& s, int m, const float* v,
                             float* out) {
  const float* Binv = s.aug + m;
  const int LD = 2 * m;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    double acc = 0.0;
    for (int i = 0; i < m; ++i)
      acc = add_product(acc, Binv[(size_t)i * LD + j], v[i]);
    out[j] = __double2float_rn(acc);
  }
  __syncthreads();
}

// Reduced cost of candidate j (the plain version's d_j, masked).
__device__ inline float price(const Block& s, int m, int n, int j,
                              bool phase2) {
  const int NC = n + 2 * m;
  double acc = 0.0;
  for (int i = 0; i < m; ++i)
    acc = add_product(acc, s.Abar[(size_t)i * NC + j], s.y[i]);
  float dv = __fsub_rn(phase2 ? s.cvec[j] : 0.f, __double2float_rn(acc));
  if (j < n && s.onub[j]) dv = -dv;
  if (s.basic[j]) dv = -kBig;
  s.d[j] = dv;
  return dv;
}

// Argmax of the stored d over [0, NP).
__device__ inline ArgVal argmax_d(const Block& s, int NP) {
  ArgVal best{-INFINITY, INT_MAX};
  for (int j = threadIdx.x; j < NP; j += blockDim.x)
    if (wins(true, s.d[j], j, best.v, best.i)) {
      best.v = s.d[j];
      best.i = j;
    }
  return block_arg<true>(best, s.red_v, s.red_i);
}

// Per-LP scalars, identical in every thread of the block.
struct Scalars {
  int phase, status, iters, cnt;
  float thr;
  int work[kWorkCounters];
};

template <int kRule>
__device__ void step(const Block& s, int m, int n, float tol, int K,
                     Scalars& v) {
  const int tid = threadIdx.x, NT = blockDim.x;
  const int NP = n + m, NC = n + 2 * m, LD = 2 * m;
  float* Binv = s.aug + m;

  // ---- refactor when the eta clock is due (the first step of a segment) --
  if (v.cnt >= K) {
    refactor(s, m, n);
    v.cnt = 0;
    v.work[kWorkRefactors] += 1;
  }

  // ---- BTRAN + pricing ----------------------------------------------------
  for (int j = tid; j < NP; j += NT) s.basic[j] = 0;
  __syncthreads();
  for (int i = tid; i < m; i += NT) {
    const int bi = s.basis[i];
    if (bi < NP) s.basic[bi] = 1;
    s.cB[i] = v.phase == 1 ? (bi >= NP ? -1.f : 0.f)
                           : (bi < NP ? s.cvec[bi] : 0.f);
  }
  __syncthreads();
  btran(s, m, s.cB, s.y);
  const bool p2 = v.phase == 2;
  ArgVal best{-INFINITY, INT_MAX};
  int priced = NP;
  if (kRule == kPartial) {
    const int bs = NP < kPartialBlock ? NP : kPartialBlock;
    const int nblk = (NP + bs - 1) / bs;
    const int lo = (v.iters % nblk) * bs;
    const int hi = lo + bs < NP ? lo + bs : NP;
    for (int j = lo + tid; j < hi; j += NT) {
      const float dv = price(s, m, n, j, p2);
      if (wins(true, dv, j, best.v, best.i)) {
        best.v = dv;
        best.i = j;
      }
    }
    best = block_arg<true>(best, s.red_v, s.red_i);
    if (best.v > tol) {
      priced = hi - lo;
    } else {
      for (int j = tid; j < NP; j += NT)
        if (j < lo || j >= hi) price(s, m, n, j, p2);
      __syncthreads();
      best = argmax_d(s, NP);
    }
  } else {
    for (int j = tid; j < NP; j += NT) {
      const float dv = price(s, m, n, j, p2);
      if (wins(true, dv, j, best.v, best.i)) {
        best.v = dv;
        best.i = j;
      }
    }
    best = block_arg<true>(best, s.red_v, s.red_i);
  }
  v.work[kWorkSteps] += 1;
  v.work[kWorkPriced] += priced;
  const int e = best.i;

  if (best.v <= tol) {  // optimal for the current objective
    if (v.phase == 1) {
      if (tid == 0) {
        float acc = 0.f;
        for (int i = 0; i < m; ++i)
          acc = __fadd_rn(acc, s.basis[i] >= NP ? s.xB[i] : 0.f);
        s.red_v[0] = acc;
      }
      __syncthreads();
      const float p1_obj = s.red_v[0];
      __syncthreads();
      if (p1_obj > v.thr) {
        v.status = kInfeasible;
      } else {
        v.phase = 2;
        v.iters += 1;
      }
    } else {
      v.status = kOptimal;
    }
    return;
  }

  // ---- FTRAN + sentinel ratio test ----------------------------------------
  for (int i = tid; i < m; i += NT) s.ae[i] = s.Abar[(size_t)i * NC + e];
  __syncthreads();
  for (int i = tid; i < m; i += NT) {
    double acc = 0.0;
    for (int j = 0; j < m; ++j)
      acc = add_product(acc, Binv[(size_t)i * LD + j], s.ae[j]);
    s.u[i] = __double2float_rn(acc);
  }
  __syncthreads();
  const bool onub_e = e < n && s.onub[e];
  ArgVal lo{INFINITY, INT_MAX};
  for (int i = tid; i < m; i += NT) {
    const float uc = onub_e ? -s.u[i] : s.u[i];
    const float xb = s.xB[i];
    float r = uc > tol ? __fdiv_rn(nonneg(xb), uc) : kBig;
    const int bi = s.basis[i];
    const float ubB = bi < n ? s.ub[bi] : INFINITY;
    if (uc < -tol && isfinite(ubB))
      r = __fdiv_rn(nonneg(__fsub_rn(ubB, xb)), -uc);
    if (v.phase == 2 && bi >= NP && uc < -tol) r = 0.f;
    if (wins(false, r, i, lo.v, lo.i)) {
      lo.v = r;
      lo.i = i;
    }
  }
  const ArgVal lr = block_arg<false>(lo, s.red_v, s.red_i);
  const int l = lr.i;
  const float min_ratio = lr.v;
  const float t_e = e < n ? s.ub[e] : INFINITY;

  if (t_e < min_ratio) {  // the entering variable reaches its own bound
    for (int i = tid; i < m; i += NT) {
      const float uc = onub_e ? -s.u[i] : s.u[i];
      s.xB[i] = __fmaf_rn(-t_e, uc, s.xB[i]);
    }
    if (tid == 0) s.onub[e] ^= 1;
    v.work[kWorkFlips] += 1;
    v.iters += 1;
    __syncthreads();
    return;
  }
  if (min_ratio >= kHalfBig) {  // no bounding row
    v.status = v.phase == 2 ? kUnbounded : kIterationLimit;
    v.iters += 1;
    return;
  }

  // ---- pivot: basic values, bound flags, eta update of Binv ---------------
  const float enter_val = onub_e ? __fsub_rn(t_e, min_ratio) : min_ratio;
  const int jl = s.basis[l];
  const float ucl = onub_e ? -s.u[l] : s.u[l];
  const bool leave_up = jl < n && ucl < -tol && isfinite(s.ub[jl]);
  const float ul = s.u[l];
  for (int j = tid; j < m; j += NT)
    s.rowbuf[j] = __fdiv_rn(Binv[(size_t)l * LD + j], ul);
  __syncthreads();
  for (int i = tid; i < m; i += NT) {
    const float uc = onub_e ? -s.u[i] : s.u[i];
    s.xB[i] = i == l ? enter_val : __fmaf_rn(-min_ratio, uc, s.xB[i]);
  }
  for (int idx = tid; idx < m * m; idx += NT) {
    const int i = idx / m, j = idx % m;
    float* b = Binv + (size_t)i * LD + j;
    *b = i == l ? s.rowbuf[j] : __fmaf_rn(-s.u[i], s.rowbuf[j], *b);
  }
  if (tid == 0) {
    if (e < n) s.onub[e] = 0;
    if (leave_up) s.onub[jl] = 1;
    s.basis[l] = e;
  }
  v.cnt += 1;
  v.work[kWorkPivots] += 1;
  v.iters += 1;
  __syncthreads();
}

template <int kRule, bool kAugSmem, bool kP1>
__global__ void __launch_bounds__(1024)
    revised_segment_kernel(SegmentState g, int m, int n, int steps,
                           int max_iters, float tol, int K) {
  const int NP = n + m, NC = n + 2 * m;
  const int tid = threadIdx.x, NT = blockDim.x;
  const size_t lp = blockIdx.x;
  Scalars v;
  v.phase = g.phase[lp];
  v.status = g.status[lp];
  v.iters = g.iters[lp];
  const bool stage_ok = !kP1 || v.phase == 1;
  if (!(v.status == kRunning && stage_ok && v.iters < max_iters &&
        steps > 0)) {
    // nothing to do: the state is never loaded
    if (tid == 0) {
      g.it[lp] = 0;
      if (v.status == kRunning && stage_ok && v.iters >= max_iters)
        g.status[lp] = kIterationLimit;
    }
    return;
  }

  extern __shared__ __align__(16) float smem[];
  const Block s =
      carve(smem, layout(m, n, kAugSmem), g.Abar + lp * (size_t)m * NC,
            kAugSmem ? nullptr : g.aug + lp * (size_t)m * 2 * m, kAugSmem);
  for (int j = tid; j < NP; j += NT) s.cvec[j] = g.cvec[lp * NP + j];
  for (int j = tid; j < n; j += NT) {
    s.ub[j] = g.ub[lp * n + j];
    s.onub[j] = g.onub[lp * n + j];
  }
  for (int i = tid; i < m; i += NT) {
    s.basis[i] = g.basis[lp * m + i];
    s.xB[i] = g.xB[lp * m + i];
  }
  v.thr = g.thr[lp];
  v.cnt = K;  // refactor at the first step
  for (int k = 0; k < kWorkCounters; ++k)
    v.work[k] = g.work[lp * kWorkCounters + k];
  __syncthreads();

  int it = 0;
  while (v.status == kRunning && (!kP1 || v.phase == 1) &&
         v.iters < max_iters && it < steps) {
    step<kRule>(s, m, n, tol, K, v);
    ++it;
  }
  if (v.status == kRunning && (!kP1 || v.phase == 1) && v.iters >= max_iters)
    v.status = kIterationLimit;
  __syncthreads();

  // y = c_B Binv under the phase-2 costs, for the extraction
  for (int i = tid; i < m; i += NT) {
    const int bi = s.basis[i];
    s.cB[i] = bi < NP ? s.cvec[bi] : 0.f;
  }
  __syncthreads();
  btran(s, m, s.cB, s.y);
  for (int i = tid; i < m; i += NT) {
    g.xB[lp * m + i] = s.xB[i];
    g.basis[lp * m + i] = s.basis[i];
    g.y[lp * m + i] = s.y[i];
  }
  for (int j = tid; j < n; j += NT) g.onub[lp * n + j] = s.onub[j] != 0;
  if (tid == 0) {
    g.phase[lp] = v.phase;
    g.status[lp] = v.status;
    g.iters[lp] = v.iters;
    g.it[lp] = it;
    for (int k = 0; k < kWorkCounters; ++k)
      g.work[lp * kWorkCounters + k] = v.work[k];
  }
}

template <int kRule, bool kAugSmem, bool kP1>
cudaError_t launch(const SegmentState& g, int B, int m, int n, int steps,
                   int max_iters, float tol, int K, int threads,
                   cudaStream_t stream) {
  auto kernel = revised_segment_kernel<kRule, kAugSmem, kP1>;
  const size_t smem = sizeof(float) * layout(m, n, kAugSmem).words;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, smem, stream>>>(g, m, n, steps, max_iters, tol, K);
  return cudaGetLastError();
}

template <int kRule>
cudaError_t dispatch(bool aug_smem, bool p1, const SegmentState& g, int B,
                     int m, int n, int steps, int max_iters, float tol, int K,
                     int threads, cudaStream_t st) {
  if (aug_smem) {
    if (p1)
      return launch<kRule, true, true>(g, B, m, n, steps, max_iters, tol, K,
                                       threads, st);
    return launch<kRule, true, false>(g, B, m, n, steps, max_iters, tol, K,
                                      threads, st);
  }
  if (p1)
    return launch<kRule, false, true>(g, B, m, n, steps, max_iters, tol, K,
                                      threads, st);
  return launch<kRule, false, false>(g, B, m, n, steps, max_iters, tol, K,
                                     threads, st);
}

}  // namespace

// Bytes of dynamic shared memory one block takes, with the Gauss-Jordan
// workspace in shared memory (aug != 0) or in device memory.
extern "C" long long revised_tile_smem_bytes(int m, int n, int aug) {
  return (long long)(sizeof(float) * layout(m, n, aug != 0).words);
}

// Whether the launcher keeps the workspace in shared memory on the current
// device: 1 or 0, or minus a CUDA error code.
extern "C" int revised_tile_aug_in_smem(int m, int n) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  return revised_tile_smem_bytes(m, n, 1) <= limit;
}

// Launches one segment block per LP on `stream`; allocates nothing and does
// not synchronise.  Abar (B, m, n+2m), cvec (B, n+m), ub (B, n) and thr (B,)
// are read; xB (B, m), basis (B, m), onub (B, n) bytes, phase, status,
// iters (B,), y (B, m) and work (B, 5) are updated in place; `it` (B,)
// receives the steps each LP took.  `aug` is a (B, m, 2m) float scratch
// buffer, needed (not null) only when revised_tile_aug_in_smem is 0.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int revised_segment_launch(
    const void* Abar, const void* cvec, const void* ub, const void* thr,
    void* xB, void* basis, void* onub, void* phase, void* status, void* iters,
    void* y, void* work, void* it, void* aug, int B, int m, int n, int p1,
    int steps, int max_iters, float tol, int K, int rule, int threads,
    void* stream) {
  if (B <= 0) return cudaSuccess;
  if (m < 1 || n < 1 || K < 1 || threads < 32 || threads > 1024 ||
      threads % 32 || (rule != kDantzig && rule != kPartial))
    return cudaErrorInvalidValue;
  const int in_smem = revised_tile_aug_in_smem(m, n);
  if (in_smem < 0) return -in_smem;
  if (!in_smem && aug == nullptr) return cudaErrorInvalidValue;
  const SegmentState g{
      static_cast<const float*>(Abar), static_cast<const float*>(cvec),
      static_cast<const float*>(ub),   static_cast<const float*>(thr),
      static_cast<float*>(xB),         static_cast<int*>(basis),
      static_cast<bool*>(onub),        static_cast<int*>(phase),
      static_cast<int*>(status),       static_cast<int*>(iters),
      static_cast<float*>(y),          static_cast<int*>(work),
      static_cast<int*>(it),           static_cast<float*>(aug)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rule == kDantzig)
    return dispatch<kDantzig>(in_smem != 0, p1 != 0, g, B, m, n, steps,
                              max_iters, tol, K, threads, st);
  return dispatch<kPartial>(in_smem != 0, p1 != 0, g, B, m, n, steps,
                            max_iters, tol, K, threads, st);
}
