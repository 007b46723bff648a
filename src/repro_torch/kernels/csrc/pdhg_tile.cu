// Batched restarted PDHG for Hopper (sm_90a): one thread block per LP.
//
// `pdhg_kernel` replaces both Pallas TPU kernels of
// src/repro/kernels/pdhg_tile.py: `_pdhg_kernel` (the whole solve, launched
// by `pdhg_pallas`) and `_pdhg_segment_kernel` (at most `steps` resumable
// rounds for the compaction scheduler, launched by `pdhg_segment_pallas` and
// driven by `PdhgPallasBackend`).  Both run one round body, the port's plain
// `pdhg_round` / `pdhg_round_mp` + `_pdhg_check`
// (src/repro_torch/core/pdhg.py), which is what the TPU's `_make_pdhg_round`
// computes: `check_every` iterations of prox step and extrapolated dual step,
// then the check (KKT residuals of the current and the averaged iterate, the
// candidate, convergence at res <= tol, Farkas rays on the pre-adoption
// iterates, sufficient / necessary restarts, the smoothed primal-weight
// update clipped to [OMEGA_MIN, OMEGA_MAX]).
//
// Modes: a segment (mode 0) runs the fixed step for at most `steps` rounds
// per LP and updates the state in place; the whole solve (mode 1 fixed,
// mode 2 Malitsky-Pock, a template parameter of the same iteration) runs
// from the given state, cold or warm-injected, until the LP is terminal or
// has run `max_rounds` rounds, then writes the extraction (x * csc; the
// objective, y * rsc and z, NaN off OPTIMAL) and the terminal y * rsc for
// the warm capture.  An LP runs a round while it is running and its own
// iteration count is below max_rounds * check_every; one still running at
// that cap ends ITERATION_LIMIT.  A segment block with nothing to run
// returns before it loads anything.  Ruiz scaling, step sizes and warm
// injection run outside the kernel, in torch (as the TPU design runs them
// outside its kernel).
//
// Layout: the TPU design keeps the immutable data resident in VMEM and
// mutates only the iterates.  Here the Ruiz-scaled A (m x lda floats, lda =
// n rounded up to odd, so a warp reading a column hits 32 banks) lives in
// dynamic shared memory for the whole launch, beside the vectors (b, c,
// scales, bounds, x, y, the running sums and anchors, scratch for A x,
// A^T y and the trial points): 46 KB at 100x100 (four blocks share an SM),
// 170 KB at sc205_like's 246x159 (one block per SM).  Where A does not fit
// the opt-in limit (300x300: 361 KB), or m or n exceeds 256, the same body
// reads A from the block's slice of device memory.
//
// The fixed order of every sum (the plain version repeats it with
// core/fp.py `tree_sum`): each product is rounded once (__fmul_rn); the
// terms are zero-padded to the next power of two P and added pairwise,
// s[i] += s[i + h] for h = P/2, ..., 1, each add rounded once (__fadd_rn).
// A warp computes one sum: lane l holds terms l, l + 32, l + 64, ... (at
// most 16, so m, n <= 512), the levels h >= 32 add within a lane, h = 16
// ... 1 across lanes by shuffle.  A x takes a warp per row, A^T y a warp
// per column, two at a time; c.x, b.y, ub.zc and the norms a warp each.  Maxima and minima are exact (NaN wins, as in
// torch).  Square roots are __fsqrt_rn; the omega update takes log and
// exp in double, as the plain version does.  No other arithmetic is
// reordered: the file is built with -fmad=false, so nvcc fuses no a*b+c.
//
// What bounds it: operations.  An iteration is two matvecs, 4mn flops; the
// check adds 8mn (two KKT evaluations) and up to 4mn more (the ray
// matvecs, only once an iterate's normalized size passes RAY_MIN_NORM).
// Bytes: A is read from device memory once a launch while it sits in shared
// memory, twice an iteration in the device-memory variant.  Each LP's
// iterations are one block's dependent chain, so at the paper's sizes the
// kernel is bound by latency (barriers, shuffle trees) more than by the
// flop rate; the design fills the card with one LP per block, several
// blocks per SM, and takes no device-memory traffic inside the loop.  No
// wgmma, no TMA: a first version, right and simple.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kRunning = -1;
constexpr int kOptimal = 0;
constexpr int kUnbounded = 1;
constexpr int kInfeasible = 2;
constexpr int kIterationLimit = 3;
// core/pdhg.py constants
constexpr float kRestartSufficient = 0.2f;
constexpr float kRestartNecessary = 0.9f;
constexpr double kOmegaSmoothing = 0.5;
constexpr float kOmegaMin = 1e-4f;
constexpr float kOmegaMax = 1e4f;
constexpr float kCertTol = 1e-4f;
constexpr float kRayMinNorm = 1.0f;
constexpr float kMpDelta = 0.99f;
constexpr float kMpMu = 0.7f;
constexpr int kMpTrials = 6;
constexpr int kMaxK = 16;       // terms per lane: sums of up to 512 terms
constexpr int kRedSlots = 32;   // one per warp
constexpr unsigned kFull = 0xffffffffu;

constexpr int kSegment = 0;
constexpr int kWholeFixed = 1;
constexpr int kWholeMP = 2;

// Pointers of one launch: data read, state updated in place, whole-solve
// outputs (null for a segment).
struct Args {
  const float* A;
  const float* b;
  const float* c;
  const float* rsc;
  const float* csc;
  const float* ub;
  const float* eta;
  const float* binf;
  const float* cinf;
  float* x;
  float* y;
  float* xs;
  float* ys;
  float* xr;
  float* yr;
  float* cnt;
  float* last;
  float* prev;
  float* omega;
  int* status;
  int* iters;
  int* it;
  float* xo;
  float* obj;
  float* yo;
  float* zo;
  float* wy;
};

// The block's shared-memory vectors (A too, or A's device-memory slice).
struct Block {
  const float* A;
  int lda;
  float *c, *csc, *ub, *x, *xs, *xr, *n0, *n1, *n2, *n3;
  float *b, *rsc, *y, *ys, *yr, *m0, *m1, *m2;
  float* red;   // 4 x kRedSlots
};

struct Words {
  size_t a, words;
};

__host__ __device__ inline int odd_lda(int n) { return n | 1; }

__host__ __device__ inline Words layout(int m, int n, bool a_smem) {
  const size_t a = a_smem ? (size_t)m * odd_lda(n) : 0;
  return {a, a + 10 * (size_t)n + 8 * (size_t)m + 4 * kRedSlots};
}

__host__ __device__ inline int pow2_at_least(int L) {
  int p = 1;
  while (p < L) p *= 2;
  return p;
}

// torch.maximum / torch.minimum / clamp: NaN wins.
__device__ __forceinline__ float maxp(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float minp(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// Lane count K = P / 32 (at least 1) of a sum over P = pow2(L) terms.
__device__ __forceinline__ int lanes_k(int P) { return P < 32 ? 1 : P / 32; }

// The fixed-order sums of term0(0..L-1) and term1(0..L-1), each over
// P = pow2(L) zero-padded terms, by one warp (every lane calls it; K =
// lanes_k(P) <= KM); lane 0 holds the results.  Two sums at once give the
// warp independent work between the dependent adds of one tree.
template <int KM, class T0, class T1>
__device__ __forceinline__ void warp_tree2(int L, int K, int P, T0 term0,
                                           T1 term1, float& v0, float& v1) {
  const int lane = threadIdx.x & 31;
  float t[KM], u[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const int i = lane + 32 * k;
    const bool in = i < L;
    t[k] = in ? term0(i) : 0.f;
    u[k] = in ? term1(i) : 0.f;
  }
#pragma unroll
  for (int h = KM / 2; h >= 1; h /= 2) {
    if (h < K) {
#pragma unroll
      for (int k = 0; k < h; ++k) {
        t[k] = __fadd_rn(t[k], t[k + h]);
        u[k] = __fadd_rn(u[k], u[k + h]);
      }
    }
  }
  float a = t[0], b = u[0];
#pragma unroll
  for (int h = 16; h >= 1; h /= 2) {
    if (2 * h <= P) {
      const float ra = __shfl_down_sync(kFull, a, h);
      const float rb = __shfl_down_sync(kFull, b, h);
      a = __fadd_rn(a, ra);
      b = __fadd_rn(b, rb);
    }
  }
  v0 = a;
  v1 = b;
}

// One fixed-order sum (see warp_tree2); lane 0 holds the result.
template <int KM, class Term>
__device__ __forceinline__ float warp_tree(int L, int P, Term term) {
  const int lane = threadIdx.x & 31;
  const int K = lanes_k(P);
  float t[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const int i = lane + 32 * k;
    t[k] = i < L ? term(i) : 0.f;
  }
#pragma unroll
  for (int h = KM / 2; h >= 1; h /= 2) {
    if (h < K) {
#pragma unroll
      for (int k = 0; k < h; ++k) t[k] = __fadd_rn(t[k], t[k + h]);
    }
  }
  float v = t[0];
#pragma unroll
  for (int h = 16; h >= 1; h /= 2)
    if (2 * h <= P) v = __fadd_rn(v, __shfl_down_sync(kFull, v, h));
  return v;
}

// A fixed-order sum by warp `w` of the block into *dst (lane 0).
template <int KM, class Term>
__device__ __forceinline__ void warp_sum_to(int w, int L, Term term,
                                            float* dst) {
  if ((int)(threadIdx.x >> 5) != w) return;
  const float v = warp_tree<KM>(L, pow2_at_least(L), term);
  if ((threadIdx.x & 31) == 0) *dst = v;
}

// NaN-propagating max over the block of one value per thread; every
// thread gets it.  Two barriers; red[0..31] is free again afterwards.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o >= 1; o /= 2) v = maxp(v, __shfl_xor_sync(kFull, v, o));
  const int nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = -INFINITY;
  for (int w = 0; w < nw; ++w) r = maxp(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o /= 2) v = maxp(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o /= 2) v = minp(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// ax_out = A xv (a warp per row) and aty_out = A^T yv (a warp per column),
// either may be null; each warp takes two rows or columns at a time.  No
// barrier.
template <int KM>
__device__ __forceinline__ void matvecs(const Block& s, int m, int n,
                                        const float* xv, float* ax_out,
                                        const float* yv, float* aty_out) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* A = s.A;
  const int lda = s.lda;
  if (ax_out) {
    const int P = pow2_at_least(n), K = lanes_k(P);
    for (int i = warp; i < m; i += 2 * nw) {
      const int i2 = i + nw < m ? i + nw : i;
      const float* r0 = A + (size_t)i * lda;
      const float* r1 = A + (size_t)i2 * lda;
      float v0, v1;
      warp_tree2<KM>(
          n, K, P, [&](int j) { return __fmul_rn(r0[j], xv[j]); },
          [&](int j) { return __fmul_rn(r1[j], xv[j]); }, v0, v1);
      if (lane == 0) {
        ax_out[i] = v0;
        ax_out[i2] = v1;
      }
    }
  }
  if (aty_out) {
    const int P = pow2_at_least(m), K = lanes_k(P);
    for (int j = warp; j < n; j += 2 * nw) {
      const int j2 = j + nw < n ? j + nw : j;
      float v0, v1;
      warp_tree2<KM>(
          m, K, P,
          [&](int i) { return __fmul_rn(A[(size_t)i * lda + j], yv[i]); },
          [&](int i) { return __fmul_rn(A[(size_t)i * lda + j2], yv[i]); },
          v0, v1);
      if (lane == 0) {
        aty_out[j] = v0;
        aty_out[j2] = v1;
      }
    }
  }
}

struct LP {   // the per-LP scalars every thread keeps
  float eta, omega, binf, cinf, cnt, last, prev;
  int status, iters;
};

// The KKT residual max(rp, rd, gap) of (xv, yv), kkt_residuals; uses m0,
// n0 and red.  Every thread gets it.
template <int KM>
__device__ __forceinline__ float kkt(const Block& s, int m, int n, const LP& v,
                     const float* xv, const float* yv) {
  const int tid = threadIdx.x, NT = blockDim.x;
  matvecs<KM>(s, m, n, xv, s.m0, yv, s.n0);
  __syncthreads();
  float prp = -INFINITY, prd = -INFINITY;
  for (int i = tid; i < m; i += NT)
    prp = maxp(prp, maxp(__fsub_rn(s.m0[i], s.b[i]), 0.f) / s.rsc[i]);
  for (int j = tid; j < n; j += NT) {
    const float zc = maxp(__fsub_rn(s.c[j], s.n0[j]), 0.f);
    prd = maxp(prd, (isfinite(s.ub[j]) ? 0.f : zc) / s.csc[j]);
  }
  prp = warp_max(prp);
  prd = warp_max(prd);
  if ((tid & 31) == 0) {
    s.red[tid >> 5] = prp;
    s.red[kRedSlots + (tid >> 5)] = prd;
  }
  float* dots = s.red + 2 * kRedSlots;
  warp_sum_to<KM>(0, n, [&](int j) { return __fmul_rn(s.c[j], xv[j]); },
              dots + 0);
  warp_sum_to<KM>(1, m, [&](int i) { return __fmul_rn(s.b[i], yv[i]); },
              dots + 1);
  warp_sum_to<KM>(2, n, [&](int j) {
    const float u = s.ub[j];
    const float zc = maxp(__fsub_rn(s.c[j], s.n0[j]), 0.f);
    return __fmul_rn(isfinite(u) ? u : 0.f, zc);
  }, dots + 2);
  __syncthreads();
  const int nw = NT >> 5;
  float rp = -INFINITY, rd = -INFINITY;
  for (int w = 0; w < nw; ++w) {
    rp = maxp(rp, s.red[w]);
    rd = maxp(rd, s.red[kRedSlots + w]);
  }
  rp = rp / __fadd_rn(1.f, v.binf);
  rd = rd / __fadd_rn(1.f, v.cinf);
  const float pobj = dots[0];
  const float dobj = __fadd_rn(dots[1], dots[2]);
  __syncthreads();
  const float gap = fabsf(__fsub_rn(pobj, dobj)) /
                    __fadd_rn(__fadd_rn(1.f, fabsf(pobj)), fabsf(dobj));
  return maxp(maxp(rp, rd), gap);
}

// One fixed-step iteration: x, y, xs, ys updated; n0, n1, m0 scratch.
template <int KM>
__device__ __forceinline__ void iterate_fixed(const Block& s, int m, int n, float tau,
                              float sig) {
  const int tid = threadIdx.x, NT = blockDim.x;
  matvecs<KM>(s, m, n, nullptr, nullptr, s.y, s.n0);
  __syncthreads();
  for (int j = tid; j < n; j += NT) {
    const float xj = s.x[j];
    const float xn = minp(maxp(__fadd_rn(xj, __fmul_rn(tau, __fsub_rn(
                                                    s.c[j], s.n0[j]))),
                               0.f),
                          s.ub[j]);
    s.n1[j] = xn;
    s.n0[j] = __fsub_rn(__fmul_rn(2.f, xn), xj);
  }
  __syncthreads();
  matvecs<KM>(s, m, n, s.n0, s.m0, nullptr, nullptr);
  __syncthreads();
  for (int i = tid; i < m; i += NT) {
    const float yn = maxp(
        __fadd_rn(s.y[i], __fmul_rn(sig, __fsub_rn(s.m0[i], s.b[i]))), 0.f);
    s.y[i] = yn;
    s.ys[i] = __fadd_rn(s.ys[i], yn);
  }
  for (int j = tid; j < n; j += NT) {
    const float xn = s.n1[j];
    s.x[j] = xn;
    s.xs[j] = __fadd_rn(s.xs[j], xn);
  }
  __syncthreads();
}

// One Malitsky-Pock iteration (pdhg_round_mp): tau, tprev updated.
template <int KM>
__device__ __forceinline__ void iterate_mp(const Block& s, int m, int n, const LP& v,
                           float& tau, float& tprev) {
  const int tid = threadIdx.x, NT = blockDim.x;
  const float beta = __fmul_rn(v.omega, v.omega);
  const float sqb = v.omega;
  const float tau0 = v.eta / v.omega;
  const float sig0 = __fmul_rn(v.eta, v.omega);
  matvecs<KM>(s, m, n, nullptr, nullptr, s.y, s.n0);   // aty
  __syncthreads();
  for (int j = tid; j < n; j += NT)
    s.n1[j] = minp(maxp(__fadd_rn(s.x[j], __fmul_rn(tau, __fsub_rn(
                                                   s.c[j], s.n0[j]))),
                        0.f),
                   s.ub[j]);                         // xn
  __syncthreads();
  const float theta0 = tau / maxp(tprev, 1e-30f);
  float tau_t = __fmul_rn(tau, __fsqrt_rn(__fadd_rn(1.f, theta0)));
  bool done = false;
  for (int trial = 0; trial < kMpTrials && !done; ++trial) {
    const float theta = tau_t / maxp(tau, 1e-30f);
    for (int j = tid; j < n; j += NT) {
      const float xn = s.n1[j];
      s.n2[j] = __fadd_rn(xn, __fmul_rn(theta, __fsub_rn(xn, s.x[j])));
    }
    __syncthreads();
    matvecs<KM>(s, m, n, s.n2, s.m0, nullptr, nullptr);
    __syncthreads();
    const float bt = __fmul_rn(beta, tau_t);
    for (int i = tid; i < m; i += NT)
      s.m2[i] = maxp(
          __fadd_rn(s.y[i], __fmul_rn(bt, __fsub_rn(s.m0[i], s.b[i]))), 0.f);
    __syncthreads();
    matvecs<KM>(s, m, n, nullptr, nullptr, s.m2, s.n3);
    __syncthreads();
    warp_sum_to<KM>(0, n, [&](int j) {
      const float d = __fsub_rn(s.n3[j], s.n0[j]);
      return __fmul_rn(d, d);
    }, s.red + 0);
    warp_sum_to<KM>(1, m, [&](int i) {
      const float d = __fsub_rn(s.m2[i], s.y[i]);
      return __fmul_rn(d, d);
    }, s.red + 1);
    __syncthreads();
    const float lhs =
        __fmul_rn(__fmul_rn(sqb, tau_t), __fsqrt_rn(s.red[0]));
    const float rhs = __fmul_rn(kMpDelta, __fsqrt_rn(s.red[1]));
    __syncthreads();
    if (lhs <= __fadd_rn(rhs, 1e-30f))
      done = true;
    else
      tau_t = __fmul_rn(tau_t, kMpMu);
  }
  if (done) {
    tprev = tau;
    tau = tau_t;
  } else {    // the known-safe fixed step, and the growth clock reset
    for (int j = tid; j < n; j += NT)
      s.n2[j] = __fsub_rn(__fmul_rn(2.f, s.n1[j]), s.x[j]);
    __syncthreads();
    matvecs<KM>(s, m, n, s.n2, s.m0, nullptr, nullptr);
    __syncthreads();
    for (int i = tid; i < m; i += NT)
      s.m2[i] = maxp(
          __fadd_rn(s.y[i], __fmul_rn(sig0, __fsub_rn(s.m0[i], s.b[i]))),
          0.f);
    tau = tau0;
    tprev = tau0;
  }
  for (int i = tid; i < m; i += NT) {
    const float yn = s.m2[i];
    s.y[i] = yn;
    s.ys[i] = __fadd_rn(s.ys[i], yn);
  }
  for (int j = tid; j < n; j += NT) {
    const float xn = s.n1[j];
    s.x[j] = xn;
    s.xs[j] = __fadd_rn(s.xs[j], xn);
  }
  __syncthreads();
}

// The round's check (_pdhg_check) after its iterations.
template <int KM>
__device__ __forceinline__ void check(const Block& s, int m, int n, LP& v, float tol) {
  const int tid = threadIdx.x, NT = blockDim.x;
  const float cc = maxp(v.cnt, 1.f);
  for (int j = tid; j < n; j += NT) s.n2[j] = s.xs[j] / cc;   // xa
  for (int i = tid; i < m; i += NT) s.m1[i] = s.ys[i] / cc;   // ya
  __syncthreads();
  const float res_cur = kkt<KM>(s, m, n, v, s.x, s.y);
  const float res_avg = kkt<KM>(s, m, n, v, s.n2, s.m1);
  const bool use_avg = res_avg < res_cur;
  const float res = use_avg ? res_avg : res_cur;
  const float* xc = use_avg ? s.n2 : s.x;
  const float* yc = use_avg ? s.m1 : s.y;
  const bool converged = res <= tol;
  const bool restart =
      !converged && ((res <= __fmul_rn(kRestartSufficient, v.last)) ||
                     ((res <= __fmul_rn(kRestartNecessary, v.last)) &&
                      (res > v.prev)));

  // Farkas rays on the pre-adoption iterates (_ray_certificates)
  bool infeas = false, unbounded = false;
  if (!converged) {
    const float rs = __fadd_rn(__fadd_rn(1.f, v.binf), v.cinf);
    float p = -INFINITY;
    for (int i = tid; i < m; i += NT)
      p = maxp(p, fabsf(__fmul_rn(s.y[i], s.rsc[i])));
    const float yinf = block_max(p, s.red);
    if (yinf > kRayMinNorm) {
      const float d = maxp(yinf, 1e-12f);
      for (int i = tid; i < m; i += NT) s.m0[i] = s.y[i] / d;   // yh
      __syncthreads();
      matvecs<KM>(s, m, n, nullptr, nullptr, s.m0, s.n0);          // aty_s
      __syncthreads();
      float q = INFINITY;
      for (int j = tid; j < n; j += NT)
        q = minp(q, isfinite(s.ub[j]) ? INFINITY : s.n0[j] / s.csc[j]);
      q = warp_min(q);
      if ((tid & 31) == 0) s.red[tid >> 5] = q;
      float* dots = s.red + 2 * kRedSlots;
      warp_sum_to<KM>(0, m, [&](int i) { return __fmul_rn(s.b[i], s.m0[i]); },
                  dots + 0);
      warp_sum_to<KM>(1, n, [&](int j) {
        const float u = s.ub[j];
        return __fmul_rn(isfinite(u) ? u : 0.f, maxp(-s.n0[j], 0.f));
      }, dots + 1);
      __syncthreads();
      float mn = INFINITY;
      for (int w = 0; w < (NT >> 5); ++w) mn = minp(mn, s.red[w]);
      const float eps = __fmul_rn(-kCertTol, rs);
      infeas = (mn >= eps) && (__fadd_rn(dots[0], dots[1]) <= eps);
      __syncthreads();
    }
    p = -INFINITY;
    for (int j = tid; j < n; j += NT)
      p = maxp(p, fabsf(__fmul_rn(isfinite(s.ub[j]) ? 0.f : s.x[j],
                                  s.csc[j])));
    const float xinf = block_max(p, s.red);
    if (xinf > kRayMinNorm) {
      const float d = maxp(xinf, 1e-12f);
      for (int j = tid; j < n; j += NT)
        s.n0[j] = (isfinite(s.ub[j]) ? 0.f : s.x[j]) / d;      // xh
      __syncthreads();
      matvecs<KM>(s, m, n, s.n0, s.m0, nullptr, nullptr);
      __syncthreads();
      float q = -INFINITY;
      for (int i = tid; i < m; i += NT) q = maxp(q, s.m0[i] / s.rsc[i]);
      q = warp_max(q);
      if ((tid & 31) == 0) s.red[tid >> 5] = q;
      float* dots = s.red + 2 * kRedSlots;
      warp_sum_to<KM>(0, n, [&](int j) { return __fmul_rn(s.c[j], s.n0[j]); },
                  dots + 0);
      __syncthreads();
      float mx = -INFINITY;
      for (int w = 0; w < (NT >> 5); ++w) mx = maxp(mx, s.red[w]);
      const float eps = __fmul_rn(kCertTol, rs);
      unbounded = (mx <= eps) && (dots[0] >= eps);
      __syncthreads();
    }
  }

  // adaptive primal weight (at a restart), toward the displacement ratio
  if (restart) {
    warp_sum_to<KM>(0, n, [&](int j) {
      const float d = __fsub_rn(xc[j], s.xr[j]);
      return __fmul_rn(d, d);
    }, s.red + 0);
    warp_sum_to<KM>(1, m, [&](int i) {
      const float d = __fsub_rn(yc[i], s.yr[i]);
      return __fmul_rn(d, d);
    }, s.red + 1);
    __syncthreads();
    const float dx = __fsqrt_rn(s.red[0]);
    const float dy = __fsqrt_rn(s.red[1]);
    __syncthreads();
    if (dx > 1e-10f && dy > 1e-10f) {
      const float ratio = maxp(dy, 1e-12f) / maxp(dx, 1e-12f);
      const double e = kOmegaSmoothing * log((double)ratio) +
                       (1.0 - kOmegaSmoothing) * log((double)v.omega);
      v.omega = minp(maxp((float)exp(e), kOmegaMin), kOmegaMax);
    }
  }

  // adoption of the candidate; restart bookkeeping
  if ((converged || restart) && use_avg) {
    for (int j = tid; j < n; j += NT) s.x[j] = s.n2[j];
    for (int i = tid; i < m; i += NT) s.y[i] = s.m1[i];
  }
  if (restart) {
    __syncthreads();
    for (int j = tid; j < n; j += NT) {
      s.xs[j] = 0.f;
      s.xr[j] = s.x[j];
    }
    for (int i = tid; i < m; i += NT) {
      s.ys[i] = 0.f;
      s.yr[i] = s.y[i];
    }
    v.cnt = 0.f;
    v.last = res;
    v.prev = INFINITY;
  } else {
    v.prev = res;
  }
  __syncthreads();
  if (converged) v.status = kOptimal;
  if (infeas) v.status = kInfeasible;
  if (unbounded) v.status = kUnbounded;
}

template <int kMode, bool kSmemA, int KM>
__global__ void __launch_bounds__(256, KM <= 4 ? 4 : 1)
    pdhg_kernel(Args g, int m, int n, int steps, int max_rounds,
                            int ce, float tol) {
  const int lp = blockIdx.x;
  const int tid = threadIdx.x, NT = blockDim.x;
  LP v;
  v.status = g.status[lp];
  v.iters = g.iters[lp];
  const long long cap = (long long)max_rounds * ce;
  if (kMode == kSegment && (v.status != kRunning || v.iters >= cap)) {
    if (tid == 0) {
      if (v.status == kRunning) g.status[lp] = kIterationLimit;
      g.it[lp] = 0;
    }
    return;
  }
  extern __shared__ float smem[];
  const Words w = layout(m, n, kSmemA);
  Block s;
  float* p = smem + w.a;
  s.c = p; p += n;
  s.csc = p; p += n;
  s.ub = p; p += n;
  s.x = p; p += n;
  s.xs = p; p += n;
  s.xr = p; p += n;
  s.n0 = p; p += n;
  s.n1 = p; p += n;
  s.n2 = p; p += n;
  s.n3 = p; p += n;
  s.b = p; p += m;
  s.rsc = p; p += m;
  s.y = p; p += m;
  s.ys = p; p += m;
  s.yr = p; p += m;
  s.m0 = p; p += m;
  s.m1 = p; p += m;
  s.m2 = p; p += m;
  s.red = p;
  const size_t on = (size_t)lp * n, om = (size_t)lp * m;
  const float* Ag = g.A + (size_t)lp * m * n;
  if (kSmemA) {
    const int lda = odd_lda(n);
    for (int idx = tid; idx < m * n; idx += NT) {
      const int i = idx / n, j = idx - i * n;
      smem[(size_t)i * lda + j] = Ag[idx];
    }
    s.A = smem;
    s.lda = lda;
  } else {
    s.A = Ag;
    s.lda = n;
  }
  for (int j = tid; j < n; j += NT) {
    s.c[j] = g.c[on + j];
    s.csc[j] = g.csc[on + j];
    s.ub[j] = g.ub[on + j];
    s.x[j] = g.x[on + j];
    s.xs[j] = g.xs[on + j];
    s.xr[j] = g.xr[on + j];
  }
  for (int i = tid; i < m; i += NT) {
    s.b[i] = g.b[om + i];
    s.rsc[i] = g.rsc[om + i];
    s.y[i] = g.y[om + i];
    s.ys[i] = g.ys[om + i];
    s.yr[i] = g.yr[om + i];
  }
  v.eta = g.eta[lp];
  v.omega = g.omega[lp];
  v.binf = g.binf[lp];
  v.cinf = g.cinf[lp];
  v.cnt = g.cnt[lp];
  v.last = g.last[lp];
  v.prev = g.prev[lp];
  float tau = v.eta / v.omega, tprev = tau;   // Malitsky-Pock steps
  __syncthreads();

  int it = 0;
  while (v.status == kRunning && v.iters < cap && it < steps) {
    if (kMode == kWholeMP) {
      for (int k = 0; k < ce; ++k) {
        iterate_mp<KM>(s, m, n, v, tau, tprev);
        v.cnt = __fadd_rn(v.cnt, 1.f);
      }
    } else {
      const float tau_f = v.eta / v.omega;
      const float sig = __fmul_rn(v.eta, v.omega);
      for (int k = 0; k < ce; ++k) {
        iterate_fixed<KM>(s, m, n, tau_f, sig);
        v.cnt = __fadd_rn(v.cnt, 1.f);
      }
    }
    v.iters += ce;
    check<KM>(s, m, n, v, tol);
    ++it;
  }
  if (v.status == kRunning && v.iters >= cap) v.status = kIterationLimit;

  if (kMode == kSegment) {
    for (int j = tid; j < n; j += NT) {
      g.x[on + j] = s.x[j];
      g.xs[on + j] = s.xs[j];
      g.xr[on + j] = s.xr[j];
    }
    for (int i = tid; i < m; i += NT) {
      g.y[om + i] = s.y[i];
      g.ys[om + i] = s.ys[i];
      g.yr[om + i] = s.yr[i];
    }
    if (tid == 0) {
      g.cnt[lp] = v.cnt;
      g.last[lp] = v.last;
      g.prev[lp] = v.prev;
      g.omega[lp] = v.omega;
      g.status[lp] = v.status;
      g.iters[lp] = v.iters;
      g.it[lp] = it;
    }
    return;
  }

  // extraction (extract_pdhg) and the warm capture
  const bool opt = v.status == kOptimal;
  matvecs<KM>(s, m, n, nullptr, nullptr, s.y, s.n0);
  warp_sum_to<KM>(0, n, [&](int j) { return __fmul_rn(s.c[j], s.x[j]); },
              s.red + 0);
  __syncthreads();
  for (int j = tid; j < n; j += NT) {
    const float cs = s.csc[j];
    g.xo[on + j] = __fmul_rn(s.x[j], cs);
    g.zo[on + j] = opt ? __fsub_rn(s.c[j] / cs, s.n0[j] / cs) : qnan();
  }
  for (int i = tid; i < m; i += NT) {
    const float yu = __fmul_rn(s.y[i], s.rsc[i]);
    g.wy[om + i] = yu;
    g.yo[om + i] = opt ? yu : qnan();
  }
  if (tid == 0) {
    g.obj[lp] = opt ? s.red[0] : qnan();
    g.omega[lp] = v.omega;
    g.status[lp] = v.status;
    g.iters[lp] = v.iters;
  }
}

template <int kMode, bool kSmemA, int KM>
cudaError_t launch(const Args& g, int B, int m, int n, int steps,
                   int max_rounds, int ce, float tol, int threads,
                   cudaStream_t stream) {
  auto kernel = pdhg_kernel<kMode, kSmemA, KM>;
  const size_t smem = sizeof(float) * layout(m, n, kSmemA).words;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, smem, stream>>>(g, m, n, steps, max_rounds, ce, tol);
  return cudaGetLastError();
}

template <bool kSmemA, int KM>
cudaError_t by_mode(int mode, const Args& g, int B, int m, int n, int steps,
                    int max_rounds, int ce, float tol, int threads,
                    cudaStream_t st) {
  if (mode == kSegment)
    return launch<kSegment, kSmemA, KM>(g, B, m, n, steps, max_rounds, ce,
                                        tol, threads, st);
  if (mode == kWholeFixed)
    return launch<kWholeFixed, kSmemA, KM>(g, B, m, n, steps, max_rounds,
                                           ce, tol, threads, st);
  return launch<kWholeMP, kSmemA, KM>(g, B, m, n, steps, max_rounds, ce, tol,
                                      threads, st);
}

// KM, the lanes a tree sum may hold: 4 (sums of up to 128 terms) or 8 (up
// to 256) with A in shared memory, kMaxK with A in device memory.  Three
// sizes keep the build short; a sum that needs fewer lanes skips the levels
// it does not have.
template <bool kSmemA>
cudaError_t by_k(int mode, const Args& g, int B, int m, int n, int steps,
                 int max_rounds, int ce, float tol, int threads,
                 cudaStream_t st) {
  if constexpr (kSmemA) {
    if (pow2_at_least(m > n ? m : n) <= 128)
      return by_mode<kSmemA, 4>(mode, g, B, m, n, steps, max_rounds, ce, tol,
                                threads, st);
    return by_mode<kSmemA, 8>(mode, g, B, m, n, steps, max_rounds, ce, tol,
                              threads, st);
  } else {
    return by_mode<kSmemA, kMaxK>(mode, g, B, m, n, steps, max_rounds, ce,
                                  tol, threads, st);
  }
}

}  // namespace

// Bytes of dynamic shared memory one block takes, with A in shared memory
// (a_smem != 0) or in device memory.
extern "C" long long pdhg_tile_smem_bytes(int m, int n, int a_smem) {
  return (long long)(sizeof(float) * layout(m, n, a_smem != 0).words);
}

// Whether the launcher keeps A in shared memory on the current device (it
// fits, and m, n <= 256): 1 or 0, or minus a CUDA error code.
extern "C" int pdhg_tile_a_in_smem(int m, int n) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  return m <= 256 && n <= 256 && pdhg_tile_smem_bytes(m, n, 1) <= limit;
}

// Launches one block per LP on `stream`; allocates nothing and does not
// synchronise.  A (B, m, n), b, rsc (B, m), c, csc, ub (B, n) and eta,
// binf, cinf (B,) are read; x, xs, xr (B, n), y, ys, yr (B, m), cnt, last,
// prev, omega, status, iters (B,) are updated in place (a whole solve
// writes back only omega, status and iters).  mode 0 (segment) writes the
// rounds each LP ran to it (B,); modes 1 (fixed) and 2 (Malitsky-Pock),
// whole solves, write xo, zo (B, n), obj (B,), yo, wy (B, m).  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int pdhg_launch(
    const void* A, const void* b, const void* c, const void* rsc,
    const void* csc, const void* ub, const void* eta, const void* binf,
    const void* cinf, void* x, void* y, void* xs, void* ys, void* xr,
    void* yr, void* cnt, void* last, void* prev, void* omega, void* status,
    void* iters, void* it, void* xo, void* obj, void* yo, void* zo, void* wy,
    int B, int m, int n, int steps, int max_rounds, int check_every,
    float tol, int mode, int threads, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (m < 1 || n < 1 || m > 32 * kMaxK || n > 32 * kMaxK ||
      check_every < 1 || threads < 128 || threads > 256 || threads % 32 ||
      mode < kSegment || mode > kWholeMP)
    return cudaErrorInvalidValue;
  if (mode == kSegment ? it == nullptr
                       : (xo == nullptr || obj == nullptr || yo == nullptr ||
                          zo == nullptr || wy == nullptr))
    return cudaErrorInvalidValue;
  const int in_smem = pdhg_tile_a_in_smem(m, n);
  if (in_smem < 0) return -in_smem;
  const Args g{
      static_cast<const float*>(A),    static_cast<const float*>(b),
      static_cast<const float*>(c),    static_cast<const float*>(rsc),
      static_cast<const float*>(csc),  static_cast<const float*>(ub),
      static_cast<const float*>(eta),  static_cast<const float*>(binf),
      static_cast<const float*>(cinf), static_cast<float*>(x),
      static_cast<float*>(y),          static_cast<float*>(xs),
      static_cast<float*>(ys),         static_cast<float*>(xr),
      static_cast<float*>(yr),         static_cast<float*>(cnt),
      static_cast<float*>(last),       static_cast<float*>(prev),
      static_cast<float*>(omega),      static_cast<int*>(status),
      static_cast<int*>(iters),        static_cast<int*>(it),
      static_cast<float*>(xo),         static_cast<float*>(obj),
      static_cast<float*>(yo),         static_cast<float*>(zo),
      static_cast<float*>(wy)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_smem)
    return by_k<true>(mode, g, B, m, n, steps, max_rounds, check_every, tol,
                      threads, st);
  return by_k<false>(mode, g, B, m, n, steps, max_rounds, check_every, tol,
                     threads, st);
}
