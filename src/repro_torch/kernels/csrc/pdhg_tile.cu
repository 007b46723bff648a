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
// The fixed order of every sum (the plain version repeats it with
// core/fp.py `tree_sum`): each product is rounded once (__fmul_rn); the
// terms are zero-padded to the next power of two P and added pairwise,
// s[i] += s[i + h] for h = P/2, ..., 1, each add rounded once (__fadd_rn).
// The terms {r, r + S, r + 2S, ...} of a power-of-two stride S <= P form
// the subtree of node r at level h = S, so a thread holding one residue
// class mod S reduces it alone, in the tree's order, and the levels
// S/2 ... 1 then pair classes across threads.  Maxima and minima are exact
// (NaN wins, as in torch).  Square roots are __fsqrt_rn; the omega update
// takes log and exp in double, as the plain version does.  No other
// arithmetic is reordered: the file is built with -fmad=false, so nvcc
// fuses no a*b+c.  Vectors live in dynamic shared memory (b, c, scales,
// bounds, x, y, the running sums and anchors, scratch for A x, A^T y and
// the trial points); the check, the Malitsky-Pock linesearch and the
// extraction run the same code in every variant, on the variant's two
// matvecs.
//
// Three variants, chosen by shape (pdhg_tile_variant):
//
// * registers (m, n <= 112): A stays in registers for the whole launch.
//   The block is Sp x Sq threads; thread (p, q) holds A[i, j] for
//   i = p (mod Sp), j = q (mod Sq), R x C of them (RegMv).  A x: the
//   thread sums its q-class of each of its rows locally, the levels
//   Sq/2 ... 1 run across lanes by recursive-halving shuffles (a lane
//   keeps half its values at each level, so R rows cost about R
//   shuffles, not R log Sq), and the lane left with row i updates y[i].
//   A^T y: the thread sums its p-class of each column locally, the levels
//   within a warp run by shuffles, and the warps' partials meet in shared
//   memory after one barrier; the thread of column j finishes its sum and
//   updates x[j].  A fixed-step iteration takes three barriers (the warp
//   design below: four) and loads no A.  Two shapes, all loops over a thread's
//   rows and columns unrolled on compile-time bounds:
//   - Sp = Sq = 16, 7 x 7 (RegBlock: 256 threads, m, n <= 112, e.g.
//     lp_100d_50k's 100 x 100): 49 A registers; ptxas -v (sm_90a): 128
//     registers a thread, 0 spill, 0 stack; __launch_bounds__(256, 2),
//     so two LPs an SM against the warp design's four.
//   - Sp = 32, Sq = 1, 2 x 32 (RegWarp: one warp holds whole rows,
//     m <= 64, n <= 32, e.g. lp_afiro_100k's 35 x 32): 64 A registers,
//     A x with no shuffle; 167 to 181 registers, 0 spill, 0 stack
//     (__launch_bounds__(32, 8): 128 registers spilled), eleven or twelve
//     LPs an SM.
//   With half the LPs an SM, the gain needs the per-iteration latency to
//   fall more than twice: the cycle counters (PERF.md section 5) put a
//   block at 19,343 cycles an LP-iteration in the warp design and 4,276
//   here at 100 x 100, 4.5 times fewer, so 2.3 times the throughput
//   (measured on all of lp_100d_50k: 2.9 times).
// * shared (m, n <= 256 and A fits the opt-in limit: sc205_like's
//   246 x 159, 170 KB): the warp design (WarpMv), the kernel's first.
//   A (m x lda floats, lda = n rounded up to odd, so a warp reading a
//   column hits 32 banks) sits in shared memory; a warp computes one
//   sum: lane l holds terms
//   l, l + 32, ... (at most 16), the levels h >= 32 add within a lane,
//   h = 16 ... 1 across lanes by shuffle.  A x takes a warp per row,
//   A^T y a warp per column, two at a time.
// * device (m or n > 256, or A too large: lp_300d_2k's 300 x 300): the
//   same warp design reading the block's slice of A from device memory.
//
// What bounds it: operations and their latency.  An iteration is two
// matvecs, 4mn flops (under -fmad=false, 4mn instructions: a fused bound
// counts half); the check adds 8mn (two KKT evaluations) and up to 4mn
// (the ray matvecs, once an iterate's normalized size passes
// RAY_MIN_NORM).  A is read from device memory once a launch in the
// registers and shared variants, twice an iteration in the device one.
// Each LP's iterations are one block's dependent chain, so the design
// fills the card with blocks (one LP each) and takes no device-memory
// traffic inside the loop.  No tensor cores: they round neither each
// product nor each add as the fixed order needs.
//
// Per-LP counters (the telemetry plane, src/repro_torch/obs/telemetry.py).
// The segment mode has a second instantiation per variant, kTel, that
// carries each LP's int32 and float32 counter rows (16 and 8 lanes):
// thread 0 loads the lanes the engine owns into a static shared-memory slot
// at the start, books each round there (its iterations, an adopted
// restart), copies in the KKT triple of the round's candidate (the two
// KKT evaluations leave theirs beside the slot) and the primal weight after
// the check, and stores the lanes at the end, in place.  The copies are the
// values the check computes, bit for bit.  A block with nothing to run
// leaves the rows as they are.  Registers hold none of it, and kTel ==
// false compiles to the kernel without counters.
//
// Built with -DPDHG_TRACE, thread 0 of each block counts clock64() cycles
// by phase into `g_trace` (pdhg_trace_read); the main build has none of it.

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

constexpr int kVarRegisters = 0;
constexpr int kVarShared = 1;
constexpr int kVarDevice = 2;

// The counter rows (src/repro_torch/obs/telemetry.py INT_LANES, F32_LANES):
// their widths and the lanes PDHG books.
constexpr int kTelInts = 16;
constexpr int kTelFloats = 8;
constexpr int kTelIters2 = 1;
constexpr int kTelRestarts = 9;
constexpr int kTelKkt = 0;     // kkt_primal, kkt_dual, kkt_gap: lanes 0..2
constexpr int kTelOmega = 3;
constexpr int kTelCur = kTelFloats;       // the current iterate's triple
constexpr int kTelAvg = kTelFloats + 3;   // the average's triple
constexpr int kTelSlotBytes =
    (int)(sizeof(int) * kTelInts + sizeof(float) * (kTelFloats + 6));

#ifdef PDHG_TRACE
// Phases of the cycle counters.
enum : int {
  kTrAty,          // A^T y of an iteration (registers: with the x update)
  kTrAx,           // A x of an iteration (registers: with the y update)
  kTrUpdate,       // elementwise work of an iteration
  kTrBarrier,      // waiting at a block barrier
  kTrKktMv,        // the check's KKT matvecs
  kTrCheckReduce,  // the check's dot products and maxima
  kTrRayMv,        // the Farkas-ray matvecs
  kTrCheckOther,   // averages, adoption, restart bookkeeping, omega
  kTrOther,        // loads, the round loop, extraction
  kTrPhases
};
__device__ unsigned long long g_trace[kTrPhases + 1];   // + blocks counted
__shared__ long long tr_last;
__shared__ int tr_cur;
__shared__ unsigned long long tr_acc[kTrPhases];

// Thread 0 books the cycles since the last mark to the phase it was in and
// enters `ph`; returns the phase it left.
__device__ __forceinline__ int tr_to(int ph) {
  if (threadIdx.x != 0) return 0;
  const long long now = clock64();
  const int was = tr_cur;
  tr_acc[was] += (unsigned long long)(now - tr_last);
  tr_last = now;
  tr_cur = ph;
  return was;
}
__device__ __forceinline__ void tr_begin() {
  if (threadIdx.x != 0) return;
  for (int k = 0; k < kTrPhases; ++k) tr_acc[k] = 0;
  tr_cur = kTrOther;
  tr_last = clock64();
}
__device__ __forceinline__ void tr_end() {
  if (threadIdx.x != 0) return;
  tr_to(kTrOther);
  for (int k = 0; k < kTrPhases; ++k) atomicAdd(&g_trace[k], tr_acc[k]);
  atomicAdd(&g_trace[kTrPhases], 1ull);
}
#define TR(ph) tr_to(ph)
#define TSYNC()                                  \
  do {                                           \
    const int tr_was_ = tr_to(kTrBarrier);       \
    __syncthreads();                             \
    tr_to(tr_was_);                              \
  } while (0)
#define TR_BEGIN() tr_begin()
#define TR_END() tr_end()
#else
#define TR(ph) ((void)0)
#define TSYNC() __syncthreads()
#define TR_BEGIN() ((void)0)
#define TR_END() ((void)0)
#endif

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

// The block's shared-memory vectors (A too, or A's device-memory slice, in
// the shared and device variants).
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

__host__ __device__ constexpr int pow2c(int L) {
  return L <= 1 ? 1 : 2 * pow2c((L + 1) / 2);
}
__host__ __device__ constexpr int log2c(int P) {
  return P <= 1 ? 0 : 1 + log2c(P / 2);
}

__host__ __device__ inline int odd_lda(int n) { return n | 1; }

// Floats of the vectors of an LP with n-vectors of length nl and m-vectors
// of length ml.
__host__ __device__ inline size_t vector_words(int nl, int ml) {
  return 10 * (size_t)nl + 8 * (size_t)ml + 4 * kRedSlots;
}

__host__ __device__ inline Words layout(int m, int n, bool a_smem) {
  const size_t a = a_smem ? (size_t)m * odd_lda(n) : 0;
  return {a, a + vector_words(n, m)};
}

// Points the vectors of `s` into p: ten of length nl, eight of length ml,
// then the reduction slots.  Returns the first float after them.
__device__ __forceinline__ float* carve(Block& s, float* p, int nl, int ml) {
  s.c = p; p += nl;
  s.csc = p; p += nl;
  s.ub = p; p += nl;
  s.x = p; p += nl;
  s.xs = p; p += nl;
  s.xr = p; p += nl;
  s.n0 = p; p += nl;
  s.n1 = p; p += nl;
  s.n2 = p; p += nl;
  s.n3 = p; p += nl;
  s.b = p; p += ml;
  s.rsc = p; p += ml;
  s.y = p; p += ml;
  s.ys = p; p += ml;
  s.yr = p; p += ml;
  s.m0 = p; p += ml;
  s.m1 = p; p += ml;
  s.m2 = p; p += ml;
  s.red = p;
  return p + 4 * kRedSlots;
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

// The levels t[k] += t[k + h], k < h, for h = H, H/2, ..., 1 where
// exists(h): a recursion over compile-time h, so every index is a constant
// and t stays in registers (a `for (h = H; h >= 1; h /= 2)` loop is not
// always unrolled, and then t goes to local memory).
template <int H, int N, class Ex>
__device__ __forceinline__ void halve(float (&t)[N], Ex exists) {
  if constexpr (H >= 1) {
    if (exists(H)) {
#pragma unroll
      for (int k = 0; k < H; ++k) t[k] = __fadd_rn(t[k], t[k + H]);
    }
    halve<H / 2>(t, exists);
  }
}

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
  halve<KM / 2>(t, [&](int h) { return h < K; });
  halve<KM / 2>(u, [&](int h) { return h < K; });
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
  halve<KM / 2>(t, [&](int h) { return h < K; });
  float v = t[0];
#pragma unroll
  for (int h = 16; h >= 1; h /= 2)
    if (2 * h <= P) v = __fadd_rn(v, __shfl_down_sync(kFull, v, h));
  return v;
}

// A fixed-order sum by warp `w` (modulo the block's warps) into *dst
// (lane 0).
template <int KM, class Term>
__device__ __forceinline__ void warp_sum_to(int w, int L, Term term,
                                            float* dst) {
  if ((int)(threadIdx.x >> 5) != w % (int)(blockDim.x >> 5)) return;
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
  TSYNC();
  float r = -INFINITY;
  for (int w = 0; w < nw; ++w) r = maxp(r, red[w]);
  TSYNC();
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

// ---- the shared and device variants: A read by warps ---------------------

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

// A in shared memory (kSmemA) or device memory, read by warps; KM lanes a
// sum at most.  128 or 256 threads a block.
template <bool kSmemA, int KM>
struct WarpMv {
  static constexpr int kThreads = 256;
  static constexpr int kMinBlocks = KM <= 4 ? 4 : 1;

  __host__ __device__ static size_t words(int m, int n) {
    return layout(m, n, kSmemA).words;
  }

  // Carves the vectors and places A.  No barrier.
  __device__ __forceinline__ void setup(Block& s, float* smem,
                                        const float* Ag, int m, int n) {
    const int tid = threadIdx.x, NT = blockDim.x;
    carve(s, smem + layout(m, n, kSmemA).a, n, m);
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
  }

  __device__ __forceinline__ void mv(const Block& s, int m, int n,
                                     const float* xv, float* ax_out,
                                     const float* yv, float* aty_out) {
    matvecs<KM>(s, m, n, xv, ax_out, yv, aty_out);
  }

  // One fixed-step iteration: x, y, xs, ys updated; n0, n1, m0 scratch.
  __device__ __forceinline__ void iterate_fixed(const Block& s, int m, int n,
                                                float tau, float sig) {
    const int tid = threadIdx.x, NT = blockDim.x;
    TR(kTrAty);
    matvecs<KM>(s, m, n, nullptr, nullptr, s.y, s.n0);
    TSYNC();
    TR(kTrUpdate);
    for (int j = tid; j < n; j += NT) {
      const float xj = s.x[j];
      const float xn = minp(maxp(__fadd_rn(xj, __fmul_rn(tau, __fsub_rn(
                                                      s.c[j], s.n0[j]))),
                                 0.f),
                            s.ub[j]);
      s.n1[j] = xn;
      s.n0[j] = __fsub_rn(__fmul_rn(2.f, xn), xj);
    }
    TSYNC();
    TR(kTrAx);
    matvecs<KM>(s, m, n, s.n0, s.m0, nullptr, nullptr);
    TSYNC();
    TR(kTrUpdate);
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
    TSYNC();
  }
};

// ---- the registers variant: A held in registers ---------------------------

// Recursive halving across the lanes at xor distances d, d/2, ... (LEV
// levels) of the CNT values in v: a lane keeps the upper half of them if
// its bit d is set, else the lower half, and adds the partner's copy of
// that half (one shuffle a kept value); once one value is left both lanes
// add.  Where exists(d) is false the tree has no such level and the lower
// lane's values pass on unchanged.
template <int N, int CNT, int LEV, class Ex>
__device__ __forceinline__ void bfly(float (&v)[N], int lane, int d,
                                     Ex exists) {
  if constexpr (LEV > 0) {
    const bool up = (lane & d) != 0;
    const bool ex = exists(d);
    if constexpr (CNT > 1) {
      constexpr int H = CNT / 2;
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const float keep = up ? v[k + H] : v[k];
        const float send = up ? v[k] : v[k + H];
        const float got = __shfl_xor_sync(kFull, send, d);
        v[k] = ex ? __fadd_rn(keep, got) : (up ? got : keep);
      }
      bfly<N, H, LEV - 1>(v, lane, d >> 1, exists);
    } else {
      const float got = __shfl_xor_sync(kFull, v[0], d);
      v[0] = ex ? __fadd_rn(v[0], got) : (up ? got : v[0]);
      bfly<N, 1, LEV - 1>(v, lane, d >> 1, exists);
    }
  }
}

// The slot a lane keeps after bfly<., CNT, LEV> from distance d, and
// whether it is the first of the lanes that hold it.
__device__ __forceinline__ void bfly_slot(int cnt, int lev, int d, int lane,
                                          int& base, bool& first) {
  base = 0;
  int dup = 0;
  for (int l = 0; l < lev; ++l, d >>= 1) {
    if (cnt > 1) {
      if (lane & d) base += cnt / 2;
      cnt /= 2;
    } else {
      dup |= d;
    }
  }
  first = (lane & dup) == 0;
}

// The levels hs = K/2 ... 1 of a tree over K slots of stride S (slot k
// holds the terms of class k): level h = S * hs exists when 2h <= P.
template <int K>
__device__ __forceinline__ void slot_tree(float (&t)[K], int S, int P) {
  halve<K / 2>(t, [&](int hs) { return 2 * S * hs <= P; });
}

// A in registers: thread (p, q) of an SP x SQ block holds A[i, j] for
// i = p + SP r (r < R) and j = q + SQ c (c < C), +0 outside the LP.  q is
// the lane's low log2(SQ) bits; p = w + NW (lane >> log2 SQ) with w the
// warp, so the upper levels of a column's tree over p pair lanes of one
// warp and its last log2(NW) levels pair warps.  The vectors have padded
// lengths SQ C and SP R, their padding +0 for the whole launch, so a
// padded term is the product +0 * +0 = +0 that tree_sum adds there.
template <int SP, int SQ, int R, int C, int kBlocksPerSM>
struct RegMv {
  static constexpr int kThreads = SP * SQ;
  static constexpr int kNW = kThreads / 32;
  static constexpr int kLogSQ = log2c(SQ);
  static constexpr int kLogWP = log2c(32 / SQ);
  static constexpr int kRP = pow2c(R), kCP = pow2c(C);
  static constexpr int kNPad = SQ * C, kMPad = SP * R;
  static constexpr int kPartCols = SQ * kCP;   // a warp's A^T y partials
  static constexpr int kMinBlocks = kBlocksPerSM;
  // values a lane keeps after the lane levels of A x and of A^T y
  static constexpr int kRV = kRP > SQ ? kRP / SQ : 1;
  static constexpr int kCV = kCP > 32 / SQ ? kCP / (32 / SQ) : 1;
  static_assert(SQ <= 32 && 32 % SQ == 0 && kThreads % 32 == 0, "shape");
  static_assert((kNW & (kNW - 1)) == 0, "warps a power of two");

  float a[R][C];
  float* part;
  int m, n, Pm, Pn, lane, w, p, q, rbase, cbase;
  bool rfirst, cfirst;

  __host__ __device__ static size_t words(int, int) {
    return vector_words(kNPad, kMPad) + (kNW > 1 ? kNW * kPartCols : 0);
  }

  // Zeroes the vectors and loads A into registers.  No barrier.
  __device__ __forceinline__ void setup(Block& s, float* smem,
                                        const float* Ag, int m_, int n_) {
    m = m_;
    n = n_;
    Pm = pow2_at_least(m);
    Pn = pow2_at_least(n);
    const int tid = threadIdx.x;
    lane = tid & 31;
    w = tid >> 5;
    q = lane & (SQ - 1);
    p = w + kNW * (lane >> kLogSQ);
    bfly_slot(kRP, kLogSQ, SQ / 2, lane, rbase, rfirst);
    bfly_slot(kCP, kLogWP, 16, lane, cbase, cfirst);
    part = carve(s, smem, kNPad, kMPad);
    s.A = nullptr;
    s.lda = 0;
    const size_t words_ = words(m, n);
    for (size_t k = tid; k < words_; k += kThreads) smem[k] = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = p + SP * r;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = q + SQ * c;
        a[r][c] = (i < m && j < n) ? Ag[(size_t)i * n + j] : 0.f;
      }
    }
  }

  // A xv: out(i, (A xv)_i) once for each row, by the lane left holding
  // it.  xv must be complete (a barrier after its writes).  No barrier.
  template <class F>
  __device__ __forceinline__ void ax(const float* xv, F out) {
    constexpr int H0 = kCP > 1 ? kCP / 2 : 1;
    const bool ex0 = 2 * SQ * H0 <= Pn;   // the first local level
    float t[R][H0];
#pragma unroll
    for (int k = 0; k < H0; ++k) {
      const float xlo = k < C ? xv[q + SQ * k] : 0.f;
      const float xhi = (kCP > 1 && k + H0 < C) ? xv[q + SQ * (k + H0)] : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float lo = k < C ? __fmul_rn(a[r][k], xlo) : 0.f;
        if (kCP > 1) {
          const float hi =
              k + H0 < C ? __fmul_rn(a[r][k + H0 < C ? k + H0 : 0], xhi)
                         : 0.f;
          t[r][k] = ex0 ? __fadd_rn(lo, hi) : lo;
        } else {
          t[r][k] = lo;
        }
      }
    }
    float v[kRP];
#pragma unroll
    for (int r = 0; r < kRP; ++r) {
      if (r < R) {
        slot_tree<H0>(t[r < R ? r : 0], SQ, Pn);
        v[r] = t[r < R ? r : 0][0];
      } else {
        v[r] = 0.f;
      }
    }
    bfly<kRP, kRP, kLogSQ>(v, lane, SQ / 2,
                           [&](int d) { return 2 * d <= Pn; });
#pragma unroll
    for (int k = 0; k < kRV; ++k) {
      const int r = rbase + k, i = p + SP * r;
      if (rfirst && r < R && i < m) out(i, v[k]);
    }
  }

  // A^T yv: out(j, (A^T yv)_j) once for each column.  yv must be
  // complete.  With more than one warp, one barrier inside (callers keep a
  // barrier between two calls, as every caller does between a matvec and
  // the use of its result).
  template <class F>
  __device__ __forceinline__ void aty(const float* yv, F out) {
    float yr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) yr[r] = yv[p + SP * r];
    float v[kCP];
#pragma unroll
    for (int c = 0; c < kCP; ++c) {
      if (c < C) {
        float t[kRP];
#pragma unroll
        for (int r = 0; r < kRP; ++r)
          t[r] = r < R ? __fmul_rn(a[r < R ? r : 0][c < C ? c : 0],
                                   yr[r < R ? r : 0])
                       : 0.f;
        slot_tree<kRP>(t, SP, Pm);
        v[c] = t[0];
      } else {
        v[c] = 0.f;
      }
    }
    // the levels h = SP/2 ... NW of p, within the warp: xor distance
    // SQ h / NW
    bfly<kCP, kCP, kLogWP>(v, lane, 16, [&](int d) {
      return 2 * ((d / SQ) * kNW) <= Pm;
    });
    if constexpr (kNW == 1) {
#pragma unroll
      for (int k = 0; k < kCV; ++k) {
        const int c = cbase + k, j = q + SQ * c;
        if (cfirst && c < C && j < n) out(j, v[k]);
      }
    } else {
      if (cfirst) {
#pragma unroll
        for (int k = 0; k < kCV; ++k)
          part[w * kPartCols + q + SQ * (cbase + k)] = v[k];
      }
      TSYNC();
      for (int j = threadIdx.x; j < n; j += kThreads) {
        float u[kNW];
#pragma unroll
        for (int k = 0; k < kNW; ++k) u[k] = part[k * kPartCols + j];
        halve<kNW / 2>(u, [&](int h) { return 2 * h <= Pm; });
        out(j, u[0]);
      }
    }
  }

  __device__ __forceinline__ void mv(const Block&, int, int, const float* xv,
                                     float* ax_out, const float* yv,
                                     float* aty_out) {
    if (ax_out) ax(xv, [&](int i, float v) { ax_out[i] = v; });
    if (aty_out) aty(yv, [&](int j, float v) { aty_out[j] = v; });
  }

  // One fixed-step iteration: the x update follows A^T y in the thread
  // that finishes each column, the y update A x in the lane left holding
  // each row; n0 carries 2 x+ - x.  Three barriers (two with one warp).
  __device__ __forceinline__ void iterate_fixed(const Block& s, int, int,
                                                float tau, float sig) {
    TR(kTrAty);
    aty(s.y, [&](int j, float v) {
      const float xj = s.x[j];
      const float xn = minp(
          maxp(__fadd_rn(xj, __fmul_rn(tau, __fsub_rn(s.c[j], v))), 0.f),
          s.ub[j]);
      s.n0[j] = __fsub_rn(__fmul_rn(2.f, xn), xj);
      s.x[j] = xn;
      s.xs[j] = __fadd_rn(s.xs[j], xn);
    });
    TSYNC();
    TR(kTrAx);
    ax(s.n0, [&](int i, float v) {
      const float yn =
          maxp(__fadd_rn(s.y[i], __fmul_rn(sig, __fsub_rn(v, s.b[i]))), 0.f);
      s.y[i] = yn;
      s.ys[i] = __fadd_rn(s.ys[i], yn);
    });
    TSYNC();
  }
};

// ---- the round body, on a variant's matvecs -------------------------------

struct LP {   // the per-LP scalars every thread keeps
  float eta, omega, binf, cinf, cnt, last, prev;
  int status, iters;
};

// The block's counter slot in static shared memory, in the counter-
// carrying instantiations only (null in the others, which allocate none):
// the int32 row's lanes, then the float32 row's and two KKT triples.
template <bool kTel>
__device__ __forceinline__ int* tel_ints() {
  if constexpr (kTel) {
    __shared__ int slot[kTelInts];
    return slot;
  } else {
    return nullptr;
  }
}
template <bool kTel>
__device__ __forceinline__ float* tel_floats() {
  if constexpr (kTel) {
    __shared__ float slot[kTelFloats + 6];
    return slot;
  } else {
    return nullptr;
  }
}

// The KKT residual max(rp, rd, gap) of (xv, yv), kkt_residuals; uses m0,
// n0 and red.  Every thread gets it; thread 0 also writes the triple to
// `parts` when it is given.
template <int KM, class V>
__device__ __forceinline__ float kkt(V& mv, const Block& s, int m, int n,
                                     const LP& v, const float* xv,
                                     const float* yv,
                                     float* parts = nullptr) {
  const int tid = threadIdx.x, NT = blockDim.x;
  TR(kTrKktMv);
  mv.mv(s, m, n, xv, s.m0, yv, s.n0);
  TSYNC();
  TR(kTrCheckReduce);
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
  TSYNC();
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
  TSYNC();
  const float gap = fabsf(__fsub_rn(pobj, dobj)) /
                    __fadd_rn(__fadd_rn(1.f, fabsf(pobj)), fabsf(dobj));
  if (parts != nullptr && tid == 0) {
    parts[0] = rp;
    parts[1] = rd;
    parts[2] = gap;
  }
  return maxp(maxp(rp, rd), gap);
}

// One Malitsky-Pock iteration (pdhg_round_mp): tau, tprev updated.
template <int KM, class V>
__device__ __forceinline__ void iterate_mp(V& mv, const Block& s, int m,
                                           int n, const LP& v, float& tau,
                                           float& tprev) {
  const int tid = threadIdx.x, NT = blockDim.x;
  const float beta = __fmul_rn(v.omega, v.omega);
  const float sqb = v.omega;
  const float tau0 = v.eta / v.omega;
  const float sig0 = __fmul_rn(v.eta, v.omega);
  mv.mv(s, m, n, nullptr, nullptr, s.y, s.n0);   // aty
  TSYNC();
  for (int j = tid; j < n; j += NT)
    s.n1[j] = minp(maxp(__fadd_rn(s.x[j], __fmul_rn(tau, __fsub_rn(
                                                   s.c[j], s.n0[j]))),
                        0.f),
                   s.ub[j]);                         // xn
  TSYNC();
  const float theta0 = tau / maxp(tprev, 1e-30f);
  float tau_t = __fmul_rn(tau, __fsqrt_rn(__fadd_rn(1.f, theta0)));
  bool done = false;
  for (int trial = 0; trial < kMpTrials && !done; ++trial) {
    const float theta = tau_t / maxp(tau, 1e-30f);
    for (int j = tid; j < n; j += NT) {
      const float xn = s.n1[j];
      s.n2[j] = __fadd_rn(xn, __fmul_rn(theta, __fsub_rn(xn, s.x[j])));
    }
    TSYNC();
    mv.mv(s, m, n, s.n2, s.m0, nullptr, nullptr);
    TSYNC();
    const float bt = __fmul_rn(beta, tau_t);
    for (int i = tid; i < m; i += NT)
      s.m2[i] = maxp(
          __fadd_rn(s.y[i], __fmul_rn(bt, __fsub_rn(s.m0[i], s.b[i]))), 0.f);
    TSYNC();
    mv.mv(s, m, n, nullptr, nullptr, s.m2, s.n3);
    TSYNC();
    warp_sum_to<KM>(0, n, [&](int j) {
      const float d = __fsub_rn(s.n3[j], s.n0[j]);
      return __fmul_rn(d, d);
    }, s.red + 0);
    warp_sum_to<KM>(1, m, [&](int i) {
      const float d = __fsub_rn(s.m2[i], s.y[i]);
      return __fmul_rn(d, d);
    }, s.red + 1);
    TSYNC();
    const float lhs =
        __fmul_rn(__fmul_rn(sqb, tau_t), __fsqrt_rn(s.red[0]));
    const float rhs = __fmul_rn(kMpDelta, __fsqrt_rn(s.red[1]));
    TSYNC();
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
    TSYNC();
    mv.mv(s, m, n, s.n2, s.m0, nullptr, nullptr);
    TSYNC();
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
  TSYNC();
}

// The round's check (_pdhg_check) after its iterations; kTel books it
// into the counter slot.
template <int KM, class V, bool kTel = false>
__device__ __forceinline__ void check(V& mv, const Block& s, int m, int n,
                                      LP& v, float tol) {
  const int tid = threadIdx.x, NT = blockDim.x;
  float* const tf = tel_floats<kTel>();
  TR(kTrCheckOther);
  const float cc = maxp(v.cnt, 1.f);
  for (int j = tid; j < n; j += NT) s.n2[j] = s.xs[j] / cc;   // xa
  for (int i = tid; i < m; i += NT) s.m1[i] = s.ys[i] / cc;   // ya
  TSYNC();
  const float res_cur = kkt<KM>(mv, s, m, n, v, s.x, s.y,
                                kTel ? tf + kTelCur : nullptr);
  const float res_avg = kkt<KM>(mv, s, m, n, v, s.n2, s.m1,
                                kTel ? tf + kTelAvg : nullptr);
  TR(kTrCheckOther);
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
    TR(kTrCheckReduce);
    const float rs = __fadd_rn(__fadd_rn(1.f, v.binf), v.cinf);
    float p = -INFINITY;
    for (int i = tid; i < m; i += NT)
      p = maxp(p, fabsf(__fmul_rn(s.y[i], s.rsc[i])));
    const float yinf = block_max(p, s.red);
    if (yinf > kRayMinNorm) {
      const float d = maxp(yinf, 1e-12f);
      for (int i = tid; i < m; i += NT) s.m0[i] = s.y[i] / d;   // yh
      TSYNC();
      TR(kTrRayMv);
      mv.mv(s, m, n, nullptr, nullptr, s.m0, s.n0);            // aty_s
      TSYNC();
      TR(kTrCheckReduce);
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
      TSYNC();
      float mn = INFINITY;
      for (int w = 0; w < (NT >> 5); ++w) mn = minp(mn, s.red[w]);
      const float eps = __fmul_rn(-kCertTol, rs);
      infeas = (mn >= eps) && (__fadd_rn(dots[0], dots[1]) <= eps);
      TSYNC();
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
      TSYNC();
      TR(kTrRayMv);
      mv.mv(s, m, n, s.n0, s.m0, nullptr, nullptr);
      TSYNC();
      TR(kTrCheckReduce);
      float q = -INFINITY;
      for (int i = tid; i < m; i += NT) q = maxp(q, s.m0[i] / s.rsc[i]);
      q = warp_max(q);
      if ((tid & 31) == 0) s.red[tid >> 5] = q;
      float* dots = s.red + 2 * kRedSlots;
      warp_sum_to<KM>(0, n, [&](int j) { return __fmul_rn(s.c[j], s.n0[j]); },
                      dots + 0);
      TSYNC();
      float mx = -INFINITY;
      for (int w = 0; w < (NT >> 5); ++w) mx = maxp(mx, s.red[w]);
      const float eps = __fmul_rn(kCertTol, rs);
      unbounded = (mx <= eps) && (dots[0] >= eps);
      TSYNC();
    }
  }

  // adaptive primal weight (at a restart), toward the displacement ratio
  if (restart) {
    TR(kTrCheckReduce);
    warp_sum_to<KM>(0, n, [&](int j) {
      const float d = __fsub_rn(xc[j], s.xr[j]);
      return __fmul_rn(d, d);
    }, s.red + 0);
    warp_sum_to<KM>(1, m, [&](int i) {
      const float d = __fsub_rn(yc[i], s.yr[i]);
      return __fmul_rn(d, d);
    }, s.red + 1);
    TSYNC();
    const float dx = __fsqrt_rn(s.red[0]);
    const float dy = __fsqrt_rn(s.red[1]);
    TSYNC();
    TR(kTrCheckOther);
    if (dx > 1e-10f && dy > 1e-10f) {
      const float ratio = maxp(dy, 1e-12f) / maxp(dx, 1e-12f);
      const double e = kOmegaSmoothing * log((double)ratio) +
                       (1.0 - kOmegaSmoothing) * log((double)v.omega);
      v.omega = minp(maxp((float)exp(e), kOmegaMin), kOmegaMax);
    }
  }

  // adoption of the candidate; restart bookkeeping
  TR(kTrCheckOther);
  if ((converged || restart) && use_avg) {
    for (int j = tid; j < n; j += NT) s.x[j] = s.n2[j];
    for (int i = tid; i < m; i += NT) s.y[i] = s.m1[i];
  }
  if (restart) {
    TSYNC();
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
  TSYNC();
  if (converged) v.status = kOptimal;
  if (infeas) v.status = kInfeasible;
  if (unbounded) v.status = kUnbounded;
  if constexpr (kTel) {
    if (tid == 0) {
      const float* c = tf + (use_avg ? kTelAvg : kTelCur);
      for (int k = 0; k < 3; ++k) tf[kTelKkt + k] = c[k];
      tf[kTelOmega] = v.omega;
      if (restart) tel_ints<true>()[kTelRestarts] += 1;
    }
  }
}

// The round body of every variant V; KM lanes bound the check's one-warp
// sums (dot products, norms).  kTel (segments only) carries the counter
// rows `ti` (kTelInts int32 an LP) and `tf` (kTelFloats float32), updated
// in place (the last parameters, so that the counter-free instantiations
// read every other one where they did before the plane).
template <int kMode, class V, int KM, bool kTel = false>
__global__ void __launch_bounds__(V::kThreads, V::kMinBlocks)
    pdhg_kernel(Args g, int m, int n, int steps, int max_rounds, int ce,
                float tol, int* ti, float* tf) {
  static_assert(!kTel || kMode == kSegment, "counters ride segments only");
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
  TR_BEGIN();
  extern __shared__ float smem[];
  Block s;
  V mv;
  mv.setup(s, smem, g.A + (size_t)lp * m * n, m, n);
  TSYNC();
  const size_t on = (size_t)lp * n, om = (size_t)lp * m;
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
  if constexpr (kTel) {
    if (tid == 0) {
      tel_ints<true>()[kTelIters2] = ti[lp * kTelInts + kTelIters2];
      tel_ints<true>()[kTelRestarts] = ti[lp * kTelInts + kTelRestarts];
      for (int k = 0; k < 4; ++k)
        tel_floats<true>()[k] = tf[lp * kTelFloats + k];
    }
  }
  TSYNC();

  int it = 0;
  while (v.status == kRunning && v.iters < cap && it < steps) {
    if (kMode == kWholeMP) {
      for (int k = 0; k < ce; ++k) {
        iterate_mp<KM>(mv, s, m, n, v, tau, tprev);
        v.cnt = __fadd_rn(v.cnt, 1.f);
      }
    } else {
      const float tau_f = v.eta / v.omega;
      const float sig = __fmul_rn(v.eta, v.omega);
      for (int k = 0; k < ce; ++k) {
        mv.iterate_fixed(s, m, n, tau_f, sig);
        v.cnt = __fadd_rn(v.cnt, 1.f);
      }
    }
    v.iters += ce;
    if constexpr (kTel) {
      if (tid == 0) tel_ints<true>()[kTelIters2] += ce;
    }
    check<KM, V, kTel>(mv, s, m, n, v, tol);
    TR(kTrOther);
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
      if constexpr (kTel) {
        ti[lp * kTelInts + kTelIters2] = tel_ints<true>()[kTelIters2];
        ti[lp * kTelInts + kTelRestarts] = tel_ints<true>()[kTelRestarts];
        for (int k = 0; k < 4; ++k)
          tf[lp * kTelFloats + k] = tel_floats<true>()[k];
      }
    }
    TR_END();
    return;
  }

  // extraction (extract_pdhg) and the warm capture
  const bool opt = v.status == kOptimal;
  mv.mv(s, m, n, nullptr, nullptr, s.y, s.n0);
  warp_sum_to<KM>(0, n, [&](int j) { return __fmul_rn(s.c[j], s.x[j]); },
                  s.red + 0);
  TSYNC();
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
  TR_END();
}

// The counter rows of a launch (null, or both given for a segment).
struct TelRows {
  int* ti;
  float* tf;
};

template <int kMode, class V, int KM, bool kTel = false>
cudaError_t launch(const Args& g, const TelRows& t, int B, int m, int n,
                   int steps, int max_rounds, int ce, float tol, int threads,
                   cudaStream_t stream) {
  auto kernel = pdhg_kernel<kMode, V, KM, kTel>;
  const size_t smem = sizeof(float) * V::words(m, n);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, smem, stream>>>(g, m, n, steps, max_rounds, ce, tol,
                                       t.ti, t.tf);
  return cudaGetLastError();
}

template <class V, int KM>
cudaError_t by_mode(int mode, const Args& g, const TelRows& t, int B, int m,
                    int n, int steps, int max_rounds, int ce, float tol,
                    int threads, cudaStream_t st) {
  if (mode == kSegment && t.ti != nullptr)
    return launch<kSegment, V, KM, true>(g, t, B, m, n, steps, max_rounds,
                                         ce, tol, threads, st);
  if (mode == kSegment)
    return launch<kSegment, V, KM>(g, t, B, m, n, steps, max_rounds, ce, tol,
                                   threads, st);
  if (mode == kWholeFixed)
    return launch<kWholeFixed, V, KM>(g, t, B, m, n, steps, max_rounds, ce,
                                      tol, threads, st);
  return launch<kWholeMP, V, KM>(g, t, B, m, n, steps, max_rounds, ce, tol,
                                 threads, st);
}

// The two register shapes (see the note at the top), with the blocks an
// SM must hold (which caps the registers a thread: 255 and 128).
using RegWarp = RegMv<32, 1, 2, 32, 8>;     // m <= 64, n <= 32
using RegBlock = RegMv<16, 16, 7, 7, 2>;    // m, n <= 112

// Which register shape takes (m, n): 1 RegWarp, 2 RegBlock, 0 none.
inline int reg_shape(int m, int n) {
  if (m <= 64 && n <= 32) return 1;
  if (m <= 112 && n <= 112) return 2;
  return 0;
}

}  // namespace

// Bytes of dynamic shared memory one block of the shared (a_smem != 0) or
// device variant takes.
extern "C" long long pdhg_tile_smem_bytes(int m, int n, int a_smem) {
  return (long long)(sizeof(float) * layout(m, n, a_smem != 0).words);
}

namespace {

// pdhg_tile_variant with `reserved` bytes of the block's shared memory
// taken (the counter slot's, for the counter-carrying instantiations).
int variant_with(int m, int n, int reserved) {
  if (reg_shape(m, n)) return kVarRegisters;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  return m <= 256 && n <= 256 &&
                 pdhg_tile_smem_bytes(m, n, 1) <= limit - reserved
             ? kVarShared
             : kVarDevice;
}

}  // namespace

// The variant the launcher runs for (m, n) on the current device: 0
// registers, 1 shared, 2 device; minus a CUDA error code on failure.
extern "C" int pdhg_tile_variant(int m, int n) {
  return variant_with(m, n, 0);
}

// Threads a block of the variant for (m, n) takes: the register shape's
// (32 or 256); 128 or 256 in the shared and device variants.
extern "C" int pdhg_tile_threads(int m, int n) {
  switch (reg_shape(m, n)) {
    case 1: return RegWarp::kThreads;
    case 2: return RegBlock::kThreads;
    default: return (m > n ? m : n) < 64 ? 128 : 256;
  }
}

namespace {

// Validates and launches the given variant (see pdhg_launch).
int launch_variant(
    const void* A, const void* b, const void* c, const void* rsc,
    const void* csc, const void* ub, const void* eta, const void* binf,
    const void* cinf, void* x, void* y, void* xs, void* ys, void* xr,
    void* yr, void* cnt, void* last, void* prev, void* omega, void* status,
    void* iters, void* it, void* xo, void* obj, void* yo, void* zo, void* wy,
    int B, int m, int n, int steps, int max_rounds, int ce, float tol,
    int mode, int threads, void* stream, int variant, void* ti = nullptr,
    void* tf = nullptr) {
  if (B <= 0) return cudaSuccess;
  if ((ti == nullptr) != (tf == nullptr) ||
      (ti != nullptr && mode != kSegment))
    return cudaErrorInvalidValue;
  if (m < 1 || n < 1 || m > 32 * kMaxK || n > 32 * kMaxK || ce < 1 ||
      mode < kSegment || mode > kWholeMP)
    return cudaErrorInvalidValue;
  const int shape = reg_shape(m, n);
  if (variant == kVarRegisters
          ? (shape == 0 ||
             threads != (shape == 1 ? RegWarp::kThreads : RegBlock::kThreads))
          : (variant != kVarShared && variant != kVarDevice) ||
                threads < 128 || threads > 256 || threads % 32)
    return cudaErrorInvalidValue;
  if (mode == kSegment ? it == nullptr
                       : (xo == nullptr || obj == nullptr || yo == nullptr ||
                          zo == nullptr || wy == nullptr))
    return cudaErrorInvalidValue;
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
  const TelRows t{static_cast<int*>(ti), static_cast<float*>(tf)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == kVarRegisters) {
    // the check's sums cover at most 128 terms: 4 lanes' worth
    if (shape == 1)
      return by_mode<RegWarp, 4>(mode, g, t, B, m, n, steps, max_rounds, ce,
                                 tol, threads, st);
    return by_mode<RegBlock, 4>(mode, g, t, B, m, n, steps, max_rounds, ce,
                                tol, threads, st);
  }
  // KM, the lanes a tree sum may hold: 8 (sums of up to 256 terms) with A
  // in shared memory, kMaxK with A in device memory; a sum that needs
  // fewer lanes skips the levels it does not have.
  if (variant == kVarShared) {
    if (m > 256 || n > 256) return cudaErrorInvalidValue;
    return by_mode<WarpMv<true, 8>, 8>(mode, g, t, B, m, n, steps,
                                       max_rounds, ce, tol, threads, st);
  }
  return by_mode<WarpMv<false, kMaxK>, kMaxK>(mode, g, t, B, m, n, steps,
                                              max_rounds, ce, tol, threads,
                                              st);
}

}  // namespace

// Launches one block per LP on `stream`, in the variant pdhg_tile_variant
// names; allocates nothing and does not synchronise.  A (B, m, n), b, rsc
// (B, m), c, csc, ub (B, n) and eta, binf, cinf (B,) are read; x, xs, xr
// (B, n), y, ys, yr (B, m), cnt, last, prev, omega, status, iters (B,) are
// updated in place (a whole solve writes back only omega, status and
// iters).  mode 0 (segment) writes the rounds each LP ran to it (B,);
// modes 1 (fixed) and 2 (Malitsky-Pock), whole solves, write xo, zo
// (B, n), obj (B,), yo, wy (B, m).  `threads` must be the variant's
// (pdhg_tile_threads).  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int pdhg_launch(
    const void* A, const void* b, const void* c, const void* rsc,
    const void* csc, const void* ub, const void* eta, const void* binf,
    const void* cinf, void* x, void* y, void* xs, void* ys, void* xr,
    void* yr, void* cnt, void* last, void* prev, void* omega, void* status,
    void* iters, void* it, void* xo, void* obj, void* yo, void* zo, void* wy,
    int B, int m, int n, int steps, int max_rounds, int check_every,
    float tol, int mode, int threads, void* stream) {
  if (B <= 0) return cudaSuccess;
  const int variant = pdhg_tile_variant(m, n);
  if (variant < 0) return -variant;
  if (threads != pdhg_tile_threads(m, n)) return cudaErrorInvalidValue;
  return launch_variant(A, b, c, rsc, csc, ub, eta, binf, cinf, x, y, xs, ys,
                        xr, yr, cnt, last, prev, omega, status, iters, it, xo,
                        obj, yo, zo, wy, B, m, n, steps, max_rounds,
                        check_every, tol, mode, threads, stream, variant);
}

// pdhg_launch's segment (mode 0) through the counter-carrying
// instantiation: `ti` (B, 16) int32 and `tf` (B, 8) float32, the packed
// counter rows of obs.telemetry.tel_to_rows, updated in place (int lanes
// 1 and 9: iterations, restarts; float lanes 0-3: the last KKT triple,
// omega).  The variant is chosen with the counter slot's shared memory
// taken.
extern "C" int pdhg_segment_tel_launch(
    const void* A, const void* b, const void* c, const void* rsc,
    const void* csc, const void* ub, const void* eta, const void* binf,
    const void* cinf, void* x, void* y, void* xs, void* ys, void* xr,
    void* yr, void* cnt, void* last, void* prev, void* omega, void* status,
    void* iters, void* it, void* ti, void* tf, int B, int m, int n,
    int steps, int max_rounds, int check_every, float tol, int threads,
    void* stream) {
  if (B <= 0) return cudaSuccess;
  if (ti == nullptr || tf == nullptr) return cudaErrorInvalidValue;
  const int variant = variant_with(m, n, kTelSlotBytes);
  if (variant < 0) return -variant;
  if (threads != pdhg_tile_threads(m, n)) return cudaErrorInvalidValue;
  return launch_variant(A, b, c, rsc, csc, ub, eta, binf, cinf, x, y, xs, ys,
                        xr, yr, cnt, last, prev, omega, status, iters, it,
                        nullptr, nullptr, nullptr, nullptr, nullptr, B, m, n,
                        steps, max_rounds, check_every, tol, kSegment,
                        threads, stream, variant, ti, tf);
}

#ifdef PDHG_TRACE
// The cycle counters: kTrPhases sums over the blocks, then the count of
// blocks that booked them.
extern "C" int pdhg_trace_phases() { return kTrPhases; }
extern "C" int pdhg_trace_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
}
extern "C" int pdhg_trace_reset() {
  static const unsigned long long zero[kTrPhases + 1] = {};
  return (int)cudaMemcpyToSymbol(g_trace, zero, sizeof(zero));
}
// pdhg_launch with the variant given (0 registers, 1 shared, 2 device) and
// `threads` to match it, to trace two designs on one shape.
extern "C" int pdhg_launch_variant(
    const void* A, const void* b, const void* c, const void* rsc,
    const void* csc, const void* ub, const void* eta, const void* binf,
    const void* cinf, void* x, void* y, void* xs, void* ys, void* xr,
    void* yr, void* cnt, void* last, void* prev, void* omega, void* status,
    void* iters, void* it, void* xo, void* obj, void* yo, void* zo, void* wy,
    int B, int m, int n, int steps, int max_rounds, int check_every,
    float tol, int mode, int threads, void* stream, int variant) {
  return launch_variant(A, b, c, rsc, csc, ub, eta, binf, cinf, x, y, xs, ys,
                        xr, yr, cnt, last, prev, omega, status, iters, it, xo,
                        obj, yo, zo, wy, B, m, n, steps, max_rounds,
                        check_every, tol, mode, threads, stream, variant);
}
#endif
