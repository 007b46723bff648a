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
// times it).  Pallas cannot lower an LU, so the reference refactorizes on
// the host between launches; here the block refactorizes its own basis
// matrix by Gauss-Jordan with partial pivoting (the plain `_gauss_solve`,
// step for step) at its first step in a segment and whenever K =
// `refactor_period` pivots have passed since the last one (the eta clock,
// per LP): the reference's schedule at tile_b = 1.
//
// What bounds it.  The parity contract fixes the order of every sum: each
// dot product is one chain of exact float64 products added in index order
// (core/fp.py `sum_products`).  So a step is three dependent chains of m
// double adds (BTRAN, the pricing of a column, FTRAN) framed by block
// reductions, and no tensor core applies (DMMA sums in its own order).  The
// floor those chains set is their float64 instructions, 2 a term at 64 a
// cycle an SM: about 100 ms for all 50,000 LPs of lp_100d_50k, against
// 36 ms for the float32 operations bound; the float32 -> float64
// conversion of one operand a term (16 a cycle an SM) comes on top.  What
// bounds this kernel is latency: each phase is a dependent chain per
// thread (a term waits on the add before it, a load on the barrier before
// it), only m threads have a chain, and two 100 x 100 LPs fill an SM's
// shared memory, so few warps hide each other's waits.
//
// What the design does about it:
//  * A on chip.  The structural columns of Abar (m x n) sit in shared
//    memory (`shared` variant), reloaded in coalesced rows after every
//    refactorization, so pricing's chains read shared memory, not L2.
//    Each term is one fused float64 multiply-add, which rounds as the
//    exact product plus one add (a float product is exact in double).
//    The loads of a chain's next four terms go out before its current four
//    adds.
//  * No wasted terms.  A slack column n+i is the signed unit vector
//    sign_i e_i (checked once a launch); while every y is finite its chain
//    sums to exactly 0 + sign_i * y_i, so it is priced as that one product.
//    A zero term of c_B (BTRAN) or of a_e (FTRAN) adds a zero that cannot
//    change an accumulator that started at +0 while Binv is finite, so only
//    the nonzero terms are summed then (lists built by warp ballots; the
//    finiteness is tracked through every update).  A flip leaves the basis
//    and so y as they are: no BTRAN after it.
//  * Layouts without bank conflicts.  Binv (m x ld) has ld = 4 mod 8, so
//    FTRAN's row reads are conflict-free float4 loads and BTRAN's column
//    reads are consecutive.  The Gauss-Jordan left half reuses A's region.
//  * Gauss-Jordan without data movement or division.  Rows are permuted,
//    not swapped; the steps run in panels of four, each step computing
//    only its column and pivot row with the panel's earlier steps applied,
//    and the bulk takes the panel's four updates in one pass (a quarter of
//    the shared-memory traffic, which bounds that pass); every (row,
//    4-column group) belongs to one thread; no index division.  The eta
//    update is the same rank-one pass with the pivot row in a buffer.
//  * Few barriers: five a pivot (BTRAN, pricing, ratio test, the eta
//    update's two); a block reduction takes one barrier (a warp's winner
//    by two warp reductions of an order-preserving key, slots double-
//    buffered); c_B and the basic mask change by one entry a pivot.
//  * A zero dividend, frequent in an inverse's sparse rows, is answered
//    without __fdiv_rn's slow path (a subroutine call).
//  * Sized blocks: one thread a candidate column, at most 384, so afiro's
//    35 x 32 runs three warps and 100 x 100 seven, two LPs an SM (96,608
//    bytes of shared memory each).
//
// A basis too large for shared memory (sc205_like, 246x159) keeps A in
// device memory and the Gauss-Jordan workspace, the FTRAN copies of a_e and
// the panel buffers in the block's slice of a device-memory scratch buffer
// (`device` variant), so its shared memory holds only vectors (about
// 4n + 13m words), and runs the same body.  `revised_tile_variant` is the
// one place that chooses.  A block of any size from one warp to 384
// threads runs any shape: the eta update and the elimination loop over
// their column groups when there are more groups than threads.
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
//
// Per-LP counters (the telemetry plane, src/repro_torch/obs/telemetry.py).
// The kernel has a second instantiation per shape, kTel, that carries the
// int32 counter row of each LP (16 lanes; the float32 row is not the
// revised engine's and stays where it is): thread 0 loads the lanes it
// owns into a static shared-memory slot at the start and books there, after
// each block-uniform decision, the step (its iteration by the phase it
// began in, pivots by phase, bound flips, pivots at a zero minimum ratio,
// partial pricing's rotations to the full pass) and each refactorization
// (the first step's and every K pivots'); at the end it stores them, with
// the eta length (pivots since the last refactorization), in place.  A
// block with nothing to do leaves the row as it is.  Registers hold none
// of it, and kTel == false compiles to the kernel without counters.
//
// Built with -DREVISED_TRACE, thread 0 of each block counts clock64()
// cycles by phase into `g_trace` (revised_trace_read); the main build has
// none of it.

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
constexpr int kMaxThreads = 384;  // block_threads' cap
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// Work counters per LP (core/revised.py WORK_FIELDS).
constexpr int kWorkSteps = 0;
constexpr int kWorkPivots = 1;
constexpr int kWorkFlips = 2;
constexpr int kWorkRefactors = 3;
constexpr int kWorkPriced = 4;
constexpr int kWorkCounters = 5;
// The counter row (src/repro_torch/obs/telemetry.py INT_LANES): its width
// and the lanes the revised engine books.
constexpr int kTelInts = 16;
constexpr int kTelIters1 = 0;
constexpr int kTelIters2 = 1;
constexpr int kTelPivots1 = 2;
constexpr int kTelPivots2 = 3;
constexpr int kTelFlips = 4;
constexpr int kTelDegenerate = 5;
constexpr int kTelRefactors = 6;
constexpr int kTelEtaLen = 7;
constexpr int kTelRotations = 8;
constexpr int kTelLanes = 9;  // lanes 0..8 are the revised engine's
// Variants (revised_tile_variant).
constexpr int kVarShared = 0;
constexpr int kVarDevice = 1;

#ifdef REVISED_TRACE
// Phases of the cycle counters (thread 0 of each block, clock64).
enum : int {
  kTrRefactor,      // refactorization: copy, pivot search, elimination
  kTrBtran,         // y = Binv^T c_B
  kTrPricePartial,  // the partial rule's block of candidates
  kTrPrice,         // every candidate (Dantzig), or the rest (partial)
  kTrFtran,         // u = Binv a_e
  kTrRatio,         // the ratio test
  kTrUpdate,        // flip or pivot: basic values, bound flags, eta update
  kTrBarrier,       // waiting at a block barrier
  kTrOther,         // loads, the step loop, the optimality test, extraction
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
// A barrier's wait is booked to kTrBarrier, except inside a
// refactorization, which keeps its own.
__device__ __forceinline__ int tr_barrier() {
  return tr_to(threadIdx.x == 0 && tr_cur == kTrRefactor ? kTrRefactor
                                                         : kTrBarrier);
}
__device__ __forceinline__ int tsync_and(int x) {
  const int was = tr_barrier();
  const int r = __syncthreads_and(x);
  tr_to(was);
  return r;
}
#define TR(ph) tr_to(ph)
#define TSYNC()                       \
  do {                                \
    const int tr_was_ = tr_barrier(); \
    __syncthreads();                  \
    tr_to(tr_was_);                   \
  } while (0)
#define TSYNC_AND(x) tsync_and(x)
#define TR_BEGIN() tr_begin()
#define TR_END() tr_end()
#else
#define TR(ph) ((void)0)
#define TSYNC() __syncthreads()
#define TSYNC_AND(x) __syncthreads_and(x)
#define TR_BEGIN() ((void)0)
#define TR_END() ((void)0)
#endif

// Leading dimension of Binv and of the Gauss-Jordan left half: the least
// ld >= m with ld = 4 (mod 8).  Rows are 16-byte aligned, and a quarter
// warp's float4 loads of rows i..i+7 at one column fall on distinct bank
// groups (ld/4 is odd), so FTRAN's row reads have no conflict.
__host__ __device__ inline int binv_ld(int m) { return m + ((12 - m % 8) % 8); }

__host__ __device__ inline size_t up4(size_t w) { return (w + 3) & ~size_t(3); }

// The scratch of FTRAN and the Gauss-Jordan in 4-byte words: one copy of
// a_e a warp (double) and its list of nonzero entries, for the FTRAN warps
// a block can have, and a panel's multipliers and pivot rows.  It sits in
// shared memory in the shared variant and in the LP's device-memory
// workspace in the device variant, so that the device variant's shared
// memory holds only vectors of length m or n+m.
struct Scratch {
  size_t nza, mult, rbuf, aed, words;
};

__host__ __device__ inline Scratch scratch(int m) {
  const size_t ld = binv_ld(m);
  const size_t nfw = ((size_t)m + 31) / 32 < kMaxWarps ? ((size_t)m + 31) / 32
                                                        : kMaxWarps;
  Scratch S;
  S.nza = 0;                            // entries where a_e is not zero
  S.mult = up4(nfw * ld);               // m x 4: a panel's multipliers
  S.rbuf = S.mult + 4 * (size_t)m;      // 4 pivot rows: left | right half
  S.aed = up4(S.rbuf + 8 * ld);         // a_e in double
  S.words = up4(S.aed + 2 * nfw * ld);
  return S;
}

// Floats of device-memory workspace one LP of the device variant takes:
// the Gauss-Jordan left half and Binv (m x ld each), then the scratch.
__host__ __device__ inline size_t ws_floats(int m) {
  return 2 * (size_t)m * binv_ld(m) + scratch(m).words;
}

// One block's dynamic shared memory in 4-byte words.  Doubles sit at even
// offsets, float4 rows at multiples of 4.
struct Layout {
  size_t red, misc, cvec, ub, onub, basis, basic, xB, u, sgn, perm, pidx,
      nzc, cbd, yd, scr, areg, binv, words;
};

__host__ __device__ inline Layout layout(int m, int n, bool ws_smem) {
  const size_t NP = (size_t)n + m, ld = binv_ld(m);
  Layout L;
  L.red = 0;                            // 2 sets x kMaxWarps x (v, i)
  L.misc = 4 * kMaxWarps;               // the length of nzc
  L.cvec = L.misc + 4;
  L.ub = L.cvec + NP;
  L.onub = L.ub + n;
  L.basis = L.onub + n;
  L.basic = L.basis + m;                // basic count of each candidate
  L.xB = L.basic + NP;
  L.u = up4(L.xB + m);                  // float4 reads
  L.sgn = L.u + m;                      // slack signs Abar[i, n+i]
  L.perm = L.sgn + m;                   // Gauss-Jordan rows: logical -> physical
  L.pidx = L.perm + m;                  // a row's step in its panel, or -1
  L.nzc = up4(L.pidx + m);              // rows where c_B is not zero
  L.cbd = up4(L.nzc + m);               // c_B in double
  L.yd = up4(L.cbd + 2 * (size_t)m);    // y in double
  L.scr = up4(L.yd + 2 * (size_t)m);    // the scratch (shared variant)
  L.areg = L.scr + (ws_smem ? scratch(m).words : 0);  // A, or the left half
  L.binv = L.areg + (ws_smem ? up4(m * (n > (int)ld ? (size_t)n : ld)) : 0);
  L.words = L.binv + (ws_smem ? (size_t)m * ld : 0);
  return L;
}

struct ArgVal {
  float v;
  int i;
};

// Does (v, i) beat (bv, bi)?  NaN beats every number and ties go to the
// lower index, as torch.argmax/argmin treat them.  A strict total order, so
// any combination order gives the same winner.
__device__ __forceinline__ bool wins(bool is_max, float v, int i, float bv,
                                     int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return (is_max ? v > bv : v < bv) || (v == bv && i < bi);
}

// v as an unsigned key in the order of `wins`: numbers in their order
// with -0 as +0, every NaN first (largest for argmax, 0 for argmin).
template <bool kMax>
__device__ __forceinline__ unsigned order_key(float v) {
  if (isnan(v)) return kMax ? 0xffffffffu : 0u;
  const unsigned b = __float_as_uint(__fadd_rn(v, 0.f));  // -0 -> +0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The warp's winner under `wins`, in every lane: the best key and then the
// lowest index holding it, by two warp reductions; its value from its lane.
// Indices must differ across lanes.
template <bool kMax>
__device__ __forceinline__ ArgVal warp_arg(ArgVal a) {
  const unsigned key = order_key<kMax>(a.v);
  const unsigned best =
      kMax ? __reduce_max_sync(kFull, key) : __reduce_min_sync(kFull, key);
  const unsigned i =
      __reduce_min_sync(kFull, key == best ? (unsigned)a.i : 0xffffffffu);
  const int src = __ffs(__ballot_sync(kFull, key == best && (unsigned)a.i == i)) - 1;
  return ArgVal{__shfl_sync(kFull, a.v, src), (int)i};
}

// v where it is positive, else 0 (NaN and -0 included): a basic value a
// rounding put below its bound counts as at the bound in the ratio test.
__device__ __forceinline__ float nonneg(float v) { return v > 0.f ? v : 0.f; }

// a / b correctly rounded, as __fdiv_rn, which sends a zero dividend down
// its slow path (a subroutine call per lane); 0 / b is a signed zero for
// every b but 0 and NaN, so that case is answered here.
__device__ __forceinline__ float div_rn(float a, float b) {
  if (a == 0.f && b == b && b != 0.f)
    return __int_as_float((__float_as_int(a) ^ __float_as_int(b)) &
                          0x80000000);
  return __fdiv_rn(a, b);
}

// acc + a * b rounded once in double: a float product is exact in double,
// so this is one term of core/fp.py `sum_products` (product, then add).
__device__ __forceinline__ double term(double acc, float a, double b) {
  return __fma_rn((double)a, b, acc);
}

// One dot-product chain, each term one fused float64 multiply-add, in
// order: sum over q < cnt of a[q * sa] * v[q] (dense) or of
// a[idx[q] * sa] * v[idx[q]] (a list of the nonzero terms).  The loads of
// the next four terms go out before the adds of the current four, so the
// chain waits on the adds, not on the loads; v and idx are 16-byte aligned.
__device__ __forceinline__ double chain_dense(const float* a, int sa,
                                              const double* v, int cnt) {
  double acc = 0.0;
  int q = 0;
  if (cnt >= 4) {
    float a0 = a[0], a1 = a[sa], a2 = a[2 * sa], a3 = a[3 * sa];
    double2 v01 = reinterpret_cast<const double2*>(v)[0],
            v23 = reinterpret_cast<const double2*>(v)[1];
#pragma unroll 1
    for (; q + 8 <= cnt; q += 4) {
      const float* an = a + (size_t)(q + 4) * sa;
      const float b0 = an[0], b1 = an[sa], b2 = an[2 * sa], b3 = an[3 * sa];
      const double2* vn = reinterpret_cast<const double2*>(v + q + 4);
      const double2 w01 = vn[0], w23 = vn[1];
      acc = term(acc, a0, v01.x);
      acc = term(acc, a1, v01.y);
      acc = term(acc, a2, v23.x);
      acc = term(acc, a3, v23.y);
      a0 = b0, a1 = b1, a2 = b2, a3 = b3, v01 = w01, v23 = w23;
    }
    acc = term(acc, a0, v01.x);
    acc = term(acc, a1, v01.y);
    acc = term(acc, a2, v23.x);
    acc = term(acc, a3, v23.y);
    q += 4;
  }
#pragma unroll 1
  for (; q < cnt; ++q) acc = term(acc, a[(size_t)q * sa], v[q]);
  return acc;
}

__device__ __forceinline__ double chain_list(const float* a, int sa,
                                             const double* v, const int* idx,
                                             int cnt) {
  double acc = 0.0;
  int q = 0;
  if (cnt >= 4) {
    int4 k = reinterpret_cast<const int4*>(idx)[0];
    float a0 = a[(size_t)k.x * sa], a1 = a[(size_t)k.y * sa],
          a2 = a[(size_t)k.z * sa], a3 = a[(size_t)k.w * sa];
    double v0 = v[k.x], v1 = v[k.y], v2 = v[k.z], v3 = v[k.w];
#pragma unroll 1
    for (; q + 8 <= cnt; q += 4) {
      k = reinterpret_cast<const int4*>(idx + q + 4)[0];
      const float b0 = a[(size_t)k.x * sa], b1 = a[(size_t)k.y * sa],
                  b2 = a[(size_t)k.z * sa], b3 = a[(size_t)k.w * sa];
      const double w0 = v[k.x], w1 = v[k.y], w2 = v[k.z], w3 = v[k.w];
      acc = term(acc, a0, v0);
      acc = term(acc, a1, v1);
      acc = term(acc, a2, v2);
      acc = term(acc, a3, v3);
      a0 = b0, a1 = b1, a2 = b2, a3 = b3, v0 = w0, v1 = w1, v2 = w2, v3 = w3;
    }
    acc = term(acc, a0, v0);
    acc = term(acc, a1, v1);
    acc = term(acc, a2, v2);
    acc = term(acc, a3, v3);
    q += 4;
  }
#pragma unroll 1
  for (; q < cnt; ++q) acc = term(acc, a[(size_t)idx[q] * sa], v[idx[q]]);
  return acc;
}

// The state a segment reads and writes, one row per LP (see
// src/repro_torch/core/revised.py, `RevisedState`).  Abar, cvec, ub and thr
// are read-only; onub is one byte per structural column; `it` receives the
// steps each LP took; `ws` is the device-memory workspace (B x
// ws_floats(m)) of the device variant, else null.
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
  float* ws;
};

struct Block {
  const float* Abar;  // m x (n+2m), device memory
  const float* A;     // structural columns, row stride lda
  float* left;        // Gauss-Jordan left half, m x ld (shared: A's region)
  float* Binv;        // m x ld; columns m..ld-1 stay zero
  int lda, ld;
  float* cvec;
  float* ub;
  int* onub;
  int* basis;
  int* basic;
  int *misc, *perm, *pidx, *nzc, *nza;
  float *xB, *u, *sgn, *mult, *rbuf;
  double *cbd, *yd, *aed;
  ArgVal* red;
};

template <bool kSmem>
__device__ inline Block carve(float* smem, const Layout& L, const float* Abar,
                              float* ws, int m, int n) {
  Block s;
  s.Abar = Abar;
  s.ld = binv_ld(m);
  s.red = reinterpret_cast<ArgVal*>(smem + L.red);
  s.cvec = smem + L.cvec;
  s.ub = smem + L.ub;
  s.onub = reinterpret_cast<int*>(smem + L.onub);
  s.basis = reinterpret_cast<int*>(smem + L.basis);
  s.basic = reinterpret_cast<int*>(smem + L.basic);
  s.misc = reinterpret_cast<int*>(smem + L.misc);
  s.nzc = reinterpret_cast<int*>(smem + L.nzc);
  s.xB = smem + L.xB;
  s.u = smem + L.u;
  s.sgn = smem + L.sgn;
  s.perm = reinterpret_cast<int*>(smem + L.perm);
  s.pidx = reinterpret_cast<int*>(smem + L.pidx);
  s.cbd = reinterpret_cast<double*>(smem + L.cbd);
  s.yd = reinterpret_cast<double*>(smem + L.yd);
  const Scratch S = scratch(m);
  float* scr = kSmem ? smem + L.scr : ws + 2 * (size_t)m * s.ld;
  s.nza = reinterpret_cast<int*>(scr + S.nza);
  s.mult = scr + S.mult;
  s.rbuf = scr + S.rbuf;
  s.aed = reinterpret_cast<double*>(scr + S.aed);
  if (kSmem) {
    s.A = smem + L.areg;
    s.lda = n;
    s.left = smem + L.areg;
    s.Binv = smem + L.binv;
  } else {
    s.A = Abar;
    s.lda = n + 2 * m;
    s.left = ws;
    s.Binv = ws + (size_t)m * s.ld;
  }
  return s;
}

// Block-wide argmax (argmin) under `wins`, known to every thread after one
// barrier: each warp's winner goes to slot set `set`, which alternates, so
// the next reduction never writes slots this one still reads.
template <bool kMax>
__device__ __forceinline__ ArgVal block_arg(ArgVal a, ArgVal* red, int& set) {
  a = warp_arg<kMax>(a);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ArgVal* slots = red + set * kMaxWarps;
  if (lane == 0) slots[warp] = a;
  TSYNC();
  ArgVal r = slots[0];
#pragma unroll 1
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
    const ArgVal o = slots[w];
    if (wins(kMax, o.v, o.i, r.v, r.i)) r = o;
  }
  set ^= 1;
  return r;
}

// Copies the structural columns of Abar into A's region: a warp a row,
// 16-byte loads where rows allow them.
__device__ inline void load_a(const Block& s, int m, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, NC = n + 2 * m;
  float* A = const_cast<float*>(s.A);
  const bool vec = (n % 4 == 0) && (NC % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(s.Abar) % 16 == 0);
#pragma unroll 1
  for (int i = warp; i < m; i += nw) {
    const float* src = s.Abar + (size_t)i * NC;
    float* dst = A + (size_t)i * n;
    if (vec) {
#pragma unroll 1
      for (int q = lane; q < n / 4; q += 32)
        reinterpret_cast<float4*>(dst)[q] =
            __ldg(reinterpret_cast<const float4*>(src) + q);
    } else {
#pragma unroll 1
      for (int j = lane; j < n; j += 32) dst[j] = __ldg(src + j);
    }
  }
}

// The eta update of a pivot on row l: Binv[i][c] -= u[i] * r[c] for every
// row i and column c < m, row l set to r (r = Binv[l] / u_l, in rbuf).
// Each (row slice, 4-column group) pair belongs to one thread, which runs
// rows four at a time with their loads ahead of their stores (a block with
// fewer threads than groups: one slice, each thread looping over groups);
// the owner of row l writes its garbage there first and r last.  Returns
// whether every value written is finite (row l's garbage included, which
// can only make the answer false when all is finite).
__device__ __forceinline__ bool eta_update(const Block& s, int m, int l) {
  const int ld = s.ld, ng = (m + 3) / 4, T = blockDim.x, tid = threadIdx.x;
  const bool wide = T >= ng;
  const int slices = wide ? T / ng : 1, slice = wide ? tid / ng : 0;
  bool fin = true;
  if (slice >= slices) return fin;
#pragma unroll 1
  for (int t = tid - slice * ng; t < ng; t += wide ? ng : T) {
    float* base = s.Binv + 4 * t;
    const float4 r = *reinterpret_cast<const float4*>(s.rbuf + 4 * t);
    const int hi = m - 4 * t;  // live columns of the group: [0, hi)
    const bool l0 = 0 < hi, l1 = 1 < hi, l2 = 2 < hi, l3 = 3 < hi;
    auto put = [&](int q, const float4& o) {
      float* e = base + (size_t)q * ld;
      if (l3) {
        *reinterpret_cast<float4*>(e) = o;
      } else {
        if (l0) e[0] = o.x;
        if (l1) e[1] = o.y;
        if (l2) e[2] = o.z;
      }
      fin = fin && (!l0 || fabsf(o.x) <= 3.402823466e38f) &&
            (!l1 || fabsf(o.y) <= 3.402823466e38f) &&
            (!l2 || fabsf(o.z) <= 3.402823466e38f) &&
            (!l3 || fabsf(o.w) <= 3.402823466e38f);
    };
    auto update = [&](float4 o, float ui) {
      o.x = __fmaf_rn(-ui, r.x, o.x);
      o.y = __fmaf_rn(-ui, r.y, o.y);
      o.z = __fmaf_rn(-ui, r.z, o.z);
      o.w = __fmaf_rn(-ui, r.w, o.w);
      return o;
    };
    int q = slice;
  #pragma unroll 1
    for (; q + 3 * slices < m; q += 4 * slices) {
      float4 o[4];
      float c[4];
  #pragma unroll
      for (int k = 0; k < 4; ++k) {
        o[k] = *reinterpret_cast<const float4*>(base +
                                                (size_t)(q + k * slices) * ld);
        c[k] = s.u[q + k * slices];
      }
  #pragma unroll
      for (int k = 0; k < 4; ++k) put(q + k * slices, update(o[k], c[k]));
    }
  #pragma unroll 1
    for (; q < m; q += slices)
      put(q, update(*reinterpret_cast<const float4*>(base + (size_t)q * ld),
                    s.u[q]));
    if (l % slices == slice) put(l, r);
  }
  return fin;
}

// Binv of the current basis, by Gauss-Jordan with partial pivoting on
// [B | I]: the plain `_gauss_solve` step for step.  Rows are swapped in a
// permutation (perm: logical row -> physical row), not in memory, which
// moves no value and so changes no rounding.  Columns left of the pivot are
// never read again, so step k updates columns k+1..2m-1.
//
// The steps run in panels of four, so the bulk of [B | I] is read and
// written once a panel, not once a step (shared memory's bandwidth bounds
// the update).  Step j of a panel works only on what it needs, with the
// panel's earlier steps applied in order: (A) column k for every row (its
// multipliers, into mult[:, j]); a barrier; (B) the pivot search by every
// warp (logical rows >= k; lowest row on ties, NaN first) and the pivot
// row r_j = M[p, :] / M[p, k] (into rbuf j); a barrier.  Then (C) every
// row and 4-column group right of the panel takes the panel's steps in
// order, M = fma(-mult[q][j], r_j, M), a pivot row r_j at its own step.
// Every value meets the same operations in the same order as in one step
// at a time.  Then Binv is put back in logical row order and A reloaded.
// Returns whether every entry of Binv is finite.
template <bool kSmem>
__device__ bool refactor(const Block& s, int m, int n) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const int NC = n + 2 * m, ld = s.ld, G = ld / 4, RB = 2 * ld;
  float* L = s.left;
  float* Bi = s.Binv;
  int* perm = s.perm;
  int* pidx = s.pidx;
  float* mult = s.mult;
  float* rb = s.rbuf;
#pragma unroll 1
  for (int i = warp; i < m; i += nw) {
    const float* arow = s.Abar + (size_t)i * NC;
#pragma unroll 1
    for (int j = lane; j < ld; j += 32) {
      L[(size_t)i * ld + j] = j < m ? arow[s.basis[j]] : 0.f;
      Bi[(size_t)i * ld + j] = j == i ? 1.f : 0.f;
    }
  }
#pragma unroll 1
  for (int i = tid; i < m; i += T) {
    perm[i] = i;
    pidx[i] = -1;
  }
  TSYNC();
#pragma unroll 1
  for (int k0 = 0; k0 < m; k0 += 4) {
    const int KB = min(4, m - k0);
    int qp = 0, qk = 0, p = 0;  // the last step's swap, made by thread 0
#pragma unroll 1
    for (int j = 0; j < KB; ++j) {
      const int k = k0 + j;
      if (tid == 0 && j > 0) {  // every warp is past the last step's search
        perm[k - 1] = qp;
        perm[p] = qk;
      }
      // (A) column k with the panel's earlier steps: the multipliers
#pragma unroll 1
      for (int q = tid; q < m; q += T) {
        float val = L[(size_t)q * ld + k];
        const int pi = pidx[q];
#pragma unroll 1
        for (int i = 0; i < j; ++i) {
          const float ri = rb[i * RB + k];
          val = pi == i ? ri : __fmaf_rn(-mult[q * 4 + i], ri, val);
        }
        mult[q * 4 + j] = val;
      }
      TSYNC();
      // (B) the pivot, then its row over the live columns of both halves
      ArgVal best{-INFINITY, INT_MAX};
#pragma unroll 1
      for (int i = k + lane; i < m; i += 32) {
        const float v = fabsf(mult[perm[i] * 4 + j]);
        if (wins(true, v, i, best.v, best.i)) {
          best.v = v;
          best.i = i;
        }
      }
      p = warp_arg<true>(best).i;
      qp = perm[p];
      qk = perm[k];
      const float piv = mult[qp * 4 + j];
#pragma unroll 1
      for (int c = k + 1 + tid; c < 2 * m; c += T) {
        const int cc = c < m ? c : c - m + ld;  // offset in a pivot row
        float val = c < m ? L[(size_t)qp * ld + c] : Bi[(size_t)qp * ld + c - m];
#pragma unroll 1
        for (int i = 0; i < j; ++i)
          val = __fmaf_rn(-mult[qp * 4 + i], rb[i * RB + cc], val);
        rb[j * RB + cc] = div_rn(val, piv);
      }
      if (tid == 0) pidx[qp] = j;
      TSYNC();
    }
    if (tid == 0) {
      perm[k0 + KB - 1] = qp;
      perm[p] = qk;
    }
    // (C) groups right of the panel in the left half, then all of Binv: a
    // (row slice, group) pair a thread, or with fewer threads than groups
    // one slice, each thread looping over groups
    const int g0 = (k0 + KB) / 4, ng = 2 * G - g0;
    const bool wide = T >= ng;
    const int slices = wide ? T / ng : 1, slice = wide ? tid / ng : 0;
#pragma unroll 1
    for (int t = tid - slice * ng; slice < slices && t < ng;
         t += wide ? ng : T) {
      const int g = g0 + t;
      const bool right = g >= G;
      const int c0 = 4 * (right ? g - G : g);
      float* base = (right ? Bi : L) + c0;
      const int off = (right ? ld : 0) + c0;
      const int lo = right ? 0 : k0 + KB - c0, hi = m - c0;
      const bool all = lo <= 0 && hi >= 4;
      float4 r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = i < KB ? *reinterpret_cast<const float4*>(rb + i * RB + off)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
      for (int q = slice; q < m; q += slices) {
        float* e = base + (size_t)q * ld;
        float4 o = *reinterpret_cast<const float4*>(e);
        const float4 mq = *reinterpret_cast<const float4*>(mult + q * 4);
        const int pi = pidx[q];
        const float mv[4] = {mq.x, mq.y, mq.z, mq.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i >= KB) break;
          if (pi == i) {
            o = r[i];
          } else {
            o.x = __fmaf_rn(-mv[i], r[i].x, o.x);
            o.y = __fmaf_rn(-mv[i], r[i].y, o.y);
            o.z = __fmaf_rn(-mv[i], r[i].z, o.z);
            o.w = __fmaf_rn(-mv[i], r[i].w, o.w);
          }
        }
        if (all) {
          *reinterpret_cast<float4*>(e) = o;
        } else {
          if (0 >= lo && 0 < hi) e[0] = o.x;
          if (1 >= lo && 1 < hi) e[1] = o.y;
          if (2 >= lo && 2 < hi) e[2] = o.z;
          if (3 >= lo && 3 < hi) e[3] = o.w;
        }
      }
    }
    TSYNC();
    if (tid == 0) {
#pragma unroll 1
      for (int i = k0; i < k0 + KB; ++i) pidx[perm[i]] = -1;
    }
  }
  // Binv back in logical row order, through the free left half
#pragma unroll 1
  for (int i = warp; i < m; i += nw) {
    const float4* src = reinterpret_cast<const float4*>(Bi + (size_t)perm[i] * ld);
    float4* dst = reinterpret_cast<float4*>(L + (size_t)i * ld);
#pragma unroll 1
    for (int q = lane; q < G; q += 32) dst[q] = src[q];
  }
  TSYNC();
  bool fin = true;
#pragma unroll 1
  for (int i = warp; i < m; i += nw) {
    const float4* src = reinterpret_cast<const float4*>(L + (size_t)i * ld);
    float4* dst = reinterpret_cast<float4*>(Bi + (size_t)i * ld);
#pragma unroll 1
    for (int q = lane; q < G; q += 32) {
      const float4 o = src[q];
      dst[q] = o;
      fin = fin && fabsf(o.x) <= 3.402823466e38f &&
            fabsf(o.y) <= 3.402823466e38f && fabsf(o.z) <= 3.402823466e38f &&
            fabsf(o.w) <= 3.402823466e38f;
    }
  }
  TSYNC();
  if (kSmem) load_a(s, m, n);  // A back into the left half's region
  return TSYNC_AND(fin) != 0;
}

// The rows where c_B is not zero, in order, into nzc (its length in
// misc[0]): one warp, a ballot per 32 rows.
__device__ inline void list_cb(const Block& s, int m) {
  const int lane = threadIdx.x & 31;
  int base = 0;
#pragma unroll 1
  for (int c = 0; c < m; c += 32) {
    const int i = c + lane;
    const bool nz = i < m && s.cbd[i] != 0.0;
    const unsigned mask = __ballot_sync(kFull, nz);
    if (nz) s.nzc[base + __popc(mask & ((1u << lane) - 1u))] = i;
    base += __popc(mask);
  }
  if (lane == 0) s.misc[0] = base;
}

// y = Binv^T c_B: y_j sums Binv[i][j] c_B[i] over rows i in order.  A zero
// c_B[i] makes a zero product while Binv is finite, and a zero added to an
// accumulator that started at +0 changes nothing (it is never -0), so only
// the rows of nzc are summed then.  Writes y in double; returns whether
// every y is finite (one barrier).
__device__ inline bool btran(const Block& s, int m, bool binv_fin) {
  const int ld = s.ld;
  const int cnt = binv_fin ? s.misc[0] : m;
  const int* rows = s.nzc;
  bool fin = true;
#pragma unroll 1
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const float* col = s.Binv + j;
    const double acc = binv_fin ? chain_list(col, ld, s.cbd, rows, cnt)
                                : chain_dense(col, ld, s.cbd, m);
    const float yf = __double2float_rn(acc);
    s.yd[j] = (double)yf;
    fin = fin && fabsf(yf) <= 3.402823466e38f;
  }
  return TSYNC_AND(fin) != 0;
}

// Reduced cost of candidate j (the plain version's d_j, masked).  A slack
// column is sign_i e_i when `slack_ok` (checked once a launch, and every y
// finite), so its chain is exactly 0 + sign_i y_i.
__device__ __forceinline__ float price(const Block& s, int m, int n, int j,
                                       bool phase2, bool slack_ok) {
  double acc;
  const double* yd = s.yd;
  if (j < n) {
    const float* col = s.A + j;
    const int lda = s.lda;
    acc = chain_dense(col, lda, yd, m);
  } else if (slack_ok) {
    acc = term(0.0, s.sgn[j - n], yd[j - n]);
  } else {
    const float* col = s.Abar + j;
    const int NC = n + 2 * m;
    acc = chain_dense(col, NC, yd, m);
  }
  float dv = __fsub_rn(phase2 ? s.cvec[j] : 0.f, __double2float_rn(acc));
  if (j < n && s.onub[j]) dv = -dv;
  if (s.basic[j] > 0) dv = -kBig;
  return dv;
}

// c_B[i] for the LP's phase: phase 1 charges -1 on a basic artificial,
// phase 2 the cost of a basic candidate (0 for an artificial).
__device__ __forceinline__ double cost_b(const Block& s, int NP, int phase,
                                         int bi) {
  if (phase == 1) return bi >= NP ? -1.0 : 0.0;
  return bi < NP ? (double)s.cvec[bi] : 0.0;
}

// Per-LP scalars, identical in every thread of the block.
struct Scalars {
  int phase, status, iters, cnt, set;
  float thr;
  bool binv_fin;    // every entry of Binv is finite
  bool slack_diag;  // every slack column is sign_i e_i
  bool have_y;      // yd is c_B Binv for the current c_B and Binv
  bool yfin;        // every y is finite
  int work[kWorkCounters];
};

// The block's counter slot in static shared memory, in the counter-
// carrying instantiations only (null in the others, which allocate none).
template <bool kTel>
__device__ __forceinline__ int* tel_slot() {
  if constexpr (kTel) {
    __shared__ int slot[kTelInts];
    return slot;
  } else {
    return nullptr;
  }
}

// Thread 0 books one into counter lane `k` (kTel only).
template <bool kTel>
__device__ __forceinline__ void tel_add(int k) {
  if constexpr (kTel) {
    if (threadIdx.x == 0) tel_slot<true>()[k] += 1;
  }
}

// One step with y current (v.have_y): pricing, FTRAN, the ratio test and
// a flip (the basis, and so y, stay as they are), a pivot or a terminal
// status.  kTel books it into the counter slot.
template <int kRule, bool kSmem, bool kTel = false>
__device__ void step(const Block& s, int m, int n, float tol, Scalars& v) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int NP = n + m, NC = n + 2 * m, ld = s.ld;
  const int lane = tid & 31, warp = tid >> 5;

  // ---- pricing: the partial rule's block first, every other column only
  // when it prices out (each thread keeps its best across the passes);
  // Dantzig: every column in the first pass
  const bool slack_ok = v.slack_diag && v.yfin;
  const bool p2 = v.phase == 2;
  int lo = 0, hi = NP;
  if (kRule == kPartial) {
    const int bs = NP < kPartialBlock ? NP : kPartialBlock;
    const int nblk = (NP + bs - 1) / bs;
    lo = (v.iters % nblk) * bs;
    hi = lo + bs < NP ? lo + bs : NP;
  }
  ArgVal mine{-INFINITY, INT_MAX}, best;
  int priced = NP;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    TR(kRule == kPartial && pass == 0 ? kTrPricePartial : kTrPrice);
    const int a = pass == 0 ? lo : 0, b = pass == 0 ? hi : NP;
#pragma unroll 1
    for (int j = a + tid; j < b; j += T) {
      if (pass == 1 && j >= lo && j < hi) continue;
      const float dv = price(s, m, n, j, p2, slack_ok);
      if (wins(true, dv, j, mine.v, mine.i)) {
        mine.v = dv;
        mine.i = j;
      }
    }
    best = block_arg<true>(mine, s.red, v.set);
    if (kRule == kDantzig) break;
    if (pass == 0 && best.v > tol) {
      priced = hi - lo;
      break;
    }
    if (pass == 1) tel_add<kTel>(kTelRotations);  // the block priced out
  }
  TR(kTrOther);
  v.work[kWorkSteps] += 1;
  v.work[kWorkPriced] += priced;
  const int e = best.i;

  if (best.v <= tol) {  // optimal for the current objective
    if (v.phase == 1) {
      float p1_obj = 0.f;  // every thread sums the same values in order
#pragma unroll 1
      for (int i = 0; i < m; ++i)
        p1_obj = __fadd_rn(p1_obj, s.basis[i] >= NP ? s.xB[i] : 0.f);
      if (p1_obj > v.thr) {
        v.status = kInfeasible;
      } else {
        tel_add<kTel>(kTelIters1);
        v.phase = 2;
        v.iters += 1;
        v.have_y = false;
        if (warp == 0) {
#pragma unroll 1
          for (int i = lane; i < m; i += 32)
            s.cbd[i] = cost_b(s, NP, 2, s.basis[i]);
          __syncwarp();
          list_cb(s, m);
        }
        TSYNC();
      }
    } else {
      v.status = kOptimal;
    }
    return;
  }

  // ---- FTRAN: u = Binv a_e, a row a thread, a_e in double per warp -------
  TR(kTrFtran);
  const int nw = T >> 5, nfw = min(nw, (m + 31) >> 5);
  if (warp < nfw) {
    double* aed = s.aed + (size_t)warp * ld;
    const int ks = e - n;  // the slack's row when e is a slack
#pragma unroll 1
    for (int j = lane; j < ld; j += 32) {
      float a = 0.f;
      if (j < m) {
        if (e < n) a = s.A[(size_t)j * s.lda + e];
        else if (v.slack_diag) a = j == ks ? s.sgn[j] : 0.f;
        else a = s.Abar[(size_t)j * NC + e];
      }
      aed[j] = (double)a;
    }
    // while Binv is finite a zero entry of a_e adds nothing: a sparse a_e
    // (a slack: one entry) sums only its nonzeros, listed by ballot
    int* nz = s.nza + (size_t)warp * ld;
    int cnt = 0;
    if (v.binv_fin) {
#pragma unroll 1
      for (int c = 0; c < m; c += 32) {
        const bool on = c + lane < m && aed[c + lane] != 0.0;
        const unsigned mask = __ballot_sync(kFull, on);
        if (on) nz[cnt + __popc(mask & ((1u << lane) - 1u))] = c + lane;
        cnt += __popc(mask);
      }
    }
    __syncwarp();
    const bool sparse = v.binv_fin && 2 * cnt < m;
#pragma unroll 1
    for (int i = tid; i < m; i += nfw * 32) {
      const float* row = s.Binv + (size_t)i * ld;
      double acc;
      if (sparse) {
        acc = chain_list(row, 1, aed, nz, cnt);
      } else {  // every term, four a float4 (the padding adds 0 * 0)
        const float4* r4 = reinterpret_cast<const float4*>(row);
        const double2* a2 = reinterpret_cast<const double2*>(aed);
        const int G = ld / 4;
        acc = 0.0;
        float4 b = r4[0];
        double2 x = a2[0], y = a2[1];
#pragma unroll 1
        for (int q = 0; q < G; ++q) {
          const int qn = min(q + 1, G - 1);
          const float4 bn = r4[qn];
          const double2 xn = a2[2 * qn], yn = a2[2 * qn + 1];
          acc = term(acc, b.x, x.x);
          acc = term(acc, b.y, x.y);
          acc = term(acc, b.z, y.x);
          acc = term(acc, b.w, y.y);
          b = bn, x = xn, y = yn;
        }
      }
      s.u[i] = __double2float_rn(acc);
    }
  }

  // ---- sentinel ratio test: each thread reads back the u it wrote --------
  TR(kTrRatio);
  const bool onub_e = e < n && s.onub[e];
  ArgVal rmin{INFINITY, INT_MAX};
#pragma unroll 1
  for (int i = tid; i < m; i += T) {
    const float uc = onub_e ? -s.u[i] : s.u[i];
    const float xb = s.xB[i];
    float r = uc > tol ? div_rn(nonneg(xb), uc) : kBig;
    const int bi = s.basis[i];
    const float ubB = bi < n ? s.ub[bi] : INFINITY;
    if (uc < -tol && isfinite(ubB))
      r = div_rn(nonneg(__fsub_rn(ubB, xb)), -uc);
    if (v.phase == 2 && bi >= NP && uc < -tol) r = 0.f;
    if (wins(false, r, i, rmin.v, rmin.i)) {
      rmin.v = r;
      rmin.i = i;
    }
  }
  const ArgVal lr = block_arg<false>(rmin, s.red, v.set);
  const int l = lr.i;
  const float min_ratio = lr.v;
  const float t_e = e < n ? s.ub[e] : INFINITY;
  TR(kTrUpdate);

  if (t_e < min_ratio) {  // the entering variable reaches its own bound
#pragma unroll 1
    for (int i = tid; i < m; i += T) {
      const float uc = onub_e ? -s.u[i] : s.u[i];
      s.xB[i] = __fmaf_rn(-t_e, uc, s.xB[i]);
    }
    if (tid == 0) s.onub[e] ^= 1;
    v.work[kWorkFlips] += 1;
    tel_add<kTel>(v.phase == 1 ? kTelIters1 : kTelIters2);
    tel_add<kTel>(kTelFlips);
    v.iters += 1;
    TSYNC();  // the basis and so y stay as they are
    TR(kTrOther);
    return;
  }
  if (min_ratio >= kHalfBig) {  // no bounding row
    tel_add<kTel>(v.phase == 1 ? kTelIters1 : kTelIters2);
    v.status = v.phase == 2 ? kUnbounded : kIterationLimit;
    v.iters += 1;
    TR(kTrOther);
    return;
  }

  // ---- pivot: the pivot row r = Binv[l] / u_l, the basic values, the
  // bookkeeping; a barrier; then every (row, 4-column group) of Binv minus
  // u_i times r, row l set to r.  The next step's BTRAN sees the new c_B.
  const float enter_val = onub_e ? __fsub_rn(t_e, min_ratio) : min_ratio;
  const float ul = s.u[l];
#pragma unroll 1
  for (int j = tid; j < m; j += T)
    s.rbuf[j] = div_rn(s.Binv[(size_t)l * ld + j], ul);
#pragma unroll 1
  for (int i = tid; i < m; i += T) {
    const float uc = onub_e ? -s.u[i] : s.u[i];
    s.xB[i] = i == l ? enter_val : __fmaf_rn(-min_ratio, uc, s.xB[i]);
  }
  if (tid == 0) {
    const int jl = s.basis[l];
    const float ucl = onub_e ? -s.u[l] : s.u[l];
    if (e < n) s.onub[e] = 0;
    if (jl < n && ucl < -tol && isfinite(s.ub[jl])) s.onub[jl] = 1;
    if (jl < NP) s.basic[jl] -= 1;
    s.basic[e] += 1;
    s.basis[l] = e;
    s.cbd[l] = cost_b(s, NP, v.phase, e);
  }
  TSYNC();
  const bool fin = eta_update(s, m, l);
  if (warp == 0) list_cb(s, m);
  v.cnt += 1;
  v.work[kWorkPivots] += 1;
  tel_add<kTel>(v.phase == 1 ? kTelIters1 : kTelIters2);
  tel_add<kTel>(v.phase == 1 ? kTelPivots1 : kTelPivots2);
  if (min_ratio <= 0.f) tel_add<kTel>(kTelDegenerate);
  v.iters += 1;
  v.binv_fin = TSYNC_AND(fin) != 0;
  v.have_y = false;
  TR(kTrOther);
}

template <int kRule, bool kSmem, bool kP1, bool kTel = false>
// The shared variant is held to 128 registers (two 224-thread blocks an SM
// at 100 x 100), the device variant to 168.  kTel carries the counter rows
// `tel`, kTelInts int32 an LP, updated in place (the last parameter, so
// that the counter-free instantiation reads every other one where it did
// before the plane).
__global__ void __launch_bounds__(kSmem ? 512 : kMaxThreads)
    revised_segment_kernel(SegmentState g, int m, int n, int steps,
                           int max_iters, float tol, int K, int* tel) {
  const int NP = n + m, NC = n + 2 * m;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
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

  TR_BEGIN();
  extern __shared__ __align__(16) float smem[];
  const Block s = carve<kSmem>(smem, layout(m, n, kSmem),
                               g.Abar + lp * (size_t)m * NC,
                               kSmem ? nullptr : g.ws + lp * ws_floats(m), m, n);
#pragma unroll 1
  for (int j = tid; j < NP; j += T) {
    s.cvec[j] = g.cvec[lp * NP + j];
    s.basic[j] = 0;
  }
#pragma unroll 1
  for (int j = tid; j < n; j += T) {
    s.ub[j] = g.ub[lp * n + j];
    s.onub[j] = g.onub[lp * n + j];
  }
#pragma unroll 1
  for (int i = tid; i < m; i += T) {
    s.basis[i] = g.basis[lp * m + i];
    s.xB[i] = g.xB[lp * m + i];
  }
  // the slack block: its diagonal, and whether it is nothing else
  bool diag = true;
#pragma unroll 1
  for (int i = warp; i < m; i += nw) {
    const float* row = s.Abar + (size_t)i * NC + n;
#pragma unroll 1
    for (int k = lane; k < m; k += 32) {
      const float a = row[k];
      if (k == i) s.sgn[i] = a;
      else diag = diag && a == 0.f;
    }
  }
  v.slack_diag = __syncthreads_and(diag) != 0;
#pragma unroll 1
  for (int i = tid; i < m; i += T) {
    const int bi = s.basis[i];
    if (bi < NP) atomicAdd(&s.basic[bi], 1);
  }
  if (warp == 0) {
#pragma unroll 1
    for (int i = lane; i < m; i += 32)
      s.cbd[i] = cost_b(s, NP, v.phase, s.basis[i]);
    __syncwarp();
    list_cb(s, m);
  }
  v.thr = g.thr[lp];
  v.cnt = K;  // refactor at the first step
  v.set = 0;
  v.binv_fin = false;
  v.have_y = false;
  v.yfin = false;
  for (int k = 0; k < kWorkCounters; ++k)
    v.work[k] = g.work[lp * kWorkCounters + k];
  if constexpr (kTel) {
    if (tid == 0)
      for (int k = 0; k < kTelLanes; ++k)
        tel_slot<true>()[k] = tel[lp * kTelInts + k];
  }
  TSYNC();

  // Each pass: refactor when the eta clock is due (always at the first
  // step), BTRAN, the rest of the step.  Once the LP stops, one more BTRAN
  // under the phase-2 costs gives the extraction's y = c_B Binv.
  int it = 0;
#pragma unroll 1
  for (;;) {
    const bool go = v.status == kRunning && (!kP1 || v.phase == 1) &&
                    v.iters < max_iters && it < steps;
    if (go && v.cnt >= K) {
      TR(kTrRefactor);
      v.binv_fin = refactor<kSmem>(s, m, n);
      v.cnt = 0;
      v.work[kWorkRefactors] += 1;
      tel_add<kTel>(kTelRefactors);
      v.have_y = false;
    }
    if (!go) {
      TR(kTrOther);
      if (v.status == kRunning && (!kP1 || v.phase == 1) &&
          v.iters >= max_iters)
        v.status = kIterationLimit;
      TSYNC();
      if (v.phase != 2 || !v.have_y) {  // y under the phase-2 costs
        if (warp == 0) {
#pragma unroll 1
          for (int i = lane; i < m; i += 32)
            s.cbd[i] = cost_b(s, NP, 2, s.basis[i]);
          __syncwarp();
          list_cb(s, m);
        }
        TSYNC();
        v.have_y = false;
      }
    }
    if (!v.have_y) {
      TR(kTrBtran);
      v.yfin = btran(s, m, v.binv_fin);
      v.have_y = true;
    }
    if (!go) break;
    step<kRule, kSmem, kTel>(s, m, n, tol, v);
    ++it;
  }
  TR(kTrOther);
#pragma unroll 1
  for (int i = tid; i < m; i += T) {
    g.xB[lp * m + i] = s.xB[i];
    g.basis[lp * m + i] = s.basis[i];
    g.y[lp * m + i] = (float)s.yd[i];
  }
#pragma unroll 1
  for (int j = tid; j < n; j += T) g.onub[lp * n + j] = s.onub[j] != 0;
  if (tid == 0) {
    g.phase[lp] = v.phase;
    g.status[lp] = v.status;
    g.iters[lp] = v.iters;
    g.it[lp] = it;
    for (int k = 0; k < kWorkCounters; ++k)
      g.work[lp * kWorkCounters + k] = v.work[k];
    if constexpr (kTel) {
      tel_slot<true>()[kTelEtaLen] = v.cnt;
      for (int k = 0; k < kTelLanes; ++k)
        tel[lp * kTelInts + k] = tel_slot<true>()[k];
    }
  }
  TR_END();
}

template <int kRule, bool kSmem, bool kP1, bool kTel>
cudaError_t launch(const SegmentState& g, int* tel, int B, int m, int n,
                   int steps, int max_iters, float tol, int K, int threads,
                   cudaStream_t stream) {
  auto kernel = revised_segment_kernel<kRule, kSmem, kP1, kTel>;
  const size_t smem = sizeof(float) * layout(m, n, kSmem).words;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, smem, stream>>>(g, m, n, steps, max_iters, tol, K,
                                       tel);
  return cudaGetLastError();
}

template <int kRule, bool kSmem, bool kTel>
cudaError_t dispatch_stage(bool p1, const SegmentState& g, int* tel, int B,
                           int m, int n, int steps, int max_iters, float tol,
                           int K, int threads, cudaStream_t st) {
  if (p1)
    return launch<kRule, kSmem, true, kTel>(g, tel, B, m, n, steps,
                                            max_iters, tol, K, threads, st);
  return launch<kRule, kSmem, false, kTel>(g, tel, B, m, n, steps, max_iters,
                                           tol, K, threads, st);
}

template <int kRule, bool kTel>
cudaError_t dispatch(int variant, bool p1, const SegmentState& g, int* tel,
                     int B, int m, int n, int steps, int max_iters, float tol,
                     int K, int threads, cudaStream_t st) {
  if (variant == kVarShared)
    return dispatch_stage<kRule, true, kTel>(p1, g, tel, B, m, n, steps,
                                             max_iters, tol, K, threads, st);
  return dispatch_stage<kRule, false, kTel>(p1, g, tel, B, m, n, steps,
                                            max_iters, tol, K, threads, st);
}

}  // namespace

// Bytes of dynamic shared memory one block takes, with A, the Gauss-Jordan
// workspace and the scratch in shared memory (ws != 0: the shared variant)
// or in device memory.
extern "C" long long revised_tile_smem_bytes(int m, int n, int ws) {
  return (long long)(sizeof(float) * layout(m, n, ws != 0).words);
}

// Floats of device-memory workspace one LP of the device variant needs:
// the Gauss-Jordan left half and Binv, m x ld each, and the scratch.
extern "C" long long revised_tile_workspace_floats(int m) {
  return (long long)ws_floats(m);
}

// The variant the launcher runs at (m, n) on the current device: 0 shared
// (A and the workspace in shared memory), 1 device, or minus a CUDA error
// code (-1 for a shape no variant takes).  With `tel` not 0, for the
// counter-carrying instantiation, whose counter slot takes kTelInts words
// of the block's shared memory.  The one place that chooses.
extern "C" int revised_tile_variant(int m, int n, int tel) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  if (tel != 0) limit -= (int)sizeof(int) * kTelInts;
  if (revised_tile_smem_bytes(m, n, 1) <= limit) return kVarShared;
  if (revised_tile_smem_bytes(m, n, 0) <= limit) return kVarDevice;
  return -(int)cudaErrorInvalidValue;
}

namespace {

// Validates and launches one segment, the counter-carrying instantiation
// when `tel` is not null (see revised_segment_launch).
int segment_launch(const void* Abar, const void* cvec, const void* ub,
                   const void* thr, void* xB, void* basis, void* onub,
                   void* phase, void* status, void* iters, void* y,
                   void* work, void* it, void* ws, void* tel, int B, int m,
                   int n, int p1, int steps, int max_iters, float tol, int K,
                   int rule, int threads, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (m < 1 || n < 1 || K < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 ||
      (rule != kDantzig && rule != kPartial))
    return cudaErrorInvalidValue;
  const int variant = revised_tile_variant(m, n, tel != nullptr);
  if (variant < 0) return -variant;
  if (variant == kVarDevice && ws == nullptr) return cudaErrorInvalidValue;
  const SegmentState g{
      static_cast<const float*>(Abar), static_cast<const float*>(cvec),
      static_cast<const float*>(ub),   static_cast<const float*>(thr),
      static_cast<float*>(xB),         static_cast<int*>(basis),
      static_cast<bool*>(onub),        static_cast<int*>(phase),
      static_cast<int*>(status),       static_cast<int*>(iters),
      static_cast<float*>(y),          static_cast<int*>(work),
      static_cast<int*>(it),           static_cast<float*>(ws)};
  int* rows = static_cast<int*>(tel);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows != nullptr) {
    if (rule == kDantzig)
      return dispatch<kDantzig, true>(variant, p1 != 0, g, rows, B, m, n,
                                      steps, max_iters, tol, K, threads, st);
    return dispatch<kPartial, true>(variant, p1 != 0, g, rows, B, m, n,
                                    steps, max_iters, tol, K, threads, st);
  }
  if (rule == kDantzig)
    return dispatch<kDantzig, false>(variant, p1 != 0, g, rows, B, m, n,
                                     steps, max_iters, tol, K, threads, st);
  return dispatch<kPartial, false>(variant, p1 != 0, g, rows, B, m, n, steps,
                                   max_iters, tol, K, threads, st);
}

}  // namespace

// Launches one segment block per LP on `stream`; allocates nothing and does
// not synchronise.  Abar (B, m, n+2m), cvec (B, n+m), ub (B, n) and thr (B,)
// are read; xB (B, m), basis (B, m), onub (B, n) bytes, phase, status,
// iters (B,), y (B, m) and work (B, 5) are updated in place; `it` (B,)
// receives the steps each LP took.  `ws` is a float scratch buffer of
// revised_tile_workspace_floats(m) per LP, needed (not null) only for the
// device variant.  `threads` must be a multiple of 32, at most 384.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int revised_segment_launch(
    const void* Abar, const void* cvec, const void* ub, const void* thr,
    void* xB, void* basis, void* onub, void* phase, void* status, void* iters,
    void* y, void* work, void* it, void* ws, int B, int m, int n, int p1,
    int steps, int max_iters, float tol, int K, int rule, int threads,
    void* stream) {
  return segment_launch(Abar, cvec, ub, thr, xB, basis, onub, phase, status,
                        iters, y, work, it, ws, nullptr, B, m, n, p1, steps,
                        max_iters, tol, K, rule, threads, stream);
}

// revised_segment_launch through the counter-carrying instantiation: `tel`
// (B, 16) int32, the packed counter rows of obs.telemetry.tel_to_rows,
// updated in place (lanes 0-8: iterations and pivots by phase, bound
// flips, degenerate pivots, refactorizations, eta length, partial
// pricing's rotations).  The variant is revised_tile_variant(m, n, 1).
extern "C" int revised_segment_tel_launch(
    const void* Abar, const void* cvec, const void* ub, const void* thr,
    void* xB, void* basis, void* onub, void* phase, void* status, void* iters,
    void* y, void* work, void* it, void* ws, void* tel, int B, int m, int n,
    int p1, int steps, int max_iters, float tol, int K, int rule, int threads,
    void* stream) {
  if (tel == nullptr) return cudaErrorInvalidValue;
  return segment_launch(Abar, cvec, ub, thr, xB, basis, onub, phase, status,
                        iters, y, work, it, ws, tel, B, m, n, p1, steps,
                        max_iters, tol, K, rule, threads, stream);
}

#ifdef REVISED_TRACE
// The cycle counters: kTrPhases sums over the blocks, then the count of
// blocks that booked them.
extern "C" int revised_trace_phases() { return kTrPhases; }
extern "C" int revised_trace_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
}
extern "C" int revised_trace_reset() {
  static const unsigned long long zero[kTrPhases + 1] = {};
  return (int)cudaMemcpyToSymbol(g_trace, zero, sizeof(zero));
}
#endif
