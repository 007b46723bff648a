// Batched dense-tableau simplex for Hopper (sm_90a): one thread block per
// LP.  Two kernels share one step body.
//
// `simplex_tile_kernel`, the whole solve, replaces the Pallas TPU kernel
// `_simplex_kernel` of src/repro/kernels/simplex_tile.py (launched by
// `simplex_pallas`).  It computes the same function as the port's plain
// engine (src/repro_torch/core/simplex.py, `solve_two_phase`): loop 1 runs
// the combined two-phase step until the LP leaves phase 1, loop 2 runs
// phase-2 steps (rows <= m), and only x, the objective, status,
// iterations, y and z are written back.
//
// `simplex_segment_kernel`, one resumable segment, replaces the Pallas TPU
// kernel `_segment_kernel` of the same file (launched by `segment_pallas`
// under the compaction scheduler).  It computes the port's plain segment
// (src/repro_torch/core/compaction.py, `run_segment`): state in, at most
// `steps` steps, state out.  Stage p1 steps an LP while it is running, in
// phase 1 and under its cap, on the full (m+2) x (n+2m+1) state; stage p2
// runs phase-2 steps on the compacted (m+1) x (n+m+1) state.  Stage full,
// the counterpart of the reference's `segment_combined`
// (src/repro/core/compaction.py, which the reference runs as XLA), keeps
// the p1 layout and steps an LP while it is running and under its cap,
// through phase 1 and on into phase 2: the frontier scheduler's segments,
// which must take a newcomer in phase 1 in any lane, and the card's warm
// solves.  A block whose LP has nothing to do returns before it loads
// anything.
//
// What bounds it.  A pivot is a rank-1 update of every live tableau entry:
// one load and one store of shared memory each, at 128 bytes an SM-cycle,
// so about 1,280 SM-cycles a pivot at 100 x 100 (102 x 201 entries) and
// about 104 ms for the 21.3 M steps of all 50,000 LPs of lp_100d_50k.  The
// float32 operations bound is lower (about 13 ms): the shared-memory
// traffic, and the latency of the two block reductions a step, set the
// floor.  The device-memory variant moves the tableau through L2 every
// pivot and is bound by those bytes.
//
// What the design does about it:
//  * Live columns only.  The m artificial columns of the phase-1 tableau
//    are never read: pricing scans the n+m structural and slack columns,
//    the ratio test reads column e < n+m and the rhs, extraction the rhs
//    and the objective row's first n+m entries, and an entry's update
//    reads only its own column, column e and row l.  So the whole solve
//    keeps an (m+2) x (n+m+1) tableau, rhs last, and drops them exactly:
//    about 84 KB a block at 100 x 100, two LPs an SM.  Phase 2 works on
//    the same storage, rows <= m.  The row stride is odd, so the ratio
//    test's reads down column e and the rhs meet no bank conflict.
//  * A p1 (or full) segment keeps its state exact with the same storage:
//    each pivot logs its row l, its pivot element after the complement, the
//    complement flag and the entering column (kept where the ratio test
//    wrote it); at the end of the launch, or when the log is full, the
//    logged pivots are replayed in order on the artificial columns (staged
//    through the freed tableau region, or in place for the device
//    variant; each column's rows split among threads when there are 2m of
//    them, one barrier a pivot): the same operations in the same order,
//    so the same bits.
//  * Column-owned updates.  Each thread owns fixed columns for the whole
//    launch: it prices them, computes its own pivot-row value T[l][k] / pe
//    in a register, updates its column down the rows, eight at a time with
//    every load before the first store (the entering column read as float4
//    broadcasts), and, under steepest edge, sums the column's squares in
//    row order as it goes.  No division, modulo or index walk runs in an
//    inner loop, and no other thread reads a column between its owner's
//    update and the next step's first barrier.  The bound of each row's
//    basic variable sits beside the basis, so the ratio test reads it
//    without a dependent lookup.
//  * Two barriers a Dantzig step.  Pricing and the ratio test reduce their
//    candidates with two hardware warp reductions of an order-preserving
//    key (the best key, then the lowest index holding it); each warp's
//    winner (with the optimality vote, or the leaving row's basic
//    variable) goes to a shared slot, one barrier, and every warp reduces
//    the few slots the same way.  Pricing's slots alternate between two
//    banks, so a step that ends right after pricing needs no second
//    barrier.  Devex adds one for its reset vote.
//  * Sized blocks: one thread a live column, rounded to warps and spread
//    over column groups of at most 256 threads (__launch_bounds__ with two
//    blocks an SM: up to 128 registers a thread, as ptxas allots them by
//    warps per SM quarter); afiro's 35 x 32 runs three warps, 100 x 100
//    seven.
//
// A tableau too large for shared memory (sc205_like, lp_300d_2k) stays in
// device memory and runs the same body on the LP's own slice (the live
// columns of the full layout, in place); shared memory then holds vectors
// and the pivot log only.  `simplex_tile_tableau_in_smem` is the one
// place that chooses.
//
// Parity with the reference (every rule holds bit for bit against the
// plain engine):
//  * ties in the argmax/argmin reductions go to the lowest index and NaN
//    beats every number, as jnp.argmax/torch.argmax do (f32 tableaux that
//    blow up, sc205_like, reach NaN weights); the order is total, so any
//    reduction order finds the same winner;
//  * `t - f * p` updates round once (__fmaf_rn), as the reference's CPU
//    build contracts them; other arithmetic uses the _rn intrinsics and the
//    file is built with -fmad=false, never with fast math (the ratio test
//    needs IEEE division);
//  * the pivot row is replaced by the scaled row, not re-added;
//  * bound lookups select, never sum (inf * 0 would poison a sum);
//  * phase 2 pins basic artificials at zero;
//  * the max_iters budget is counted per LP (loops 1 and 2, and every
//    segment, share it);
//  * steepest-edge norms accumulate rows in order, one rounding per term.
//
// Per-LP counters (the telemetry plane, src/repro_torch/obs/telemetry.py).
// The segment kernel has a second instantiation per shape, kTel, that
// carries the int32 counter row of each LP (16 lanes; the float32 row is
// not the simplex's and stays where it is).  Thread 0 loads the lanes it
// owns into a static shared-memory slot at the start, with the LP's
// iteration and work counts; a pivot at a zero minimum ratio books itself
// there; at the end thread 0 adds the segment's iterations, pivots and
// bound flips to the lanes of the LP's phase and stores them, in place.
// Every step of a p1 segment begins in phase 1 and a p2 step never changes
// the phase, so those sums split by phase exactly as the steps would.  A
// block with nothing to do leaves the row as it is.  Registers hold none
// of it, and kTel == false compiles to the kernel without counters.
//
// Built with -DSIMPLEX_TRACE, thread 0 of each block counts clock64()
// cycles by phase into `g_trace` (simplex_trace_read); the main build has
// none of it.

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
constexpr int kMaxThreads = 256;    // block_threads' cap
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
// Pivots a p1 segment logs before it replays them on the artificial
// columns (fewer when the log would not fit).
constexpr int kLogCap = 32;
// Work counters per LP: pivots in phase 1 (full tableau), pivots in phase
// 2 (compacted view) and entering-bound flips.
constexpr int kWorkPivots1 = 0;
constexpr int kWorkPivots2 = 1;
constexpr int kWorkFlips = 2;
constexpr int kWorkCounters = 3;
// Stages (the C exports' `stage`): the whole solve, a p1 segment, a p2
// segment, a full segment (the p1 layout, both phases).
constexpr int kWhole = 0;
constexpr int kSegP1 = 1;
constexpr int kSegP2 = 2;
constexpr int kSegFull = 3;
// The counter row (src/repro_torch/obs/telemetry.py INT_LANES): its width
// and the lanes the simplex books.
constexpr int kTelInts = 16;
constexpr int kTelIters1 = 0;
constexpr int kTelIters2 = 1;
constexpr int kTelPivots1 = 2;
constexpr int kTelPivots2 = 3;
constexpr int kTelFlips = 4;
constexpr int kTelDegenerate = 5;
constexpr int kTelLanes = 6;  // lanes 0..5 are the simplex's
// dead lanes of the slot that keep the LP's counts at the segment's start
constexpr int kTelIters0 = 10;
constexpr int kTelPivots0 = 11;
constexpr int kTelFlips0 = 12;

#ifdef SIMPLEX_TRACE
// Cycle counters (thread 0 of each block, clock64): the phases of a step,
// kept apart for full-tableau (phase-1) and compacted (phase-2) steps,
// then the load, step loop, state store and extraction, then the steps of
// each kind.
enum : int {
  kTrPrice,    // pricing with the optimality vote
  kTrRatio,    // ratio test with the copy of the entering column
  kTrFlip,     // entering-bound flip
  kTrScale,    // pivot-row scaling
  kTrUpdate,   // rank-1 update (steepest edge's sums included)
  kTrWeights,  // weights written, devex's recurrence and reset vote
  kTrBarrier,  // waiting at a block barrier
  kTrReplay,   // a p1 segment's replay on the artificial columns
  kTrStep      // phases a step kind has
};
constexpr int kTrOther = 2 * kTrStep;
constexpr int kTrCounters = kTrOther + 1;
__device__ unsigned long long g_trace[kTrCounters + 3];  // + steps, blocks
__shared__ long long tr_last;
__shared__ int tr_cur;
__shared__ unsigned long long tr_acc[kTrCounters + 2];

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
  for (int k = 0; k < kTrCounters + 2; ++k) tr_acc[k] = 0;
  tr_cur = kTrOther;
  tr_last = clock64();
}
__device__ __forceinline__ void tr_end() {
  if (threadIdx.x != 0) return;
  tr_to(kTrOther);
  for (int k = 0; k < kTrCounters + 2; ++k)
    atomicAdd(&g_trace[k], tr_acc[k]);
  atomicAdd(&g_trace[kTrCounters + 2], 1ull);
}
// A barrier's wait goes to the barrier phase of the step kind it is in.
__device__ __forceinline__ int tr_barrier() {
  if (threadIdx.x != 0) return 0;
  const int cur = tr_cur;
  return tr_to(cur == kTrOther ? kTrOther
                               : (cur / kTrStep) * kTrStep + kTrBarrier);
}
#define TR(ph, full) tr_to((ph) + ((full) ? 0 : kTrStep))
#define TR_OTHER() tr_to(kTrOther)
#define TR_STEP(full)                                                  \
  do {                                                                 \
    if (threadIdx.x == 0) tr_acc[kTrCounters + ((full) ? 0 : 1)] += 1; \
  } while (0)
#define TSYNC()                       \
  do {                                \
    const int tr_was_ = tr_barrier(); \
    __syncthreads();                  \
    tr_to(tr_was_);                   \
  } while (0)
#define TR_BEGIN() tr_begin()
#define TR_END() tr_end()
#else
#define TR(ph, full) ((void)0)
#define TR_OTHER() ((void)0)
#define TR_STEP(full) ((void)0)
#define TSYNC() __syncthreads()
#define TR_BEGIN() ((void)0)
#define TR_END() ((void)0)
#endif

// Rows a stage keeps: m+2 (whole solve, p1, full) or m+1 (p2).
__host__ __device__ inline int stage_rows(int m, int stage) {
  return stage == kSegP2 ? m + 1 : m + 2;
}
// Row stride of the state in device memory: the full layout, or the
// compacted one of a p2 segment.
__host__ __device__ inline int global_cols(int m, int n, int stage) {
  return stage == kSegP2 ? n + m + 1 : n + 2 * m + 1;
}
// Row stride of the tableau in shared memory: the n+m live columns and the
// rhs, made odd so that reads down a column meet no bank conflict.
__host__ __device__ inline int smem_stride(int m, int n) {
  return (n + m + 1) | 1;
}
__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }
// Stages that keep the full state with the live columns on chip and log
// their pivots for the replay on the artificial columns: p1 and full.
__host__ __device__ constexpr bool logs_pivots(int stage) {
  return stage == kSegP1 || stage == kSegFull;
}

// One warp's winner of a reduction, published to the block.
struct __align__(16) Slot {
  unsigned key;  // order_key of the value
  int i;
  int aux;  // pricing: the optimality vote; ratio test: the basic variable
  int pad;
};
// Pricing's two banks and the ratio test's slots, then the devex vote,
// rounded so that the buffers after them stay 16-byte aligned.
constexpr int kSlotWords = (4 * (3 * kMaxWarps) + kMaxWarps + 3) & ~3;

// Where each buffer of one block's dynamic shared memory starts, in 4-byte
// words: the reduction slots, the entering column (the pivot log's
// columns in a p1 or full segment; x's staging at extraction), the log's
// rows, pivot elements and complement flags and the replay's two rows of
// pivot-row values (p1 and full segments), the bound, flip and basis rows,
// the
// bound of each row's basic variable, the weights of a weighted rule and,
// when it fits, the tableau.  The kernels carve their buffers and the
// launchers size the allocation from this one layout.
struct Layout {
  size_t col, log_l, log_pe, log_comp, rv, ub, flip, basis, ubB, w, T, words;
  int rpad;  // floats an entering column takes, rows rounded up to 4
  int cap;   // pivots the log holds (1 outside a p1 or full segment)
};

__host__ __device__ inline Layout layout(int m, int n, int rule, int stage,
                                         bool tableau, int cap) {
  Layout L;
  L.rpad = round4(stage_rows(m, stage));
  L.cap = logs_pivots(stage) ? cap : 1;
  size_t colw = (size_t)L.cap * L.rpad;
  if (stage == kWhole && colw < (size_t)round4(n)) colw = round4(n);
  const size_t logw = logs_pivots(stage) ? (size_t)L.cap : 0;
  L.col = kSlotWords;
  L.log_l = L.col + colw;
  L.log_pe = L.log_l + logw;
  L.log_comp = L.log_pe + logw;
  L.rv = L.log_comp + logw;
  L.ub = L.rv + (logs_pivots(stage) ? 2 * (size_t)m : 0);
  L.flip = L.ub + n;
  L.basis = L.flip + n;
  L.ubB = L.basis + m;
  L.w = L.ubB + m;
  L.T = L.w + (rule != kDantzig ? (size_t)n + m : 0);
  L.words = L.T + (tableau ? (size_t)stage_rows(m, stage) * smem_stride(m, n)
                           : 0);
  return L;
}

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

// A key that orders floats as `wins` does: a larger key wins an argmax, a
// smaller one an argmin, NaN wins both, -0 ties +0.  Equal keys go to the
// lower index, so a warp finds its winner with two hardware reductions.
template <bool kMax>
__device__ __forceinline__ unsigned order_key(float v) {
  if (isnan(v)) return kMax ? 0xffffffffu : 0u;
  const unsigned u = __float_as_uint(v == 0.f ? 0.f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The float a key came from (-0 read as +0, NaN as a NaN).
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The warp's winner, in every lane: the best key, then the lowest index
// holding it.
template <bool kMax>
__device__ __forceinline__ void warp_best(unsigned& key, int& i) {
  const unsigned best = kMax ? __reduce_max_sync(kAll, key)
                             : __reduce_min_sync(kAll, key);
  i = (int)__reduce_min_sync(kAll, key == best ? (unsigned)i : 0xffffffffu);
  key = best;
}

// Lane w's copy of slot w (the reduction's identity in lanes past the
// block's warps), read after the barrier that published the slots.
template <bool kMax>
__device__ __forceinline__ Slot lane_slot(const Slot* slots) {
  const int lane = threadIdx.x & 31;
  if (lane < (int)(blockDim.x >> 5)) return slots[lane];
  return Slot{kMax ? 0u : 0xffffffffu, INT_MAX, 0, 0};
}

// The block's shared buffers and the working tableau.
struct Block {
  float* T;       // row-major, row stride S; column k < n+m at k, rhs at rhs
  int S;
  int rhs;
  float* col;     // this step's entering column (rows), 16-byte aligned
  Slot* price;    // pricing's two banks of kMaxWarps slots
  Slot* ratio;    // the ratio test's slots
  int* vote;      // the devex reset vote, one word a warp
  float* ub;      // n structural bounds (+inf = none)
  int* flip;      // n complement flags
  int* basis;     // m basic columns (full-tableau indices)
  float* ubB;     // m bounds of the basic variables (+inf: none, or slack)
  float* w;       // n+m pricing weights (steepest edge, devex)
};

// The block's buffers in dynamic shared memory, laid out by `L`; the
// tableau is there too when `smem_tableau`, else it is the LP's own slice
// `Tg_lp` of the device-memory state (row stride `gcols`, rhs last).
__device__ inline Block carve(float* smem, const Layout& L, int m, int n,
                              float* Tg_lp, int gcols, bool smem_tableau) {
  Block s;
  s.price = reinterpret_cast<Slot*>(smem);
  s.ratio = s.price + 2 * kMaxWarps;
  s.vote = reinterpret_cast<int*>(s.ratio + kMaxWarps);
  s.col = smem + L.col;
  s.ub = smem + L.ub;
  s.flip = reinterpret_cast<int*>(smem + L.flip);
  s.basis = reinterpret_cast<int*>(smem + L.basis);
  s.ubB = smem + L.ubB;
  s.w = smem + L.w;
  if (smem_tableau) {
    s.T = smem + L.T;
    s.S = smem_stride(m, n);
    s.rhs = n + m;
  } else {
    s.T = Tg_lp;
    s.S = gcols;
    s.rhs = gcols - 1;
  }
  return s;
}

// The pivot log of a p1 or full segment: its entering columns sit in the
// block's
// column region, `rpad` floats apart.
struct PivotLog {
  float* col;
  int* l;
  float* pe;
  int* comp;
  float* rv;  // the replay's pivot-row values, two rows of m
  int rpad;
};

// Rows r..r+K-1 of column tc (row stride S) after a pivot on row l with
// pivot-row value p and entering-column entries c: every row but l is
// t - c * p rounded once, row l is p.  All K loads go out before the
// first store.  Under kSq adds the new values' squares over rows < m to
// acc, in row order, one rounding a term.
template <int K, bool kSq>
__device__ __forceinline__ void update_rows(float* tc, int S, int r,
                                            const float* c, int l, float p,
                                            int m, float& acc) {
  float* t = tc + (size_t)r * S;
  float v[K];
#pragma unroll
  for (int q = 0; q < K; ++q) v[q] = t[(size_t)q * S];
#pragma unroll
  for (int q = 0; q < K; ++q)
    v[q] = r + q == l ? p : __fmaf_rn(-c[q], p, v[q]);
#pragma unroll
  for (int q = 0; q < K; ++q) t[(size_t)q * S] = v[q];
  if (kSq) {
#pragma unroll
    for (int q = 0; q < K; ++q)
      if (r + q < m) acc = __fmaf_rn(v[q], v[q], acc);
  }
}

// Column tc (row stride S, `rows` rows) after a pivot on row l with
// pivot-row value p and entering column `col` (16-byte aligned), rows in
// order, eight at a time; under kSq returns the sum of the new values'
// squares over rows < m, in row order, one rounding a term (steepest
// edge's column norm).
template <bool kSq>
__device__ __forceinline__ float update_column(float* tc, int S, int rows,
                                               const float* col, int l,
                                               float p, int m) {
  float acc = 0.f;
  int r = 0;
  for (; r + 8 <= rows; r += 8) {
    const float4 f0 = *reinterpret_cast<const float4*>(col + r);
    const float4 f1 = *reinterpret_cast<const float4*>(col + r + 4);
    const float c[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
    update_rows<8, kSq>(tc, S, r, c, l, p, m, acc);
  }
  if (r + 4 <= rows) {
    const float4 f = *reinterpret_cast<const float4*>(col + r);
    const float c[4] = {f.x, f.y, f.z, f.w};
    update_rows<4, kSq>(tc, S, r, c, l, p, m, acc);
    r += 4;
  }
  for (; r < rows; ++r) update_rows<1, kSq>(tc, S, r, col + r, l, p, m, acc);
  return acc;
}

// sum_{i<m} tc[i]^2 down a column, rows in order, one rounding a term.
__device__ __forceinline__ float colsum_sq(const float* tc, int S, int m) {
  float acc = 0.f;
  for (int i = 0; i < m; ++i) {
    const float v = tc[(size_t)i * S];
    acc = __fmaf_rn(v, v, acc);
  }
  return acc;
}

// Replays the log's first `npiv` pivots, in order, on the m artificial
// columns A (row stride sa, `rows` rows): per column the pivot-row value
// (negated under the complement) over the pivot element, then the column
// update, as the step applied them to the live columns.  With at least 2m
// threads each column's rows are split into groups of a multiple of four
// rows, one thread a group: the group that holds row l publishes the
// pivot-row value (two rows of values, by pivot parity) and one barrier a
// pivot lets the others read it.  Fewer threads own whole columns and
// need no barrier.  Called by every thread of the block.
__device__ void replay(float* A, int sa, int m, int rows, const PivotLog& g,
                       int npiv) {
  const int tid = threadIdx.x, NT = blockDim.x;
  int groups = NT / m;
  if (groups > rows / 8) groups = rows / 8;
  if (groups < 2) {
    for (int a = tid; a < m; a += NT) {
      float* tc = A + a;
      for (int p = 0; p < npiv; ++p) {
        const int l = g.l[p];
        float v = tc[(size_t)l * sa];
        if (g.comp[p]) v = -v;
        update_column<false>(tc, sa, rows, g.col + (size_t)p * g.rpad, l,
                             __fdiv_rn(v, g.pe[p]), m);
      }
    }
    return;
  }
  const int grp = tid / m, a = tid - grp * m;
  const int span = round4((rows + groups - 1) / groups);
  const int r0 = grp * span;
  const int nr = grp < groups ? min(span, rows - r0) : 0;
  float* tc = A + (size_t)r0 * sa + a;
  for (int p = 0; p < npiv; ++p) {
    const int l = g.l[p] - r0;
    float* rv = g.rv + (p & 1) * m;
    if (l >= 0 && l < nr) {
      float v = tc[(size_t)l * sa];
      if (g.comp[p]) v = -v;
      rv[a] = __fdiv_rn(v, g.pe[p]);
    }
    __syncthreads();
    if (nr > 0)
      update_column<false>(tc, sa, nr, g.col + (size_t)p * g.rpad + r0, l,
                           rv[a], m);
  }
}

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

// One step of the LP's solve.  kFull: the combined two-phase step on rows
// <= m+1 (loop 1, p1 and full segments); otherwise a phase-2 step on rows
// <= m.  Every thread makes the same decisions from block-broadcast values,
// so control flow stays uniform across the block.  The entering column goes
// to s.col; when `lg` is given (a p1 or full segment) a pivot also logs its
// row, pivot element and complement flag at `npiv`.  kTel books a pivot at
// a zero minimum ratio into the counter slot.  kBoth: a kFull step may find
// the LP in phase 2 (a full segment), so a pivot is counted by its phase.
// Returns 1 after a pivot.
template <int kRule, bool kFull, bool kTel = false, bool kBoth = false>
__device__ int step(const Block& s, int m, int n, float tol, float thr,
                    int& phase, int& status, int& iters, int* work,
                    int& bank, const PivotLog* lg, int npiv) {
  const int NP = n + m, ncols = NP + 1;
  const int rows = kFull ? m + 2 : m + 1;
  const int tid = threadIdx.x, NT = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = NT >> 5;
  float* T = s.T;
  const int S = s.S;
  TR_STEP(kFull);
  TR(kTrPrice, kFull);

  // ---- Step 1: entering column, each thread its own columns --------------
  const float* cost = T + (size_t)((kFull && phase == 1) ? m + 1 : m) * S;
  float bv = -INFINITY;
  int bi = INT_MAX;
  int not_opt = 0;  // max reduced cost <= tol fails (NaN included)
  for (int k = tid; k < NP; k += NT) {
    const float d = cost[k];
    not_opt |= !(d <= tol);
    float score = d;
    if (kRule != kDantzig)
      score = d > tol ? __fdiv_rn(__fmul_rn(d, d), s.w[k]) : -kBig;
    if (wins(true, score, k, bv, bi)) {
      bv = score;
      bi = k;
    }
  }
  not_opt = __any_sync(kAll, not_opt);
  unsigned bk = order_key<true>(bv);
  warp_best<true>(bk, bi);
  Slot* P = s.price + bank * kMaxWarps;
  bank ^= 1;
  if (lane == 0) P[warp] = Slot{bk, bi, not_opt, 0};
  TSYNC();
  const Slot ps = lane_slot<true>(P);
  if (!__any_sync(kAll, ps.aux)) {
    // optimal for the current row
    if (kFull && phase == 1) {
      if (T[(size_t)(m + 1) * S + s.rhs] > thr) {
        status = kInfeasible;
      } else {
        phase = 2;
        iters += 1;
      }
    } else {
      status = kOptimal;
    }
    TR_OTHER();
    return 0;
  }
  unsigned pk = ps.key;
  int e = ps.i;
  warp_best<true>(pk, e);
  // read before the ratio test's barrier: e's owner resets it after
  const float w_e = kRule == kDevex ? s.w[e] : 0.f;
  TR(kTrRatio, kFull);

  // ---- Step 2: leaving row, sentinel min-ratio ----------------------------
  float* col = s.col;
  float lv = INFINITY;
  int li = INT_MAX, lbasic = 0;
  for (int i = tid; i < rows; i += NT) {
    const float ce = T[(size_t)i * S + e];
    col[i] = ce;
    if (i < m) {
      const float rhs = T[(size_t)i * S + s.rhs];
      float r = ce > tol ? __fdiv_rn(rhs, ce) : kBig;
      const int b = s.basis[i];
      const float ubb = s.ubB[i];   // ub[b] for a bounded structural b
      if (ce < -tol && isfinite(ubb))
        r = __fdiv_rn(__fsub_rn(ubb, rhs), -ce);
      if (phase == 2 && b >= NP && ce < -tol) r = 0.f;
      if (wins(false, r, i, lv, li)) {
        lv = r;
        li = i;
        lbasic = b;
      }
    }
  }
  unsigned lk = order_key<false>(lv);
  int wi = li;
  const unsigned my_key = lk;
  warp_best<false>(lk, wi);
  // the winning lane (every lane, when the warp has no row) publishes
  if (my_key == lk && li == wi) s.ratio[warp] = Slot{lk, li, lbasic, 0};
  TSYNC();
  const Slot rs = lane_slot<false>(s.ratio);
  unsigned rk = rs.key;
  int l = rs.i;
  warp_best<false>(rk, l);
  const int jl =
      __shfl_sync(kAll, rs.aux, __ffs(__ballot_sync(kAll, rs.i == l)) - 1);
  const float min_ratio = key_value(rk);  // only compared: -0 reads as +0

  // ---- Step 3a: entering-bound flip (the owners of e and of the rhs) ------
  const float ub_e = e < n ? s.ub[e] : INFINITY;
  if (ub_e < min_ratio) {
    TR(kTrFlip, kFull);
    for (int k = tid; k < ncols; k += NT) {
      if (k == NP) {
        float* tc = T + s.rhs;
        for (int i = 0; i < rows; ++i)
          tc[(size_t)i * S] = __fmaf_rn(-ub_e, col[i], tc[(size_t)i * S]);
      } else if (k == e) {
        float* tc = T + e;
        for (int i = 0; i < rows; ++i) tc[(size_t)i * S] = -tc[(size_t)i * S];
      }
    }
    if (tid == 0) s.flip[e] ^= 1;
    work[kWorkFlips] += 1;
    iters += 1;
    TR_OTHER();
    return 0;
  }
  if (min_ratio >= kHalfBig) {  // no bounding row
    status = phase == 2 ? kUnbounded : kIterationLimit;
    iters += 1;
    TR_OTHER();
    return 0;
  }

  // ---- Step 3b: pivot (leaving-at-upper complement folded into the row) --
  // booked before the update, so min_ratio need not live through it
  if (min_ratio <= 0.f) tel_add<kTel>(kTelDegenerate);
  float pe = col[l];
  const bool comp = pe < 0.f && jl < n;
  const float ub_jl = comp ? s.ub[jl] : 0.f;
  if (comp) pe = -pe;
  const float w_leave =
      kRule == kDevex ? max_nan(__fdiv_rn(w_e, __fmul_rn(pe, pe)), 1.f) : 0.f;
  int over = 0, has_nan = 0;
  for (int k = tid; k < ncols; k += NT) {
    TR(kTrScale, kFull);
    const int j = k < NP ? k : s.rhs;
    float* tc = T + j;
    float v = tc[(size_t)l * S];
    if (comp) {
      v = -v;
      if (k == NP) v = __fadd_rn(v, ub_jl);
      if (j == jl) v = 1.f;
    }
    const float p = __fdiv_rn(v, pe);
    TR(kTrUpdate, kFull);
    const float sq = update_column<kRule == kSteepestEdge>(tc, S, rows, col,
                                                           l, p, m);
    TR(kTrWeights, kFull);
    if (k < NP) {
      if (kRule == kSteepestEdge) {
        s.w[k] = __fadd_rn(1.f, sq);
      } else if (kRule == kDevex) {
        float wk;
        if (k == e)
          wk = 1.f;
        else if (k == jl)
          wk = w_leave;
        else
          wk = max_nan(s.w[k], __fmul_rn(__fmul_rn(p, p), w_e));
        s.w[k] = wk;
        over |= wk > kDevexReset;
        has_nan |= isnan(wk);
      }
    }
  }
  if (kRule == kDevex) {
    // reset when max(w) > DEVEX_RESET; a NaN max compares false
    TR(kTrWeights, kFull);
    const int vote = __any_sync(kAll, over) | (__any_sync(kAll, has_nan) << 1);
    if (lane == 0) s.vote[warp] = vote;
    TSYNC();
    const int v = lane < nwarps ? s.vote[lane] : 0;
    if (__any_sync(kAll, v & 1) && !__any_sync(kAll, v & 2))
      for (int k = tid; k < NP; k += NT) s.w[k] = 1.f;
  }
  if (tid == 0) {
    s.basis[l] = e;
    s.ubB[l] = e < n ? s.ub[e] : INFINITY;
    if (comp) s.flip[jl] ^= 1;
    if (lg != nullptr) {
      lg->l[npiv] = l;
      lg->pe[npiv] = pe;
      lg->comp[npiv] = comp;
    }
  }
  // constant indices only: a computed one would put `work` on the stack
  if (kBoth && phase != 1)
    work[kWorkPivots2] += 1;
  else
    work[kFull ? kWorkPivots1 : kWorkPivots2] += 1;
  iters += 1;
  TR_OTHER();
  return 1;
}

// Copies the live columns of `rows` rows between the device-memory state
// (row stride gcols, rhs last) and the on-chip tableau (row stride S),
// each thread its own columns, as the steps own them; `to_smem` picks the
// direction.
__device__ void copy_live(float* Ts, int S, float* Tg, int gcols, int m,
                          int n, int rows, bool to_smem) {
  const int NP = n + m;
  for (int k = threadIdx.x; k <= NP; k += blockDim.x) {
    float* ts = Ts + k;
    float* tg = Tg + (k < NP ? k : gcols - 1);
    for (int r = 0; r < rows; ++r) {
      if (to_smem)
        ts[(size_t)r * S] = tg[(size_t)r * gcols];
      else
        tg[(size_t)r * gcols] = ts[(size_t)r * S];
    }
  }
}

template <int kRule, bool kSmemTableau>
__global__ void __launch_bounds__(kMaxThreads, 2)
    simplex_tile_kernel(float* __restrict__ Tg, const int* __restrict__ basis0,
                        const int* __restrict__ phase0,
                        const float* __restrict__ thr0,
                        const float* __restrict__ ubg, float* __restrict__ x_out,
                        float* __restrict__ obj_out, int* __restrict__ status_out,
                        int* __restrict__ iters_out, float* __restrict__ y_out,
                        float* __restrict__ z_out, int* __restrict__ work_out,
                        int m, int n, int max_iters, float tol) {
  extern __shared__ __align__(16) float smem[];
  TR_BEGIN();
  const int R = m + 2, C = n + 2 * m + 1, NP = n + m;
  const int tid = threadIdx.x, NT = blockDim.x;
  const size_t lp = blockIdx.x;

  float* Tg_lp = Tg + lp * (size_t)R * C;
  const Block s = carve(smem, layout(m, n, kRule, kWhole, kSmemTableau, 1), m,
                        n, Tg_lp, C, kSmemTableau);

  if (kSmemTableau) copy_live(s.T, s.S, Tg_lp, C, m, n, R, true);
  for (int j = tid; j < n; j += NT) {
    s.ub[j] = ubg[lp * n + j];
    s.flip[j] = 0;
  }
  for (int i = tid; i < m; i += NT) {
    const int b = basis0[lp * m + i];
    s.basis[i] = b;
    s.ubB[i] = b < n ? ubg[lp * n + b] : INFINITY;
  }
  int phase = phase0[lp];
  const float thr = thr0[lp];
  int status = kRunning, iters = 0, bank = 0;
  int work[kWorkCounters] = {0, 0, 0};
  __syncthreads();
  // each thread's weights are its own columns'
  if (kRule == kSteepestEdge)
    for (int k = tid; k < NP; k += NT)
      s.w[k] = __fadd_rn(1.f, colsum_sq(s.T + k, s.S, m));
  if (kRule == kDevex)
    for (int k = tid; k < NP; k += NT) s.w[k] = 1.f;

  while (status == kRunning && phase == 1 && iters < max_iters)
    step<kRule, true>(s, m, n, tol, thr, phase, status, iters, work, bank,
                      nullptr, 0);
  if (status == kRunning && phase == 1) status = kIterationLimit;
  while (status == kRunning && iters < max_iters)
    step<kRule, false>(s, m, n, tol, thr, phase, status, iters, work, bank,
                       nullptr, 0);
  if (status == kRunning) status = kIterationLimit;
  __syncthreads();

  // ---- extraction: x staged in the column buffer, duals off row m -------
  float* xs = s.col;
  for (int j = tid; j < n; j += NT) xs[j] = 0.f;
  __syncthreads();
  for (int i = tid; i < m; i += NT) {
    const int bi = s.basis[i];
    if (bi < n) xs[bi] = s.T[(size_t)i * s.S + s.rhs];
  }
  __syncthreads();
  const bool opt = status == kOptimal;
  const float nan = __int_as_float(0x7fc00000);
  const float* obj_row = s.T + (size_t)m * s.S;
  for (int j = tid; j < n; j += NT) {
    const float xv = xs[j];
    x_out[lp * n + j] = s.flip[j] ? __fsub_rn(s.ub[j], xv) : xv;
    const float zv = obj_row[j];
    z_out[lp * n + j] = opt ? (s.flip[j] ? -zv : zv) : nan;
  }
  for (int i = tid; i < m; i += NT)
    y_out[lp * m + i] = opt ? -obj_row[n + i] : nan;
  if (tid == 0) {
    obj_out[lp] = opt ? -obj_row[s.rhs] : nan;
    status_out[lp] = status;
    iters_out[lp] = iters;
    if (work_out != nullptr)
      for (int k = 0; k < kWorkCounters; ++k)
        work_out[lp * kWorkCounters + k] = work[k];
  }
  TR_END();
}

template <int kRule, bool kSmemTableau>
cudaError_t launch(float* T, const int* basis, const int* phase,
                   const float* thr, const float* ub, float* x, float* obj,
                   int* status, int* iters, float* y, float* z, int* work,
                   int B, int m, int n, int max_iters, float tol, int threads,
                   cudaStream_t stream) {
  auto kernel = simplex_tile_kernel<kRule, kSmemTableau>;
  const size_t smem =
      sizeof(float) * layout(m, n, kRule, kWhole, kSmemTableau, 1).words;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, smem, stream>>>(T, basis, phase, thr, ub, x, obj,
                                       status, iters, y, z, work, m, n,
                                       max_iters, tol);
  return cudaGetLastError();
}

// The state a segment reads and writes, one row per LP (see
// src/repro_torch/core/compaction.py, `CompactionState`).  T is the stage's
// tableau, row stride n+2m+1 (p1) or n+m+1 (p2); w holds the n+m priceable
// weights (unread under dantzig); flip is one byte per structural column.
// ub and thr are read-only; `it` receives the steps each LP took.
struct SegmentState {
  float* T;
  int* basis;
  float* w;
  bool* flip;
  const float* ub;
  int* phase;
  const float* thr;
  int* status;
  int* iters;
  int* work;
  int* it;
};

// One segment: at most `steps` steps of stage p1 (kStage == kSegP1), p2 or
// full per LP.  An LP steps while it is running, under its cap and, in p1,
// in phase 1; one still running at its cap afterwards (in p1: in phase 1)
// is marked at the iteration limit, as after the whole-solve kernel's
// loops.  A p1 or full segment runs in rounds of at most `cap` pivots, each
// ended by the replay of its pivots on the artificial columns.  kTel
// carries the counter rows `tel`, kTelInts int32 an LP, updated in place
// (the last parameter, so that the counter-free instantiation reads every
// other one where it did before the plane); stage full has none.
template <int kRule, bool kSmemTableau, int kStage, bool kTel = false>
__global__ void __launch_bounds__(kMaxThreads, 2)
    simplex_segment_kernel(SegmentState g, int m, int n, int steps,
                           int max_iters, float tol, int cap, int* tel) {
  static_assert(!(kTel && kStage == kSegFull),
                "a full segment carries no counters");
  // kFull: the full state, live columns on chip and the pivot log (p1,
  // full); kP1: an LP steps only in phase 1
  constexpr bool kFull = logs_pivots(kStage);
  constexpr bool kP1 = kStage == kSegP1;
  const int R = stage_rows(m, kStage), C = global_cols(m, n, kStage);
  const int NP = n + m;
  const int tid = threadIdx.x, NT = blockDim.x;
  const size_t lp = blockIdx.x;
  int phase = g.phase[lp], status = g.status[lp], iters = g.iters[lp];
  const bool stage_ok = !kP1 || phase == 1;
  if (!(status == kRunning && stage_ok && iters < max_iters && steps > 0)) {
    // nothing to do: the tableau is never loaded
    if (tid == 0) {
      g.it[lp] = 0;
      if (status == kRunning && stage_ok && iters >= max_iters)
        g.status[lp] = kIterationLimit;
    }
    return;
  }

  extern __shared__ __align__(16) float smem[];
  TR_BEGIN();
  float* Tg_lp = g.T + lp * (size_t)R * C;
  const Layout L = layout(m, n, kRule, kStage, kSmemTableau, cap);
  Block s = carve(smem, L, m, n, Tg_lp, C, kSmemTableau);
  const PivotLog lg{smem + L.col, reinterpret_cast<int*>(smem + L.log_l),
                    smem + L.log_pe, reinterpret_cast<int*>(smem + L.log_comp),
                    smem + L.rv, L.rpad};
  if (kSmemTableau) copy_live(s.T, s.S, Tg_lp, C, m, n, R, true);
  for (int j = tid; j < n; j += NT) {
    s.ub[j] = g.ub[lp * n + j];
    s.flip[j] = g.flip[lp * n + j];
  }
  for (int i = tid; i < m; i += NT) {
    const int b = g.basis[lp * m + i];
    s.basis[i] = b;
    s.ubB[i] = b < n ? g.ub[lp * n + b] : INFINITY;
  }
  if (kRule != kDantzig)
    for (int k = tid; k < NP; k += NT) s.w[k] = g.w[lp * NP + k];
  const float thr = kFull ? g.thr[lp] : 0.f;
  int work[kWorkCounters];
  for (int k = 0; k < kWorkCounters; ++k)
    work[k] = g.work[lp * kWorkCounters + k];
  if constexpr (kTel) {
    if (tid == 0) {
      int* slot = tel_slot<true>();
      for (int k = 0; k < kTelLanes; ++k) slot[k] = tel[lp * kTelInts + k];
      slot[kTelIters0] = iters;
      slot[kTelPivots0] = work[kWorkPivots1] + work[kWorkPivots2];
      slot[kTelFlips0] = work[kWorkFlips];
    }
  }
  int bank = 0;
  __syncthreads();

  int it = 0;
  bool stored = false;  // the device-memory state holds the live columns
  for (;;) {
    int npiv = 0;
    while (status == kRunning && (!kP1 || phase == 1) &&
           iters < max_iters && it < steps && (!kFull || npiv < L.cap)) {
      if (kFull) s.col = lg.col + (size_t)npiv * L.rpad;
      npiv += step<kRule, kFull, kTel, kStage == kSegFull>(
          s, m, n, tol, thr, phase, status, iters, work, bank,
          kFull ? &lg : nullptr, npiv);
      ++it;
    }
    __syncthreads();
    if (!kFull || npiv == 0) break;  // the loop stopped for the LP's sake
    const bool more = status == kRunning && (!kP1 || phase == 1) &&
                      iters < max_iters && it < steps;
    // ---- the round's pivots on the artificial columns --------------------
    TR(kTrReplay, true);
    if (kSmemTableau) {
      // the live columns go home; their region stages the artificial ones
      copy_live(s.T, s.S, Tg_lp, C, m, n, R, false);
      __syncthreads();
      for (int a = tid; a < m; a += NT)
        for (int r = 0; r < R; ++r)
          s.T[(size_t)r * m + a] = Tg_lp[(size_t)r * C + NP + a];
      __syncthreads();
      replay(s.T, m, m, R, lg, npiv);
      __syncthreads();
      for (int a = tid; a < m; a += NT)
        for (int r = 0; r < R; ++r)
          Tg_lp[(size_t)r * C + NP + a] = s.T[(size_t)r * m + a];
      stored = true;
      if (more) {
        __syncthreads();
        copy_live(s.T, s.S, Tg_lp, C, m, n, R, true);
        stored = false;
      }
    } else {
      replay(Tg_lp + NP, C, m, R, lg, npiv);
    }
    __syncthreads();
    TR_OTHER();
    if (!more) break;
  }
  if (status == kRunning && (!kP1 || phase == 1) && iters >= max_iters)
    status = kIterationLimit;

  if (kSmemTableau && !stored) copy_live(s.T, s.S, Tg_lp, C, m, n, R, false);
  for (int j = tid; j < n; j += NT) g.flip[lp * n + j] = s.flip[j] != 0;
  for (int i = tid; i < m; i += NT) g.basis[lp * m + i] = s.basis[i];
  if (kRule != kDantzig)
    for (int k = tid; k < NP; k += NT) g.w[lp * NP + k] = s.w[k];
  if (tid == 0) {
    g.phase[lp] = phase;
    g.status[lp] = status;
    g.iters[lp] = iters;
    g.it[lp] = it;
    for (int k = 0; k < kWorkCounters; ++k)
      g.work[lp * kWorkCounters + k] = work[k];
    if constexpr (kTel) {
      int* slot = tel_slot<true>();
      const bool p1 = kFull || phase == 1;
      slot[p1 ? kTelIters1 : kTelIters2] += iters - slot[kTelIters0];
      slot[p1 ? kTelPivots1 : kTelPivots2] +=
          work[kWorkPivots1] + work[kWorkPivots2] - slot[kTelPivots0];
      slot[kTelFlips] += work[kWorkFlips] - slot[kTelFlips0];
      for (int k = 0; k < kTelLanes; ++k) tel[lp * kTelInts + k] = slot[k];
    }
  }
  TR_END();
}

template <int kRule, bool kSmemTableau, int kStage, bool kTel>
cudaError_t launch_segment(const SegmentState& g, int* tel, int B, int m,
                           int n, int steps, int max_iters, float tol,
                           int cap, int threads, cudaStream_t stream) {
  auto kernel = simplex_segment_kernel<kRule, kSmemTableau, kStage, kTel>;
  const size_t smem =
      sizeof(float) * layout(m, n, kRule, kStage, kSmemTableau, cap).words;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, smem, stream>>>(g, m, n, steps, max_iters, tol, cap,
                                       tel);
  return cudaGetLastError();
}

template <int kRule, int kStage, bool kTel>
cudaError_t dispatch_segment(bool in_smem, const SegmentState& g, int* tel,
                             int B, int m, int n, int steps, int max_iters,
                             float tol, int cap, int threads,
                             cudaStream_t stream) {
  if (in_smem)
    return launch_segment<kRule, true, kStage, kTel>(
        g, tel, B, m, n, steps, max_iters, tol, cap, threads, stream);
  return launch_segment<kRule, false, kStage, kTel>(
      g, tel, B, m, n, steps, max_iters, tol, cap, threads, stream);
}

template <int kRule, bool kTel>
cudaError_t dispatch_segment(int stage, bool in_smem, const SegmentState& g,
                             int* tel, int B, int m, int n, int steps,
                             int max_iters, float tol, int cap, int threads,
                             cudaStream_t stream) {
  if (stage == kSegP1)
    return dispatch_segment<kRule, kSegP1, kTel>(in_smem, g, tel, B, m, n,
                                                 steps, max_iters, tol, cap,
                                                 threads, stream);
  if constexpr (!kTel) {
    if (stage == kSegFull)
      return dispatch_segment<kRule, kSegFull, false>(
          in_smem, g, tel, B, m, n, steps, max_iters, tol, cap, threads,
          stream);
  }
  return dispatch_segment<kRule, kSegP2, kTel>(in_smem, g, tel, B, m, n,
                                               steps, max_iters, tol, cap,
                                               threads, stream);
}

// The shared memory a block may opt into on the current device, or minus a
// CUDA error code.
int optin_limit() {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? limit : -(int)err;
}

}  // namespace

// Bytes of dynamic shared memory one block takes, with the tableau in
// shared memory (tableau != 0) or left in device memory, for `stage` 0
// (the whole solve), 1 or 3 (a p1 or full segment, its pivot log full size)
// or 2 (a p2 segment).
extern "C" long long simplex_tile_smem_bytes(int m, int n, int rule,
                                             int tableau, int stage) {
  return (long long)(sizeof(float) *
                     layout(m, n, rule, stage, tableau != 0, kLogCap).words);
}

// Whether the launchers keep that stage's tableau in shared memory on the
// current device: 1 or 0, or minus a CUDA error code.
extern "C" int simplex_tile_tableau_in_smem(int m, int n, int rule,
                                            int stage) {
  const int limit = optin_limit();
  if (limit < 0) return limit;
  return simplex_tile_smem_bytes(m, n, rule, 1, stage) <= limit;
}

// Launches one block per LP on `stream`; allocates nothing and does not
// synchronise.  The tableau's live columns stay in shared memory when they
// fit on the current device; otherwise they are updated in place in T
// (B, m+2, n+2m+1), whose artificial columns go stale.  `work` (B, 3),
// when not null, receives each LP's phase-1 pivots, phase-2 pivots and
// bound flips.  Returns the CUDA error code of the launch (0 on success).
extern "C" int simplex_tile_launch(void* T, const void* basis,
                                   const void* phase, const void* thr,
                                   const void* ub, void* x, void* obj,
                                   void* status, void* iters, void* y, void* z,
                                   void* work, int B, int m, int n,
                                   int max_iters, float tol, int rule,
                                   int threads, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (m < 1 || n < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 || rule < kDantzig || rule > kDevex)
    return cudaErrorInvalidValue;
  const int in_smem = simplex_tile_tableau_in_smem(m, n, rule, kWhole);
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

namespace {

// Validates and launches one segment, the counter-carrying instantiation
// when `tel` is not null (see simplex_segment_launch).
int segment_launch(void* T, void* basis, void* w, void* flip, const void* ub,
                   void* phase, const void* thr, void* status, void* iters,
                   void* work, void* it, void* tel, int B, int m, int n,
                   int stage, int steps, int max_iters, float tol, int rule,
                   int threads, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (m < 1 || n < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 || rule < kDantzig || rule > kDevex ||
      (stage != kSegP1 && stage != kSegP2 && stage != kSegFull) ||
      (stage == kSegFull && tel != nullptr))
    return cudaErrorInvalidValue;
  int limit = optin_limit();
  if (limit < 0) return -limit;
  // the counter slot's static shared memory comes out of the same budget
  if (tel != nullptr) limit -= (int)(sizeof(int) * kTelInts);
  const int in_smem = simplex_tile_smem_bytes(m, n, rule, 1, stage) <= limit;
  // a round's pivots; fewer when the log would not fit beside a large
  // LP's vectors
  int cap = steps < 1 ? 1 : (steps < kLogCap ? steps : kLogCap);
  while (cap > 1 && sizeof(float) * layout(m, n, rule, stage, in_smem != 0,
                                           cap).words > (size_t)limit)
    cap >>= 1;
  const SegmentState g{static_cast<float*>(T),       static_cast<int*>(basis),
                       static_cast<float*>(w),       static_cast<bool*>(flip),
                       static_cast<const float*>(ub), static_cast<int*>(phase),
                       static_cast<const float*>(thr), static_cast<int*>(status),
                       static_cast<int*>(iters),     static_cast<int*>(work),
                       static_cast<int*>(it)};
  int* rows = static_cast<int*>(tel);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SIMPLEX_SEGMENT_DISPATCH(RULE, TEL)                                  \
  return dispatch_segment<RULE, TEL>(stage, in_smem != 0, g, rows, B, m, n, \
                                     steps, max_iters, tol, cap, threads,    \
                                     st)
  if (tel != nullptr) {
    if (rule == kDantzig) SIMPLEX_SEGMENT_DISPATCH(kDantzig, true);
    if (rule == kSteepestEdge) SIMPLEX_SEGMENT_DISPATCH(kSteepestEdge, true);
    SIMPLEX_SEGMENT_DISPATCH(kDevex, true);
  }
  if (rule == kDantzig) SIMPLEX_SEGMENT_DISPATCH(kDantzig, false);
  if (rule == kSteepestEdge) SIMPLEX_SEGMENT_DISPATCH(kSteepestEdge, false);
  SIMPLEX_SEGMENT_DISPATCH(kDevex, false);
#undef SIMPLEX_SEGMENT_DISPATCH
}

}  // namespace

// Launches one segment block per LP on `stream`; allocates nothing and does
// not synchronise.  `stage` 1 (p1) and 3 (full) work on T (B, m+2,
// n+2m+1), stage 2 (p2) on T (B, m+1, n+m+1); every state array is updated
// in place: T, basis
// (B, m), w (B, n+m; unread under dantzig), flip (B, n) bytes, phase,
// status, iters (B,), work (B, 3); ub (B, n) and thr (B,) are read; `it`
// (B,) receives the steps each LP took.  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int simplex_segment_launch(void* T, void* basis, void* w,
                                      void* flip, const void* ub, void* phase,
                                      const void* thr, void* status,
                                      void* iters, void* work, void* it,
                                      int B, int m, int n, int stage,
                                      int steps, int max_iters, float tol,
                                      int rule, int threads, void* stream) {
  return segment_launch(T, basis, w, flip, ub, phase, thr, status, iters,
                        work, it, nullptr, B, m, n, stage, steps, max_iters,
                        tol, rule, threads, stream);
}

// simplex_segment_launch through the counter-carrying instantiation: `tel`
// (B, 16) int32, the packed counter rows of obs.telemetry.tel_to_rows,
// updated in place (lanes 0-5: iterations and pivots by phase, bound
// flips, degenerate pivots); stages 1 and 2 only.
extern "C" int simplex_segment_tel_launch(void* T, void* basis, void* w,
                                          void* flip, const void* ub,
                                          void* phase, const void* thr,
                                          void* status, void* iters,
                                          void* work, void* it, void* tel,
                                          int B, int m, int n, int stage,
                                          int steps, int max_iters, float tol,
                                          int rule, int threads,
                                          void* stream) {
  if (tel == nullptr) return cudaErrorInvalidValue;
  return segment_launch(T, basis, w, flip, ub, phase, thr, status, iters,
                        work, it, tel, B, m, n, stage, steps, max_iters, tol,
                        rule, threads, stream);
}

#ifdef SIMPLEX_TRACE
// The cycle counters: kTrCounters sums over the blocks (the step phases of
// full-tableau steps, of compacted steps, then the rest), the steps of each
// kind, then the count of blocks that booked them.
extern "C" int simplex_trace_phases() { return kTrStep; }
extern "C" int simplex_trace_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
}
extern "C" int simplex_trace_reset() {
  static const unsigned long long zero[kTrCounters + 3] = {};
  return (int)cudaMemcpyToSymbol(g_trace, zero, sizeof(zero));
}
#endif
