"""§Perf analysis for the paper-representative workload: batched LP solving.

A copy of ``repro.analysis.lp_perf`` on the port's own modules (NumPy
arithmetic, so every model returns the reference's numbers exactly); the
port imports nothing of the reference.

Quantifies the three-level termination story with measured pivot-count
distributions, and the residency argument for a kernel that keeps the
tableau on chip (the reference's Pallas kernel in VMEM, the port's CUDA
kernels in shared memory):

1. lockstep waste        — a global while-loop executes max(pivots) for every
                           LP; waste = 1 - mean/max.
2. per-shard termination — shard_map's per-chip loops each stop at their own
                           max; expected executed pivots = mean over shards
                           of shard-max.
3. per-tile early exit   — the Pallas kernel's grid tiles stop independently.
4. sorted batching       — difficulty-sorted chunks tighten each chunk's max
                           (beyond-paper optimization in core/batching.py).
5. HBM-traffic model     — pure-XLA lockstep re-reads the tableau from HBM
                           every pivot (while-loop carry); the VMEM-resident
                           kernel touches HBM once per solve: traffic ratio
                           ~= pivots executed.
6. work elimination      — executed *tableau-element updates* before/after
                           the two-level engine: phase-compacted tableaux
                           (core/simplex.py) shrink the per-pivot update;
                           the active-set compaction scheduler
                           (core/compaction.py) shrinks the batch as LPs
                           retire.  `element_updates_*` below are the
                           closed-form models; benchmarks/pivot_work.py
                           cross-checks them against measured SegmentStats.
7. pricing rules         — every model above is per-rule: ``pricing=``
                           replays the workload under dantzig /
                           steepest_edge / devex pivot selection
                           (core/pricing.py), so the work models quantify
                           how fewer pivots multiply against both
                           compaction levels (`compare_pricing`).
8. revised simplex       — flops-per-pivot model for the basis-factor
                           backend (core/revised.py): BTRAN/FTRAN
                           triangular+eta solves O(m^2), pricing O(m*C),
                           amortized LU refactorization — vs the tableau's
                           O(m*(n+2m)) rank-1 update.  `revised_crossover`
                           locates the n/m frontier where the revised
                           backend wins on *flops*; on element *updates*
                           (state written per pivot, `revised_elements`)
                           it wins everywhere because the (m, n+2m) data
                           block is immutable.
9. canonical shapes      — general-form problems (core/forms.py) are solved
                           at their *canonical* shape: equalities grow m,
                           free variables grow n, presolve shrinks both.
                           `canonical_work` re-evaluates every per-pivot
                           model at the canonical (m, n) — the
                           revised-vs-tableau crossover must be judged
                           there, not at the original shape (a
                           square-looking Netlib instance with many
                           equalities canonicalizes tall, which is
                           tableau-hostile).  Finite upper bounds are
                           handled *natively* by the bounded ratio test
                           (no rows); `canonical_work` also reports the
                           counterfactual ``bound_rows=True`` shape and
                           the element/flops ratio the row encoding would
                           have cost — the tentpole's "stop paying for
                           upper-bound rows" number.
10. sparsity             — shared-pattern sparse batches (core/sparse.py)
                           replace the PDHG matvecs' 2mn flops with 2nnz:
                           `sparse_matvec_flops` / `sparse_pdhg_iteration_
                           flops` are the density-aware twins of the dense
                           models, and `sparse_pdhg_speedup` is the
                           dense/sparse flops ratio (~1/density for
                           matvec-dominated shapes) that
                           benchmarks/pivot_work.py cross-checks against
                           measured element counts.

  PYTHONPATH=src python -m repro_torch.analysis.lp_perf
"""
from __future__ import annotations

import numpy as np

from ..core.compaction import next_bucket
from ..core.lp import LPBatch
from ..core.pricing import PRICING_RULES, partial_priced_candidates
from ..core.reference import (random_lp_batch,
                              solve_batched_reference_detailed)
from ..core.revised import auto_refactor_period, revised_elements  # noqa: F401  (re-export: the element-update side of the model)
from ..core.simplex import flops_per_pivot, tableau_elements
from ..obs.work import element_updates_lockstep  # noqa: F401  (re-export: the shared lockstep accounting)


def executed_pivots(iters: np.ndarray, group: int) -> float:
    """Total device pivots when termination granularity = `group` LPs."""
    n = len(iters)
    pad = (-n) % group
    arr = np.concatenate([iters, np.zeros(pad, iters.dtype)])
    return float(arr.reshape(-1, group).max(axis=1).sum() * group)


def element_updates_phase_compacted(p1_iters: np.ndarray, iters: np.ndarray,
                                    m: int, n: int) -> float:
    """Level 1 only (monolithic two-loop solve): full-tableau steps until the
    last LP leaves phase 1, compacted-tableau steps for the rest."""
    B = len(iters)
    s1 = int(p1_iters.max())
    s2 = int(np.maximum(iters - p1_iters, 0).max()) + 1
    return float(s1 * B * tableau_elements(m, n)
                 + s2 * B * tableau_elements(m, n, compacted=True))


class _ScheduleSim:
    """Host-side replay of core.compaction.run_schedule's executed-work
    accounting: same segment quantization, same power-of-two bucket ladder,
    with bucket membership carried across stages (the real scheduler never
    re-expands the bucket at the stage-1 -> stage-2 transition)."""

    def __init__(self, B: int, segment_k: int, compact_threshold: float,
                 pad_multiple: int):
        self.segment_k = segment_k
        self.compact_threshold = compact_threshold
        self.pad_multiple = pad_multiple
        self.in_bucket = np.ones(B, bool)
        self.bucket = B
        self.elems = 0.0

    def run_stage(self, length: np.ndarray, retire_at: np.ndarray,
                  per: int) -> int:
        """``length[i]``: stage-local steps until LP i stops being *pending*
        (its loop-exit condition); ``retire_at[i]``: steps until it stops
        counting as RUNNING for bucket sizing (length <= retire_at).
        Returns the stage's executed lockstep steps."""
        done = 0
        while True:
            pending = self.in_bucket & (length > done)
            if not pending.any():
                return done
            step = min(self.segment_k, int(length[pending].max()) - done)
            self.elems += step * self.bucket * per
            done += step
            running = self.in_bucket & (retire_at > done)
            n_run = int(running.sum())
            if n_run == 0:
                continue  # next pending check ends the stage
            new_bucket = next_bucket(n_run, self.pad_multiple)
            if new_bucket < self.bucket \
                    and n_run < self.compact_threshold * self.bucket:
                self.in_bucket = running
                self.bucket = new_bucket


def element_updates_scheduled(p1_iters: np.ndarray, iters: np.ndarray,
                              m: int, n: int, segment_k: int = 8,
                              compact_threshold: float = 0.5,
                              pad_multiple: int = 1) -> float:
    """Both levels: simulate the segment/bucket ladder of
    core.compaction.run_schedule over the measured per-LP pivot counts —
    no device needed."""
    p1 = p1_iters.astype(np.int64)
    total = iters.astype(np.int64)
    sim = _ScheduleSim(len(total), segment_k, compact_threshold, pad_multiple)
    # stage 1 (full tableau): an LP is pending until it leaves phase 1 and
    # RUNNING until its whole solve terminates (total pivots + final check);
    # meanwhile the combined step also advances its phase-2 pivots.
    s1 = sim.run_stage(length=p1, retire_at=total + 1,
                       per=tableau_elements(m, n))
    # stage 2 (compacted tableau): only pivots not already executed during
    # stage 1 remain, plus the terminal check; LPs finished in stage 1 are 0.
    rem = np.where(total + 1 <= s1, 0, np.maximum(total - s1, 0) + 1)
    sim.run_stage(length=rem, retire_at=rem,
                  per=tableau_elements(m, n, compacted=True))
    return sim.elems


def revised_pivot_flops(m: int, n: int, *, refactor_period: int | None = None,
                        partial: bool = False,
                        block: int | None = None) -> float:
    """Honest flops of one revised-simplex pivot (core/revised.py).

    * BTRAN + FTRAN: two LU solves (2 m^2 flops each) ......... 4 m^2
    * eta passes: 2 applications x avg K/2 etas x 3 flops/el .. 3 K m
    * pricing matvec over priced candidates ................... 2 m C_priced
      (full: C = n+m; partial: one block + the amortized full
       fallback, ~once per block cycle)
    * amortized refactorization: LU (2/3 m^3) + basis gather .. /K
    * x_B / eta update ........................................ 5 m

    Unlike ``revised_elements`` (state *written*, where revised wins at
    every size because the tableau's rank-1 write never happens), the flops
    model charges triangular-solve reads — so the tableau backend, at
    2 flops per tableau element, stays cheaper on *square* dense LPs and the
    revised method pays off as n grows past a few multiples of m (or under
    sparsity the dense model can't see): the classic textbook crossover,
    located by `revised_crossover`."""
    K = refactor_period or auto_refactor_period(m, n)
    ncand = n + m
    priced = partial_priced_candidates(ncand, block, partial=partial)
    solves = 4.0 * m * m
    etas = 3.0 * K * m
    pricing = 2.0 * m * priced
    refac = (2.0 * m ** 3 / 3.0 + m * m) / K
    return solves + etas + pricing + refac + 5.0 * m


def tableau_pivot_flops(m: int, n: int, compacted: bool = False) -> float:
    """Tableau-backend flops per pivot in the same currency: ~2 flops per
    tableau element touched by the rank-1 update (see `flops_per_pivot` for
    the Gflop/s-accounting variant; this one drops the shared reductions so
    the backend comparison isolates the update term)."""
    return 2.0 * tableau_elements(m, n, compacted=compacted)


def revised_crossover(m: int, *, partial: bool = True,
                      refactor_period: int | None = None,
                      max_ratio: int = 64) -> int | None:
    """Smallest n (scanned up to ``max_ratio * m``) where the revised
    backend's flops-per-pivot model undercuts the phase-compacted tableau's.
    Returns None if the tableau wins over the whole scanned range (dense
    square-ish problems — the tableau's best case)."""
    for n in range(1, max_ratio * m + 1):
        if revised_pivot_flops(m, n, partial=partial,
                               refactor_period=refactor_period) \
                < tableau_pivot_flops(m, n, compacted=True):
            return n
    return None


def pdhg_iteration_flops(m: int, n: int) -> float:
    """Honest flops of one PDHG iteration (core/pdhg.py): two (m, n)
    matvecs (2mn flops each) plus the O(m+n) prox/extrapolation updates.
    Each check round adds six more matvecs — KKT residuals of both the
    current and the average iterate (4) plus the two Farkas-ray tests —
    amortized in as 12mn/CHECK_EVERY."""
    from ..core.pdhg import CHECK_EVERY

    return 4.0 * m * n + 6.0 * (m + n) + 12.0 * m * n / CHECK_EVERY


def sparse_matvec_flops(nnz: int) -> float:
    """Honest flops of one shared-pattern sparse matvec (core/sparse.py):
    one multiply + one scatter-add per stored nonzero.  The dense
    counterpart is 2mn — the ratio is exactly the density."""
    return 2.0 * nnz


def sparse_pdhg_iteration_flops(nnz: int, m: int, n: int) -> float:
    """Density-aware twin of `pdhg_iteration_flops`: two sparse matvecs per
    iteration plus the O(m + n) prox/extrapolation updates, with the six
    check-round matvecs amortized in — every 2mn replaced by 2nnz, the
    vector work unchanged (it never depended on the pattern)."""
    from ..core.pdhg import CHECK_EVERY

    return 2.0 * sparse_matvec_flops(nnz) + 6.0 * (m + n) \
        + 6.0 * sparse_matvec_flops(nnz) / CHECK_EVERY


def sparse_pdhg_speedup(m: int, n: int, nnz: int) -> float:
    """Dense/sparse flops ratio for one PDHG iteration at this pattern:
    -> ~1/density while the matvecs dominate, degrading toward 1 as the
    O(m + n) vector work takes over on very sparse or very small shapes."""
    return pdhg_iteration_flops(m, n) / sparse_pdhg_iteration_flops(nnz, m, n)


def pdhg_crossover_pivots(m: int, n: int, pdhg_iters: float,
                          *, partial: bool = True) -> dict:
    """The headline first-order-vs-simplex comparison: how many *pivots*
    a simplex engine may spend before a PDHG solve of ``pdhg_iters``
    iterations is cheaper on honest flops — and, since Dantzig-style pivot
    counts grow ~O(m+n) while PDHG's iteration count is governed by
    conditioning rather than size, the problem scale where the first-order
    engine takes over.

    The *sequential-depth* column is the sharper story: a simplex pivot is
    a dependent reduce -> ratio -> rank-1 chain (3 serial stages on a
    parallel machine), while a PDHG iteration is 2 matvec stages; but each
    simplex pivot processes O(m x n) state that cannot be split across
    iterations, so once batch parallelism saturates the device the
    iteration *count* is the critical path.  ``depth_ratio`` reports
    (pivots x 3) / (iterations x 2): > 1 means the first-order engine has
    the shorter critical path even before flops win."""
    tab = tableau_pivot_flops(m, n, compacted=True)
    rev = revised_pivot_flops(m, n, partial=partial)
    it_flops = pdhg_iteration_flops(m, n)
    total = pdhg_iters * it_flops
    exp_pivots = float(m + n)    # Dantzig's empirical O(m+n) on this suite
    return {
        "pdhg_iteration_flops": it_flops,
        "pdhg_total_flops": total,
        "crossover_pivots_vs_tableau": total / tab,
        "crossover_pivots_vs_revised": total / rev,
        "expected_pivots": exp_pivots,
        "pdhg_wins_flops_vs_tableau": bool(total < exp_pivots * tab),
        "pdhg_wins_flops_vs_revised": bool(total < exp_pivots * rev),
        "depth_ratio": (exp_pivots * 3.0) / max(pdhg_iters * 2.0, 1.0),
    }


def pdhg_crossover_size(pdhg_iters: float, *, max_m: int = 100000) -> int | None:
    """Smallest square size m (= n) where the first-order engine undercuts
    the phase-compacted tableau on *total* honest flops: simplex pivot
    counts grow ~O(m+n) on this suite while restarted-PDHG iteration
    counts are governed by conditioning, not size — so past this m the
    per-solve flops budget flips even though a single iteration and a
    single pivot cost nearly the same.  Returns None if the tableau wins
    over the whole scanned range (i.e. ``pdhg_iters`` is too large)."""
    for m in range(2, max_m + 1, max(1, max_m // 4096)):
        if pdhg_iters * pdhg_iteration_flops(m, m) \
                < (2.0 * m) * tableau_pivot_flops(m, m, compacted=True):
            return m
    return None


def canonical_work(g, *, presolve: bool = True) -> dict:
    """Canonical-vs-original shape accounting for a general-form batch.

    Returns the original and canonical (m, n) plus every per-pivot work
    model evaluated at the canonical shape — the shape the device solvers
    actually run at.  ``revised_wins_flops`` is the headline: whether the
    basis-factor backend undercuts the phase-compacted tableau *on this
    instance's canonical geometry* (equalities/upper bounds grow m, so
    instances that look square in the original data are often
    revised-territory after canonicalization).
    """
    from ..core.forms import canonical_shape

    mc, nc = canonical_shape(g, presolve=presolve)
    mr, nr = canonical_shape(g, presolve=presolve, bound_rows=True)
    tab_flops = tableau_pivot_flops(mc, nc, compacted=True)
    rev_flops = revised_pivot_flops(mc, nc, partial=True)
    el_native = tableau_elements(mc, nc, compacted=True)
    el_rows = tableau_elements(mr, nr, compacted=True)
    return {
        "name": g.name, "m": g.m, "n": g.n,
        "m_canonical": mc, "n_canonical": nc,
        "row_growth": mc / max(1, g.m), "col_growth": nc / max(1, g.n),
        # counterfactual: finite ubs encoded as x_j <= u_j rows instead of
        # the bounded ratio test — what every per-pivot model would pay
        "m_bound_rows": mr, "n_bound_rows": nr,
        "bound_rows_added": mr - mc,
        "bound_row_element_ratio": el_rows / el_native,
        "bound_row_flops_ratio":
            tableau_pivot_flops(mr, nr, compacted=True) / tab_flops,
        "tableau_elements_canonical": el_native,
        "revised_elements_canonical": revised_elements(mc, nc, partial=True),
        "tableau_flops_canonical": tab_flops,
        "revised_flops_canonical": rev_flops,
        "revised_wins_flops": bool(rev_flops < tab_flops),
        "revised_crossover_n": revised_crossover(mc),
    }


def _workload(m: int, n: int, B: int, mixed: bool, seed: int) -> LPBatch:
    rng = np.random.default_rng(seed)
    half = B // 2
    if mixed:
        b1 = random_lp_batch(rng, half, m, n, feasible_start=True)
        b2 = random_lp_batch(rng, B - half, m, n, feasible_start=False)
        batch = LPBatch(A=np.concatenate([b1.A, b2.A]),
                        b=np.concatenate([b1.b, b2.b]),
                        c=np.concatenate([b1.c, b2.c]))
        order = rng.permutation(B)
        batch = LPBatch(A=batch.A[order], b=batch.b[order], c=batch.c[order])
    else:
        batch = random_lp_batch(rng, B, m, n)
    return batch


def analyze(m: int, n: int, B: int = 4096, mixed: bool = True,
            chips: int = 256, tile_b: int = 8, seed: int = 0,
            pricing: str = "dantzig"):
    batch = _workload(m, n, B, mixed, seed)
    ref, p1_iters = solve_batched_reference_detailed(batch, pricing=pricing)
    iters = ref.iterations.astype(np.int64)
    p1_iters = p1_iters.astype(np.int64)

    useful = float(iters.sum())
    lockstep = executed_pivots(iters, B)
    per_shard = executed_pivots(iters, max(1, B // chips))
    per_tile = executed_pivots(iters, tile_b)
    # sorted batching: difficulty-sorted then per-shard groups
    srt = np.sort(iters)
    per_shard_sorted = executed_pivots(srt, max(1, B // chips))
    per_tile_sorted = executed_pivots(srt, tile_b)

    fpp = flops_per_pivot(m, n)
    tableau_bytes = tableau_elements(m, n) * 4
    # HBM traffic per LP: lockstep XLA re-reads+writes the tableau per
    # executed pivot; the Pallas tile kernel reads it once and writes results
    xla_traffic = 2 * tableau_bytes * lockstep / B
    kernel_traffic = tableau_bytes + (n + 16) * 4

    # two-level work-elimination model (element updates = pivots x tableau)
    el_lock = element_updates_lockstep(iters, m, n)
    el_pc = element_updates_phase_compacted(p1_iters, iters, m, n)
    el_sched = element_updates_scheduled(p1_iters, iters, m, n)

    return {
        "m": m, "n": n, "B": B, "mixed": mixed, "pricing": pricing,
        "pivots_mean": float(iters.mean()), "pivots_max": int(iters.max()),
        "eff_lockstep": useful / lockstep,
        "eff_per_shard": useful / per_shard,
        "eff_per_tile": useful / per_tile,
        "eff_per_shard_sorted": useful / per_shard_sorted,
        "eff_per_tile_sorted": useful / per_tile_sorted,
        "flops_per_pivot": fpp,
        "flops_per_pivot_compacted": flops_per_pivot(m, n, compacted=True),
        "hbm_bytes_per_lp_xla": xla_traffic,
        "hbm_bytes_per_lp_kernel": float(kernel_traffic),
        "traffic_ratio": xla_traffic / kernel_traffic,
        "elems_lockstep": el_lock,
        "elems_phase_compacted": el_pc,
        "elems_scheduled": el_sched,
        "work_reduction_phase_compacted": el_lock / el_pc,
        "work_reduction_scheduled": el_lock / el_sched,
    }


def compare_pricing(m: int, n: int, B: int = 4096, mixed: bool = True,
                    seed: int = 0) -> dict:
    """Replay one workload under every pricing rule through the float64
    oracle and report per-rule pivot counts plus the two-level work models —
    the closed-form view of how pivot savings multiply against phase
    compaction and the bucket ladder.  Rules must agree on statuses (they
    change the path, never the certificate)."""
    batch = _workload(m, n, B, mixed, seed)
    out = {"m": m, "n": n, "B": B, "mixed": mixed, "rules": {}}
    base_status = None
    for rule in PRICING_RULES:
        ref, p1 = solve_batched_reference_detailed(batch, pricing=rule)
        iters = ref.iterations.astype(np.int64)
        p1 = p1.astype(np.int64)
        if base_status is None:
            base_status = ref.status
        out["rules"][rule] = {
            "pivots_mean": float(iters.mean()),
            "pivots_max": int(iters.max()),
            "pivots_total": int(iters.sum()),
            "statuses_match": bool(np.array_equal(ref.status, base_status)),
            "elems_lockstep": element_updates_lockstep(iters, m, n),
            "elems_phase_compacted":
                element_updates_phase_compacted(p1, iters, m, n),
            "elems_scheduled": element_updates_scheduled(p1, iters, m, n),
        }
    dz = out["rules"]["dantzig"]["pivots_mean"]
    for rule in PRICING_RULES:
        out["rules"][rule]["pivot_cut_vs_dantzig"] = (
            1.0 - out["rules"][rule]["pivots_mean"] / max(dz, 1e-12))
    return out


def main():
    print("workload,eff_lockstep,eff_shard,eff_tile,eff_shard_sorted,"
          "eff_tile_sorted,traffic_ratio_xla_vs_kernel,"
          "work_red_phase_compact,work_red_scheduled")
    for (m, n, mixed) in [(5, 5, True), (28, 28, True), (50, 50, True),
                          (100, 100, True), (28, 28, False)]:
        r = analyze(m, n, mixed=mixed)
        print(f"lp_{n}d{'_mixed' if mixed else ''},"
              f"{r['eff_lockstep']:.3f},{r['eff_per_shard']:.3f},"
              f"{r['eff_per_tile']:.3f},{r['eff_per_shard_sorted']:.3f},"
              f"{r['eff_per_tile_sorted']:.3f},{r['traffic_ratio']:.1f},"
              f"{r['work_reduction_phase_compacted']:.2f},"
              f"{r['work_reduction_scheduled']:.2f}")
    print()
    print("pricing,pivots_mean,pivots_max,pivot_cut_vs_dantzig,"
          "elems_scheduled,statuses_match  # 28x28 mixed B=4096")
    cmp = compare_pricing(28, 28)
    for rule, r in cmp["rules"].items():
        print(f"{rule},{r['pivots_mean']:.2f},{r['pivots_max']},"
              f"{r['pivot_cut_vs_dantzig']:.3f},{r['elems_scheduled']:.3e},"
              f"{r['statuses_match']}")
    print()
    print("backend_model,m,n,flops_per_pivot,element_updates_per_pivot,"
          "crossover_n_at_m  # tableau (compacted) vs revised")
    for (m, n) in [(28, 28), (100, 100), (100, 400), (50, 500)]:
        print(f"tableau,{m},{n},{tableau_pivot_flops(m, n, compacted=True):.3e},"
              f"{tableau_elements(m, n, compacted=True):.3e},")
        print(f"revised_partial,{m},{n},"
              f"{revised_pivot_flops(m, n, partial=True):.3e},"
              f"{revised_elements(m, n, partial=True):.3e},"
              f"{revised_crossover(m)}")
    print()
    print("fixture,m,n,m_canonical,n_canonical,m_bound_rows,"
          "bound_row_element_ratio,tableau_flops,revised_flops,"
          "revised_wins  # general-form instances at canonical shape; "
          "bound_row_* = cost of encoding ubs as rows instead of natively")
    from ..io.mps import FIXTURE_NAMES, fixture_path, read_mps
    for name in FIXTURE_NAMES:
        g = read_mps(fixture_path(name))
        w = canonical_work(g)
        print(f"{w['name']},{w['m']},{w['n']},{w['m_canonical']},"
              f"{w['n_canonical']},{w['m_bound_rows']},"
              f"{w['bound_row_element_ratio']:.2f},"
              f"{w['tableau_flops_canonical']:.3e},"
              f"{w['revised_flops_canonical']:.3e},{w['revised_wins_flops']}")
    print()
    print("sparse_pdhg,fixture,m,n,nnz,density,dense_iter_flops,"
          "sparse_iter_flops,speedup  # shared-pattern matvecs vs dense")
    for name in FIXTURE_NAMES:
        g = read_mps(fixture_path(name))
        nnz = int((np.asarray(g.A[0]) != 0).sum())
        print(f"sparse_pdhg,{name},{g.m},{g.n},{nnz},"
              f"{nnz / max(1, g.m * g.n):.4f},"
              f"{pdhg_iteration_flops(g.m, g.n):.3e},"
              f"{sparse_pdhg_iteration_flops(nnz, g.m, g.n):.3e},"
              f"{sparse_pdhg_speedup(g.m, g.n, nnz):.2f}")
    print()
    print("pdhg_crossover,m,n,iters,flops_per_iter,pivot_budget_vs_tableau,"
          "expected_pivots,pdhg_wins  # first-order vs simplex, honest flops"
          " (iters = typical measured restarted-PDHG counts)")
    for (m, n, iters) in [(28, 28, 3000), (100, 100, 5000),
                          (500, 500, 8000), (2000, 2000, 12000)]:
        w = pdhg_crossover_pivots(m, n, iters)
        print(f"pdhg,{m},{n},{iters},{w['pdhg_iteration_flops']:.3e},"
              f"{w['crossover_pivots_vs_tableau']:.1f},"
              f"{w['expected_pivots']:.0f},"
              f"{w['pdhg_wins_flops_vs_tableau']}")
    for iters in (3000, 10000, 30000):
        print(f"pdhg_crossover_size(iters={iters}): m = "
              f"{pdhg_crossover_size(iters)}  # square size where the "
              "O(m+n) pivot count overtakes a conditioning-bound "
              "iteration count")


if __name__ == "__main__":
    main()
