"""Float64 NumPy two-phase simplex — the correctness oracle & CPU baseline.

A copy of ``repro.core.reference`` (the port's smoke run needs the oracle
and the batch generators on a machine without JAX).

Plays the role GLPK/CPLEX play in the paper's evaluation: a trusted
*sequential* CPU solver that batched device solvers are compared against,
both for correctness (tests) and for speedup curves (benchmarks). It
implements the exact same two-phase/sentinel algorithm as the torch engine and
the CUDA kernel — including the pluggable pricing engine (``pricing=`` selects
dantzig / steepest_edge / devex, see core/pricing.py) — so that iteration
counts and pivot sequences match bit-for-bit modulo dtype *per rule*: the
oracle is the per-rule pivot-sequence ground truth.
"""
from __future__ import annotations

import numpy as np

from .forms import ensure_canonical, finish_result, prepare_warm
from .lp import (
    BIG,
    INFEASIBLE,
    ITERATION_LIMIT,
    OPTIMAL,
    UNBOUNDED,
    LPBatch,
    LPResult,
    WarmStart,
    build_tableau,
    default_max_iters,
    extract_solution,
)
from .pricing import (
    canonicalize_rule,
    init_weights_np,
    select_entering_np,
    update_weights_np,
)


def _inject_warm_np(A, b, c, ub, wb, wfl, *, m: int, n: int,
                    feas_tol: float = 1e-8):
    """Single-LP float64 mirror of ``simplex.inject_tableau_warm``: rebuild
    the two-phase tableau from a parent basis with the same per-LP
    skip/repair/cold trichotomy (see that docstring for the math).  Returns
    ``(T, basis, start_phase, flip)`` or ``None`` for the cold fallback."""
    if wb.min() < 0 or wb.max() >= n + 2 * m:
        return None
    wb2 = np.where(wb >= n + m, wb - m, wb).astype(np.int64)
    ubv = np.full(n, np.inf) if ub is None else np.asarray(ub, np.float64)
    wfl = wfl & np.isfinite(ubv)
    ubz = np.where(wfl, ubv, 0.0)
    Af = np.where(wfl[None, :], -A, A)
    bf = b - A @ ubz
    cf = np.where(wfl, -c, c)
    obj_off = float(c @ ubz)
    Acols = np.concatenate([Af, np.eye(m)], axis=1)
    Bmat = Acols[:, wb2]
    try:
        body = np.linalg.solve(
            Bmat, np.concatenate([Acols, bf[:, None]], axis=1))
    except np.linalg.LinAlgError:
        return None
    if not np.isfinite(body).all():
        return None
    xB = body[:, -1]
    eps = feas_tol * max(1.0, float(np.abs(bf).max(initial=0.0)))
    viol = xB < -eps
    rows = np.where(viol, -1.0, 1.0)[:, None] * body
    cext = np.concatenate([cf, np.zeros(m)])
    cB = np.where(viol, 0.0, cext[wb2])
    red = cext - cB @ rows[:, :n + m]
    idx = np.arange(m)
    T = np.zeros((m + 2, n + 2 * m + 1))
    T[:m, :n + m] = rows[:, :n + m]
    T[idx, n + m + idx] = np.where(viol, 1.0, 0.0)
    T[:m, -1] = rows[:, -1]
    T[m, :n + m] = red
    T[m, -1] = -(cB @ rows[:, -1] + obj_off)
    p1 = (rows * viol[:, None]).sum(axis=0)
    T[m + 1, :n + m] = p1[:n + m]
    T[m + 1, -1] = p1[-1]
    basis = np.where(viol, n + m + idx, wb2)
    return T, basis, (1 if viol.any() else 2), wfl


def _solve_single(T, basis, n, m, tol, max_iters, rule="dantzig", ub=None,
                  flip=None, start_phase=1):
    """Solve one LP in-place on its (m+2, cols) float64 tableau.

    Returns (status, iters, p1_iters): ``p1_iters`` counts the iterations
    consumed before phase 2 began (phase-1 pivots plus the transition check)
    — the input to the phase-compaction executed-work models in
    analysis/lp_perf.py and benchmarks/pivot_work.py.

    ``ub`` ((n,) or None) enables the bounded-variable method ``0 <= x <=
    ub``: columns are stored *complemented* (x' = ub - x) whenever their
    ``flip`` flag is set, so every nonbasic variable sits at 0 and the
    classic sentinel min-ratio applies unchanged.  The ratio test gains two
    cases: a basic variable may hit its own upper bound (its row is
    complemented before the pivot, making the pivot element positive), and
    the entering variable may hit its bound first — a *bound flip* that
    costs one column negation + rhs update instead of a pivot (counted as
    an iteration; pricing weights are untouched — column negation is
    norm-invariant for the d^2/w scores).  With all-+inf ``ub`` every new
    branch is dead and the classic method runs bitwise-unchanged."""
    cols = T.shape[1]
    allowed = np.zeros(cols, dtype=bool)
    allowed[: n + m] = True  # artificials and rhs never enter
    feas_thr = 1e-8 * max(1.0, T[m + 1, -1])  # relative, as in the f32 engines
    weights = init_weights_np(rule, T, m)
    bounded = ub is not None and np.isfinite(ub).any()
    if flip is None:
        flip = np.zeros(n, dtype=bool)
    phase = start_phase
    iters = 0
    p1_iters = 0
    status = None
    while iters < max_iters:
        obj_row = T[m + 1] if phase == 1 else T[m]
        reduced = np.where(allowed, obj_row, -BIG)
        e = select_entering_np(reduced, weights, rule=rule, tol=tol,
                               iters=iters, ncand=n + m)
        if np.max(reduced) <= tol:
            if phase == 1:
                w = T[m + 1, -1]
                if w > feas_thr:
                    status = INFEASIBLE
                    break
                phase = 2
                iters += 1
                p1_iters = iters
                continue
            status = OPTIMAL
            break
        col = T[:m, e]
        rhs = T[:m, -1]
        with np.errstate(divide="ignore", invalid="ignore"):
            ratios = np.where(col > tol, rhs / np.where(col > tol, col, 1.0), BIG)
        if bounded:
            # a *decreasing* basic variable never binds, but an increasing
            # one (col < 0) may hit its own finite upper bound at
            # (ub_B - rhs) / (-col) — complement-and-pivot when it wins
            ubB = np.where(basis < n, ub[np.minimum(basis, n - 1)], np.inf)
            hit_ub = (col < -tol) & np.isfinite(ubB)
            with np.errstate(divide="ignore", invalid="ignore"):
                ub_ratio = (ubB - rhs) / np.where(hit_ub, -col, 1.0)
            ratios = np.where(hit_ub, ub_ratio, ratios)
        if phase == 2:
            # Basic artificials are pinned at zero in phase 2: a pivot whose
            # entering column would *grow* one (negative coefficient in its
            # row) instead kicks it out at ratio 0 — the pivot element is
            # negative, which is legal at a zero rhs.  Without this, the
            # degenerate artificials that equality-pair canonicalization
            # (core/forms.py) routinely leaves basic-at-zero can silently
            # re-relax their row during phase 2.
            ratios = np.where((basis >= n + m) & (col < -tol), 0.0, ratios)
        l = int(np.argmin(ratios))
        t_e = ub[e] if bounded and e < n else np.inf
        if t_e < ratios[l]:
            # bound flip: the entering variable hits its own upper bound
            # before any basic variable binds — complement it in place
            T[:, -1] -= t_e * T[:, e]
            T[:, e] = -T[:, e]
            flip[e] = ~flip[e]
            iters += 1
            continue
        if ratios[l] >= BIG / 2:
            status = UNBOUNDED if phase == 2 else ITERATION_LIMIT
            break
        if bounded and T[l, e] < 0 and basis[l] < n:
            # leaving basic hits its *upper* bound: complement its (unit)
            # column — negate row l, rhs_l -> ub_l - rhs_l — which makes
            # the pivot element positive and the pivot classic
            jl = int(basis[l])
            T[l] = -T[l]
            T[l, -1] += ub[jl]
            T[l, jl] = 1.0
            flip[jl] = ~flip[jl]
        pe = T[l, e]
        pivrow = T[l] / pe
        factor = T[:, e].copy()
        T -= factor[:, None] * pivrow[None, :]
        T[l] = pivrow
        weights = update_weights_np(rule, weights, T, pivrow, pe, e, basis[l],
                                    m=m, n=n)
        basis[l] = e
        iters += 1
    if status is None:
        status = ITERATION_LIMIT
    if phase == 1:
        p1_iters = iters
    return status, iters, p1_iters


def solve_batched_reference_detailed(batch: LPBatch, tol: float = 1e-9,
                                     max_iters: int | None = None,
                                     pricing: str = "dantzig",
                                     presolve: bool = True,
                                     scale: bool | None = None,
                                     warm: WarmStart | None = None):
    """Like solve_batched_reference, but also returns per-LP phase-1
    iteration counts ``(LPResult, p1_iters)`` — the input for the
    phase-compaction executed-work models (analysis/lp_perf.py,
    benchmarks/pivot_work.py).

    Accepts a ``GeneralLPBatch`` like every solver entry point: the oracle
    then solves the canonical form and reports in original coordinates
    (``presolve``/``scale`` control the canonicalization).  ``warm``
    accepts a WarmStart (any basis-carrying engine's, or a previous oracle
    solve's) and seeds each LP via `_inject_warm_np` — the f64 ground truth
    for the batched engines' warm paths."""
    batch, rec = ensure_canonical(batch, presolve=presolve, scale=scale)
    B, m, n = batch.batch, batch.m, batch.n
    rule = canonicalize_rule(pricing)
    if max_iters is None:
        max_iters = default_max_iters(m, n)
    warm = prepare_warm(warm, rec, batch)
    T, basis, _ = build_tableau(batch.A, batch.b, batch.c)
    ub = None if batch.ub is None else np.asarray(batch.ub, np.float64)
    flip = np.zeros((B, n), dtype=bool)
    start_phase = np.ones(B, dtype=np.int32)
    if warm is not None and warm.basis is not None:
        wb = np.asarray(warm.basis, np.int64)
        wfl = (np.zeros((B, n), bool) if warm.at_upper is None
               else np.asarray(warm.at_upper, bool))
        A64 = np.asarray(batch.A, np.float64)
        b64 = np.asarray(batch.b, np.float64)
        c64 = np.asarray(batch.c, np.float64)
        for k in range(B):
            inj = _inject_warm_np(A64[k], b64[k], c64[k],
                                  None if ub is None else ub[k],
                                  wb[k], wfl[k], m=m, n=n)
            if inj is not None:
                T[k], basis[k], start_phase[k], flip[k] = inj
    status = np.zeros(B, dtype=np.int8)
    iters = np.zeros(B, dtype=np.int32)
    p1_iters = np.zeros(B, dtype=np.int32)
    for k in range(B):
        status[k], iters[k], p1_iters[k] = _solve_single(
            T[k], basis[k], n, m, tol, max_iters, rule=rule,
            ub=None if ub is None else ub[k], flip=flip[k],
            start_phase=int(start_phase[k]))
    x, obj = extract_solution(T, basis, n, ub=ub, flip=flip)
    # dual certificate off the final tableau (see simplex.extract_duals):
    # slack-column reduced costs are -y, structural entries are z = c - y.A
    # (flipped columns are complemented, so their stored entry is -z)
    y = -T[:, m, n:n + m]
    z = np.where(flip, -T[:, m, :n], T[:, m, :n])
    # non-optimal LPs report NaN objective/duals to make misuse loud
    bad = status != OPTIMAL
    obj = np.where(bad, np.nan, obj)
    y = np.where(bad[:, None], np.nan, y)
    z = np.where(bad[:, None], np.nan, z)
    res = LPResult(x=x, objective=obj, status=status, iterations=iters,
                   y=y, z=z,
                   warm=WarmStart(m=m, n=n, basis=basis.astype(np.int32),
                                  at_upper=flip.copy(), pricing=rule))
    return finish_result(rec, res), p1_iters


def solve_batched_reference(batch: LPBatch, tol: float = 1e-9,
                            max_iters: int | None = None,
                            pricing: str = "dantzig",
                            presolve: bool = True,
                            scale: bool | None = None,
                            warm: WarmStart | None = None) -> LPResult:
    """Sequentially solve every LP in the batch (float64). O(B) loop — this is
    the 'CPU sequential' side of every speedup table.  Accepts general-form
    batches (GeneralLPBatch) like every solver entry point, and a ``warm``
    carrier like every batched engine."""
    res, _ = solve_batched_reference_detailed(batch, tol=tol,
                                              max_iters=max_iters,
                                              pricing=pricing,
                                              presolve=presolve, scale=scale,
                                              warm=warm)
    return res


def solve_dual_reference(batch: LPBatch, tol: float = 1e-9) -> LPResult:
    """Solve the dual of each LP:  min b.y  s.t.  A^T y >= c, y >= 0.

    Rewritten as the standard-form max problem  max (-b).y  s.t. (-A^T) y <= -c.
    Used by the strong-duality property tests: for feasible+bounded primal,
    primal optimum == dual optimum (dual objective here is -reported).
    """
    A = np.asarray(batch.A, dtype=np.float64)
    dual = LPBatch.from_arrays(
        -np.swapaxes(A, 1, 2), -np.asarray(batch.c, np.float64),
        -np.asarray(batch.b, np.float64),
    )
    res = solve_batched_reference(dual, tol=tol)
    return LPResult(x=res.x, objective=-res.objective, status=res.status,
                    iterations=res.iterations)


def random_lp_batch(rng: np.random.Generator, B: int, m: int, n: int,
                    feasible_start: bool = True) -> LPBatch:
    """Random dense LPs following the paper's Sec. 6 recipe: A in [1,1000],
    b in [1,1000], c in [1,500]. With positive A and b the origin is feasible
    and the optimum is finite (every variable is bounded by some row).

    feasible_start=False mirrors the paper's Table-4 class: ~m/4 rows are
    flipped into ">=" rows (negative b), so the initial basic solution is
    infeasible and the two-phase method runs — but the LP itself is kept
    feasible by construction around a known interior point x0, and bounded
    because the remaining rows have all-positive coefficients.
    """
    A = rng.uniform(1.0, 1000.0, size=(B, m, n))
    c = rng.uniform(1.0, 500.0, size=(B, n))
    if feasible_start:
        b = rng.uniform(1.0, 1000.0, size=(B, m))
    else:
        x0 = rng.uniform(0.05, 0.5, size=(B, n))          # known feasible point
        ax0 = np.einsum("bmn,bn->bm", A, x0)
        b = ax0 * rng.uniform(1.05, 2.0, size=(B, m))      # x0 strictly feasible
        k = max(1, m // 4)
        rows = rng.permuted(np.tile(np.arange(m), (B, 1)), axis=1)[:, :k]
        theta = rng.uniform(0.3, 0.9, size=(B, k))
        for bi in range(B):
            for j, r in enumerate(rows[bi]):
                A[bi, r] = -A[bi, r]
                b[bi, r] = -theta[bi, j] * ax0[bi, r]      # -A_r x <= -theta*(A_r x0)
    return LPBatch.from_arrays(A, b, c)


def random_sparse_lp_batch(rng: np.random.Generator, B: int, m: int, n: int,
                           density: float = 0.1) -> LPBatch:
    """Sparse feasible LPs at given density — stand-ins for the Netlib set
    (the paper's Table 5/6 problems are highly sparse). Every column keeps at
    least one nonzero so the LP stays bounded."""
    A = rng.uniform(1.0, 1000.0, size=(B, m, n))
    mask = rng.uniform(size=(B, m, n)) < density
    # guarantee a bounding nonzero per column
    rows = rng.integers(0, m, size=(B, n))
    mask[np.arange(B)[:, None], rows, np.arange(n)[None, :]] = True
    A = A * mask
    b = rng.uniform(1.0, 1000.0, size=(B, m))
    c = rng.uniform(1.0, 500.0, size=(B, n)) * (rng.uniform(size=(B, n)) < 0.5)
    return LPBatch.from_arrays(A, b, c)
