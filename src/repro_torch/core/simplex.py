"""Batched two-phase dense-tableau simplex in PyTorch: the port's engine and
the plain version of the CUDA kernel (kernels/csrc/simplex_tile.cu).

Counterpart of ``repro.core.simplex`` (the cold path): the same tableau
layout (core/lp.py), the same lockstep steps and the same two chained loops
with one-shot phase compaction.  Loop 1 runs the combined step on the full
(B, m+2, n+2m+1) tableau until no LP is still in phase 1;
``compact_tableau`` then drops the m artificial columns and the phase-1
row, and loop 2 finishes phase 2 on the (B, m+1, n+m+1) tableau.  The loops
share one ``max_iters`` budget.  Each step is Steps 1-3 of the paper's
Sec. 4.1 with the Sec. 5.2 sentinel, the bounded-variable ratio test with
bound flips, and phase-2 pinning of basic-at-zero artificials.

Every ``a - b * c`` of the reference rounds once here (core/fp.py), as the
reference's CPU build and the CUDA kernel do, so statuses, iteration counts
and solutions are bit-identical across the three.  Each step builds new
tensors rather than updating in place: the engine is the readable
statement of what the kernel computes, not a fast path.

A warm start (``warm=``, a ``WarmStart`` of a parent solve) rebuilds the
tableau from the parent basis per LP (``inject_tableau_warm``: skip,
repair or cold fallback), through ``_gauss_solve``, a per-LP Gauss-Jordan
whose results do not depend on the batch size.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..obs.report import report_from_counters
from ..obs.telemetry import (TelemetryState, init_telemetry,
                             tel_simplex_update, tel_to_numpy)
from ..obs.trace import maybe_span
from .forms import ensure_canonical, finish_result, prepare_warm
from .fp import colsum_fma, dot_last, fma
from .lp import (
    BIG,
    INFEASIBLE,
    ITERATION_LIMIT,
    OPTIMAL,
    UNBOUNDED,
    LPBatch,
    LPResult,
    WarmStart,
    default_max_iters,
)
from .pricing import (
    canonicalize_rule,
    compact_weights,
    init_weights,
    select_entering,
    update_weights,
)

_RUNNING = -1


class SimplexState(NamedTuple):
    T: torch.Tensor       # (B, rows, C) tableaux (full or phase-compacted)
    basis: torch.Tensor   # (B, m) int32
    phase: torch.Tensor   # (B,) int32 — 1 or 2
    status: torch.Tensor  # (B,) int32 — _RUNNING until terminal
    iters: torch.Tensor   # (B,) int32
    w: torch.Tensor       # (B, C) pricing weights (unread under dantzig)
    flip: torch.Tensor    # (B, n) bool — structural column stored
                          #  complemented (x' = ub - x)
    ub: torch.Tensor      # (B, n) upper bounds (+inf = unbounded)
    work: torch.Tensor    # (B, 3) int32 — phase-1 pivots, phase-2 pivots,
                          #  bound flips
    tel: Optional[TelemetryState] = None  # counter lanes, or None with
                                          #  telemetry off


def build_tableau_torch(A: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """The two-phase tableau batch of core.lp.build_tableau, on A's device.

    Returns ``(T, basis, phase)``.  Rows with b_i < 0 are negated and get an
    artificial; the phase-1 row sums those rows in row order (one rounding
    per row, as the reference's fused reduction: each term is the row or
    an exact zero)."""
    B, m, n = A.shape
    dtype, dev = A.dtype, A.device
    C = n + 2 * m + 1
    neg = b < 0
    sign = torch.where(neg, -1.0, 1.0).to(dtype)
    idx = torch.arange(m, device=dev)
    T = torch.zeros((B, m + 2, C), dtype=dtype, device=dev)
    T[:, :m, :n] = A * sign[:, :, None]
    T[:, idx, n + idx] = sign
    T[:, idx, n + m + idx] = neg.to(dtype)
    T[:, :m, -1] = b * sign
    T[:, m, :n] = c
    negf = neg.to(dtype)
    p1 = torch.zeros((B, C), dtype=dtype, device=dev)
    for i in range(m):
        p1 = p1 + T[:, i, :] * negf[:, i, None]
    p1[:, n + m:n + 2 * m] = 0.0
    T[:, m + 1, :] = p1
    basis = torch.where(neg, n + m + idx[None, :], n + idx[None, :])
    phase = torch.where(neg.any(dim=1), 1, 2)
    return T, basis.to(torch.int32), phase.to(torch.int32)


def _gauss_solve(Bmat: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched ``B^-1 @ rhs`` by Gauss-Jordan with partial pivoting (the
    largest ``|entry|`` at or below the diagonal, lowest row on ties), one
    LP at a time in effect: every operation is elementwise or per LP, so
    the result does not depend on the batch size (a batched LU or
    ``torch.linalg.solve`` may).  Each elimination rounds once
    (``fma``), as the reference's CPU build does.  A singular matrix
    divides by zero and yields non-finite rows: the callers' cold-fallback
    signal.  Columns left of the pivot are exact zeros or ones after their
    own step and are never read again, so each step updates the columns
    from the pivot on."""
    B, m, _ = Bmat.shape
    aug = torch.cat([Bmat, rhs], dim=2)
    rows = torch.arange(m, device=aug.device)
    for k in range(m):
        cand = torch.where(rows[None, :] >= k, aug[:, :, k].abs(), -torch.inf)
        p = cand.argmax(dim=1)
        swap = torch.where(rows[None, :] == k, p[:, None],
                           torch.where(rows[None, :] == p[:, None], k,
                                       rows[None, :]))
        aug = aug.gather(1, swap[:, :, None].expand_as(aug))
        col = aug[:, :, k]
        pivrow = aug[:, k, k:] / aug[:, k, k][:, None]
        upd = fma(-col[:, :, None], pivrow[:, None, :], aug[:, :, k:])
        upd[:, k, :] = pivrow
        aug = torch.cat([aug[:, :, :k], upd], dim=2)
    return aug[:, :, m:]


def inject_tableau_warm(A, b, c, ub, wb, wfl, *, m: int, n: int,
                        feas_tol: float):
    """Rebuild the two-phase tableau batch from a parent basis.

    ``wb`` (B, m) int32 is the parent basis, ``wfl`` (B, n) bool its
    nonbasic-at-upper flips.  Per LP, as the reference's
    ``inject_tableau_warm``:

    * **skip**: the parent basis is still primal-feasible on the new data,
      so the tableau starts in phase 2 with no artificials;
    * **repair**: rows whose basic value went negative get an artificial
      (its physical column is ``-B e_i``, so negating the computed row
      makes it basic at ``|x_B_i|``), and a phase-1 row summing exactly
      those rows drives them out;
    * **cold**: out-of-range indices or a singular basis matrix after the
      artificial-to-slack remap (a non-finite solve): ``ok`` is False and
      the caller keeps the cold tableau.

    Flips on columns whose new bound is infinite are cleared.  Sums run in
    index order with one rounding per term.  Returns
    ``(T, basis, phase, flip, ok)``."""
    B = A.shape[0]
    dtype, dev = A.dtype, A.device
    idx = torch.arange(m, device=dev)
    wb = wb.to(torch.int64)
    in_range = ((wb >= 0) & (wb < n + 2 * m)).all(dim=1)
    wb2 = torch.where(wb >= n + m, wb - m, wb).clamp(0, n + m - 1)
    wfl = wfl & torch.isfinite(ub)
    ubz = torch.where(wfl, ub, 0.0).to(dtype)
    # complement flipped structurals: x_j = ub_j - x'_j
    Af = torch.where(wfl[:, None, :], -A, A)
    bf = b - dot_last(A, ubz[:, None, :])
    cf = torch.where(wfl, -c, c)
    obj_off = dot_last(c, ubz)

    eye = torch.eye(m, dtype=dtype, device=dev).expand(B, m, m)
    Acols = torch.cat([Af, eye], dim=2)                       # (B, m, n+m)
    Bmat = Acols.gather(2, wb2[:, None, :].expand(B, m, m))
    body = _gauss_solve(Bmat, torch.cat([Acols, bf[:, :, None]], dim=2))
    xB = body[:, :, -1]
    eps = feas_tol * torch.clamp(bf.abs().amax(dim=1), min=1.0)
    viol = xB < -eps[:, None]
    D = torch.where(viol, -1.0, 1.0).to(dtype)
    rows = D[:, :, None] * body
    cext = torch.cat([cf, torch.zeros((B, m), dtype=dtype, device=dev)],
                     dim=1)
    cB = torch.where(viol, 0.0, cext.gather(1, wb2))
    red = cext - colsum_fma(cB[:, :, None], rows[:, :, :n + m])

    T = torch.zeros((B, m + 2, n + 2 * m + 1), dtype=dtype, device=dev)
    T[:, :m, :n + m] = rows[:, :, :n + m]
    T[:, idx, n + m + idx] = viol.to(dtype)
    T[:, :m, -1] = rows[:, :, -1]
    T[:, m, :n + m] = red
    # -T[m, -1] is the true (unflipped) objective of the warm vertex
    T[:, m, -1] = -(colsum_fma(cB, rows[:, :, -1]) + obj_off)
    violf = viol.to(dtype)
    p1 = torch.zeros((B, n + m + 1), dtype=dtype, device=dev)
    for i in range(m):
        p1 = p1 + rows[:, i, :] * violf[:, i, None]
    T[:, m + 1, :n + m] = p1[:, :n + m]
    T[:, m + 1, -1] = p1[:, -1]

    basis = torch.where(viol, n + m + idx[None, :], wb2).to(torch.int32)
    phase = torch.where(viol.any(dim=1), 1, 2).to(torch.int32)
    ok = in_range & torch.isfinite(T).flatten(1).all(dim=1)
    return T, basis, phase, wfl & ok[:, None], ok


def _pivot_update(T, w, basis, factor, pivrow_raw, pe, e, l, do_pivot,
                  *, m, n, rule):
    """Rank-1 pivot update: subtract the entering-column outer product
    everywhere (one rounding per entry), then *replace* the pivot row with
    the scaled row; the pricing-weight recurrence reads the result."""
    rows = T.shape[1]
    pe_safe = torch.where(do_pivot, pe, 1.0)
    pivrow = pivrow_raw / pe_safe[:, None]
    T_new = fma(-factor[:, :, None], pivrow[:, None, :], T)
    is_l = torch.arange(rows, device=T.device)[None, :, None] == l[:, None, None]
    T_new = torch.where(is_l, pivrow[:, None, :], T_new)
    T_out = torch.where(do_pivot[:, None, None], T_new, T)
    r = basis.gather(1, l[:, None])[:, 0]
    w = update_weights(rule, w, T_out, pivrow, pe_safe, e, r, do_pivot,
                       m=m, n=n)
    return T_out, w


def _take(v, idx, n, fill=torch.inf):
    """v[b, idx[b]] where idx < n, else ``fill`` (bound lookups by select,
    never by a sum: inf * 0 would poison it)."""
    got = v.gather(1, idx.clamp(max=n - 1).long()).to(v.dtype)
    return torch.where(idx < n, got, fill)


def _bounded_ratios(ratios, col, rhs, basis, ub, *, n, tol):
    """Case (b) of the bounded-variable ratio test: a basic variable the
    entering column drives *up* (col < 0) may hit its own finite upper
    bound at ``(ub_B - rhs) / (-col)``; with all-+inf bounds this is the
    identity."""
    ubB = _take(ub, basis, n)
    hit = (col < -tol) & torch.isfinite(ubB)
    return torch.where(hit, (ubB - rhs) / torch.where(hit, -col, 1.0), ratios)


def _bound_moves(T, flip, ub, basis, factor, pivrow_raw, pe, e, l,
                 wants_pivot, no_row, min_ratio, *, n):
    """The two bounded-variable moves of one step.

    * Entering-bound flip (``ub_e < min_ratio``): complement the entering
      column in place — ``rhs -= ub_e * col`` on every row and negate the
      column; no pivot, no weight update.
    * Leaving-at-upper complement: a negative pivot element on a structural
      basic means it hit its own bound; rewrite the pivot row (negate it,
      ``rhs_l -> ub_l - rhs_l``, restore the +1 basic entry) so the pivot
      element turns positive.

    Returns ``(T, flip, pivrow_raw, pe, do_flip, do_pivot)``."""
    B, rows, C = T.shape
    ub_e = _take(ub, e[:, None], n)[:, 0]
    do_flip = wants_pivot & (ub_e < min_ratio)
    do_pivot = wants_pivot & ~no_row & ~do_flip

    ub_e_term = torch.where(do_flip, ub_e, 0.0)
    T = T.clone()
    T[:, :, -1] = fma(-ub_e_term[:, None], factor, T[:, :, -1])
    sign_e = torch.where(do_flip, -1.0, 1.0).to(T.dtype)
    eidx = e.view(B, 1, 1).expand(B, rows, 1)
    T.scatter_(2, eidx, T.gather(2, eidx) * sign_e[:, None, None])
    cols_n = torch.arange(n, device=T.device)
    flip = flip ^ (do_flip[:, None] & (cols_n[None, :] == e[:, None]))

    jl = basis.gather(1, l[:, None])[:, 0]
    need_comp = do_pivot & (pe < 0) & (jl < n)
    ub_jl = _take(ub, jl[:, None], n)[:, 0]
    is_jl = torch.arange(C, device=T.device)[None, :] == jl[:, None]
    comp_row = -pivrow_raw
    comp_row[:, -1] = comp_row[:, -1] + torch.where(need_comp, ub_jl, 0.0)
    comp_row = torch.where(is_jl, 1.0, comp_row)
    pivrow_raw = torch.where(need_comp[:, None], comp_row, pivrow_raw)
    pe = torch.where(need_comp, -pe, pe)
    flip = flip ^ (need_comp[:, None] & is_jl[:, :n])
    return T, flip, pivrow_raw, pe, do_flip, do_pivot


def _step(s: SimplexState, *, n: int, m: int, tol: float, feas_thr,
          rule: str, full: bool, active=None) -> SimplexState:
    """One lockstep step across the batch (masked for inactive LPs): on the
    full tableau (``full=True``, both phases) or on the phase-compacted one
    (phase 2 only, every running LP is in phase 2 there).  ``active``, a
    (B,) bool mask, restricts the step to the running LPs it selects (a
    resumable segment parks some and stops others at their cap); an LP
    outside it keeps every leaf bit for bit."""
    T, basis, phase, status, iters, w, flip, ub, work = s[:9]
    B, rows, C = T.shape
    running = status == _RUNNING
    active = running if active is None else running & active
    col_ok = torch.arange(C, device=T.device) < n + m

    # ---- Step 1: entering variable (pivot column) --------------------------
    cost = (torch.where((phase == 1)[:, None], T[:, m + 1, :], T[:, m, :])
            if full else T[:, m, :])
    masked_cost = torch.where(col_ok[None, :], cost, -BIG)
    e, max_cost = select_entering(masked_cost, w, rule=rule, tol=tol,
                                  iters=iters, ncand=n + m)
    is_opt = max_cost <= tol
    if full:
        p1_done = active & (phase == 1) & is_opt
        infeasible = p1_done & (T[:, m + 1, -1] > feas_thr)
        to_phase2 = p1_done & ~infeasible
    else:
        infeasible = to_phase2 = torch.zeros_like(active)
    p2_done = active & (phase == 2) & is_opt

    # ---- Step 2: leaving variable (pivot row), sentinel min-ratio ----------
    factor = T.gather(2, e.view(B, 1, 1).expand(B, rows, 1))[:, :, 0]
    col = factor[:, :m]
    rhs = T[:, :m, -1]
    valid = col > tol
    ratios = torch.where(valid, rhs / torch.where(valid, col, 1.0), BIG)
    ratios = _bounded_ratios(ratios, col, rhs, basis, ub, n=n, tol=tol)
    # phase 2 pins basic artificials at zero: an entering column that would
    # grow one kicks it out at ratio 0 instead
    pin = (phase == 2)[:, None] & (basis >= n + m) & (col < -tol)
    ratios = torch.where(pin, 0.0, ratios)
    l = ratios.argmin(dim=1)
    min_ratio = ratios.amin(dim=1)
    no_row = min_ratio >= BIG / 2
    wants_pivot = active & ~is_opt

    # ---- Step 3: bound moves + rank-1 pivot update (+ fused weights) -------
    pivrow_raw = T.gather(1, l.view(B, 1, 1).expand(B, 1, C))[:, 0, :]
    pe = col.gather(1, l[:, None])[:, 0]
    T, flip, pivrow_raw, pe, do_flip, do_pivot = _bound_moves(
        T, flip, ub, basis, factor, pivrow_raw, pe, e, l,
        wants_pivot, no_row, min_ratio, n=n)
    stalled = wants_pivot & no_row & ~do_flip
    T, w = _pivot_update(T, w, basis, factor, pivrow_raw, pe, e, l, do_pivot,
                         m=m, n=n, rule=rule)
    row_m = torch.arange(m, device=T.device)
    basis = torch.where(do_pivot[:, None] & (row_m[None, :] == l[:, None]),
                        e[:, None].to(torch.int32), basis)

    status = torch.where(infeasible, INFEASIBLE, status)
    status = torch.where(stalled & (phase == 2), UNBOUNDED, status)
    status = torch.where(stalled & (phase == 1), ITERATION_LIMIT, status)
    status = torch.where(p2_done, OPTIMAL, status)
    work = work + torch.stack([do_pivot & (phase == 1),
                               do_pivot & (phase == 2), do_flip],
                              dim=1).to(torch.int32)
    inc = active & ~p2_done & ~infeasible
    tel = s.tel
    if tel is not None:
        tel = tel_simplex_update(tel, inc=inc, in_phase1=phase == 1,
                                 do_pivot=do_pivot, do_flip=do_flip,
                                 degenerate=min_ratio <= 0.0)
    phase = torch.where(to_phase2, 2, phase)
    iters = iters + inc.to(torch.int32)
    return SimplexState(T, basis, phase, status.to(torch.int32), iters, w,
                        flip, ub, work, tel)


def simplex_step(state: SimplexState, *, n: int, m: int, tol: float,
                 feas_thr, rule: str = "dantzig", active=None) -> SimplexState:
    """One lockstep pivot on the **full** (B, m+2, n+2m+1) tableau, for the
    running LPs in ``active`` (all of them when None)."""
    return _step(state, n=n, m=m, tol=tol, feas_thr=feas_thr, rule=rule,
                 full=True, active=active)


def phase2_step(state: SimplexState, *, n: int, m: int, tol: float,
                rule: str = "dantzig", active=None) -> SimplexState:
    """One lockstep phase-2 pivot on the **compacted** (B, m+1, n+m+1)
    tableau: the same pivots ``simplex_step`` would make, on fewer
    entries."""
    return _step(state, n=n, m=m, tol=tol, feas_thr=None, rule=rule,
                 full=False, active=active)


def tableau_elements(m: int, n: int, compacted: bool = False) -> int:
    """Logical tableau elements touched by one pivot's rank-1 update: the
    unit of the scheduler's executed-work record (``SegmentStat``)."""
    if compacted:
        return (m + 1) * (n + m + 1)
    return (m + 2) * (n + 2 * m + 1)


def flops_per_pivot(m: int, n: int, compacted: bool = False) -> int:
    """Approximate flops of one pivot across one tableau (Table-5-style
    Gflop/s accounting): the rank-1 update, 2 * rows * C, plus the two
    reductions and the row scale."""
    if compacted:
        rows, C = m + 1, n + m + 1
    else:
        rows, C = m + 2, n + 2 * m + 1
    return 2 * rows * C + (2 * C + 3 * m) + C


def compact_tableau(T: torch.Tensor, *, m: int, n: int) -> torch.Tensor:
    """One-shot phase compaction: drop the m artificial columns and the
    phase-1 row, (B, m+2, n+2m+1) -> (B, m+1, n+m+1).  Basic artificials
    left at zero stay in the basis (index >= n+m) and stay pinned."""
    return torch.cat([T[:, :m + 1, :n + m], T[:, :m + 1, -1:]], dim=2)


def extract_solution(T, basis, *, m: int, n: int, flip, ub):
    """(x, objective) off a final tableau (full or compacted): structural
    basics read their row's rhs, complemented columns map back to
    ``ub - x'``."""
    rhs = T[:, :m, -1]
    x = torch.zeros((T.shape[0], n), dtype=T.dtype, device=T.device)
    x.scatter_add_(1, basis.clamp(max=n - 1).long(),
                   torch.where(basis < n, rhs, 0.0))
    x = torch.where(flip, ub.to(x.dtype) - x, x)
    return x, -T[:, m, -1]


def extract_duals(T, *, m: int, n: int, flip):
    """Dual certificate off the phase-2 objective row: slack entries are
    -y, structural entries the reduced costs z (sign-flipped on
    complemented columns)."""
    y = -T[:, m, n:n + m]
    z = T[:, m, :n]
    return y, torch.where(flip, -z, z)


def warm_tableau(A, b, c, ub, *, m: int, n: int, feas_tol: float, rule: str,
                 warm_basis=None, warm_at_upper=None, warm_weights=None):
    """The starting tableau batch: cold (``build_tableau_torch``), or with
    ``warm_basis`` seeded per LP from the parent basis
    (``inject_tableau_warm``; an LP whose basis is unusable keeps the cold
    tableau).  ``warm_weights`` (width >= n+m) overlays carried devex
    weights where the injection held.  Returns
    ``(T, basis, phase, flip, w)``."""
    B, dev = A.shape[0], A.device
    T, basis, phase = build_tableau_torch(A, b, c)
    flip = torch.zeros((B, n), dtype=torch.bool, device=dev)
    ok = None
    if warm_basis is not None:
        wfl = (flip if warm_at_upper is None
               else torch.as_tensor(warm_at_upper, dtype=torch.bool,
                                    device=dev))
        T_w, basis_w, phase_w, flip_w, ok = inject_tableau_warm(
            A, b, c, ub, torch.as_tensor(warm_basis, device=dev), wfl,
            m=m, n=n, feas_tol=feas_tol)
        T = torch.where(ok[:, None, None], T_w, T)
        basis = torch.where(ok[:, None], basis_w, basis)
        phase = torch.where(ok, phase_w, phase)
        flip = torch.where(ok[:, None], flip_w, flip)
    w = init_weights(rule, T, m)
    if ok is not None and warm_weights is not None:
        ww = torch.as_tensor(warm_weights, dtype=w.dtype, device=dev)
        w = w.clone()
        w[:, :n + m] = torch.where(ok[:, None], ww[:, :n + m], w[:, :n + m])
    return T, basis, phase, flip, w


def solve_two_phase(A, b, c, ub=None, *, m: int, n: int, max_iters: int,
                    tol: float, feas_tol: float, pricing: str = "dantzig",
                    full_state: bool = False, work=None, warm_basis=None,
                    warm_at_upper=None, warm_weights=None,
                    telemetry: bool = False):
    """Two-phase solve of a float32 batch already on its device.

    Returns ``(x, obj, status, iters, y, z)``, ``(basis, flip, w)`` after
    them when ``full_state`` and the ``TelemetryState`` last when
    ``telemetry``; objectives and duals are NaN off OPTIMAL.  ``work``, a
    (B, 3) int32 tensor when given, is overwritten with each LP's phase-1
    pivots, phase-2 pivots and bound flips.
    ``warm_basis`` (B, m) and ``warm_at_upper`` (B, n) seed the solve from
    a parent basis (``warm_tableau``); ``warm_weights`` overlays carried
    devex weights."""
    rule = canonicalize_rule(pricing)
    B = A.shape[0]
    if ub is None:
        ub = torch.full((B, n), torch.inf, dtype=A.dtype, device=A.device)
    T, basis, phase, flip, w = warm_tableau(
        A, b, c, ub, m=m, n=n, feas_tol=feas_tol, rule=rule,
        warm_basis=warm_basis, warm_at_upper=warm_at_upper,
        warm_weights=warm_weights)
    # phase-1 feasibility threshold, relative to the initial infeasibility
    feas_thr = feas_tol * torch.clamp(T[:, m + 1, -1], min=1.0)
    s = SimplexState(
        T=T, basis=basis, phase=phase,
        status=torch.full((B,), _RUNNING, dtype=torch.int32, device=A.device),
        iters=torch.zeros((B,), dtype=torch.int32, device=A.device),
        w=w, flip=flip,
        ub=ub, work=torch.zeros((B, 3), dtype=torch.int32, device=A.device),
        tel=init_telemetry(B, A.device) if telemetry else None)

    it = 0
    while it < max_iters and bool(((s.status == _RUNNING)
                                   & (s.phase == 1)).any()):
        s = simplex_step(s, n=n, m=m, tol=tol, feas_thr=feas_thr, rule=rule)
        it += 1
    status = torch.where((s.status == _RUNNING) & (s.phase == 1),
                         ITERATION_LIMIT, s.status)
    s = s._replace(T=compact_tableau(s.T, m=m, n=n), status=status,
                   w=compact_weights(s.w, m=m, n=n))
    while it < max_iters and bool((s.status == _RUNNING).any()):
        s = phase2_step(s, n=n, m=m, tol=tol, rule=rule)
        it += 1
    status = torch.where(s.status == _RUNNING, ITERATION_LIMIT, s.status)

    x, obj = extract_solution(s.T, s.basis, m=m, n=n, flip=s.flip, ub=s.ub)
    y, z = extract_duals(s.T, m=m, n=n, flip=s.flip)
    opt = status == OPTIMAL
    if work is not None:
        work.copy_(s.work)
    out = (x, torch.where(opt, obj, torch.nan), status.to(torch.int8),
           s.iters, torch.where(opt[:, None], y, torch.nan),
           torch.where(opt[:, None], z, torch.nan))
    if full_state:
        out = out + (s.basis, s.flip, s.w)
    if telemetry:
        out = out + (s.tel,)
    return out


def default_tolerances(tol=None, feas_tol=None):
    """The float32 defaults of the reference engine: (1e-6, 1e-5)."""
    return (1e-6 if tol is None else float(tol),
            1e-5 if feas_tol is None else float(feas_tol))


def batch_tensors(batch: LPBatch, device):
    """(A, b, c, ub) of a canonical batch as float32 tensors on ``device``."""
    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)
    return (put(batch.A), put(batch.b), put(batch.c),
            put(batch.upper_bounds()))


def warm_basis_arrays(warm: WarmStart | None) -> dict:
    """The ``warm_basis``/``warm_at_upper`` arguments of a validated
    carrier (none when it carries no basis)."""
    if warm is None or warm.basis is None:
        return dict(warm_basis=None, warm_at_upper=None)
    return dict(warm_basis=np.asarray(warm.basis).astype(np.int32),
                warm_at_upper=None if warm.at_upper is None
                else np.asarray(warm.at_upper).astype(bool))


def warm_arrays(warm: WarmStart | None, rule: str, m: int, n: int) -> dict:
    """``warm_basis_arrays`` plus ``warm_weights``.  Carried weights mean
    something only to devex (steepest edge recomputes them exactly,
    dantzig and partial never read them), so only a devex carrier of width
    >= n+m hands them on."""
    out = dict(warm_basis_arrays(warm), warm_weights=None)
    if (out["warm_basis"] is not None and rule == "devex"
            and warm.pricing == rule and warm.weights is not None
            and np.asarray(warm.weights).shape[1] >= n + m):
        out["warm_weights"] = np.array(warm.weights, dtype=np.float32)
    return out


def solve_batched_torch(batch: LPBatch, *, device=None, tol: float | None = None,
                        feas_tol: float | None = None,
                        max_iters: int | None = None,
                        pricing: str = "dantzig",
                        presolve: bool = True, scale: bool | None = None,
                        warm: WarmStart | None = None,
                        telemetry: bool = False, tracer=None) -> LPResult:
    """Solve a batch with the plain PyTorch engine, in float32 on
    ``device`` (CUDA unless ``device="cpu"``).  Counterpart of
    ``repro.core.simplex.solve_batched_jax``: a ``GeneralLPBatch`` is
    canonicalized on ingestion and recovered on the way out, and the result
    carries the terminal ``WarmStart`` capture (basis, flips, weights).
    ``warm`` re-injects a previous solve's capture (validated by
    ``forms.prepare_warm``; skip, repair or cold per LP); its weights are
    reused only under devex, as in the reference.  ``telemetry=True``
    counts per-LP work into ``LPResult.stats`` (``obs.SolveReport``);
    ``tracer`` (an ``obs.SpanTracer``) records the canonicalize, dispatch
    and recover spans."""
    with maybe_span(tracer, "canonicalize"):
        batch, rec = ensure_canonical(batch, presolve=presolve, scale=scale)
    dev = resolve_device(device)
    m, n = batch.m, batch.n
    rule = canonicalize_rule(pricing)
    tol, feas_tol = default_tolerances(tol, feas_tol)
    if max_iters is None:
        max_iters = default_max_iters(m, n)
    warm = prepare_warm(warm, rec, batch)
    t0 = time.perf_counter()
    with maybe_span(tracer, "dispatch", backend="tableau", B=batch.batch,
                    m=m, n=n):
        A, b, c, ub = batch_tensors(batch, dev)
        out = solve_two_phase(
            A, b, c, ub, m=m, n=n, max_iters=int(max_iters), tol=tol,
            feas_tol=feas_tol, pricing=rule, full_state=True,
            telemetry=telemetry, **warm_arrays(warm, rule, m, n))
        x, obj, status, iters, y, z, basis, flip, w = out[:9]
        host = lambda t: t.cpu().numpy()  # noqa: E731
        capture = WarmStart(m=m, n=n, basis=host(basis), at_upper=host(flip),
                            weights=host(w), pricing=rule)
        res = LPResult(x=host(x), objective=host(obj), status=host(status),
                       iterations=host(iters), y=host(y), z=host(z),
                       warm=capture,
                       stats=solve_report(out[9] if telemetry else None, t0,
                                          "tableau", tracer))
    with maybe_span(tracer, "recover"):
        return finish_result(rec, res)


def solve_report(tel, t0: float, backend: str, tracer=None):
    """The ``obs.SolveReport`` of a solve that started at ``t0``
    (``time.perf_counter``) from its final counter lanes, with the
    tracer's span tree; None when ``tel`` is None (telemetry off)."""
    if tel is None:
        return None
    counters = tel_to_numpy(tel)
    return report_from_counters(
        counters, wall_s=time.perf_counter() - t0, backend=backend,
        spans=tuple(tracer.roots) if tracer is not None else ())
