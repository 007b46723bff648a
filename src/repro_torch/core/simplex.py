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

Warm-start injection is not ported yet: ``warm=`` raises.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .forms import ensure_canonical, finish_result
from .fp import fma
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
          rule: str, full: bool) -> SimplexState:
    """One lockstep step across the batch (masked for inactive LPs): on the
    full tableau (``full=True``, both phases) or on the phase-compacted one
    (phase 2 only, every running LP is in phase 2 there)."""
    T, basis, phase, status, iters, w, flip, ub, work = s
    B, rows, C = T.shape
    active = status == _RUNNING
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
    phase = torch.where(to_phase2, 2, phase)
    inc = active & ~p2_done & ~infeasible
    iters = iters + inc.to(torch.int32)
    return SimplexState(T, basis, phase, status.to(torch.int32), iters, w,
                        flip, ub, work)


def simplex_step(state: SimplexState, *, n: int, m: int, tol: float,
                 feas_thr, rule: str = "dantzig") -> SimplexState:
    """One lockstep pivot on the **full** (B, m+2, n+2m+1) tableau."""
    return _step(state, n=n, m=m, tol=tol, feas_thr=feas_thr, rule=rule,
                 full=True)


def phase2_step(state: SimplexState, *, n: int, m: int, tol: float,
                rule: str = "dantzig") -> SimplexState:
    """One lockstep phase-2 pivot on the **compacted** (B, m+1, n+m+1)
    tableau: the same pivots ``simplex_step`` would make, on fewer
    entries."""
    return _step(state, n=n, m=m, tol=tol, feas_thr=None, rule=rule,
                 full=False)


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


def solve_two_phase(A, b, c, ub=None, *, m: int, n: int, max_iters: int,
                    tol: float, feas_tol: float, pricing: str = "dantzig",
                    full_state: bool = False, work=None):
    """Two-phase solve of a float32 batch already on its device.

    Returns ``(x, obj, status, iters, y, z)``, and ``(basis, flip, w)``
    after them when ``full_state``; objectives and duals are NaN off
    OPTIMAL.  ``work``, a (B, 3) int32 tensor when given, is overwritten
    with each LP's phase-1 pivots, phase-2 pivots and bound flips."""
    rule = canonicalize_rule(pricing)
    B = A.shape[0]
    if ub is None:
        ub = torch.full((B, n), torch.inf, dtype=A.dtype, device=A.device)
    T, basis, phase = build_tableau_torch(A, b, c)
    # phase-1 feasibility threshold, relative to the initial infeasibility
    feas_thr = feas_tol * torch.clamp(T[:, m + 1, -1], min=1.0)
    s = SimplexState(
        T=T, basis=basis, phase=phase,
        status=torch.full((B,), _RUNNING, dtype=torch.int32, device=A.device),
        iters=torch.zeros((B,), dtype=torch.int32, device=A.device),
        w=init_weights(rule, T, m),
        flip=torch.zeros((B, n), dtype=torch.bool, device=A.device),
        ub=ub, work=torch.zeros((B, 3), dtype=torch.int32, device=A.device))

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


def solve_batched_torch(batch: LPBatch, *, device=None, tol: float | None = None,
                        feas_tol: float | None = None,
                        max_iters: int | None = None,
                        pricing: str = "dantzig",
                        presolve: bool = True, scale: bool | None = None,
                        warm: WarmStart | None = None) -> LPResult:
    """Solve a batch with the plain PyTorch engine, in float32 on
    ``device`` (CUDA unless ``device="cpu"``).  Counterpart of
    ``repro.core.simplex.solve_batched_jax``: a ``GeneralLPBatch`` is
    canonicalized on ingestion and recovered on the way out, and the result
    carries the terminal ``WarmStart`` capture (basis, flips, weights)."""
    if warm is not None:
        raise NotImplementedError(
            "warm-start injection is not ported to repro_torch yet "
            "(ROADMAP.md, queue 1: warm starts)")
    batch, rec = ensure_canonical(batch, presolve=presolve, scale=scale)
    dev = resolve_device(device)
    m, n = batch.m, batch.n
    rule = canonicalize_rule(pricing)
    tol, feas_tol = default_tolerances(tol, feas_tol)
    if max_iters is None:
        max_iters = default_max_iters(m, n)
    A, b, c, ub = batch_tensors(batch, dev)
    x, obj, status, iters, y, z, basis, flip, w = solve_two_phase(
        A, b, c, ub, m=m, n=n, max_iters=int(max_iters), tol=tol,
        feas_tol=feas_tol, pricing=rule, full_state=True)
    host = lambda t: t.cpu().numpy()  # noqa: E731
    capture = WarmStart(m=m, n=n, basis=host(basis), at_upper=host(flip),
                        weights=host(w), pricing=rule)
    res = LPResult(x=host(x), objective=host(obj), status=host(status),
                   iterations=host(iters), y=host(y), z=host(z), warm=capture)
    return finish_result(rec, res)
