"""Batched revised simplex in PyTorch: the port's revised engine and the
plain version of the CUDA kernel (kernels/csrc/revised_tile.cu).

Counterpart of ``repro.core.revised`` with the representation of the
reference's tile kernel (``repro.kernels.revised_tile``), not of its engine:
the constraint data ``Abar`` (B, m, n+2m) is immutable (structurals,
slacks, artificials, sign-adjusted rows: the tableau's column layout, so
bases, statuses and extraction mean the same as in the tableau engine) and
each LP keeps a dense basis inverse ``Binv`` (m, m).  A pivot runs

1. BTRAN: ``y = Binv^T c_B``;
2. pricing: ``d_j = c_j - y . a_j`` over the n+m candidates, Dantzig or
   partial (a rotating block of ``PARTIAL_BLOCK`` columns, the full set
   only when the block prices out);
3. FTRAN: ``u = Binv a_e``, then the sentinel ratio test with bounded
   columns: a bound flip, a pivot or a terminal status;
4. on a pivot the eta update ``Binv <- E Binv`` (the pivot row of ``Binv``
   divided by ``u_l``, every other row minus ``u_i`` times it) and the
   basic values.

The reference's tile kernel keeps ``Binv`` fixed for a segment and appends
each eta column to a file that BTRAN and FTRAN replay.  Here each eta is
applied to ``Binv`` as it arrives: BTRAN would otherwise replay the file as
a chain of K dot products, each summed in a fixed order by one thread, and
the plain version would need K * m sequential tensor calls per pivot to
match it bit for bit.  The eta clock stays: after K = ``refactor_period``
pivots, and at the start of every segment, an LP refactorizes (``Binv``
from ``_gauss_solve`` on its basis matrix), as the tile kernel's host does
between launches.  **The clock is per LP**: each LP counts its own pivots.
The reference's engine shares one clock across the batch (``cnt +=
any(do_pivot)``) and its tile kernel one across a tile; at ``tile_b=1`` the
tile kernel's schedule is this one.  So the port's revised results do not
depend on the batch: chunked equal unchunked bit for bit.

Every dot product is ``core.fp.sum_products``: exact products added in
index order in float64, rounded once to float32, as the kernel sums them;
every ``a - b * c`` update rounds once (``core.fp.fma``, ``__fmaf_rn`` in
the kernel).  So kernel and plain version agree bit for bit.  Against the
reference (LU and triangular solves, or the tile kernel's host inverse,
all summed in float32) statuses and iterations agree and objectives to
f32 rounding.

``RevisedBackend`` runs the engine's segments under the compaction
scheduler (core/compaction.py); every segment starts from a fresh
factorization, so a bucket gather is followed by a refactorization
(refactor-on-compact) as in the reference.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..obs.telemetry import (TelemetryState, init_telemetry,
                             tel_revised_update, tel_simplex_update)
from ..obs.trace import maybe_span
from .compaction import (
    STAGES,
    SegmentStat,
    TorchBackend,
    schedule_batch,
    segment_pending,
)
from .forms import ensure_canonical, finish_result, prepare_warm
from .fp import fma, rowsum, sum_products
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
    partial_geometry,
    partial_priced_candidates,
)
from .simplex import (
    _RUNNING,
    _gauss_solve,
    _take,
    batch_tensors,
    default_tolerances,
    solve_report,
    warm_basis_arrays,
)

# Pricing rules of the revised engine: steepest edge and devex need the
# dense tableau the revised method exists to avoid.
REVISED_RULES = ("dantzig", "partial")
# Per-LP work counters of a revised solve, in this order: steps taken,
# pivots, bound flips, refactorizations, candidate columns priced.
WORK_FIELDS = ("steps", "pivots", "flips", "refactors", "priced")
_STEPS, _PIVOTS, _FLIPS, _REFACTORS, _PRICED = range(len(WORK_FIELDS))


def canonicalize_revised_rule(pricing: str) -> str:
    rule = canonicalize_rule(pricing)
    if rule not in REVISED_RULES:
        raise ValueError(
            f"pricing rule {rule!r} is tableau-only; the revised backend "
            f"supports {REVISED_RULES} (steepest-edge/devex weights need "
            "the dense tableau the revised method exists to avoid)")
    return rule


def auto_refactor_period(m: int, n: int) -> int:
    """Pivots between refactorizations when ``refactor_period=None``:
    about m/2, clamped to [4, 64] (the reference's rule)."""
    return max(4, min(64, m // 2))


def revised_elements(m: int, n: int, *, refactor_period: int | None = None,
                     partial: bool = False, block: int | None = None) -> int:
    """State elements one revised pivot writes, in the scheduler's
    executed-work unit: the BTRAN and FTRAN vectors, the basic values and
    one eta (4m), the priced reduced costs, and the refactorization (2m^2
    every K pivots), as the reference counts them."""
    K = refactor_period or auto_refactor_period(m, n)
    priced = partial_priced_candidates(n + m, block, partial=partial)
    return int(4 * m + priced + (2 * m * m) // K)


class RevisedState(NamedTuple):
    """Resumable revised-simplex state; every leaf has the batch on axis 0,
    so a bucket gather is one ``index_select`` per leaf.  The basis inverse
    is not part of it: every segment refactorizes at its start."""
    Abar: torch.Tensor    # (B, m, n+2m) f32 sign-adjusted columns; only a
                          #  warm repair writes them (its artificials)
    cvec: torch.Tensor    # (B, n+m) f32 phase-2 costs of the candidates
    ub: torch.Tensor      # (B, n) f32 upper bounds (+inf = none)
    thr: torch.Tensor     # (B,) f32 phase-1 feasibility threshold
    xB: torch.Tensor      # (B, m) f32 basic values
    basis: torch.Tensor   # (B, m) int32 column basic in each row
    onub: torch.Tensor    # (B, n) bool nonbasic structural at its upper
                          #  bound
    phase: torch.Tensor   # (B,) int32
    status: torch.Tensor  # (B,) int32, _RUNNING until terminal
    iters: torch.Tensor   # (B,) int32
    y: torch.Tensor       # (B, m) f32 c_B Binv (phase-2 costs, sign-
                          #  adjusted rows) after the LP's last segment
    work: torch.Tensor    # (B, 5) int32, WORK_FIELDS
    tel: Optional[TelemetryState] = None  # counter lanes, or None with
                                          #  telemetry off


def build_revised_state(A, b, c, ub=None, *, feas_tol: float) -> RevisedState:
    """Cold state: the tableau's column layout with sign-adjusted rows and
    the slack/artificial starting basis (its basis matrix is I)."""
    B, m, n = A.shape
    dtype, dev = A.dtype, A.device
    neg = b < 0
    sign = torch.where(neg, -1.0, 1.0).to(dtype)
    idx = torch.arange(m, device=dev)
    Abar = torch.zeros((B, m, n + 2 * m), dtype=dtype, device=dev)
    Abar[:, :, :n] = A * sign[:, :, None]
    Abar[:, idx, n + idx] = sign
    Abar[:, idx, n + m + idx] = neg.to(dtype)
    bbar = b * sign
    cvec = torch.cat([c, torch.zeros((B, m), dtype=dtype, device=dev)], dim=1)
    basis = torch.where(neg, n + m + idx[None, :], n + idx[None, :])
    # the tableau's phase-1 threshold: the initial infeasibility mass
    thr = feas_tol * torch.clamp(rowsum(torch.where(neg, bbar, 0.0)),
                                 min=1.0)
    if ub is None:
        ub = torch.full((B, n), torch.inf, dtype=dtype, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return RevisedState(
        Abar=Abar, cvec=cvec, ub=ub.to(dtype).contiguous(), thr=thr,
        xB=bbar.contiguous(), basis=basis.to(torch.int32),
        onub=torch.zeros((B, n), dtype=torch.bool, device=dev),
        phase=torch.where(neg.any(dim=1), 1, 2).to(torch.int32),
        status=torch.full((B,), _RUNNING, **i32),
        iters=torch.zeros((B,), **i32),
        y=torch.zeros((B, m), dtype=dtype, device=dev),
        work=torch.zeros((B, len(WORK_FIELDS)), **i32))


def inject_revised_warm(state: RevisedState, wb, wonub, *, m: int, n: int,
                        feas_tol: float) -> RevisedState:
    """Seed a cold ``RevisedState`` from a parent basis, per LP, as the
    reference's ``inject_revised_warm``:

    * **skip**: solve the parent basis against the new data; all basic
      values nonnegative means phase 2 starts from the parent vertex
      (at-upper nonbasics enter through the effective rhs);
    * **repair**: rows whose basic value went negative get a fresh
      artificial whose column is ``-(B e_i)``; its basic value is
      ``|x_B_i|`` and phase 1 drives it out;
    * **cold**: out-of-range indices or a singular basis matrix (a
      non-finite ``_gauss_solve``): the LP keeps the cold state.

    Parent artificials map to their row's slack.  The slack diagonal (the
    row signs extraction reads) is never overwritten."""
    Abar, ub = state.Abar, state.ub
    B, dev = Abar.shape[0], Abar.device
    ncand = n + m
    idx = torch.arange(m, device=dev)
    wb = torch.as_tensor(np.asarray(wb), device=dev).to(torch.int64)
    wonub = torch.as_tensor(np.asarray(wonub), device=dev).to(torch.bool)
    in_range = ((wb >= 0) & (wb < n + 2 * m)).all(dim=1)
    wb2 = torch.where(wb >= ncand, wb - m, wb).clamp(0, ncand - 1)
    onub_w = wonub & torch.isfinite(ub)
    bbar = state.xB                      # cold state: xB is the signed b
    ubz = torch.where(onub_w, ub, 0.0)
    rhs_eff = bbar - sum_products(Abar[:, :, :n], ubz[:, None, :], -1)
    Bcols = Abar.gather(2, wb2[:, None, :].expand(B, m, m))
    xB = _gauss_solve(Bcols, rhs_eff[:, :, None])[:, :, 0]
    ok = in_range & torch.isfinite(xB).all(dim=1)
    eps = feas_tol * torch.clamp(bbar.abs().amax(dim=1), min=1.0)
    viol = xB < -eps[:, None]

    art_w = torch.where(viol[:, None, :], -Bcols, Abar[:, :, ncand:])
    Abar_w = torch.cat([Abar[:, :, :ncand], art_w], dim=2)
    basis_w = torch.where(viol, ncand + idx[None, :], wb2).to(torch.int32)
    xB_w = torch.where(viol, -xB, xB)
    phase_w = torch.where(viol.any(dim=1), 1, 2).to(torch.int32)
    thr_w = feas_tol * torch.clamp(rowsum(torch.where(viol, -xB, 0.0)),
                                   min=1.0)
    ok2 = ok[:, None]
    return state._replace(
        Abar=torch.where(ok[:, None, None], Abar_w, Abar),
        xB=torch.where(ok2, xB_w, state.xB),
        basis=torch.where(ok2, basis_w, state.basis),
        phase=torch.where(ok, phase_w, state.phase),
        onub=torch.where(ok2, onub_w, state.onub),
        thr=torch.where(ok, thr_w, state.thr))


def warm_state(A, b, c, ub, *, m: int, n: int, feas_tol: float,
               warm_basis=None, warm_at_upper=None) -> RevisedState:
    """``build_revised_state``, then ``inject_revised_warm`` when a parent
    basis is given."""
    state = build_revised_state(A, b, c, ub, feas_tol=feas_tol)
    if warm_basis is None:
        return state
    if warm_at_upper is None:
        warm_at_upper = np.zeros((A.shape[0], n), bool)
    return inject_revised_warm(state, warm_basis, warm_at_upper, m=m, n=n,
                               feas_tol=feas_tol)


def refactorize(Abar: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Dense inverse of each LP's basis matrix, gathered from ``Abar``:
    ``_gauss_solve`` against the identity."""
    B, m, _ = Abar.shape
    Bmat = Abar.gather(2, basis.long()[:, None, :].expand(B, m, m))
    eye = torch.eye(m, dtype=Abar.dtype, device=Abar.device).expand(B, m, m)
    return _gauss_solve(Bmat, eye)


def phase2_costs(state: RevisedState, ncand: int) -> torch.Tensor:
    """c_B under the phase-2 costs: cvec of a basic candidate, 0 for a
    basic artificial."""
    got = state.cvec.gather(1, state.basis.clamp(max=ncand - 1).long())
    return torch.where(state.basis < ncand, got, 0.0)


def _nonneg(v: torch.Tensor) -> torch.Tensor:
    """v where it is positive, else 0 (NaN and -0 included)."""
    return torch.where(v > 0, v, 0.0)


def _step(s: RevisedState, Binv, cnt, act, *, m: int, n: int, tol: float,
          K: int, rule: str):
    """One revised step for the LPs in ``act`` (running, pending in the
    segment's stage, under their cap); every other LP keeps every leaf,
    its ``Binv`` and its eta clock ``cnt`` bit for bit.  Returns
    ``(state, Binv, cnt)``."""
    B, dev = s.xB.shape[0], s.xB.device
    ncand = n + m
    work = s.work.clone()
    # ---- refactor when the eta clock is due (always at segment start) -----
    due = act & (cnt >= K)
    if bool(due.any()):
        sel = torch.nonzero(due)[:, 0]
        Binv = Binv.clone()
        Binv[sel] = refactorize(s.Abar[sel], s.basis[sel])
        cnt = torch.where(due, 0, cnt)
        work[:, _REFACTORS] += due.to(torch.int32)

    # ---- BTRAN + pricing ---------------------------------------------------
    in_p1 = s.phase == 1
    in_p2 = s.phase == 2
    is_art = s.basis >= ncand
    cB = torch.where(in_p1[:, None], -is_art.to(s.xB.dtype),
                     phase2_costs(s, ncand))
    y = sum_products(Binv, cB[:, :, None], 1)
    d = torch.where(in_p2[:, None], s.cvec, 0.0) \
        - sum_products(s.Abar[:, :, :ncand], y[:, :, None], 1)
    onub_pad = torch.cat([s.onub, torch.zeros((B, m), dtype=torch.bool,
                                              device=dev)], dim=1)
    d = torch.where(onub_pad, -d, d)
    basic = torch.zeros((B, ncand + 1), dtype=torch.bool, device=dev)
    basic.scatter_(1, s.basis.clamp(max=ncand).long(), True)
    d = torch.where(basic[:, :ncand], -BIG, d)
    e = d.argmax(dim=1)
    max_cost = d.gather(1, e[:, None])[:, 0]
    priced = torch.full((B,), ncand, dtype=torch.int32, device=dev)
    rotated = None
    if rule == "partial":
        n_blocks, bs = partial_geometry(ncand)
        blk = s.iters.long() % n_blocks
        cols = torch.arange(ncand, device=dev)
        in_blk = (cols // bs)[None, :] == blk[:, None]
        d_blk = torch.where(in_blk, d, -BIG)
        e_blk = d_blk.argmax(dim=1)
        blk_max = d_blk.gather(1, e_blk[:, None])[:, 0]
        improving = blk_max > tol
        e = torch.where(improving, e_blk, e)
        max_cost = torch.where(improving, blk_max, max_cost)
        priced = torch.where(improving, in_blk.sum(dim=1).to(torch.int32),
                             priced)
        rotated = act & ~improving
    is_opt = max_cost <= tol
    p1_done = act & in_p1 & is_opt
    infeasible = torch.zeros_like(act)
    if bool(p1_done.any()):
        p1_obj = rowsum(torch.where(is_art, s.xB, 0.0))
        infeasible = p1_done & (p1_obj > s.thr)
    to_phase2 = p1_done & ~infeasible
    p2_done = act & in_p2 & is_opt
    wants = act & ~is_opt

    # ---- FTRAN + sentinel ratio test ---------------------------------------
    a_e = s.Abar.gather(2, e.view(B, 1, 1).expand(B, m, 1))[:, :, 0]
    u = sum_products(Binv, a_e[:, None, :], -1)
    onub_e = onub_pad.gather(1, e[:, None])[:, 0]
    ucol = torch.where(onub_e[:, None], -u, u)
    xB = s.xB
    # a basic value a rounding put below its bound counts as at the bound:
    # a negative ratio would step backwards and lose the basis
    valid = ucol > tol
    ratios = torch.where(valid, _nonneg(xB) / torch.where(valid, ucol, 1.0),
                         BIG)
    ubB = _take(s.ub, s.basis, n)
    hit = (ucol < -tol) & torch.isfinite(ubB)
    ratios = torch.where(hit, _nonneg(ubB - xB)
                         / torch.where(hit, -ucol, 1.0), ratios)
    # phase 2 pins basic artificials at zero
    pin = in_p2[:, None] & is_art & (ucol < -tol)
    ratios = torch.where(pin, 0.0, ratios)
    l = ratios.argmin(dim=1)
    min_ratio = ratios.gather(1, l[:, None])[:, 0]
    no_row = min_ratio >= BIG / 2
    t_e = _take(s.ub, e[:, None], n)[:, 0]
    do_flip = wants & (t_e < min_ratio)
    stalled = wants & no_row & ~do_flip
    do_pivot = wants & ~no_row & ~do_flip

    # ---- update: basic values, bound flags, Binv, basis --------------------
    move = do_flip | do_pivot
    theta = torch.where(do_flip, t_e, torch.where(do_pivot, min_ratio, 0.0))
    enter_val = torch.where(onub_e, t_e - min_ratio, min_ratio)
    rows = torch.arange(m, device=dev)
    is_l = rows[None, :] == l[:, None]
    xB_new = torch.where(is_l & do_pivot[:, None], enter_val[:, None],
                         fma(-theta[:, None], ucol, xB))
    xB = torch.where(move[:, None], xB_new, xB)

    col_n = torch.arange(n, device=dev)
    is_e_n = col_n[None, :] == e[:, None]
    onub = s.onub ^ (do_flip[:, None] & is_e_n)
    onub = onub & ~(do_pivot[:, None] & is_e_n)
    jl = s.basis.gather(1, l[:, None])[:, 0]
    leave_up = do_pivot & hit.gather(1, l[:, None])[:, 0] & (jl < n)
    onub = onub | (leave_up[:, None] & (col_n[None, :] == jl[:, None]))

    ul = torch.where(do_pivot, u.gather(1, l[:, None])[:, 0], 1.0)
    pivrow = Binv.gather(1, l.view(B, 1, 1).expand(B, 1, m))[:, 0, :] \
        / ul[:, None]
    Binv_new = fma(-u[:, :, None], pivrow[:, None, :], Binv)
    Binv_new = torch.where(is_l[:, :, None], pivrow[:, None, :], Binv_new)
    Binv = torch.where(do_pivot[:, None, None], Binv_new, Binv)
    basis = torch.where(do_pivot[:, None] & is_l, e[:, None].to(torch.int32),
                        s.basis)
    cnt = cnt + do_pivot.to(torch.int32)

    status = torch.where(infeasible, INFEASIBLE, s.status)
    status = torch.where(stalled & in_p2, UNBOUNDED, status)
    status = torch.where(stalled & in_p1, ITERATION_LIMIT, status)
    status = torch.where(p2_done, OPTIMAL, status)
    inc = act & ~p2_done & ~infeasible
    work[:, _STEPS] += act.to(torch.int32)
    work[:, _PIVOTS] += do_pivot.to(torch.int32)
    work[:, _FLIPS] += do_flip.to(torch.int32)
    work[:, _PRICED] += torch.where(act, priced, 0)
    tel = s.tel
    if tel is not None:
        tel = tel_simplex_update(tel, inc=inc, in_phase1=in_p1,
                                 do_pivot=do_pivot, do_flip=do_flip,
                                 degenerate=min_ratio <= 0.0)
        tel = tel_revised_update(
            tel, refactor=due, eta_len=torch.where(act, cnt, tel.eta_len),
            block_rotation=rotated)
    state = s._replace(
        xB=xB, basis=basis, onub=onub,
        phase=torch.where(to_phase2, 2, s.phase).to(torch.int32),
        status=status.to(torch.int32),
        iters=s.iters + inc.to(torch.int32), work=work, tel=tel)
    return state, Binv, cnt


def revised_segment(state: RevisedState, steps: int, *, stage: str, m: int,
                    n: int, max_iters: int, tol: float, refactor_period: int,
                    rule: str = "dantzig"):
    """At most ``steps`` revised steps of ``stage`` per LP, the kernel's
    segment in torch.  An LP steps while ``segment_pending`` holds for it;
    its first step refactorizes, and so does every step that finds K
    pivots since the last refactorization.  Afterwards an LP still running
    at its cap (stage p1: in phase 1) is ITERATION_LIMIT, and one that
    stepped gets ``y = c_B Binv`` under the phase-2 costs.  Returns
    ``(state, it)`` with ``it`` the (B,) int32 steps each LP took; builds
    new tensors."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    K = int(refactor_period)
    B, dev = state.xB.shape[0], state.xB.device
    Binv = torch.zeros((B, m, m), dtype=state.xB.dtype, device=dev)
    cnt = torch.full((B,), K, dtype=torch.int32, device=dev)
    it = torch.zeros((B,), dtype=torch.int32, device=dev)
    s = state
    for _ in range(int(steps)):
        act = segment_pending(s, stage, max_iters)
        if not bool(act.any()):
            break
        s, Binv, cnt = _step(s, Binv, cnt, act, m=m, n=n, tol=tol, K=K,
                             rule=rule)
        it += act.to(torch.int32)
    capped = (s.status == _RUNNING) & (s.iters >= max_iters)
    if stage == "p1":
        capped &= s.phase == 1
    y = sum_products(Binv, phase2_costs(s, n + m)[:, :, None], 1)
    return s._replace(
        status=torch.where(capped, ITERATION_LIMIT, s.status).to(torch.int32),
        y=torch.where((it > 0)[:, None], y, s.y)), it


def extract_revised(state: RevisedState, *, m: int, n: int):
    """``(x, obj, status, iters, y, z)`` off a revised state: x from the
    basic values plus the upper bounds of at-upper nonbasics, the
    objective and the reduced costs summed in index order, the row duals
    ``y`` with the row signs (the slack diagonal) taken off.  RUNNING reads
    as the iteration limit; objectives and duals are NaN off OPTIMAL."""
    B, dev = state.xB.shape[0], state.xB.device
    ncand = n + m
    struct = state.basis < n
    x = torch.zeros((B, n + 1), dtype=state.xB.dtype, device=dev)
    x.scatter_(1, torch.where(struct, state.basis, n).long(),
               torch.where(struct, state.xB, 0.0))
    at_ub = torch.where(state.onub, state.ub, 0.0)
    x = x[:, :n] + at_ub
    cb = torch.where(struct, phase2_costs(state, ncand), 0.0)
    obj = sum_products(torch.cat([cb, state.cvec[:, :n]], dim=1),
                       torch.cat([state.xB, at_ub], dim=1), 1)
    idx = torch.arange(m, device=dev)
    sign = state.Abar[:, idx, n + idx]
    y = sign * state.y
    z = state.cvec[:, :n] - sum_products(state.Abar[:, :, :n],
                                         state.y[:, :, None], 1)
    status = torch.where(state.status == _RUNNING, ITERATION_LIMIT,
                         state.status)
    opt = status == OPTIMAL
    return (x, torch.where(opt, obj, torch.nan), status.to(torch.int8),
            state.iters, torch.where(opt[:, None], y, torch.nan),
            torch.where(opt[:, None], z, torch.nan))


def solve_revised(A, b, c, ub=None, *, m: int, n: int, max_iters: int,
                  tol: float, feas_tol: float, refactor_period: int,
                  pricing: str = "dantzig", warm_basis=None,
                  warm_at_upper=None, segment=None, work=None,
                  telemetry: bool = False):
    """Whole revised solve of a float32 batch on its device: one segment of
    ``max_iters`` steps (``segment``, by default the plain
    ``revised_segment``; the kernel wrapper passes itself), then the
    extraction.  Returns ``(x, obj, status, iters, y, z, basis, onub)``,
    and the ``TelemetryState`` after them when ``telemetry``.  ``work``, a
    (B, 5) int32 tensor when given, receives WORK_FIELDS."""
    rule = canonicalize_revised_rule(pricing)
    state = warm_state(A, b, c, ub, m=m, n=n, feas_tol=feas_tol,
                       warm_basis=warm_basis, warm_at_upper=warm_at_upper)
    if telemetry:
        state = state._replace(tel=init_telemetry(A.shape[0], A.device))
    segment = revised_segment if segment is None else segment
    state, _ = segment(state, int(max_iters), stage="p2", m=m, n=n,
                       max_iters=int(max_iters), tol=tol,
                       refactor_period=int(refactor_period), rule=rule)
    if work is not None:
        work.copy_(state.work)
    out = extract_revised(state, m=m, n=n) + (state.basis, state.onub)
    return out + (state.tel,) if telemetry else out


def revised_result(out, *, m: int, n: int, rule: str, stats=None
                   ) -> LPResult:
    """The ``LPResult`` (NumPy, with its ``WarmStart`` capture) of a
    ``solve_revised`` tuple's first eight entries, carrying ``stats``."""
    host = lambda t: t.cpu().numpy()  # noqa: E731
    x, obj, status, iters, y, z, basis, onub = (host(t) for t in out[:8])
    return LPResult(x=x, objective=obj, status=status, iterations=iters,
                    y=y, z=z, warm=WarmStart(m=m, n=n, basis=basis,
                                             at_upper=onub, pricing=rule),
                    stats=stats)


def solve_batched_revised(batch: LPBatch, *, device=None,
                          tol: float | None = None,
                          feas_tol: float | None = None,
                          max_iters: int | None = None,
                          refactor_period: int | None = None,
                          pricing: str = "dantzig",
                          presolve: bool = True,
                          scale: bool | None = None,
                          warm: WarmStart | None = None,
                          telemetry: bool = False, tracer=None) -> LPResult:
    """Solve a batch with the plain revised engine, in float32 on
    ``device`` (CUDA unless ``device="cpu"``).  Counterpart of
    ``repro.core.revised.solve_batched_revised``: ``pricing`` is
    "dantzig" or "partial", ``refactor_period`` the eta clock (None:
    ``auto_refactor_period``), ``warm`` a parent's ``WarmStart`` (any
    basis-carrying engine's); the result carries its own capture.
    ``telemetry`` and ``tracer`` as in ``core.simplex.solve_batched_torch``."""
    with maybe_span(tracer, "canonicalize"):
        batch, rec = ensure_canonical(batch, presolve=presolve, scale=scale)
    dev = resolve_device(device)
    m, n = batch.m, batch.n
    rule = canonicalize_revised_rule(pricing)
    tol, feas_tol = default_tolerances(tol, feas_tol)
    if max_iters is None:
        max_iters = default_max_iters(m, n)
    K = refactor_period or auto_refactor_period(m, n)
    warm = prepare_warm(warm, rec, batch)
    t0 = time.perf_counter()
    with maybe_span(tracer, "dispatch", backend="revised", B=batch.batch,
                    m=m, n=n):
        A, b, c, ub = batch_tensors(batch, dev)
        out = solve_revised(A, b, c, ub, m=m, n=n, max_iters=int(max_iters),
                            tol=tol, feas_tol=feas_tol, refactor_period=K,
                            pricing=rule, telemetry=telemetry,
                            **warm_basis_arrays(warm))
        res = revised_result(out, m=m, n=n, rule=rule, stats=solve_report(
            out[8] if telemetry else None, t0, "revised", tracer))
    with maybe_span(tracer, "recover"):
        return finish_result(rec, res)


class RevisedBackend(TorchBackend):
    """Scheduler backend of the revised engine (the counterpart of the
    reference's ``RevisedBackend``): segments of ``revised_segment`` on
    any device; ``kernels.ops.RevisedKernelBackend`` runs the CUDA kernel
    instead.  There is nothing to phase-compact.  A gather is followed by
    a refactorization because every segment starts with one."""

    def __init__(self, m: int, n: int, tol: float, feas_tol: float,
                 pricing: str = "dantzig",
                 refactor_period: int | None = None):
        super().__init__(m, n, tol, feas_tol)
        self.rule = canonicalize_revised_rule(pricing)
        self.refactor_period = int(refactor_period
                                   or auto_refactor_period(m, n))

    def init(self, A, b, c, ub=None, warm: WarmStart | None = None,
             telemetry: bool = False):
        state = warm_state(A, b, c, ub, m=self.m, n=self.n,
                           feas_tol=self.feas_tol, **warm_basis_arrays(warm))
        if telemetry:
            state = state._replace(tel=init_telemetry(A.shape[0], A.device))
        return state

    def segment(self, state, steps: int, stage: str, max_iters: int):
        return revised_segment(state, steps, stage=stage, m=self.m, n=self.n,
                               max_iters=max_iters, tol=self.tol,
                               refactor_period=self.refactor_period,
                               rule=self.rule)

    def compact_columns(self, state: RevisedState) -> RevisedState:
        return state

    def extract(self, state: RevisedState, stage: str):
        return tuple(t.cpu().numpy()
                     for t in extract_revised(state, m=self.m, n=self.n))

    def elements_per_step(self, stage: str) -> int:
        return revised_elements(self.m, self.n,
                                refactor_period=self.refactor_period,
                                partial=self.rule == "partial")


def solve_batched_revised_compacted(
        batch: LPBatch, *, device=None, tol: Optional[float] = None,
        feas_tol: Optional[float] = None, max_iters: Optional[int] = None,
        segment_k: Optional[int] = None,
        compact_threshold: Optional[float] = None,
        refactor_period: Optional[int] = None, pricing: str = "dantzig",
        stats_out: Optional[List[SegmentStat]] = None,
        presolve: bool = True, scale: Optional[bool] = None,
        warm: WarmStart | None = None, telemetry: bool = False,
        tracer=None) -> LPResult:
    """The revised engine under the compaction scheduler, in float32 on
    ``device`` (CUDA unless ``device="cpu"``): segments of at most
    ``segment_k`` steps, survivor gathers between them.  Same contract as
    ``core.compaction.solve_batched_compacted`` (``telemetry`` and
    ``tracer`` included); ``warm`` seeds the initial state, and the result
    carries no warm-start capture."""
    with maybe_span(tracer, "canonicalize"):
        batch, rec = ensure_canonical(batch, presolve=presolve, scale=scale)
    dev = resolve_device(device)
    tol, feas_tol = default_tolerances(tol, feas_tol)
    runner = RevisedBackend(batch.m, batch.n, tol, feas_tol, pricing=pricing,
                            refactor_period=refactor_period)
    res = schedule_batch(runner, batch, dev, max_iters=max_iters,
                         segment_k=segment_k,
                         compact_threshold=compact_threshold,
                         stats_out=stats_out,
                         warm=prepare_warm(warm, rec, batch),
                         telemetry=telemetry, tracer=tracer)
    with maybe_span(tracer, "recover"):
        return finish_result(rec, res)
