"""Batched branch-and-bound: MIP trees as frontiers of warm-started LPs.

Counterpart of ``repro.core.branch_bound``, on the port's engines and
kernels: ``branch_and_bound`` runs on CUDA unless the caller passes
``device="cpu"`` (and raises when there is no card and no device was
given).  On the card every node relaxation goes through the CUDA kernels
(``solve_batched`` -> kernels/ops.py): the tableau engine through the
segment kernel (the warm path's combined stage, or a cold whole solve),
revised through the revised kernel, pdhg through the PDHG kernel; on the
CPU each runs its plain engine.  Selection, branching and fathoming are
the reference's rule for rule, so on the CPU the tableau and revised
engines give the reference's proven optima, node counts and LP-iteration
counts:

* **the frontier is one batch**: open nodes differ from the root only in
  ``lb``/``ub``, so a frontier canonicalizes through ``forms.rebind_bounds``
  (the root's canonical ``A``/``c``/scales, only the rhs, shift and native
  bounds recomputed) and is solved in one dispatch through
  ``solve_batched``.  Integer columns' bounds are forced into canonical
  rows (``canonicalize(bound_rows=mask)``), so a branch edits only ``b``;
* **children start warm**: each node keeps its parent's per-LP
  ``WarmStart`` slice (canonical coordinates) and the next dispatch
  re-injects the stacked carriers; the root and reset nodes ride along as
  cold carriers (``_cold_carrier``);
* **fathoming is certificate-driven**: INFEASIBLE prunes, an integral
  OPTIMAL relaxation updates the incumbent (its objective recomputed in
  float64 from the rounded point after a feasibility check), and bound
  pruning compares the relaxation bound with the incumbent.  For the exact
  engines the relaxation objective is the bound (less a float32 slack);
  PDHG's dual certificate ``LPResult.y`` goes through ``safe_dual_bound``,
  valid for any dual vector (``BackendSpec.supports_safe_bound``).

Two modes: ``mode="dispatch"`` (every backend) solves whole frontiers a
round through ``solve_batched(..., pad_to_bucket=True)``;
``mode="stream"`` (tableau only) drives the ``FrontierScheduler``
(core/compaction.py): fathomed nodes retire mid-batch and their children
are admitted into the freed lanes.  The driver is host-side NumPy;
``tracer`` (an ``obs.SpanTracer``) records one ``node`` event per
decision, a ``bnb_dispatch`` span per dispatch and, in stream mode, the
scheduler's spans and lane events.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..device import resolve_device
from ..obs.trace import maybe_span
from .batching import solve_batched
from .compaction import FrontierScheduler
from .forms import (GeneralLPBatch, Recovery, canonicalize, general_violation,
                    rebind_bounds)
from .lp import (INFEASIBLE, ITERATION_LIMIT, OPTIMAL, UNBOUNDED, LPResult,
                 WarmStart, backend_spec)

SEARCHES = ("best", "depth")
MODES = ("dispatch", "stream")


def safe_dual_bound(g: GeneralLPBatch, y: np.ndarray) -> np.ndarray:
    """A bound on each LP's optimal value that is valid for **any** row-dual
    vector ``y`` (B, m) — the safe-bound pass behind
    ``BackendSpec.supports_safe_bound``.

    From the exact identity ``c.x = y.(Ax) + z.x`` with ``z = c - A^T y``,
    bounding each term over the feasible box gives, for minimization::

        min c.x + c0  >=  c0 + sum_i min(y_i lo_i, y_i hi_i)
                             + sum_j min(z_j lb_j, z_j ub_j)

    (maximization: the mirrored upper bound with max picks).  This holds
    for *every* y, so duals from a tolerance-based solver (PDHG) — or
    float32-noisy duals from an exact one — still yield bounds safe to
    prune with.  Entries of ``y`` whose optimizing side is an infinite row
    bound are projected to 0 first (still valid: any y is); a reduced cost
    pushing against an infinite variable bound honestly yields ``-inf``
    (``+inf`` for max) — no information.  NaN duals are treated as 0.

    Returns (B,) bounds in the problem's own sense: a lower bound on the
    minimum, or an upper bound on the maximum.
    """
    y = np.nan_to_num(np.asarray(y, np.float64),
                      nan=0.0, posinf=0.0, neginf=0.0)
    lo, hi = g.row_bounds()
    lb = np.asarray(g.lb, np.float64)
    ub = np.asarray(g.ub, np.float64)
    if not g.maximize:
        bad = ((y > 0) & ~np.isfinite(lo)) | ((y < 0) & ~np.isfinite(hi))
        yp = np.where(bad, 0.0, y)
        rt = (np.where(yp > 0, yp, 0.0) * np.where(yp > 0, lo, 0.0)
              + np.where(yp < 0, yp, 0.0) * np.where(yp < 0, hi, 0.0))
        z = np.asarray(g.c, np.float64) - np.einsum("bmn,bm->bn", g.A, yp)
        ct = (np.where(z > 0, z, 0.0) * np.where(z > 0, lb, 0.0)
              + np.where(z < 0, z, 0.0) * np.where(z < 0, ub, 0.0))
    else:
        bad = ((y > 0) & ~np.isfinite(hi)) | ((y < 0) & ~np.isfinite(lo))
        yp = np.where(bad, 0.0, y)
        rt = (np.where(yp > 0, yp, 0.0) * np.where(yp > 0, hi, 0.0)
              + np.where(yp < 0, yp, 0.0) * np.where(yp < 0, lo, 0.0))
        z = np.asarray(g.c, np.float64) - np.einsum("bmn,bm->bn", g.A, yp)
        ct = (np.where(z > 0, z, 0.0) * np.where(z > 0, ub, 0.0)
              + np.where(z < 0, z, 0.0) * np.where(z < 0, lb, 0.0))
    return np.asarray(g.c0, np.float64) + rt.sum(axis=1) + ct.sum(axis=1)


def _cold_carrier(m: int, n: int) -> WarmStart:
    """A 1-member carrier encoding the cold start (slack basis, zero
    iterates): lets root/reset nodes share a frontier dispatch with
    genuinely warm siblings — ``WarmStart.concat`` needs uniform leaves,
    and injecting the cold construction *as* a warm start is a no-op."""
    return WarmStart(m=m, n=n,
                     basis=np.arange(n, n + m, dtype=np.int32)[None],
                     at_upper=np.zeros((1, n), bool),
                     x=np.zeros((1, n)), y=np.zeros((1, m)),
                     omega=np.ones(1), eta=np.ones(1))


@dataclasses.dataclass
class _Node:
    """One open node: bound edits vs the root + inherited bookkeeping."""
    lb: np.ndarray            # (n,) original-coordinate bounds
    ub: np.ndarray
    bound: float              # inherited relaxation bound (min-form)
    depth: int
    warm: Optional[WarmStart]  # parent's terminal state, canonical coords


@dataclasses.dataclass(frozen=True)
class BnBResult:
    """Outcome of one branch-and-bound run (original problem sense).

    ``status`` reuses the LP codes: OPTIMAL — incumbent proven optimal to
    ``gap_tol``; INFEASIBLE — no integer-feasible point exists (proven);
    UNBOUNDED — the root relaxation is unbounded; ITERATION_LIMIT — the
    node budget ran out or some node was unresolvable, ``objective``/
    ``bound`` bracket the true optimum.  ``proven`` is the single flag
    tests should assert.
    """
    x: Optional[np.ndarray]   # (n,) incumbent (integer cols exactly integral)
    objective: float          # incumbent value (NaN when none found)
    bound: float              # proven bound on the optimum (problem sense)
    status: int
    proven: bool
    nodes: int                # LP relaxations solved
    dispatches: int           # device dispatches (rounds / admit groups)
    lp_iterations: int        # total LP iterations across all node solves
    max_depth: int
    gap: float                # |objective - bound| / max(1, |objective|)

    def summary(self) -> str:
        names = {OPTIMAL: "optimal", UNBOUNDED: "unbounded",
                 INFEASIBLE: "infeasible", ITERATION_LIMIT: "node_limit"}
        return (f"{names[self.status]}: objective={self.objective:.6g} "
                f"bound={self.bound:.6g} nodes={self.nodes} "
                f"lp_iters={self.lp_iterations} depth<={self.max_depth}")


def _normalize_integer(g: GeneralLPBatch, integer) -> np.ndarray:
    if integer is None:
        integer = g.integer
    if integer is None:
        raise ValueError(
            "no integer columns: pass integer= or set GeneralLPBatch.integer "
            "(read_mps records INTORG/INTEND markers and BV/UI/LI bounds)")
    integer = np.asarray(integer)
    if integer.dtype != bool:
        mask = np.zeros(g.n, bool)
        mask[integer.reshape(-1).astype(int)] = True
        integer = mask
    integer = integer.reshape(g.n)
    if not integer.any():
        raise ValueError("integer mask is empty")
    fin = (np.isfinite(g.lb[:, integer]).all()
           and np.isfinite(g.ub[:, integer]).all())
    if not fin:
        raise ValueError(
            "integer columns need finite lb and ub at the root: branching "
            "edits bounds, and the canonical batch's bound-finiteness "
            "pattern must stay invariant across the tree "
            "(forms.rebind_bounds)")
    return integer


def branch_and_bound(g: GeneralLPBatch, *, device=None, integer=None,
                     backend: str = "tableau", mode: str = "dispatch",
                     search: str = "best", frontier: int = 16,
                     lanes: Optional[int] = None,
                     warm_start: bool = True,
                     max_nodes: int = 10_000,
                     gap_tol: float = 1e-6, int_tol: float = 1e-5,
                     bound_slack: float = 1e-5, feas_accept: float = 1e-5,
                     pricing: str = "dantzig", tracer=None,
                     **solver_kwargs) -> BnBResult:
    """Solve the mixed-integer program ``g`` (integer columns per
    ``integer``/``g.integer``) by batched LP-based branch-and-bound.

    ``g`` must be a single instance (batch of 1) with finite bounds on
    every integer column.  ``backend`` is any BACKEND_REGISTRY engine; a
    non-exact backend must advertise ``supports_safe_bound`` (its node
    bounds then go through the ``safe_dual_bound`` certificate pass
    instead of trusting tolerance-based objectives).  ``search`` picks the
    node order — ``"best"`` (best-bound-first: strongest bound growth) or
    ``"depth"`` (diving: incumbents early, frontier stays warm-start
    coherent).  ``frontier`` caps nodes per device dispatch
    (``mode="dispatch"``); ``lanes`` sizes the refill pool
    (``mode="stream"``, tableau only, default ``next pow2 >= frontier``).
    ``warm_start=False`` solves every node cold.  ``device`` (CUDA unless
    ``"cpu"``) is where every node relaxation is solved.  Remaining kwargs
    (``tol``, ``max_iters``, ...) forward to the LP engine via
    ``solve_batched`` (stream mode: ``tol``, ``feas_tol``, ``max_iters``,
    ``segment_k`` and ``stats_out`` to the scheduler).

    Fathoming tolerances: a node is pruned when its relaxation bound
    cannot beat the incumbent by more than ``gap_tol`` (relative), so the
    returned incumbent is optimal to ``gap_tol`` when ``proven``;
    ``bound_slack`` is the float32 safety margin subtracted from exact
    engines' relaxation objectives before they are used as bounds;
    ``int_tol`` decides integrality of a relaxation solution and
    ``feas_accept`` re-checks the rounded candidate's original-space
    feasibility before it may become the incumbent.

    ``tracer`` (an `obs.SpanTracer`) records node lifecycle events — one
    ``node`` event per fathom/branch decision with the outcome and depth —
    plus dispatch spans; in ``mode="stream"`` it is also handed to the
    `FrontierScheduler` for admit/retire lane events.
    """
    spec = backend_spec(backend)
    dev = resolve_device(device)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if search not in SEARCHES:
        raise ValueError(
            f"unknown search {search!r}; expected one of {SEARCHES}")
    if mode == "stream" and backend != "tableau":
        raise ValueError(
            "mode='stream' drives the tableau FrontierScheduler; use "
            "mode='dispatch' for the revised/pdhg engines")
    if not spec.exact and not spec.supports_safe_bound:
        raise ValueError(
            f"backend {backend!r} is tolerance-based and does not support "
            "the safe-bound certificate pass (BackendSpec."
            "supports_safe_bound); its objectives cannot prune safely")
    if g.batch != 1:
        raise ValueError(f"branch_and_bound takes one instance, got a batch "
                         f"of {g.batch}")
    int_mask = _normalize_integer(g, integer)
    int_cols = np.flatnonzero(int_mask)
    if frontier < 1:
        raise ValueError(f"frontier must be >= 1, got {frontier}")

    # Integer columns' bounds are forced into canonical *rows*: a branch
    # then edits only ``b``, which the engines' warm repair phase 1 can fix
    # under the parent basis; a tightened native ``ub`` under a stale basis
    # would go undetected (the injected vertex can sit above the new bound).
    lp0, rec0 = canonicalize(g, bound_rows=int_mask)
    mval = (lambda v: -v) if g.maximize else (lambda v: v)

    # ---- mutable search state (shared by both modes via _process) ---------
    open_nodes: List[_Node] = [
        _Node(lb=np.asarray(g.lb[0], np.float64).copy(),
              ub=np.asarray(g.ub[0], np.float64).copy(),
              bound=-np.inf, depth=0, warm=None)]
    state = {"incumbent": np.inf, "x": None, "proven": True,
             "unbounded": False, "nodes": 0, "dispatches": 0,
             "lp_iters": 0, "max_depth": 0}

    def note(outcome: str, nd: "_Node", **kw):
        if tracer is not None:
            tracer.event("node", outcome=outcome, depth=nd.depth,
                         bound=float(nd.bound), **kw)

    def prune_eps():
        inc = state["incumbent"]
        return gap_tol * max(1.0, abs(inc)) if np.isfinite(inc) else 0.0

    def select(k: int) -> List[_Node]:
        if search == "best":
            open_nodes.sort(key=lambda nd: nd.bound)
            take = open_nodes[:k]
            del open_nodes[:k]
        else:                               # diving: deepest-first
            take = open_nodes[-k:]
            del open_nodes[-k:]
        return take

    def _branch(nd: _Node, j: int, split: float, bound: float,
                warm: Optional[WarmStart]):
        dn_ub = nd.ub.copy()
        dn_ub[j] = split
        up_lb = nd.lb.copy()
        up_lb[j] = split + 1.0
        for lb2, ub2 in ((nd.lb.copy(), dn_ub), (up_lb, nd.ub.copy())):
            open_nodes.append(_Node(lb=lb2, ub=ub2, bound=bound,
                                    depth=nd.depth + 1, warm=warm))
        state["max_depth"] = max(state["max_depth"], nd.depth + 1)

    def _process(nd: _Node, status: int, obj: float, x: np.ndarray,
                 node_g_row, y_row, warm: Optional[WarmStart]):
        """Fathom/branch one solved node (x/obj/y in original coords)."""
        if status == INFEASIBLE:
            note("infeasible", nd)
            return
        if status == UNBOUNDED:
            note("unbounded", nd)
            if nd.depth == 0:
                state["unbounded"] = True
            else:          # a child more constrained than a bounded root:
                state["proven"] = False   # numerically suspect — don't claim
            return
        if status == ITERATION_LIMIT:
            # x is whatever the limit left behind — branch on a domain
            # split instead (always valid), cold-start the children
            unfixed = int_cols[nd.lb[int_cols] < nd.ub[int_cols]]
            if not len(unfixed):
                note("limit_stuck", nd)
                state["proven"] = False
                return
            j = int(unfixed[0])
            note("limit_split", nd, column=j)
            _branch(nd, j, np.floor((nd.lb[j] + nd.ub[j]) / 2.0),
                    nd.bound, None)
            return
        # OPTIMAL relaxation
        if spec.exact:
            nb = mval(obj) - bound_slack * (1.0 + abs(obj))
        else:
            sb = float(safe_dual_bound(node_g_row, y_row[None])[0])
            nb = mval(sb) if np.isfinite(sb) else nd.bound
        nb = max(nb, nd.bound)
        if nb >= state["incumbent"] - prune_eps():
            note("fathomed", nd, node_bound=float(nb))
            return                          # fathom by bound
        xi = x[int_cols]
        frac = np.abs(xi - np.round(xi))
        if float(frac.max()) <= int_tol:
            cand = np.asarray(x, np.float64).copy()
            cand[int_cols] = np.round(xi)
            viol = float(general_violation(g, cand[None])[0])
            if viol <= feas_accept:
                v = mval(float(g.objective_value(cand[None])[0]))
                if v < state["incumbent"]:
                    state["incumbent"], state["x"] = v, cand
                    note("incumbent", nd, objective=mval(v))
                else:
                    note("integral", nd)
            else:                           # rounding broke feasibility —
                note("round_infeasible", nd)
                state["proven"] = False     # pathological; don't fabricate
            return
        j = int(int_cols[int(np.argmax(frac))])
        split = float(np.clip(np.floor(x[j]), nd.lb[j], nd.ub[j] - 1.0))
        note("branched", nd, column=j, split=split, node_bound=float(nb))
        _branch(nd, j, split, nb, warm if warm_start else None)

    # ---- frontier loop ----------------------------------------------------
    if mode == "dispatch":
        while open_nodes and not state["unbounded"] \
                and state["nodes"] < max_nodes:
            take = select(min(frontier, len(open_nodes),
                              max_nodes - state["nodes"]))
            LB = np.stack([nd.lb for nd in take])
            UB = np.stack([nd.ub for nd in take])
            lp_f, rec_f = rebind_bounds(lp0, rec0, LB, UB)
            ws = None
            if warm_start:
                ws = WarmStart.concat(
                    [nd.warm if nd.warm is not None
                     else _cold_carrier(lp0.m, lp0.n) for nd in take])
            with maybe_span(tracer, "bnb_dispatch", nodes=len(take),
                            open_nodes=len(open_nodes)):
                res_can = solve_batched(lp_f, device=dev, backend=backend,
                                        pricing=pricing, warm=ws,
                                        pad_to_bucket=True, **solver_kwargs)
            res = rec_f.recover(res_can)
            state["nodes"] += len(take)
            state["dispatches"] += 1
            state["lp_iters"] += int(np.asarray(res.iterations).sum())
            gf = rec_f.general
            for i, nd in enumerate(take):
                row_g = dataclasses.replace(
                    gf, A=gf.A[i:i + 1], rhs=gf.rhs[i:i + 1],
                    lb=gf.lb[i:i + 1], ub=gf.ub[i:i + 1],
                    c=gf.c[i:i + 1], c0=gf.c0[i:i + 1]) \
                    if not spec.exact else None
                w = (res_can.warm.slice(i, i + 1)
                     if res_can.warm is not None else None)
                _process(nd, int(res.status[i]), float(res.objective[i])
                         if res.objective is not None else np.nan,
                         np.asarray(res.x[i], np.float64), row_g,
                         None if res.y is None else np.asarray(res.y[i]), w)
    else:                                   # mode == "stream"
        sched = FrontierScheduler(
            lp0.m, lp0.n, lanes=(frontier if lanes is None else lanes),
            device=dev, pricing=pricing, tracer=tracer,
            **{k: v for k, v in solver_kwargs.items()
               if k in ("tol", "feas_tol", "max_iters", "segment_k",
                        "stats_out")})
        pending = {}
        seq = [0]

        def source(k):
            if not open_nodes or state["unbounded"] \
                    or state["nodes"] >= max_nodes:
                return None
            take = select(min(k, len(open_nodes),
                              max_nodes - state["nodes"]))
            LB = np.stack([nd.lb for nd in take])
            UB = np.stack([nd.ub for nd in take])
            lp_f, rec_f = rebind_bounds(lp0, rec0, LB, UB)
            tags = []
            for i, nd in enumerate(take):
                pending[seq[0]] = (nd, rec_f, i)
                tags.append(seq[0])
                seq[0] += 1
            ws = None
            if warm_start:
                ws = WarmStart.concat(
                    [nd.warm if nd.warm is not None
                     else _cold_carrier(lp0.m, lp0.n) for nd in take])
            state["nodes"] += len(take)
            state["dispatches"] += 1
            return (np.asarray(lp_f.A), np.asarray(lp_f.b),
                    np.asarray(lp_f.c), lp_f.upper_bounds(), ws, tags)

        def sink(tag, row):
            nd, rec_f, i = pending.pop(tag)
            rec1 = _slice_recovery(rec_f, i)
            res1 = LPResult(
                x=row["x"][None], objective=np.array([row["objective"]]),
                status=np.array([row["status"]], np.int8),
                iterations=np.array([row["iterations"]], np.int32),
                y=row["y"][None], z=row["z"][None])
            res = rec1.recover(res1)
            state["lp_iters"] += int(row["iterations"])
            _process(nd, int(res.status[0]),
                     float(res.objective[0]),
                     np.asarray(res.x[0], np.float64), None,
                     None if res.y is None else np.asarray(res.y[0]),
                     row["warm"])

        sched.run(source, sink)

    # ---- verdict ----------------------------------------------------------
    inc = state["incumbent"]
    have_inc = np.isfinite(inc)
    exhausted = not open_nodes and not state["unbounded"]
    if state["unbounded"]:
        status, proven = UNBOUNDED, True
        bound_min = -np.inf
    elif exhausted and state["proven"]:
        status = OPTIMAL if have_inc else INFEASIBLE
        proven = True
        bound_min = inc
    else:
        status, proven = ITERATION_LIMIT, False
        bound_min = min([nd.bound for nd in open_nodes] + [inc]) \
            if (open_nodes or have_inc) else -np.inf
    objective = mval(inc) if have_inc else np.nan
    bound = mval(bound_min) if np.isfinite(bound_min) else \
        (np.inf if g.maximize else -np.inf)
    gap = (abs(objective - bound) / max(1.0, abs(objective))
           if have_inc and np.isfinite(bound) else np.inf)
    if proven:
        gap = 0.0
    return BnBResult(x=state["x"], objective=objective, bound=bound,
                     status=status, proven=proven, nodes=state["nodes"],
                     dispatches=state["dispatches"],
                     lp_iterations=state["lp_iters"],
                     max_depth=state["max_depth"], gap=gap)


def _slice_recovery(rec: Recovery, i: int) -> Recovery:
    """The single-row view of a frontier Recovery (stream-mode retirement
    recovers nodes one at a time as they leave the lane pool)."""
    gf = rec.general
    g1 = dataclasses.replace(gf, A=gf.A[i:i + 1], rhs=gf.rhs[i:i + 1],
                             lb=gf.lb[i:i + 1], ub=gf.ub[i:i + 1],
                             c=gf.c[i:i + 1], c0=gf.c0[i:i + 1])
    sl = (lambda a: None if a is None
          else (a if a.shape[0] == 1 else a[i:i + 1]))
    return dataclasses.replace(
        rec, general=g1, baseline=rec.baseline[i:i + 1],
        shift=rec.shift[i:i + 1],
        status_override=rec.status_override[i:i + 1],
        col_scale=sl(rec.col_scale), row_scale=sl(rec.row_scale))
