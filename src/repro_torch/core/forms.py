"""General-form LP batches and the canonicalization pipeline (NumPy).

A copy of ``repro.core.forms`` restricted to what the port's entry points
need: ``GeneralLPBatch``, ``canonicalize``, ``Recovery``,
``ensure_canonical``, ``finish_result`` and ``prepare_warm``.  The port
keeps its own copy because importing any ``repro.core`` module imports JAX.

    GeneralLPBatch  --canonicalize()-->  (LPBatch, Recovery)

``canonicalize`` is an invertible, host-side (float64 NumPy) transform:
presolve (fixed-variable, empty-column and empty-row elimination), bound
handling (lower-bound shifts, free-column splits, finite upper bounds as the
native ``LPBatch.ub`` vector), row senses (``>=`` rows negated, ``=`` and
ranged rows as a ``<=`` pair) and power-of-two geometric-mean scaling.
``Recovery.recover`` maps an ``LPResult`` on the canonical batch back to
original coordinates, duals included.  The arithmetic is the reference's
line for line, so both packages solve the same canonical batch.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np

from .lp import INFEASIBLE, OPTIMAL, LPBatch, LPResult, WarmStart

# Row senses (MPS letters).
LE, GE, EQ = "L", "G", "E"
SENSES = (LE, GE, EQ)


def _bcast(arr, shape, name, dtype=np.float64):
    """Broadcast per-structure (m,)/(n,) data against the batch axis."""
    out = np.asarray(arr, dtype=dtype)
    if out.ndim == len(shape) - 1:
        out = np.broadcast_to(out[None], shape)
    if out.shape != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {out.shape}")
    return np.ascontiguousarray(out)


@dataclasses.dataclass(frozen=True)
class GeneralLPBatch:
    """A batch of B general-form LPs sharing one structure.

        optimize  c . x + c0      (min by default — the MPS convention)
        s.t.      lo_i <= A_i . x <= hi_i    (senses/ranges per row)
                  lb <= x <= ub              (+-inf allowed)

    Numeric data (``A``, ``rhs``, ``lb``, ``ub``, ``c``, ``c0``) is per-LP;
    structure (``sense``, ``ranges``, names, objective direction) is shared
    across the batch so the canonical form has one static shape — the same
    same-size contract the paper's batches obey (perturbed copies of one
    instance, Sec. 6).
    """

    A: np.ndarray          # (B, m, n) float64
    sense: np.ndarray      # (m,) '<U1' in {L, G, E}
    rhs: np.ndarray        # (B, m)
    lb: np.ndarray         # (B, n), -inf for free-below
    ub: np.ndarray         # (B, n), +inf for unbounded-above
    c: np.ndarray          # (B, n)
    c0: np.ndarray         # (B,) objective constant
    maximize: bool = False
    ranges: Optional[np.ndarray] = None  # (m,), NaN = no range
    name: str = "general"
    row_names: Optional[Tuple[str, ...]] = None
    col_names: Optional[Tuple[str, ...]] = None
    integer: Optional[np.ndarray] = None  # (n,) bool — columns required
                                          # integral (structure, shared
                                          # across the batch).  Every LP
                                          # solver ignores it (solves the
                                          # continuous relaxation); the
                                          # branch-and-bound solver
                                          # (core/branch_bound.py) enforces
                                          # it by branching on lb/ub.

    @property
    def batch(self) -> int:
        return self.A.shape[0]

    @property
    def m(self) -> int:
        return self.A.shape[1]

    @property
    def n(self) -> int:
        return self.A.shape[2]

    @staticmethod
    def from_arrays(A, sense, rhs, *, lb=None, ub=None, c=None, c0=0.0,
                    maximize=False, ranges=None, name="general",
                    row_names=None, col_names=None,
                    integer=None) -> "GeneralLPBatch":
        A = np.asarray(A, dtype=np.float64)
        if A.ndim == 2:
            A = A[None]
        B, m, n = A.shape
        sense = np.asarray(sense, dtype="<U1").reshape(m)
        bad = ~np.isin(sense, SENSES)
        if bad.any():
            raise ValueError(f"unknown row senses {set(sense[bad])}; "
                             f"expected one of {SENSES}")
        rhs = _bcast(rhs, (B, m), "rhs")
        lb = _bcast(np.zeros(n) if lb is None else lb, (B, n), "lb")
        ub = _bcast(np.full(n, np.inf) if ub is None else ub, (B, n), "ub")
        c = _bcast(np.zeros(n) if c is None else c, (B, n), "c")
        c0 = np.broadcast_to(np.asarray(c0, np.float64), (B,)).copy()
        if ranges is not None:
            ranges = np.asarray(ranges, np.float64).reshape(m)
        if (lb > ub).any():
            raise ValueError("lb > ub on some variable")
        if integer is not None:
            integer = np.asarray(integer)
            if integer.dtype != bool:      # index list -> (n,) mask
                mask = np.zeros(n, bool)
                mask[integer.reshape(-1).astype(int)] = True
                integer = mask
            integer = integer.reshape(n)
            if not integer.any():
                integer = None
        return GeneralLPBatch(A=A, sense=sense, rhs=rhs, lb=lb, ub=ub, c=c,
                              c0=c0, maximize=bool(maximize), ranges=ranges,
                              name=name,
                              row_names=tuple(row_names) if row_names else None,
                              col_names=tuple(col_names) if col_names else None,
                              integer=integer)

    def row_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-row activity interval (lo, hi), each (B, m), from sense +
        rhs + RANGES (MPS semantics: an ``E`` row's range sign picks the
        side the interval grows toward)."""
        B, m = self.rhs.shape
        lo = np.full((B, m), -np.inf)
        hi = np.full((B, m), np.inf)
        is_l = self.sense == LE
        is_g = self.sense == GE
        is_e = self.sense == EQ
        hi[:, is_l] = self.rhs[:, is_l]
        lo[:, is_g] = self.rhs[:, is_g]
        lo[:, is_e] = self.rhs[:, is_e]
        hi[:, is_e] = self.rhs[:, is_e]
        if self.ranges is not None:
            has = ~np.isnan(self.ranges)
            r = self.ranges
            sel = has & is_l
            lo[:, sel] = self.rhs[:, sel] - np.abs(r[sel])[None]
            sel = has & is_g
            hi[:, sel] = self.rhs[:, sel] + np.abs(r[sel])[None]
            sel = has & is_e & (r >= 0)
            hi[:, sel] = self.rhs[:, sel] + r[sel][None]
            sel = has & is_e & (r < 0)
            lo[:, sel] = self.rhs[:, sel] + r[sel][None]
        return lo, hi

    def objective_value(self, x: np.ndarray) -> np.ndarray:
        """c . x + c0 in original coordinates (the recovered objective)."""
        return np.einsum("bn,bn->b", self.c,
                         np.asarray(x, np.float64)) + self.c0



def _pow2(s: np.ndarray) -> np.ndarray:
    """Snap positive scales to the nearest power of two (mantissa-exact
    scaling: equilibration then changes exponents only)."""
    return np.exp2(np.round(np.log2(s)))


def _equilibrate(A: np.ndarray, iters: int = 2):
    """Geometric-mean row/column equilibration of a (B, m, n) batch.
    Returns (row_scale (B, m), col_scale (B, n)), powers of two, such that
    ``row_scale[:, :, None] * A * col_scale[:, None, :]`` has row/column
    magnitude ranges centered near 1.  All-zero rows/columns get scale 1."""
    B, m, n = A.shape
    r = np.ones((B, m))
    s = np.ones((B, n))
    W = np.abs(A)
    for _ in range(iters):
        cur = W * r[:, :, None] * s[:, None, :]
        nz = cur > 0
        big = np.where(nz, cur, -np.inf).max(axis=2)
        small = np.where(nz, cur, np.inf).min(axis=2)
        ok = np.isfinite(big) & (big > 0)
        r = r * np.where(ok, 1.0 / np.sqrt(np.where(ok, big * small, 1.0)), 1.0)
        cur = W * r[:, :, None] * s[:, None, :]
        nz = cur > 0
        big = np.where(nz, cur, -np.inf).max(axis=1)
        small = np.where(nz, cur, np.inf).min(axis=1)
        ok = np.isfinite(big) & (big > 0)
        s = s * np.where(ok, 1.0 / np.sqrt(np.where(ok, big * small, 1.0)), 1.0)
    return _pow2(r), _pow2(s)


@dataclasses.dataclass(frozen=True)
class Recovery:
    """Invertible record of everything ``canonicalize`` did, sufficient to
    report an ``LPResult`` in original coordinates — primal solution *and*
    dual certificate (row duals + reduced costs)."""

    general: GeneralLPBatch
    kept: np.ndarray           # (nk,) original column indices that survived
    baseline: np.ndarray       # (B, n) presolved-variable values (0 elsewhere)
    shift: np.ndarray          # (B, nk) lower-bound shift (0 for free cols)
    free: np.ndarray           # (nk,) bool — column was split (has neg part)
    status_override: np.ndarray  # (B,) int16, -1 = none (presolve verdicts)
    col_scale: Optional[np.ndarray]  # (B, n_canonical) or None
    row_scale: Optional[np.ndarray]  # (B, m_canonical) or None
    m_canonical: int
    n_canonical: int
    # dual bookkeeping: which original rows survived presolve, and which
    # canonical row blocks they produced (canonical rows are ordered
    # [hi_rows | lo_rows | row-encoded ub rows] by construction; native
    # ``LPBatch.ub`` bounds emit no rows, their multipliers surface as
    # reduced costs, which ``recover_duals`` recomputes anyway)
    rows: np.ndarray = None      # (mk,) original row indices that survived
    hi_rows: np.ndarray = None   # indices into ``rows``: A x <= hi rows
    lo_rows: np.ndarray = None   # indices into ``rows``: -A x <= -lo rows
    # frozen structural decisions: presolve's verdict per eliminated column,
    # which kept columns carry row-encoded vs native upper bounds (indices
    # into the canonical column space)
    fixed_cols: np.ndarray = None    # original col idx: presolved lb == ub
    dropped_cols: np.ndarray = None  # original col idx: empty cols
                                     # substituted at a cost-optimal bound
    ub_cols: np.ndarray = None       # kept-col idx with an ub *row*
    native_cols: np.ndarray = None   # kept-col idx with a native LPBatch.ub

    def recover_x(self, x_can: np.ndarray) -> np.ndarray:
        """Canonical solution (B, n_canonical) -> original x (B, n)."""
        x_can = np.asarray(x_can, np.float64)
        if self.col_scale is not None:
            x_can = x_can * self.col_scale
        nk = len(self.kept)
        y = x_can[:, :nk].copy()
        if self.free.any():
            y[:, self.free] -= x_can[:, nk:]
        y += self.shift
        x = self.baseline.copy()
        x[:, self.kept] = y
        return x

    def recover_duals(self, y_can: np.ndarray):
        """Canonical row duals (B, m_canonical) -> original-coordinate
        ``(y, z)``.

        Canonical rows were emitted as [A x <= hi | -A x <= -lo | ub rows]
        over the presolve-surviving rows, so the original row dual is the
        unscaled hi-multiplier minus the lo-multiplier (E/ranged rows carry
        both); ub-row multipliers are *bound* duals and are deliberately
        folded into the reduced costs instead.  Convention: the returned
        pair satisfies ``z = c - A^T y`` with the **original** objective
        vector — for minimization this is the standard (HiGHS/scipy) sign
        convention (y <= 0 on active <=-rows, z >= 0 at active lower
        bounds); maximization flips every sign.  Presolve-dropped rows get
        dual 0; presolve-dropped columns still get a meaningful reduced
        cost because ``z`` is recomputed from the full original data."""
        g = self.general
        B, m = g.batch, g.m
        y_can = np.asarray(y_can, np.float64)
        if self.row_scale is not None:
            y_can = y_can * self.row_scale
        nh, nl = len(self.hi_rows), len(self.lo_rows)
        y_kept = np.zeros((B, len(self.rows)))
        y_kept[:, self.hi_rows] += y_can[:, :nh]
        y_kept[:, self.lo_rows] -= y_can[:, nh:nh + nl]
        y_max = np.zeros((B, m))
        y_max[:, self.rows] = y_kept          # canonical-max-form duals
        csign = 1.0 if g.maximize else -1.0
        y = csign * y_max
        z = np.asarray(g.c, np.float64) - np.einsum("bmn,bm->bn", g.A, y)
        return y, z

    def recover(self, res: LPResult) -> LPResult:
        """Map a canonical LPResult back to the original problem: original
        coordinates, original objective sense/constant, presolve status
        overrides applied.  The objective is recomputed as ``c.x + c0`` in
        original coordinates (NaN for non-optimal statuses, matching the
        solver convention); the dual certificate, when the backend produced
        one, is mapped through ``recover_duals`` under the same NaN mask."""
        x = self.recover_x(np.asarray(res.x))
        status = np.asarray(res.status).copy()
        ov = self.status_override >= 0
        status[ov] = self.status_override[ov].astype(status.dtype)
        obj = self.general.objective_value(x)
        opt = status == OPTIMAL
        obj = np.where(opt, obj, np.nan)
        y = z = None
        if res.y is not None:
            y, z = self.recover_duals(np.where(np.isnan(res.y), 0.0, res.y))
            y = np.where(opt[:, None], y, np.nan)
            z = np.where(opt[:, None], z, np.nan)
        # warm-start state stays in *canonical* coordinates (a basis has no
        # original-space meaning) but the equilibration scaling is peeled
        # off the iterate leaves: a perturbed follow-up batch re-scales with
        # its own factors at injection (prepare_warm)
        warm = res.warm
        if warm is not None:
            wx, wy = warm.x, warm.y
            if wx is not None and self.col_scale is not None:
                wx = np.asarray(wx) * self.col_scale
            if wy is not None and self.row_scale is not None:
                wy = np.asarray(wy) * self.row_scale
            warm = dataclasses.replace(warm, x=wx, y=wy)
        return LPResult(x=x, objective=obj, status=status,
                        iterations=np.asarray(res.iterations), y=y, z=z,
                        warm=warm, stats=res.stats)


def canonicalize(g: GeneralLPBatch, *, presolve: bool = True,
                 scale: Optional[bool] = None,
                 feas_tol: float = 1e-9) -> Tuple[LPBatch, Recovery]:
    """General form -> the paper's standard form (see module docstring).

    ``scale=None`` follows ``presolve`` (equilibration is part of the
    default presolve pass); pass ``scale=False`` to canonicalize without
    touching the numbers — useful for A/B-ing f32 behavior.

    Finite upper bounds go into the canonical batch's native
    ``LPBatch.ub`` vector (zero extra rows), except bounds on split free
    columns, which stay rows: a bound on ``y+ - y-`` is not a column bound.
    """
    if scale is None:
        scale = presolve
    B, m, n = g.batch, g.m, g.n
    lo, hi = g.row_bounds()
    A = np.asarray(g.A, np.float64)
    csign = 1.0 if g.maximize else -1.0
    cmax = csign * np.asarray(g.c, np.float64)   # standard form maximizes
    lb = np.asarray(g.lb, np.float64)
    ub = np.asarray(g.ub, np.float64)

    baseline = np.zeros((B, n))
    keep_col = np.ones(n, bool)
    keep_row = np.ones(m, bool)
    status_override = np.full(B, -1, np.int16)
    fixed = np.zeros(n, bool)
    droppable = np.zeros(n, bool)

    if presolve:
        # --- fixed variables: lb == ub for every batch member ------------
        fixed = (lb == ub).all(axis=0) & np.isfinite(lb).all(axis=0)
        # --- empty columns: structurally zero across the batch -----------
        empty = (A == 0.0).all(axis=(0, 1)) & ~fixed
        # value each member wants: the cost-optimal bound; keep the column
        # when any member's *optimizing* bound is infinite — dropping it
        # would hide unboundedness (the kept zero column's positive-cost
        # side then has no ratio row, so the solver certifies UNBOUNDED)
        want_ub = cmax > 0
        want_lb = cmax < 0
        val = np.where(want_ub, ub,
                       np.where(want_lb, lb,
                                np.where(np.isfinite(lb), lb, ub)))
        droppable = empty & np.isfinite(val).all(axis=0)
        sub = fixed | droppable
        if sub.any():
            baseline[:, fixed] = lb[:, fixed]
            baseline[:, droppable] = val[:, droppable]
            contrib = np.einsum("bmk,bk->bm", A[:, :, sub], baseline[:, sub])
            lo = lo - contrib
            hi = hi - contrib
            keep_col &= ~sub
        # --- empty rows (after column elimination) ------------------------
        empty_row = (A[:, :, keep_col] == 0.0).all(axis=(0, 2))
        if empty_row.any():
            bad = ((np.where(np.isfinite(lo), lo, -np.inf) > feas_tol)
                   | (np.where(np.isfinite(hi), hi, np.inf) < -feas_tol))
            status_override[bad[:, empty_row].any(axis=1)] = INFEASIBLE
            keep_row &= ~empty_row

    kept = np.flatnonzero(keep_col)
    rows = np.flatnonzero(keep_row)
    A = A[:, rows][:, :, kept]
    lo, hi = lo[:, rows], hi[:, rows]
    lbk, ubk, ck = lb[:, kept], ub[:, kept], cmax[:, kept]

    # --- bounds: shift finite lower bounds, split free columns -----------
    lb_fin = np.isfinite(lbk)
    mixed = lb_fin.any(axis=0) & ~lb_fin.all(axis=0)
    if mixed.any():
        raise ValueError(
            "lower-bound finiteness must be batch-uniform per column "
            f"(columns {np.flatnonzero(mixed)} mix finite and -inf): the "
            "canonical batch needs one static shape")
    free = ~lb_fin[0] if B else ~lb_fin.any(axis=0)
    shift = np.where(lb_fin, lbk, 0.0)
    contrib = np.einsum("bmk,bk->bm", A, shift)
    lo, hi = lo - contrib, hi - contrib
    ub_shifted = ubk - shift            # finite iff ub finite
    ub_fin = np.isfinite(ub_shifted)
    if (ub_fin.any(axis=0) & ~ub_fin.all(axis=0)).any():
        raise ValueError(
            "upper-bound finiteness must be batch-uniform per column: the "
            "canonical batch needs one static shape")
    bounded_cols = np.flatnonzero(ub_fin.all(axis=0)) if B else np.array([], int)
    # native bounds, except on free (split) columns, which keep a row
    ub_cols = bounded_cols[free[bounded_cols]]
    native_cols = np.setdiff1d(bounded_cols, ub_cols)

    nk = len(kept)
    nf = int(free.sum())
    n_can = nk + nf
    hi_fin = np.isfinite(hi)
    lo_fin = np.isfinite(lo)
    # A row bound that is infinite for some members but finite for others
    # has no faithful static-shape encoding (substituting a large finite
    # bound would mis-report genuinely unbounded members as OPTIMAL), so
    # reject it — same contract as the variable-bound uniformity checks.
    mixed_rows = ((hi_fin.any(axis=0) & ~hi_fin.all(axis=0))
                  | (lo_fin.any(axis=0) & ~lo_fin.all(axis=0)))
    if mixed_rows.any():
        raise ValueError(
            "row-bound finiteness must be batch-uniform per row (rows "
            f"{np.flatnonzero(mixed_rows)} mix finite and infinite rhs): "
            "the canonical batch needs one static shape")
    hi_rows = np.flatnonzero(hi_fin.all(axis=0))
    lo_rows = np.flatnonzero(lo_fin.all(axis=0))
    m_can = len(hi_rows) + len(lo_rows) + len(ub_cols)

    A_can = np.zeros((B, m_can, n_can))
    b_can = np.zeros((B, m_can))
    pos = A if nf == 0 else np.concatenate([A, -A[:, :, free]], axis=2)
    r0 = len(hi_rows)
    A_can[:, :r0] = pos[:, hi_rows]
    b_can[:, :r0] = hi[:, hi_rows]
    r1 = r0 + len(lo_rows)
    A_can[:, r0:r1] = -pos[:, lo_rows]
    b_can[:, r0:r1] = -lo[:, lo_rows]
    # upper-bound rows: y_j <= ub' (free columns: y+ - y- <= ub')
    free_slot = np.cumsum(free) - 1      # index into the neg block
    for k, j in enumerate(ub_cols):
        i = r1 + k
        A_can[:, i, j] = 1.0
        if free[j]:
            A_can[:, i, nk + free_slot[j]] = -1.0
        b_can[:, i] = ub_shifted[:, j]
    c_can = ck if nf == 0 else np.concatenate([ck, -ck[:, free]], axis=1)
    # native upper bounds: a (B, n_can) vector instead of rows (split
    # negative parts are unbounded above)
    ub_can = np.full((B, n_can), np.inf)
    if len(native_cols):
        ub_can[:, native_cols] = ub_shifted[:, native_cols]

    # Degenerate shells: presolve can empty the canonical problem entirely
    # (every row redundant and/or every column substituted).  The solvers
    # need at least one row and one column, so pad with an inert 0.y <= 1
    # row / zero-cost zero column — neither changes the solution set, and
    # unboundedness along a padded-away direction is still caught (an empty
    # entering column has no ratio row).
    if n_can == 0:
        n_can = 1
        A_can = np.zeros((B, m_can, 1))
        c_can = np.zeros((B, 1))
        ub_can = np.full((B, 1), np.inf)
    if m_can == 0:
        m_can = 1
        A_can = np.zeros((B, 1, n_can))
        b_can = np.ones((B, 1))

    row_scale = col_scale = None
    if scale and m_can and n_can:
        row_scale, col_scale = _equilibrate(A_can)
        A_can = A_can * row_scale[:, :, None] * col_scale[:, None, :]
        b_can = b_can * row_scale
        c_can = c_can * col_scale
        # the solver variable is x_s = x / col_scale, so bounds scale too
        ub_can = ub_can / col_scale

    lp = LPBatch.from_arrays(A_can, b_can, c_can, ub=ub_can)
    rec = Recovery(general=g, kept=kept, baseline=baseline, shift=shift,
                   free=free, status_override=status_override,
                   col_scale=col_scale, row_scale=row_scale,
                   m_canonical=m_can, n_canonical=n_can,
                   rows=rows, hi_rows=hi_rows, lo_rows=lo_rows,
                   fixed_cols=np.flatnonzero(fixed),
                   dropped_cols=np.flatnonzero(droppable),
                   ub_cols=ub_cols, native_cols=native_cols)
    return lp, rec


def ensure_canonical(batch, *, presolve: bool = True,
                     scale: Optional[bool] = None):
    """Entry-point shim: pass ``LPBatch`` through untouched; canonicalize a
    ``GeneralLPBatch``.  Returns (LPBatch, Recovery-or-None)."""
    if isinstance(batch, GeneralLPBatch):
        return canonicalize(batch, presolve=presolve, scale=scale)
    return batch, None


def finish_result(rec, res: LPResult) -> LPResult:
    """Entry-point shim: apply ``Recovery`` when the input was general."""
    return res if rec is None else rec.recover(res)


def prepare_warm(warm: Optional[WarmStart], rec: Optional[Recovery],
                 batch: LPBatch) -> Optional[WarmStart]:
    """Validate a ``WarmStart`` against the canonical batch about to be
    solved and map its iterate leaves into the engine's scaled coordinates.

    The single validation gate every entry point routes through: a carrier
    whose batch/shape does not match (the follow-up batch changed size, or
    the perturbation changed the canonical shape) is *dropped with a
    warning* — warm starting is an optimization, never a correctness
    requirement, so shape drift degrades to a cold solve instead of
    erroring.  ``rec=None`` (the input was already canonical) skips the
    re-scaling and only validates."""
    if warm is None:
        return None
    B, m, n = batch.batch, batch.m, batch.n

    def drop(why):
        warnings.warn(f"warm start dropped ({why}); solving cold")
        return None

    if warm.m != m or warm.n != n:
        return drop(f"carrier is {warm.m}x{warm.n}, batch canonicalizes "
                    f"to {m}x{n}")
    if warm.batch != B:
        return drop(f"carrier batch {warm.batch} != batch size {B}")
    for field, rows, cols in (("basis", m, None), ("at_upper", n, None),
                              ("x", n, None), ("y", m, None),
                              ("omega", None, None), ("eta", None, None)):
        v = getattr(warm, field)
        if v is None:
            continue
        want = (B,) if rows is None else (B, rows)
        if np.asarray(v).shape != want:
            return drop(f"leaf {field!r} has shape {np.asarray(v).shape}, "
                        f"expected {want}")
    if rec is None:
        return warm
    wx, wy = warm.x, warm.y
    if wx is not None and rec.col_scale is not None:
        wx = np.asarray(wx) / rec.col_scale
    if wy is not None and rec.row_scale is not None:
        wy = np.asarray(wy) / rec.row_scale
    return dataclasses.replace(warm, x=wx, y=wy)
