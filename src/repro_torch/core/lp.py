"""LP problem containers: the canonical standard form every solver consumes.

A copy of ``repro.core.lp`` (NumPy only; the port keeps its own because
importing any ``repro.core`` module imports JAX).  The paper (Gurung & Ray
2018) solves LPs in *standard form*:

    maximize    c . x
    subject to  A x <= b,   0 <= x <= ub

with ``m`` constraints over ``n`` variables.  A batch holds ``B``
independent LPs of identical (m, n); ``ub`` is an optional per-column bound
vector (+inf = unbounded).  General-form problems (``core/forms.py``,
``io/mps.py``) are canonicalized into an ``LPBatch`` on ingestion.

The simplex tableau layout follows Sec. 4.1/5.5 of the paper:

    rows    0..m-1 : constraint rows
    row     m      : phase-2 objective row (reduced costs; value = -T[m, -1])
    row     m+1    : phase-1 objective row (for the two-phase method)
    columns 0..n-1          : structural variables
    columns n..n+m-1        : slack variables
    columns n+m..n+2m-1     : artificial variables (zero columns when b_i >= 0)
    column  n+2m            : right-hand side

All three engines of the reference are ported: ``tableau`` and ``revised``
(exact simplex certificates) and ``pdhg`` (restarted PDHG, tolerance-based
KKT convergence).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

# Status codes shared by every solver backend (NumPy oracle, torch engine,
# CUDA kernel) and by the reference package.
OPTIMAL = 0
UNBOUNDED = 1
INFEASIBLE = 2
ITERATION_LIMIT = 3

STATUS_NAMES = {
    OPTIMAL: "optimal",
    UNBOUNDED: "unbounded",
    INFEASIBLE: "infeasible",
    ITERATION_LIMIT: "iteration_limit",
}

# The paper's branch-elimination sentinel (Sec. 5.2): invalid min-ratio
# entries are replaced by a large positive value instead of being masked
# with a conditional.
BIG = 1e30


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Lazy entry points of one solver engine.  The registry below is the
    single source of truth for ``backend=`` dispatch."""

    name: str
    exact: bool            # pivot-exact simplex certificates
    solve: str             # "module:attr" of the batched entry point and
    solve_compacted: str   # of the scheduled one, imported lazily (the
                           # engine modules import this module)
    # "module:attr" of ``(m, n) -> bytes``, the peak device bytes one LP
    # needs on this engine's path, the scheduler's gathers included; None:
    # the tableau's ``LPBatch.bytes_per_lp``, twice under the scheduler
    bytes_per_lp: Optional[str] = None
    # emits dual certificates (``LPResult.y``/``z``) that a consumer can
    # turn into valid relaxation bounds whatever the engine's own
    # tolerance: branch-and-bound's safe-bound pass needs it from a
    # tolerance-based engine (core/branch_bound.py ``safe_dual_bound``)
    supports_safe_bound: bool = False


BACKEND_REGISTRY = {
    # dense tableaux, rank-1 pivot updates (core/simplex.py); on cuda the
    # batched entry point runs the hand-written kernel (kernels/ops.py)
    "tableau": BackendSpec(
        name="tableau", exact=True,
        solve="repro_torch.core.simplex:solve_batched_torch",
        solve_compacted="repro_torch.core.compaction:solve_batched_compacted",
        supports_safe_bound=True),
    # immutable constraint data, a dense basis inverse updated per pivot
    # (core/revised.py); on cuda the kernel of kernels/csrc/revised_tile.cu
    "revised": BackendSpec(
        name="revised", exact=True,
        solve="repro_torch.core.revised:solve_batched_revised",
        solve_compacted=("repro_torch.core.revised:"
                         "solve_batched_revised_compacted"),
        supports_safe_bound=True),
    # restarted primal-dual hybrid gradient, tolerance-based KKT
    # convergence (core/pdhg.py); on cuda the kernels of
    # kernels/csrc/pdhg_tile.cu; sparse batches go to core/sparse.py
    "pdhg": BackendSpec(
        name="pdhg", exact=False,
        solve="repro_torch.core.pdhg:solve_batched_pdhg",
        solve_compacted="repro_torch.core.pdhg:solve_batched_pdhg_compacted",
        bytes_per_lp="repro_torch.core.pdhg:pdhg_bytes_per_lp",
        supports_safe_bound=True),
}

BACKENDS = tuple(BACKEND_REGISTRY)


def canonicalize_backend(backend: str) -> str:
    """Validate a solver-engine name (shared by every ``backend=`` kwarg)."""
    if backend not in BACKEND_REGISTRY:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}")
    return backend


def backend_spec(backend: str) -> BackendSpec:
    """The registry record for a (validated) engine name."""
    return BACKEND_REGISTRY[canonicalize_backend(backend)]


def resolve_backend(backend: str, *, compacted: bool = False):
    """Late-bound batched entry point of an engine (its scheduled one when
    ``compacted``).  Importing lazily keeps the registry cycle-free (engine
    modules import this module)."""
    spec = backend_spec(backend)
    return load_entry(spec.solve_compacted if compacted else spec.solve)


def load_entry(target: str):
    """The object a registry string ``"module:attr"`` names."""
    import importlib

    module, attr = target.split(":")
    return getattr(importlib.import_module(module), attr)


@dataclasses.dataclass(frozen=True)
class LPBatch:
    """A batch of B independent LPs of identical shape (m constraints, n vars).

    Arrays are NumPy; shapes are (B, m, n), (B, m), (B, n).

    ``ub`` (optional, (B, n)) are native variable upper bounds: the problem
    becomes ``max c.x s.t. Ax <= b, 0 <= x <= ub`` with +inf marking
    unbounded columns.  ``ub=None`` means all +inf (the paper's original
    standard form); every engine treats the two identically.
    """

    A: np.ndarray
    b: np.ndarray
    c: np.ndarray
    ub: np.ndarray | None = None

    @property
    def batch(self) -> int:
        return self.A.shape[0]

    @property
    def m(self) -> int:
        return self.A.shape[1]

    @property
    def n(self) -> int:
        return self.A.shape[2]

    def upper_bounds(self) -> np.ndarray:
        """The (B, n) bound vector with ``None`` materialized as all +inf —
        what the engines consume (their bounded ratio tests degenerate to
        the classic unbounded test on +inf entries)."""
        if self.ub is None:
            return np.full((self.batch, self.n), np.inf, np.float64)
        return np.asarray(self.ub)

    @staticmethod
    def from_arrays(A, b, c, ub=None) -> "LPBatch":
        A = np.asarray(A)
        b = np.asarray(b)
        c = np.asarray(c)
        if A.ndim == 2:  # single LP convenience
            A, b, c = A[None], b[None], c[None]
            if ub is not None and np.asarray(ub).ndim == 1:
                ub = np.asarray(ub)[None]
        B, m, n = A.shape
        if b.shape != (B, m) or c.shape != (B, n):
            raise ValueError(
                f"inconsistent LP batch shapes: A={A.shape} b={b.shape} c={c.shape}"
            )
        if ub is not None:
            ub = np.asarray(ub, np.float64)
            if ub.shape != (B, n):
                raise ValueError(
                    f"inconsistent ub shape: expected {(B, n)}, got {ub.shape}")
            if (ub < 0).any():
                raise ValueError("ub must be >= 0 (the canonical lower bound)")
            if not np.isfinite(ub).any():
                ub = None  # all +inf is the unbounded case
        return LPBatch(A=A, b=b, c=c, ub=ub)

    def tableau_shape(self) -> Tuple[int, int]:
        """(rows, cols) of the per-LP simplex tableau (incl. both obj rows)."""
        return (self.m + 2, self.n + 2 * self.m + 1)

    def compacted_tableau_shape(self) -> Tuple[int, int]:
        """(rows, cols) of the phase-compacted phase-2 tableau (artificial
        columns and the phase-1 objective row removed)."""
        return (self.m + 1, self.n + self.m + 1)

    def bytes_per_lp(self, dtype_size: int = 4) -> int:
        """Device bytes needed per LP — Eq. (5) of the paper, adapted.

        Tableau + basis + the two reduction scratch vectors (Data/Indices in
        the paper's Fig. 4/5 become the ratio/cost vectors here).
        """
        rows, cols = self.tableau_shape()
        tableau = rows * cols * dtype_size
        basis = self.m * 4
        scratch = 2 * cols * dtype_size  # the paper's two auxiliary arrays
        return tableau + basis + scratch


@dataclasses.dataclass(frozen=True)
class WarmStart:
    """Backend-uniform warm-start carrier: the terminal solver state of one
    batched solve, re-injectable into the next via ``solve_*(..., warm=ws)``.

    ``m``/``n`` are the *canonical* dimensions of the batch the carrier was
    captured from (a basis has no original-coordinate meaning, so for
    general-form solves the carrier stays in canonical space; only the
    equilibration scaling is peeled off its iterate leaves by ``Recovery``).
    A carrier is only usable on a batch whose canonical shape matches
    (B, m, n); mismatches are dropped with a warning at injection
    (forms.prepare_warm), degrading to a cold solve.

    Simplex leaves (tableau/revised engines):
      basis    (B, m) int32 — parent basis (column basic in each row)
      at_upper (B, n) bool  — structural columns nonbasic at their upper
                              bound (tableau ``flip`` / revised ``onub``)
      weights  (B, C)       — pricing weights at termination (``pricing``
                              tags the rule; reused only when rule and
                              shape still match, else re-initialized)
    PDHG leaves:
      x (B, n), y (B, m)    — final iterates (original coordinates)
      omega (B,)            — primal weight at termination
      eta   (B,)            — step size at termination (recorded for
                              completeness; injection re-estimates the step
                              from the new matrix, which is always safe)

    Unused leaves are None — a simplex result carries no PDHG state and
    vice versa, and each engine ignores the other's leaves at injection.
    """

    m: int
    n: int
    basis: np.ndarray | None = None
    at_upper: np.ndarray | None = None
    weights: np.ndarray | None = None
    pricing: str | None = None
    x: np.ndarray | None = None
    y: np.ndarray | None = None
    omega: np.ndarray | None = None
    eta: np.ndarray | None = None

    _ARRAY_FIELDS = ("basis", "at_upper", "weights", "x", "y", "omega", "eta")

    @property
    def batch(self) -> int:
        for f in self._ARRAY_FIELDS:
            v = getattr(self, f)
            if v is not None:
                return np.asarray(v).shape[0]
        return 0

    def _map(self, fn) -> "WarmStart":
        kw = {f: (None if getattr(self, f) is None
                  else fn(np.asarray(getattr(self, f))))
              for f in self._ARRAY_FIELDS}
        return WarmStart(m=self.m, n=self.n, pricing=self.pricing, **kw)

    def take(self, idx) -> "WarmStart":
        """Gather per-LP state along the batch axis (sorting/permutation)."""
        return self._map(lambda a: a[np.asarray(idx)])

    def slice(self, start: int, stop: int) -> "WarmStart":
        """The [start:stop) sub-carrier (chunked solve)."""
        return self._map(lambda a: a[start:stop])

    @staticmethod
    def concat(parts) -> "WarmStart | None":
        """Concatenate per-chunk carriers back into one (chunked solve).
        Any missing part (a chunk whose solver captured no state) drops the
        whole carrier — a partial warm start cannot be re-injected."""
        parts = list(parts)
        if not parts or any(p is None for p in parts):
            return None
        first = parts[0]
        kw = {}
        for f in WarmStart._ARRAY_FIELDS:
            vals = [getattr(p, f) for p in parts]
            if any(v is None for v in vals):
                kw[f] = None
            else:
                kw[f] = np.concatenate([np.asarray(v) for v in vals])
        return WarmStart(m=first.m, n=first.n, pricing=first.pricing, **kw)


@dataclasses.dataclass(frozen=True)
class LPResult:
    """Solver output for a batch: per-LP solution, objective, status, iters,
    and (when the backend provides them) the dual certificate.

    ``y``/``z`` are the backend-independent dual certificate, populated at
    OPTIMAL and NaN elsewhere (None when a path cannot produce duals, e.g.
    the Pallas tableau segment path pre-extraction):

    * ``y`` (B, m) — row duals.  Canonical batches report the duals of
      ``max c.x s.t. Ax <= b, x >= 0`` (y >= 0, strong duality b.y = c.x);
      general batches report original-coordinate row duals under the
      convention ``z = c - A^T y`` with the *original* objective vector, so
      signs follow the problem sense (see forms.Recovery.recover_duals).
    * ``z`` (B, n) — reduced costs ``c - A^T y``; complementary slackness
      pairs them with active bounds (forms.general_kkt is the checker).

    ``warm`` is the terminal solver state (basis/flips/weights for the
    simplex engines, iterates/omega/eta for PDHG) when the solve path
    captures it — the monolithic batched solvers and the chunked solve do;
    compaction-scheduled, distributed and Pallas paths report None.  Feed it
    to the next solve of a perturbed batch via
    ``solve_batched(batch2, warm=res.warm_start())``.

    ``stats`` is a ``repro_torch.obs.SolveReport`` (per-LP telemetry
    counters, host span tree, wall-clock) when the solve ran with
    ``telemetry=True``; None otherwise.  ``stats.iterations`` always
    equals ``iterations``.
    """

    x: np.ndarray          # (B, n)
    objective: np.ndarray  # (B,)
    status: np.ndarray     # (B,) int8  — see status codes above
    iterations: np.ndarray  # (B,) int32
    y: np.ndarray | None = None   # (B, m) row duals (see above)
    z: np.ndarray | None = None   # (B, n) reduced costs
    warm: "WarmStart | None" = None  # terminal state for warm restarts
    stats: "object | None" = None  # obs.SolveReport when telemetry was on

    def warm_start(self) -> WarmStart:
        """The warm-start carrier for a follow-up solve of a same-shape
        (typically perturbed) batch.  Raises when this result came from a
        path that does not capture terminal state (compaction scheduler,
        distributed solvers, Pallas kernels) — solve cold there, or route
        the sequence through a monolithic/chunked entry point."""
        if self.warm is None:
            raise ValueError(
                "this LPResult carries no warm-start state (the producing "
                "path does not capture it — e.g. compaction-scheduled, "
                "distributed or Pallas solves); re-solve through a "
                "monolithic entry point to obtain one")
        return self.warm

    def summary(self) -> str:
        status = np.asarray(self.status)
        parts = [
            f"{STATUS_NAMES[code]}={int((status == code).sum())}"
            for code in sorted(STATUS_NAMES)
            if (status == code).any()
        ]
        return ", ".join(parts)


def build_tableau(A: np.ndarray, b: np.ndarray, c: np.ndarray):
    """Build the batched two-phase tableau (float64 NumPy; init path).

    Returns (T, basis, needs_phase1):
      T:      (B, m+2, n+2m+1)
      basis:  (B, m) int32   — basis[i] = column index basic in row i
      needs_phase1: (B,) bool
    Rows with b_i < 0 are negated (making rhs >= 0) and given an artificial
    variable; other rows start with their slack basic — exactly the paper's
    Sec. 4 construction, except artificial columns exist (as zeros) for all
    rows so the batch keeps one static shape.
    """
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    B, m, n = A.shape
    cols = n + 2 * m + 1
    T = np.zeros((B, m + 2, cols), dtype=np.float64)

    neg = b < 0  # (B, m)
    sign = np.where(neg, -1.0, 1.0)
    T[:, :m, :n] = A * sign[:, :, None]
    # slack block: identity scaled by the row sign
    idx = np.arange(m)
    T[:, idx, n + idx] = sign
    # artificial block: +1 only where the row was negated
    T[:, idx, n + m + idx] = np.where(neg, 1.0, 0.0)
    T[:, :m, -1] = b * sign

    # phase-2 objective row: reduced costs start at c
    T[:, m, :n] = c
    # phase-1 objective row: sum of rows that carry an artificial
    T[:, m + 1, :] = (T[:, :m, :] * neg[:, :, None]).sum(axis=1)
    # basic columns must have zero reduced cost: zero out the artificial
    # columns of the phase-1 row (they are basic where they exist)
    T[:, m + 1, n + m:n + 2 * m] = 0.0

    basis = np.where(neg, n + m + idx[None, :], n + idx[None, :]).astype(np.int32)
    return T, basis, neg.any(axis=1)


def extract_solution(T: np.ndarray, basis: np.ndarray, n: int,
                     ub: np.ndarray | None = None,
                     flip: np.ndarray | None = None):
    """Read (x, objective) off a final tableau batch.

    Batched scatter: structural basis entries (basis < n) write their row's
    rhs into x, everything else lands in a dump slot that is sliced away —
    one vectorized write instead of the old O(m) host loop over rows (a
    legal basis never repeats a column, so the writes cannot collide).

    With the bounded-variable method, columns whose ``flip`` flag is set
    are stored *complemented* (x' = ub - x): a flipped basic column reads
    ``ub - rhs``, a flipped nonbasic column sits at its upper bound.  The
    objective row's rhs already tracks the true objective through every
    flip (the complement substitution updates it), so ``-T[m, -1]`` is
    unchanged."""
    B, rows, cols = T.shape
    m = rows - 2
    rhs = T[:, :m, -1]
    sel = basis[:, :m] < n
    target = np.where(sel, basis[:, :m], n)          # n = dump slot
    xpad = np.zeros((B, n + 1), dtype=T.dtype)
    xpad[np.arange(B)[:, None], target] = np.where(sel, rhs, 0.0)
    x = xpad[:, :n]
    if flip is not None and flip.any():
        # flipped basic: ub - rhs; flipped nonbasic: ub - 0 = ub
        x = np.where(flip[:, :n], np.asarray(ub, dtype=T.dtype) - x, x)
    objective = -T[:, m, -1]
    return x, objective


def default_max_iters(m: int, n: int) -> int:
    """Iteration cap. Dantzig's rule typically terminates in O(m+n) pivots on
    the paper's problem classes; the cap only exists to bound the lockstep
    while-loop."""
    return 10 * (m + n) + 50
