"""Fixed-format MPS reader -> ``GeneralLPBatch`` (NumPy).

A copy of ``repro.io.mps``'s reader and batch constructors (``read_mps``,
``fixture_path``, ``perturbed_batch``, ``perturbed_sequence``): the port
needs them on a machine without JAX.  Parsing accepts the classic sections
(NAME, ROWS, COLUMNS, RHS, RANGES, BOUNDS, ENDATA) plus OBJSENSE, tolerant of
whitespace; ``*`` lines are comments.  ``perturbed_batch`` expands one
instance into a B-sized batch by multiplicative perturbation of the nonzero
data, the paper's recipe for same-shape batches (Sec. 6).  Fixtures resolve
to the repository's ``tests/fixtures/``, shared with the reference package.
"""
from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np

from ..core.forms import GeneralLPBatch

_FIXTURE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))), "tests", "fixtures")

# The vendored general-form instances (tests/fixtures/README.md has the
# provenance notes).  Benchmarks and configs address them by these names.
FIXTURE_NAMES = ("afiro", "sc50b_like", "sc205_like", "testprob")

def fixture_path(name: str) -> str:
    """Absolute path of a vendored fixture (with or without ``.mps``)."""
    if not name.endswith(".mps"):
        name += ".mps"
    return os.path.join(_FIXTURE_DIR, name)


def read_mps(path: str) -> GeneralLPBatch:
    """Parse an MPS file into a single-member ``GeneralLPBatch`` (B=1)."""
    name = "mps"
    maximize = False
    row_order: list = []           # (sense, row_name), objective excluded
    free_rows: set = set()         # secondary N rows (legal MPS; ignored)
    obj_row: Optional[str] = None
    entries: dict = {}             # col -> {row: val}
    col_order: list = []
    rhs: dict = {}
    obj_const = 0.0
    ranges: dict = {}
    bounds: dict = {}              # col -> [lb, ub]
    integer_cols: set = set()      # columns declared integral
    in_integer = False             # inside an INTORG..INTEND marker pair
    section = None

    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            if raw.startswith("*") or not raw.strip():
                continue
            fields = raw.split()
            if not raw[0].isspace():           # section header
                section = fields[0].upper()
                if section == "NAME" and len(fields) > 1:
                    name = fields[1]
                elif section == "OBJSENSE" and len(fields) > 1:
                    maximize = fields[1].upper().startswith("MAX")
                elif section == "ENDATA":
                    break
                continue
            if section == "OBJSENSE":
                maximize = fields[0].upper().startswith("MAX")
            elif section == "ROWS":
                sense, rname = fields[0].upper(), fields[1]
                if sense == "N":
                    if obj_row is None:        # first N row is the objective
                        obj_row = rname
                    else:                      # later N rows are free rows:
                        free_rows.add(rname)   # entries are discarded
                elif sense in ("L", "G", "E"):
                    row_order.append((sense, rname))
                else:
                    raise ValueError(
                        f"{path}:{lineno}: unknown row sense {sense!r}")
            elif section == "COLUMNS":
                if len(fields) >= 3 and fields[1].upper() == "'MARKER'":
                    mk = fields[-1].upper().strip("'")
                    if mk == "INTORG":
                        in_integer = True
                    elif mk == "INTEND":
                        in_integer = False
                    else:
                        warnings.warn(f"{path}:{lineno}: unknown marker "
                                      f"{mk!r} ignored")
                    continue
                col = fields[0]
                if col not in entries:
                    entries[col] = {}
                    col_order.append(col)
                if in_integer:
                    integer_cols.add(col)
                for rname, val in zip(fields[1::2], fields[2::2]):
                    entries[col][rname] = float(val)
            elif section == "RHS":
                # field[0] is the RHS-set label
                for rname, val in zip(fields[1::2], fields[2::2]):
                    if rname == obj_row:
                        obj_const = -float(val)   # MPS objective constant
                    else:
                        rhs[rname] = float(val)
            elif section == "RANGES":
                for rname, val in zip(fields[1::2], fields[2::2]):
                    ranges[rname] = float(val)
            elif section == "BOUNDS":
                btype = fields[0].upper()
                col = fields[2]
                b = bounds.setdefault(col, [0.0, np.inf])
                val = float(fields[3]) if len(fields) > 3 else None
                if btype == "UP":
                    b[1] = val
                    if val is not None and val < 0 and b[0] == 0.0:
                        # historic MPS semantics: a negative UP bound with
                        # no explicit LO frees the variable below
                        b[0] = -np.inf
                elif btype == "LO":
                    b[0] = val
                elif btype == "FX":
                    b[0] = b[1] = val
                elif btype == "FR":
                    b[0], b[1] = -np.inf, np.inf
                elif btype == "MI":
                    b[0] = -np.inf
                elif btype == "PL":
                    b[1] = np.inf
                elif btype == "BV":
                    b[0], b[1] = 0.0, 1.0
                    integer_cols.add(col)
                elif btype == "UI":
                    b[1] = val
                    integer_cols.add(col)
                elif btype == "LI":
                    b[0] = val
                    integer_cols.add(col)
                else:
                    raise ValueError(
                        f"{path}:{lineno}: unsupported bound type {btype!r}")
            elif section in (None, "NAME"):
                raise ValueError(f"{path}:{lineno}: data before any section")

    if obj_row is None:
        raise ValueError(f"{path}: no objective (N) row")
    m, n = len(row_order), len(col_order)
    ridx = {rname: i for i, (_, rname) in enumerate(row_order)}
    A = np.zeros((1, m, n))
    c = np.zeros((1, n))
    for j, col in enumerate(col_order):
        for rname, val in entries[col].items():
            if rname == obj_row:
                c[0, j] = val
            elif rname in ridx:
                A[0, ridx[rname], j] = val
            elif rname not in free_rows:
                raise ValueError(f"{path}: column {col!r} references "
                                 f"unknown row {rname!r}")
    for rname in list(rhs) + list(ranges):
        if rname not in ridx and rname not in free_rows:
            raise ValueError(f"{path}: RHS/RANGES references unknown row "
                             f"{rname!r}")
    sense = np.array([s for s, _ in row_order], dtype="<U1")
    b = np.array([[rhs.get(rname, 0.0) for _, rname in row_order]])
    rng_arr = None
    if any(rname in ridx for rname in ranges):
        rng_arr = np.full(m, np.nan)
        for rname, val in ranges.items():
            if rname in ridx:
                rng_arr[ridx[rname]] = val
    lb = np.zeros((1, n))
    ub = np.full((1, n), np.inf)
    cidx = {col: j for j, col in enumerate(col_order)}
    for col, (blo, bhi) in bounds.items():
        if col not in cidx:
            raise ValueError(f"{path}: BOUNDS references unknown column "
                             f"{col!r}")
        lb[0, cidx[col]], ub[0, cidx[col]] = blo, bhi
    integer = None
    if integer_cols:
        integer = np.array([col in integer_cols for col in col_order], bool)
    return GeneralLPBatch.from_arrays(
        A, sense, b, lb=lb, ub=ub, c=c, c0=obj_const, maximize=maximize,
        ranges=rng_arr, name=name,
        row_names=[rname for _, rname in row_order], col_names=col_order,
        integer=integer)


def perturbed_batch(g: GeneralLPBatch, B: int,
                    rng: Optional[np.random.Generator] = None,
                    rel: float = 0.01,
                    perturb: tuple = ("A", "rhs", "c")) -> GeneralLPBatch:
    """Expand one instance into a B-sized batch the way the paper builds
    its Netlib batches: each member is the instance with nonzero data
    multiplicatively perturbed by ±``rel``.  Member 0 is the unperturbed
    original; structure (sparsity, senses, ranges, bounds, names) is shared
    so the whole batch canonicalizes to one static shape."""
    if rng is None:
        rng = np.random.default_rng(0)
    if g.batch != 1:
        raise ValueError("perturbed_batch expands a single instance "
                         f"(got batch={g.batch})")

    def expand(arr, on):
        tiled = np.repeat(np.asarray(arr, np.float64), B, axis=0)
        if on:
            noise = 1.0 + rel * rng.uniform(-1.0, 1.0, size=tiled.shape)
            noise[0] = 1.0
            tiled = tiled * np.where(tiled != 0.0, noise, 1.0)
        return tiled

    return GeneralLPBatch(
        A=expand(g.A, "A" in perturb),
        sense=g.sense,
        rhs=expand(g.rhs, "rhs" in perturb),
        lb=np.repeat(g.lb, B, axis=0),
        ub=np.repeat(g.ub, B, axis=0),
        c=expand(g.c, "c" in perturb),
        c0=np.repeat(g.c0, B, axis=0),
        maximize=g.maximize, ranges=g.ranges,
        name=f"{g.name}_x{B}", row_names=g.row_names, col_names=g.col_names,
        integer=g.integer)


def perturbed_sequence(g: GeneralLPBatch, B: int, K: int,
                       rng: Optional[np.random.Generator] = None,
                       rel: float = 0.01, step_rel: float = 0.005,
                       perturb: tuple = ("rhs", "c")) -> list:
    """Deterministic trajectory of ``K`` successively-perturbed batches from
    one instance — the shared workload for warm-start benchmarks and tests.

    Batch 0 is ``perturbed_batch(g, B, rel=rel)``; each subsequent batch
    applies an independent multiplicative ±``step_rel`` nudge to the
    *nonzero* entries of the perturbed fields of its predecessor (default
    rhs + c: the bound-edit/objective-nudge workload of MPC loops and
    branch-and-bound frontiers — pass ``perturb=("A", "rhs", "c")`` for
    matrix drift too).  Nudging only nonzeros keeps the sparsity pattern,
    senses, bounds and canonical shape static across the trajectory, which
    is exactly the contract a ``WarmStart`` carrier rides on.  With the
    default ``rng=None`` the trajectory is reproducible (seed 0).
    Returns a list of K ``GeneralLPBatch`` objects."""
    if rng is None:
        rng = np.random.default_rng(0)
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    seq = [perturbed_batch(g, B, rng=rng, rel=rel, perturb=perturb)]

    def nudge(arr, on):
        arr = np.asarray(arr, np.float64)
        if not on:
            return arr.copy()
        noise = 1.0 + step_rel * rng.uniform(-1.0, 1.0, size=arr.shape)
        return arr * np.where(arr != 0.0, noise, 1.0)

    for _ in range(K - 1):
        p = seq[-1]
        seq.append(GeneralLPBatch(
            A=nudge(p.A, "A" in perturb),
            sense=p.sense,
            rhs=nudge(p.rhs, "rhs" in perturb),
            lb=p.lb.copy(), ub=p.ub.copy(),
            c=nudge(p.c, "c" in perturb),
            c0=p.c0.copy(),
            maximize=p.maximize, ranges=p.ranges,
            name=f"{g.name}_seq{len(seq)}", row_names=p.row_names,
            col_names=p.col_names, integer=p.integer))
    return seq
