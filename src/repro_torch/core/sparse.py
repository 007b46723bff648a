"""Shared-pattern sparse batches and the sparse first-order solver.

Counterpart of ``repro.core.sparse``.  Batches that come from one
Netlib-style instance (``io.mps.perturbed_batch``) share a single sparsity
pattern and differ only in the values.  ``SparseLPBatch`` stores one
``(nnz,)`` coordinate pattern (rows, cols) and a ``(B, nnz)`` value array,
and the two PDHG matvecs become

    (A x)_i   = sum over k with rows[k] == i of  vals[:, k] * x[:, cols[k]]
    (A^T y)_j = sum over k with cols[k] == j of  vals[:, k] * y[:, rows[k]]

so an iteration touches ``2*nnz + 2*(m+n)`` elements instead of
``2*m*n + 2*(m+n)``.  Everything else (Ruiz equilibration, step sizes, the
rounds, restarts, certificates, extraction) is the dense engine's code
(core/pdhg.py), which touches A only through a ``Matvecs`` pair.

The reference sums with an XLA scatter-add.  The port uses no scatter and
no atomics: the pattern is shared across the batch, so it is turned once
into a plan of the dense kernels' own sum (``core.fp.tree_sum``: the
halving tree over the column positions of a row, or the row positions of
a column) restricted to the pattern's entries.  At each level of the tree
an entry at position j adds the one at j + h when there is one and is
carried when not; a structural zero adds nothing but a zero, which leaves
a sum unchanged.  So the sparse matvecs, and with them the whole sparse
solve, equal the dense ones bit for bit, from run to run and whatever the
batch.  They are torch operations on the batch's device (CUDA unless the
caller passes ``device="cpu"``); the reference has no sparse kernel, and
neither has the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .fp import sqrt_rn
from .lp import LPBatch, LPResult
from .pdhg import (
    CHECK_EVERY,
    DEFAULT_TOL,
    RUIZ_ITERS,
    Matvecs,
    PdhgState,
    _check_pdhg_pricing,
    default_pdhg_max_iters,
    finish_state,
    pdhg_rounds,
    run_and_extract,
)


def sparse_pdhg_elements(nnz: int, m: int, n: int) -> int:
    """State elements touched per sparse PDHG iteration: the two matvecs
    read the (B, nnz) values twice and write the four length-m/n vectors."""
    return 2 * nnz + 2 * (m + n)


@dataclasses.dataclass(frozen=True)
class SparseLPBatch:
    """B LPs ``max c.x s.t. Ax <= b, 0 <= x <= ub`` sharing one sparsity
    pattern: COO coordinates ``(rows, cols)`` of length nnz and per-LP
    values ``(B, nnz)``.  The batch is canonical by construction; build one
    from a canonical dense ``LPBatch`` with ``from_dense``."""

    rows: np.ndarray            # (nnz,) int32 row of each entry
    cols: np.ndarray            # (nnz,) int32 column of each entry
    vals: np.ndarray            # (B, nnz) per-LP values
    b: np.ndarray               # (B, m)
    c: np.ndarray               # (B, n)
    m: int
    n: int
    ub: Optional[np.ndarray] = None   # (B, n) or None (all +inf)

    @property
    def batch(self) -> int:
        return self.vals.shape[0]

    @property
    def nnz(self) -> int:
        return self.rows.shape[0]

    @property
    def density(self) -> float:
        return self.nnz / float(self.m * self.n)

    def upper_bounds(self) -> np.ndarray:
        if self.ub is None:
            return np.full((self.batch, self.n), np.inf)
        return np.asarray(self.ub)

    @staticmethod
    def from_dense(batch: LPBatch, tol: float = 0.0) -> "SparseLPBatch":
        """The shared pattern as the union of the members' nonzeros
        (|A| > tol in any member); a member where a pattern entry is zero
        carries a zero value."""
        A = np.asarray(batch.A)
        mask = (np.abs(A) > tol).any(axis=0)
        rows, cols = np.nonzero(mask)
        return SparseLPBatch(
            rows=rows.astype(np.int32), cols=cols.astype(np.int32),
            vals=np.ascontiguousarray(A[:, rows, cols]),
            b=np.asarray(batch.b), c=np.asarray(batch.c),
            m=batch.m, n=batch.n, ub=batch.ub)

    def to_dense(self) -> LPBatch:
        """The dense ``(B, m, n)`` batch."""
        A = np.zeros((self.batch, self.m, self.n), self.vals.dtype)
        A[:, self.rows, self.cols] = self.vals
        return LPBatch.from_arrays(A, self.b, self.c, ub=self.ub)


def _ell(keys: np.ndarray, count: int) -> np.ndarray:
    """Per-key lists of pattern positions, padded to the longest list with
    position nnz (which addresses an appended zero): for the maxima."""
    nnz = keys.shape[0]
    width = max(1, int(np.bincount(keys, minlength=count).max(initial=0)))
    pos = np.full((count, width), nnz, np.int64)
    fill = np.zeros(count, np.int64)
    for k, key in enumerate(keys):
        pos[key, fill[key]] = k
        fill[key] += 1
    return pos


def _tree_plan(keys: np.ndarray, pos: np.ndarray, count: int,
               length: int):
    """The levels of ``tree_sum`` over ``length`` positions for ``count``
    sums whose nonzero terms are the entries (keys[k], pos[k]).  Each level
    is a pair of index arrays (left, right) into the previous level's
    values, whose last index addresses an appended zero; ``final`` picks
    each sum from the last level (the zero for an empty one)."""
    P = 1 << max(0, length - 1).bit_length()
    keys = np.asarray(keys, np.int64)
    pos = np.asarray(pos, np.int64)
    levels = []
    h = P // 2
    while h >= 1:
        merged, inv = np.unique(keys * h + pos % h, return_inverse=True)
        inv = inv.reshape(-1)
        left = np.full(merged.shape[0], keys.shape[0], np.int64)
        right = left.copy()
        low = pos < h
        left[inv[low]] = np.nonzero(low)[0]
        right[inv[~low]] = np.nonzero(~low)[0]
        levels.append((left, right))
        keys, pos = merged // h, merged % h
        h //= 2
    final = np.full(count, keys.shape[0], np.int64)
    final[keys] = np.arange(keys.shape[0])
    return levels, final


def _pad0(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([t, t.new_zeros((t.shape[0], 1))], dim=1)


def _tree_apply(v: torch.Tensor, levels, final) -> torch.Tensor:
    for left, right in levels:
        v = _pad0(v)
        v = v[:, left] + v[:, right]
    return _pad0(v)[:, final]


def sparse_matvecs(rows, cols, m: int, n: int, device) -> Matvecs:
    """The shared-pattern matvec pair; ``data`` is the (B, nnz) value
    array.  Row i of ``A x`` sums ``vals[:, k] * x[:, cols[k]]`` over its
    entries in the dense kernels' order (``_tree_plan``), so it equals
    ``pdhg.dense_ax`` of the dense matrix bit for bit; likewise ``A^T y``."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)

    def put(plan):
        levels, final = plan
        return ([(torch.as_tensor(a, device=device),
                  torch.as_tensor(b, device=device)) for a, b in levels],
                torch.as_tensor(final, device=device))

    row_plan = put(_tree_plan(rows, cols, m, n))
    col_plan = put(_tree_plan(cols, rows, n, m))
    ci = torch.as_tensor(cols, device=device)
    ri = torch.as_tensor(rows, device=device)

    def ax(vals, x):
        return _tree_apply(vals * x[:, ci], *row_plan)

    def aty(vals, y):
        return _tree_apply(vals * y[:, ri], *col_plan)

    return Matvecs(ax=ax, aty=aty)


def _segment_max(W: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Per-list maxima of a nonnegative (B, nnz) array over ELL lists (the
    padding reads 0, as an empty row's scatter-max does)."""
    return _pad0(W)[:, pos].amax(dim=2)


def _ruiz_equilibrate_sparse(vals, rows, cols, m: int, n: int,
                            iters: int = RUIZ_ITERS):
    """Sparse twin of ``pdhg.ruiz_equilibrate``: row and column inf-norms
    over the pattern (maxima are exact, so the scales equal the dense
    ones); empty rows and columns keep scale 1."""
    B = vals.shape[0]
    dev = vals.device
    rows_np = np.asarray(rows, np.int64)
    cols_np = np.asarray(cols, np.int64)
    r_pos = torch.as_tensor(_ell(rows_np, m), device=dev)
    c_pos = torch.as_tensor(_ell(cols_np, n), device=dev)
    ri = torch.as_tensor(rows_np, device=dev)
    ci = torch.as_tensor(cols_np, device=dev)
    av = vals.abs()
    r = torch.ones((B, m), dtype=vals.dtype, device=dev)
    s = torch.ones((B, n), dtype=vals.dtype, device=dev)
    one = torch.ones((), dtype=vals.dtype, device=dev)
    for _ in range(iters):
        rn = _segment_max(av * r[:, ri] * s[:, ci], r_pos)
        r = r / sqrt_rn(torch.where(rn > 0, rn, one))
        cn = _segment_max(av * r[:, ri] * s[:, ci], c_pos)
        s = s / sqrt_rn(torch.where(cn > 0, cn, one))
    return r, s


def init_pdhg_state_sparse(vals, b, c, ub, rows, cols, m: int, n: int,
                           mv: Matvecs) -> PdhgState:
    """Sparse twin of ``pdhg.init_pdhg_state``: the same state with
    ``PdhgState.A`` holding the (B, nnz) scaled values, which every later
    step touches only through ``mv``."""
    r, s = _ruiz_equilibrate_sparse(vals, rows, cols, m, n)
    ri = torch.as_tensor(np.asarray(rows, np.int64), device=vals.device)
    ci = torch.as_tensor(np.asarray(cols, np.int64), device=vals.device)
    vs = vals * r[:, ri] * s[:, ci]
    return finish_state(vs, b, c, ub, r, s, mv, n)


def solve_batched_pdhg_sparse(batch: SparseLPBatch, *, device=None,
                              tol: Optional[float] = None,
                              feas_tol: Optional[float] = None,
                              max_iters: Optional[int] = None,
                              check_every: int = CHECK_EVERY,
                              pricing: str = "dantzig") -> LPResult:
    """Restarted PDHG over a shared-pattern sparse batch, in float32 on
    ``device`` (CUDA unless ``device="cpu"``).  Counterpart of
    ``repro.core.sparse.solve_batched_pdhg_sparse``: the tolerance
    semantics and ``LPResult`` contract of ``solve_batched_pdhg``
    (statuses at ``tol``, the primal-dual certificate in ``y``/``z``), the
    fixed step, no warm start.  Takes a ``SparseLPBatch`` only."""
    if not isinstance(batch, SparseLPBatch):
        raise TypeError(
            "solve_batched_pdhg_sparse takes a SparseLPBatch; wrap a "
            "canonical dense batch with SparseLPBatch.from_dense(batch) "
            "or call the dense solver")
    _check_pdhg_pricing(pricing)
    del feas_tol
    dev = resolve_device(device)
    m, n = batch.m, batch.n
    if max_iters is None:
        max_iters = default_pdhg_max_iters(m, n)
    mv = sparse_matvecs(batch.rows, batch.cols, m, n, dev)

    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)

    state = init_pdhg_state_sparse(put(batch.vals), put(batch.b),
                                   put(batch.c), put(batch.upper_bounds()),
                                   batch.rows, batch.cols, m, n, mv)
    out = run_and_extract(state, pdhg_rounds(max_iters, check_every),
                          tol=DEFAULT_TOL if tol is None else float(tol),
                          check_every=int(check_every), mv=mv)
    x, obj, status, iters, y, z = (t.cpu().numpy() for t in out[:6])
    return LPResult(x=x, objective=obj, status=status, iterations=iters,
                    y=y, z=z)
