"""Pluggable pricing engine: pivot-column selection rules for the batched
simplex, in two dialects.

Counterpart of ``repro.core.pricing``.  The batched torch dialect below is
used by the port's engine (core/simplex.py) and restated per column in the
CUDA kernel (kernels/csrc/simplex_tile.cu); the scalar NumPy dialect is a
copy of the reference's and drives the float64 oracle (core/reference.py).

* ``dantzig``        — e = argmax_j d_j (the paper's rule).
* ``steepest_edge``  — e = argmax_j d_j^2 / gamma_j with exact weights
                       gamma_j = 1 + ||T[:m, j]||^2, recomputed after every
                       pivot.
* ``devex``          — e = argmax_j d_j^2 / w_j with Forrest/Goldfarb
                       approximate weights (reset to 1 on overflow).
* ``partial``        — Dantzig restricted to a rotating block of columns
                       (block clock = the LP's iteration count), falling
                       back to full Dantzig when the block prices out.

Ties break to the first index, as ``torch.argmax`` (and ``jnp.argmax`` in
the reference) do.  Steepest-edge column norms accumulate in row order with
one rounding per term (core/fp.py), the reference's order on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from .fp import colsum_fma
from .lp import BIG

PRICING_RULES = ("dantzig", "steepest_edge", "devex")
ALL_PRICING = PRICING_RULES + ("partial",)

# Devex framework reset: when any reference weight exceeds this, the whole
# framework restarts at 1 (standard practice; keeps f32 scores well-scaled).
DEVEX_RESET = 1e7

# Partial pricing: candidate columns are scanned in blocks of this many
# columns (clamped to the candidate count), as in the reference.
PARTIAL_BLOCK = 64


def canonicalize_rule(pricing: str) -> str:
    """Validate and normalize a pricing-rule name."""
    rule = str(pricing).lower()
    if rule not in ALL_PRICING:
        raise ValueError(
            f"unknown pricing rule {pricing!r}; expected one of {ALL_PRICING}")
    return rule


def partial_geometry(ncand: int, block: int | None = None):
    """(n_blocks, block_size) for partial pricing over ``ncand`` candidate
    columns.  Shared by every dialect so the block schedule is identical."""
    blk = min(int(block or PARTIAL_BLOCK), ncand)
    return -(-ncand // blk), blk


def partial_priced_candidates(ncand: int, block: int | None = None,
                              partial: bool = True) -> int:
    """Candidate columns priced per pivot: one block pass plus the
    amortized full fallback (about once per block cycle); a single block
    is full pricing."""
    if not partial:
        return ncand
    n_blocks, blk = partial_geometry(ncand, block)
    if n_blocks <= 1:
        return ncand
    return blk + ncand // n_blocks


# ---------------------------------------------------------------------------
# Batched torch dialect (core/simplex.py)
# ---------------------------------------------------------------------------

def init_weights(rule: str, T: torch.Tensor, m: int) -> torch.Tensor:
    """Initial (B, C) pricing weights for a batch of tableaux: exact
    gamma_j = 1 + ||T[:m, j]||^2 for steepest_edge, ones otherwise."""
    B, _, C = T.shape
    if rule == "steepest_edge":
        return 1.0 + colsum_fma(T[:, :m, :], T[:, :m, :])
    return torch.ones((B, C), dtype=T.dtype, device=T.device)


def select_entering(masked_cost: torch.Tensor, w: torch.Tensor, *, rule: str,
                    tol: float, iters: torch.Tensor | None = None,
                    ncand: int | None = None):
    """Step 1 under a pricing rule.  ``masked_cost`` is the objective row
    with disallowed columns at -BIG.  Returns ``(e, max_cost)``: the
    entering column per LP and the max reduced cost (the rule-independent
    optimality test).  ``partial`` also needs the per-LP iteration clock
    ``iters`` and the priceable-column count ``ncand``."""
    max_cost = masked_cost.amax(dim=1)
    if rule == "dantzig":
        e = masked_cost.argmax(dim=1)
    elif rule == "partial":
        n_blocks, blk_sz = partial_geometry(ncand)
        blk = iters % n_blocks
        cols = torch.arange(masked_cost.shape[1], device=masked_cost.device)
        in_blk = (cols // blk_sz)[None, :] == blk[:, None]
        blk_cost = torch.where(in_blk, masked_cost, -BIG)
        blk_max = blk_cost.amax(dim=1)
        e = torch.where(blk_max > tol, blk_cost.argmax(dim=1),
                        masked_cost.argmax(dim=1))
    else:
        improving = masked_cost > tol
        d = torch.where(improving, masked_cost, 0.0)
        score = torch.where(improving, d * d / w, -BIG)
        e = score.argmax(dim=1)
    return e, max_cost


def update_weights(rule: str, w, T_new, pivrow, pe_safe, e, r, do_pivot,
                   *, m: int, n: int):
    """Post-pivot weight recurrence.  ``T_new`` is the tableau after the
    pivot, ``pivrow`` the scaled pivot row, ``pe_safe`` the pivot element
    (1 where ~do_pivot), ``e``/``r`` the entering column and the leaving
    variable's column.  Non-pivoting LPs keep their weights bitwise.
    Devex pins the weights of non-priceable columns (index >= n+m) to 1, as
    every dialect of the reference does."""
    if rule in ("dantzig", "partial"):
        return w
    if rule == "steepest_edge":
        w_new = 1.0 + colsum_fma(T_new[:, :m, :], T_new[:, :m, :])
        return torch.where(do_pivot[:, None], w_new, w)
    cols = torch.arange(w.shape[1], device=w.device)
    w_e = w.gather(1, e[:, None])[:, 0]
    w_new = torch.maximum(w, pivrow * pivrow * w_e[:, None])
    w_leave = torch.clamp(w_e / (pe_safe * pe_safe), min=1.0)
    w_new = torch.where(cols[None, :] == r[:, None], w_leave[:, None], w_new)
    w_new = torch.where(cols[None, :] == e[:, None], 1.0, w_new)
    w_new = torch.where((cols < n + m)[None, :], w_new, 1.0)
    overflow = w_new.amax(dim=1) > DEVEX_RESET
    w_new = torch.where(overflow[:, None], 1.0, w_new)
    return torch.where(do_pivot[:, None], w_new, w)


def compact_weights(w: torch.Tensor, *, m: int, n: int) -> torch.Tensor:
    """Phase compaction for weights: keep structurals+slacks and the rhs
    slot, (B, n+2m+1) -> (B, n+m+1), as the tableau's column drop."""
    return torch.cat([w[:, :n + m], w[:, -1:]], dim=1)


# ---------------------------------------------------------------------------
# Scalar NumPy dialect (core/reference.py float64 oracle), copied
# ---------------------------------------------------------------------------

def init_weights_np(rule: str, T: np.ndarray, m: int) -> np.ndarray:
    """(C,) initial weights for one float64 tableau (see init_weights)."""
    if rule == "steepest_edge":
        return 1.0 + (T[:m] * T[:m]).sum(axis=0)
    return np.ones(T.shape[1])


def select_entering_np(reduced: np.ndarray, w: np.ndarray, *, rule: str,
                       tol: float, iters: int = 0,
                       ncand: int | None = None) -> int:
    """Scalar Step 1 (reduced costs with disallowed columns at -BIG).

    ``partial`` scans the candidate block selected by the LP's iteration
    clock (``iters``) and falls back to full Dantzig when it prices out —
    the same schedule as the JAX dialects, so oracle pivot sequences remain
    the per-rule ground truth."""
    if rule == "dantzig":
        return int(np.argmax(reduced))
    if rule == "partial":
        n_blocks, blk_sz = partial_geometry(ncand)
        blk = iters % n_blocks
        blk_red = reduced[blk * blk_sz:(blk + 1) * blk_sz]
        if blk_red.size and np.max(blk_red) > tol:
            return blk * blk_sz + int(np.argmax(blk_red))
        return int(np.argmax(reduced))
    improving = reduced > tol
    d = np.where(improving, reduced, 0.0)
    score = np.where(improving, d * d / w, -BIG)
    return int(np.argmax(score))


def update_weights_np(rule: str, w: np.ndarray, T_new: np.ndarray,
                      pivrow: np.ndarray, pe: float, e: int, r: int,
                      *, m: int, n: int) -> np.ndarray:
    """Scalar post-pivot recurrence (see update_weights, including the devex
    non-priceable-column pin)."""
    if rule in ("dantzig", "partial"):
        return w
    if rule == "steepest_edge":
        return 1.0 + (T_new[:m] * T_new[:m]).sum(axis=0)
    w_e = w[e]
    w = np.maximum(w, pivrow * pivrow * w_e)
    w[r] = max(w_e / (pe * pe), 1.0)
    w[e] = 1.0
    w[n + m:] = 1.0
    if w.max() > DEVEX_RESET:
        w[:] = 1.0
    return w
