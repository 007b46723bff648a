"""Data-source mixture weights as a batch of LPs: the paper's technique in
the data layer (the reference's ``data/mixture.py``).

Choose source weights w to maximize the estimated utility u.w under the
per-source availability caps, a diversity floor per source and a total
of at most 1:

    max  u.w
    s.t. w_i <= cap_i            (availability)
         -w_i <= -floor_i        (diversity floor: the start w = 0 is
                                  infeasible, so phase 1 runs)
         sum w <= 1

One LP per row of utility estimates (one per validation slice, say), all
solved at once by ``solve_batched``'s tableau backend: the whole-solve
simplex kernel on the card, its plain version on the CPU.
"""
from __future__ import annotations

import numpy as np

from ..core import OPTIMAL, LPBatch, solve_batched


def optimal_mixture(utilities, caps, floors, *, device=None) -> np.ndarray:
    """utilities: (B, S) utility estimates (or one (S,) row); caps and
    floors: (S,) or (B, S).  Returns the (B, S) mixture weights, each row
    normalized to sum 1: the LP's optimum, or the uniform mixture for a
    row whose LP does not end OPTIMAL.  Solves on ``device`` (the card
    unless ``"cpu"``)."""
    utilities = np.atleast_2d(np.asarray(utilities, np.float64))
    B, S = utilities.shape
    caps = np.broadcast_to(caps, (B, S)).astype(np.float64)
    floors = np.broadcast_to(floors, (B, S)).astype(np.float64)
    eye = np.tile(np.eye(S)[None], (B, 1, 1))
    A = np.concatenate([eye, -eye, np.ones((B, 1, S))], axis=1)
    b = np.concatenate([caps, -floors, np.ones((B, 1))], axis=1)
    res = solve_batched(LPBatch.from_arrays(A, b, utilities), device=device)
    w = np.where((res.status == OPTIMAL)[:, None], res.x, 1.0 / S)
    return w / np.maximum(w.sum(-1, keepdims=True), 1e-9)
