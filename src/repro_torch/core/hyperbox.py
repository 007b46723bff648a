"""Special-case LP over a hyper-rectangle (paper Sec. 5.6).

Counterpart of ``repro.core.hyperbox``.  When the feasible region is a box
[a_1, b_1] x ... x [a_n, b_n], the LP ``max l.x  s.t. x in box`` has the
closed form

    sum_i l_i * (a_i if l_i < 0 else b_i),

a select and a dot product per LP.  The paper gives each LP one GPU thread;
so does the port's kernel (kernels/csrc/hyperbox.cu).  Used by the
reachability study (paper Sec. 7 / Table 7).
"""
from __future__ import annotations

import numpy as np
import torch

from .lp import LPBatch


def solve_hyperbox_ref(lo: np.ndarray, hi: np.ndarray, directions: np.ndarray):
    """NumPy oracle. lo/hi: (B, n) box bounds; directions: (B, n) or (K, n)
    broadcast against the batch. Returns (B,) or (B, K) support values."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    d = np.asarray(directions, np.float64)
    if d.ndim == 2 and d.shape[0] != lo.shape[0]:
        # (K, n) directions applied to every box -> (B, K)
        pick = np.where(d[None, :, :] < 0, lo[:, None, :], hi[:, None, :])
        return (d[None, :, :] * pick).sum(-1)
    pick = np.where(d < 0, lo, hi)
    return (d * pick).sum(-1)


def solve_hyperbox(lo: torch.Tensor, hi: torch.Tensor,
                   directions: torch.Tensor) -> torch.Tensor:
    """Batched box LP on the tensors' device, in float32: (B, n) x (B, n)
    -> (B,) and (B, n) x (K, n) -> (B, K) (K != B).  CUDA tensors go
    through the hyperbox kernel in both forms, CPU tensors through its
    plain version (``kernels.hyperbox_kernel.hyperbox_tile``)."""
    from ..kernels.hyperbox_kernel import hyperbox_tile

    for t in (lo, hi, directions):
        if not isinstance(t, torch.Tensor):
            raise TypeError("solve_hyperbox takes torch tensors; for NumPy "
                            "arrays use kernels.ops.solve_hyperbox_kernel")
    return hyperbox_tile(*(t.to(torch.float32).contiguous()
                           for t in (lo, hi, directions)))


def hyperbox_as_general_lp(lo: np.ndarray, hi: np.ndarray, directions: np.ndarray):
    """Encode box LPs as general-form LPs (for cross-validation against the
    simplex path).  max d.x  s.t. x <= hi, -x <= -lo.  To respect x >= 0 of
    the standard form we substitute y = x - lo (y >= 0 when lo is the lower
    bound):  max d.y + d.lo  s.t.  y <= hi - lo.
    Returns (LPBatch, offset) where true objective = lp objective + offset.
    """
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    d = np.asarray(directions, np.float64)
    B, n = lo.shape
    A = np.tile(np.eye(n)[None], (B, 1, 1))
    b = hi - lo
    offset = (d * lo).sum(-1)
    return LPBatch.from_arrays(A, b, d), offset
