"""Float32 arithmetic with the rounding of the reference engine.

The reference's CPU build (XLA) contracts every ``a - b * c`` of the pivot
loop into one fused multiply-add, and reduces over tableau rows by
accumulating ``acc = fma(x_i, y_i, acc)`` in row order (for up to 32 rows;
larger reductions are reassociated).  A plain PyTorch expression rounds the
product and the sum separately, which moves tableau entries by an ulp and,
on degenerate LPs, changes ties in the ratio test and so the pivot path.
The port's engine and its CUDA kernel (``__fmaf_rn``) both round once, as
here, so all three compute the same function bit for bit.
"""
from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` (broadcasting), as a fused
    multiply-add computes it.

    The product of two float32 values is exact in float64.  The float64 sum
    is made exact with TwoSum and rounded to odd, which makes the final
    float64 -> float32 rounding the only one (no double rounding)."""
    p = a.double() * b.double()
    c64 = c.double().expand_as(p)
    s = p + c64
    bb = s - p
    err = (c64 - bb).add_(p.sub_(s - bb))
    # round to odd: an inexact sum with an even last bit moves one ulp
    # toward the exact value, so ties cannot be resolved twice
    fix = (err != 0) & ((s.view(torch.int64) & 1) == 0) & torch.isfinite(s)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where(fix, torch.nextafter(s, toward), s)
    return s.float()


def colsum_fma(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``sum_i x[:, i] * y[:, i]`` over dim 1, accumulated in row order
    with one rounding per term: ``acc = fma(x_i, y_i, acc)``."""
    acc = torch.zeros(torch.broadcast_shapes(x[:, 0].shape, y[:, 0].shape),
                      dtype=torch.float32, device=x.device)
    for i in range(x.shape[1]):
        acc = fma(x[:, i], y[:, i], acc)
    return acc
