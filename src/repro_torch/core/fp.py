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


def dot_last(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``sum_j x[..., j] * y[..., j]`` over the last dim, in index order
    with one rounding per term (a matrix-vector product row by row)."""
    shape = torch.broadcast_shapes(x[..., 0].shape, y[..., 0].shape)
    acc = torch.zeros(shape, dtype=torch.float32, device=x.device)
    for j in range(x.shape[-1]):
        acc = fma(x[..., j], y[..., j], acc)
    return acc


def sum_products(x: torch.Tensor, y: torch.Tensor, dim: int) -> torch.Tensor:
    """``sum_k x_k * y_k`` over ``dim`` (broadcasting) for float32 inputs:
    each product is exact in float64, the products are added in index
    order in float64 (one rounding per term) and the sum is rounded once
    to float32.  The revised kernel sums its dot products this way
    (``__dmul_rn``/``__dadd_rn``), so the two agree bit for bit; here it
    costs one tensor operation per term, where an exactly rounded float32
    multiply-add (``fma``) costs about fifteen."""
    prods = (x.double() * y.double()).movedim(dim, 0)
    acc = torch.zeros(prods.shape[1:], dtype=torch.float64, device=x.device)
    for term in prods:
        acc = acc + term
    return acc.float()


def rowsum(x: torch.Tensor) -> torch.Tensor:
    """``sum_i x[:, i]`` over dim 1, added in row order (one rounding per
    term), as the kernels sum."""
    acc = torch.zeros(x[:, 0].shape, dtype=x.dtype, device=x.device)
    for i in range(x.shape[1]):
        acc = acc + x[:, i]
    return acc


def tree_sum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``sum_k t_k`` over ``dim`` in the order of the PDHG kernels
    (csrc/pdhg_tile.cu): the terms are zero-padded to the next power of
    two L, then the upper half is added onto the lower one, ``s[i] +=
    s[i + h]`` for h = L/2, L/4, ..., 1, one rounding per add.  That is
    log2(L) tensor operations, and each entry of the result depends only
    on its own terms, so the sum does not depend on the batch."""
    dim = dim % t.dim()
    L = t.shape[dim]
    P = 1 << max(0, L - 1).bit_length()
    if P != L:
        pad = list(t.shape)
        pad[dim] = P - L
        t = torch.cat([t, t.new_zeros(pad)], dim)
    while P > 1:
        P //= 2
        t = t.narrow(dim, 0, P) + t.narrow(dim, P, P)
    return t.squeeze(dim)


def sqrt_rn(t: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (``__fsqrt_rn``).  PyTorch's
    vectorized float32 ``sqrt`` on the CPU is not; the float64 root of a
    float32 value rounds to the correct float32 one."""
    return torch.sqrt(t.double()).float()
