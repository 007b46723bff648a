"""Identities the revised kernel's design rests on (csrc/revised_tile.cu),
checked on the CPU against the plain version's arithmetic bit for bit.

The kernel skips terms and reorders loops only where the result cannot
change: a slack column is priced as one product while every y is finite; a
zero term of c_B (BTRAN) or of a_e (FTRAN) is skipped while Binv is finite;
each term is one fused float64 multiply-add; the Gauss-Jordan permutes
rows instead of swapping them and runs its steps in panels whose bulk takes
several steps in one pass; the eta update writes the pivot row last.
Each test models the kernel's loop in torch and holds it against
``core/fp.py`` ``sum_products`` and ``core/revised.py`` ``refactorize``.
The shared-memory accounting is the kernel's own (its C exports), so its
test needs the built kernel and runs only on a card.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro_torch.core.fp import fma, sum_products
from repro_torch.core.revised import refactorize
from repro_torch.kernels.revised_tile import (MAX_THREADS, block_threads,
                                              smem_bytes, workspace_floats)

OPTIN = 232448          # H100: shared memory a block may opt into
SM_SMEM = 233472        # H100: shared memory of an SM
RESERVED = 1024         # reserved by the runtime for each block


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, any NaN equal to any NaN."""
    nan = torch.isnan(a) & torch.isnan(b)
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | nan).all())


def _chain(col: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """The plain version's dot product: sum_products over index order."""
    return sum_products(col[None, :], vec[None, :], 1)[0]


def _one_product(s: float, y: float) -> torch.Tensor:
    """The kernel's slack price: 0 + sign_i * y_i in double, then float."""
    t = torch.tensor([s], dtype=torch.float64) * torch.tensor(
        [y], dtype=torch.float32).double()
    return (torch.zeros(1, dtype=torch.float64) + t).float()[0]


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("yi", [0.75, 0.0, -0.0, 3e38, float("inf"),
                                float("nan")])
def test_slack_column_prices_as_one_product_while_y_is_finite(sign, yi):
    rng = np.random.default_rng(3)
    m, i = 9, 4
    col = torch.zeros(m)
    col[i] = sign
    col[1] = -0.0                       # a signed zero off the diagonal
    y = torch.tensor(rng.standard_normal(m), dtype=torch.float32)
    y[2], y[6] = 0.0, -0.0
    y[i] = yi
    others_finite = bool(torch.isfinite(torch.cat([y[:i], y[i + 1:]])).all())
    assert others_finite
    assert _bits_equal(_chain(col, y), _one_product(sign, yi))


@pytest.mark.parametrize("bad", [float("inf"), float("-inf"), float("nan")])
def test_slack_shortcut_must_not_be_taken_when_another_y_is_not_finite(bad):
    m, i = 6, 2
    col = torch.zeros(m)
    col[i] = -1.0
    y = torch.linspace(-2, 3, m)
    y[4] = bad                          # 0 * bad is NaN in the full chain
    full = _chain(col, y)
    assert torch.isnan(full)
    assert not torch.isnan(_one_product(-1.0, float(y[i])))


def test_zero_terms_never_change_a_sum_that_started_at_plus_zero():
    """acc + (+-0) == acc bit for bit when acc started at +0, because an
    add of two values is -0 only when both are -0."""
    vals = [0.0, -0.0, 1.5, -2.25, 1e-310, float("inf"), float("-inf")]
    for first in vals:
        acc = torch.zeros(1, dtype=torch.float64) + first
        for z in (0.0, -0.0):
            got = acc + z
            assert got.view(torch.int64) == acc.view(torch.int64) or (
                first == 0.0 and got.item() == 0.0
                and not torch.signbit(got).item())


@pytest.mark.parametrize("seed", range(4))
def test_zero_cb_terms_skip_in_btran(seed):
    rng = np.random.default_rng(seed)
    m = 23
    Binv = torch.tensor(rng.standard_normal((m, m)), dtype=torch.float32)
    cB = torch.tensor(rng.standard_normal(m), dtype=torch.float32)
    zero = rng.random(m) < 0.6
    cB[torch.from_numpy(zero)] = 0.0
    cB[torch.from_numpy(zero & (rng.random(m) < 0.5))] = -0.0
    keep = torch.nonzero(cB != 0)[:, 0]
    full = sum_products(Binv, cB[:, None], 0)          # y_j over rows
    skipped = sum_products(Binv[keep], cB[keep][:, None], 0)
    assert _bits_equal(full, skipped)
    # with a non-finite entry in a skipped row the full sum is NaN: the
    # kernel skips only while Binv is finite
    row = int(torch.nonzero(cB == 0)[0, 0])
    Binv[row, 3] = float("inf")
    assert torch.isnan(sum_products(Binv, cB[:, None], 0)[3])
    assert not torch.isnan(sum_products(Binv[keep], cB[keep][:, None], 0)[3])


@pytest.mark.parametrize("entering", ["structural", "slack"])
def test_zero_ae_terms_skip_in_ftran(entering):
    rng = np.random.default_rng(11)
    m = 17
    Binv = torch.tensor(rng.standard_normal((m, m)), dtype=torch.float32)
    if entering == "slack":             # a_e = sign_k e_k
        ae = torch.zeros(m)
        ae[5] = -1.0
    else:                               # a sparse structural column
        ae = torch.tensor(rng.standard_normal(m), dtype=torch.float32)
        ae[torch.from_numpy(rng.random(m) < 0.5)] = 0.0
    keep = torch.nonzero(ae != 0)[:, 0]
    full = sum_products(Binv, ae[None, :], 1)          # u_i over columns
    skipped = sum_products(Binv[:, keep], ae[keep][None, :], 1)
    assert _bits_equal(full, skipped)
    if entering == "slack":             # one product, exactly
        one = (torch.zeros(m, dtype=torch.float64)
               + Binv[:, 5].double() * -1.0).float()
        assert _bits_equal(full, one)


def test_fused_term_rounds_as_the_exact_product_plus_one_add():
    """fma(a, b, acc) in double equals acc + a * b with the product exact:
    a float32 product has at most 48 significant bits.  The reference is
    the exact rational sum rounded once (Fraction -> float rounds to
    nearest even)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(400).astype(np.float32) * np.float32(3e18)
    b = rng.standard_normal(400).astype(np.float32) * np.float32(1e-9)
    acc = rng.standard_normal(400) * 1e10
    for x, y, s in zip(a, b, acc):
        fused = float(Fraction(float(x)) * Fraction(float(y)) + Fraction(s))
        assert fused == s + float(x) * float(y)


def test_a_zero_dividend_gives_the_signed_zero_of_the_division():
    """The kernel answers 0 / b itself (the sign of a xor the sign of b)
    for every b but 0 and NaN, which go to the full division."""
    a = torch.tensor([0.0, -0.0], dtype=torch.float32)
    b = torch.tensor([1.0, -1.0, 3e38, -1e-45, float("inf"), float("-inf"),
                      0.5], dtype=torch.float32)
    got = a[:, None] / b[None, :]
    sign = (a.view(torch.int32)[:, None] ^ b.view(torch.int32)[None, :]) \
        & torch.tensor(-2 ** 31, dtype=torch.int32)
    assert torch.equal(got.view(torch.int32), sign)
    for bad in (0.0, -0.0, float("nan")):
        assert torch.isnan(a / bad).all()


def _kernel_refactor(Bmat: torch.Tensor, panel: int = 4) -> torch.Tensor:
    """The kernel's Gauss-Jordan on one [B | I], in its order: rows stay in
    place behind a permutation; steps run in panels; step j of a panel
    computes column k (the multipliers) and the pivot row with the panel's
    earlier steps applied, picks the pivot (largest |entry| among the
    logical rows at or below k, lowest on ties, NaN first), and the bulk of
    the matrix takes the panel's steps in order afterwards; a pivot row is
    set to its r at its own step."""
    m = Bmat.shape[0]
    M = torch.cat([Bmat, torch.eye(m)], dim=1).clone()
    perm = list(range(m))
    for k0 in range(0, m, panel):
        kb = min(panel, m - k0)
        mult = torch.zeros((m, kb))
        rows, pivs = [], []                   # pivot rows r_j, their rows
        for j in range(kb):
            k = k0 + j
            col = M[:, k].clone()             # (A) column k, earlier steps
            for i in range(j):
                col = fma(-mult[:, i], rows[i][k].expand(m), col)
                col[pivs[i]] = rows[i][k]
            mult[:, j] = col
            cand = col[perm[k:]].abs()        # (B) the pivot and its row
            p = k + int(torch.argmax(cand))
            qp = perm[p]
            row = M[qp].clone()
            for i in range(j):
                row = fma(-mult[qp, i].expand(2 * m), rows[i], row)
            rows.append(row / col[qp])
            pivs.append(qp)
            perm[k], perm[p] = perm[p], perm[k]
        live = slice(k0 + kb, 2 * m)          # (C) the bulk
        for q in range(m):
            val = M[q, live]
            for i in range(kb):
                val = rows[i][live] if q == pivs[i] else \
                    fma(-mult[q, i].expand_as(val), rows[i][live], val)
            M[q, live] = val
    return M[perm, m:]


@pytest.mark.parametrize("case", ["random", "permuted", "tied", "singular"])
def test_elimination_order_matches_refactorize(case):
    rng = np.random.default_rng(21)
    m = 11
    B = torch.tensor(rng.standard_normal((m, m)), dtype=torch.float32)
    if case == "permuted":              # a basis of signed unit columns
        B = torch.eye(m)[torch.from_numpy(rng.permutation(m))]
        B[:, 3] *= -1
    elif case == "tied":                # equal magnitudes in a column
        B[:, 0] = torch.tensor([1.0, -1.0] * 5 + [1.0])
    elif case == "singular":            # a zero pivot: inf and NaN rows
        B[:, 4] = B[:, 2]
    Abar = B[None]
    basis = torch.arange(m, dtype=torch.int32)[None]
    want = refactorize(Abar, basis)[0]
    for panel in (1, 4):
        assert _bits_equal(_kernel_refactor(B, panel), want), panel
    assert bool(torch.isfinite(want).all()) == (case != "singular")


def test_eta_update_overwrites_the_pivot_row_after_the_sweep():
    rng = np.random.default_rng(4)
    m, l = 13, 6
    Binv = torch.tensor(rng.standard_normal((m, m)), dtype=torch.float32)
    u = torch.tensor(rng.standard_normal(m), dtype=torch.float32)
    u[2] = 0.0
    # the plain version's update (core/revised.py _step)
    pivrow = Binv[l] / u[l]
    want = fma(-u[:, None], pivrow[None, :], Binv)
    want[l] = pivrow
    # the kernel's: the pivot row into a buffer, every row (row l too)
    # minus u_i times it, then row l overwritten
    r = Binv[l] / u[l]
    got = Binv.clone()
    for i in range(m):
        got[i] = fma(-u[i].expand(m), r, got[i])
    got[l] = r
    assert _bits_equal(got, want)


def _binv_ld(m: int) -> int:
    """The kernel's rule (csrc/revised_tile.cu ``binv_ld``): the least
    ld >= m with ld = 4 (mod 8)."""
    return m + (12 - m % 8) % 8


def test_binv_ld_keeps_float4_row_reads_conflict_free():
    for m in list(range(1, 70)) + [100, 159, 246, 300, 800]:
        ld = _binv_ld(m)
        assert ld % 8 == 4 and m <= ld < m + 8, m
        # a quarter warp (8 lanes, rows i..i+7) reading one float4 column
        # group touches 8 distinct 16-byte bank groups
        for i0 in range(0, 16):
            groups = {((i0 + i) * ld // 4) % 8 for i in range(8)}
            assert len(groups) == 8, (m, i0)


@pytest.mark.parametrize("m,n", [(100, 100), (35, 32), (246, 159), (4, 5),
                                 (300, 300), (500, 20), (800, 400)])
def test_block_threads_cover_candidates_and_column_groups(m, n):
    """One thread a candidate, rounded up to a warp, at most 384.  The
    elimination's and the eta update's column groups (ld/2 and ld/4) set
    no floor: with more groups than threads each thread loops over them
    (the card-only tests run such blocks)."""
    t = block_threads(m, n)
    assert t % 32 == 0 and 32 <= t <= MAX_THREADS
    assert t >= min(n + m, MAX_THREADS)
    assert t == min(MAX_THREADS, -(-(n + m) // 32) * 32)


@pytest.mark.gpu
def test_shared_memory_accounting_at_the_paper_shapes():
    """The kernel's own accounting (revised_tile_smem_bytes and
    revised_tile_workspace_floats) at the paper's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and the built kernel")
    # 100 x 100: A's region and Binv in shared memory, two LPs an SM
    full = smem_bytes(100, 100)
    assert full == 96608
    assert 2 * (full + RESERVED) <= SM_SMEM < 3 * (full + RESERVED)
    scratch = 4 * (4 * 100 + 4 * 100 + 8 * 100 + 2 * 4 * 100)
    assert full - smem_bytes(100, 100, workspace=False) \
        == scratch + 4 * (100 * 100 + 100 * _binv_ld(100))
    # 35 x 32 (canonical afiro): the left half (35 x 36) outgrows A (35 x 32)
    small = smem_bytes(35, 32)
    scratch = 4 * (2 * 36 + 140 + 8 * 36 + 2 * 2 * 36)
    assert small - smem_bytes(35, 32, workspace=False) \
        == scratch + 4 * (35 * 36 + 35 * 36)
    assert SM_SMEM // (small + RESERVED) >= 8    # registers bound it first
    # 246 x 159 (sc205_like): the workspace does not fit; the vectors do,
    # and the device-memory workspace is two m x ld halves and the scratch
    assert smem_bytes(246, 159) > OPTIN
    assert smem_bytes(246, 159, workspace=False) < 64 * 1024
    assert workspace_floats(246) == 2 * 246 * 252 + (
        8 * 252 + 4 * 246 + 8 * 252 + 2 * 8 * 252)
    # the device variant's shared memory holds vectors only: about
    # 4n + 13m words, so a basis of 3,000 rows still fits
    assert smem_bytes(3000, 3000, workspace=False) < OPTIN
