"""The port's warm starts against the reference.

A parent's ``WarmStart`` (its terminal basis and bound flags) seeds the
next solve of a perturbed batch, per LP: skip to phase 2, repair the rows
that went infeasible, or fall back to the cold start.  The same NumPy
inputs and the same parent carrier (through ``interop``) go to both
packages.  ``_gauss_solve``, the per-LP Gauss-Jordan under the injection
and the revised refactorization, is bit-equal to the reference's; the
tableau engine's warm solves equal ``solve_batched_jax(warm=...)`` in
statuses, iterations, x and objectives bit for bit; the revised engine's
equal ``solve_batched_revised(warm=...)`` in statuses and iterations, with
objectives to rtol=atol=1e-4 (tests/test_torch_revised.py says why).
Warm answers agree with cold ones as in the reference's tests/test_warm.py
(statuses equal, objectives to rtol 2e-3) with no more pivots, and a
re-solve from its own optimum takes none.
"""
import numpy as np
import pytest
import torch

from repro.core import INFEASIBLE, OPTIMAL, LPBatch
from repro.core import WarmStart as WarmStartRef
from repro.core import random_lp_batch, solve_batched_jax, solve_batched_revised
from repro.core.simplex import _gauss_solve as gauss_ref
from repro.io.mps import fixture_path, perturbed_sequence, read_mps
import jax.numpy as jnp
from repro_torch.core import batching
from repro_torch.core.compaction import solve_batched_compacted
from repro_torch.core.lp import WarmStart
from repro_torch.core.revised import solve_batched_revised as port_revised
from repro_torch.core.simplex import _gauss_solve, solve_batched_torch
from repro_torch.interop import (batch_from_reference, warm_from_reference,
                                 warm_to_reference)
from repro_torch.kernels.ops import solve_batched_kernel

TABLEAU_RULES = ("dantzig", "steepest_edge", "devex", "partial")
REVISED_RULES = ("dantzig", "partial")
BITWISE = ("status", "iterations", "x", "objective")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _afiro_seq(B=8, K=3, seed=0, **kw):
    g = read_mps(fixture_path("afiro"))
    return perturbed_sequence(g, B, K, np.random.default_rng(seed), **kw)


def _tableau(batch, **kw):
    return solve_batched_torch(batch_from_reference(batch), device="cpu",
                               **kw)


def _revised(batch, **kw):
    return port_revised(batch_from_reference(batch), device="cpu", **kw)


def _assert_same_answers(cold, warm, rtol=2e-3):
    np.testing.assert_array_equal(cold.status, warm.status)
    ok = np.asarray(cold.status) == OPTIMAL
    np.testing.assert_allclose(np.asarray(warm.objective)[ok],
                               np.asarray(cold.objective)[ok], rtol=rtol)


def _total(res):
    return int(np.asarray(res.iterations).astype(np.int64).sum())


# ---------------------------------------------------------------------------
# _gauss_solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 4, 9, 33])
def test_gauss_solve_is_bit_equal_to_the_reference(m):
    rng = np.random.default_rng(m)
    Bmat = rng.normal(size=(6, m, m)).astype(np.float32)
    rhs = rng.normal(size=(6, m, m + 3)).astype(np.float32)
    if m > 1:
        Bmat[1, :, 1] = Bmat[1, :, 0]      # singular: duplicate columns
        Bmat[2, 0, :] = 0.0                # singular: a zero row
    Bmat[3] = np.eye(m, dtype=np.float32)[::-1]   # a permutation
    want = np.asarray(gauss_ref(jnp.asarray(Bmat), jnp.asarray(rhs)))
    got = _gauss_solve(torch.tensor(Bmat), torch.tensor(rhs)).numpy()
    np.testing.assert_array_equal(got, want)
    if m > 1:
        assert not np.isfinite(got[1]).all() and not np.isfinite(got[2]).all()
    np.testing.assert_array_equal(got[3], rhs[3][::-1])


def test_gauss_solve_does_not_depend_on_the_batch():
    rng = np.random.default_rng(3)
    Bmat = torch.tensor(rng.normal(size=(9, 7, 7)), dtype=torch.float32)
    rhs = torch.tensor(rng.normal(size=(9, 7, 2)), dtype=torch.float32)
    whole = _gauss_solve(Bmat, rhs)
    for i in range(9):
        assert torch.equal(_gauss_solve(Bmat[i:i + 1], rhs[i:i + 1])[0],
                           whole[i])


# ---------------------------------------------------------------------------
# parity with the reference's warm solves
# ---------------------------------------------------------------------------

def _edits(seed):
    """A feasible-start batch and two rhs edits of it: every third row
    halved (the parent basis stays feasible or needs a repair) and every
    third row negated (the repair phase 1 proves infeasibility)."""
    batch = random_lp_batch(np.random.default_rng(seed), 12, 8, 6,
                            feasible_start=True)
    for scale in (0.5, -1.0):
        b2 = np.asarray(batch.b).copy()
        b2[:, ::3] *= scale
        yield batch, LPBatch(A=batch.A, b=b2, c=batch.c)


@pytest.mark.parametrize("rule", TABLEAU_RULES)
def test_tableau_warm_equals_the_reference(rule):
    statuses = []
    for batch, edited in _edits(14):
        ws = solve_batched_jax(batch, pricing=rule).warm_start()
        want = solve_batched_jax(edited, pricing=rule, warm=ws)
        got = _tableau(edited, pricing=rule, warm=warm_from_reference(ws))
        for f in BITWISE:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        _assert_same_answers(_tableau(edited, pricing=rule), got, rtol=1e-4)
        statuses += list(got.status)
    assert {OPTIMAL, INFEASIBLE} <= set(statuses)


@pytest.mark.parametrize("rule", REVISED_RULES)
def test_revised_warm_equals_the_reference(rule):
    statuses = []
    for batch, edited in _edits(15):
        ws = solve_batched_revised(batch, pricing=rule).warm_start()
        want = solve_batched_revised(edited, pricing=rule, warm=ws)
        got = _revised(edited, pricing=rule, warm=warm_from_reference(ws))
        np.testing.assert_array_equal(got.status, want.status)
        np.testing.assert_array_equal(got.iterations, want.iterations)
        ok = want.status == OPTIMAL
        np.testing.assert_allclose(got.objective[ok], want.objective[ok],
                                   rtol=1e-4, atol=1e-4)
        _assert_same_answers(_revised(edited, pricing=rule), got, rtol=1e-4)
        statuses += list(got.status)
    assert {OPTIMAL, INFEASIBLE} <= set(statuses)


def test_a_port_carrier_seeds_the_reference():
    seq = _afiro_seq(K=2, seed=3)
    ws = _tableau(seq[0]).warm_start()
    ref_ws = warm_to_reference(ws, WarmStartRef)
    assert isinstance(ref_ws, WarmStartRef)
    want = solve_batched_jax(seq[1], warm=ref_ws)
    got = _tableau(seq[1], warm=ws)
    for f in BITWISE:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    back = warm_from_reference(ref_ws)
    for f in ("basis", "at_upper", "weights"):
        np.testing.assert_array_equal(getattr(back, f), getattr(ws, f))
    assert warm_from_reference(None) is None


# ---------------------------------------------------------------------------
# trajectories: warm answers equal cold ones, with less work
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine,rule", [("tableau", r) for r in
                                         TABLEAU_RULES]
                         + [("revised", r) for r in REVISED_RULES])
def test_afiro_warm_trajectory(engine, rule):
    solve = _tableau if engine == "tableau" else _revised
    seq = _afiro_seq(seed=1)
    ws, cold_tot, warm_tot = None, 0, 0
    for k, gb in enumerate(seq):
        cold = solve(gb, pricing=rule)
        if k > 0:
            warm = solve(gb, pricing=rule, warm=ws)
            _assert_same_answers(cold, warm)
            cold_tot += _total(cold)
            warm_tot += _total(warm)
            ws = warm.warm_start()
        else:
            ws = cold.warm_start()
    assert warm_tot < cold_tot, (warm_tot, cold_tot)


@pytest.mark.parametrize("engine", ["tableau", "revised"])
def test_staircase_fixture_trajectory(engine):
    g = read_mps(fixture_path("sc50b_like"))
    seq = perturbed_sequence(g, 4, 2, np.random.default_rng(13))
    kw = dict(device="cpu", backend=engine)
    first = [batch_from_reference(b) for b in seq]
    ws = batching.solve_batched(first[0], **kw).warm_start()
    cold = batching.solve_batched(first[1], **kw)
    warm = batching.solve_batched(first[1], warm=ws, **kw)
    _assert_same_answers(cold, warm)
    assert _total(warm) <= _total(cold)


@pytest.mark.parametrize("engine", ["tableau", "revised"])
def test_resolve_from_its_own_optimum_takes_no_pivots(engine):
    solve = _tableau if engine == "tableau" else _revised
    batch = random_lp_batch(np.random.default_rng(16), 10, 9, 7,
                            feasible_start=False)
    cold = solve(batch)
    assert (cold.status == OPTIMAL).all() and (cold.iterations > 0).all()
    warm = solve(batch, warm=cold.warm_start())
    assert (warm.iterations == 0).all()
    np.testing.assert_array_equal(warm.status, cold.status)
    np.testing.assert_allclose(warm.objective, cold.objective, rtol=1e-5)


def test_tableau_parent_seeds_the_revised_engine():
    seq = _afiro_seq(K=2, seed=3)
    ws = _tableau(seq[0]).warm_start()
    cold = _revised(seq[1])
    warm = _revised(seq[1], warm=ws)
    _assert_same_answers(cold, warm)
    assert _total(warm) <= _total(cold)


def test_infeasible_parent_reuse():
    rng = np.random.default_rng(7)
    batch = random_lp_batch(rng, 16, 8, 6, feasible_start=False)
    A = np.asarray(batch.A).copy()
    b = np.asarray(batch.b).copy()
    A[::2, 0, :] = np.abs(A[::2, 0, :])
    b[::2, 0] = -1.0
    batch = LPBatch(A=A, b=b, c=batch.c)
    for solve in (_tableau, _revised):
        cold = solve(batch)
        assert (cold.status == INFEASIBLE).any()
        warm = solve(batch, warm=cold.warm_start())
        _assert_same_answers(cold, warm, rtol=1e-4)
        assert _total(warm) <= _total(cold)


# ---------------------------------------------------------------------------
# unusable carriers: repair or cold start, never a wrong answer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["tableau", "revised"])
def test_garbage_basis_degrades_to_cold_answers(engine):
    solve = _tableau if engine == "tableau" else _revised
    rng = np.random.default_rng(5)
    batch = random_lp_batch(rng, 12, 8, 6, feasible_start=False)
    basis = rng.integers(0, 6 + 8, size=(12, 8)).astype(np.int32)
    basis[0] = 1000                     # out of range: cold
    garbage = WarmStart(m=8, n=6, basis=basis,
                        at_upper=np.zeros((12, 6), bool))
    cold = solve(batch)
    warm = solve(batch, warm=garbage)
    _assert_same_answers(cold, warm, rtol=1e-4)
    np.testing.assert_array_equal(warm.iterations[0], cold.iterations[0])


@pytest.mark.parametrize("engine", ["tableau", "revised"])
def test_shape_and_batch_mismatch_drop_to_cold_with_a_warning(engine):
    solve = _tableau if engine == "tableau" else _revised
    seq = _afiro_seq(K=1, seed=8)
    ws = solve(seq[0]).warm_start()
    other = read_mps(fixture_path("testprob"))
    bigger = perturbed_sequence(read_mps(fixture_path("afiro")), 10, 1,
                                np.random.default_rng(9))[0]
    for batch in (other, bigger):
        cold = solve(batch)
        with pytest.warns(UserWarning, match="warm start dropped"):
            warm = solve(batch, warm=ws)
        np.testing.assert_array_equal(cold.status, warm.status)
        np.testing.assert_array_equal(cold.iterations, warm.iterations)


# ---------------------------------------------------------------------------
# chunked solves and the scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["tableau", "revised"])
def test_chunked_warm_equals_unchunked(engine):
    seq = [batch_from_reference(b) for b in _afiro_seq(B=12, K=2, seed=4)]
    kw = dict(device="cpu", backend=engine)
    ws = batching.solve_batched(seq[0], **kw).warm_start()
    full = batching.solve_batched(seq[1], warm=ws, **kw)
    chunked = batching.solve_batched(seq[1], warm=ws, chunk_size=5, **kw)
    sorted_ = batching.solve_batched(seq[1], warm=ws, chunk_size=5,
                                     sort_by_difficulty=True, **kw)
    padded = batching.solve_batched(seq[1], warm=ws, pad_to_bucket=True,
                                    **kw)
    for other in (chunked, sorted_, padded):
        for f in BITWISE:
            np.testing.assert_array_equal(getattr(full, f),
                                          getattr(other, f), err_msg=f)
        np.testing.assert_array_equal(full.warm.basis, other.warm.basis)
    nxt_full = batching.solve_batched(seq[1], warm=full.warm_start(), **kw)
    nxt_sorted = batching.solve_batched(seq[1], warm=sorted_.warm_start(),
                                        **kw)
    np.testing.assert_array_equal(nxt_full.iterations, nxt_sorted.iterations)


@pytest.mark.parametrize("engine", ["tableau", "revised"])
def test_compacted_paths_accept_warm(engine):
    seq = [batch_from_reference(b) for b in _afiro_seq(B=8, K=2, seed=11)]
    kw = dict(device="cpu", backend=engine, segment_k=3)
    ws = batching.solve_batched(seq[0], device="cpu",
                                backend=engine).warm_start()
    cold = solve_batched_compacted(seq[1], **kw)
    warm = solve_batched_compacted(seq[1], warm=ws, **kw)
    assert warm.warm is None
    _assert_same_answers(cold, warm, rtol=1e-4)
    assert _total(warm) <= _total(cold)
    if engine == "tableau":   # the scheduler changes no pivot of the engine
        whole = batching.solve_batched(seq[1], device="cpu", warm=ws)
        for f in BITWISE:
            np.testing.assert_array_equal(getattr(warm, f),
                                          getattr(whole, f), err_msg=f)


def test_tableau_kernel_path_warns_and_starts_cold():
    seq = [batch_from_reference(b) for b in _afiro_seq(B=4, K=2, seed=12)]
    ws = solve_batched_torch(seq[0], device="cpu").warm_start()
    cold = solve_batched_kernel(seq[1], device="cpu")
    with pytest.warns(UserWarning, match="no warm-start injection"):
        warm = solve_batched_kernel(seq[1], device="cpu", warm=ws)
    for f in BITWISE:
        np.testing.assert_array_equal(getattr(warm, f), getattr(cold, f))
    revised = solve_batched_kernel(seq[1], device="cpu", backend="revised",
                                   warm=ws)
    _assert_same_answers(cold, revised)
