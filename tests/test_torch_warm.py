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
import dataclasses
import itertools
import warnings

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


# Members of perturbed_batch(afiro, 100_000) (chip_smoke.py's lp_afiro_100k)
# whose re-solve from their own optimum pivots, with the pivots the port
# and the reference take: the injection rebuilds a tableau that is not the
# one the last pivot left (a basic artificial maps to its row's slack, and
# the Gauss-Jordan rebuild rounds otherwise), so both engines pivot again.
# On 5426 the reference takes one more: its phase-1 row sums more than 32
# rows in windows (ROADMAP.md, queue 3; _xla_row_sum).  The last member,
# a neighbour, re-solves with none.
AFIRO_RESOLVE = {5426: (25, 26), 13721: (7, 7), 5427: (0, 0)}


def _perturbed_members(g, B, members, seed=0, rel=0.01):
    """Members ``members`` (a range or a list) of ``perturbed_batch(g, B,
    default_rng(seed), rel)`` without the other ones: each run of
    consecutive members takes its noise from its place in the generator's
    stream (A for every member, then rhs, then c; one 64-bit draw a
    value)."""
    members = list(members)
    runs = np.split(members, np.flatnonzero(np.diff(members) != 1) + 1)
    out, start = {}, 0
    for f in ("A", "rhs", "c"):
        a = np.asarray(getattr(g, f)[0], np.float64)
        parts = []
        for run in runs:
            bits = np.random.PCG64(seed)
            bits.advance(start + int(run[0]) * a.size)
            noise = 1.0 + rel * np.random.Generator(bits).uniform(
                -1.0, 1.0, size=(len(run),) + a.shape)
            noise[run == 0] = 1.0
            parts.append(a * np.where(a != 0.0, noise, 1.0))
        out[f] = np.concatenate(parts)
        start += B * a.size
    k = len(members)
    return dataclasses.replace(g, A=out["A"], rhs=out["rhs"], c=out["c"],
                               lb=np.repeat(g.lb, k, 0),
                               ub=np.repeat(g.ub, k, 0),
                               c0=np.repeat(g.c0, k, 0))


def _xla_row_sum(x):
    """``x.sum(axis=1)`` in the reference's CPU order for more than 32
    terms: windows of 32 over the terms zero-padded (the lower half of the
    padding first), each window added in order, then the window sums in
    order; one rounding per add."""
    L = x.shape[1]
    W = 32
    lo = (-L % W) // 2
    total = np.zeros(x[:, 0].shape, np.float32)
    for start in range(-lo, L, W):
        acc = np.zeros(x[:, 0].shape, np.float32)
        for i in range(max(start, 0), min(start + W, L)):
            acc = acc + x[:, i]
        total = total + acc
    return total


def test_afiro_resolve_pivots_and_their_cause():
    """The warm re-solve of the chip smoke's lp_afiro_100k from its own
    optimum pivots on exactly members 5426 and 13721 on the card.  On the
    CPU both packages re-solve those members from the same optimum basis,
    and the reference pivots on them too: on 13721 the same 7 times, on
    5426 once more than the port, because its injected phase-1 row and
    objective sum the 35 rows in windows of 32 (the rest of the injected
    tableau is bit-equal)."""
    import jax
    from repro.core.forms import canonicalize as canonicalize_ref
    from repro.core.simplex import inject_tableau_warm as inject_ref
    from repro.io.mps import perturbed_batch as perturbed_batch_ref
    from repro_torch.core.simplex import inject_tableau_warm
    g = read_mps(fixture_path("afiro"))
    small = perturbed_batch_ref(g, 40)
    picked = _perturbed_members(g, 40, [0, 1, 2, 7, 38, 39])
    for f in ("A", "rhs", "c"):
        np.testing.assert_array_equal(getattr(picked, f),
                                      getattr(small, f)[[0, 1, 2, 7, 38, 39]])
    members = list(AFIRO_RESOLVE)
    lp, _ = canonicalize_ref(_perturbed_members(g, 100_000, members))
    cold_ref = solve_batched_jax(lp)
    cold = _tableau(lp)
    np.testing.assert_array_equal(cold.iterations, cold_ref.iterations)
    np.testing.assert_array_equal(cold.warm.basis, cold_ref.warm.basis)
    assert (cold.status == OPTIMAL).all()
    again_ref = solve_batched_jax(lp, warm=cold_ref.warm_start())
    again = _tableau(lp, warm=cold.warm_start())
    np.testing.assert_array_equal(again.iterations,
                                  [p for p, _ in AFIRO_RESOLVE.values()])
    np.testing.assert_array_equal(again_ref.iterations,
                                  [r for _, r in AFIRO_RESOLVE.values()])
    np.testing.assert_array_equal(again.status, again_ref.status)
    np.testing.assert_allclose(again.objective, again_ref.objective,
                               rtol=1e-6)
    # the cause: the injected tableaux differ in the two summed entries
    # only, and the reference's are the port's terms summed in windows
    m, n = lp.m, lp.n
    arrays = [np.asarray(a, np.float32) for a in (
        lp.A, lp.b, lp.c, lp.upper_bounds())]
    wb = np.asarray(cold_ref.warm.basis, np.int32)
    wfl = np.asarray(cold_ref.warm.at_upper, bool)
    ref = jax.jit(lambda *a: inject_ref(*a, m=m, n=n, feas_tol=1e-5))(
        *arrays, wb, wfl)
    got = inject_tableau_warm(*map(torch.tensor, arrays),
                              torch.tensor(wb), torch.tensor(wfl),
                              m=m, n=n, feas_tol=1e-5)
    T_ref, T = np.asarray(ref[0]), got[0].numpy()
    for r, g_ in zip(ref[1:], got[1:]):
        np.testing.assert_array_equal(np.asarray(r), g_.numpy())
    np.testing.assert_array_equal(T[:, :m + 1, :-1], T_ref[:, :m + 1, :-1])
    np.testing.assert_array_equal(T[:, :m, -1], T_ref[:, :m, -1])
    basis = got[1].numpy()
    viol = basis >= n + m
    rows = T[:, :m, :]
    cols = np.r_[0:n + m, n + 2 * m]
    p1 = _xla_row_sum(rows * viol[:, :, None])[:, cols]
    np.testing.assert_array_equal(T_ref[:, m + 1, cols], p1)
    assert not np.array_equal(T[0, m + 1, cols], p1[0])
    cext = np.concatenate([np.where(wfl, -arrays[2], arrays[2]),
                           np.zeros((len(members), m), np.float32)], 1)
    cB = np.where(viol, np.float32(0),
                  np.take_along_axis(cext, np.minimum(basis, n + m - 1), 1))
    obj_off = (arrays[2] * np.where(wfl, arrays[3], 0)).sum(1)
    np.testing.assert_array_equal(
        T_ref[:, m, -1], -(_xla_row_sum(cB * rows[:, :, -1]) + obj_off))


def test_afiro_members_that_resolve_with_pivots_in_the_reference():
    """All 100,000 members of lp_afiro_100k through the reference, cold
    and then from their own optimum, in slices of 10,000: the members
    whose re-solve pivots are exactly those of AFIRO_RESOLVE, with the
    reference's pivots (the card's set is the same: chip_smoke.py)."""
    from repro.core.forms import canonicalize as canonicalize_ref
    g = read_mps(fixture_path("afiro"))
    B, k = 100_000, 10_000
    moved = {}
    for lo in range(0, B, k):
        lp, _ = canonicalize_ref(_perturbed_members(g, B, range(lo, lo + k)))
        cold = solve_batched_jax(lp)
        again = solve_batched_jax(lp, warm=cold.warm_start())
        assert (np.asarray(cold.status) == OPTIMAL).all()
        it = np.asarray(again.iterations)
        moved.update({lo + int(i): int(it[i]) for i in np.flatnonzero(it)})
    assert moved == {i: r for i, (_, r) in AFIRO_RESOLVE.items() if r}


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
    """The name is the test's first one: the kernel path now injects.
    Its warm tableau solve under each rule (on CPU tensors: the plain
    version of the segment kernel's combined stage, one launch through
    both phases from ``KernelBackend.init(warm=...)``) warns about nothing
    and equals ``solve_batched_torch(warm=...)`` bit for bit, its capture
    included (basis, flips, and the weights of the n+m priceable
    columns); ``compaction=True`` takes the carrier too.  The revised
    kernel path takes the tableau engine's carrier and answers as the cold
    solve does."""
    rng = np.random.default_rng(12)
    base = random_lp_batch(rng, 6, 7, 6, feasible_start=False)
    ub = rng.uniform(0.05, 0.6, size=(6, 6))
    ub[:, ::2] = np.inf
    bounded = LPBatch.from_arrays(base.A, base.b, base.c, ub=ub)
    nudged = LPBatch.from_arrays(base.A, base.b * rng.uniform(
        0.6, 1.1, size=base.b.shape), base.c, ub=ub)
    pairs = [_afiro_seq(B=4, K=2, seed=12), [bounded, nudged]]
    for rule, (first, second) in itertools.product(
            ("dantzig", "steepest_edge", "devex"), pairs):
        first, second = batch_from_reference(first), \
            batch_from_reference(second)
        ws = solve_batched_torch(first, device="cpu",
                                 pricing=rule).warm_start()
        want = solve_batched_torch(second, device="cpu", pricing=rule,
                                   warm=ws)
        cold = solve_batched_kernel(second, device="cpu", pricing=rule)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = solve_batched_kernel(second, device="cpu", pricing=rule,
                                       warm=ws)
            sched = solve_batched_kernel(second, device="cpu", pricing=rule,
                                         warm=ws, compaction=True,
                                         segment_k=3)
        assert _total(got) < _total(cold)
        for f in ("status", "iterations", "x", "objective", "y", "z"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
            np.testing.assert_array_equal(getattr(sched, f),
                                          getattr(want, f), err_msg=f)
        m, n = got.warm.m, got.warm.n
        np.testing.assert_array_equal(got.warm.basis, want.warm.basis)
        np.testing.assert_array_equal(got.warm.at_upper, want.warm.at_upper)
        assert got.warm.pricing == want.warm.pricing == rule
        np.testing.assert_array_equal(got.warm.weights,
                                      want.warm.weights[:, :n + m])
    seq = [batch_from_reference(b) for b in _afiro_seq(B=4, K=2, seed=12)]
    ws = solve_batched_torch(seq[0], device="cpu").warm_start()
    cold = solve_batched_kernel(seq[1], device="cpu")
    revised = solve_batched_kernel(seq[1], device="cpu", backend="revised",
                                   warm=ws)
    _assert_same_answers(cold, revised)
