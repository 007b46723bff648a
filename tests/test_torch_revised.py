"""The port's revised simplex against the reference.

``repro_torch.core.revised`` (the plain engine, and the plain version of
the CUDA kernel ``revised_segment_tile`` on CPU tensors) gets the same NumPy
inputs as the reference's engine ``solve_batched_revised`` and its tile
kernel ``solve_batched_pallas(backend="revised", tile_b=1,
interpret=True)``.  Statuses and iterations must be equal; objectives
agree to ``rtol=atol=1e-4``, the reference's own tolerance between its tile
kernel and its engine (tests/test_tile_parity.py): the port keeps a dense
inverse updated per pivot where the engine keeps LU factors and the tile
kernel a host inverse plus an eta file, so the two round differently.
Under the compaction scheduler statuses are equal and objectives agree to
rtol 1e-3, the reference's contract.  The port's eta clock is per LP, so
its results do not depend on the batch: chunked solves equal unchunked
ones bit for bit.  The CUDA kernel is held against the plain version on
the card (tests/test_torch_package.py, marker ``gpu``; chip_smoke.py).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OPTIMAL, random_lp_batch, solve_batched_revised
from repro.core.revised import auto_refactor_period as auto_k_ref
from repro.core.revised import revised_elements as revised_elements_ref
from repro.io.mps import fixture_path, read_mps
from repro.kernels import solve_batched_pallas
from repro.kernels.revised_tile import (build_revised_tile_state,
                                        revised_segment_pallas)
from repro_torch.core import batching
from repro_torch.core.revised import (REVISED_RULES, RevisedBackend,
                                      RevisedState, auto_refactor_period,
                                      canonicalize_revised_rule,
                                      revised_elements, revised_segment,
                                      solve_batched_revised_compacted,
                                      warm_state)
from repro_torch.core.revised import solve_batched_revised as port_revised
from repro_torch.core.simplex import batch_tensors
from repro_torch.interop import batch_from_reference, result_arrays
from repro_torch.kernels import (revised_segment_tile,
                                 revised_segment_tile_plain)
from repro_torch.kernels.ops import RevisedKernelBackend, solve_batched_kernel

RNG_SEED = 23
FIELDS = ("status", "iterations", "x", "objective", "y", "z")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port(batch, **kw):
    return port_revised(batch_from_reference(batch), device="cpu", **kw)


def _assert_parity(ref, got, rtol=1e-4):
    np.testing.assert_array_equal(got.status, ref.status)
    np.testing.assert_array_equal(got.iterations, ref.iterations)
    ok = (ref.status == OPTIMAL) & (got.status == OPTIMAL)
    assert ok.any()
    np.testing.assert_allclose(got.objective[ok], ref.objective[ok],
                               rtol=rtol, atol=rtol)


def _bitwise(a, b, fields=FIELDS):
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


@pytest.mark.parametrize("pricing", REVISED_RULES)
@pytest.mark.parametrize("m,n", [(5, 5), (12, 8)])
@pytest.mark.parametrize("feas", [True, False])
def test_revised_engine_parity_sweep(pricing, m, n, feas):
    rng = np.random.default_rng([RNG_SEED, m, n, int(feas)])
    batch = random_lp_batch(rng, B=17, m=m, n=n, feasible_start=feas)
    got = _port(batch, pricing=pricing)
    _assert_parity(solve_batched_revised(batch, pricing=pricing), got)
    tile = solve_batched_pallas(batch, backend="revised", tile_b=1,
                                pricing=pricing)
    _assert_parity(tile, got)


def test_revised_bounded_columns_parity():
    rng = np.random.default_rng(RNG_SEED)
    base = random_lp_batch(rng, B=11, m=6, n=5)
    ub = rng.uniform(0.01, 0.2, size=(base.batch, base.n)).astype(np.float32)
    ub[:, ::2] = np.inf
    batch = dataclasses.replace(base, ub=ub)
    got = _port(batch)
    _assert_parity(solve_batched_revised(batch), got)
    _assert_parity(solve_batched_pallas(batch, backend="revised", tile_b=1),
                   got)
    assert got.warm.at_upper.any()   # some columns end at their bound


def test_revised_afiro():
    g = read_mps(fixture_path("afiro"))
    got = _port(g)
    _assert_parity(solve_batched_revised(g), got)
    assert got.status[0] == OPTIMAL
    np.testing.assert_allclose(got.objective[0], -464.7531, rtol=1e-4)


@pytest.mark.parametrize("pricing", REVISED_RULES)
def test_binding_budget_matches_the_reference(pricing):
    """``max_iters`` is each LP's own budget; the reference's whole solve
    counts one loop for the batch, which a running LP's count equals."""
    batch = random_lp_batch(np.random.default_rng(4), B=12, m=8, n=7,
                            feasible_start=False)
    for cap in (2, 5):
        ref = solve_batched_revised(batch, pricing=pricing, max_iters=cap)
        got = _port(batch, pricing=pricing, max_iters=cap)
        np.testing.assert_array_equal(got.status, ref.status)
        np.testing.assert_array_equal(got.iterations, ref.iterations)
        assert (got.status == 3).any()


def test_refactor_period_and_work_model_match_the_reference():
    for m, n in ((1, 1), (7, 3), (35, 32), (100, 100), (246, 159)):
        assert auto_refactor_period(m, n) == auto_k_ref(m, n)
        for partial in (False, True):
            assert revised_elements(m, n, partial=partial) \
                == revised_elements_ref(m, n, partial=partial)
    assert canonicalize_revised_rule("Partial") == "partial"
    with pytest.raises(ValueError, match="tableau-only"):
        canonicalize_revised_rule("devex")


@pytest.mark.parametrize("refactor_period", [1, 3, None])
def test_refactor_period_changes_rounding_not_answers(refactor_period):
    batch = random_lp_batch(np.random.default_rng(8), B=10, m=9, n=7,
                            feasible_start=False)
    ref = solve_batched_revised(batch, refactor_period=refactor_period)
    got = _port(batch, refactor_period=refactor_period)
    _assert_parity(ref, got)


@pytest.mark.parametrize("stage", ["p1", "p2"])
@pytest.mark.parametrize("pricing", REVISED_RULES)
def test_one_segment_launch_matches_the_reference_tile_kernel(stage,
                                                              pricing):
    """One launch of ``revised_segment_tile`` (CPU tensors: the plain
    version) against one of ``revised_segment_pallas`` at tile_b=1, with
    fewer steps than the eta file holds: the same pivots, so basis,
    statuses, phases, iterations and steps taken are equal and the basic
    values agree to f32 rounding."""
    batch = random_lp_batch(np.random.default_rng(9), B=8, m=8, n=6,
                            feasible_start=False)
    m, n, steps, K = 8, 6, 3, 4
    st_ref = build_revised_tile_state(
        jnp.asarray(batch.A), jnp.asarray(batch.b), jnp.asarray(batch.c),
        jnp.asarray(batch.upper_bounds()), m=m, n=n, tile_b=1,
        feas_tol=1e-5)
    xB, basis, onub, phase, status, iters, it = revised_segment_pallas(
        jnp.int32(steps), st_ref.Abar, st_ref.cvec, st_ref.ub, st_ref.thr,
        st_ref.Binv, st_ref.xB, st_ref.basis, st_ref.onub, st_ref.phase,
        st_ref.status, st_ref.iters, stage=stage, m=m, n=n, tile_b=1,
        tol=1e-6, K=K, interpret=True, pricing=pricing)
    A, b, c, ub = batch_tensors(batch_from_reference(batch),
                                torch.device("cpu"))
    state = warm_state(A, b, c, ub, m=m, n=n, feas_tol=1e-5)
    before = revised_segment_tile.launches
    got, got_it = revised_segment_tile(state, steps, stage=stage, m=m, n=n,
                                       max_iters=200, refactor_period=K,
                                       rule=pricing)
    assert revised_segment_tile.launches == before
    np.testing.assert_array_equal(got_it.numpy(), np.asarray(it)[:, 0])
    np.testing.assert_array_equal(got.basis.numpy(), np.asarray(basis)[:, :m])
    for mine, theirs in ((got.status, status), (got.phase, phase),
                         (got.iters, iters)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs)[:, 0])
    np.testing.assert_array_equal(got.onub.numpy(),
                                  np.asarray(onub)[:, :n] != 0)
    np.testing.assert_allclose(got.xB.numpy(), np.asarray(xB)[:, :m],
                               rtol=1e-5, atol=1e-6)


def test_segment_on_cpu_tensors_is_the_plain_version():
    batch = random_lp_batch(np.random.default_rng(10), B=6, m=5, n=4,
                            feasible_start=False)
    A, b, c, ub = batch_tensors(batch_from_reference(batch),
                                torch.device("cpu"))
    state = warm_state(A, b, c, ub, m=5, n=4, feas_tol=1e-5)
    kw = dict(stage="p2", m=5, n=4, max_iters=100, refactor_period=2,
              rule="partial")
    got, it = revised_segment_tile(state, 4, **kw)
    want, want_it = revised_segment_tile_plain(state, 4, **kw)
    torch.testing.assert_close(it, want_it, rtol=0, atol=0)
    for name, g, w in zip(RevisedState._fields, got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


def test_stage_p1_parks_phase2_lps_and_marks_the_cap():
    rng = np.random.default_rng(11)
    p1 = random_lp_batch(rng, B=5, m=7, n=6, feasible_start=False)
    p2 = random_lp_batch(rng, B=5, m=7, n=6, feasible_start=True)
    A, b, c, ub = (torch.cat(pair) for pair in zip(
        batch_tensors(batch_from_reference(p1), torch.device("cpu")),
        batch_tensors(batch_from_reference(p2), torch.device("cpu"))))
    state = warm_state(A, b, c, ub, m=7, n=6, feas_tol=1e-5)
    got, it = revised_segment(state, 50, stage="p1", m=7, n=6, max_iters=1,
                              tol=1e-6, refactor_period=3)
    assert (it <= 1).all()
    in_p1 = got.phase == 1
    assert in_p1.any() and (~in_p1).any()
    assert (got.status[in_p1] == 3).all()     # ITERATION_LIMIT
    assert (got.status[~in_p1] == -1).all()   # left for stage p2
    assert (got.work[:, 0] == it).all()       # steps counted per LP


@pytest.mark.parametrize("pricing", REVISED_RULES)
def test_compaction_matches_the_engine(pricing):
    batch = random_lp_batch(np.random.default_rng(12), B=24, m=6, n=6,
                            feasible_start=False)
    ref = solve_batched_revised(batch, pricing=pricing)
    stats = []
    got = solve_batched_revised_compacted(
        batch_from_reference(batch), device="cpu", pricing=pricing,
        segment_k=2, stats_out=stats)
    np.testing.assert_array_equal(got.status, ref.status)
    ok = ref.status == OPTIMAL
    np.testing.assert_allclose(got.objective[ok], ref.objective[ok],
                               rtol=1e-3, atol=1e-3)
    assert got.warm is None
    buckets = [s.bucket for s in stats]
    assert min(buckets) < max(buckets), "expected a bucket shrink"
    whole = _port(batch, pricing=pricing)
    np.testing.assert_array_equal(got.status, whole.status)
    np.testing.assert_allclose(got.objective[ok], whole.objective[ok],
                               rtol=1e-3, atol=1e-3)


def test_compaction_routes_through_solve_batched_and_the_kernel_backend():
    batch = batch_from_reference(random_lp_batch(
        np.random.default_rng(13), B=20, m=7, n=5, feasible_start=False))
    kw = dict(device="cpu", segment_k=3, pricing="partial")
    plain = solve_batched_revised_compacted(batch, **kw)
    via = batching.solve_batched(batch, backend="revised", compaction=True,
                                 **kw)
    kern = solve_batched_kernel(batch, backend="revised", compaction=True,
                                **kw)
    _bitwise(plain, via)
    _bitwise(plain, kern)
    assert issubclass(RevisedKernelBackend, RevisedBackend)


@pytest.mark.parametrize("pricing", REVISED_RULES)
def test_chunked_equals_unchunked_bit_for_bit(pricing):
    batch = batch_from_reference(random_lp_batch(
        np.random.default_rng(14), B=19, m=9, n=8, feasible_start=False))
    kw = dict(device="cpu", backend="revised", pricing=pricing)
    full = batching.solve_batched(batch, **kw)
    for other in (batching.solve_batched(batch, chunk_size=4, **kw),
                  batching.solve_batched(batch, chunk_size=5,
                                         sort_by_difficulty=True, **kw),
                  batching.solve_batched(batch, pad_to_bucket=True, **kw)):
        _bitwise(full, other)
        np.testing.assert_array_equal(full.warm.basis, other.warm.basis)
        np.testing.assert_array_equal(full.warm.at_upper,
                                      other.warm.at_upper)
    # one LP alone gives the bits it gives inside the batch
    alone = port_revised(batch_from_reference(dataclasses.replace(
        batch, A=batch.A[3:4], b=batch.b[3:4], c=batch.c[3:4])),
        device="cpu", pricing=pricing)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(alone, f)[0],
                                      getattr(full, f)[3], err_msg=f)


def test_whole_solve_kernel_entry_on_cpu_is_the_engine():
    batch = batch_from_reference(random_lp_batch(
        np.random.default_rng(15), B=9, m=6, n=6, feasible_start=False))
    before = revised_segment_tile.launches
    got = solve_batched_kernel(batch, device="cpu", backend="revised")
    assert revised_segment_tile.launches == before
    want = port_revised(batch, device="cpu")
    _bitwise(got, want)
    np.testing.assert_array_equal(got.warm.basis, want.warm.basis)
    assert got.warm.pricing == "dantzig"
    res = result_arrays(got)
    assert res["y"].shape == (9, 6) and res["z"].shape == (9, 6)


def test_ratio_test_reads_a_basic_value_below_zero_as_zero():
    """A rounding can leave a basic value a hair below zero after a
    degenerate pivot.  Its row then bounds the step at 0, never at a
    negative ratio that would move the entering variable below its bound
    (on member 761 of lp_afiro_100k that backward step led the f32 solve
    into a singular basis; the reference, which rounds the same pivot to
    an exact 0, solves it)."""
    A = torch.tensor([[[1.0, 1.0], [1.0, 2.0]]])
    b = torch.tensor([[4.0, 6.0]])
    c = torch.tensor([[1.0, 1.0]])
    ub = torch.full((1, 2), torch.inf)
    state = warm_state(A, b, c, ub, m=2, n=2, feas_tol=1e-5)
    state = state._replace(xB=torch.tensor([[4.0, -1e-4]]))
    got, _ = revised_segment(state, 1, stage="p2", m=2, n=2, max_iters=10,
                             tol=1e-6, refactor_period=4)
    assert got.basis.tolist() == [[2, 0]]      # x_0 entered in row 1
    assert got.xB[0, 1].item() == 0.0          # at 0, not at -1e-4
    assert got.xB[0, 0].item() == 4.0
