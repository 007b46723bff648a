"""The port's restarted PDHG against the reference.

``repro_torch.core.pdhg`` (the plain engine, and the plain version of the
CUDA kernels ``pdhg_tile`` / ``pdhg_segment_tile`` on CPU tensors) and
``repro_torch.core.sparse`` get the same NumPy inputs as the reference's
``solve_batched_pdhg``, ``solve_batched_pdhg_compacted``,
``solve_batched_pdhg_sparse`` and its Pallas kernels ``pdhg_pallas`` /
``pdhg_segment_pallas`` (``interpret=True``).  PDHG is tolerance-based, and
the port sums in the kernels' fixed order where the reference lets XLA
order its sums, so the contract is the reference's own between two
executors of the same rounds (tests/test_pdhg.py): statuses equal,
OPTIMAL objectives within ``XTOL`` = 1e-3 relative, the canonical KKT
certificate below 10 * ``TOL``, and against the float64 oracle the
reference's ``CHECK`` bounds.  Within the port everything is bit for bit:
compaction equals the whole solve, chunked equals unchunked, a permuted
batch gives each LP the same result, the sparse engine equals the dense
one, and the CUDA kernels equal the plain version
(tests/test_torch_package.py, marker ``gpu``; chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (OPTIMAL, LPBatch, WarmStart, random_lp_batch,
                        random_sparse_lp_batch, solve_batched_pdhg,
                        solve_batched_pdhg_compacted, solve_batched_reference)
from repro.core import pdhg as ref_pdhg
from repro.core import sparse as ref_sparse
from repro.io.mps import fixture_path, perturbed_batch, perturbed_sequence
from repro.io.mps import read_mps
from repro.kernels.pdhg_tile import (build_pdhg_tile_state, pdhg_pallas,
                                     pdhg_segment_pallas)
from repro_torch.core import batching
from repro_torch.core import pdhg as port_pdhg
from repro_torch.core import sparse as port_sparse
from repro_torch.core.fp import tree_sum
from repro_torch.core.pdhg import (PdhgBackend, PdhgState, init_pdhg_state,
                                   pdhg_round, schedule_pdhg, segment_pdhg)
from repro_torch.core.simplex import batch_tensors
from repro_torch.interop import (batch_from_reference,
                                 pdhg_state_from_reference, result_arrays,
                                 warm_from_reference)
from repro_torch.kernels import (pdhg_segment_tile, pdhg_segment_tile_plain,
                                 pdhg_tile, pdhg_tile_plain)
from repro_torch.kernels.ops import PdhgKernelBackend, solve_batched_kernel

TOL = 1e-5      # the engine's float32 default
CHECK = 1e-3    # the reference's budget against the oracle
XTOL = 1e-3     # the reference's budget between two executors of PDHG
FIELDS = ("status", "iterations", "x", "objective", "y", "z")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rng(k):
    return np.random.default_rng(k)


def _port(batch, **kw):
    return port_pdhg.solve_batched_pdhg(batch_from_reference(batch),
                                        device="cpu", **kw)


def _rel_obj_err(res, ref):
    ok = (np.asarray(res.status) == OPTIMAL) \
        & (np.asarray(ref.status) == OPTIMAL)
    assert ok.any()
    return float((np.abs(res.objective[ok] - ref.objective[ok])
                  / np.maximum(np.abs(ref.objective[ok]), 1e-12)).max())


def _canonical_kkt(batch, res):
    """tests/test_pdhg.py's certificate: relative primal/dual feasibility
    and duality gap of (x, y) on a canonical batch without bounds."""
    ok = np.asarray(res.status) == OPTIMAL
    A = np.asarray(batch.A, np.float64)[ok]
    b = np.asarray(batch.b, np.float64)[ok]
    c = np.asarray(batch.c, np.float64)[ok]
    x = np.asarray(res.x, np.float64)[ok]
    y = np.asarray(res.y, np.float64)[ok]
    rp = np.maximum(np.einsum("bmn,bn->bm", A, x) - b, 0.0).max(axis=1) \
        / (1.0 + np.abs(b).max(axis=1))
    rd = np.maximum(c - np.einsum("bmn,bm->bn", A, y), 0.0).max(axis=1) \
        / (1.0 + np.abs(c).max(axis=1))
    p = np.einsum("bn,bn->b", c, x)
    d = np.einsum("bm,bm->b", b, y)
    gap = np.abs(p - d) / (1.0 + np.abs(p) + np.abs(d))
    return float(np.maximum(np.maximum(rp, rd), gap).max())


def _assert_parity(ref, got, rtol=XTOL):
    np.testing.assert_array_equal(got.status, ref.status)
    ok = (np.asarray(ref.status) == OPTIMAL)
    if ok.any():
        np.testing.assert_allclose(got.objective[ok], ref.objective[ok],
                                   rtol=rtol, atol=rtol)


def _bitwise(a, b, fields=FIELDS):
    a, b = result_arrays(a), result_arrays(b)
    for f in fields:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def _bounded_batch():
    batch = random_lp_batch(_rng(21), 6, 6, 7)
    ub = np.full((6, 7), np.inf)
    ub[:, ::2] = 0.5
    return LPBatch.from_arrays(batch.A, batch.b, batch.c, ub=ub)


def _infeasible_batch():
    A = np.tile(np.array([[[1.0, 1.0], [-1.0, -1.0]]]), (4, 1, 1))
    b = np.tile(np.array([[-1.0, -2.0]]), (4, 1))
    return LPBatch.from_arrays(A, b, np.ones((4, 2)))


def _unbounded_batch():
    A = np.tile(np.array([[[-1.0, 0.0]]]), (4, 1, 1))
    c = np.tile(np.array([[1.0, 0.0]]), (4, 1))
    return LPBatch.from_arrays(A, np.ones((4, 1)), c)


def _afiro(B=4, seed=1):
    return perturbed_batch(read_mps(fixture_path("afiro")), B, _rng(seed))


CASES = {
    "feasible": lambda: random_lp_batch(_rng(0), 8, 8, 8),
    "phase1": lambda: random_lp_batch(_rng(1), 8, 10, 10,
                                      feasible_start=False),
    "bounded": _bounded_batch,
    "infeasible": _infeasible_batch,
    "unbounded": _unbounded_batch,
    "afiro": _afiro,
}


# ---------------------------------------------------------------------------
# the engine against the reference engine and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_reference(case):
    batch = CASES[case]()
    ref = solve_batched_pdhg(batch)
    got = _port(batch)
    _assert_parity(ref, got)
    orc = solve_batched_reference(batch)
    assert (got.status == orc.status).mean() >= 0.9
    if (orc.status == OPTIMAL).any():
        assert _rel_obj_err(got, orc) < CHECK
    if case in ("feasible", "phase1"):
        assert _canonical_kkt(batch, got) < 10 * TOL
    # the warm capture: x and y unscaled, omega and eta per LP
    assert got.warm.x.shape == got.x.shape and got.warm.omega.shape == (
        got.status.shape[0],)


def test_certificates_and_duals_hold_on_the_canonical_batch():
    batch = random_lp_batch(_rng(18), 8, 8, 8)
    got = _port(batch)
    ok = got.status == OPTIMAL
    assert ok.all()
    z = np.asarray(batch.c) - np.einsum("bmn,bm->bn", np.asarray(batch.A),
                                        got.y)
    np.testing.assert_allclose(got.z[ok], z[ok], rtol=1e-3, atol=1e-2)
    assert _canonical_kkt(batch, got) < 10 * TOL


def test_iteration_cap_quantizes_to_rounds_and_binds():
    batch = random_lp_batch(_rng(12), 4, 6, 6)
    got = _port(batch, tol=1e-12, max_iters=64)
    ref = solve_batched_pdhg(batch, tol=1e-12, max_iters=64)
    np.testing.assert_array_equal(got.status, 3)
    np.testing.assert_array_equal(got.iterations, ref.iterations)
    assert (got.iterations == 64).all()
    assert np.isnan(got.objective).all() and np.isnan(got.y).all()


def test_constants_and_work_units_are_the_references():
    for name in ("RESTART_SUFFICIENT", "RESTART_NECESSARY",
                 "OMEGA_SMOOTHING", "OMEGA_MIN", "OMEGA_MAX", "RUIZ_ITERS",
                 "POWER_ITERS", "STEP_SAFETY", "CHECK_EVERY", "CERT_TOL",
                 "RAY_MIN_NORM", "MP_DELTA", "MP_MU", "MP_TRIALS"):
        assert getattr(port_pdhg, name) == getattr(ref_pdhg, name), name
    for m, n in ((100, 100), (246, 159), (5, 7)):
        assert port_pdhg.default_pdhg_max_iters(m, n) \
            == ref_pdhg.default_pdhg_max_iters(m, n)
        assert port_pdhg.pdhg_elements(m, n) == ref_pdhg.pdhg_elements(m, n)
        assert port_sparse.sparse_pdhg_elements(40, m, n) \
            == ref_sparse.sparse_pdhg_elements(40, m, n)


@pytest.mark.parametrize("L", [1, 3, 8, 33, 100])
def test_tree_sum_is_the_halving_order(L):
    rng = _rng(L)
    t = rng.standard_normal((5, L)).astype(np.float32)
    P = 1 << max(0, L - 1).bit_length()
    want = np.concatenate([t, np.zeros((5, P - L), np.float32)], axis=1)
    while want.shape[1] > 1:
        h = want.shape[1] // 2
        want = want[:, :h] + want[:, h:]
    got = tree_sum(torch.as_tensor(t), 1).numpy()
    np.testing.assert_array_equal(got, want[:, 0])
    np.testing.assert_allclose(got, t.astype(np.float64).sum(axis=1),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the plain kernels against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def test_plain_whole_solve_matches_pdhg_pallas():
    batch = random_lp_batch(_rng(17), 4, 6, 6)
    f32 = jnp.float32
    x, obj, status, iters, y, z = (np.asarray(o) for o in pdhg_pallas(
        jnp.asarray(batch.A, f32), jnp.asarray(batch.b, f32),
        jnp.asarray(batch.c, f32), None, m=6, n=6, tile_b=2,
        max_iters=ref_pdhg.default_pdhg_max_iters(6, 6), tol=TOL))
    A, b, c, ub = batch_tensors(batch_from_reference(batch), "cpu")
    before = pdhg_tile.launches
    got = pdhg_tile(A, b, c, ub, m=6, n=6,
                    max_iters=port_pdhg.default_pdhg_max_iters(6, 6))
    assert pdhg_tile.launches == before   # CPU tensors: no kernel launch
    want = pdhg_tile_plain(A, b, c, ub, m=6, n=6,
                           max_iters=port_pdhg.default_pdhg_max_iters(6, 6))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    np.testing.assert_array_equal(got[2].numpy(), status)
    ok = status == OPTIMAL
    np.testing.assert_allclose(got[1].numpy()[ok], obj[ok], rtol=XTOL,
                               atol=XTOL)
    np.testing.assert_allclose(got[0].numpy(), x, rtol=XTOL, atol=XTOL)


def test_plain_segment_matches_pdhg_segment_pallas():
    """One segment launch from the same mid-solve state, carried from the
    reference's tile layout by ``pdhg_state_from_reference``."""
    batch = random_lp_batch(_rng(19), 3, 5, 5, feasible_start=False)
    f32 = jnp.float32
    s0 = ref_pdhg.init_pdhg_state(jnp.asarray(batch.A, f32),
                                  jnp.asarray(batch.b, f32),
                                  jnp.asarray(batch.c, f32))
    for _ in range(4):   # a mid-solve state
        s0 = ref_pdhg.pdhg_round(s0, tol=TOL)
    tile = build_pdhg_tile_state(s0, m=5, n=5, tile_b=2)
    after, it_ref = pdhg_segment_pallas(6, tile, m=5, n=5, tile_b=2, tol=TOL)
    state = pdhg_state_from_reference(tile, m=5, n=5, batch=3)
    want_state = pdhg_state_from_reference(after, m=5, n=5, batch=3)
    before = pdhg_segment_tile.launches
    got, it = pdhg_segment_tile(state, 6, m=5, n=5, max_rounds=10_000)
    assert pdhg_segment_tile.launches == before
    plain, plain_it = pdhg_segment_tile_plain(state, 6, max_rounds=10_000)
    for g, w in zip(got, plain):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    np.testing.assert_array_equal(got.status.numpy(),
                                  want_state.status.numpy())
    np.testing.assert_array_equal(got.iters.numpy(),
                                  want_state.iters.numpy())
    assert int(it.max()) == int(np.asarray(it_ref).max())
    for leaf in ("x", "y", "xs", "ys", "omega"):
        g = getattr(got, leaf).numpy()
        w = getattr(want_state, leaf).numpy()
        np.testing.assert_allclose(g, w, rtol=XTOL,
                                   atol=XTOL * max(1.0, np.abs(w).max()),
                                   err_msg=leaf)


def test_one_round_from_a_carried_engine_state():
    batch = random_lp_batch(_rng(20), 4, 6, 5)
    f32 = jnp.float32
    s0 = ref_pdhg.init_pdhg_state(jnp.asarray(batch.A, f32),
                                  jnp.asarray(batch.b, f32),
                                  jnp.asarray(batch.c, f32))
    s1 = ref_pdhg.pdhg_round(s0, tol=TOL)
    state = pdhg_state_from_reference(s0, m=6, n=5)
    got = pdhg_round(state, state.status == -1, tol=TOL)
    want = pdhg_state_from_reference(s1, m=6, n=5)
    np.testing.assert_array_equal(got.status.numpy(), want.status.numpy())
    np.testing.assert_array_equal(got.iters.numpy(), want.iters.numpy())
    for leaf in ("x", "y", "xs", "ys", "xr", "yr", "omega", "last_res"):
        np.testing.assert_allclose(getattr(got, leaf).numpy(),
                                   getattr(want, leaf).numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=leaf)


# ---------------------------------------------------------------------------
# step rules, compaction, warm starts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("feasible_start", [True, False])
def test_malitsky_pock_matches_reference(feasible_start):
    batch = random_lp_batch(_rng(4), 6, 8, 8, feasible_start=feasible_start)
    ref = solve_batched_pdhg(batch, step_rule="malitsky_pock")
    got = _port(batch, step_rule="malitsky_pock")
    _assert_parity(ref, got)
    # the kernel entry point on CPU tensors is the same plain engine
    _bitwise(got, solve_batched_kernel(batch_from_reference(batch),
                                       device="cpu", backend="pdhg",
                                       step_rule="malitsky_pock"))


def test_compaction_matches_reference_compacted():
    batch = random_lp_batch(_rng(13), 12, 8, 8)
    ref = solve_batched_pdhg_compacted(batch, segment_k=4,
                                       compact_threshold=0.75)
    stats = []
    got = port_pdhg.solve_batched_pdhg_compacted(
        batch_from_reference(batch), device="cpu", segment_k=4,
        compact_threshold=0.75, stats_out=stats)
    _assert_parity(ref, got)
    assert len({s.bucket for s in stats}) > 1 and all(
        s.stage == "p2" for s in stats)
    assert got.warm is None


@pytest.mark.parametrize("max_iters", [None, 96])
def test_compaction_equals_the_whole_solve_bit_for_bit(max_iters):
    batch = batch_from_reference(random_lp_batch(_rng(14), 10, 7, 7,
                                                 feasible_start=False))
    whole = port_pdhg.solve_batched_pdhg(batch, device="cpu",
                                         max_iters=max_iters)
    for solve in (port_pdhg.solve_batched_pdhg_compacted,
                  lambda b, **kw: solve_batched_kernel(
                      b, backend="pdhg", compaction=True, **kw)):
        got = solve(batch, device="cpu", max_iters=max_iters, segment_k=3,
                    compact_threshold=0.9)
        _bitwise(got, whole)
    if max_iters is not None:
        assert (whole.status == 3).any()


def test_kernel_backed_schedule_equals_the_plain_one_on_cpu():
    batch = batch_from_reference(random_lp_batch(_rng(15), 6, 5, 5))
    kw = dict(max_iters=None, segment_k=2, compact_threshold=0.9,
              stats_out=None)
    got = schedule_pdhg(PdhgKernelBackend(5, 5), batch, torch.device("cpu"),
                        **kw)
    want = schedule_pdhg(PdhgBackend(5, 5), batch, torch.device("cpu"), **kw)
    _bitwise(got, want)


def test_chunked_and_permuted_batches_give_each_lp_the_same_result():
    batch = batch_from_reference(random_lp_batch(_rng(16), 9, 6, 6,
                                                 feasible_start=False))
    whole = port_pdhg.solve_batched_pdhg(batch, device="cpu")
    chunked = batching.solve_batched(batch, device="cpu", backend="pdhg",
                                     chunk_size=4, sort_by_difficulty=True)
    _bitwise(chunked, whole)
    for f in ("x", "y", "omega", "eta"):
        np.testing.assert_array_equal(getattr(chunked.warm, f),
                                      getattr(whole.warm, f))
    perm = _rng(3).permutation(9)
    permuted = port_pdhg.solve_batched_pdhg(
        LPBatch(A=batch.A[perm], b=batch.b[perm], c=batch.c[perm]),
        device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(permuted, f),
                                      getattr(whole, f)[perm], err_msg=f)


@pytest.mark.parametrize("m, n", [(100, 100), (35, 32), (300, 300)])
def test_chunk_plan_counts_the_pdhg_setup_peak(m, n):
    """Eq. (5) sizes a pdhg chunk by the setup's peak (A, its scaled copy
    and one tree matvec's products and padded copy), which exceeds the
    tableau's bytes at the paper's shapes; the scheduler's gathers need
    less, so compaction does not halve the chunk."""
    lp = batch_from_reference(random_lp_batch(_rng(17), 1, m, n))
    budget = 16 * 2 ** 30
    pdhg = batching.max_chunk_size(lp, budget, backend="pdhg")
    assert pdhg < batching.max_chunk_size(lp, budget)
    assert pdhg == batching.max_chunk_size(lp, budget, backend="pdhg",
                                           compaction=True)
    assert port_pdhg.pdhg_bytes_per_lp(m, n) >= 4 * 4 * m * n
    assert batching.max_chunk_size(lp, budget, backend="revised") == \
        batching.max_chunk_size(lp, budget)


def test_planned_chunks_equal_the_unchunked_solve(monkeypatch):
    """A CPU budget of four LPs' pdhg peak cuts the batch into chunks
    through solve_batched's own plan, and each LP's result is the
    unchunked one."""
    batch = batch_from_reference(random_lp_batch(_rng(16), 9, 6, 6,
                                                 feasible_start=False))
    whole = port_pdhg.solve_batched_pdhg(batch, device="cpu")
    monkeypatch.setattr(batching, "CPU_DEVICE_BYTES", int(
        port_pdhg.pdhg_bytes_per_lp(6, 6) * 4 / batching.BUDGET_FRACTION))
    assert 1 < batching.max_chunk_size(
        batch, batching.CPU_DEVICE_BYTES, backend="pdhg") < 9
    _bitwise(batching.solve_batched(batch, device="cpu", backend="pdhg"),
             whole)


def test_warm_trajectory_matches_reference():
    seq = perturbed_sequence(read_mps(fixture_path("afiro")), 6, 2, _rng(2))
    cold_ref = solve_batched_pdhg(seq[0])
    ws = cold_ref.warm_start()
    ref = solve_batched_pdhg(seq[1], warm=ws)
    got = _port(seq[1], warm=warm_from_reference(ws))
    _assert_parity(ref, got)
    cold = _port(seq[1])
    _assert_parity(cold, got, rtol=2e-3)   # tests/test_warm.py's contract
    assert got.iterations.sum() < cold.iterations.sum()
    # the re-solve of a batch from its own optimum
    own = _port(seq[1], warm=cold.warm_start())
    _assert_parity(cold, own, rtol=2e-3)
    assert own.iterations.mean() <= 0.25 * cold.iterations.mean()


def test_garbage_iterates_trip_the_reset_guard():
    """A warm point far worse than the cold start is rejected per LP: the
    warm solve is the cold solve, bit for bit, as in the reference."""
    batch = random_lp_batch(_rng(6), 8, 6, 5)
    m, n, B = 6, 5, 8
    garbage = WarmStart(m=m, n=n, x=np.full((B, n), 1e12),
                        y=np.full((B, m), -1e12), omega=np.full((B,), 1e9),
                        eta=np.full((B,), 1.0))
    cold = _port(batch)
    warm = _port(batch, warm=warm_from_reference(garbage))
    _bitwise(warm, cold)
    ref_cold = solve_batched_pdhg(batch)
    ref_warm = solve_batched_pdhg(batch, warm=garbage)
    np.testing.assert_array_equal(ref_warm.iterations, ref_cold.iterations)
    _assert_parity(ref_warm, warm)


def test_warm_start_through_the_kernel_entry_point_and_the_scheduler():
    batch = batch_from_reference(_afiro(B=4, seed=3))
    cold = port_pdhg.solve_batched_pdhg(batch, device="cpu")
    ws = cold.warm_start()
    engine = port_pdhg.solve_batched_pdhg(batch, device="cpu", warm=ws)
    kernel = solve_batched_kernel(batch, device="cpu", backend="pdhg",
                                  warm=ws)
    _bitwise(kernel, engine)
    sched = port_pdhg.solve_batched_pdhg_compacted(batch, device="cpu",
                                                   warm=ws)
    _bitwise(sched, engine)


# ---------------------------------------------------------------------------
# sparse
# ---------------------------------------------------------------------------

def test_sparse_matches_reference_and_the_dense_engine():
    batch = random_sparse_lp_batch(_rng(2), 8, 12, 16)
    ref = ref_sparse.solve_batched_pdhg_sparse(
        ref_sparse.SparseLPBatch.from_dense(batch))
    sp = port_sparse.SparseLPBatch.from_dense(batch_from_reference(batch))
    got = port_sparse.solve_batched_pdhg_sparse(sp, device="cpu")
    _assert_parity(ref, got)
    # the sparse sums follow the dense kernels' order: equal bit for bit
    _bitwise(got, _port(batch))
    orc = solve_batched_reference(batch)
    assert (got.status == orc.status).mean() >= 0.9
    assert _rel_obj_err(got, orc) < CHECK


def test_sparse_batch_round_trips_and_keeps_bounds():
    batch = batch_from_reference(_bounded_batch())
    sp = port_sparse.SparseLPBatch.from_dense(batch)
    ref = ref_sparse.SparseLPBatch.from_dense(_bounded_batch())
    np.testing.assert_array_equal(sp.rows, ref.rows)
    np.testing.assert_array_equal(sp.cols, ref.cols)
    np.testing.assert_array_equal(sp.vals, ref.vals)
    back = sp.to_dense()
    np.testing.assert_array_equal(back.A, batch.A)
    np.testing.assert_array_equal(back.ub, batch.ub)
    assert sp.nnz == ref.nnz and sp.density == ref.density
    got = port_sparse.solve_batched_pdhg_sparse(sp, device="cpu")
    _assert_parity(ref_sparse.solve_batched_pdhg_sparse(ref), got)
    _bitwise(got, port_pdhg.solve_batched_pdhg(batch, device="cpu"))
    with pytest.raises(TypeError, match="SparseLPBatch"):
        port_sparse.solve_batched_pdhg_sparse(batch, device="cpu")


def test_sparse_matvecs_equal_the_dense_products():
    batch = batch_from_reference(random_sparse_lp_batch(_rng(7), 3, 9, 11))
    sp = port_sparse.SparseLPBatch.from_dense(batch)
    mv = port_sparse.sparse_matvecs(sp.rows, sp.cols, sp.m, sp.n, "cpu")
    vals = torch.as_tensor(sp.vals, dtype=torch.float32)
    A = torch.as_tensor(batch.A, dtype=torch.float32)
    x = torch.as_tensor(_rng(8).standard_normal((3, 11)), dtype=torch.float32)
    y = torch.as_tensor(_rng(9).standard_normal((3, 9)), dtype=torch.float32)
    assert torch.equal(mv.ax(vals, x), port_pdhg.dense_ax(A, x))
    assert torch.equal(mv.aty(vals, y), port_pdhg.dense_aty(A, y))
    torch.testing.assert_close(mv.ax(vals, x), torch.einsum("bmn,bn->bm",
                                                            A, x))
    torch.testing.assert_close(mv.aty(vals, y), torch.einsum("bmn,bm->bn",
                                                             A, y))


# ---------------------------------------------------------------------------
# options
# ---------------------------------------------------------------------------

def test_options_the_engine_refuses():
    batch = batch_from_reference(random_lp_batch(_rng(20), 2, 4, 4))
    with pytest.raises(ValueError, match="pricing"):
        port_pdhg.solve_batched_pdhg(batch, device="cpu", pricing="devex")
    with pytest.raises(ValueError, match="step_rule"):
        port_pdhg.solve_batched_pdhg(batch, device="cpu", step_rule="armijo")
    for solve in (port_pdhg.solve_batched_pdhg_compacted,
                  lambda b, **kw: solve_batched_kernel(
                      b, backend="pdhg", compaction=True, **kw),
                  lambda b, **kw: batching.solve_batched(
                      b, backend="pdhg", compaction=True, **kw)):
        with pytest.raises(ValueError, match="malitsky_pock"):
            solve(batch, device="cpu", step_rule="malitsky_pock")


def test_segment_state_leaves_and_per_lp_cap():
    batch = batch_from_reference(random_lp_batch(_rng(22), 5, 4, 4))
    A, b, c, ub = batch_tensors(batch, "cpu")
    state = init_pdhg_state(A, b, c, ub)
    assert isinstance(state, PdhgState)
    assert (state.phase == 2).all() and (state.status == -1).all()
    s1, it = segment_pdhg(state, 3, tol=1e-12, max_rounds=2)
    assert (it == 2).all() and (s1.iters == 32).all()
    assert (s1.status == 3).all()   # at its cap, still running
    s2, it2 = segment_pdhg(s1, 3, tol=1e-12, max_rounds=2)
    assert (it2 == 0).all()
    for g, w in zip(s2, s1):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
