"""The port's compaction scheduler and segment kernel against the reference.

``repro_torch.core.compaction.solve_batched_compacted`` (the plain engine
under the scheduler) gets the same NumPy inputs as the reference's
``solve_batched_compacted``: statuses, iterations, x and objectives must be
bit-identical, and equal to the port's unsegmented engine's, also when
``max_iters`` binds.  One launch of ``segment_tile`` (on CPU tensors: its
plain version) is held against one launch of the reference's
``segment_pallas`` at ``tile_b=1`` (interpret mode), which gives the
reference the kernel's per-LP exit.  The CUDA segment kernel itself is held
against the plain version on the card (tests/test_torch_package.py, marker
``gpu``; chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (INFEASIBLE, OPTIMAL, UNBOUNDED, LPBatch,
                        random_lp_batch, solve_batched_jax)
from repro.core import solve_batched_compacted as compacted_ref
from repro.core.simplex import tableau_elements as tableau_elements_ref
from repro.kernels.ops import PallasBackend
from repro.kernels.simplex_tile import segment_pallas
from repro_torch.core import batching
from repro_torch.core.compaction import (auto_compact_threshold,
                                         auto_segment_k, next_bucket,
                                         solve_batched_compacted)
from repro_torch.core.simplex import solve_batched_torch, tableau_elements
from repro_torch.interop import (batch_from_reference, result_arrays,
                                 segment_state_from_tile)
from repro_torch.kernels import segment_tile
from repro_torch.kernels.ops import solve_batched_kernel
from repro_torch.obs import SolveReport, SpanTracer

BITWISE = ("status", "iterations", "x", "objective")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mixed_statuses_batch(rng, B_each=10, m=8, n=6):
    """OPTIMAL, INFEASIBLE and UNBOUNDED LPs in one permuted batch: the
    construction of the reference's tests/test_compaction.py."""
    feas = random_lp_batch(rng, B_each, m, n, feasible_start=True)
    p1 = random_lp_batch(rng, B_each, m, n, feasible_start=False)
    inf = random_lp_batch(rng, B_each, m, n, feasible_start=True)
    A_inf, b_inf = inf.A.copy(), inf.b.copy()
    A_inf[:, 0, :] = 0.0         # first row forces x_0 <= -1 with x >= 0
    A_inf[:, 0, 0] = 1.0
    b_inf[:, 0] = -1.0
    unb = random_lp_batch(rng, B_each, m, n, feasible_start=True)
    A_unb = unb.A.copy()
    A_unb[:, :, 0] = 0.0         # x_0 is free to grow and pays
    c_unb = unb.c.copy()
    c_unb[:, 0] = 1.0
    batch = LPBatch(A=np.concatenate([feas.A, p1.A, A_inf, A_unb]),
                    b=np.concatenate([feas.b, p1.b, b_inf, unb.b]),
                    c=np.concatenate([feas.c, p1.c, inf.c, c_unb]))
    perm = rng.permutation(batch.batch)
    return LPBatch(A=batch.A[perm], b=batch.b[perm], c=batch.c[perm])


def _motivation_batch():
    """8 feasible-start then 8 phase-1 random 12 x 10 LPs."""
    rng = np.random.default_rng(3)
    a = random_lp_batch(rng, 8, 12, 10, feasible_start=True)
    b = random_lp_batch(rng, 8, 12, 10, feasible_start=False)
    return LPBatch(A=np.concatenate([a.A, b.A]), b=np.concatenate([a.b, b.b]),
                   c=np.concatenate([a.c, b.c]))


def _assert_bitwise(got, want, fields=BITWISE):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(got[f]), np.asarray(want[f]),
                                      err_msg=f)


def _port(batch, fn=solve_batched_compacted, **kw):
    return result_arrays(fn(batch_from_reference(batch), device="cpu", **kw))


@pytest.mark.parametrize("segment_k", [1, 4, 16])
def test_scheduled_matches_reference_scheduler_bitwise(segment_k):
    batch = _mixed_statuses_batch(np.random.default_rng(17))
    want = result_arrays(compacted_ref(batch, segment_k=segment_k))
    got = _port(batch, segment_k=segment_k)
    _assert_bitwise(got, want)
    _assert_bitwise(got, _port(batch, fn=solve_batched_torch),
                    fields=BITWISE + ("y", "z"))
    for code in (OPTIMAL, INFEASIBLE, UNBOUNDED):
        assert (got["status"] == code).any()


@pytest.mark.parametrize("pricing", ["devex", "steepest_edge"])
def test_pricing_rules_match_reference_scheduler(pricing):
    batch = _mixed_statuses_batch(np.random.default_rng(23))
    want = result_arrays(compacted_ref(batch, segment_k=4, pricing=pricing))
    got = _port(batch, segment_k=4, pricing=pricing)
    _assert_bitwise(got, want)
    _assert_bitwise(got, _port(batch, fn=solve_batched_torch,
                               pricing=pricing))


@pytest.mark.parametrize("max_iters", [2, 5])
def test_binding_budget_matches_the_unsegmented_solvers(max_iters):
    """Per-LP budgets: LPs that leave phase 1 early keep their own budget
    for phase 2, as in the unsegmented engine (the reference's shared
    budget does not carry over)."""
    batch = _motivation_batch()
    want = result_arrays(solve_batched_jax(batch, max_iters=max_iters))
    unseg = _port(batch, fn=solve_batched_torch, max_iters=max_iters)
    for k in (1, 4):
        got = _port(batch, segment_k=k, max_iters=max_iters)
        _assert_bitwise(got, want)
        _assert_bitwise(got, unseg)
    if max_iters == 5:   # the feasible-start half solves within the budget
        assert (want["status"][:8] == OPTIMAL).all()
    assert (want["iterations"] <= max_iters).all()


def test_stats_record_the_bucket_ladder():
    batch = _mixed_statuses_batch(np.random.default_rng(29), B_each=16)
    m, n = batch.m, batch.n
    stats = []
    _port(batch, segment_k=2, stats_out=stats)
    assert {s.stage for s in stats} == {"p1", "p2"}
    assert stats[0].bucket == batch.batch
    assert min(s.bucket for s in stats) < batch.batch   # a gather happened
    for s in stats:
        assert s.bucket in (batch.batch, next_bucket(s.bucket))
        assert 0 <= s.steps <= 2
        assert s.elements == s.steps * s.bucket * tableau_elements(
            m, n, compacted=s.stage == "p2")
    assert stats[-1].survivors == 0
    assert tableau_elements(m, n) == tableau_elements_ref(m, n)
    assert (tableau_elements(m, n, True)
            == tableau_elements_ref(m, n, compacted=True))


def test_auto_parameters_match_the_reference():
    from repro.core.compaction import auto_compact_threshold as act_ref
    from repro.core.compaction import auto_segment_k as ask_ref
    for m, n in ((8, 6), (100, 100), (35, 32)):
        assert auto_segment_k(m, n) == ask_ref(m, n)
    for k in (1, 2, 4, 32):
        assert auto_compact_threshold(k) == act_ref(k)


@pytest.mark.parametrize("kw", [dict(), dict(chunk_size=7),
                                dict(chunk_size=9, sort_by_difficulty=True)],
                         ids=["whole", "chunked", "chunked_sorted"])
def test_front_door_compaction_equals_the_unsegmented_path(kw):
    batch = batch_from_reference(
        _mixed_statuses_batch(np.random.default_rng(31)))
    want = result_arrays(batching.solve_batched(batch, device="cpu"))
    got = result_arrays(batching.solve_batched(batch, device="cpu",
                                               compaction=True, segment_k=3,
                                               **kw))
    _assert_bitwise(got, want, fields=BITWISE + ("y", "z"))


def test_kernel_backend_on_cpu_tensors_equals_the_plain_scheduler():
    batch = batch_from_reference(
        _mixed_statuses_batch(np.random.default_rng(37)))
    before = segment_tile.launches
    stats = []
    got = result_arrays(solve_batched_kernel(
        batch, device="cpu", compaction=True, segment_k=4, stats_out=stats))
    assert segment_tile.launches == before
    assert stats
    _assert_bitwise(got, _port(batch, segment_k=4),
                    fields=BITWISE + ("y", "z"))


def test_custom_solver_must_accept_compaction():
    batch = batch_from_reference(
        random_lp_batch(np.random.default_rng(2), B=4, m=3, n=3))

    def plain(b, *, device):
        return solve_batched_torch(b, device=device)

    with pytest.raises(ValueError, match="compaction"):
        batching.solve_batched(batch, device="cpu", solver=plain,
                               compaction=True)
    got = batching.solve_batched(batch, device="cpu", compaction=True,
                                 solver=solve_batched_kernel)
    np.testing.assert_array_equal(
        got.iterations, solve_batched_torch(batch, device="cpu").iterations)


@pytest.mark.parametrize("backend,telemetry,traced", [
    ("revised", True, False),
    ("tableau", True, False),
    ("tableau", False, True),
    ("revised", False, True),
    ("pdhg", True, False),
])
def test_observability_options_report_and_trace(backend, telemetry, traced):
    """``telemetry=True`` brings back an ``obs.SolveReport`` whose
    iterations are the result's; a tracer records the scheduler's spans."""
    batch = random_lp_batch(np.random.default_rng(4), B=2, m=3, n=3)
    tracer = SpanTracer() if traced else None
    res = solve_batched_compacted(batch, device="cpu", backend=backend,
                                  telemetry=telemetry, tracer=tracer)
    if telemetry:
        assert isinstance(res.stats, SolveReport)
        assert res.stats.backend.endswith("Backend")
        np.testing.assert_array_equal(res.stats.iterations, res.iterations)
    else:
        assert res.stats is None
    if traced:
        names = {s.name for root in tracer.roots for s in root.walk()}
        assert {"canonicalize", "dispatch", "recover"} <= names
        assert "segment[p2]" in names


# ---- one segment launch against the reference's segment kernel ----------

def _segment_case(case, rule, stage):
    """(reference tile state, backend, m, n): a mid-solve state of the
    reference's PallasBackend at tile_b=1."""
    m, n = 8, 10
    rng = np.random.default_rng(17)
    lp = random_lp_batch(rng, B=6, m=m, n=n, feasible_start=stage == "p2")
    if case == "bounded":
        ub = rng.uniform(0.05, 0.5, size=(6, n))
        ub[:, ::3] = np.inf
        lp = LPBatch.from_arrays(lp.A, lp.b, lp.c, ub=ub)
    A, b, c, ub = (jnp.asarray(np.asarray(a, np.float32))
                   for a in (lp.A, lp.b, lp.c, lp.upper_bounds()))
    be = PallasBackend(m, n, 1e-6, 1e-5, tile_b=1, interpret=True,
                       pricing=rule)
    st = be.init(A, b, c, ub=ub)
    if stage == "p1":
        st, _ = be.run_phase1(st, 3)
    else:   # feasible start: every LP is in phase 2 already
        st = be.compact_columns(be.limit_phase1(st))
    return st, m, n


@pytest.mark.parametrize("stage", ["p1", "p2"])
@pytest.mark.parametrize("rule", ["dantzig", "devex", "steepest_edge"])
@pytest.mark.parametrize("case", ["unbounded", "bounded"])
def test_one_launch_matches_the_reference_segment_kernel(case, rule, stage):
    st, m, n = _segment_case(case, rule, stage)
    steps = 6
    port = segment_state_from_tile(st, m=m, n=n, stage=stage)
    T, basis, w, flip, phase, status, iters, it = segment_pallas(
        jnp.int32(steps), st.T, st.basis, st.w, st.flip, st.ub, st.phase,
        st.thr, st.status, st.iters, stage=stage, m=m, n=n, tile_b=1,
        tol=1e-6, interpret=True, pricing=rule)
    want = segment_state_from_tile(
        st._replace(T=T, basis=basis, w=w, flip=flip, phase=phase,
                    status=status, iters=iters), m=m, n=n, stage=stage)
    got, got_it = segment_tile(port, steps, stage=stage, m=m, n=n,
                               max_iters=1000, pricing=rule)
    for leaf in ("basis", "phase", "status", "iters", "flip"):
        torch.testing.assert_close(getattr(got, leaf), getattr(want, leaf),
                                   rtol=0, atol=0, msg=leaf)
    np.testing.assert_array_equal(got_it.numpy(),
                                  np.asarray(it).reshape(-1))
    assert int(got_it.max()) > 1
    if case == "unbounded":
        torch.testing.assert_close(got.T, want.T, rtol=0, atol=0)
    else:
        # the reference's bound flip rounds ub_e * col before subtracting
        # it from the rhs (two roundings, the port's fma one), so rhs
        # entries that cancel differ in their last bits: rel 1e-5 of each
        # LP's largest tableau entry
        scale = want.T.abs().amax(dim=(1, 2), keepdim=True)
        assert ((got.T - want.T).abs() <= 1e-5 * scale).all()
