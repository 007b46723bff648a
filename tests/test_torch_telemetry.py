"""The port's telemetry plane (``repro_torch.obs``) against the reference's.

Mirrors tests/test_telemetry.py at small sizes: the same inputs, made from
a seed with numpy, go through the reference's engines with
``telemetry=True`` and through the port's, and the counter lanes must
agree.  The iteration-attribution invariant holds everywhere:
``phase1_iters + phase2_iters == LPResult.iterations`` on every engine and
every scheduling path.

* Tableau: every lane equals the reference's exactly.
* Revised: the pivot lanes (iterations and pivots by phase, flips,
  degenerate pivots, block rotations) equal the reference engine's
  exactly.  Its eta clock is shared across the batch where the port's is
  per LP, so the refactorization and eta-length lanes are held against
  the reference engine run one LP at a time: ``eta_len`` equal, and
  ``refactorizations`` one more in the port, whose solve factorizes at
  its first step where the reference starts from the slack basis's
  identity factor without counting it.
* PDHG: the port sums in the kernels' order, so only statuses are exact
  against the reference; omega of OPTIMAL LPs and the KKT and omega
  lanes of LPs stopped mid-solve agree within ``XTOL`` relative and
  ``XTOL`` times that lane's largest value, the tolerance
  tests/test_torch_pdhg.py holds the port's iterates and omega to.  The
  KKT lanes of converged LPs are residuals below the tolerance whose
  digits two summation orders do not share: only that bound is checked.

The plain versions of the three counter-carrying CUDA segment kernels,
started from a reference mid-solve state with non-zero counters (carried
by ``repro_torch.interop``), give the rows of the reference's Pallas
segment kernels in interpret mode.  The kernels themselves are held
against the plain versions on the card (marker ``gpu``); those tests need
no JAX, so ``python -m pytest -m gpu tests/test_torch_telemetry.py`` runs
on a machine with a card and without the reference.
"""
import json

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.core import batching
from repro_torch.core.compaction import (TorchBackend, map_state,
                                         segment_pending)
from repro_torch.core.compaction import \
    solve_batched_compacted as port_compacted
from repro_torch.core.pdhg import PdhgBackend, PdhgState, solve_pdhg
from repro_torch.core.pdhg import solve_batched_pdhg as port_pdhg
from repro_torch.core.pdhg import \
    solve_batched_pdhg_compacted as port_pdhg_compacted
from repro_torch.core.reference import random_lp_batch as port_random_batch
from repro_torch.core.revised import RevisedBackend, solve_revised
from repro_torch.core.revised import solve_batched_revised as port_revised
from repro_torch.core.revised import \
    solve_batched_revised_compacted as port_revised_compacted
from repro_torch.core.simplex import (batch_tensors, solve_batched_torch,
                                      solve_two_phase, tableau_elements)
from repro_torch.interop import (batch_from_reference,
                                 pdhg_state_from_reference,
                                 revised_state_from_tile,
                                 segment_state_from_tile)
from repro_torch.kernels import (pdhg_segment_tile, pdhg_segment_tile_plain,
                                 revised_segment_tile,
                                 revised_segment_tile_plain, segment_tile,
                                 segment_tile_plain)
from repro_torch.kernels.ops import solve_batched_kernel
from repro_torch.kernels.pdhg_tile import variant as pdhg_variant
from repro_torch.kernels.revised_tile import variant as revised_variant
from repro_torch.kernels.simplex_tile import tableau_in_smem
from repro_torch.obs import SolveReport, SpanTracer
from repro_torch.obs.telemetry import (ALL_LANES, F32_LANES, INT_LANES,
                                       init_telemetry, tel_to_rows)
from repro_torch.obs.work import element_updates_lockstep, lockstep_steps

try:   # the card's machine has no JAX: only the gpu tests run there
    import jax
    import jax.numpy as jnp
    from repro.core import LPBatch as RefLPBatch
    from repro.core import (OPTIMAL, random_lp_batch, solve_batched,
                            solve_batched_compacted, solve_batched_pdhg,
                            solve_batched_reference_detailed,
                            solve_batched_revised)
    from repro.core import pdhg as ref_pdhg
    from repro.io.mps import fixture_path, perturbed_batch, read_mps
    from repro.kernels.ops import PallasBackend, RevisedPallasBackend
    from repro.kernels.pdhg_tile import (build_pdhg_tile_state,
                                         pdhg_segment_pallas)
    from repro.kernels.revised_tile import revised_segment_pallas
    from repro.kernels.simplex_tile import segment_pallas
    from repro.obs import SpanTracer as RefSpanTracer
    from repro.obs import work as ref_work
    from repro.obs.telemetry import init_telemetry as ref_init_telemetry
    from repro.obs.telemetry import tel_to_rows as ref_tel_to_rows
except ImportError:
    jax = None

XTOL = 1e-3   # tests/test_torch_pdhg.py's budget against the reference
# the revised lanes the reference's shared eta clock decides
CLOCK_LANES = ("refactorizations", "eta_len")


@pytest.fixture(scope="module", autouse=True)
def _release_telemetry_executables():
    """Drop the reference's compiled executables when this module ends:
    every telemetry=True solve retraces an engine with the counter lanes
    in its carry, and holding them all pushes a later module's compile
    into XLA's limits (the reference's tests/test_telemetry.py does the
    same)."""
    yield
    if jax is not None:
        jax.clear_caches()


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mixed_batch(rng, B=24, m=6, n=6):
    """Half feasible-start, half phase-1 LPs: both phase lanes fire."""
    half = B // 2
    b1 = random_lp_batch(rng, half, m, n, feasible_start=True)
    b2 = random_lp_batch(rng, B - half, m, n, feasible_start=False)
    perm = rng.permutation(B)
    return RefLPBatch(A=np.concatenate([b1.A, b2.A])[perm],
                      b=np.concatenate([b1.b, b2.b])[perm],
                      c=np.concatenate([b1.c, b2.c])[perm])


def _degenerate_batch(rng, B=8, m=6, n=6):
    """Feasible-start LPs with zeroed rhs rows: the first pivots have a
    minimum ratio of zero."""
    batch = random_lp_batch(rng, B, m, n, feasible_start=True)
    b = batch.b.copy()
    b[:, :2] = 0.0
    return RefLPBatch(A=batch.A, b=b, c=batch.c)


PORT = {"tableau": solve_batched_torch, "revised": port_revised,
        "pdhg": port_pdhg}


def _port(batch, backend="tableau", **kw):
    return PORT[backend](batch_from_reference(batch), device="cpu", **kw)


def _assert_report_consistent(res):
    rep = res.stats
    assert isinstance(rep, SolveReport)
    assert set(rep.counters) == set(ALL_LANES)
    np.testing.assert_array_equal(rep.iterations, np.asarray(res.iterations))
    for name in INT_LANES:
        assert rep.lane(name).dtype == np.int32
        assert (rep.lane(name) >= 0).all(), name
    for name in F32_LANES:
        assert rep.lane(name).dtype == np.float32
    return rep


def _assert_lanes_equal(got, want, lanes=ALL_LANES):
    for name in lanes:
        np.testing.assert_array_equal(got.lane(name), want.lane(name),
                                      err_msg=name)


def _pivot_lanes(backend):
    return tuple(n for n in INT_LANES
                 if backend != "revised" or n not in CLOCK_LANES)


# ---------------------------------------------------------------------------
# the engines against the reference's and the float64 oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["tableau", "revised"])
@pytest.mark.parametrize("fixture", ["afiro", "testprob"])
def test_fixture_parity_vs_oracle(backend, fixture):
    batch = perturbed_batch(read_mps(fixture_path(fixture)), 6,
                            np.random.default_rng(0))
    orc, p1 = solve_batched_reference_detailed(batch)
    ref = solve_batched(batch, backend=backend, telemetry=True)
    got = batching.solve_batched(batch_from_reference(batch), device="cpu",
                                 backend=backend, telemetry=True)
    rep = _assert_report_consistent(got)
    np.testing.assert_array_equal(got.status, orc.status)
    np.testing.assert_array_equal(rep.iterations, orc.iterations)
    np.testing.assert_array_equal(rep.lane("phase1_iters"), p1)
    _assert_lanes_equal(rep, ref.stats, _pivot_lanes(backend))


@pytest.mark.parametrize("backend", ["tableau", "revised"])
def test_dense_feasible_parity(backend):
    """Feasible-start LPs skip phase 1 (the oracle charges its feasibility
    check as one phase-1 iteration): the phase-2 lane alone equals the
    oracle's phase-2 count, and every pivot lane the reference's."""
    batch = random_lp_batch(np.random.default_rng(3), 16, 6, 6,
                            feasible_start=True)
    orc, p1 = solve_batched_reference_detailed(batch)
    got = _port(batch, backend, telemetry=True)
    rep = _assert_report_consistent(got)
    np.testing.assert_array_equal(got.status, orc.status)
    assert not rep.lane("phase1_iters").any()
    np.testing.assert_array_equal(rep.lane("phase2_iters"),
                                  np.asarray(orc.iterations) - p1)
    ref = solve_batched(batch, backend=backend, telemetry=True)
    _assert_lanes_equal(rep, ref.stats, _pivot_lanes(backend))


def test_phase1_dense_parity_revised():
    batch = random_lp_batch(np.random.default_rng(1), 16, 6, 6,
                            feasible_start=False)
    orc, p1 = solve_batched_reference_detailed(batch)
    rep = _assert_report_consistent(_port(batch, "revised", telemetry=True))
    np.testing.assert_array_equal(rep.iterations, orc.iterations)
    np.testing.assert_array_equal(rep.lane("phase1_iters"), p1)
    assert rep.lane("phase1_iters").any() and rep.lane("phase2_iters").any()
    ref = solve_batched_revised(batch, telemetry=True)
    _assert_lanes_equal(rep, ref.stats, _pivot_lanes("revised"))


@pytest.mark.parametrize("backend", ["tableau", "revised"])
def test_degenerate_pivots_lane(backend):
    batch = _degenerate_batch(np.random.default_rng(11))
    rep = _assert_report_consistent(_port(batch, backend, telemetry=True))
    assert rep.lane("degenerate_pivots").any(), \
        "zeroed rhs rows must give pivots at a zero ratio"
    assert (rep.pivots <= rep.iterations).all()
    ref = solve_batched(batch, backend=backend, telemetry=True)
    _assert_lanes_equal(rep, ref.stats, _pivot_lanes(backend))


def _assert_f32_lanes_close(got, want, lanes=F32_LANES, rows=slice(None)):
    """Each float32 lane within XTOL relative and XTOL times that lane's
    own largest value."""
    for name in lanes:
        w = want.lane(name)[rows]
        np.testing.assert_allclose(got.lane(name)[rows], w, rtol=XTOL,
                                   atol=XTOL * np.abs(w).max(), err_msg=name)


def test_pdhg_lanes():
    batch = _mixed_batch(np.random.default_rng(5), B=12)
    got = _port(batch, "pdhg", telemetry=True)
    rep = _assert_report_consistent(got)
    assert not rep.lane("phase1_iters").any()   # one phase: all in lane 2
    ok = np.asarray(got.status) == OPTIMAL
    assert ok.any()
    for name in ("kkt_primal", "kkt_dual", "kkt_gap"):
        vals = rep.lane(name)[ok]
        assert np.isfinite(vals).all() and (vals >= 0).all(), name
        # the candidate that converged is below the tolerance
        assert (vals <= 1e-5).all(), name
    assert (rep.lane("omega")[ok] > 0).all()
    assert rep.lane("restarts").any()
    ref = solve_batched_pdhg(batch, telemetry=True)
    np.testing.assert_array_equal(got.status, ref.status)
    # converged KKT lanes are residuals below 1e-5 whose digits the two
    # summation orders do not share: for them only the bound above holds;
    # omega is compared here, the KKT triple mid-solve below
    _assert_f32_lanes_close(rep, ref.stats, ("omega",), ok)
    # mid-solve (every LP stopped at 64 iterations) the KKT lanes are the
    # residuals of running iterates, O(0.001-0.1), and compared as values
    mid = _port(batch, "pdhg", max_iters=64, telemetry=True)
    mid_ref = solve_batched_pdhg(batch, max_iters=64, telemetry=True)
    np.testing.assert_array_equal(mid.status, mid_ref.status)
    _assert_lanes_equal(mid.stats, mid_ref.stats, INT_LANES)
    assert (mid_ref.stats.lane("kkt_primal") > 0).any()
    _assert_f32_lanes_close(mid.stats, mid_ref.stats)


def test_revised_refactor_lanes():
    batch = _mixed_batch(np.random.default_rng(7), B=8)
    got = _port(batch, "revised", refactor_period=4, telemetry=True)
    rep = _assert_report_consistent(got)
    assert (rep.lane("refactorizations") > 1).any(), \
        "a period-4 clock must fire again on multi-pivot solves"
    assert (rep.lane("eta_len") <= 4).all()
    ref = solve_batched_revised(batch, refactor_period=4, telemetry=True)
    _assert_lanes_equal(rep, ref.stats, _pivot_lanes("revised"))
    # one LP at a time the reference's clock is the LP's own
    for i in range(batch.batch):
        one = RefLPBatch(A=batch.A[i:i + 1], b=batch.b[i:i + 1],
                         c=batch.c[i:i + 1])
        ri = solve_batched_revised(one, refactor_period=4, telemetry=True)
        assert ri.iterations[0] == got.iterations[i]
        assert rep.lane("eta_len")[i] == ri.stats.lane("eta_len")[0]
        assert rep.lane("refactorizations")[i] \
            == ri.stats.lane("refactorizations")[0] + 1


# ---------------------------------------------------------------------------
# counters survive the compaction scheduler and the chunked driver
# ---------------------------------------------------------------------------

def test_counters_survive_bucket_shrink():
    batch = _mixed_batch(np.random.default_rng(9), B=32)
    mono = _port(batch, telemetry=True)
    stats = []
    sched = port_compacted(batch_from_reference(batch), device="cpu",
                           segment_k=4, telemetry=True, stats_out=stats)
    buckets = [s.bucket for s in stats]
    assert min(buckets) < max(buckets), "batch too easy: no bucket shrink"
    rep = _assert_report_consistent(sched)
    _assert_lanes_equal(rep, mono.stats)   # gathers never touch counters
    ref = solve_batched_compacted(batch, segment_k=4, telemetry=True)
    _assert_lanes_equal(rep, ref.stats, INT_LANES)


@pytest.mark.parametrize("backend", ["revised", "pdhg"])
def test_counters_survive_compaction_other_engines(backend):
    batch = _mixed_batch(np.random.default_rng(13), B=16)
    solver = {"revised": port_revised_compacted,
              "pdhg": port_pdhg_compacted}[backend]
    res = solver(batch_from_reference(batch), device="cpu", segment_k=4,
                 telemetry=True)
    rep = _assert_report_consistent(res)
    assert rep.iterations.any()
    whole = _port(batch, backend, telemetry=True)
    if backend == "pdhg":   # compaction equals the whole solve bit for bit
        _assert_lanes_equal(rep, whole.stats)
    else:
        np.testing.assert_array_equal(whole.status, res.status)
        # every segment an LP steps in factorizes at its first step
        assert (rep.lane("refactorizations")
                >= -(-rep.iterations // 4)).all()


def test_counters_survive_chunked_sorted_roundtrip():
    batch = _mixed_batch(np.random.default_rng(15), B=24)
    mono = _port(batch, telemetry=True)
    for compaction in (False, True):
        chunked = batching.solve_batched(
            batch_from_reference(batch), device="cpu", chunk_size=7,
            sort_by_difficulty=True, pad_to_bucket=compaction,
            compaction=compaction, telemetry=True)
        rep = _assert_report_consistent(chunked)
        np.testing.assert_array_equal(chunked.status, mono.status)
        # sort, chunk, pad and back: every LP's counters in its own slot
        _assert_lanes_equal(rep, mono.stats)


# ---------------------------------------------------------------------------
# telemetry=False: no counter tensors, the same operations
# ---------------------------------------------------------------------------

class _OpLog(TorchFunctionMode):
    """Records the name of every torch function a block calls."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.names.append(getattr(func, "__name__", repr(func)))
        return func(*args, **(kwargs or {}))


def _core_ops(backend, **kw):
    batch = port_random_batch(np.random.default_rng(0), 4, 4, 4)
    A, b, c, ub = batch_tensors(batch, torch.device("cpu"))
    common = dict(m=4, n=4, tol=1e-6, feas_tol=1e-5)
    with _OpLog() as log:
        if backend == "tableau":
            solve_two_phase(A, b, c, ub, max_iters=50, **common, **kw)
        elif backend == "revised":
            solve_revised(A, b, c, ub, max_iters=50, refactor_period=4,
                          **common, **kw)
        else:
            solve_pdhg(A, b, c, ub, m=4, n=4, max_iters=200, tol=1e-4, **kw)
    return log.names


@pytest.mark.parametrize("backend", ["tableau", "revised", "pdhg"])
def test_telemetry_off_is_default_and_trace_identical(backend):
    """The torch counterpart of the reference's jaxpr identity: the
    default path calls exactly the torch functions the telemetry-off path
    does, and telemetry=True only adds calls."""
    default = _core_ops(backend)
    off = _core_ops(backend, telemetry=False)
    on = _core_ops(backend, telemetry=True)
    assert default == off
    assert on != off
    assert len(on) > len(off)


def test_off_state_has_no_extra_leaves():
    """With telemetry off every state carries ``tel=None``: no counter
    tensor exists, and a gather maps exactly the leaves it mapped before
    the plane."""
    batch = port_random_batch(np.random.default_rng(1), 4, 3, 3,
                              feasible_start=False)
    A, b, c, ub = batch_tensors(batch, torch.device("cpu"))
    tel = init_telemetry(4)
    assert len(tel) == len(ALL_LANES) == len(INT_LANES) + len(F32_LANES)
    for be in (TorchBackend(3, 3, 1e-6, 1e-5),
               RevisedBackend(3, 3, 1e-6, 1e-5), PdhgBackend(3, 3)):
        state = be.init(A, b, c, ub)
        assert state.tel is None
        mapped = []
        map_state(lambda t: mapped.append(t) or t, state)
        assert len(mapped) == len(state) - 1
        after, _ = be.segment(state, 3, "p2" if isinstance(
            state, PdhgState) else "p1", 100)
        assert after.tel is None
        on = be.init(A, b, c, ub, telemetry=True)
        mapped = []
        map_state(lambda t: mapped.append(t) or t, on)
        assert len(mapped) == len(state) - 1 + len(ALL_LANES)


@pytest.mark.parametrize("backend", ["tableau", "revised", "pdhg"])
def test_stats_none_when_disabled(backend):
    batch = random_lp_batch(np.random.default_rng(2), 4, 4, 4)
    res = _port(batch, backend)
    assert res.stats is None
    on = _port(batch, backend, telemetry=True)
    # turning telemetry on never changes the answers
    for f in ("status", "iterations", "x", "objective"):
        np.testing.assert_array_equal(getattr(res, f), getattr(on, f),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# span tracer and exporters
# ---------------------------------------------------------------------------

def test_perfetto_export_valid_and_nested(tmp_path):
    batch = _mixed_batch(np.random.default_rng(21), B=32)
    tr = SpanTracer()
    with tr.span("solve", B=batch.batch):
        res = port_compacted(batch_from_reference(batch), device="cpu",
                             segment_k=4, telemetry=True, tracer=tr)
    rep = res.stats
    assert rep.spans, "run_schedule must attach the tracer's span tree"
    path = tmp_path / "trace.json"
    rep.to_perfetto(str(path))
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    assert any(nm.startswith("segment[") for nm in names), names
    assert {"canonicalize", "dispatch", "recover", "bucket_gather"} <= names
    root = next(e for e in spans if e["name"] == "solve")
    for e in spans:
        if e["name"].startswith("segment["):
            assert e["ts"] >= root["ts"] - 1e-6
            assert e["ts"] + e["dur"] <= root["ts"] + root["dur"] + 1e-6
    assert any(e["ph"] == "i" for e in events)   # the flush instants
    # the reference's scheduler records the same span names
    ref_tr = RefSpanTracer()
    solve_batched_compacted(batch, segment_k=4, telemetry=True,
                            tracer=ref_tr)
    assert {s.name for r in ref_tr.roots for s in r.walk()} <= names


def test_jsonl_stream_unifies_segments_and_events():
    batch = _mixed_batch(np.random.default_rng(23), B=16)
    tr = SpanTracer()
    stats = []
    port_compacted(batch_from_reference(batch), device="cpu", segment_k=4,
                   telemetry=True, tracer=tr, stats_out=stats)
    lines = [json.loads(ln) for ln in tr.to_jsonl().splitlines()]
    kinds = {(rec["type"], rec["name"]) for rec in lines}
    assert ("event", "flush") in kinds
    segs = [rec for rec in lines
            if rec["type"] == "span" and rec["name"].startswith("segment[")]
    # one span per segment, carrying the scheduler's own record of it
    assert [(r["args"]["bucket"], r["args"]["steps"]) for r in segs] \
        == [(s.bucket, s.steps) for s in stats]


def test_report_algebra_and_summary():
    batch = _mixed_batch(np.random.default_rng(25), B=12)
    rep = _port(batch, telemetry=True).stats
    assert rep.batch_size == 12
    sliced = rep.slice(2, 8)
    assert sliced.batch_size == 6
    np.testing.assert_array_equal(sliced.iterations, rep.iterations[2:8])
    idx = np.array([3, 1, 2])
    np.testing.assert_array_equal(rep.take(idx).iterations,
                                  rep.iterations[idx])
    back = SolveReport.concat([rep.slice(0, 5), rep.slice(5, 12)])
    np.testing.assert_array_equal(back.iterations, rep.iterations)
    assert SolveReport.concat([rep, None]) is None
    s = rep.summary()
    assert s["batch_size"] == 12 and s["backend"] == "tableau"
    assert s["iterations_total"] == int(rep.iterations.sum())
    assert "phase2_iters" in s["lanes"]
    assert "SolveReport" in rep.render()
    assert json.loads(rep.to_json())["summary"]["batch_size"] == 12


def test_work_helper_matches_bespoke_formula():
    iters = np.array([3, 7, 1, 4])
    assert lockstep_steps(iters) == ref_work.lockstep_steps(iters) == 8
    assert element_updates_lockstep(iters, 5, 6) \
        == ref_work.element_updates_lockstep(iters, 5, 6) \
        == 8 * 4 * tableau_elements(5, 6)
    batch = random_lp_batch(np.random.default_rng(27), 8, 5, 5)
    res = _port(batch, telemetry=True)
    assert element_updates_lockstep(res.stats.iterations, 5, 5) == \
        element_updates_lockstep(np.asarray(res.iterations), 5, 5)


# ---------------------------------------------------------------------------
# the segment kernels' plain versions against the reference's Pallas kernels
# ---------------------------------------------------------------------------

def _ref_rows(tel):
    return tuple(np.asarray(r) for r in ref_tel_to_rows(tel))


@pytest.mark.parametrize("stage", ["p1", "p2"])
@pytest.mark.parametrize("rule", ["dantzig", "devex", "steepest_edge"])
def test_segment_plain_rows_match_segment_pallas(rule, stage):
    """One segment from a reference mid-solve state with non-zero counters
    (bounded columns, so flips fire): the plain version's packed int32 row
    equals ``segment_pallas(..., tel_int=)``'s at tile_b=1, and the float32
    row passes through."""
    m, n = 8, 10
    rng = np.random.default_rng(17)
    lp = random_lp_batch(rng, B=6, m=m, n=n, feasible_start=stage == "p2")
    ub = rng.uniform(0.05, 0.5, size=(6, n))
    ub[:, ::3] = np.inf
    lp = RefLPBatch.from_arrays(lp.A, lp.b, lp.c, ub=ub)
    A, b, c, ubj = (jnp.asarray(np.asarray(a, np.float32))
                    for a in (lp.A, lp.b, lp.c, lp.upper_bounds()))
    be = PallasBackend(m, n, 1e-6, 1e-5, tile_b=1, interpret=True,
                       pricing=rule)
    st = be.init(A, b, c, ub=ubj, telemetry=True)
    st, _ = be.run_phase1(st, 3)
    if stage == "p2":
        st = be.compact_columns(be.limit_phase1(st))
        st, _ = be.run_phase2(st, 2)
    rows0 = _ref_rows(st.tel)
    assert rows0[0].any(), "the segment must start from non-zero counters"
    outs = segment_pallas(
        jnp.int32(6), st.T, st.basis, st.w, st.flip, st.ub, st.phase,
        st.thr, st.status, st.iters, jnp.asarray(rows0[0]), stage=stage,
        m=m, n=n, tile_b=1, tol=1e-6, interpret=True, pricing=rule)
    port = segment_state_from_tile(st, m=m, n=n, stage=stage)
    got, it = segment_tile(port, 6, stage=stage, m=m, n=n, max_iters=1000,
                           pricing=rule)
    np.testing.assert_array_equal(it.numpy(),
                                  np.asarray(outs[7]).reshape(-1))
    assert int(it.max()) > 1
    ints, f32s = (r.numpy() for r in tel_to_rows(got.tel))
    np.testing.assert_array_equal(ints, np.asarray(outs[8]))
    np.testing.assert_array_equal(f32s, rows0[1])
    assert (ints != rows0[0]).any()


@pytest.mark.parametrize("stage", ["p1", "p2"])
@pytest.mark.parametrize("rule", ["dantzig", "partial"])
def test_revised_segment_plain_rows_match_revised_segment_pallas(rule,
                                                                  stage):
    """One revised segment from the reference's mid-solve tile state with
    counters, fewer steps than the eta file holds: every lane of the plain
    version's row equals ``revised_segment_pallas(tile_b=1, tel_int=)``'s
    but ``refactorizations``, one more for each LP that stepped: the
    port's block factorizes at its first step, where the reference's host
    factorizes between launches and counts it at the boundary before."""
    m, n, K = 8, 6, 4
    batch = random_lp_batch(np.random.default_rng(9), B=8, m=m, n=n,
                            feasible_start=stage == "p2")
    be = RevisedPallasBackend(m, n, 1e-6, 1e-5, tile_b=1, interpret=True,
                              pricing=rule, refactor_period=K)
    st = be.init(jnp.asarray(batch.A), jnp.asarray(batch.b),
                 jnp.asarray(batch.c), ub=jnp.asarray(batch.upper_bounds()),
                 telemetry=True)
    st, _ = (be.run_phase1 if stage == "p1" else be.run_phase2)(st, 2)
    rows0 = _ref_rows(st.tel)
    assert rows0[0].any()
    outs = revised_segment_pallas(
        jnp.int32(3), st.Abar, st.cvec, st.ub, st.thr, st.Binv, st.xB,
        st.basis, st.onub, st.phase, st.status, st.iters,
        jnp.asarray(rows0[0]), stage=stage, m=m, n=n, tile_b=1, tol=1e-6,
        K=K, interpret=True, pricing=rule)
    port = revised_state_from_tile(st, m=m, n=n)
    got, it = revised_segment_tile(port, 3, stage=stage, m=m, n=n,
                                   max_iters=200, refactor_period=K,
                                   rule=rule)
    np.testing.assert_array_equal(it.numpy(),
                                  np.asarray(outs[6]).reshape(-1))
    ints, f32s = (r.numpy() for r in tel_to_rows(got.tel))
    want = np.asarray(outs[7]).copy()
    refac = INT_LANES.index("refactorizations")
    want[:, refac] += (it.numpy() > 0)
    np.testing.assert_array_equal(ints, want)
    np.testing.assert_array_equal(f32s, rows0[1])
    assert (ints != rows0[0]).any()


def test_pdhg_segment_plain_rows_match_pdhg_segment_pallas():
    """One PDHG segment from a reference mid-solve state with counters:
    the int32 row (iterations, restarts) equals ``pdhg_segment_pallas``'s
    and the float32 row (the KKT triple, omega) agrees within XTOL, the
    port's budget against the reference's PDHG."""
    batch = random_lp_batch(np.random.default_rng(19), 3, 5, 5,
                            feasible_start=False)
    f32 = jnp.float32
    s0 = ref_pdhg.init_pdhg_state(jnp.asarray(batch.A, f32),
                                  jnp.asarray(batch.b, f32),
                                  jnp.asarray(batch.c, f32))
    s0 = s0._replace(tel=ref_init_telemetry(3))
    for _ in range(4):
        s0 = ref_pdhg.pdhg_round(s0, tol=1e-5)
    tile = build_pdhg_tile_state(s0, m=5, n=5, tile_b=1)
    rows0 = _ref_rows(tile.tel)
    assert rows0[0].any() and rows0[1].any()
    after, it_ref = pdhg_segment_pallas(6, tile, m=5, n=5, tile_b=1,
                                        tol=1e-5)
    state = pdhg_state_from_reference(tile, m=5, n=5, batch=3)
    got, it = pdhg_segment_tile(state, 6, m=5, n=5, max_rounds=10_000)
    np.testing.assert_array_equal(it.numpy(),
                                  np.asarray(it_ref).reshape(-1)[:3])
    ints, f32s = (r.numpy() for r in tel_to_rows(got.tel))
    want_i, want_f = _ref_rows(after.tel)
    np.testing.assert_array_equal(ints, want_i[:3])
    for lane, (g, w) in enumerate(zip(f32s.T, want_f[:3].T)):
        np.testing.assert_allclose(g, w, rtol=XTOL,
                                   atol=XTOL * np.abs(w).max(),
                                   err_msg=f"float lane {lane}")
    assert (ints != rows0[0][:3]).any()


# ---------------------------------------------------------------------------
# the kernel entry point's contract (CPU: the plain versions)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["tableau", "pdhg"])
def test_whole_solve_kernels_refuse_counters_without_compaction(backend):
    batch = port_random_batch(np.random.default_rng(3), 4, 3, 3)
    with pytest.raises(ValueError, match="compaction=True"):
        solve_batched_kernel(batch, device="cpu", backend=backend,
                             telemetry=True)
    got = solve_batched_kernel(batch, device="cpu", backend=backend,
                               compaction=True, telemetry=True)
    _assert_report_consistent(got)


def test_revised_kernel_path_counts_with_or_without_compaction():
    batch = _mixed_batch(np.random.default_rng(29), B=8)
    port = batch_from_reference(batch)
    whole = solve_batched_kernel(port, device="cpu", backend="revised",
                                 telemetry=True)
    _assert_lanes_equal(_assert_report_consistent(whole),
                        _port(batch, "revised", telemetry=True).stats)
    sched = solve_batched_kernel(port, device="cpu", backend="revised",
                                 compaction=True, telemetry=True,
                                 segment_k=3)
    _assert_report_consistent(sched)
    np.testing.assert_array_equal(sched.status, whole.status)


# ---------------------------------------------------------------------------
# on the card: every counter-carrying kernel against its plain version
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _clone(state):
    return map_state(torch.clone, state)


def _equal_states(got, want):
    for name, g, w in zip(type(want)._fields, got, want):
        if name == "tel" and w is None:
            assert g is None
        elif name == "tel":
            for lane, gl, wl in zip(ALL_LANES, g, w):
                torch.testing.assert_close(gl, wl, rtol=0, atol=0,
                                           equal_nan=True, msg=lane)
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                       msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("stage", ["p1", "p2"])
@pytest.mark.parametrize("pricing", ["dantzig", "devex", "steepest_edge"])
@pytest.mark.parametrize("m,n,B,in_smem", [(30, 24, 48, True),
                                           (100, 100, 48, True),
                                           (246, 159, 16, False)])
def test_simplex_counter_kernel_matches_plain_on_the_card(m, n, B, in_smem,
                                                          pricing, stage):
    """Both variants: the tableau in shared memory (30 x 24, 100 x 100) and
    in device memory (246 x 159, sc205_like's shape)."""
    dev = _card()
    assert tableau_in_smem(m, n, pricing, stage=stage) == in_smem
    batch = port_random_batch(np.random.default_rng(5), B, m, n,
                              feasible_start=False)
    be = TorchBackend(m, n, 1e-6, 1e-5, pricing=pricing)
    state = be.init(*batch_tensors(batch, dev), telemetry=True)
    state = segment_tile_plain(state, 5, stage="p1", m=m, n=n,
                               max_iters=2000, pricing=pricing)[0]
    if stage == "p2":
        while bool(segment_pending(state, "p1", 2000).any()):
            state = segment_tile_plain(state, 16, stage="p1", m=m, n=n,
                                       max_iters=2000, pricing=pricing)[0]
        state = be.compact_columns(state)
    kw = dict(stage=stage, m=m, n=n, max_iters=2000, pricing=pricing)
    before = segment_tile.launches
    got, it = segment_tile(_clone(state), 9, **kw)
    torch.cuda.synchronize()
    assert segment_tile.launches == before + 1
    want, want_it = segment_tile_plain(state, 9, **kw)
    torch.testing.assert_close(it, want_it, rtol=0, atol=0)
    _equal_states(got, want)


def _revised_counter_check(m, n, B, pricing, stage, counter_free=False):
    """One counter-carrying revised launch from a mid-solve state against
    the plain version; with ``counter_free``, also the counter-free launch,
    every leaf but the counters equal."""
    dev = _card()
    batch = port_random_batch(np.random.default_rng(6), B, m, n,
                              feasible_start=stage == "p2")
    be = RevisedBackend(m, n, 1e-6, 1e-5, pricing=pricing, refactor_period=5)
    state = be.init(*batch_tensors(batch, dev), telemetry=True)
    kw = dict(stage=stage, m=m, n=n, max_iters=2000, refactor_period=5,
              rule=pricing)
    state = revised_segment_tile_plain(state, 4, **kw)[0]
    before = revised_segment_tile.launches
    got, it = revised_segment_tile(_clone(state), 12, **kw)
    torch.cuda.synchronize()
    assert revised_segment_tile.launches == before + 1
    want, want_it = revised_segment_tile_plain(state, 12, **kw)
    torch.testing.assert_close(it, want_it, rtol=0, atol=0)
    _equal_states(got, want)
    if counter_free:
        free, free_it = revised_segment_tile(
            _clone(state)._replace(tel=None), 12, **kw)
        torch.testing.assert_close(free_it, it, rtol=0, atol=0)
        _equal_states(free, got._replace(tel=None))


@pytest.mark.gpu
@pytest.mark.parametrize("stage", ["p1", "p2"])
@pytest.mark.parametrize("pricing", ["dantzig", "partial"])
@pytest.mark.parametrize("m,n,B,variant", [(40, 30, 48, "shared"),
                                           (246, 159, 16, "device")])
def test_revised_counter_kernel_matches_plain_on_the_card(m, n, B, variant,
                                                          pricing, stage):
    """Both variants: A and the workspace in shared memory (40 x 30) and in
    device memory (246 x 159, sc205_like's shape)."""
    _card()
    assert revised_variant(m, n, tel=True) == variant
    _revised_counter_check(m, n, B, pricing, stage)


def _revised_slot_band_shape():
    """A shape whose shared layout fits the card's opt-in limit by fewer
    bytes than the counter slot takes: for each m, the largest n the
    counter-free launch runs in shared memory (a bisection: the layout
    grows with n), until the counter-carrying launch there runs in device
    memory."""
    for m in range(100, 200):
        lo, hi = 1, 4096
        if revised_variant(m, lo) != "shared":
            continue
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if revised_variant(m, mid) == "shared":
                lo = mid
            else:
                hi = mid
        if revised_variant(m, lo, tel=True) == "device":
            return m, lo
    raise AssertionError("no shape in the counter slot's band")


@pytest.mark.gpu
@pytest.mark.parametrize("stage", ["p1", "p2"])
def test_revised_counter_kernel_in_the_counter_slots_band(stage):
    """Where the counter slot tips the layout over the limit, the
    counter-carrying launch runs (and gets the workspace of) the device
    variant, the counter-free one the shared variant; both equal the
    plain version."""
    _card()
    m, n = _revised_slot_band_shape()
    assert revised_variant(m, n) == "shared"
    _revised_counter_check(m, n, 8, "dantzig", stage, counter_free=True)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,variant", [(20, 16, "registers"),
                                         (100, 100, "registers"),
                                         (150, 120, "shared"),
                                         (300, 300, "device")])
def test_pdhg_counter_kernel_matches_plain_on_the_card(m, n, variant):
    """Every variant: A in registers (20 x 16, 100 x 100), in shared memory
    (150 x 120) and in device memory (300 x 300)."""
    dev = _card()
    assert pdhg_variant(m, n) == variant
    batch = port_random_batch(np.random.default_rng(7), 24, m, n,
                              feasible_start=False)
    be = PdhgBackend(m, n)
    state = be.init(*batch_tensors(batch, dev), telemetry=True)
    state = pdhg_segment_tile_plain(state, 3, max_rounds=400)[0]
    before = pdhg_segment_tile.launches
    got, it = pdhg_segment_tile(_clone(state), 5, m=m, n=n, max_rounds=400)
    torch.cuda.synchronize()
    assert pdhg_segment_tile.launches == before + 1
    want, want_it = pdhg_segment_tile_plain(state, 5, max_rounds=400)
    torch.testing.assert_close(it, want_it, rtol=0, atol=0)
    _equal_states(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["tableau", "pdhg"])
def test_whole_solve_kernels_refuse_counters_on_the_card(backend):
    dev = _card()
    batch = port_random_batch(np.random.default_rng(8), 8, 6, 6)
    with pytest.raises(ValueError, match="compaction=True"):
        batching.solve_batched(batch, device=dev, backend=backend,
                               telemetry=True)
    got = batching.solve_batched(batch, device=dev, backend=backend,
                                 compaction=True, telemetry=True)
    assert isinstance(got.stats, SolveReport)
    np.testing.assert_array_equal(got.stats.iterations, got.iterations)
