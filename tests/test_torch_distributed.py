"""The port's solvers over a ``torch.distributed`` world
(``repro_torch.core.distributed``) on the CPU.

One gloo world of two ranks (two processes, a file store) runs every case
at once, to keep the suite fast: for each backend, ``solve_pjit``, the
one-shot ``solve_shard_map`` and ``solve_shard_map(segment_k=4)`` on an
uneven batch (37 LPs, padded to 38), bit-equal on every rank to the
single-device solvers of the port (``solve_batched(device="cpu")``; for the
segmented revised engine, whose segments start from a fresh factorization,
``solve_batched(compaction=True, segment_k=4)``, held to the whole solve
by statuses and objectives to 1e-3), the segment ladders' buckets
multiples of two and equal to one process driving the same schedule; a
general-form batch; telemetry through the segmented solve; ``lower_only``
raising.  The reference's ``solve_pjit`` and ``solve_shard_map`` (one-shot
and ``segment_k=4``) run on the same batches on a 2-device mesh, in a
subprocess as tests/test_distributed.py does: their statuses and
iterations equal the two-rank world's, x and objective too for the
tableau engine, and within the port's stated contracts with the reference
for revised (1e-4) and PDHG (1e-3).  The segment ladder is equal for PDHG
and in stage p1 for the simplex engines.  In stage p2 the
simplex engines' rows differ by design (ROADMAP queue 3): the reference's
stage p1 also steps LPs already in phase 2, on each shard while any of its
LPs is in phase 1, and the port's parks them; with no LP in phase 1 the
ladders are equal.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import random_lp_batch, solve_batched
from repro_torch.core.compaction import SegmentStat, TorchBackend, run_schedule
from repro_torch.core.distributed import (LOWER_ONLY, ShardedBackend, World,
                                          _pad_batch, solve_pjit,
                                          solve_shard_map)
from repro_torch.core.simplex import batch_tensors
from repro_torch.io import fixture_path, perturbed_batch, read_mps

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIELDS = ("status", "iterations", "x", "objective", "y", "z")
BACKENDS = ("tableau", "revised", "pdhg")
K = 4


def _batch(feasible_start=False):
    return random_lp_batch(np.random.default_rng(2), B=37, m=12, n=8,
                           feasible_start=feasible_start)


def _general():
    return perturbed_batch(read_mps(fixture_path("afiro")), 5,
                           np.random.default_rng(4))


RANK = textwrap.dedent("""
    import pickle, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    import test_torch_distributed as t
    from repro_torch.core.distributed import solve_pjit, solve_shard_map
    from repro_torch.obs import SpanTracer

    def keep(res, stats=None):
        got = {f: getattr(res, f) for f in t.FIELDS}
        if stats is not None:
            got["ladder"] = [(s.stage, s.bucket, s.steps, s.survivors,
                              s.elements) for s in stats]
        if res.stats is not None:
            got["counters"] = dict(res.stats.counters)
        return got

    cpu = dict(device="cpu")
    done = {}
    for backend in t.BACKENDS:
        b = t._batch()
        stats = []
        done[backend, "pjit"] = keep(solve_pjit(b, backend=backend, **cpu))
        done[backend, "one-shot"] = keep(solve_shard_map(b, backend=backend,
                                                         **cpu))
        done[backend, "segment_k"] = keep(solve_shard_map(
            b, backend=backend, segment_k=t.K, stats_out=stats, **cpu),
            stats)
    stats = []
    done["general", "pjit"] = keep(solve_pjit(t._general(), **cpu))
    done["general", "segment_k"] = keep(solve_shard_map(
        t._general(), segment_k=t.K, stats_out=stats, **cpu), stats)
    stats = []
    done["feasible", "segment_k"] = keep(solve_shard_map(
        t._batch(feasible_start=True), segment_k=t.K, stats_out=stats,
        **cpu), stats)
    tracer = SpanTracer()
    done["telemetry", "segment_k"] = keep(solve_shard_map(
        t._batch(), segment_k=t.K, telemetry=True, tracer=tracer, **cpu))
    done["telemetry", "spans"] = len(tracer.roots)
    try:
        solve_shard_map(t._batch(), lower_only=True, **cpu)
    except NotImplementedError as e:
        done["lower_only"] = str(e)
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(done, f)
    dist.barrier()
    dist.destroy_process_group()
""")

REFERENCE = textwrap.dedent("""
    import pickle, sys
    import numpy as np
    from repro.core import random_lp_batch, solve_pjit, solve_shard_map
    from repro.distributed.sharding import make_mesh
    mesh = make_mesh((2,), ("data",))

    def keep(res, stats=None):
        got = {f: np.asarray(getattr(res, f))
               for f in ("status", "iterations", "x", "objective")}
        if stats is not None:
            got["ladder"] = [(s.stage, s.bucket, s.steps, s.survivors)
                             for s in stats]
        return got

    def batch(feasible_start=False):
        return random_lp_batch(np.random.default_rng(2), B=37, m=12, n=8,
                               feasible_start=feasible_start)

    out = {}
    for backend in ("tableau", "revised", "pdhg"):
        stats = []
        out[backend, "pjit"] = keep(solve_pjit(batch(), mesh,
                                               backend=backend))
        out[backend, "one-shot"] = keep(solve_shard_map(batch(), mesh,
                                                        backend=backend))
        out[backend, "segment_k"] = keep(solve_shard_map(
            batch(), mesh, segment_k=4, stats_out=stats, backend=backend),
            stats)
    stats = []
    out["feasible", "segment_k"] = keep(solve_shard_map(
        batch(feasible_start=True), mesh, segment_k=4, stats_out=stats),
        stats)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")

# The reference's results against the two-rank world's: statuses and
# iterations equal; x and objective equal for the tableau engine, and
# within the port's stated contracts with the reference where the engines
# round differently (tests/test_torch_revised.py: rtol = atol = 1e-4, a
# dense inverse against LU factors; tests/test_torch_pdhg.py: XTOL 1e-3,
# the fixed sum order against XLA's)
REF_TOL = {"tableau": 0.0, "revised": 1e-4, "pdhg": 1e-3}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The two-rank gloo world's results (rank 0's) and the reference's
    results and ladders on a 2-device mesh, run side by side."""
    tmp = tmp_path_factory.mktemp("world")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.dirname(__file__)]),
        OMP_NUM_THREADS="1")
    ref_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=2")
    ref_out = tmp / "reference.pkl"
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(ref_out)],
                           env=ref_env, cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    out = tmp / "rank0.pkl"
    ranks = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), "2", str(tmp / "store"),
         str(out)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    logs = [p.communicate(timeout=600) for p in ranks]
    _, ref_err = ref.communicate(timeout=600)
    for p, (so, se) in zip(ranks, logs):
        assert p.returncode == 0, f"STDOUT:\n{so}\nSTDERR:\n{se[-4000:]}"
    assert ref.returncode == 0, ref_err[-4000:]
    with open(out, "rb") as f, open(ref_out, "rb") as g:
        return pickle.load(f), pickle.load(g)


def _equal(got, want, fields=FIELDS):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(got[f]),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["pjit", "one-shot"])
def test_two_ranks_solve_whole_as_one_device(worlds, backend, mode):
    got, _ = worlds
    _equal(got[backend, mode],
           solve_batched(_batch(), device="cpu", backend=backend))


@pytest.mark.parametrize("backend", BACKENDS)
def test_two_ranks_segmented_as_one_device(worlds, backend):
    got = worlds[0][backend, "segment_k"]
    whole = solve_batched(_batch(), device="cpu", backend=backend)
    scheduled = solve_batched(_batch(), device="cpu", backend=backend,
                              compaction=True, segment_k=K)
    _equal(got, scheduled)
    if backend == "revised":   # a fresh factorization every segment
        np.testing.assert_array_equal(got["status"], whole.status)
        ok = whole.status == 0
        np.testing.assert_allclose(got["objective"][ok],
                                   whole.objective[ok], rtol=1e-3)
    else:
        _equal(got, whole)
    assert all(b % 2 == 0 for _, b, *_ in got["ladder"])


def _one_process_ladder(backend_cls, batch, world_size, **kw):
    """The schedule one process drives with buckets padded to
    ``world_size``: what a world of that size must record."""
    padded, B = _pad_batch(batch, world_size)
    runner = backend_cls(batch.m, batch.n, 1e-6, 1e-5, **kw)
    sharded = ShardedBackend(runner, World(device="cpu"))
    sharded.pad_multiple = world_size
    state = runner.init(*batch_tensors(padded, torch.device("cpu")))
    orig = np.where(np.arange(padded.batch) < B, np.arange(padded.batch), -1)
    state = sharded.deactivate(state, orig >= 0)
    stats = []
    run_schedule(sharded, state, segment_k=K, stats_out=stats, orig=orig)
    return [(s.stage, s.bucket, s.steps, s.survivors, s.elements)
            for s in stats]


def test_ladder_is_the_one_process_schedule_padded_to_the_world(worlds):
    got, _ = worlds
    assert [tuple(r) for r in got["tableau", "segment_k"]["ladder"]] == \
        _one_process_ladder(TorchBackend, _batch(), 2)


def test_ladder_against_the_reference_two_device_mesh(worlds):
    got, ref = worlds
    for backend in BACKENDS:
        ours = [tuple(r[:4]) for r in got[backend, "segment_k"]["ladder"]]
        theirs = [tuple(r) for r in ref[backend, "segment_k"]["ladder"]]
        if backend == "pdhg":
            assert ours == theirs
            continue
        # stage p1 equal; stage p2 differs by the phase-2 steps the
        # reference takes inside stage p1 (module docstring)
        p1 = [r for r in ours if r[0] == "p1"]
        assert p1 == [r for r in theirs if r[0] == "p1"] and p1
        assert ours != theirs
        p2_ours = [r for r in ours if r[0] == "p2"]
        p2_ref = [r for r in theirs if r[0] == "p2"]
        assert p2_ours[0][3] >= p2_ref[0][3]   # the reference is ahead
    feasible = [tuple(r[:4]) for r in got["feasible", "segment_k"]["ladder"]]
    assert feasible == [tuple(r) for r in ref["feasible", "segment_k"]
                        ["ladder"]]
    assert all(r[0] == "p2" for r in feasible)


@pytest.mark.parametrize("case", [(b, m) for b in BACKENDS
                                  for m in ("pjit", "one-shot", "segment_k")]
                         + [("feasible", "segment_k")], ids=str)
def test_results_against_the_reference_two_device_mesh(worlds, case):
    """The two-rank world's results against the reference's solver of the
    same name on a 2-device mesh (REF_TOL), also in segment_k mode, where
    the simplex engines' ladders differ."""
    got, ref = worlds
    ours, theirs = got[case], ref[case]
    np.testing.assert_array_equal(ours["status"], theirs["status"])
    np.testing.assert_array_equal(ours["iterations"], theirs["iterations"])
    tol = REF_TOL.get(case[0], 0.0)
    for f in ("x", "objective"):
        np.testing.assert_allclose(ours[f], theirs[f], rtol=tol, atol=tol,
                                   equal_nan=True, err_msg=f"{case} {f}")
    assert (theirs["status"] == 0).all()


def test_general_form_input_is_canonicalized_once_and_recovered(worlds):
    got, _ = worlds
    g = _general()
    whole = solve_batched(g, device="cpu")
    _equal(got["general", "pjit"], whole)
    _equal(got["general", "segment_k"], whole)
    assert (whole.status == 0).all()
    np.testing.assert_allclose(got["general", "pjit"]["objective"][0],
                               -464.7531428571429, rtol=1e-4)
    assert all(b % 2 == 0 for _, b, *_ in got["general", "segment_k"]
               ["ladder"])


def test_telemetry_and_tracer_pass_through(worlds):
    got, _ = worlds
    want = solve_batched(_batch(), device="cpu", compaction=True,
                         segment_k=K, telemetry=True)
    res = got["telemetry", "segment_k"]
    _equal(res, want)
    for lane, vals in want.stats.counters.items():
        np.testing.assert_array_equal(res["counters"][lane], vals,
                                      err_msg=lane)
    assert got["telemetry", "spans"] > 0


def test_lower_only_raises(worlds):
    assert worlds[0]["lower_only"] == LOWER_ONLY
    with pytest.raises(NotImplementedError, match="no torch meaning"):
        solve_pjit(_batch(), device="cpu", lower_only=True)


def test_without_an_initialised_world_group_none_is_one_rank():
    import torch.distributed as dist
    assert not dist.is_initialized()
    world = World(device="cpu")
    assert (world.size, world.rank, world.via) == (1, 0, None)
    stats = []
    res = solve_shard_map(_batch(), segment_k=K, stats_out=stats,
                          device="cpu")
    _equal({f: getattr(res, f) for f in FIELDS},
           solve_batched(_batch(), device="cpu"))
    assert stats and all(isinstance(s, SegmentStat) for s in stats)
    with pytest.raises(ValueError, match="not initialised"):
        solve_pjit(_batch(), group=object(), device="cpu")
    with pytest.raises(ValueError, match="stats_out requires segment_k"):
        solve_shard_map(_batch(), device="cpu", stats_out=[])


def test_without_a_card_the_solvers_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for solve in (solve_pjit, solve_shard_map):
        with pytest.raises(RuntimeError, match="CUDA"):
            solve(_batch())
