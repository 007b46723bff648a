"""Package rules of the port (repro_torch) and its kernel on the card.

The port imports torch and numpy, never jax and nothing of the reference
package; its entry points run on CUDA unless asked for the CPU and never
fall back silently; the kernel wrapper takes the plain version only for CPU
tensors.  This file imports no JAX, so its ``gpu`` tests run on a machine
that has a card and no JAX (``python -m pytest -m gpu
tests/test_torch_package.py``).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import batching
from repro_torch.core.compaction import (CompactionState, TorchBackend,
                                         segment_pending,
                                         solve_batched_compacted)
from repro_torch.core.forms import canonicalize
from repro_torch.core.lp import (LPBatch, backend_spec, canonicalize_backend,
                                 resolve_backend)
from repro_torch.core.pdhg import (PdhgState, init_pdhg_state,
                                   solve_batched_pdhg,
                                   solve_batched_pdhg_compacted)
from repro_torch.core.sparse import SparseLPBatch, solve_batched_pdhg_sparse
from repro_torch.core.reference import random_lp_batch
from repro_torch.core.revised import (RevisedState, solve_batched_revised,
                                      solve_batched_revised_compacted,
                                      warm_state)
from repro_torch.core.simplex import batch_tensors, solve_batched_torch
from repro_torch.io import fixture_path, perturbed_batch, read_mps
from repro_torch.kernels import (_build, hyperbox_tile, hyperbox_tile_plain,
                                  pdhg_segment_tile, pdhg_segment_tile_plain,
                                  pdhg_tile, pdhg_tile_plain,
                                  revised_segment_tile,
                                  revised_segment_tile_plain, segment_tile,
                                  segment_tile_plain, simplex_tile,
                                  simplex_tile_plain)
from repro_torch.kernels.revised_tile import block_threads as revised_threads
from repro_torch.kernels.revised_tile import (smem_bytes as
                                              revised_smem_bytes)
from repro_torch.kernels.revised_tile import workspace_in_smem
from repro_torch.kernels.ops import (KernelBackend, solve_batched_kernel,
                                     solve_hyperbox_kernel)
from repro_torch.kernels.pdhg_tile import a_in_smem as pdhg_a_in_smem
from repro_torch.kernels.pdhg_tile import block_threads as pdhg_threads
from repro_torch.kernels.pdhg_tile import smem_bytes as pdhg_smem_bytes
from repro_torch.kernels.simplex_tile import (WORK_COUNTERS, block_threads,
                                              smem_bytes, tableau_in_smem)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _is_reference(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


def test_import_leaves_jax_and_the_reference_out():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels, "
            "repro_torch.io, repro_torch.interop\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"


def test_sources_never_import_jax_or_the_reference():
    offenders = []
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}: {n}" for n in names
                          if _is_reference(n)]
    assert not offenders


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = random_lp_batch(np.random.default_rng(0), B=2, m=3, n=3)
    for solve in (batching.solve_batched, solve_batched_torch,
                  solve_batched_kernel):
        with pytest.raises(RuntimeError, match="CUDA"):
            solve(batch)
    res = batching.solve_batched(batch, device="cpu")
    assert (res.status == 0).all()


def _small_inputs(seed=0, B=6, m=4, n=5):
    batch = random_lp_batch(np.random.default_rng(seed), B=B, m=m, n=n,
                            feasible_start=False)
    return batch_tensors(batch, torch.device("cpu")), m, n


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    (A, b, c, ub), m, n = _small_inputs()
    before = simplex_tile.launches
    got = simplex_tile(A, b, c, ub, m=m, n=n, max_iters=100)
    want = simplex_tile_plain(A, b, c, ub, m=m, n=n, max_iters=100)
    assert simplex_tile.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    (A, b, c, ub), m, n = _small_inputs()
    with pytest.raises(TypeError, match="float32"):
        simplex_tile(A.double(), b, c, ub, m=m, n=n, max_iters=10)
    with pytest.raises(ValueError, match="shape"):
        simplex_tile(A, b[:, :-1], c, ub, m=m, n=n, max_iters=10)
    with pytest.raises(ValueError, match="contiguous"):
        simplex_tile(A, b, c, ub.t().contiguous().t(), m=m, n=n,
                     max_iters=10)
    with pytest.raises(ValueError, match="prices with"):
        simplex_tile(A, b, c, ub, m=m, n=n, max_iters=10, pricing="partial")
    with pytest.raises(TypeError, match="int32"):
        simplex_tile(A, b, c, ub, m=m, n=n, max_iters=10,
                     work=torch.zeros((A.shape[0], WORK_COUNTERS)))
    with pytest.raises(ValueError, match="shape"):
        simplex_tile(A, b, c, ub, m=m, n=n, max_iters=10,
                     work=torch.zeros((A.shape[0], 2), dtype=torch.int32))


@pytest.mark.parametrize("pricing", ["dantzig", "devex", "steepest_edge"])
@pytest.mark.parametrize("feasible_start", [True, False])
def test_work_counts_add_up_to_the_iterations(pricing, feasible_start):
    rng = np.random.default_rng(7)
    batch = random_lp_batch(rng, B=12, m=6, n=7,
                            feasible_start=feasible_start)
    bounds = rng.uniform(0.05, 0.5, size=(12, 7))
    bounds[:, ::2] = np.inf
    batch = LPBatch.from_arrays(batch.A, batch.b, batch.c, ub=bounds)
    A, b, c, ub = batch_tensors(batch, torch.device("cpu"))
    work = torch.full((12, WORK_COUNTERS), -1, dtype=torch.int32)
    _, _, status, iters, _, _ = simplex_tile(
        A, b, c, ub, m=6, n=7, max_iters=200, pricing=pricing, work=work)
    assert (work >= 0).all()
    # the steps that move nothing: the switch to phase 2 and a final step
    # that finds no bounding row
    idle = iters - work.sum(dim=1)
    assert ((idle >= 0) & (idle <= 2)).all()
    if feasible_start:
        assert (work[:, 0] == 0).all()
    else:
        assert (work[:, 0] > 0).any()
    assert (work[:, 2] > 0).any()   # three columns in seven are bounded


def test_unported_backends_raise_and_unknown_names_are_rejected():
    """Every engine of the reference is ported: pdhg resolves and solves
    through each entry point (the same plain engine on the CPU, so the
    results are equal bit for bit); unknown names are still rejected."""
    assert resolve_backend("tableau") is solve_batched_torch
    assert resolve_backend("tableau", compacted=True) \
        is solve_batched_compacted
    assert resolve_backend("revised") is solve_batched_revised
    assert resolve_backend("revised", compacted=True) \
        is solve_batched_revised_compacted
    assert resolve_backend("pdhg") is solve_batched_pdhg
    assert resolve_backend("pdhg", compacted=True) \
        is solve_batched_pdhg_compacted
    assert not backend_spec("pdhg").exact
    small = random_lp_batch(np.random.default_rng(0), B=2, m=3, n=3)
    want = solve_batched_pdhg(small, device="cpu")
    assert (want.status == 0).all()
    for solve in (batching.solve_batched, solve_batched_kernel,
                  solve_batched_compacted,
                  lambda b, **kw: solve_batched_kernel(b, compaction=True,
                                                       **kw)):
        got = solve(small, device="cpu", backend="pdhg")
        for f in ("status", "iterations", "x", "objective", "y", "z"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    with pytest.raises(ValueError):
        canonicalize_backend("simplex")
    batch = random_lp_batch(np.random.default_rng(1), B=3, m=4, n=4)
    res = batching.solve_batched(batch, device="cpu", backend="revised")
    assert (res.status == 0).all()
    np.testing.assert_allclose(
        res.objective, solve_batched_torch(batch, device="cpu").objective,
        rtol=1e-5)


def test_partial_pricing_degrades_to_dantzig_with_a_warning():
    batch = random_lp_batch(np.random.default_rng(1), B=3, m=4, n=4)
    want = solve_batched_kernel(batch, device="cpu")
    with pytest.warns(UserWarning, match="partial"):
        got = solve_batched_kernel(batch, device="cpu", pricing="partial")
    np.testing.assert_array_equal(got.iterations, want.iterations)


SHAPES = [(100, 100, True), (27, 32, True), (246, 159, False),
          (300, 300, False)]


@pytest.mark.parametrize("m,n,fits", SHAPES)
def test_block_threads(m, n, fits):
    t = block_threads(m, n)
    assert t % 32 == 0 and 128 <= t <= 1024
    assert t * 32 >= min((m + 2) * (n + 2 * m + 1), 1024 * 32)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,fits", SHAPES)
def test_shared_memory_budget(m, n, fits):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and the built kernel")
    for rule in ("dantzig", "steepest_edge", "devex"):
        assert tableau_in_smem(m, n, rule) == fits
        tableau = 4 * (m + 2) * (n + 2 * m + 1)
        assert (smem_bytes(m, n, rule)
                - smem_bytes(m, n, rule, tableau=False)) == tableau
        assert smem_bytes(m, n, rule, tableau=False) < 64 * 1024


def test_kernel_build_is_lazy_and_lands_in_an_ignored_directory():
    lib = _build.library_path("simplex_tile")
    assert lib.parent == ROOT / "build" / "kernels"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert (_build.CSRC / "simplex_tile.cu").exists()
    code = ("import repro_torch.kernels\n"
            "print(repro_torch.kernels._build.load.cache_info().currsize)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "0"


def test_fixtures_are_the_shared_ones():
    path = Path(fixture_path("afiro"))
    assert path == ROOT / "tests" / "fixtures" / "afiro.mps"
    lp, _ = canonicalize(read_mps(str(path)))
    assert (lp.m, lp.n) == (35, 32)


@pytest.mark.gpu
@pytest.mark.parametrize("pricing", ["dantzig", "devex", "steepest_edge"])
def test_kernel_matches_plain_version_on_the_card(pricing):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    sc, _ = canonicalize(perturbed_batch(read_mps(fixture_path("sc205_like")),
                                         4, rng))
    batches = [random_lp_batch(rng, B=64, m=30, n=24, feasible_start=False),
               sc]
    for batch in batches:
        A, b, c, ub = batch_tensors(batch, dev)
        kw = dict(m=batch.m, n=batch.n, max_iters=10 * (batch.m + batch.n) + 50,
                  pricing=pricing)
        work = torch.zeros((batch.batch, WORK_COUNTERS), dtype=torch.int32,
                           device=dev)
        work_plain = torch.zeros_like(work)
        before = simplex_tile.launches
        got = simplex_tile(A, b, c, ub, work=work, **kw)
        torch.cuda.synchronize()
        assert simplex_tile.launches == before + 1
        want = simplex_tile_plain(A, b, c, ub, work=work_plain, **kw)
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
        torch.testing.assert_close(got[3], want[3], rtol=0, atol=0)
        torch.testing.assert_close(work, work_plain, rtol=0, atol=0)
        for i in (0, 1, 4, 5):   # x, objective, y, z
            torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=0,
                                       equal_nan=True)


def test_lp_batch_round_trips_through_interop():
    from repro_torch.interop import batch_from_reference, result_arrays
    batch = random_lp_batch(np.random.default_rng(2), B=3, m=2, n=2)
    again = batch_from_reference(batch)
    assert isinstance(again, LPBatch)
    np.testing.assert_array_equal(again.A, batch.A)
    res = result_arrays(solve_batched_torch(again, device="cpu"))
    assert set(res) == {"x", "objective", "status", "iterations", "y", "z"}


def test_new_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = random_lp_batch(np.random.default_rng(0), B=2, m=3, n=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_batched_compacted(batch)
    with pytest.raises(RuntimeError, match="CUDA"):
        batching.solve_batched(batch, compaction=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_batched_kernel(batch, compaction=True)
    box = np.zeros((2, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_hyperbox_kernel(box, box + 1, box)
    res = batching.solve_batched(batch, device="cpu", compaction=True)
    assert (res.status == 0).all()


def _segment_state(rule="dantzig", seed=0, B=6, m=4, n=5):
    (A, b, c, ub), m, n = _small_inputs(seed, B, m, n)
    return TorchBackend(m, n, 1e-6, 1e-5, pricing=rule).init(A, b, c, ub), m, n


@pytest.mark.parametrize("stage", ["p1", "p2"])
def test_segment_on_cpu_tensors_is_the_plain_version_with_no_launch(stage):
    state, m, n = _segment_state("devex")
    if stage == "p2":
        be = TorchBackend(m, n, 1e-6, 1e-5, pricing="devex")
        # the phase-1 LPs are out of stage p2, as stage p1's end leaves them
        state = be.compact_columns(
            be.deactivate(state, be.phase_host(state) != 1))
    before = segment_tile.launches
    got, it = segment_tile(state, 3, stage=stage, m=m, n=n, max_iters=100,
                           pricing="devex")
    want, want_it = segment_tile_plain(state, 3, stage=stage, m=m, n=n,
                                       max_iters=100, pricing="devex")
    assert segment_tile.launches == before
    torch.testing.assert_close(it, want_it, rtol=0, atol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_segment_wrapper_rejects_what_the_kernel_does_not_take():
    state, m, n = _segment_state()
    kw = dict(stage="p1", m=m, n=n, max_iters=10)
    with pytest.raises(ValueError, match="stage"):
        segment_tile(state, 2, **dict(kw, stage="p3"))
    with pytest.raises(ValueError, match="prices with"):
        segment_tile(state, 2, pricing="partial", **kw)
    with pytest.raises(ValueError, match="shape"):   # a p2 tableau in p1
        segment_tile(state, 2, **dict(kw, stage="p2"))
    bad = {"T": state.T.double(), "flip": state.flip.to(torch.int32),
           "iters": state.iters.to(torch.int64),
           "thr": state.thr.double()}
    for leaf, value in bad.items():
        with pytest.raises(TypeError, match=leaf):
            segment_tile(state._replace(**{leaf: value}), 2, **kw)
    with pytest.raises(ValueError, match="basis has shape"):
        segment_tile(state._replace(basis=state.basis[:, :-1]), 2, **kw)
    devex = _segment_state("devex")[0]
    with pytest.raises(ValueError, match="w has shape"):
        segment_tile(devex._replace(w=devex.w[:, :-1].contiguous()), 2,
                     pricing="devex", **kw)
    with pytest.raises(ValueError, match="contiguous"):
        segment_tile(state._replace(
            ub=state.ub.t().contiguous().t()), 2, **kw)


def test_segment_marks_an_lp_at_its_cap():
    state, m, n = _segment_state(B=8, m=6, n=6)
    got, it = segment_tile(state, 50, stage="p1", m=m, n=n, max_iters=1)
    assert (it <= 1).all()
    in_p1 = got.phase == 1
    assert in_p1.any()
    assert (got.status[in_p1] == 3).all()     # ITERATION_LIMIT
    assert (got.status[~in_p1] == -1).all()   # parked for stage p2


def test_hyperbox_wrapper_rejects_what_the_kernel_does_not_take():
    lo = torch.zeros((4, 3))
    hi = torch.ones((4, 3))
    with pytest.raises(TypeError, match="float32"):
        hyperbox_tile(lo.double(), hi, hi)
    with pytest.raises(ValueError, match="hi has shape"):
        hyperbox_tile(lo, hi[:3], hi)
    with pytest.raises(ValueError, match="entries"):
        hyperbox_tile(lo, hi, torch.ones((2, 4)))
    with pytest.raises(ValueError, match="2-D"):
        hyperbox_tile(lo, hi, torch.ones(3))
    with pytest.raises(ValueError, match="contiguous"):
        hyperbox_tile(lo, hi, torch.ones((3, 2)).t())


def test_new_kernel_sources_are_built_with_the_others():
    assert "hyperbox" in _build.SOURCES
    assert (_build.CSRC / "hyperbox.cu").exists()
    text = (_build.CSRC / "simplex_tile.cu").read_text()
    assert "simplex_segment_launch" in text


def _clone(state):
    return CompactionState(*(leaf.clone() for leaf in state))


@pytest.mark.gpu
@pytest.mark.parametrize("pricing", ["dantzig", "devex", "steepest_edge"])
def test_segment_kernel_matches_plain_version_on_the_card(pricing):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    sc, _ = canonicalize(perturbed_batch(read_mps(fixture_path("sc205_like")),
                                         4, rng))
    for batch in (random_lp_batch(rng, B=64, m=30, n=24,
                                  feasible_start=False), sc):
        m, n = batch.m, batch.n
        be = TorchBackend(m, n, 1e-6, 1e-5, pricing=pricing)
        state = be.init(*batch_tensors(batch, dev))
        for stage in ("p1", "p2"):
            if stage == "p2":   # finish stage p1 within 60 steps first
                while bool(segment_pending(state, "p1", 60).any()):
                    state = segment_tile_plain(state, 8, stage="p1", m=m,
                                               n=n, max_iters=60,
                                               pricing=pricing)[0]
                state = be.compact_columns(state)
            kw = dict(stage=stage, m=m, n=n, max_iters=10 * (m + n) + 50,
                      pricing=pricing)
            before = segment_tile.launches
            got, it = segment_tile(_clone(state), 7, **kw)
            torch.cuda.synchronize()
            assert segment_tile.launches == before + 1
            want, want_it = segment_tile_plain(state, 7, **kw)
            torch.testing.assert_close(it, want_it, rtol=0, atol=0)
            for name, g, w in zip(CompactionState._fields, got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0,
                                           equal_nan=True, msg=name)
            state = want


@pytest.mark.gpu
def test_scheduled_kernel_solve_matches_the_plain_scheduler_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    batch = random_lp_batch(np.random.default_rng(6), B=96, m=20, n=16,
                            feasible_start=False)
    for pricing in ("dantzig", "steepest_edge"):
        kw = dict(device="cuda", segment_k=5, pricing=pricing)
        before = segment_tile.launches
        got = solve_batched_kernel(batch, compaction=True, **kw)
        assert segment_tile.launches > before
        want = solve_batched_compacted(batch, **kw)
        for f in ("status", "iterations", "x", "objective", "y", "z"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)


@pytest.mark.gpu
def test_hyperbox_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(8)
    for n in (1, 5, 33, 130):
        lo = torch.tensor(rng.uniform(-4, 0, (1000, n)), dtype=torch.float32,
                          device="cuda")
        hi = lo + torch.tensor(rng.uniform(0.1, 3, (1000, n)),
                               dtype=torch.float32, device="cuda")
        for rows in (1000, 7):
            d = torch.tensor(rng.normal(size=(rows, n)), dtype=torch.float32,
                             device="cuda")
            before = hyperbox_tile.launches
            got = hyperbox_tile(lo, hi, d)
            torch.cuda.synchronize()
            assert hyperbox_tile.launches == before + 1
            torch.testing.assert_close(got, hyperbox_tile_plain(lo, hi, d),
                                       rtol=0, atol=0)


def test_revised_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = random_lp_batch(np.random.default_rng(0), B=2, m=3, n=3)
    for solve in (solve_batched_revised, solve_batched_revised_compacted):
        with pytest.raises(RuntimeError, match="CUDA"):
            solve(batch)
    with pytest.raises(RuntimeError, match="CUDA"):
        batching.solve_batched(batch, backend="revised")
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_batched_kernel(batch, backend="revised")


def _revised_state(seed=0, B=6, m=4, n=5, device="cpu"):
    (A, b, c, ub), m, n = _small_inputs(seed, B, m, n)
    state = warm_state(A, b, c, ub, m=m, n=n, feas_tol=1e-5)
    return RevisedState(*(leaf.to(device) for leaf in state)), m, n


def test_revised_wrapper_rejects_what_the_kernel_does_not_take():
    state, m, n = _revised_state()
    kw = dict(stage="p2", m=m, n=n, max_iters=10, refactor_period=2)
    with pytest.raises(ValueError, match="stage"):
        revised_segment_tile(state, 2, **dict(kw, stage="p3"))
    with pytest.raises(ValueError, match="tableau-only"):
        revised_segment_tile(state, 2, rule="devex", **kw)
    bad = {"Abar": state.Abar.double(), "onub": state.onub.to(torch.int32),
           "iters": state.iters.to(torch.int64), "work": state.work.float()}
    for leaf, value in bad.items():
        with pytest.raises(TypeError, match=leaf):
            revised_segment_tile(state._replace(**{leaf: value}), 2, **kw)
    with pytest.raises(ValueError, match="Abar has shape"):
        revised_segment_tile(state._replace(Abar=state.Abar[:, :, :-1]), 2,
                             **kw)
    with pytest.raises(ValueError, match="contiguous"):
        revised_segment_tile(state._replace(
            xB=state.xB.t().contiguous().t()), 2, **kw)


def test_revised_kernel_source_is_built_with_the_others():
    assert "revised_tile" in _build.SOURCES
    text = (_build.CSRC / "revised_tile.cu").read_text()
    assert "revised_segment_launch" in text
    assert "_revised_segment_kernel" in text   # names what it replaces
    for m, n in ((100, 100), (35, 32), (246, 159)):
        t = revised_threads(m, n)
        assert t % 32 == 0 and 256 <= t <= 1024 and t >= min(n + m, 1024)


@pytest.mark.gpu
def test_revised_workspace_budget():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and the built kernel")
    assert workspace_in_smem(100, 100)
    assert workspace_in_smem(35, 32)
    assert not workspace_in_smem(246, 159)
    for m, n in ((100, 100), (246, 159)):
        assert (revised_smem_bytes(m, n)
                - revised_smem_bytes(m, n, workspace=False)) \
            == 4 * 2 * m * m


@pytest.mark.gpu
@pytest.mark.parametrize("pricing", ["dantzig", "partial"])
def test_revised_kernel_matches_plain_version_on_the_card(pricing):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    sc, _ = canonicalize(perturbed_batch(read_mps(fixture_path("sc205_like")),
                                         3, rng))
    for batch in (random_lp_batch(rng, B=64, m=30, n=24,
                                  feasible_start=False), sc):
        m, n = batch.m, batch.n
        A, b, c, ub = batch_tensors(batch, dev)
        state = warm_state(A, b, c, ub, m=m, n=n, feas_tol=1e-5)
        for stage in ("p1", "p2"):
            kw = dict(stage=stage, m=m, n=n, max_iters=10 * (m + n) + 50,
                      refactor_period=5, rule=pricing)
            before = revised_segment_tile.launches
            got, it = revised_segment_tile(
                RevisedState(*(leaf.clone() for leaf in state)), 23, **kw)
            torch.cuda.synchronize()
            assert revised_segment_tile.launches == before + 1
            want, want_it = revised_segment_tile_plain(state, 23, **kw)
            torch.testing.assert_close(it, want_it, rtol=0, atol=0)
            for name, g, w in zip(RevisedState._fields, got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0,
                                           equal_nan=True, msg=name)
            state = want


@pytest.mark.gpu
def test_revised_warm_resolve_takes_no_pivots_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    batch = random_lp_batch(np.random.default_rng(6), B=200, m=20, n=16,
                            feasible_start=False)
    before = revised_segment_tile.launches
    cold = solve_batched_kernel(batch, device="cuda", backend="revised")
    warm = solve_batched_kernel(batch, device="cuda", backend="revised",
                                warm=cold.warm_start())
    assert revised_segment_tile.launches == before + 2
    opt = cold.status == 0
    assert opt.all() and (cold.iterations > 0).all()
    assert (warm.iterations[opt] == 0).all()
    np.testing.assert_array_equal(warm.status, cold.status)
    np.testing.assert_allclose(warm.objective, cold.objective, rtol=1e-5)
    plain = solve_batched_revised(batch, device="cuda")
    for f in ("status", "iterations", "x", "objective", "y", "z"):
        np.testing.assert_array_equal(getattr(cold, f), getattr(plain, f))


# ---- restarted PDHG (csrc/pdhg_tile.cu) -------------------------------------

def test_pdhg_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = random_lp_batch(np.random.default_rng(0), B=2, m=3, n=3)
    for solve in (solve_batched_pdhg, solve_batched_pdhg_compacted,
                  lambda b: batching.solve_batched(b, backend="pdhg"),
                  lambda b: solve_batched_kernel(b, backend="pdhg"),
                  lambda b: solve_batched_pdhg_sparse(
                      SparseLPBatch.from_dense(b))):
        with pytest.raises(RuntimeError, match="CUDA"):
            solve(batch)


def _pdhg_state(seed=0, B=6, m=4, n=5, device="cpu"):
    (A, b, c, ub), m, n = _small_inputs(seed, B, m, n)
    state = init_pdhg_state(A, b, c, ub)
    return PdhgState(*(leaf.to(device) for leaf in state)), (A, b, c, ub), \
        m, n


@pytest.mark.parametrize("rule", ["fixed", "malitsky_pock"])
def test_pdhg_cpu_tensors_take_the_plain_version_and_count_no_launch(rule):
    _, (A, b, c, ub), m, n = _pdhg_state()
    before = pdhg_tile.launches
    got = pdhg_tile(A, b, c, ub, m=m, n=n, max_iters=2000, step_rule=rule)
    want = pdhg_tile_plain(A, b, c, ub, m=m, n=n, max_iters=2000,
                           step_rule=rule)
    assert pdhg_tile.launches == before
    assert len(got) == 10
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def test_pdhg_segment_on_cpu_tensors_is_the_plain_version_with_no_launch():
    state, _, m, n = _pdhg_state(seed=1)
    before = pdhg_segment_tile.launches
    got, it = pdhg_segment_tile(state, 5, m=m, n=n, max_rounds=100)
    want, want_it = pdhg_segment_tile_plain(state, 5, max_rounds=100)
    assert pdhg_segment_tile.launches == before
    torch.testing.assert_close(it, want_it, rtol=0, atol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def test_pdhg_wrapper_rejects_what_the_kernel_does_not_take():
    state, (A, b, c, ub), m, n = _pdhg_state()
    kw = dict(m=m, n=n, max_rounds=10)
    bad = {"A": state.A.double(), "status": state.status.to(torch.int64),
           "cnt": state.cnt.double()}
    for leaf, value in bad.items():
        with pytest.raises(TypeError, match=leaf):
            pdhg_segment_tile(state._replace(**{leaf: value}), 2, **kw)
    with pytest.raises(ValueError, match="eta has shape"):
        pdhg_segment_tile(state._replace(eta=state.eta[:, 0]), 2, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        pdhg_segment_tile(state._replace(x=state.x.t().contiguous().t()), 2,
                          **kw)
    with pytest.raises(ValueError, match="step_rule"):
        pdhg_tile(A, b, c, ub, m=m, n=n, max_iters=10, step_rule="armijo")


def test_pdhg_kernel_source_is_built_with_the_others():
    assert "pdhg_tile" in _build.SOURCES
    text = (_build.CSRC / "pdhg_tile.cu").read_text()
    assert "pdhg_launch" in text
    for name in ("_pdhg_kernel", "_pdhg_segment_kernel"):  # what it replaces
        assert name in text
    for m, n in ((100, 100), (35, 32), (246, 159), (300, 300)):
        assert pdhg_threads(m, n) in (128, 256)


@pytest.mark.gpu
def test_pdhg_shared_memory_budget():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and the built kernel")
    assert pdhg_a_in_smem(100, 100) and pdhg_a_in_smem(35, 32)
    assert pdhg_a_in_smem(246, 159)
    assert not pdhg_a_in_smem(300, 300)
    assert not pdhg_a_in_smem(300, 40)   # fits, but more than 256 rows
    for m, n in ((100, 100), (246, 159)):
        assert (pdhg_smem_bytes(m, n) - pdhg_smem_bytes(m, n, a_smem=False)) \
            == 4 * m * (n | 1)


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["fixed", "malitsky_pock"])
def test_pdhg_kernel_matches_plain_version_on_the_card(rule):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    sc, _ = canonicalize(perturbed_batch(read_mps(fixture_path("sc205_like")),
                                         3, rng))
    for batch, cap in ((random_lp_batch(rng, B=64, m=30, n=24,
                                        feasible_start=False), 4000),
                       (sc, 320)):
        m, n = batch.m, batch.n
        A, b, c, ub = batch_tensors(batch, dev)
        before = pdhg_tile.launches
        got = pdhg_tile(A, b, c, ub, m=m, n=n, max_iters=cap, step_rule=rule)
        torch.cuda.synchronize()
        assert pdhg_tile.launches == before + 1
        want = pdhg_tile_plain(A, b, c, ub, m=m, n=n, max_iters=cap,
                               step_rule=rule)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
def test_pdhg_segment_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    state, _, m, n = _pdhg_state(seed=2, B=64, m=30, n=24,
                                 device=torch.device("cuda"))
    for _ in range(3):
        before = pdhg_segment_tile.launches
        got, it = pdhg_segment_tile(PdhgState(*(t.clone() for t in state)),
                                    7, m=m, n=n, max_rounds=40)
        torch.cuda.synchronize()
        assert pdhg_segment_tile.launches == before + 1
        want, want_it = pdhg_segment_tile_plain(state, 7, max_rounds=40)
        torch.testing.assert_close(it, want_it, rtol=0, atol=0)
        for name, g, w in zip(PdhgState._fields, got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                       msg=name)
        state = want


@pytest.mark.gpu
def test_pdhg_compaction_equals_the_whole_solve_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    batch = random_lp_batch(np.random.default_rng(6), B=200, m=20, n=16,
                            feasible_start=False)
    before = (pdhg_tile.launches, pdhg_segment_tile.launches)
    whole = solve_batched_kernel(batch, device="cuda", backend="pdhg")
    sched = solve_batched_kernel(batch, device="cuda", backend="pdhg",
                                 compaction=True, segment_k=5)
    assert pdhg_tile.launches == before[0] + 1
    assert pdhg_segment_tile.launches > before[1]
    plain = solve_batched_pdhg(batch, device="cuda")
    for f in ("status", "iterations", "x", "objective", "y", "z"):
        np.testing.assert_array_equal(getattr(sched, f), getattr(whole, f))
        np.testing.assert_array_equal(getattr(plain, f), getattr(whole, f))
    warm = solve_batched_kernel(batch, device="cuda", backend="pdhg",
                                warm=whole.warm_start())
    assert warm.iterations.mean() <= 0.25 * whole.iterations.mean()
    np.testing.assert_array_equal(warm.status, whole.status)
