"""Package rules of the port (repro_torch) and its kernel on the card.

The port imports torch and numpy, never jax and nothing of the reference
package; its entry points run on CUDA unless asked for the CPU and never
fall back silently; the kernel wrapper takes the plain version only for CPU
tensors.  This file imports no JAX, so its ``gpu`` tests run on a machine
that has a card and no JAX (``python -m pytest -m gpu
tests/test_torch_package.py``).
"""
import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import batching
from repro_torch.core.compaction import (CompactionState, TorchBackend,
                                         map_state, segment_pending,
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
from repro_torch.kernels.revised_tile import variant as revised_variant
from repro_torch.kernels.revised_tile import (workspace_floats as
                                              revised_workspace_floats)
from repro_torch.kernels.ops import (KernelBackend, solve_batched_kernel,
                                     solve_hyperbox_kernel)
from repro_torch.kernels.pdhg_tile import variant as pdhg_variant
from repro_torch.kernels.pdhg_tile import block_threads as pdhg_threads
from repro_torch.kernels.pdhg_tile import smem_bytes as pdhg_smem_bytes
from repro_torch.kernels.simplex_tile import (MAX_THREADS, WORK_COUNTERS,
                                              block_threads, smem_bytes,
                                              tableau_in_smem)
from repro_torch.configs import get_config
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bt_ds, \
    ssm_scan_bwd, ssm_scan_bwd_plain, ssm_scan_plain
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _is_reference(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


def test_import_leaves_jax_and_the_reference_out():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels, "
            "repro_torch.io, repro_torch.interop, repro_torch.models, "
            "repro_torch.configs, repro_torch.configs.falcon_mamba_7b, "
            "repro_torch.configs.hymba_1_5b, repro_torch.models.attention, "
            "repro_torch.launch, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.optim, "
            "repro_torch.distributed, repro_torch.data, repro_torch.obs, "
            "repro_torch.obs.work, repro_torch.core.branch_bound, "
            "repro_torch.analysis.lp_perf, repro_torch.configs.paper_lp, "
            "repro_torch.core.distributed, repro_torch.core.lp_router, "
            "repro_torch.models.moe, repro_torch.configs.qwen3_32b, "
            "repro_torch.configs.granite_20b, "
            "repro_torch.configs.nemotron_4_340b, "
            "repro_torch.configs.llama3_405b, "
            "repro_torch.configs.llama4_scout_17b_a16e, "
            "repro_torch.models.mla, repro_torch.models.encdec, "
            "repro_torch.configs.deepseek_v2_236b, "
            "repro_torch.configs.whisper_small, "
            "repro_torch.configs.phi_3_vision_4_2b, "
            "repro_torch.distributed.sharding, "
            "repro_torch.distributed.compression, repro_torch.launch.mesh, "
            "repro_torch.checkpoint, repro_torch.checkpoint.manager\n"
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


# modules of the reference with no counterpart in the port, and why
NO_COUNTERPART = {
    "kernels/ref.py": "the jnp oracles of the Pallas kernels: each kernel "
                      "wrapper's plain PyTorch version plays that part",
}


# reference modules whose counterpart has another name
RENAMED = {"analysis/hlo.py": "analysis/op_cost.py",
           "analysis/hlo_cost.py": "analysis/op_cost.py"}


def test_every_reference_module_has_a_counterpart():
    ref = ROOT / "src" / "repro"
    missing = []
    for p in ref.rglob("*.py"):
        rel = str(p.relative_to(ref))
        if "__pycache__" not in p.parts and \
                not (PKG / RENAMED.get(rel, rel)).exists():
            missing.append(rel)
    assert sorted(missing) == sorted(NO_COUNTERPART)


def test_dry_run_modules_import_without_jax():
    code = ("import sys, repro_torch.launch.cells, repro_torch.launch.dryrun,"
            " repro_torch.launch.dryrun_lp, repro_torch.analysis.op_cost, "
            "repro_torch.analysis.roofline, repro_torch.analysis.report\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"


def test_chip_smoke_never_imports_jax_or_the_reference():
    """chip_smoke.py drives the port on a machine without JAX: none of its
    imports, at any depth of the file, names jax or repro."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert "repro_torch.core" in names
    assert not [n for n in names if _is_reference(n)]


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
    """One thread a live column (n+m and the rhs), spread evenly over the
    fewest column groups of at most MAX_THREADS, rounded up to a warp."""
    t = block_threads(m, n)
    cols = n + m + 1
    groups = -(-cols // MAX_THREADS)
    assert t % 32 == 0 and 32 <= t <= MAX_THREADS
    assert t * groups >= cols and (t - 32) * groups < cols


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,fits", SHAPES)
def test_shared_memory_budget(m, n, fits):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and the built kernel")
    stride = (n + m + 1) | 1           # the live columns, an odd stride
    for rule in ("dantzig", "steepest_edge", "devex"):
        for stage, rows in (("whole", m + 2), ("p1", m + 2), ("p2", m + 1),
                            ("full", m + 2)):
            assert tableau_in_smem(m, n, rule, stage=stage) == fits
            tableau = 4 * rows * stride
            assert (smem_bytes(m, n, rule, stage=stage)
                    - smem_bytes(m, n, rule, tableau=False,
                                 stage=stage)) == tableau
        assert smem_bytes(m, n, rule, tableau=False) < 64 * 1024
        # a p1 segment adds its 32-pivot log (entering columns of m+2 rows
        # rounded to 4, a row, a pivot element and a flag a pivot) and the
        # replay's two rows of m pivot-row values
        log = 4 * 32 * (-(-(m + 2) // 4) * 4 + 3) + 4 * 2 * m
        col = 4 * max(-(-(m + 2) // 4) * 4, -(-n // 4) * 4)
        assert (smem_bytes(m, n, rule, stage="p1")
                - smem_bytes(m, n, rule)) == log - col
        # a full segment keeps the p1 layout
        assert smem_bytes(m, n, rule, stage="full") \
            == smem_bytes(m, n, rule, stage="p1")


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
    return map_state(torch.clone, state)


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
    return map_state(lambda leaf: leaf.to(device), state), m, n


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
    assert "revised_tile_variant" in text   # the one place that chooses
    # one thread a candidate column, rounded up to a warp, at most 384
    # (afiro's 67 candidates take three warps)
    for (m, n), want in {(100, 100): 224, (35, 32): 96, (246, 159): 384,
                         (4, 5): 32, (400, 300): 384}.items():
        t = revised_threads(m, n)
        assert t == want, (m, n)
        assert t % 32 == 0 and 32 <= t <= 384 and t >= min(n + m, 384)


@pytest.mark.gpu
def test_revised_workspace_budget():
    """The dispatch by shape and the layout: A's region (the Gauss-Jordan
    left half reuses it), Binv (m x ld, ld = 4 mod 8) and the scratch in
    shared memory at 100 x 100 and 35 x 32, in device memory at 246 x 159,
    where shared memory keeps the vectors only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and the built kernel")
    assert revised_variant(100, 100) == "shared"
    assert revised_variant(35, 32) == "shared"
    assert revised_variant(246, 159) == "device"
    for m, n in ((100, 100), (35, 32), (246, 159)):
        ld = m + (12 - m % 8) % 8
        region = -(-m * max(n, ld) // 4) * 4
        scratch = revised_workspace_floats(m) - 2 * m * ld
        assert scratch > 0
        assert (revised_smem_bytes(m, n)
                - revised_smem_bytes(m, n, workspace=False)) \
            == 4 * (scratch + region + m * ld)
        assert revised_smem_bytes(m, n, workspace=False) < 4 * (
            4 * n + 13 * m + 64)


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
                map_state(torch.clone, state), 23, **kw)
            torch.cuda.synchronize()
            assert revised_segment_tile.launches == before + 1
            want, want_it = revised_segment_tile_plain(state, 23, **kw)
            torch.testing.assert_close(it, want_it, rtol=0, atol=0)
            for name, g, w in zip(RevisedState._fields, got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0,
                                           equal_nan=True, msg=name)
            state = want


@pytest.mark.gpu
@pytest.mark.parametrize("pricing", ["dantzig", "partial"])
@pytest.mark.parametrize("shape", ["shared", "afiro", "device"])
def test_revised_variant_matches_plain_version_on_the_card(shape, pricing):
    """One shape of each variant (and afiro's three-warp block), both
    rules: a whole-solve launch equal to the plain version, every leaf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(7)
    if shape == "shared":
        batch = random_lp_batch(rng, B=48, m=100, n=100, feasible_start=False)
    else:
        name = "afiro" if shape == "afiro" else "sc205_like"
        batch, _ = canonicalize(perturbed_batch(read_mps(fixture_path(name)),
                                                16 if shape == "afiro" else 2,
                                                rng))
    m, n = batch.m, batch.n
    assert revised_variant(m, n) == ("device" if shape == "device"
                                     else "shared")
    A, b, c, ub = batch_tensors(batch, torch.device("cuda"))
    state = warm_state(A, b, c, ub, m=m, n=n, feas_tol=1e-5)
    kw = dict(stage="p2", m=m, n=n, max_iters=10 * (m + n) + 50,
              refactor_period=max(4, min(64, m // 2)), rule=pricing)
    steps = 400 if shape == "device" else kw["max_iters"]
    before = revised_segment_tile.launches
    got, it = revised_segment_tile(
        map_state(torch.clone, state), steps, **kw)
    torch.cuda.synchronize()
    assert revised_segment_tile.launches == before + 1
    want, want_it = revised_segment_tile_plain(state, steps, **kw)
    torch.testing.assert_close(it, want_it, rtol=0, atol=0)
    for name, g, w in zip(RevisedState._fields, got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                   msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("pricing", ["dantzig", "partial"])
@pytest.mark.parametrize("m,n,threads,want", [
    (800, 400, None, "device"),      # 384 threads, 402 elimination groups
    (132, 64, 32, "shared"),         # one warp: 33 eta groups, 66 and fewer
    (200, 100, 32, "device"),        # elimination groups
])
def test_revised_kernel_runs_any_basis_size_on_the_card(m, n, threads, want,
                                                        pricing,
                                                        monkeypatch):
    """A basis larger than any block's column groups: the device variant
    at m = 800, and blocks of one warp, where the elimination and the eta
    update loop over their column groups; every leaf equal to the plain
    version after a segment with several refactorizations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if threads is not None:
        monkeypatch.setattr(importlib.import_module(
            "repro_torch.kernels.revised_tile"), "block_threads",
            lambda m, n: threads)
    batch = random_lp_batch(np.random.default_rng(9), B=2 if m > 400 else 8,
                            m=m, n=n, feasible_start=False)
    assert revised_variant(m, n) == want
    A, b, c, ub = batch_tensors(batch, torch.device("cuda"))
    state = warm_state(A, b, c, ub, m=m, n=n, feas_tol=1e-5)
    steps = 40 if m > 400 else 300
    kw = dict(stage="p2", m=m, n=n, max_iters=10 * (m + n) + 50,
              refactor_period=16, rule=pricing)
    before = revised_segment_tile.launches
    got, it = revised_segment_tile(
        map_state(torch.clone, state), steps, **kw)
    torch.cuda.synchronize()
    assert revised_segment_tile.launches == before + 1
    assert int(got.work[:, 3].min()) >= 2        # refactorizations
    want_state, want_it = revised_segment_tile_plain(state, steps, **kw)
    torch.testing.assert_close(it, want_it, rtol=0, atol=0)
    for name, g, w in zip(RevisedState._fields, got, want_state):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                   msg=name)


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
    return map_state(lambda leaf: leaf.to(device), state), (A, b, c, ub), \
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
    # the register shapes: one warp holds whole rows up to 64 x 32, 16 x 16
    # threads up to 112 x 112; beyond them the warp design's 128 or 256
    for (m, n), threads in {(35, 32): 32, (64, 32): 32, (4, 5): 32,
                            (65, 32): 256, (64, 33): 256, (100, 100): 256,
                            (112, 112): 256, (113, 40): 256,
                            (40, 113): 256, (246, 159): 256,
                            (300, 300): 256, (300, 40): 256}.items():
        assert pdhg_threads(m, n) == threads, (m, n)
    assert "pdhg_tile_variant" in text and "pdhg_tile_a_in_smem" not in text


# (m, n): the variant the kernel runs, at and beside the register budget's
# edges (64 x 32 for one warp, 112 x 112 for 256 threads)
PDHG_VARIANTS = {(100, 100): "registers", (35, 32): "registers",
                 (64, 32): "registers", (65, 33): "registers",
                 (112, 112): "registers", (113, 112): "shared",
                 (112, 113): "shared", (246, 159): "shared",
                 (256, 256): "device", (300, 300): "device",
                 (300, 40): "device"}


@pytest.mark.gpu
def test_pdhg_shared_memory_budget():
    """The dispatch by shape: registers, shared or device memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and the built kernel")
    lib = _build.load("pdhg_tile")
    for (m, n), want in PDHG_VARIANTS.items():
        assert pdhg_variant(m, n) == want, (m, n)
        # the launcher takes only the threads block_threads gives
        assert lib.pdhg_tile_threads(m, n) == pdhg_threads(m, n), (m, n)
    # 256 x 256 is within the warp design's 256 rows but A does not fit
    assert pdhg_smem_bytes(256, 256) > 227 * 1024
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
    # one shape of each variant: registers (one warp; 16 x 16 threads),
    # shared, device
    for batch, cap, want in (
            (random_lp_batch(rng, B=64, m=30, n=24, feasible_start=False),
             4000, "registers"),
            (random_lp_batch(rng, B=6, m=100, n=100, feasible_start=False),
             640, "registers"),
            (sc, 320, "shared"),
            (random_lp_batch(rng, B=4, m=300, n=40, feasible_start=False),
             320, "device")):
        m, n = batch.m, batch.n
        assert pdhg_variant(m, n) == want
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
    # one shape of each variant: registers (one warp; 16 x 16 threads),
    # shared, device
    for (B, m, n), want_variant in (((64, 30, 24), "registers"),
                                    ((6, 100, 100), "registers"),
                                    ((4, 120, 130), "shared"),
                                    ((4, 300, 40), "device")):
        assert pdhg_variant(m, n) == want_variant
        state, _, m, n = _pdhg_state(seed=2, B=B, m=m, n=n,
                                     device=torch.device("cuda"))
        for _ in range(3):
            before = pdhg_segment_tile.launches
            got, it = pdhg_segment_tile(
                map_state(torch.clone, state), 7, m=m, n=n,
                max_rounds=40)
            torch.cuda.synchronize()
            assert pdhg_segment_tile.launches == before + 1
            want, want_it = pdhg_segment_tile_plain(state, 7, max_rounds=40)
            torch.testing.assert_close(it, want_it, rtol=0, atol=0)
            for name, g, w in zip(PdhgState._fields, got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0,
                                           equal_nan=True, msg=name)
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


# ---- the selective scan (csrc/ssm_scan.cu) and the serving path -----------

def _scan_inputs(B, T, d, s, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    put = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                 device=device)
    return (put(rng.uniform(0.5, 1.0, (B, T, d, s))),
            put(rng.normal(size=(B, T, d, s)) * 0.1),
            put(rng.normal(size=(B, d, s)) * 0.1))


def test_serving_entry_points_raise_without_cuda(monkeypatch):
    cfg = get_config("falcon-mamba-7b").reduced()
    lm = build_model(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(cfg, lm, batch=1, prompt_len=4, gen=2, requests=1)
    with pytest.raises(ValueError, match="the model is on cpu"):
        serve(cfg, lm, batch=1, prompt_len=4, gen=2, requests=1,
              device="meta")
    # a tensor on neither the CPU nor a card: no plain fallback
    meta = [t.to("meta") for t in _scan_inputs(1, 4, 8, 2)]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ssm_scan_bt_ds(*meta)
    with pytest.raises(ValueError, match=">= 1"):
        serve(cfg, lm, batch=1, prompt_len=4, gen=0, requests=1,
              device="cpu")
    res = serve(cfg, lm, batch=1, prompt_len=4, gen=2, requests=1,
                device="cpu")
    assert res["tokens"].shape == (1, 1, 2)


def test_ssm_scan_wrapper_rejects_what_the_kernel_does_not_take():
    dA, dBx, h0 = _scan_inputs(2, 5, 8, 4)
    with pytest.raises(ValueError, match="dA must be torch.float32"):
        ssm_scan(dA.double(), dBx, h0)
    with pytest.raises(ValueError, match="h0 must be contiguous"):
        ssm_scan(dA, dBx, h0.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="dBx has shape"):
        ssm_scan(dA, dBx[:, :4].contiguous(), h0)
    with pytest.raises(ValueError, match="h0 has shape"):
        ssm_scan(dA, dBx, h0[:1].contiguous())
    with pytest.raises(ValueError, match="4-D"):
        ssm_scan(dA[0], dBx[0], h0)


def test_ssm_scan_source_is_built_with_the_others_and_not_at_import():
    assert "ssm_scan" in _build.SOURCES
    text = (_build.CSRC / "ssm_scan.cu").read_text()
    assert "ssm_scan_fwd_launch" in text and "__fmaf_rn" in text
    assert "src/repro/kernels/ssm_scan.py" in text and "_fwd_kernel" in text
    assert "ssm_scan_bwd_launch" in text and "_bwd_kernel" in text
    code = ("import repro_torch.kernels.ssm_scan, repro_torch.models, "
            "repro_torch.launch.serve, repro_torch.launch.train\n"
            "print(repro_torch.kernels._build.load.cache_info().currsize)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "0"


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,d,s", [(1, 8, 8, 2), (2, 16, 24, 4),
                                     (2, 33, 130, 16), (3, 7, 256, 16),
                                     (2, 64, 130, 16), (1, 1, 1, 1)])
def test_ssm_scan_kernel_matches_plain_version_on_the_card(B, T, d, s):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dA, dBx, h0 = _scan_inputs(B, T, d, s, seed=T, device="cuda")
    before = ssm_scan.launches
    hs, hT = ssm_scan_bt_ds(dA, dBx, h0)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    want_hs, want_hT = ssm_scan_plain(dA, dBx, h0)
    torch.testing.assert_close(hs, want_hs, rtol=0, atol=0)
    torch.testing.assert_close(hT, want_hT, rtol=0, atol=0)


@pytest.mark.gpu
def test_reduced_model_serves_through_the_kernel_on_the_card():
    """The default config (``ssm_impl="assoc"``) scans with the kernel on
    the card; prefill and three decode steps there match the CPU port's
    (the kernel's plain scan) in logits and caches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    cfg = get_config("falcon-mamba-7b").reduced()
    assert cfg.ssm_impl == "assoc" and cfg.dtype == "float32"
    cpu = build_model(dataclasses.replace(cfg, ssm_impl="kernel"),
                      device="cpu", seed=0)
    card = build_model(cfg, device="cpu", seed=0).to("cuda")
    before = ssm_scan.launches
    res = serve(cfg, card, batch=2, prompt_len=64, gen=4, requests=2,
                device="cuda")
    assert ssm_scan.launches == before + cfg.n_layers * 1 * 2
    assert res["tokens"].shape == (2, 2, 4)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 67)))

    # float32 products in another summation order (cuBLAS, MKL): the
    # reference's bar between its two scan paths
    def close(got, want):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)

    with torch.inference_mode():
        want, want_c = cpu.prefill(toks[:, :64])
        got, got_c = card.prefill(toks[:, :64].cuda())
        for g in range(4):
            close(got, want)
            close(got_c.h, want_c.h)
            close(got_c.conv, want_c.conv)
            if g == 3:
                break
            pos = torch.full((2,), 64 + g)
            want, want_c = cpu.decode_step(want_c, toks[:, 64 + g], pos)
            got, got_c = card.decode_step(got_c, toks[:, 64 + g].cuda(),
                                          pos.cuda())


@pytest.mark.gpu
def test_serve_cli_scans_with_the_kernel_on_the_card(capsys):
    """``python -m repro_torch.launch.serve`` with the config as shipped:
    two 512-token chunks a layer, each one launch of the scan kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = get_config("falcon-mamba-7b").reduced()
    before = ssm_scan.launches
    res = serve_main(["--arch", "falcon-mamba-7b", "--reduced", "--batch",
                      "2", "--prompt-len", "1024",
                      "--gen", "2", "--requests", "2"])
    assert ssm_scan.launches == before + 2 * cfg.n_layers * 2
    assert res["tokens"].shape == (2, 2, 2)
    assert "[serve] wave 1: generated 2x2 tokens" in capsys.readouterr().out


@pytest.mark.gpu
def test_reduced_hymba_serves_on_the_card_as_on_the_cpu():
    """The reduced hybrid model (window 32, chunks of 32) on the card: a
    96-token prefill and three decode steps past it match the CPU port's
    (the kernel's plain scan) in logits and every cache leaf at atol
    1e-5, and the prefill scans with the kernel once a layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from repro_torch.launch.serve import pad_kv, set_matmul_policy
    set_matmul_policy()
    cfg = get_config("hymba-1.5b").reduced()
    cpu = build_model(dataclasses.replace(cfg, ssm_impl="kernel"),
                      device="cpu", seed=0)
    card = build_model(cfg, device="cpu", seed=0).to("cuda")
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (2, 99)))

    def close(got, want):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)

    def leaves(c):
        return (c.kv.k, c.kv.v, c.ssm.h, c.ssm.conv)

    before = ssm_scan.launches
    with torch.inference_mode():
        want, want_c = cpu.prefill(toks[:, :96])
        got, got_c = card.prefill(toks[:, :96].cuda())
        assert ssm_scan.launches == before + cfg.n_layers
        want_c, got_c = pad_kv(want_c, 99), pad_kv(got_c, 99)
        for g in range(4):
            close(got, want)
            for a, b in zip(leaves(got_c), leaves(want_c)):
                close(a, b)
            if g == 3:
                break
            pos = torch.full((2,), 96 + g)
            want, want_c = cpu.decode_step(want_c, toks[:, 96 + g], pos)
            got, got_c = card.decode_step(got_c, toks[:, 96 + g].cuda(),
                                          pos.cuda())
        with pytest.raises(IndexError, match="outside the cache"):
            card.decode_step(got_c, toks[:, 0].cuda(),
                             torch.full((2,), 99, device="cuda"))


def _cache_leaves(c):
    """Every tensor of a cache (nested NamedTuples), in order."""
    if isinstance(c, torch.Tensor):
        return [c]
    return [leaf for part in c for leaf in _cache_leaves(part)]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "whisper-small",
                                  "phi-3-vision-4.2b"])
def test_reduced_mla_encdec_and_vlm_serve_on_the_card_as_on_the_cpu(arch):
    """The reduced MLA MoE model (with the LP router: one whole-solve
    launch a MoE layer call), encoder-decoder (48 frames) and VLM (8
    patches) on the card: a 40-token prefill and three decode steps past
    it match the CPU port's in logits and every cache leaf at atol 1e-5;
    only MLA's router launches a kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from repro_torch.launch.serve import pad_kv, set_matmul_policy
    set_matmul_policy()
    cfg = get_config(arch).reduced()
    if cfg.attn_kind == "mla":
        cfg = dataclasses.replace(cfg, lp_capacity=True)
    cpu = build_model(cfg, device="cpu", seed=0)
    card = build_model(cfg, device="cpu", seed=0).to("cuda")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 43)))
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = torch.from_numpy(
            rng.standard_normal((2, 48, cfg.d_model), dtype=np.float32))
    if cfg.family == "vlm":
        extra["patches"] = torch.from_numpy(
            rng.standard_normal((2, cfg.n_patches, cfg.d_model),
                                dtype=np.float32))
    S = 40 + (cfg.n_patches if cfg.family == "vlm" else 0)

    def close(got, want):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)

    before = (simplex_tile.launches, ssm_scan.launches)
    with torch.inference_mode():
        want, want_c = cpu.prefill(toks[:, :40], **extra)
        got, got_c = card.prefill(toks[:, :40].cuda(),
                                  **{k: v.cuda() for k, v in extra.items()})
        want_c, got_c = pad_kv(want_c, S + 3), pad_kv(got_c, S + 3)
        for g in range(4):
            close(got, want)
            for a, b in zip(_cache_leaves(got_c), _cache_leaves(want_c)):
                close(a, b)
            if g == 3:
                break
            pos = torch.full((2,), S + g)
            want, want_c = cpu.decode_step(want_c, toks[:, 40 + g], pos)
            got, got_c = card.decode_step(got_c, toks[:, 40 + g].cuda(),
                                          pos.cuda())
    torch.cuda.synchronize()
    routed = cfg.n_layers * 4 if cfg.lp_capacity else 0
    assert (simplex_tile.launches, ssm_scan.launches) == \
        (before[0] + routed, before[1])


# ---- the scan's backward (csrc/ssm_scan.cu) and the training path ----------

@pytest.mark.gpu
@pytest.mark.parametrize("B,T,d,s", [(1, 1, 1, 1), (2, 7, 24, 4),
                                     (2, 33, 130, 16), (3, 9, 256, 16),
                                     (2, 64, 130, 16), (1, 8, 8, 2)])
def test_ssm_scan_bwd_kernel_matches_plain_version_on_the_card(B, T, d, s):
    """T = 1, T not a multiple of the unroll (8), L = d * s not a multiple
    of the block (256)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dA, dBx, h0 = _scan_inputs(B, T, d, s, seed=T, device="cuda")
    g_hs, _, g_hT = _scan_inputs(B, T, d, s, seed=T + 1, device="cuda")
    hs, _ = ssm_scan_bt_ds(dA, dBx, h0)
    before = ssm_scan_bwd.launches
    got = ssm_scan_bwd(dA, hs, h0, g_hs, g_hT)
    torch.cuda.synchronize()
    assert ssm_scan_bwd.launches == before + 1
    want = ssm_scan_bwd_plain(dA, hs, h0, g_hs, g_hT)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# the reduced model of each family trained on the card against the CPU
# port: (arch, config changes, optimizer)
TRAIN_CASES = (
    ("falcon-mamba-7b", {}, "adamw"),
    ("hymba-1.5b", {}, "adamw"),
    ("qwen3-32b", {}, "adamw"),
    ("llama3-405b", {}, "adafactor"),
    ("llama4-scout-17b-a16e", {"lp_capacity": True}, "adamw"),
    ("deepseek-v2-236b", {"lp_capacity": True}, "adamw"),
    ("whisper-small", {}, "adamw"),
    ("phi-3-vision-4.2b", {}, "adamw"),
)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,changes,optimizer", TRAIN_CASES,
                         ids=[c[0] for c in TRAIN_CASES])
def test_reduced_model_train_step_on_the_card_matches_the_cpu_port(
        arch, changes, optimizer):
    """One loss and its gradients of the reduced model (float32, remat
    per block) on the card against the CPU port: loss within 1e-5,
    gradients within 1e-4 (float32 products in another summation order);
    then a step with two microbatches and the config's optimizer
    (Adafactor for llama3-405b), its loss equal to the CPU port's step
    within 1e-5.  The scan kernels launch once a layer, chunk and
    microbatch (backward) and twice (forward and the recompute); the
    router's simplex kernel twice a MoE layer and microbatch (forward and
    the recompute)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from repro_torch.distributed import make_train_step
    from repro_torch.launch.serve import set_matmul_policy
    from repro_torch.optim import get_optimizer
    set_matmul_policy()
    cfg = dataclasses.replace(get_config(arch).reduced(), remat="block",
                              **changes)
    S = 1024 if cfg.family == "ssm" else 256
    cpu_cfg = dataclasses.replace(cfg, ssm_impl="kernel") \
        if cfg.family in ("ssm", "hybrid") else cfg
    cpu = build_model(cpu_cfg, device="cpu", seed=0)
    card = build_model(cfg, device="cpu", seed=0).to("cuda")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, S)))
    batch = {"tokens": toks, "labels": toks}
    extra = {"encdec": ("frames", 96), "vlm": ("patches", cfg.n_patches)}
    if cfg.family in extra:
        name, rows = extra[cfg.family]
        batch[name] = torch.from_numpy(rng.standard_normal(
            (2, rows, cfg.d_model), dtype=np.float32))

    def grads(model, dev):
        loss = model.loss_fn({k: v.to(dev) for k, v in batch.items()})
        return loss, torch.autograd.grad(loss, list(model.parameters()))

    want_loss, want = grads(cpu, "cpu")
    launches = (ssm_scan.launches, ssm_scan_bwd.launches,
                simplex_tile.launches)
    got_loss, got = grads(card, "cuda")
    assert abs(float(got_loss.detach()) - float(want_loss.detach())) < 1e-5
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-4)
    microbatches = 2
    # mamba_apply scans chunks of min(512, S) tokens
    chunks = S // min(512, S) if cfg.family in ("ssm", "hybrid") else 0
    scans = cfg.n_layers * chunks
    routed = cfg.n_layers if cfg.lp_capacity else 0
    assert (ssm_scan.launches - launches[0], ssm_scan_bwd.launches -
            launches[1], simplex_tile.launches - launches[2]) == \
        (2 * scans, scans, 2 * routed)
    losses = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        opt = get_optimizer(optimizer)
        step = make_train_step(model, opt, microbatches=microbatches)
        before = (ssm_scan.launches, ssm_scan_bwd.launches,
                  simplex_tile.launches)
        m = step(opt.init(list(model.named_parameters())),
                 {k: v.to(dev) for k, v in batch.items()})
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
        losses.append(float(m["loss"]))
    assert abs(losses[0] - losses[1]) < 1e-5
    assert (ssm_scan.launches - before[0], ssm_scan_bwd.launches -
            before[1], simplex_tile.launches - before[2]) == \
        (2 * microbatches * scans, microbatches * scans,
         2 * microbatches * routed)
    assert all(torch.isfinite(p).all() for p in card.parameters())


@pytest.mark.gpu
def test_optimal_mixture_on_the_card_equals_the_cpu():
    """4,096 utility rows over 8 sources: one whole-solve simplex launch,
    the weights equal to the CPU port's (the kernel equals its plain
    version bit for bit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.data import optimal_mixture
    rng = np.random.default_rng(7)
    u = rng.normal(size=(4096, 8))
    caps, floors = np.full(8, 0.3), np.full(8, 0.05)
    floors_rows = np.broadcast_to(floors, (4096, 8)).copy()
    floors_rows[::97] = 0.2                 # infeasible rows: uniform
    before = simplex_tile.launches
    got = optimal_mixture(u, caps, floors_rows)
    assert simplex_tile.launches == before + 1
    want = optimal_mixture(u, caps, floors_rows, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[::97], np.full_like(got[::97], 1 / 8))


# ---- the combined stage, the warm tableau path and branch-and-bound ------

def _full_state(batch, pricing, dev, parent_steps=200):
    """A mid-solve full-layout state holding lanes in phase 1, in phase 2
    and warm-injected ones: the odd lanes seeded from their LP's own basis
    after ``parent_steps`` combined steps, b scaled by 0.8 on every fourth
    LP (repaired: phase 1) and c reweighted on every fourth other (phase
    2, pivoting), then combined steps (the wrapper's: the kernel on the
    card) in eights until both phases have running lanes."""
    m, n = batch.m, batch.n
    be = KernelBackend(m, n, 1e-6, 1e-5, pricing=pricing)
    A, b, c, ub = batch_tensors(batch, dev)
    parent, _ = be.run_combined(be.init(A, b, c, ub), parent_steps, 10_000)
    odd = np.arange(batch.batch) % 2 == 1
    cold = np.tile(np.arange(n, n + m, dtype=np.int32), (batch.batch, 1))
    from repro_torch.core.lp import WarmStart
    warm = WarmStart(m=m, n=n, basis=np.where(
        odd[:, None], parent.basis.cpu().numpy(), cold),
        at_upper=odd[:, None] & parent.flip.cpu().numpy())
    lane = torch.arange(batch.batch, device=dev)[:, None] % 4
    state = be.init(A, torch.where(lane == 1, 0.8 * b, b), torch.where(
        lane == 3, c * torch.linspace(0.5, 1.5, n, device=dev), c), ub,
        warm=warm)
    for _ in range(200):
        running = state.status == -1
        if bool((running & (state.phase == 1)).any()) and \
                bool((running & (state.phase == 2)).any()):
            return state
        state, _ = be.run_combined(state, 8, 10_000)
    raise AssertionError("no state with running lanes in both phases")


def test_combined_stage_on_cpu_tensors_is_the_plain_version():
    batch = random_lp_batch(np.random.default_rng(3), B=8, m=6, n=5,
                            feasible_start=False)
    state = _full_state(batch, "dantzig", torch.device("cpu"))
    kw = dict(stage="full", m=6, n=5, max_iters=40)
    before = segment_tile.launches, segment_tile.full_launches
    got, it = segment_tile(state, 5, **kw)
    assert (segment_tile.launches, segment_tile.full_launches) == before
    want, want_it = segment_tile_plain(state, 5, **kw)
    assert torch.equal(it, want_it)
    for g, w in zip(got, want):
        if g is not None:
            assert torch.equal(g, w)
    tel = TorchBackend(6, 5, 1e-6, 1e-5).init(
        *batch_tensors(batch, torch.device("cpu")), telemetry=True)
    with pytest.raises(ValueError, match="counter"):
        segment_tile(tel, 5, **kw)
    with pytest.raises(ValueError, match="stage"):
        segment_tile(state, 5, **dict(kw, stage="p3"))


@pytest.mark.gpu
@pytest.mark.parametrize("pricing", ["dantzig", "devex", "steepest_edge"])
def test_combined_stage_matches_plain_version_on_the_card(pricing):
    """One launch of stage full from a state holding lanes in phase 1, in
    phase 2 and warm-injected ones, in both variants (shared: 30 x 24;
    device: sc205_like), every leaf equal to the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    sc, _ = canonicalize(perturbed_batch(read_mps(fixture_path("sc205_like")),
                                         8, rng))
    small = random_lp_batch(rng, B=64, m=30, n=24, feasible_start=False)
    for batch, fits in ((small, True), (sc, False)):
        m, n = batch.m, batch.n
        assert tableau_in_smem(m, n, pricing, stage="full") == fits
        state = _full_state(batch, pricing, dev, 200 if fits else 700)
        running = state.status == -1
        assert bool((running & (state.phase == 1)).any())
        assert bool((running & (state.phase == 2)).any())
        for steps, cap in ((8, 10_000), (40, int(state.iters.max()) + 3)):
            kw = dict(stage="full", m=m, n=n, max_iters=cap,
                      pricing=pricing)
            before = segment_tile.full_launches
            got, it = segment_tile(_clone(state), steps, **kw)
            torch.cuda.synchronize()
            assert segment_tile.full_launches == before + 1
            want, want_it = segment_tile_plain(state, steps, **kw)
            torch.testing.assert_close(it, want_it, rtol=0, atol=0)
            for name, g, w in zip(CompactionState._fields, got, want):
                if g is None:
                    continue
                torch.testing.assert_close(g, w, rtol=0, atol=0,
                                           equal_nan=True, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("pricing", ["dantzig", "devex", "steepest_edge"])
def test_tableau_warm_path_matches_the_engine_on_the_card(pricing):
    """``warm=`` on the card's tableau path injects (no warning) and equals
    the plain engine's warm solve bit for bit; a re-solve from its own
    optimum takes no pivot."""
    import warnings
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(10)
    g = perturbed_batch(read_mps(fixture_path("afiro")), 64, rng)
    first = solve_batched_torch(g, device="cpu", pricing=pricing)
    g2 = perturbed_batch(read_mps(fixture_path("afiro")), 64,
                         np.random.default_rng(11))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        before = segment_tile.full_launches
        again = solve_batched_kernel(g, device="cuda", pricing=pricing,
                                     warm=first.warm_start())
        got = solve_batched_kernel(g2, device="cuda", pricing=pricing,
                                   warm=first.warm_start())
        assert segment_tile.full_launches == before + 2
    opt = first.status == 0
    assert (again.iterations[opt] == 0).all()
    want = solve_batched_torch(g2, device="cpu", pricing=pricing,
                               warm=first.warm_start())
    for f in ("status", "iterations", "x", "objective", "y", "z"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_array_equal(got.warm.basis, want.warm.basis)


@pytest.mark.gpu
def test_branch_and_bound_on_the_card_equals_the_cpu_port():
    """The fixtures' trees on the card (every node relaxation through the
    CUDA kernels) have the CPU port's nodes, dispatches and LP iterations;
    PDHG proves the optima."""
    from repro_torch.core import branch_and_bound
    from repro_torch.io import MIP_FIXTURE_NAMES
    from repro_torch.kernels import revised_segment_tile
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    opt = {"knapsack": 280.0, "assignment": 5.0, "scheduling": 42.0}
    keys = ("objective", "proven", "nodes", "dispatches", "lp_iterations",
            "max_depth")
    for name in MIP_FIXTURE_NAMES:
        g = read_mps(fixture_path(name))
        for kw in (dict(backend="tableau"), dict(backend="tableau",
                                                 warm_start=False),
                   dict(backend="tableau", mode="stream"),
                   dict(backend="revised")):
            def launched():
                if kw["backend"] == "revised":
                    return revised_segment_tile.launches
                return segment_tile.launches + simplex_tile.launches
            before = launched()
            got = branch_and_bound(g, device="cuda", frontier=8, **kw)
            want = branch_and_bound(g, device="cpu", frontier=8, **kw)
            assert got.proven and got.objective == opt[name]
            assert {k: getattr(got, k) for k in keys} \
                == {k: getattr(want, k) for k in keys}, (name, kw)
            assert launched() > before
    for name in ("knapsack", "scheduling"):
        res = branch_and_bound(read_mps(fixture_path(name)), device="cuda",
                               backend="pdhg", frontier=8, max_nodes=200)
        assert res.proven and abs(res.objective - opt[name]) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("G,E", [(1, 16), (4096, 16), (1, 160), (4096, 160)])
def test_expert_capacity_lp_on_the_card_equals_the_cpu(G, E):
    """The router's LP through the whole-solve kernel, on device tensors
    with no host synchronization (sync-debug mode "error"), equal bit for
    bit to its run on the CPU (the plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import expert_capacity_lp
    d = np.random.default_rng(G + E).uniform(0, 50, (G, E)).astype(np.float32)
    want = expert_capacity_lp(torch.from_numpy(d), 4.0 * E, 12.0)
    dev_d = torch.from_numpy(d).cuda()
    torch.cuda.synchronize()
    before = simplex_tile.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = expert_capacity_lp(dev_d, 4.0 * E, 12.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got.is_cuda and simplex_tile.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("top_k", [1, 2])
def test_reduced_moe_layer_with_the_lp_router_on_the_card_equals_the_cpu(
        top_k):
    """The reduced llama4-scout MoE layer with lp_capacity on a card
    tensor: one whole-solve launch a call, no host synchronization
    (sync-debug mode "error"), the CPU port's experts, slots and keep
    mask (tokens dropped), its demand within 1e-5 (another summation
    order), caps bit-equal to the plain version's solve of the card's
    demand, and the output within atol 1e-5."""
    from repro_torch.core import expert_capacity_lp
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from repro_torch.launch.serve import set_matmul_policy
    from repro_torch.models import moe
    set_matmul_policy()
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e").reduced(),
                              lp_capacity=True, top_k=top_k)
    gen = torch.Generator().manual_seed(0)
    p_cpu = moe.moe_init(gen, cfg, torch.device("cpu"))
    p_card = {k: v.cuda() for k, v in p_cpu.items()}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 32, cfg.d_model)).astype(np.float32)
    x = torch.from_numpy(x + 1.5 * rng.normal(size=cfg.d_model)
                         .astype(np.float32))
    C = moe._capacity(128, top_k, cfg.n_experts, cfg.capacity_factor)
    want = moe.moe_apply(p_cpu, x, cfg)
    want_r = moe.route(x.reshape(128, -1), p_cpu["router"], cfg, C)
    x_card = x.cuda()
    torch.cuda.synchronize()
    before = simplex_tile.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe.moe_apply(p_card, x_card, cfg)
        got_r = moe.route(x_card.reshape(128, -1), p_card["router"], cfg, C)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert simplex_tile.launches == before + 2
    for f in ("expert", "slot", "keep"):
        torch.testing.assert_close(getattr(got_r, f).cpu(),
                                   getattr(want_r, f), rtol=0, atol=0)
    torch.testing.assert_close(got_r.demand.cpu(), want_r.demand, rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(
        got_r.caps.cpu(),
        expert_capacity_lp(got_r.demand.cpu(), 128.0 * top_k, float(C))[0],
        rtol=0, atol=0)
    assert not want_r.keep.all()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_world_of_one_segmented_equals_compaction_on_the_card():
    """solve_shard_map(segment_k=4) in a world of one rank through the
    segment kernel equals solve_batched(compaction=True, segment_k=4) leaf
    by leaf, ladder included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import solve_shard_map
    batch = random_lp_batch(np.random.default_rng(8), B=300, m=30, n=24,
                            feasible_start=False)
    stats, want_stats = [], []
    got = solve_shard_map(batch, segment_k=4, stats_out=stats)
    want = batching.solve_batched(batch, compaction=True, segment_k=4,
                                  stats_out=want_stats)
    for f in ("status", "iterations", "x", "objective", "y", "z"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert [vars(s) for s in stats] == [vars(s) for s in want_stats]
