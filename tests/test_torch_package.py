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
from repro_torch.core.forms import canonicalize
from repro_torch.core.lp import LPBatch, canonicalize_backend, resolve_backend
from repro_torch.core.reference import random_lp_batch
from repro_torch.core.simplex import batch_tensors, solve_batched_torch
from repro_torch.io import fixture_path, perturbed_batch, read_mps
from repro_torch.kernels import _build, simplex_tile, simplex_tile_plain
from repro_torch.kernels.ops import solve_batched_kernel
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
    assert resolve_backend("tableau") is solve_batched_torch
    for name in ("revised", "pdhg"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            resolve_backend(name)
    with pytest.raises(ValueError):
        canonicalize_backend("simplex")


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
