"""The port's work models (``repro_torch.analysis.lp_perf``) against the
reference's ``repro.analysis.lp_perf``.

The models are NumPy arithmetic over the port's own copies of the shape
helpers, so every value must equal the reference's exactly: each model
function on a grid of shapes, ``canonical_work`` on every fixture,
``analyze`` and ``compare_pricing`` at small batches (dict for dict, the
float64 oracle's pivot counts included) and the CSV report of ``main``.
"""
import functools
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

from repro.analysis import lp_perf as ref
from repro.io.mps import read_mps as ref_read_mps
from repro_torch.analysis import lp_perf
from repro_torch.io import FIXTURE_NAMES, MIP_FIXTURE_NAMES, fixture_path
from repro_torch.io import read_mps

SHAPES = [(1, 1), (5, 5), (12, 10), (28, 28), (35, 32), (100, 100),
          (100, 400), (50, 500), (300, 300)]


@pytest.mark.parametrize("m,n", SHAPES)
def test_per_pivot_models_equal_the_reference(m, n):
    for fn, kws in (
            ("tableau_pivot_flops", [{}, {"compacted": True}]),
            ("flops_per_pivot", [{}, {"compacted": True}]),
            ("tableau_elements", [{}, {"compacted": True}]),
            ("revised_pivot_flops", [{}, {"partial": True},
                                     {"refactor_period": 7},
                                     {"partial": True, "block": 16}]),
            ("revised_elements", [{}, {"partial": True},
                                  {"refactor_period": 3}]),
            ("auto_refactor_period", [{}]),
            ("pdhg_iteration_flops", [{}])):
        for kw in kws:
            assert getattr(lp_perf, fn)(m, n, **kw) == \
                getattr(ref, fn)(m, n, **kw), (fn, kw)
    for nnz in (1, m, m * n // 3 + 1, m * n):
        assert lp_perf.sparse_pdhg_speedup(m, n, nnz) == \
            ref.sparse_pdhg_speedup(m, n, nnz)
        assert lp_perf.sparse_pdhg_iteration_flops(nnz, m, n) == \
            ref.sparse_pdhg_iteration_flops(nnz, m, n)
        assert lp_perf.sparse_matvec_flops(nnz) == ref.sparse_matvec_flops(nnz)
    for iters in (1, 300.0, 5000):
        for partial in (True, False):
            assert lp_perf.pdhg_crossover_pivots(m, n, iters,
                                                 partial=partial) == \
                ref.pdhg_crossover_pivots(m, n, iters, partial=partial)


@pytest.mark.parametrize("m", [1, 5, 28, 100])
def test_crossovers_equal_the_reference(m):
    for kw in ({}, {"partial": False}, {"refactor_period": 4},
               {"max_ratio": 2}):
        assert lp_perf.revised_crossover(m, **kw) == \
            ref.revised_crossover(m, **kw)


@pytest.mark.parametrize("iters", [3000, 10000, 10 ** 9])
def test_pdhg_crossover_size_equals_the_reference(iters):
    assert lp_perf.pdhg_crossover_size(iters, max_m=5000) == \
        ref.pdhg_crossover_size(iters, max_m=5000)


@pytest.mark.parametrize("seed", [0, 1])
def test_pivot_count_models_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    iters = rng.integers(0, 60, size=37)
    p1 = np.minimum(rng.integers(0, 30, size=37), iters)
    lock = iters.astype(np.int64)
    for group in (1, 4, 37, 64):
        assert lp_perf.executed_pivots(lock, group) == \
            ref.executed_pivots(lock, group)
    for m, n in ((5, 5), (28, 28)):
        assert lp_perf.element_updates_lockstep(iters, m, n) == \
            ref.element_updates_lockstep(iters, m, n)
        assert lp_perf.element_updates_phase_compacted(p1, iters, m, n) == \
            ref.element_updates_phase_compacted(p1, iters, m, n)
        for k, thr, pad in ((8, 0.5, 1), (3, 0.9, 1), (4, 0.5, 2),
                            (5, 0.7, 8)):
            assert lp_perf.element_updates_scheduled(
                p1, iters, m, n, segment_k=k, compact_threshold=thr,
                pad_multiple=pad) == ref.element_updates_scheduled(
                p1, iters, m, n, segment_k=k, compact_threshold=thr,
                pad_multiple=pad), (k, thr, pad)
    for active in (1, 2, 3, 37, 64, 65):
        for pad in (1, 2, 3, 8):
            assert lp_perf.next_bucket(active, pad) == \
                ref.next_bucket(active, pad)


@pytest.mark.parametrize("name", FIXTURE_NAMES + MIP_FIXTURE_NAMES)
def test_canonical_work_equals_the_reference(name):
    path = fixture_path(name)
    for presolve in (True, False):
        assert lp_perf.canonical_work(read_mps(path), presolve=presolve) == \
            ref.canonical_work(ref_read_mps(path), presolve=presolve)


@pytest.mark.parametrize("m,n,mixed,pricing", [
    (5, 5, True, "dantzig"), (12, 10, False, "devex"),
    (12, 10, True, "steepest_edge")])
def test_analyze_equals_the_reference(m, n, mixed, pricing):
    kw = dict(B=48, mixed=mixed, chips=4, tile_b=8, seed=3, pricing=pricing)
    assert lp_perf.analyze(m, n, **kw) == ref.analyze(m, n, **kw)


def test_compare_pricing_equals_the_reference():
    assert lp_perf.compare_pricing(8, 6, B=32, seed=5) == \
        ref.compare_pricing(8, 6, B=32, seed=5)


def test_main_report_equals_the_reference(monkeypatch):
    """``main`` at a batch of 16 (its own is 4,096): the same CSV text."""
    out = []
    for mod in (lp_perf, ref):
        monkeypatch.setattr(mod, "analyze",
                            functools.partial(mod.analyze, B=16))
        monkeypatch.setattr(mod, "compare_pricing",
                            functools.partial(mod.compare_pricing, B=16))
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod.main()
        out.append(buf.getvalue())
    assert out[0] == out[1]
    assert "lp_28d_mixed" in out[0] and "afiro" in out[0]
