"""The port's chunked front door (repro_torch.core.batching).

Chunked, sorted and padded solves equal the unchunked one bit for bit, with
``ub`` sliced per chunk and through the sort (a regression the reference
once had: dropped bounds made bounded LPs UNBOUNDED), and the front door agrees with the reference's
``solve_batched`` on the same inputs (statuses and iterations equal, values
to rtol 1e-5).
"""
import numpy as np
import pytest
import torch

from repro.core import solve_batched as solve_batched_ref
from repro.core import random_lp_batch
from repro.core.batching import difficulty_proxy as difficulty_proxy_ref
from repro.core.batching import max_chunk_size as max_chunk_size_ref
from repro.core.lp import LPBatch
from repro.io.mps import fixture_path, perturbed_batch, read_mps
from repro_torch.core import batching
from repro_torch.core.batching import solve_batched
from repro_torch.interop import batch_from_reference, result_arrays

FIELDS = ("x", "objective", "status", "iterations", "y", "z")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mixed_bounded(seed=3):
    """Phase-1 and feasible-start LPs interleaved (so the difficulty sort
    reorders them), with finite bounds on a third of the columns."""
    rng = np.random.default_rng(seed)
    a = random_lp_batch(rng, B=12, m=6, n=7, feasible_start=False)
    b = random_lp_batch(rng, B=12, m=6, n=7)
    alt = np.arange(24).reshape(2, 12).T.ravel()    # a0, b0, a1, b1, ...
    A = np.concatenate([a.A, b.A])[alt]
    bb = np.concatenate([a.b, b.b])[alt]
    c = np.concatenate([a.c, b.c])[alt]
    ub = rng.uniform(0.05, 0.6, size=(24, 7))
    ub[:, 1::3] = np.inf
    return LPBatch.from_arrays(A, bb, c, ub=ub)


def _solve(batch, **kw):
    return result_arrays(solve_batched(batch_from_reference(batch),
                                       device="cpu", **kw))


@pytest.mark.parametrize("kw", [
    dict(chunk_size=5),
    dict(chunk_size=7, sort_by_difficulty=True),
    dict(sort_by_difficulty=True),
    dict(pad_to_bucket=True),
    dict(chunk_size=3, sort_by_difficulty=True, pad_to_bucket=True),
], ids=["chunked", "chunked_sorted", "sorted", "padded",
        "chunked_sorted_padded"])
def test_chunked_sorted_padded_equal_unchunked_bitwise(kw):
    batch = _mixed_bounded()
    whole = _solve(batch)
    got = _solve(batch, **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], whole[f], err_msg=f)
    assert np.isfinite(batch.ub).any()
    assert (whole["status"] == 0).all()   # bounded LPs stay bounded


@pytest.mark.parametrize("kw", [dict(chunk_size=5),
                                dict(chunk_size=7, sort_by_difficulty=True)],
                         ids=["chunked", "chunked_sorted"])
def test_front_door_matches_reference(kw):
    batch = _mixed_bounded(seed=4)
    ref = result_arrays(solve_batched_ref(batch, **kw))
    got = _solve(batch, **kw)
    np.testing.assert_array_equal(got["status"], ref["status"])
    np.testing.assert_array_equal(got["iterations"], ref["iterations"])
    for f in ("x", "objective", "y", "z"):
        np.testing.assert_allclose(got[f], ref[f], rtol=1e-5, atol=1e-5,
                                   equal_nan=True, err_msg=f)


def test_general_batch_chunks_after_canonicalization():
    g = perturbed_batch(read_mps(fixture_path("afiro")), 10,
                        np.random.default_rng(2))
    ref = result_arrays(solve_batched_ref(g, chunk_size=4))
    got = _solve(g, chunk_size=4)
    np.testing.assert_array_equal(got["status"], ref["status"])
    np.testing.assert_array_equal(got["iterations"], ref["iterations"])
    np.testing.assert_allclose(got["objective"], ref["objective"], rtol=1e-5)
    np.testing.assert_allclose(got["x"], ref["x"], rtol=1e-5, atol=1e-5)


def test_planning_helpers_match_reference():
    batch = _mixed_bounded()
    port = batch_from_reference(batch)
    np.testing.assert_array_equal(batching.difficulty_proxy(port),
                                  difficulty_proxy_ref(batch))
    for budget in (2 ** 20, 16 * 2 ** 30):
        assert (batching.max_chunk_size(port, budget)
                == max_chunk_size_ref(batch, budget))
    assert (batching.device_bytes_of(torch.device("cpu"))
            == batching.CPU_DEVICE_BYTES)


def test_default_chunking_plans_against_the_cpu_budget(monkeypatch):
    """With no chunk_size the CPU budget is used: a tiny budget forces
    chunks, and the result still equals the unchunked solve."""
    batch = _mixed_bounded()
    whole = _solve(batch)
    per_lp = batch_from_reference(batch).bytes_per_lp()
    monkeypatch.setattr(batching, "CPU_DEVICE_BYTES", int(per_lp * 5 / 0.6))
    got = _solve(batch)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], whole[f], err_msg=f)


def test_warm_capture_survives_chunking():
    batch = _mixed_bounded()
    whole = solve_batched(batch_from_reference(batch), device="cpu")
    got = solve_batched(batch_from_reference(batch), device="cpu",
                        chunk_size=5, sort_by_difficulty=True)
    np.testing.assert_array_equal(got.warm.basis, whole.warm.basis)
    np.testing.assert_array_equal(got.warm.at_upper, whole.warm.at_upper)


def test_custom_solver_gets_the_device_and_the_rule():
    from repro_torch.core.simplex import solve_batched_torch
    batch = _mixed_bounded()
    ref = result_arrays(solve_batched_ref(batch, pricing="devex"))
    got = result_arrays(solve_batched(batch_from_reference(batch),
                                      solver=solve_batched_torch,
                                      device="cpu", pricing="devex",
                                      chunk_size=10))
    np.testing.assert_array_equal(got["status"], ref["status"])
    np.testing.assert_array_equal(got["iterations"], ref["iterations"])
    with pytest.raises(ValueError, match="pricing"):
        solve_batched(batch_from_reference(batch), device="cpu",
                      solver=lambda sub, device: None, pricing="devex")
