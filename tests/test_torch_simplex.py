"""The port's tableau engine (repro_torch) against the JAX reference.

The same NumPy inputs go to both packages (through repro_torch.interop).
Against the JAX engine, statuses and iteration counts must be equal and x, objective, y and z agree to
rtol 1e-5; against the float64 oracle the reference's own tolerance holds
(status agreement >= 0.95, relative objective < 2e-3).  The port rounds
every fused update once, as the reference's CPU build does, so the engines
are in fact bit-identical on these classes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (OPTIMAL, random_lp_batch, solve_batched_jax,
                        solve_batched_reference)
from repro.core.forms import random_general_lp_batch
from repro.core.lp import LPBatch
from repro.io.mps import fixture_path, perturbed_batch, read_mps
from repro_torch.core import fp
from repro_torch.core.simplex import solve_batched_torch
from repro_torch.interop import batch_from_reference, result_arrays

VALUE_FIELDS = ("x", "objective", "y", "z")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bounded(rng):
    b = random_lp_batch(rng, B=33, m=8, n=10)
    ub = rng.uniform(0.05, 0.5, size=(33, 10))
    ub[:, ::3] = np.inf
    return LPBatch.from_arrays(b.A, b.b, b.c, ub=ub)


def _degenerate(rng):
    """Integer data, duplicated rows and zero right-hand sides: ties in the
    ratio test on nearly every pivot."""
    B, m, n = 33, 10, 6
    A = rng.integers(1, 4, size=(B, m, n)).astype(float)
    b = rng.integers(0, 3, size=(B, m)).astype(float) * 2.0
    A[:, m // 2:] = A[:, :m // 2]
    b[:, m // 2:] = b[:, :m // 2]
    c = rng.integers(1, 4, size=(B, n)).astype(float)
    return LPBatch.from_arrays(A, b, c)


def _mixed(rng):
    """One LP per terminal status: unbounded, infeasible, optimal, and a
    degenerate row that must beat the entering bound."""
    A = np.array([[[0.0, 1.0], [0.0, 1.0]], [[1.0, 1.0], [1.0, 0.0]],
                  [[1.0, 0.0], [1.0, 1.0]], [[1.0, -1.0], [1.0, 1.0]]])
    b = np.array([[1.0, 2.0], [-1.0, 3.0], [2.0, 4.0], [0.0, 4.0]])
    c = np.array([[1.0, 0.0], [1.0, 1.0], [1.0, 1.0], [1.0, 0.0]])
    return LPBatch.from_arrays(A, b, c)


CASES = {
    "feasible_12x8": lambda rng: random_lp_batch(rng, B=33, m=12, n=8),
    "phase1_12x12": lambda rng: random_lp_batch(rng, B=33, m=12, n=12,
                                                feasible_start=False),
    "bounded_8x10": _bounded,
    "degenerate_10x6": _degenerate,
    "mixed_status_2x2": _mixed,
    # equality pairs leave artificials basic at zero: phase-2 pinning
    "equalities_8x6": lambda rng: random_general_lp_batch(
        rng, B=16, m=8, n=6, eq_frac=0.6),
    "afiro_x8": lambda rng: perturbed_batch(read_mps(fixture_path("afiro")),
                                            8, rng),
}


def _case(name):
    return CASES[name](np.random.default_rng(sorted(CASES).index(name)))


def _port(batch, pricing):
    return result_arrays(solve_batched_torch(batch_from_reference(batch),
                                             device="cpu", pricing=pricing))


def _assert_parity(ref, port):
    np.testing.assert_array_equal(port["status"], ref["status"])
    np.testing.assert_array_equal(port["iterations"], ref["iterations"])
    for f in VALUE_FIELDS:
        np.testing.assert_allclose(port[f], ref[f], rtol=1e-5, atol=1e-5,
                                   equal_nan=True, err_msg=f)


# every case under the paper's rule; the weighted and block rules on the
# classes where their bookkeeping differs (phase 1, bounds, ties, pinning)
WEIGHTED_CASES = ["phase1_12x12", "bounded_8x10", "degenerate_10x6",
                  "equalities_8x6", "afiro_x8"]


@pytest.mark.parametrize("case,pricing",
                         [(c, "dantzig") for c in sorted(CASES)]
                         + [(c, r) for r in ("steepest_edge", "devex")
                            for c in WEIGHTED_CASES]
                         + [(c, "partial") for c in WEIGHTED_CASES[:3]])
def test_engine_matches_jax_engine(case, pricing):
    batch = _case(case)
    ref = result_arrays(solve_batched_jax(batch, pricing=pricing))
    _assert_parity(ref, _port(batch, pricing))


def test_mixed_case_covers_every_terminal_status():
    port = _port(_case("mixed_status_2x2"), "dantzig")
    assert sorted(set(port["status"].tolist())) == [0, 1, 2]


@pytest.mark.parametrize("case", ["feasible_12x8", "phase1_12x12",
                                  "bounded_8x10", "afiro_x8"])
def test_engine_matches_float64_oracle(case):
    batch = _case(case)
    ref = result_arrays(solve_batched_reference(batch))
    port = _port(batch, "dantzig")
    assert (port["status"] == ref["status"]).mean() >= 0.95
    ok = (ref["status"] == OPTIMAL) & (port["status"] == OPTIMAL)
    rel = (np.abs(port["objective"][ok] - ref["objective"][ok])
           / np.abs(ref["objective"][ok]))
    assert rel.max() < 2e-3


def test_afiro_member0_reproduces_netlib_optimum():
    port = _port(_case("afiro_x8"), "dantzig")
    assert port["status"][0] == OPTIMAL
    np.testing.assert_allclose(port["objective"][0], -464.7531428571429,
                               rtol=1e-4)


def test_fused_update_rounds_like_the_reference():
    """fp.fma reproduces the reference's contracted ``t - f * p`` bit for
    bit, where a separately rounded product differs."""
    rng = np.random.default_rng(0)
    t, f, p = (rng.standard_normal(s).astype(np.float32)
               for s in ((16, 9, 30), (16, 9, 1), (16, 1, 30)))
    ref = np.asarray(jax.jit(lambda t, f, p: t - f * p)(t, f, p))
    tt, ft, pt = map(torch.from_numpy, (t, f, p))
    np.testing.assert_array_equal(fp.fma(-ft, pt, tt).numpy(), ref)
    assert not np.array_equal((tt - ft * pt).numpy(), ref)


@pytest.mark.parametrize("m", [2, 5, 12, 32])
def test_column_sums_accumulate_like_the_reference(m):
    x = np.random.default_rng(m).standard_normal((4, m, 40)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: 1.0 + jnp.sum(x * x, axis=1))(x))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal((1.0 + fp.colsum_fma(xt, xt)).numpy(), ref)
