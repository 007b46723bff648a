"""The port's box-LP special case (paper Sec. 5.6) against the reference.

``repro_torch.core.solve_hyperbox`` on CPU tensors (the plain version of
the hyperbox kernel) gets the same float32 inputs as the reference's
``solve_hyperbox``, its Pallas kernel (interpret mode) and its float64
oracle, in both forms: one direction per box, and K directions shared by
every box.  The CUDA kernel itself is held against the plain version on the
card (tests/test_torch_package.py, marker ``gpu``; chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hyperbox_as_general_lp as as_lp_ref
from repro.core import solve_hyperbox as solve_hyperbox_jax
from repro.core import solve_hyperbox_ref as oracle_ref
from repro.kernels.hyperbox_kernel import hyperbox_pallas
from repro_torch.core import (OPTIMAL, hyperbox_as_general_lp, solve_batched,
                              solve_hyperbox, solve_hyperbox_ref)
from repro_torch.kernels import hyperbox_tile, hyperbox_tile_plain
from repro_torch.kernels.ops import solve_hyperbox_kernel


def _boxes(n, B=57, K=9, seed=13):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-4, 0, (B, n)).astype(np.float32)
    hi = (lo + rng.uniform(0.1, 3, (B, n))).astype(np.float32)
    d = rng.normal(size=(B, n)).astype(np.float32)
    dk = rng.normal(size=(K, n)).astype(np.float32)
    return lo, hi, d, dk


def _port(*arrays):
    return solve_hyperbox(*map(torch.from_numpy, arrays)).numpy()


@pytest.mark.parametrize("n", [3, 5, 7, 32, 64, 130])
def test_both_forms_match_the_jax_reference(n):
    lo, hi, d, dk = _boxes(n)
    for dirs, shape in ((d, (57,)), (dk, (57, 9))):
        got = _port(lo, hi, dirs)
        want = np.asarray(solve_hyperbox_jax(*map(jnp.asarray,
                                                 (lo, hi, dirs))))
        assert got.shape == want.shape == shape
        if n <= 32:
            # the reference's CPU build accumulates up to 32 terms in
            # order, one fused rounding each, as the port does
            np.testing.assert_array_equal(got, want)
        else:
            # above 32 terms it reassociates the sum (ROADMAP queue 3):
            # f32 rounding of n terms of size <= 12
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n", [3, 7, 64, 130])
def test_matches_the_pallas_kernel_and_the_oracle(n):
    lo, hi, d, dk = _boxes(n)
    got = _port(lo, hi, d)
    want = np.asarray(hyperbox_pallas(*map(jnp.asarray, (lo, hi, d)),
                                      tile_b=16, interpret=True))
    # the Pallas kernel rounds each product, then sums the padded lane
    # row: the reference's own kernel tolerance (tests/test_kernels.py)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)
    for dirs in (d, dk):
        f64 = oracle_ref(lo, hi, dirs)
        np.testing.assert_array_equal(solve_hyperbox_ref(lo, hi, dirs), f64)
        # float32 against float64, the same tolerance
        np.testing.assert_allclose(_port(lo, hi, dirs), f64, rtol=2e-5,
                                   atol=1e-5)


def test_shared_directions_equal_the_expanded_per_box_form():
    lo, hi, _, dk = _boxes(5)
    got = _port(lo, hi, dk)
    K = dk.shape[0]
    expanded = _port(np.repeat(lo, K, axis=0), np.repeat(hi, K, axis=0),
                     np.tile(dk, (lo.shape[0], 1)))
    np.testing.assert_array_equal(got, expanded.reshape(lo.shape[0], K))


def test_general_lp_encoding_matches_the_reference():
    lo, hi, d, _ = _boxes(6, B=11)
    lp, off = hyperbox_as_general_lp(lo, hi, d)
    lp_ref, off_ref = as_lp_ref(lo, hi, d)
    for f in ("A", "b", "c"):
        np.testing.assert_array_equal(getattr(lp, f), getattr(lp_ref, f))
    assert lp.ub is None and lp_ref.ub is None
    np.testing.assert_array_equal(off, off_ref)


def test_simplex_on_the_encoded_lps_reproduces_the_support_values():
    rng = np.random.default_rng(13)
    lo = rng.uniform(-5, 0, (40, 6))
    hi = lo + rng.uniform(0.5, 4, (40, 6))
    d = rng.normal(size=(40, 6))
    fast = solve_hyperbox(*(torch.tensor(a, dtype=torch.float32)
                            for a in (lo, hi, d))).numpy()
    lp, off = hyperbox_as_general_lp(lo, hi, d)
    res = solve_batched(lp, device="cpu")
    assert (res.status == OPTIMAL).all()
    # the reference's own tolerance (tests/test_hyperbox.py)
    np.testing.assert_allclose(fast, res.objective + off, rtol=1e-4)


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    lo, hi, d, dk = (torch.from_numpy(a) for a in _boxes(7))
    before = hyperbox_tile.launches
    for dirs in (d, dk):
        torch.testing.assert_close(hyperbox_tile(lo, hi, dirs),
                                   hyperbox_tile_plain(lo, hi, dirs),
                                   rtol=0, atol=0)
    assert hyperbox_tile.launches == before
    got = solve_hyperbox_kernel(lo.numpy(), hi.numpy(), dk.numpy(),
                                device="cpu")
    np.testing.assert_array_equal(got, hyperbox_tile_plain(lo, hi,
                                                           dk).numpy())
