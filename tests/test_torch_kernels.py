"""The port's kernel wrapper against the reference's Pallas kernel.

``repro_torch.kernels.simplex_tile`` (on CPU tensors: its plain version)
and ``repro.kernels.simplex_tile.simplex_pallas`` (interpret mode, as the
reference's own kernel tests run it) get the same float32 inputs; statuses
and iteration counts must be equal and x, objective, y and z agree to
rtol 1e-5.  The CUDA kernel itself is held against the plain version on the
card (tests/test_torch_package.py, marker ``gpu``; chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import random_lp_batch
from repro.core.forms import canonicalize
from repro.core.lp import default_max_iters
from repro.io.mps import fixture_path, perturbed_batch, read_mps
from repro.kernels.simplex_tile import simplex_pallas
from repro_torch.kernels import simplex_tile, simplex_tile_plain


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _arrays(name):
    rng = np.random.default_rng(17)
    if name == "phase1_12x10":
        lp = random_lp_batch(rng, B=19, m=12, n=10, feasible_start=False)
    elif name == "bounded_8x10":
        lp = random_lp_batch(rng, B=19, m=8, n=10)
        ub = rng.uniform(0.05, 0.5, size=(19, 10))
        ub[:, ::3] = np.inf
        lp = lp.__class__.from_arrays(lp.A, lp.b, lp.c, ub=ub)
    elif name == "degenerate_10x6":
        A = rng.integers(1, 4, size=(19, 10, 6)).astype(float)
        b = rng.integers(0, 3, size=(19, 10)).astype(float) * 2.0
        A[:, 5:], b[:, 5:] = A[:, :5], b[:, :5]
        c = rng.integers(1, 4, size=(19, 6)).astype(float)
        lp = random_lp_batch(rng, B=1, m=1, n=1).__class__.from_arrays(A, b, c)
    else:  # afiro: equality pairs, a negative row, canonical 35 x 32
        lp, _ = canonicalize(perturbed_batch(read_mps(fixture_path("afiro")),
                                             12, rng))
    return tuple(np.asarray(a, np.float32)
                 for a in (lp.A, lp.b, lp.c, lp.upper_bounds()))


def _port(arrays, pricing, fn=simplex_tile):
    A, b, c, ub = map(torch.from_numpy, arrays)
    _, m, n = A.shape
    out = fn(A, b, c, ub, m=m, n=n, max_iters=default_max_iters(m, n),
             tol=1e-6, feas_tol=1e-5, pricing=pricing)
    return [t.numpy() for t in out]


@pytest.mark.parametrize("pricing", ["dantzig", "steepest_edge", "devex"])
@pytest.mark.parametrize("case", ["phase1_12x10", "bounded_8x10",
                                  "degenerate_10x6", "afiro"])
def test_wrapper_matches_pallas_kernel(case, pricing):
    arrays = _arrays(case)
    _, m, n = arrays[0].shape
    ref = simplex_pallas(*map(jnp.asarray, arrays), m=m, n=n, tile_b=8,
                         max_iters=default_max_iters(m, n), tol=1e-6,
                         feas_tol=1e-5, interpret=True, pricing=pricing)
    ref = [np.asarray(a) for a in ref]
    port = _port(arrays, pricing)
    np.testing.assert_array_equal(port[2], ref[2])       # status
    np.testing.assert_array_equal(port[3], ref[3])       # iterations
    for i, name in ((0, "x"), (1, "objective"), (4, "y"), (5, "z")):
        np.testing.assert_allclose(port[i], ref[i], rtol=1e-5, atol=1e-5,
                                   equal_nan=True, err_msg=name)


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    arrays = _arrays("bounded_8x10")
    before = simplex_tile.launches
    got = _port(arrays, "devex")
    want = _port(arrays, "devex", fn=simplex_tile_plain)
    assert simplex_tile.launches == before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
