"""The port's MoE capacity router against ``repro.core.lp_router``.

``expert_capacity_lp`` on CPU tensors (the whole-solve kernel's plain
version) is bit-equal to the reference's at G >= 2 token groups (the
reference's batch-of-one build differs in the last bit, ROADMAP queue 3,
so G = 1 is held against the same row of a G = 2 reference batch), at the
expert counts of llama4-scout-17b-a16e (16) and deepseek-v2-236b (160).
The allocation properties of the reference's tests hold (budget, ceiling,
demand, the hot expert), and a group whose LP does not end OPTIMAL gets
the uniform capacity.  The card's run is held against the CPU's in
tests/test_torch_package.py (marker ``gpu``) and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import expert_capacity_lp as ref_capacity
from repro_torch.core import expert_capacity_lp
from repro_torch.kernels import simplex_tile


def _ref(d, total, c_max):
    return np.asarray(ref_capacity(jnp.asarray(d), total_slots=total,
                                   c_max=c_max))


def _demand(seed, G, E, hi=50.0):
    return np.random.default_rng(seed).uniform(0, hi, (G, E)).astype(
        np.float32)


@pytest.mark.parametrize("G,E", [(2, 16), (64, 16), (3, 160), (32, 160)])
@pytest.mark.parametrize("total,c_max", [(128.0, 32.0), (16.0, 12.0),
                                         (4000.0, 30.0)])
def test_bit_equal_to_the_reference(G, E, total, c_max):
    d = _demand(G * E, G, E)
    before = simplex_tile.launches
    got = expert_capacity_lp(torch.from_numpy(d), total, c_max)
    assert simplex_tile.launches == before   # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (G, E)
    assert not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), _ref(d, total, c_max))


@pytest.mark.parametrize("E", [16, 160])
def test_one_group_equals_its_row_of_a_two_group_batch(E):
    d = _demand(E, 2, E)
    got = expert_capacity_lp(torch.from_numpy(d[:1]), 128.0, 32.0)
    np.testing.assert_array_equal(got.numpy()[0], _ref(d, 128.0, 32.0)[0])


def test_budget_ceiling_and_demand():
    d = _demand(0, 3, 8)
    caps = expert_capacity_lp(torch.from_numpy(d), 128.0, 32.0).numpy()
    assert caps.shape == (3, 8)
    assert (caps <= 32.0 + 1e-3).all()
    assert (caps.sum(-1) <= 128.0 + 1e-2).all()
    assert (caps <= d + 1e-3).all()


def test_hot_expert_gets_more():
    d = np.array([[100.0, 1.0, 1.0, 1.0]], np.float32)
    caps = expert_capacity_lp(torch.from_numpy(d), 16.0, 12.0).numpy()
    assert caps[0, 0] >= 11.9   # the hot expert saturates its ceiling
    assert caps[0, 0] > caps[0, 1]


def test_gradient_does_not_flow():
    d = torch.from_numpy(_demand(1, 2, 8)).requires_grad_(True)
    caps = expert_capacity_lp(d, 20.0, 6.0)
    assert not caps.requires_grad and caps.grad_fn is None


def test_unsolved_groups_take_the_uniform_capacity():
    """NaN demand leaves a group's LP without an OPTIMAL end; that group
    gets min(total / E, c_max), the others their LP allocation, in both
    packages."""
    d = _demand(2, 4, 8)
    d[1, 3] = np.nan
    got = expert_capacity_lp(torch.from_numpy(d), 40.0, 3.0).numpy()
    want = _ref(d, 40.0, 3.0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], np.full(8, min(40.0 / 8, 3.0),
                                                  np.float32))
    ok = np.ones(4, bool)
    ok[1] = False
    np.testing.assert_array_equal(
        got[ok], expert_capacity_lp(torch.from_numpy(d[ok]), 40.0,
                                    3.0).numpy())
