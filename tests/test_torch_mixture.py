"""The port's ``optimal_mixture`` (``data/mixture.py``) against the
reference's: the source weights of a batch of LPs solved by the tableau
engine (its plain version on the CPU), equal to the reference's
``solve_batched_jax`` weights.  Every batch here holds at least two LPs:
the reference's engine builds a batch of one differently in the last bit
(ROADMAP queue 3)."""
import numpy as np
import pytest

from repro.data import optimal_mixture as ref_optimal_mixture
from repro_torch.data import optimal_mixture

S = 8


def _utilities(B, seed):
    return np.random.default_rng(seed).normal(size=(B, S))


@pytest.mark.parametrize("B,seed", [(2, 0), (64, 1), (257, 2)])
def test_weights_equal_the_reference(B, seed):
    """Positive floors make the start w = 0 infeasible, so every LP runs
    phase 1; the weights are the reference's bit for bit."""
    u = _utilities(B, seed)
    caps, floors = np.full(S, 0.3), np.full(S, 0.05)
    want = ref_optimal_mixture(u, caps, floors)
    got = optimal_mixture(u, caps, floors, device="cpu")
    assert got.shape == (B, S)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-12)
    assert (got >= 0.05 - 1e-7).all()     # w / sum(w) >= w >= floor


def test_rows_that_end_infeasible_fall_back_to_uniform():
    """Per-row floors: where they sum past 1 the LP is infeasible and the
    row is the uniform mixture, as in the reference."""
    u = _utilities(6, 3)
    caps = np.full((6, S), 0.4)
    floors = np.full((6, S), 0.05)
    floors[[1, 4]] = 0.2                    # 8 x 0.2 > 1
    want = ref_optimal_mixture(u, caps, floors)
    got = optimal_mixture(u, caps, floors, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[[1, 4]], np.full((2, S), 1.0 / S))
    assert not np.allclose(got[[0, 2, 3, 5]], 1.0 / S)


def test_one_row_is_the_row_of_a_batch():
    """A single (S,) row gives a (1, S) result equal to its row in a
    batch: the port's engine does not depend on the batch's size."""
    u = _utilities(3, 4)
    caps, floors = np.full(S, 0.3), np.full(S, 0.02)
    batch = optimal_mixture(u, caps, floors, device="cpu")
    for i in range(3):
        one = optimal_mixture(u[i], caps, floors, device="cpu")
        assert one.shape == (1, S)
        np.testing.assert_array_equal(one[0], batch[i])


def test_without_a_card_the_default_device_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(Exception, match="(?i)cuda|device"):
        optimal_mixture(_utilities(2, 5), np.full(S, 0.3), np.full(S, 0.0))
