"""The port's selective scan (repro_torch.kernels.ssm_scan) against the
reference's Pallas kernel in interpret mode.

Both packages get the same NumPy inputs.  The reference's CPU build
contracts each step ``dA * h + dBx`` into one fused multiply-add, and the
port's plain version rounds each step once the same way (core/fp.py
``fma``), so the two are compared bit for bit, in both of the port's
layouts.  The doubling scan of the "assoc" path reassociates the
recurrence, as the reference's ``associative_scan`` does in another order:
it is held to the reference's own bar between its two scans (atol 1e-6,
tests/test_ssm_kernel.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ssm_scan_bt_ds as ref_scan_bt_ds
from repro.models.mamba import _chunk_scan as ref_chunk_scan
from repro_torch.core.fp import fma
from repro_torch.kernels import ssm_scan, ssm_scan_bt_ds, ssm_scan_plain
from repro_torch.models.mamba import _chunk_scan

SHAPES = [(1, 8, 8, 2), (2, 16, 24, 4), (2, 33, 130, 16), (3, 7, 256, 16),
          (2, 64, 130, 16)]


def _inputs(B, T, d, s, seed=0):
    rng = np.random.default_rng(seed)
    dA = rng.uniform(0.5, 1.0, (B, T, d, s)).astype(np.float32)
    dBx = (rng.normal(size=(B, T, d, s)) * 0.1).astype(np.float32)
    h0 = (rng.normal(size=(B, d, s)) * 0.1).astype(np.float32)
    return dA, dBx, h0


def _reference(dA, dBx, h0):
    hs, hT = ref_scan_bt_ds(jnp.asarray(dA), jnp.asarray(dBx),
                            jnp.asarray(h0))
    return np.asarray(hs), np.asarray(hT)


@pytest.mark.parametrize("B,T,d,s", SHAPES)
@pytest.mark.parametrize("layout", ["bt_ds", "bt_sd"])
def test_plain_scan_is_bit_equal_to_the_reference_kernel(B, T, d, s, layout):
    dA, dBx, h0 = _inputs(B, T, d, s)
    hs_r, hT_r = _reference(dA, dBx, h0)
    t = [torch.from_numpy(a) for a in (dA, dBx, h0)]
    if layout == "bt_ds":
        hs, hT = ssm_scan_bt_ds(*t)
    else:   # the kernel's (B, T, S, D) layout through ssm_scan
        hs, hT = ssm_scan(t[0].transpose(-1, -2).contiguous(),
                          t[1].transpose(-1, -2).contiguous(),
                          t[2].transpose(-1, -2).contiguous())
        hs, hT = hs.transpose(-1, -2), hT.transpose(-1, -2)
    np.testing.assert_array_equal(hs.numpy(), hs_r)
    np.testing.assert_array_equal(hT.numpy(), hT_r)


def test_a_separately_rounded_step_is_not_the_reference():
    """Why the plain version uses ``fma``: ``dA * h + dBx`` rounded twice
    differs from the reference's scan."""
    dA, dBx, h0 = _inputs(2, 64, 130, 16)
    hs_r, _ = _reference(dA, dBx, h0)
    h = torch.from_numpy(h0)
    two = []
    for t in range(dA.shape[1]):
        h = torch.from_numpy(dA[:, t]) * h + torch.from_numpy(dBx[:, t])
        two.append(h)
    assert not np.array_equal(torch.stack(two, 1).numpy(), hs_r)
    one = fma(torch.from_numpy(dA[:, 0]), torch.from_numpy(h0),
              torch.from_numpy(dBx[:, 0]))
    np.testing.assert_array_equal(one.numpy(), hs_r[:, 0])


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    t = [torch.from_numpy(a) for a in _inputs(2, 9, 24, 4, seed=1)]
    before = ssm_scan.launches
    hs, hT = ssm_scan_bt_ds(*t)
    assert ssm_scan.launches == before
    want_hs, want_hT = ssm_scan_plain(*t)
    assert torch.equal(hs, want_hs) and torch.equal(hT, want_hT)
    assert torch.equal(hs[:, -1], hT)


def test_an_empty_sequence_returns_h0():
    dA, dBx, h0 = (torch.from_numpy(a) for a in _inputs(2, 0, 8, 2))
    hs, hT = ssm_scan_bt_ds(dA, dBx, h0)
    assert hs.shape == (2, 0, 8, 2) and torch.equal(hT, h0)
    assert hT.data_ptr() != h0.data_ptr()


@pytest.mark.parametrize("B,T,d,s", SHAPES[:4])
def test_doubling_scan_matches_the_reference_associative_scan(B, T, d, s):
    dA, dBx, h0 = _inputs(B, T, d, s, seed=2)
    hs_r, hT_r = jax.jit(ref_chunk_scan)(jnp.asarray(h0), jnp.asarray(dA),
                                         jnp.asarray(dBx))
    hs, hT = _chunk_scan(torch.from_numpy(h0), torch.from_numpy(dA),
                         torch.from_numpy(dBx))
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_r), atol=1e-6)
    np.testing.assert_allclose(hT.numpy(), np.asarray(hT_r), atol=1e-6)
    # and against the exact sequential scan
    hs_k, _ = ssm_scan_plain(torch.from_numpy(dA), torch.from_numpy(dBx),
                             torch.from_numpy(h0))
    np.testing.assert_allclose(hs.numpy(), hs_k.numpy(), atol=1e-6)
