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

The backward (``ssm_scan_bwd_plain``, and ``ssm_scan`` as an autograd
function) is held bit for bit to ``jax.vjp`` through the same Pallas scan:
the reference's reverse loop carries its cotangent across the loop
boundary, so its CPU build rounds the add and both products separately,
and so does the plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ssm_scan_bt_ds as ref_scan_bt_ds
from repro.models.mamba import _chunk_scan as ref_chunk_scan
from repro_torch.core.fp import fma
from repro_torch.kernels import (ssm_scan, ssm_scan_bt_ds, ssm_scan_bwd,
                                  ssm_scan_bwd_plain, ssm_scan_plain)
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


# ---- the backward ------------------------------------------------------------

def _cotangents(B, T, d, s, seed=3):
    rng = np.random.default_rng(seed)
    g_hs = rng.normal(size=(B, T, d, s)).astype(np.float32)
    g_hT = rng.normal(size=(B, d, s)).astype(np.float32)
    return g_hs, g_hT


def _reference_vjp(dA, dBx, h0, g_hs, g_hT):
    _, vjp = jax.vjp(ref_scan_bt_ds, jnp.asarray(dA), jnp.asarray(dBx),
                     jnp.asarray(h0))
    return [np.asarray(a) for a in vjp((jnp.asarray(g_hs),
                                        jnp.asarray(g_hT)))]


def _sd(t):    # (B, [T,] d, s) <-> (B, [T,] s, d)
    return t.transpose(-1, -2).contiguous()


@pytest.mark.parametrize("B,T,d,s", SHAPES[:4])
@pytest.mark.parametrize("layout", ["bt_ds", "bt_sd"])
def test_plain_backward_is_bit_equal_to_the_reference_vjp(B, T, d, s,
                                                          layout):
    dA, dBx, h0 = _inputs(B, T, d, s)
    g_hs, g_hT = _cotangents(B, T, d, s)
    assert np.abs(g_hT).max() > 0
    want = _reference_vjp(dA, dBx, h0, g_hs, g_hT)
    t = [torch.from_numpy(a) for a in (dA, dBx, h0, g_hs, g_hT)]
    hs, _ = ssm_scan_plain(*t[:3])
    if layout == "bt_ds":
        got = ssm_scan_bwd_plain(t[0], hs, t[2], t[3], t[4])
    else:   # the kernel's (B, T, S, D) layout
        got = [_sd(g) for g in ssm_scan_bwd_plain(
            _sd(t[0]), _sd(hs), _sd(t[2]), _sd(t[3]), _sd(t[4]))]
    for name, g, w in zip(("ddA", "ddBx", "dh0"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_a_fused_carry_is_not_the_reference_backward():
    """Why the plain backward rounds each operation: a loop that fuses
    the carry ``dA_t * gh + g_{t-1}`` into one multiply-add differs from
    the reference's vjp."""
    dA, dBx, h0 = _inputs(2, 64, 130, 16)
    g_hs, g_hT = _cotangents(2, 64, 130, 16)
    want_ddA = _reference_vjp(dA, dBx, h0, g_hs, g_hT)[0]
    t = [torch.from_numpy(a) for a in (dA, dBx, h0, g_hs, g_hT)]
    hs, _ = ssm_scan_plain(*t[:3])
    ddA = torch.empty_like(t[0])
    gh = t[4] + t[3][:, -1]
    for i in range(63, -1, -1):
        ddA[:, i] = gh * (hs[:, i - 1] if i else t[2])
        if i:
            gh = fma(t[0][:, i], gh, t[3][:, i - 1])
    assert not np.array_equal(ddA.numpy(), want_ddA)
    got = ssm_scan_bwd_plain(t[0], hs, t[2], t[3], t[4])[0]
    np.testing.assert_array_equal(got.numpy(), want_ddA)


def _ref_loop(dA, dBx, h0):
    """The sequential scan of tests/test_ssm_kernel.py, in lax.scan."""
    def step(h, inp):
        a, b = inp
        h = a * h + b
        return h, h
    hT, hs = jax.lax.scan(step, h0, (jnp.moveaxis(dA, 1, 0),
                                     jnp.moveaxis(dBx, 1, 0)))
    return jnp.moveaxis(hs, 0, 1), hT


def test_autograd_matches_the_reference_gradients():
    """torch.autograd.grad through the port's scan against jax.grad
    through the reference's sequential loop, on the loss of
    tests/test_ssm_kernel.py (atol 1e-5, its bar)."""
    B, T, d, s = 2, 16, 24, 4
    dA, dBx, h0 = _inputs(B, T, d, s, seed=4)
    w = np.arange(1, T + 1, dtype=np.float32)[None, :, None, None]

    def loss(args):
        hs, hT = _ref_loop(*args)
        return (hs * w).sum() + (hT ** 2).sum()

    want = jax.grad(loss)(tuple(jnp.asarray(a) for a in (dA, dBx, h0)))
    t = [torch.from_numpy(a).requires_grad_() for a in (dA, dBx, h0)]
    hs, hT = ssm_scan_bt_ds(*t)
    got = torch.autograd.grad((hs * torch.from_numpy(w)).sum()
                              + (hT ** 2).sum(), t)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=0)


def test_autograd_runs_the_plain_backward_on_cpu_tensors():
    """The autograd function hands its saved (dA, hs, h0) and the
    cotangents to ``ssm_scan_bwd``, which runs the plain version on CPU
    tensors and counts no launch; an unused hT gets a zero cotangent."""
    dA, dBx, h0 = (torch.from_numpy(a) for a in _inputs(2, 9, 24, 4, 5))
    g_hs = torch.from_numpy(_cotangents(2, 9, 24, 4)[0])
    leaves = [t.clone().requires_grad_() for t in (dA, dBx, h0)]
    before = (ssm_scan.launches, ssm_scan_bwd.launches)
    hs, _ = ssm_scan_bt_ds(*leaves)
    # a transposed cotangent, as einsum's backward may hand over
    g_view = g_hs.transpose(1, 2).contiguous().transpose(1, 2)
    assert not g_view.is_contiguous()
    got = torch.autograd.grad(hs, leaves, g_view)
    assert (ssm_scan.launches, ssm_scan_bwd.launches) == before
    want = ssm_scan_bwd_plain(dA, ssm_scan_plain(dA, dBx, h0)[0], h0, g_hs,
                              torch.zeros_like(h0))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with torch.no_grad():
        hs_ng, _ = ssm_scan_bt_ds(*leaves)
    assert hs_ng.grad_fn is None and torch.equal(hs_ng, hs.detach())


def test_backward_of_an_empty_sequence_passes_g_hT_to_h0():
    dA, dBx, h0 = (torch.from_numpy(a) for a in _inputs(2, 0, 8, 2))
    g_hT = torch.from_numpy(_cotangents(2, 1, 8, 2)[1])
    ddA, ddBx, dh0 = ssm_scan_bwd(dA, dBx, h0, dBx, g_hT)
    assert ddA.shape == ddBx.shape == (2, 0, 8, 2)
    assert torch.equal(dh0, g_hT) and dh0.data_ptr() != g_hT.data_ptr()
