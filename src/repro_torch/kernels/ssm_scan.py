"""Wrapper of the CUDA selective-scan kernel (csrc/ssm_scan.cu) and its
plain PyTorch version.

Counterpart of ``repro.kernels.ssm_scan``: ``ssm_scan`` takes the kernel's
(B, T, S, D) layout and ``ssm_scan_bt_ds`` the model's (B, T, d, s); both
run the recurrence h_t = dA_t * h_{t-1} + dBx_t from h0 and return
(hs, hT).  The recurrence is elementwise over the last two axes, so one
kernel serves both layouts as B x L lanes, with no transpose and no
padding.

On CPU tensors the wrappers run ``ssm_scan_plain``; on CUDA tensors they
launch the kernel or raise.  Each step of both is one correctly rounded
fused multiply-add, the rounding of the reference's CPU build, so the two
agree bit for bit.  ``ssm_scan.launches`` counts kernel launches.

When an input requires grad, ``ssm_scan`` runs as a
``torch.autograd.Function``, the counterpart of the reference's
``custom_vjp``: the forward saves (dA, hs, h0), and the backward runs the
reverse recurrence of the cotangents through ``ssm_scan_bwd``, which
launches the backward kernel of the same source on CUDA tensors and runs
``ssm_scan_bwd_plain`` on CPU tensors.  The backward rounds its add and
both of its products separately, as the reference's does (its carry
crosses the loop boundary, so nothing is fused), and the kernel agrees
with the plain version bit for bit.  ``ssm_scan_bwd.launches`` counts
backward launches.

Inputs with no data (meta tensors, ``device.is_fake``) take the card's
path without a launch: the wrappers return fake outputs of the kernel's
shapes and charge one launch of the card's kernel to the dry run's
counter (``analysis/op_cost.py`` ``charge``, which refuses them when no
counter traces): 2 BTL operations and 4 (3 BTL + 2 BL) bytes forward, 3 BTL
operations and 4 (5 BTL + 3 BL) bytes backward (L = S D lanes), the
bounds of the kernel table. The plain version never runs on them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.fp import fma
from ..device import is_fake
from . import _build

THREADS = 256


@functools.cache
def _lib():
    lib = _build.load("ssm_scan")
    lib.ssm_scan_fwd_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_void_p])
    lib.ssm_scan_fwd_launch.restype = ctypes.c_int
    lib.ssm_scan_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_void_p])
    lib.ssm_scan_bwd_launch.restype = ctypes.c_int
    return lib


def _check(dA, dBx, h0, names=("dA", "dBx", "h0")):
    for name, t in zip(names, (dA, dBx, h0)):
        if t.device != dA.device:
            raise ValueError(f"{name} is on {t.device}, dA on {dA.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be torch.float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dA.dim() != 4:
        raise ValueError(f"dA must be 4-D, got shape {tuple(dA.shape)}")
    if dBx.shape != dA.shape:
        raise ValueError(f"{names[1]} has shape {tuple(dBx.shape)}, dA "
                         f"{tuple(dA.shape)}")
    want = (dA.shape[0],) + tuple(dA.shape[2:])
    if tuple(h0.shape) != want:
        raise ValueError(f"{names[2]} has shape {tuple(h0.shape)}, "
                         f"expected {want}")
    if dA.device.type not in ("cpu", "cuda") and not is_fake(dA):
        raise ValueError(f"ssm_scan runs on cuda or cpu, not {dA.device}")


def _lanes(dA):
    """(B, T, L) of a scan's (B, T, S, D) or (B, T, d, s) input."""
    return dA.shape[0], dA.shape[1], dA.shape[2] * dA.shape[3]


class _Scan(torch.autograd.Function):
    """The scan with its reverse recurrence as the backward (the
    reference's ``_fwd_rule`` / ``_bwd_rule``)."""

    @staticmethod
    def forward(ctx, dA, dBx, h0):
        hs, hT = _scan_fwd(dA, dBx, h0)
        ctx.save_for_backward(dA, hs, h0)
        ctx.set_materialize_grads(False)
        return hs, hT

    @staticmethod
    def backward(ctx, g_hs, g_hT):
        dA, hs, h0 = ctx.saved_tensors
        # einsum's backward need not hand over contiguous cotangents; an
        # unused output (hT of the last chunk) has none
        g_hs = torch.zeros_like(dA) if g_hs is None else g_hs.contiguous()
        g_hT = torch.zeros_like(h0) if g_hT is None else g_hT.contiguous()
        return ssm_scan_bwd(dA, hs, h0, g_hs, g_hT)


def ssm_scan(dA, dBx, h0):
    """dA, dBx: (B, T, S, D) float32; h0: (B, S, D) float32 ->
    (hs (B, T, S, D), hT (B, S, D)).  The kernel on CUDA tensors, the
    plain version on CPU tensors; differentiable when an input requires
    grad."""
    _check(dA, dBx, h0)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (dA, dBx, h0)):
        return _Scan.apply(dA, dBx, h0)
    return _scan_fwd(dA, dBx, h0)


def _scan_fwd(dA, dBx, h0):
    if is_fake(dA):
        from ..analysis.op_cost import charge
        B, T, L = _lanes(dA)
        charge("ssm_scan", flops=2 * B * T * L,
               nbytes=4 * (3 * B * T * L + 2 * B * L))
        return torch.empty_like(dA), torch.empty_like(h0)
    if dA.device.type == "cpu":
        return ssm_scan_plain(dA, dBx, h0)
    B, T = dA.shape[:2]
    L = dA.shape[2] * dA.shape[3]
    hs = torch.empty_like(dA)
    hT = torch.empty_like(h0)
    with torch.cuda.device(dA.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().ssm_scan_fwd_launch(
            dA.data_ptr(), dBx.data_ptr(), h0.data_ptr(), hs.data_ptr(),
            hT.data_ptr(), B, T, L, THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {rc}")
    ssm_scan.launches += 1
    return hs, hT


ssm_scan.launches = 0


def ssm_scan_bwd(dA, hs, h0, g_hs, g_hT):
    """The scan's backward: residuals dA, hs (B, T, S, D) and h0 (B, S, D),
    cotangents g_hs (of hs) and g_hT (of hT), all float32 and contiguous
    -> (ddA, ddBx (B, T, S, D), dh0 (B, S, D)).  The kernel on CUDA
    tensors, the plain version on CPU tensors; either layout."""
    _check(dA, hs, h0, ("dA", "hs", "h0"))
    _check(dA, g_hs, g_hT, ("dA", "g_hs", "g_hT"))
    if is_fake(dA):
        from ..analysis.op_cost import charge
        B, T, L = _lanes(dA)
        charge("ssm_scan_bwd", flops=3 * B * T * L,
               nbytes=4 * (5 * B * T * L + 3 * B * L))
        return (torch.empty_like(dA), torch.empty_like(dA),
                torch.empty_like(h0))
    if dA.device.type == "cpu":
        return ssm_scan_bwd_plain(dA, hs, h0, g_hs, g_hT)
    B, T = dA.shape[:2]
    L = dA.shape[2] * dA.shape[3]
    ddA = torch.empty_like(dA)
    ddBx = torch.empty_like(dA)
    dh0 = torch.empty_like(h0)
    with torch.cuda.device(dA.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().ssm_scan_bwd_launch(
            dA.data_ptr(), hs.data_ptr(), h0.data_ptr(), g_hs.data_ptr(),
            g_hT.data_ptr(), ddA.data_ptr(), ddBx.data_ptr(),
            dh0.data_ptr(), B, T, L, THREADS, stream)
    if rc != 0:
        raise RuntimeError(
            f"ssm_scan_bwd kernel launch failed: CUDA error {rc}")
    ssm_scan_bwd.launches += 1
    return ddA, ddBx, dh0


ssm_scan_bwd.launches = 0


def ssm_scan_bt_ds(dA, dBx, h0):
    """The model's layout: dA, dBx (B, T, d, s), h0 (B, d, s) float32 ->
    (hs (B, T, d, s), hT (B, d, s)).  The lanes are the same
    recurrence in another order, so this is ``ssm_scan`` as it is."""
    return ssm_scan(dA, dBx, h0)


def ssm_scan_plain(dA, dBx, h0):
    """The plain PyTorch version, on any device and in either layout: a
    loop over t of ``fma(dA_t, h, dBx_t)`` (core/fp.py), one rounding a
    step."""
    hs = torch.empty_like(dA)
    h = h0
    for t in range(dA.shape[1]):
        h = fma(dA[:, t], h, dBx[:, t])
        hs[:, t] = h
    return hs, h if dA.shape[1] else h0.clone()


def ssm_scan_bwd_plain(dA, hs, h0, g_hs, g_hT):
    """The plain PyTorch version of the backward, on any device and in
    either layout: the reverse loop t = T-1 .. 0 of ``gh = gh + g_t``,
    ``ddA_t = gh * h_{t-1}`` (h0 at t = 0), ``ddBx_t = gh``,
    ``gh = dA_t * gh`` from gh = g_hT, one rounding per operation;
    dh0 is the last gh."""
    ddA = torch.empty_like(dA)
    ddBx = torch.empty_like(dA)
    gh = g_hT
    for t in range(dA.shape[1] - 1, -1, -1):
        gh = gh + g_hs[:, t]
        ddA[:, t] = gh * (hs[:, t - 1] if t else h0)
        ddBx[:, t] = gh
        gh = dA[:, t] * gh
    return ddA, ddBx, gh if dA.shape[1] else g_hT.clone()
