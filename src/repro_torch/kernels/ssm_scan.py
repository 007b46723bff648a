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
agree bit for bit.  ``ssm_scan.launches`` counts kernel launches.  There
is no backward yet: an input that requires grad is refused (the training
slice, ROADMAP queue 2 item 7, adds the ``torch.autograd.Function``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.fp import fma
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
    return lib


def _check(dA, dBx, h0):
    if any(t.requires_grad for t in (dA, dBx, h0)):
        raise NotImplementedError(
            "ssm_scan has no backward yet: the training slice (ROADMAP "
            "queue 2 item 7) adds it; call it under torch.no_grad()")
    for name, t in (("dA", dA), ("dBx", dBx), ("h0", h0)):
        if t.device != dA.device:
            raise ValueError(f"{name} is on {t.device}, dA on {dA.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be torch.float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dA.dim() != 4:
        raise ValueError(f"dA must be 4-D, got shape {tuple(dA.shape)}")
    if dBx.shape != dA.shape:
        raise ValueError(f"dBx has shape {tuple(dBx.shape)}, dA "
                         f"{tuple(dA.shape)}")
    want = (dA.shape[0],) + tuple(dA.shape[2:])
    if tuple(h0.shape) != want:
        raise ValueError(f"h0 has shape {tuple(h0.shape)}, expected {want}")


def ssm_scan(dA, dBx, h0):
    """dA, dBx: (B, T, S, D) float32; h0: (B, S, D) float32 ->
    (hs (B, T, S, D), hT (B, S, D)).  The kernel on CUDA tensors, the
    plain version on CPU tensors."""
    _check(dA, dBx, h0)
    if dA.device.type == "cpu":
        return ssm_scan_plain(dA, dBx, h0)
    if dA.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu, not {dA.device}")
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
