"""Wrapper of the CUDA box-LP kernel (csrc/hyperbox.cu) and its plain
PyTorch version.

Counterpart of ``repro.kernels.hyperbox_kernel.hyperbox_pallas`` and its
``_hyperbox_kernel``: the support value sum_i d_i * (d_i < 0 ? lo_i : hi_i)
of each box along a direction, one thread per output.  Both forms of
core/hyperbox.py are taken: ``d`` with one row per box gives (B,), ``d``
with another row count K gives (B, K) with every direction applied to every
box, without materializing a (B*K, n) copy.

On CPU tensors the wrapper runs ``hyperbox_tile_plain``; on CUDA tensors it
launches the kernel or raises.  Both sum in index order with one rounding
per term, so they agree bit for bit.  ``hyperbox_tile.launches`` counts
kernel launches.
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
    lib = _build.load("hyperbox")
    lib.hyperbox_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4
        + [ctypes.c_void_p])
    lib.hyperbox_launch.restype = ctypes.c_int
    return lib


def _check(lo, hi, d):
    for name, t in (("lo", lo), ("hi", hi), ("d", d)):
        if t.device != lo.device:
            raise ValueError(f"{name} is on {t.device}, lo on {lo.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hi.shape != lo.shape:
        raise ValueError(f"hi has shape {tuple(hi.shape)}, lo "
                         f"{tuple(lo.shape)}")
    if d.shape[1] != lo.shape[1]:
        raise ValueError(f"d has shape {tuple(d.shape)}; its rows need "
                         f"{lo.shape[1]} entries")


def hyperbox_tile(lo, hi, d):
    """Support values of float32 boxes ``lo``, ``hi`` (B, n) along ``d``:
    (B, n) -> (B,), or (K, n) with K != B -> (B, K).  The kernel on CUDA
    tensors, the plain version on CPU tensors."""
    _check(lo, hi, d)
    if lo.device.type == "cpu":
        return hyperbox_tile_plain(lo, hi, d)
    if lo.device.type != "cuda":
        raise ValueError(f"hyperbox_tile runs on cuda or cpu, not "
                         f"{lo.device}")
    B, n = lo.shape
    shared = d.shape[0] != B
    K = d.shape[0] if shared else 1
    out = torch.empty((B, K) if shared else (B,), dtype=torch.float32,
                      device=lo.device)
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().hyperbox_launch(lo.data_ptr(), hi.data_ptr(),
                                    d.data_ptr(), out.data_ptr(), B, K, n,
                                    int(shared), THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"hyperbox_tile kernel launch failed: CUDA error "
                           f"{rc}")
    hyperbox_tile.launches += 1
    return out


hyperbox_tile.launches = 0


def hyperbox_tile_plain(lo, hi, d):
    """The plain PyTorch version, on any device: the same sum in index
    order, one rounding per term (core/fp.py ``fma``)."""
    if d.shape[0] != lo.shape[0]:
        lo, hi, d = lo[:, None, :], hi[:, None, :], d[None, :, :]
    shape = torch.broadcast_shapes(lo.shape[:-1], d.shape[:-1])
    acc = torch.zeros(shape, dtype=torch.float32, device=lo.device)
    for i in range(lo.shape[-1]):
        di = d[..., i]
        acc = fma(di, torch.where(di < 0, lo[..., i], hi[..., i]), acc)
    return acc
