"""Wrapper of the CUDA simplex kernel (csrc/simplex_tile.cu) and its plain
PyTorch version.

Counterpart of ``repro.kernels.simplex_tile.simplex_pallas`` and its
``_simplex_kernel``: a whole two-phase bounded simplex per LP, one thread
block per LP, the tableau in shared memory.  The wrapper builds the tableau
on the device with torch ops (core/simplex.py ``build_tableau_torch``, as
the reference builds it outside its kernel), launches the kernel on the
current stream and returns ``(x, obj, status, iters, y, z)``.

On CPU tensors the wrapper runs the plain version, ``simplex_tile_plain``
(the port's engine, which computes the same function bit for bit); on CUDA
tensors it launches the kernel or raises.  ``simplex_tile.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.pricing import PRICING_RULES, canonicalize_rule
from ..core.simplex import build_tableau_torch, solve_two_phase
from . import _build

RULE_CODES = {rule: code for code, rule in enumerate(PRICING_RULES)}
# Per-LP work counters the kernel and the plain version report: pivots in
# phase 1 (full tableau), pivots in phase 2 (compacted view), bound flips.
WORK_COUNTERS = 3


def smem_bytes(m: int, n: int, rule: str = "dantzig", *,
               tableau: bool = True) -> int:
    """Dynamic shared memory of one block, with the tableau in shared
    memory or (``tableau=False``) left in device memory, as the kernel lays
    it out (csrc/simplex_tile.cu ``layout``).  Needs the built kernel."""
    return int(_lib().simplex_tile_smem_bytes(m, n, RULE_CODES[
        canonicalize_rule(rule)], int(tableau)))


def tableau_in_smem(m: int, n: int, rule: str = "dantzig") -> bool:
    """Whether the kernel keeps the tableau in shared memory on the current
    card.  Replaces the reference's VMEM tiling rule ``pick_tile_b``; the
    kernel's launcher makes the same choice.  Needs the built kernel and a
    card."""
    got = _lib().simplex_tile_tableau_in_smem(m, n, RULE_CODES[
        canonicalize_rule(rule)])
    if got < 0:
        raise RuntimeError(f"simplex_tile: CUDA error {-got}")
    return bool(got)


def block_threads(m: int, n: int) -> int:
    """Threads per block: about 32 tableau entries each, 128 to 1024."""
    entries = (m + 2) * (n + 2 * m + 1)
    return int(min(1024, max(128, -(-entries // 32 // 32) * 32)))


@functools.cache
def _lib():
    lib = _build.load("simplex_tile")
    lib.simplex_tile_launch.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.simplex_tile_launch.restype = ctypes.c_int
    lib.simplex_tile_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.simplex_tile_smem_bytes.restype = ctypes.c_longlong
    lib.simplex_tile_tableau_in_smem.argtypes = [ctypes.c_int] * 3
    lib.simplex_tile_tableau_in_smem.restype = ctypes.c_int
    return lib


def _check(A, b, c, ub, work, m, n):
    B = A.shape[0]
    want = {"A": (A, (B, m, n), torch.float32),
            "b": (b, (B, m), torch.float32),
            "c": (c, (B, n), torch.float32),
            "ub": (ub, (B, n), torch.float32)}
    if work is not None:
        want["work"] = (work, (B, WORK_COUNTERS), torch.int32)
    for name, (t, shape, dtype) in want.items():
        if t.device != A.device:
            raise ValueError(f"{name} is on {t.device}, A on {A.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    for name in ("ub", "work"):
        if name in want and not want[name][0].is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def simplex_tile(A, b, c, ub, *, m: int, n: int, max_iters: int,
                 tol: float = 1e-6, feas_tol: float = 1e-5,
                 pricing: str = "dantzig", work=None):
    """Solve a float32 batch with the CUDA kernel (the plain version on CPU
    tensors).  ``ub`` is the (B, n) bound vector, +inf where unbounded.
    ``pricing`` is dantzig, steepest_edge or devex.  Returns
    ``(x, obj, status, iters, y, z)`` on A's device; objectives and duals
    are NaN off OPTIMAL.  ``work``, a (B, 3) int32 tensor when given, is
    overwritten with each LP's phase-1 pivots, phase-2 pivots and bound
    flips.

    The kernel keeps an LP's tableau in shared memory when it fits
    (``tableau_in_smem``); otherwise it works on (and overwrites) the LP's
    slice of the device-memory tableau this function builds."""
    rule = canonicalize_rule(pricing)
    if rule not in RULE_CODES:
        raise ValueError(f"the tableau kernel prices with {PRICING_RULES}, "
                         f"not {pricing!r}")
    _check(A, b, c, ub, work, m, n)
    if A.device.type == "cpu":
        return simplex_tile_plain(A, b, c, ub, m=m, n=n, max_iters=max_iters,
                                  tol=tol, feas_tol=feas_tol, pricing=rule,
                                  work=work)
    if A.device.type != "cuda":
        raise ValueError(f"simplex_tile runs on cuda or cpu, not {A.device}")
    B = A.shape[0]
    T, basis, phase = build_tableau_torch(A, b, c)
    thr = (feas_tol * torch.clamp(T[:, m + 1, -1], min=1.0)).contiguous()
    opts = dict(dtype=torch.float32, device=A.device)
    x = torch.empty((B, n), **opts)
    obj = torch.empty((B,), **opts)
    y = torch.empty((B, m), **opts)
    z = torch.empty((B, n), **opts)
    status = torch.empty((B,), dtype=torch.int32, device=A.device)
    iters = torch.empty((B,), dtype=torch.int32, device=A.device)
    launch = _lib().simplex_tile_launch
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            T.data_ptr(), basis.data_ptr(), phase.data_ptr(), thr.data_ptr(),
            ub.data_ptr(), x.data_ptr(), obj.data_ptr(), status.data_ptr(),
            iters.data_ptr(), y.data_ptr(), z.data_ptr(),
            None if work is None else work.data_ptr(), B, m, n,
            int(max_iters), float(tol), RULE_CODES[rule], block_threads(m, n),
            stream)
    if rc != 0:
        raise RuntimeError(f"simplex_tile kernel launch failed: CUDA error {rc}")
    simplex_tile.launches += 1
    return x, obj, status.to(torch.int8), iters, y, z


simplex_tile.launches = 0


def simplex_tile_plain(A, b, c, ub, *, m: int, n: int, max_iters: int,
                       tol: float = 1e-6, feas_tol: float = 1e-5,
                       pricing: str = "dantzig", work=None):
    """The plain PyTorch version of the kernel: the port's engine on the
    same inputs, on any device."""
    return solve_two_phase(A, b, c, ub, m=m, n=n, max_iters=max_iters,
                           tol=tol, feas_tol=feas_tol, pricing=pricing,
                           work=work)
