"""Wrapper of the CUDA revised-simplex kernel (csrc/revised_tile.cu) and its
plain PyTorch version.

``revised_segment_tile`` is the counterpart of
``repro.kernels.revised_tile.revised_segment_pallas`` and its
``_revised_segment_kernel``: at most ``steps`` revised steps per LP over a
``RevisedState`` (core/revised.py), one thread block per LP, the basis
inverse refactorized in the block at its first step and every
``refactor_period`` pivots.  ``revised_tile`` is the counterpart of
``revised_pallas``: a whole solve as one launch of stage p2 with
``max_iters`` steps, between the state build (and warm injection) and the
extraction in torch.  When the state carries counter lanes (``state.tel``,
``telemetry=True``) they cross the kernel boundary as the packed int32 row
of ``obs.telemetry.tel_to_rows``, which the kernel's counter-carrying
instantiation updates in place (the float32 lanes pass through), so the
revised backend counts with or without the compaction scheduler.

On CPU tensors the wrapper runs its plain version
(``revised_segment_tile_plain``: the engine's segment, which computes the
same function bit for bit); on CUDA tensors it launches the kernel or
raises.  ``revised_segment_tile.launches`` counts kernel launches,
``revised_segment_tile.tel_launches`` those of them that carried counters.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.compaction import STAGES
from ..core.revised import (
    REVISED_RULES,
    WORK_FIELDS,
    RevisedState,
    canonicalize_revised_rule,
    revised_segment,
    solve_revised,
)
from ..obs.telemetry import rows_to_tel, tel_to_rows
from . import _build
from .simplex_tile import _check_leaves, tel_leaves

RULE_CODES = {rule: code for code, rule in enumerate(REVISED_RULES)}
# Where the kernel keeps A and the Gauss-Jordan workspace (index = the C
# code of revised_tile_variant).
VARIANTS = ("shared", "device")
MAX_THREADS = 384


def block_threads(m: int, n: int) -> int:
    """Threads per block: one per candidate column, rounded up to a warp,
    at most 384."""
    return int(min(MAX_THREADS, -(-(n + m) // 32) * 32))


def _bind(lib):
    """Declares the C signatures of a revised_tile build's exports."""
    lib.revised_segment_launch.argtypes = (
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.revised_segment_launch.restype = ctypes.c_int
    lib.revised_segment_tel_launch.argtypes = (
        [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.revised_segment_tel_launch.restype = ctypes.c_int
    lib.revised_tile_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.revised_tile_smem_bytes.restype = ctypes.c_longlong
    lib.revised_tile_workspace_floats.argtypes = [ctypes.c_int]
    lib.revised_tile_workspace_floats.restype = ctypes.c_longlong
    lib.revised_tile_variant.argtypes = [ctypes.c_int] * 3
    lib.revised_tile_variant.restype = ctypes.c_int
    return lib


@functools.cache
def _lib():
    return _bind(_build.load("revised_tile"))


def smem_bytes(m: int, n: int, *, workspace: bool = True) -> int:
    """Dynamic shared memory of one block: the vectors and, with
    ``workspace`` (the shared variant), the scratch, A's region (which the
    Gauss-Jordan left half reuses) and the basis inverse.  The kernel's
    own accounting; needs the built kernel."""
    return int(_lib().revised_tile_smem_bytes(m, n, int(workspace)))


def workspace_floats(m: int) -> int:
    """Floats of device-memory workspace an LP of the device variant
    needs: the Gauss-Jordan left half, the basis inverse and the scratch.
    The kernel's own accounting; needs the built kernel."""
    return int(_lib().revised_tile_workspace_floats(m))


def variant(m: int, n: int, *, tel: bool = False) -> str:
    """The variant the kernel runs at (m, n) on the current card: "shared"
    (A and the workspace in shared memory) or "device"; with ``tel``, the
    counter-carrying instantiation's, whose counter slot takes 64 bytes of
    the block's shared memory.  Needs the built kernel and a card."""
    got = _lib().revised_tile_variant(m, n, int(tel))
    if got < 0:
        raise RuntimeError(f"revised_tile: CUDA error {-got}")
    return VARIANTS[got]


def _check_state(state: RevisedState, m: int, n: int):
    B = state.xB.shape[0]
    f32, i32 = torch.float32, torch.int32
    want = {"Abar": (state.Abar, (B, m, n + 2 * m), f32),
            "cvec": (state.cvec, (B, n + m), f32),
            "ub": (state.ub, (B, n), f32),
            "thr": (state.thr, (B,), f32),
            "xB": (state.xB, (B, m), f32),
            "basis": (state.basis, (B, m), i32),
            "onub": (state.onub, (B, n), torch.bool),
            "phase": (state.phase, (B,), i32),
            "status": (state.status, (B,), i32),
            "iters": (state.iters, (B,), i32),
            "y": (state.y, (B, m), f32),
            "work": (state.work, (B, len(WORK_FIELDS)), i32)}
    _check_leaves(want, state.xB.device, contiguous=tuple(want))
    _check_leaves(tel_leaves(state.tel, B), state.xB.device)


def revised_segment_tile(state: RevisedState, steps: int, *, stage: str,
                         m: int, n: int, max_iters: int, tol: float = 1e-6,
                         refactor_period: int, rule: str = "dantzig"):
    """One segment of ``stage`` ("p1": LPs in phase 1, "p2": every running
    LP) with the CUDA kernel (the plain version on CPU tensors).  Each LP
    takes at most ``steps`` steps, stops at its own ``max_iters`` and, still
    running at that cap, is marked ITERATION_LIMIT.  Returns
    ``(state, it)`` with ``it`` the (B,) int32 steps each LP took.

    On the card the kernel updates the state's tensors in place and the
    same tensors come back, with ``tel`` (when the state carries counter
    lanes) the column views of the packed row the counter-carrying
    instantiation updated; the plain version builds new ones."""
    rule = canonicalize_revised_rule(rule)
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    _check_state(state, m, n)
    dev = state.xB.device
    kw = dict(stage=stage, m=m, n=n, max_iters=max_iters, tol=tol,
              refactor_period=refactor_period, rule=rule)
    if dev.type == "cpu":
        return revised_segment_tile_plain(state, steps, **kw)
    if dev.type != "cuda":
        raise ValueError(f"revised_segment_tile runs on cuda or cpu, not "
                         f"{dev}")
    B = state.xB.shape[0]
    it = torch.empty((B,), dtype=torch.int32, device=dev)
    lib = _lib()
    s = state
    rows = None if s.tel is None else tel_to_rows(s.tel)
    ws = None
    with torch.cuda.device(dev):
        if variant(m, n, tel=rows is not None) == "device":
            ws = torch.empty((B, workspace_floats(m)), dtype=torch.float32,
                             device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (s.Abar.data_ptr(), s.cvec.data_ptr(), s.ub.data_ptr(),
                s.thr.data_ptr(), s.xB.data_ptr(), s.basis.data_ptr(),
                s.onub.data_ptr(), s.phase.data_ptr(), s.status.data_ptr(),
                s.iters.data_ptr(), s.y.data_ptr(), s.work.data_ptr(),
                it.data_ptr(), None if ws is None else ws.data_ptr())
        args = (B, m, n, int(stage == "p1"), int(steps), int(max_iters),
                float(tol), int(refactor_period), RULE_CODES[rule],
                block_threads(m, n), stream)
        if rows is None:
            rc = lib.revised_segment_launch(*ptrs, *args)
        else:
            rc = lib.revised_segment_tel_launch(*ptrs, rows[0].data_ptr(),
                                                *args)
    if rc != 0:
        raise RuntimeError(
            f"revised_segment_tile kernel launch failed: CUDA error {rc}")
    revised_segment_tile.launches += 1
    if rows is not None:
        revised_segment_tile.tel_launches += 1
        state = state._replace(tel=rows_to_tel(*rows))
    return state, it


revised_segment_tile.launches = 0
revised_segment_tile.tel_launches = 0


def revised_segment_tile_plain(state: RevisedState, steps: int, *,
                               stage: str, m: int, n: int, max_iters: int,
                               tol: float = 1e-6, refactor_period: int,
                               rule: str = "dantzig"):
    """The plain PyTorch version of one segment: the engine's
    ``revised_segment``, on any device."""
    return revised_segment(state, steps, stage=stage, m=m, n=n,
                           max_iters=max_iters, tol=tol,
                           refactor_period=refactor_period,
                           rule=canonicalize_revised_rule(rule))


def revised_tile(A, b, c, ub, *, m: int, n: int, max_iters: int,
                 tol: float = 1e-6, feas_tol: float = 1e-5,
                 refactor_period: int, pricing: str = "dantzig",
                 warm_basis=None, warm_at_upper=None, work=None,
                 telemetry: bool = False):
    """Whole revised solve of a float32 batch through one launch of the
    kernel (its plain version on CPU tensors).  ``warm_basis`` (B, m) and
    ``warm_at_upper`` (B, n) seed it from a parent basis.  Returns
    ``(x, obj, status, iters, y, z, basis, onub)`` on A's device, and the
    ``TelemetryState`` after them when ``telemetry``; ``work``, a (B, 5)
    int32 tensor when given, receives the per-LP counts of
    ``core.revised.WORK_FIELDS``."""
    return solve_revised(A, b, c, ub, m=m, n=n, max_iters=max_iters, tol=tol,
                         feas_tol=feas_tol, refactor_period=refactor_period,
                         pricing=pricing, warm_basis=warm_basis,
                         warm_at_upper=warm_at_upper,
                         segment=revised_segment_tile, work=work,
                         telemetry=telemetry)
