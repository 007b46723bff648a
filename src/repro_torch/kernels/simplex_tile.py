"""Wrappers of the CUDA simplex kernels (csrc/simplex_tile.cu) and their
plain PyTorch versions.

``simplex_tile`` is the counterpart of
``repro.kernels.simplex_tile.simplex_pallas`` and its ``_simplex_kernel``: a
whole two-phase bounded simplex per LP, one thread block per LP, the tableau
in shared memory.  The wrapper builds the tableau on the device with torch
ops (core/simplex.py ``build_tableau_torch``, as the reference builds it
outside its kernel), launches the kernel on the current stream and returns
``(x, obj, status, iters, y, z)``.

``segment_tile`` is the counterpart of ``segment_pallas`` and its
``_segment_kernel``: one resumable segment of the compaction scheduler
(core/compaction.py) over a ``CompactionState``, at most ``steps`` steps
per LP, one thread block per LP.  Its stage "full" is the counterpart of
the reference's ``segment_combined`` (src/repro/core/compaction.py), which
the reference runs as XLA: the combined two-phase step on the full
tableau through both phases, for the frontier scheduler and the card's
warm tableau solves.  When the state carries counter lanes
(``state.tel``, ``telemetry=True``) they cross the kernel boundary as the
packed int32 row of ``obs.telemetry.tel_to_rows``, which the kernel's
counter-carrying instantiation updates in place (the float32 lanes pass
through), as ``segment_pallas(..., tel_int=)`` does.

On CPU tensors each wrapper runs its plain version (``simplex_tile_plain``,
``segment_tile_plain``: the port's engine, which computes the same function
bit for bit); on CUDA tensors it launches the kernel or raises.
``simplex_tile.launches`` and ``segment_tile.launches`` count kernel
launches, ``segment_tile.tel_launches`` those of them that carried
counters and ``segment_tile.full_launches`` those of stage full.

Given inputs with no data (meta tensors, ``device.is_fake``),
``simplex_tile`` takes the
card's path: it builds the tableau with the same torch ops and, in place
of the launch, returns fake outputs and charges one launch of the
whole-solve kernel: ``flops_per_pivot(m, n)`` (core/simplex.py) a pivot for
each of the B LPs, at the counter's ``default_trip`` pivots (the pivot
count depends on the data), and the bytes of the tableau state read and
written once, the bounds read and the outputs written once. The plain
version never runs on them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.compaction import TABLEAU_STAGES, CompactionState, run_segment
from ..core.pricing import PRICING_RULES, canonicalize_rule
from ..core.simplex import (build_tableau_torch, flops_per_pivot,
                            solve_two_phase)
from ..device import is_fake
from ..obs.telemetry import ALL_LANES, INT_LANES, rows_to_tel, tel_to_rows
from . import _build

RULE_CODES = {rule: code for code, rule in enumerate(PRICING_RULES)}
# Per-LP work counters the kernel and the plain version report: pivots in
# phase 1 (full tableau), pivots in phase 2 (compacted view), bound flips.
WORK_COUNTERS = 3


# Stages (csrc/simplex_tile.cu; the segment launcher's `stage` and the
# shared-memory accounting): the whole solve, a p1 segment (full state,
# live columns on chip and a pivot log), a p2 segment (compacted state), a
# full segment (the p1 layout, through both phases).
STAGE_CODES = {"whole": 0, "p1": 1, "p2": 2, "full": 3}
# Threads a block takes at most (csrc/simplex_tile.cu kMaxThreads).
MAX_THREADS = 256


def smem_bytes(m: int, n: int, rule: str = "dantzig", *,
               tableau: bool = True, stage: str = "whole") -> int:
    """Dynamic shared memory of one block, with the tableau's live columns
    in shared memory or (``tableau=False``) left in device memory, as the
    kernels lay it out (csrc/simplex_tile.cu ``layout``), for ``stage``
    "whole" (the whole solve), "p1" or "full" (a p1 or full segment, its
    pivot log at full size) or "p2" (a p2 segment).  Needs the built
    kernel."""
    return int(_lib().simplex_tile_smem_bytes(m, n, RULE_CODES[
        canonicalize_rule(rule)], int(tableau), STAGE_CODES[stage]))


def tableau_in_smem(m: int, n: int, rule: str = "dantzig", *,
                    stage: str = "whole") -> bool:
    """Whether the kernels keep that stage's tableau in shared memory on
    the current card (the ``shared`` variant; else ``device``).  Replaces
    the reference's VMEM tiling rule ``pick_tile_b``; the launchers make
    the same choice.  Needs the built kernel and a card."""
    got = _lib().simplex_tile_tableau_in_smem(m, n, RULE_CODES[
        canonicalize_rule(rule)], STAGE_CODES[stage])
    if got < 0:
        raise RuntimeError(f"simplex_tile: CUDA error {-got}")
    return bool(got)


def block_threads(m: int, n: int) -> int:
    """Threads per block: one a live column (the n+m structural and slack
    columns and the rhs), spread evenly over the fewest column groups of at
    most MAX_THREADS and rounded up to a warp."""
    cols = n + m + 1
    groups = -(-cols // MAX_THREADS)
    per_group = -(-cols // groups)
    return -(-per_group // 32) * 32


@functools.cache
def _lib():
    lib = _build.load("simplex_tile")
    lib.simplex_tile_launch.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.simplex_tile_launch.restype = ctypes.c_int
    lib.simplex_segment_launch.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.simplex_segment_launch.restype = ctypes.c_int
    lib.simplex_segment_tel_launch.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.simplex_segment_tel_launch.restype = ctypes.c_int
    lib.simplex_tile_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.simplex_tile_smem_bytes.restype = ctypes.c_longlong
    lib.simplex_tile_tableau_in_smem.argtypes = [ctypes.c_int] * 4
    lib.simplex_tile_tableau_in_smem.restype = ctypes.c_int
    return lib


def _check_leaves(want: dict, device, contiguous=()):
    """Raise unless every ``name: (tensor, shape, dtype)`` entry lies on
    ``device`` with that dtype and shape, and the named ones are
    contiguous."""
    for name, (t, shape, dtype) in want.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    for name in contiguous:
        if name in want and not want[name][0].is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def tel_leaves(tel, B: int) -> dict:
    """The ``_check_leaves`` entries of a state's counter lanes (none when
    ``tel`` is None): (B,) int32 and float32 lanes."""
    if tel is None:
        return {}
    return {f"tel.{name}": (getattr(tel, name), (B,),
                            torch.int32 if name in INT_LANES
                            else torch.float32) for name in ALL_LANES}


def _check(A, b, c, ub, work, m, n):
    B = A.shape[0]
    want = {"A": (A, (B, m, n), torch.float32),
            "b": (b, (B, m), torch.float32),
            "c": (c, (B, n), torch.float32),
            "ub": (ub, (B, n), torch.float32)}
    if work is not None:
        want["work"] = (work, (B, WORK_COUNTERS), torch.int32)
    _check_leaves(want, A.device, contiguous=("ub", "work"))


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
    fake = is_fake(A)
    if A.device.type == "cpu" and not fake:
        return simplex_tile_plain(A, b, c, ub, m=m, n=n, max_iters=max_iters,
                                  tol=tol, feas_tol=feas_tol, pricing=rule,
                                  work=work)
    if A.device.type != "cuda" and not fake:
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
    if fake:
        from ..analysis.op_cost import charge
        # the tableau, basis and phase read and written; ub and thr
        # read; x, obj, y, z, status and iters written
        state = 4 * (T.numel() + B * (m + 1))
        nbytes = 2 * state + 4 * B * (n + 1) + 4 * B * (2 * n + m + 3)
        charge("simplex_tile", trip_flops=flops_per_pivot(m, n) * B,
               nbytes=nbytes)
        return x, obj, status.to(torch.int8), iters, y, z
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


def _check_segment(state: CompactionState, stage: str, m: int, n: int,
                   rule: str):
    B = state.T.shape[0]
    rows, cols = ((m + 1, n + m + 1) if stage == "p2"
                  else (m + 2, n + 2 * m + 1))
    w_cols = n + m if rule != "dantzig" else state.w.shape[-1]
    f32, i32 = torch.float32, torch.int32
    want = {"T": (state.T, (B, rows, cols), f32),
            "basis": (state.basis, (B, m), i32),
            "phase": (state.phase, (B,), i32),
            "status": (state.status, (B,), i32),
            "iters": (state.iters, (B,), i32),
            "w": (state.w, (B, w_cols), f32),
            "flip": (state.flip, (B, n), torch.bool),
            "ub": (state.ub, (B, n), f32),
            "thr": (state.thr, (B,), f32),
            "work": (state.work, (B, WORK_COUNTERS), i32)}
    _check_leaves(want, state.T.device, contiguous=tuple(want))
    _check_leaves(tel_leaves(state.tel, B), state.T.device)


def segment_tile(state: CompactionState, steps: int, *, stage: str, m: int,
                 n: int, max_iters: int, tol: float = 1e-6,
                 pricing: str = "dantzig"):
    """One segment of ``stage`` ("p1": phase-1 steps on the full tableau,
    "p2": phase-2 steps on the compacted one, "full": both phases on the
    full tableau) with the CUDA kernel (the plain version on CPU tensors).
    Each LP takes at most ``steps`` steps, stops at its own ``max_iters``
    and, still running at that cap, is marked ITERATION_LIMIT.  Returns
    ``(state, it)`` with ``it`` the (B,) int32 steps each LP took.  Stage
    full carries no counters: a state with counter lanes raises there.

    On the card the kernel updates the state's tensors in place and the
    same tensors come back, with ``tel`` (when the state carries counter
    lanes) the column views of the packed row the counter-carrying
    instantiation updated; the plain version builds new ones."""
    rule = canonicalize_rule(pricing)
    if rule not in RULE_CODES:
        raise ValueError(f"the segment kernel prices with {PRICING_RULES}, "
                         f"not {pricing!r}")
    if stage not in TABLEAU_STAGES:
        raise ValueError(
            f"stage must be one of {TABLEAU_STAGES}, got {stage!r}")
    if stage == "full" and state.tel is not None:
        raise ValueError("segment_tile(stage='full') carries no counter "
                         "lanes; the frontier scheduler counts none")
    _check_segment(state, stage, m, n, rule)
    dev = state.T.device
    if dev.type == "cpu":
        return segment_tile_plain(state, steps, stage=stage, m=m, n=n,
                                  max_iters=max_iters, tol=tol, pricing=rule)
    if dev.type != "cuda":
        raise ValueError(f"segment_tile runs on cuda or cpu, not {dev}")
    B = state.T.shape[0]
    it = torch.empty((B,), dtype=torch.int32, device=dev)
    s = state
    rows = None if s.tel is None else tel_to_rows(s.tel)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (s.T.data_ptr(), s.basis.data_ptr(), s.w.data_ptr(),
                s.flip.data_ptr(), s.ub.data_ptr(), s.phase.data_ptr(),
                s.thr.data_ptr(), s.status.data_ptr(), s.iters.data_ptr(),
                s.work.data_ptr(), it.data_ptr())
        args = (B, m, n, STAGE_CODES[stage], int(steps), int(max_iters),
                float(tol), RULE_CODES[rule], block_threads(m, n), stream)
        if rows is None:
            rc = lib.simplex_segment_launch(*ptrs, *args)
        else:
            rc = lib.simplex_segment_tel_launch(*ptrs, rows[0].data_ptr(),
                                                *args)
    if rc != 0:
        raise RuntimeError(
            f"segment_tile kernel launch failed: CUDA error {rc}")
    segment_tile.launches += 1
    if stage == "full":
        segment_tile.full_launches += 1
    if rows is not None:
        segment_tile.tel_launches += 1
        state = state._replace(tel=rows_to_tel(*rows))
    return state, it


segment_tile.launches = 0
segment_tile.tel_launches = 0
segment_tile.full_launches = 0


def segment_tile_plain(state: CompactionState, steps: int, *, stage: str,
                       m: int, n: int, max_iters: int, tol: float = 1e-6,
                       pricing: str = "dantzig"):
    """The plain PyTorch version of one segment: the port's engine under
    the same per-LP stopping rule (core/compaction.py ``run_segment``), on
    any device."""
    return run_segment(state, steps, stage=stage, m=m, n=n,
                       max_iters=max_iters, tol=tol,
                       rule=canonicalize_rule(pricing))
