"""Wrappers of the CUDA PDHG kernel (csrc/pdhg_tile.cu) and their plain
PyTorch versions.

``pdhg_tile`` is the counterpart of ``repro.kernels.pdhg_tile.pdhg_pallas``
and its ``_pdhg_kernel``: a whole restarted-PDHG solve per LP, one thread
block per LP, the Ruiz-scaled ``A`` in registers, shared memory or device
memory by shape (``variant``).  Setup (Ruiz
equilibration, the power iteration, warm injection) runs in torch on the
device (core/pdhg.py ``solve_pdhg``), as the reference runs it outside its
kernel; the launch runs every round and writes the extraction and the warm
capture.  Unlike the reference's tile kernel it starts from the injected
state, so ``warm=`` takes effect on this path too.

``pdhg_segment_tile`` is the counterpart of ``pdhg_segment_pallas`` and its
``_pdhg_segment_kernel``: at most ``steps`` fixed-step rounds per LP over a
``PdhgState``, resumable, for the compaction scheduler.  When the state
carries counter lanes (``state.tel``, ``telemetry=True``) they cross the
kernel boundary as the packed int32 and float32 rows of
``obs.telemetry.tel_to_rows``, which the kernel's counter-carrying
instantiation updates in place, as ``pdhg_segment_pallas`` carries
``tel_int`` and ``tel_f32``.  The whole-solve kernel has no counter plane.

On CPU tensors each wrapper runs its plain version (``pdhg_tile_plain``,
``pdhg_segment_tile_plain``: the engine's whole solve and segment, which
compute the same function bit for bit); on CUDA tensors it launches the
kernel or raises.  ``pdhg_tile.launches`` and ``pdhg_segment_tile.launches``
count kernel launches, ``pdhg_segment_tile.tel_launches`` the segment
launches that carried counters.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.pdhg import (
    CHECK_EVERY,
    DEFAULT_TOL,
    PdhgState,
    canonicalize_step_rule,
    run_and_extract,
    segment_pdhg,
    solve_pdhg,
)
from ..obs.telemetry import rows_to_tel, tel_to_rows
from . import _build
from .simplex_tile import _check_leaves, tel_leaves

MODES = {"segment": 0, "fixed": 1, "malitsky_pock": 2}
# The kernel's tree sums hold at most 16 terms a lane (csrc/pdhg_tile.cu).
MAX_DIM = 512
VARIANTS = ("registers", "shared", "device")
# The register shapes of csrc/pdhg_tile.cu (RegWarp, RegBlock): up to
# (rows, columns), threads a block.
REGISTER_SHAPES = ((64, 32, 32), (112, 112, 256))


def block_threads(m: int, n: int) -> int:
    """Threads per block of the variant that runs (m, n): a register
    shape's (32: one warp holds whole rows; 256: 16 x 16 threads), else
    the warp design's 256 (eight warps share the rows and columns of the
    matvecs), 128 for LPs with fewer than 64 rows and columns."""
    for rows, cols, threads in REGISTER_SHAPES:
        if m <= rows and n <= cols:
            return threads
    return 128 if max(m, n) < 64 else 256


@functools.cache
def _lib():
    lib = _build.load("pdhg_tile")
    lib.pdhg_launch.argtypes = (
        [ctypes.c_void_p] * 27 + [ctypes.c_int] * 6 + [ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.pdhg_launch.restype = ctypes.c_int
    lib.pdhg_segment_tel_launch.argtypes = (
        [ctypes.c_void_p] * 24 + [ctypes.c_int] * 6 + [ctypes.c_float]
        + [ctypes.c_int] + [ctypes.c_void_p])
    lib.pdhg_segment_tel_launch.restype = ctypes.c_int
    lib.pdhg_tile_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.pdhg_tile_smem_bytes.restype = ctypes.c_longlong
    for fn in (lib.pdhg_tile_variant, lib.pdhg_tile_threads):
        fn.argtypes = [ctypes.c_int] * 2
        fn.restype = ctypes.c_int
    return lib


def smem_bytes(m: int, n: int, *, a_smem: bool = True) -> int:
    """Dynamic shared memory of one block of the shared variant, or
    (``a_smem=False``) of the device variant.  Needs the built kernel."""
    return int(_lib().pdhg_tile_smem_bytes(m, n, int(a_smem)))


def variant(m: int, n: int) -> str:
    """The variant the kernel runs for (m, n) on the current card:
    ``"registers"`` (``A`` in registers, m, n <= 112), ``"shared"`` (``A``
    in shared memory: it fits, and m, n <= 256) or ``"device"``.  Needs the
    built kernel and a card."""
    got = _lib().pdhg_tile_variant(m, n)
    if got < 0:
        raise RuntimeError(f"pdhg_tile: CUDA error {-got}")
    return VARIANTS[got]


def _check_state(state: PdhgState, m: int, n: int):
    B = state.x.shape[0]
    f32, i32 = torch.float32, torch.int32
    want = {"A": (state.A, (B, m, n), f32), "b": (state.b, (B, m), f32),
            "c": (state.c, (B, n), f32), "rsc": (state.rsc, (B, m), f32),
            "csc": (state.csc, (B, n), f32), "ub": (state.ub, (B, n), f32),
            "eta": (state.eta, (B, 1), f32),
            "omega": (state.omega, (B, 1), f32),
            "binf": (state.binf, (B,), f32), "cinf": (state.cinf, (B,), f32),
            "x": (state.x, (B, n), f32), "y": (state.y, (B, m), f32),
            "xs": (state.xs, (B, n), f32), "ys": (state.ys, (B, m), f32),
            "xr": (state.xr, (B, n), f32), "yr": (state.yr, (B, m), f32),
            "cnt": (state.cnt, (B,), f32),
            "last_res": (state.last_res, (B,), f32),
            "prev_res": (state.prev_res, (B,), f32),
            "phase": (state.phase, (B,), i32),
            "status": (state.status, (B,), i32),
            "iters": (state.iters, (B,), i32)}
    _check_leaves(want, state.x.device, contiguous=tuple(want))
    _check_leaves(tel_leaves(state.tel, B), state.x.device)
    if max(m, n) > MAX_DIM:
        raise ValueError(f"pdhg_tile takes m, n <= {MAX_DIM}, got "
                         f"{m} x {n}")


def _launch(state: PdhgState, *, m: int, n: int, steps: int,
            max_rounds: int, tol: float, mode: str, it=None, out=(),
            rows=None):
    """One launch over ``state`` (updated in place), through the
    counter-carrying segment instantiation when ``rows`` (the packed
    counter rows, updated in place) are given; raises on a CUDA error of
    the launch."""
    dev = state.x.device
    if dev.type != "cuda":
        raise ValueError(f"pdhg_tile runs on cuda or cpu, not {dev}")
    s = state
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (ptr(s.A), ptr(s.b), ptr(s.c), ptr(s.rsc), ptr(s.csc),
                ptr(s.ub), ptr(s.eta), ptr(s.binf), ptr(s.cinf), ptr(s.x),
                ptr(s.y), ptr(s.xs), ptr(s.ys), ptr(s.xr), ptr(s.yr),
                ptr(s.cnt), ptr(s.last_res), ptr(s.prev_res), ptr(s.omega),
                ptr(s.status), ptr(s.iters), ptr(it))
        args = (s.x.shape[0], m, n, int(steps), int(max_rounds),
                CHECK_EVERY, float(tol))
        if rows is None:
            outs = tuple(ptr(t) for t in out) if out else (None,) * 5
            rc = lib.pdhg_launch(*ptrs, *outs, *args, MODES[mode],
                                 block_threads(m, n), stream)
        else:
            assert mode == "segment", mode
            rc = lib.pdhg_segment_tel_launch(*ptrs, ptr(rows[0]),
                                             ptr(rows[1]), *args,
                                             block_threads(m, n), stream)
    if rc != 0:
        raise RuntimeError(f"pdhg_tile kernel launch failed: CUDA error {rc}")


def pdhg_segment_tile(state: PdhgState, steps: int, *, m: int, n: int,
                      max_rounds: int, tol: float = DEFAULT_TOL):
    """At most ``steps`` fixed-step rounds of ``CHECK_EVERY`` iterations
    per LP with the CUDA kernel (the plain version on CPU tensors).  Each LP
    stops at its own cap ``max_rounds * CHECK_EVERY`` iterations and,
    still running there, is marked ITERATION_LIMIT.  Returns ``(state,
    it)`` with ``it`` the (B,) int32 rounds each LP ran.

    On the card the kernel updates the state's tensors in place and the
    same tensors come back, with ``tel`` (when the state carries counter
    lanes) the column views of the packed rows the counter-carrying
    instantiation updated; the plain version builds new ones."""
    _check_state(state, m, n)
    kw = dict(max_rounds=max_rounds, tol=tol)
    if state.x.device.type == "cpu":
        return pdhg_segment_tile_plain(state, steps, **kw)
    it = torch.empty_like(state.iters)
    rows = None if state.tel is None else tel_to_rows(state.tel)
    _launch(state, m=m, n=n, steps=steps, mode="segment", it=it, rows=rows,
            **kw)
    pdhg_segment_tile.launches += 1
    if rows is not None:
        pdhg_segment_tile.tel_launches += 1
        state = state._replace(tel=rows_to_tel(*rows))
    return state, it


pdhg_segment_tile.launches = 0
pdhg_segment_tile.tel_launches = 0


def pdhg_segment_tile_plain(state: PdhgState, steps: int, *,
                            max_rounds: int, tol: float = DEFAULT_TOL):
    """The plain PyTorch version of one segment: the engine's
    ``segment_pdhg``, on any device."""
    return segment_pdhg(state, steps, tol=tol, max_rounds=max_rounds)


def _run_kernel(state: PdhgState, rounds: int, *, tol: float,
                check_every: int, step_rule: str):
    """The whole solve's rounds and extraction as one kernel launch: the
    ``run`` of ``core.pdhg.solve_pdhg`` on the card, whose rounds are
    ``CHECK_EVERY`` iterations."""
    assert check_every == CHECK_EVERY, check_every
    B, m, n = state.A.shape
    _check_state(state, m, n)
    dev = state.x.device
    f32 = torch.float32
    xo = torch.empty((B, n), dtype=f32, device=dev)
    zo = torch.empty((B, n), dtype=f32, device=dev)
    obj = torch.empty((B,), dtype=f32, device=dev)
    yo = torch.empty((B, m), dtype=f32, device=dev)
    wy = torch.empty((B, m), dtype=f32, device=dev)
    _launch(state, m=m, n=n, steps=rounds, max_rounds=rounds, tol=tol,
            mode=step_rule,
            out=(xo, obj, yo, zo, wy))
    pdhg_tile.launches += 1
    return (xo, obj, state.status.to(torch.int8), state.iters, yo, zo, xo,
            wy, state.omega[:, 0], state.eta[:, 0])


def pdhg_tile(A, b, c, ub, *, m: int, n: int, max_iters: int,
              tol: float = DEFAULT_TOL, step_rule: str = "fixed",
              warm_x=None, warm_y=None, warm_omega=None):
    """Whole PDHG solve of a float32 batch through one launch of the kernel
    (its plain version on CPU tensors), after setup and warm injection in
    torch.  Returns ``(x, obj, status, iters, y, z, warm_x, warm_y, omega,
    eta)`` on A's device, as ``core.pdhg.solve_pdhg`` does."""
    canonicalize_step_rule(step_rule)
    kw = dict(m=m, n=n, max_iters=max_iters, tol=tol, step_rule=step_rule,
              warm_x=warm_x, warm_y=warm_y, warm_omega=warm_omega)
    if A.device.type == "cpu":
        return pdhg_tile_plain(A, b, c, ub, **kw)
    if A.device.type != "cuda":
        raise ValueError(f"pdhg_tile runs on cuda or cpu, not {A.device}")
    return solve_pdhg(A, b, c, ub, run=_run_kernel, **kw)


pdhg_tile.launches = 0


def pdhg_tile_plain(A, b, c, ub, *, m: int, n: int, max_iters: int,
                    tol: float = DEFAULT_TOL, step_rule: str = "fixed",
                    warm_x=None, warm_y=None, warm_omega=None):
    """The plain PyTorch version of the whole solve: the engine's
    ``solve_pdhg`` (rounds by ``run_and_extract``), on any device."""
    return solve_pdhg(A, b, c, ub, m=m, n=n, max_iters=max_iters, tol=tol,
                      step_rule=step_rule, warm_x=warm_x, warm_y=warm_y,
                      warm_omega=warm_omega, run=run_and_extract)
