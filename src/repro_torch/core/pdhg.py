"""Batched restarted PDHG in PyTorch: the port's first-order engine and the
plain version of the CUDA kernels (kernels/csrc/pdhg_tile.cu).

Counterpart of ``repro.core.pdhg``.  The LP is the canonical

    maximize c.x   s.t.   A x <= b,  0 <= x <= ub   (core/lp.py standard form)

with dual  min b.y + u.w  s.t.  A^T y + w >= c,  y, w >= 0.  One PDHG
iteration is

    x+ = clip(x + tau * (c - A^T y), 0, ub)
    y+ = max(0, y + sigma * (A (2 x+ - x) - b))

and a *round* is ``check_every`` iterations followed by the check: the KKT
residual of the current and of the averaged iterate picks the candidate,
``res <= tol`` converges, approximate Farkas rays on the pre-adoption
iterates certify INFEASIBLE or UNBOUNDED, sufficient or necessary decay of
the residual restarts from the candidate, and at a restart the primal
weight omega moves halfway (in log space) toward the observed dual/primal
displacement ratio.  Setup is Ruiz equilibration and a power iteration for
the step size, as torch ops on the batch's device (the reference runs them
outside its kernel, as jitted XLA).  ``step_rule="malitsky_pock"`` replaces
the fixed step by a per-iteration dual linesearch (``pdhg_round_mp``).

**Every sum goes through one fixed order**, the kernels' own
(``core.fp.tree_sum``): products rounded once, the terms zero-padded to a
power of two and halved pairwise.  That covers both matvecs, ``c.x``,
``b.y``, the ``ub.zc`` term, every norm, and the power iteration and warm
injection at setup.  Maxima and minima are exact and need no order; square
roots round correctly (``core.fp.sqrt_rn``); the omega update takes its
logarithms and exponential in float64, as the kernel does.  No product
goes through a matrix multiply, so TF32 never applies.  Hence the engine
is the plain version of the kernels bit for bit, and each LP's result
depends only on its own data: chunked solves equal unchunked ones, and a
permuted batch gives every LP the same result.  Against the reference,
which lets XLA order its sums, results agree to the tolerance: statuses
equal, objectives within 1e-3 relative (the reference's own contract
between two executors of PDHG, ``XTOL`` in its tests).

**The round budget is per LP**: an LP runs a round while it is running and
its own ``iters`` is below ``rounds * check_every``, and a segment marks an
LP still running at that cap ITERATION_LIMIT.  A running LP has run every
round so far, so this equals the reference's shared round counter.  A
terminal LP changes nothing, ``prev_res`` included (the reference keeps
overwriting that leaf of terminal LPs, which never read it again).

``PdhgBackend`` runs the engine's segments under the compaction scheduler
(core/compaction.py): one scheduler step is one round, there is no phase
1, and gathers change no LP's iterates, so ``compaction=True`` equals the
whole solve bit for bit.
"""
from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..obs.telemetry import TelemetryState, init_telemetry, tel_pdhg_update
from ..obs.trace import maybe_span
from .compaction import (
    SegmentStat,
    TorchBackend,
    run_schedule,
)
from .forms import ensure_canonical, finish_result, prepare_warm
from .fp import sqrt_rn, tree_sum
from .lp import (
    INFEASIBLE,
    ITERATION_LIMIT,
    OPTIMAL,
    UNBOUNDED,
    LPBatch,
    LPResult,
    WarmStart,
)
from .simplex import batch_tensors, solve_report

_RUNNING = -1

# Restart policy (PDLP): restart on sufficient decay of the candidate's KKT
# residual relative to the one at the last restart, or on necessary decay
# once the candidate has started regressing.
RESTART_SUFFICIENT = 0.2
RESTART_NECESSARY = 0.9
# Adaptive primal weight: at each restart omega moves this far (in log
# space) toward the dual/primal displacement ratio, within its bounds.
OMEGA_SMOOTHING = 0.5
OMEGA_MIN, OMEGA_MAX = 1e-4, 1e4
# Ruiz equilibration sweeps / power-iteration steps at setup.
RUIZ_ITERS = 10
POWER_ITERS = 40
# Safety factor on the spectral-norm bound: tau*sigma*||A||^2 = 0.9^2 < 1.
STEP_SAFETY = 0.9
# Iterations per round; iteration counts are quantized to it.
CHECK_EVERY = 16
# Farkas-ray classification: relative certificate tolerance, and the least
# normalized iterate magnitude before a ray is considered.
CERT_TOL = 1e-4
RAY_MIN_NORM = 1.0
# Malitsky-Pock linesearch: a dual trial step at tau_t is accepted when
# sqrt(beta) * tau_t * ||A^T y_t - A^T y|| <= MP_DELTA * ||y_t - y||
# (beta = omega^2); a rejection shrinks tau_t by MP_MU, and after MP_TRIALS
# rejections the iteration takes the fixed step.
MP_DELTA = 0.99
MP_MU = 0.7
MP_TRIALS = 6

STEP_RULES = ("fixed", "malitsky_pock")
DEFAULT_TOL = 1e-5   # the reference's float32 default


def default_pdhg_max_iters(m: int, n: int) -> int:
    """Iteration cap of the first-order engine (the reference's): PDHG
    needs thousands of cheap iterations where the simplex needs tens of
    pivots; the cap only bounds pathological members."""
    return 200 * (m + n) + 30000


def pdhg_elements(m: int, n: int) -> int:
    """State elements touched per iteration: the two matvecs read the
    (m, n) data twice and write the four length-m/n vectors."""
    return 2 * m * n + 2 * (m + n)


def pdhg_bytes_per_lp(m: int, n: int) -> int:
    """Peak device bytes one LP needs on the pdhg path, for Eq. (5): the
    setup's, which holds the input ``A``, its scaled copy and one tree
    matvec (core/fp.py ``tree_sum``: the (m, n) products, their copy
    zero-padded to a power of two along the summed dim, and its first
    half-sum), beside the state's vectors.  A survivor gather of the
    scheduler holds two copies of the state (2mn and the vectors), less
    than that."""
    pm, pn = (1 << max(0, k - 1).bit_length() for k in (m, n))
    tree = max(m * pn, pm * n) * 3 // 2
    return 4 * (3 * m * n + tree + 6 * m + 8 * n + 16)


def pdhg_rounds(max_iters: int, check_every: int = CHECK_EVERY) -> int:
    """The per-LP round budget of an iteration cap (rounded up)."""
    return -(-int(max_iters) // int(check_every))


def canonicalize_step_rule(step_rule: str) -> str:
    if step_rule not in STEP_RULES:
        raise ValueError(f"unknown step_rule {step_rule!r}: expected "
                         "'fixed' or 'malitsky_pock'")
    return step_rule


class PdhgState(NamedTuple):
    """Resumable solver state; every leaf has the batch on axis 0, so a
    bucket gather is one ``index_select`` per leaf.  The problem data
    rides in the state because gathers must move it with the iterates."""
    A: torch.Tensor        # (B, m, n) Ruiz-scaled data, or under the sparse
                           #  matvecs (core/sparse.py) the (B, nnz) values
    b: torch.Tensor        # (B, m) scaled rhs
    c: torch.Tensor        # (B, n) scaled objective
    rsc: torch.Tensor      # (B, m) row scales
    csc: torch.Tensor      # (B, n) column scales
    ub: torch.Tensor       # (B, n) scaled upper bounds, +inf where free
    eta: torch.Tensor      # (B, 1) base step: tau * sigma = eta^2
    omega: torch.Tensor    # (B, 1) primal weight: tau = eta / omega
    binf: torch.Tensor     # (B,) unscaled ||b||_inf
    cinf: torch.Tensor     # (B,) unscaled ||c||_inf
    x: torch.Tensor        # (B, n) primal iterate (scaled space)
    y: torch.Tensor        # (B, m) dual iterate
    xs: torch.Tensor       # (B, n) running primal sum since the last restart
    ys: torch.Tensor       # (B, m) running dual sum
    xr: torch.Tensor       # (B, n) last-restart anchor
    yr: torch.Tensor       # (B, m) last-restart anchor
    cnt: torch.Tensor      # (B,) f32 iterations in the running average
    last_res: torch.Tensor  # (B,) KKT residual at the last restart
    prev_res: torch.Tensor  # (B,) candidate residual at the previous check
    phase: torch.Tensor    # (B,) int32, constant 2 (no phase 1)
    status: torch.Tensor   # (B,) int32, _RUNNING until terminal
    iters: torch.Tensor    # (B,) int32
    tel: Optional[TelemetryState] = None  # counter lanes, or None with
                                          #  telemetry off


class Matvecs(NamedTuple):
    """The two matvecs PDHG is made of.  ``data`` is ``PdhgState.A``: the
    dense (B, m, n) array here, a (B, nnz) value array in core/sparse.py,
    so one round, check and certificate serve both storage formats."""
    ax: Callable    # (data, x: (B, n)) -> (B, m)
    aty: Callable   # (data, y: (B, m)) -> (B, n)


def dense_ax(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A x`` per LP: row i is ``tree_sum_j A[i, j] * x[j]``."""
    return tree_sum(A * x[:, None, :], 2)


def dense_aty(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``A^T y`` per LP: column j is ``tree_sum_i A[i, j] * y[i]``."""
    return tree_sum(A * y[:, :, None], 1)


DENSE_MV = Matvecs(ax=dense_ax, aty=dense_aty)


def norm2(v: torch.Tensor) -> torch.Tensor:
    """Per-LP Euclidean norm over dim 1: ``sqrt(tree_sum(v * v))``."""
    return sqrt_rn(tree_sum(v * v, 1))


def clip(v: torch.Tensor, ub: torch.Tensor) -> torch.Tensor:
    """The prox of the [0, ub] indicator (``jnp.clip(v, 0, ub)``)."""
    return torch.minimum(torch.clamp(v, min=0.0), ub)


# ---------------------------------------------------------------------------
# Setup: equilibration and step sizes
# ---------------------------------------------------------------------------

def ruiz_equilibrate(A: torch.Tensor, iters: int = RUIZ_ITERS):
    """Batched Ruiz (inf-norm) equilibration: ``(r, s)`` with ``r[:, :,
    None] * A * s[:, None, :]`` of about unit row and column inf-norms.
    All-zero rows and columns keep scale 1."""
    B, m, n = A.shape
    absA = A.abs()
    r = torch.ones((B, m), dtype=A.dtype, device=A.device)
    s = torch.ones((B, n), dtype=A.dtype, device=A.device)
    one = torch.ones((), dtype=A.dtype, device=A.device)
    for _ in range(iters):
        rn = (absA * r[:, :, None] * s[:, None, :]).amax(dim=2)
        r = r / sqrt_rn(torch.where(rn > 0, rn, one))
        cn = (absA * r[:, :, None] * s[:, None, :]).amax(dim=1)
        s = s / sqrt_rn(torch.where(cn > 0, cn, one))
    return r, s


def power_sigma_max(data: torch.Tensor, n: int, mv: Matvecs = DENSE_MV,
                    iters: int = POWER_ITERS) -> torch.Tensor:
    """Batched power iteration on A^T A: the per-LP spectral-norm
    estimate ||A||_2, floored at 1e-12 for all-zero members."""
    B = data.shape[0]
    v = torch.full((B, n), 1.0 / np.sqrt(n), dtype=torch.float32,
                   device=data.device)
    one = torch.ones((), dtype=torch.float32, device=data.device)
    for _ in range(iters):
        w = mv.aty(data, mv.ax(data, v))
        nw = norm2(w)[:, None]
        v = w / torch.where(nw > 0, nw, one)
    return torch.clamp(norm2(mv.ax(data, v)), min=1e-12)


def finish_state(As, b, c, ub, r, s, mv: Matvecs, n: int) -> PdhgState:
    """The cold state around scaled data ``As`` (dense or sparse values)
    with row scales ``r`` and column scales ``s``: step size, primal
    weight and the zero iterate."""
    B, m = b.shape
    f32, dev = torch.float32, b.device
    bs = b * r
    cs = c * s
    ubs = ub / s
    sigma = power_sigma_max(As, n, mv)
    eta = torch.div(torch.full_like(sigma, STEP_SAFETY), sigma)
    nc = norm2(cs)
    nb = norm2(bs)
    one = torch.ones((), dtype=f32, device=dev)
    omega = sqrt_rn(torch.where((nc > 0) & (nb > 0),
                                nc / torch.clamp(nb, min=1e-12), one))
    omega = torch.clamp(omega, min=OMEGA_MIN, max=OMEGA_MAX)

    def zeros(k):
        return torch.zeros((B, k), dtype=f32, device=dev)

    inf = torch.full((B,), torch.inf, dtype=f32, device=dev)
    return PdhgState(
        A=As, b=bs, c=cs, rsc=r, csc=s, ub=ubs, eta=eta[:, None],
        omega=omega[:, None], binf=b.abs().amax(dim=1),
        cinf=c.abs().amax(dim=1), x=zeros(n), y=zeros(m), xs=zeros(n),
        ys=zeros(m), xr=zeros(n), yr=zeros(m),
        cnt=torch.zeros((B,), dtype=f32, device=dev), last_res=inf,
        prev_res=inf.clone(),
        phase=torch.full((B,), 2, dtype=torch.int32, device=dev),
        status=torch.full((B,), _RUNNING, dtype=torch.int32, device=dev),
        iters=torch.zeros((B,), dtype=torch.int32, device=dev))


def init_pdhg_state(A, b, c, ub=None) -> PdhgState:
    """Equilibrate, estimate step sizes and seed the zero iterate, for a
    float32 batch on its device.  ``ub`` (unscaled, +inf = free; None for
    all free) is carried into scaled space as ``ub / csc``."""
    B, m, n = A.shape
    if ub is None:
        ub = torch.full((B, n), torch.inf, dtype=A.dtype, device=A.device)
    r, s = ruiz_equilibrate(A)
    As = A * r[:, :, None] * s[:, None, :]
    return finish_state(As, b, c, ub, r, s, DENSE_MV, n)


def inject_pdhg_warm(state: PdhgState, wx, wy, womega=None,
                     mv: Matvecs = DENSE_MV) -> PdhgState:
    """Seed the iterate from a parent's terminal point.  ``wx``/``wy`` are
    in unscaled canonical coordinates (tensors on the state's device) and
    are mapped into scaled space and projected onto the boxes.  **Reset
    guard**: an LP adopts the warm point only where its KKT residual is
    finite and no worse than the zero iterate's, else it starts cold.
    ``womega`` carries the parent's primal weight (clipped to its bounds);
    ``eta`` stays the fresh estimate.  Anchors start at the adopted point;
    averages and residual history start clean."""
    xw = clip(wx / state.csc, state.ub)
    yw = torch.clamp(wy / state.rsc, min=0.0)
    xw = torch.where(torch.isfinite(xw), xw, 0.0)
    yw = torch.where(torch.isfinite(yw), yw, 0.0)
    res_w = kkt_residuals(state, xw, yw, mv)
    res_0 = kkt_residuals(state, state.x, state.y, mv)
    adopt = torch.isfinite(res_w) & (res_w <= res_0)
    x = torch.where(adopt[:, None], xw, state.x)
    y = torch.where(adopt[:, None], yw, state.y)
    omega = state.omega
    if womega is not None:
        ow = womega.reshape(-1, 1)
        ow = torch.where(torch.isfinite(ow),
                         torch.clamp(ow, min=OMEGA_MIN, max=OMEGA_MAX),
                         state.omega)
        omega = torch.where(adopt[:, None], ow, state.omega)
    return state._replace(x=x, y=y, xr=x.clone(), yr=y.clone(), omega=omega)


def warm_tensors(warm: Optional[WarmStart], device) -> dict:
    """The ``warm_x``/``warm_y``/``warm_omega`` tensors of a validated
    carrier (non-finite entries read as 0), or Nones when it carries no
    PDHG iterate."""
    if warm is None or warm.x is None or warm.y is None:
        return dict(warm_x=None, warm_y=None, warm_omega=None)

    def put(a):
        a = np.nan_to_num(np.asarray(a, np.float64), posinf=0.0, neginf=0.0)
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return dict(warm_x=put(warm.x), warm_y=put(warm.y),
                warm_omega=None if warm.omega is None else torch.as_tensor(
                    np.asarray(warm.omega), dtype=torch.float32,
                    device=device))


# ---------------------------------------------------------------------------
# Residuals and certificates
# ---------------------------------------------------------------------------

def kkt_residual_parts(s: PdhgState, x, y, mv: Matvecs = DENSE_MV):
    """Relative KKT residual of a scaled-space point, reported for the
    unscaled problem: (primal infeasibility, dual infeasibility, duality
    gap).  A positive reduced cost on a bounded column is absorbed by the
    bound's dual (priced into the gap) instead of counting as dual
    infeasibility."""
    ax = mv.ax(s.A, x)
    aty = mv.aty(s.A, y)
    rp = (torch.clamp(ax - s.b, min=0.0) / s.rsc).amax(dim=1) \
        / (1.0 + s.binf)
    zc = torch.clamp(s.c - aty, min=0.0)
    fin = torch.isfinite(s.ub)
    rd = (torch.where(fin, 0.0, zc) / s.csc).amax(dim=1) / (1.0 + s.cinf)
    pobj = tree_sum(s.c * x, 1)
    dobj = tree_sum(s.b * y, 1) + tree_sum(torch.where(fin, s.ub, 0.0) * zc,
                                           1)
    gap = (pobj - dobj).abs() / (1.0 + pobj.abs() + dobj.abs())
    return rp, rd, gap


def kkt_residuals(s: PdhgState, x, y, mv: Matvecs = DENSE_MV):
    """The maximum of the ``kkt_residual_parts`` triple."""
    return _max3(kkt_residual_parts(s, x, y, mv))


def _max3(parts):
    rp, rd, gap = parts
    return torch.maximum(torch.maximum(rp, rd), gap)


def _ray_certificates(s: PdhgState, active, mv: Matvecs = DENSE_MV):
    """Approximate Farkas rays on the unscaled iterates: INFEASIBLE when
    the normalized dual iterate has A^T y >= -eps on free columns and
    b.y + sum_bounded u_j (A^T y)_j^- < -eps; UNBOUNDED when the primal
    iterate projected onto the free columns has A x <= eps and c.x > eps.
    Iterates below RAY_MIN_NORM in normalized size are never classified."""
    fin = torch.isfinite(s.ub)
    ubm = torch.where(fin, s.ub, 0.0)
    ray_scale = 1.0 + s.binf + s.cinf
    yinf = (s.y * s.rsc).abs().amax(dim=1)
    yh = s.y / torch.clamp(yinf, min=1e-12)[:, None]
    aty_s = mv.aty(s.A, yh)
    aty_u = aty_s / s.csc
    by_u = tree_sum(s.b * yh, 1)
    uw = tree_sum(ubm * torch.clamp(-aty_s, min=0.0), 1)
    infeas = active & (yinf > RAY_MIN_NORM) \
        & (torch.where(fin, torch.inf, aty_u).amin(dim=1)
           >= -CERT_TOL * ray_scale) \
        & (by_u + uw <= -CERT_TOL * ray_scale)
    xray = torch.where(fin, 0.0, s.x)
    xinf = (xray * s.csc).abs().amax(dim=1)
    xh = xray / torch.clamp(xinf, min=1e-12)[:, None]
    ax_u = mv.ax(s.A, xh) / s.rsc
    cx_u = tree_sum(s.c * xh, 1)
    unbounded = active & (xinf > RAY_MIN_NORM) \
        & (ax_u.amax(dim=1) <= CERT_TOL * ray_scale) \
        & (cx_u >= CERT_TOL * ray_scale)
    return infeas, unbounded


# ---------------------------------------------------------------------------
# Rounds
# ---------------------------------------------------------------------------

def pending(s: PdhgState, cap: int) -> torch.Tensor:
    """(B,) bool: LPs that run a round, running and under their own
    iteration cap ``cap`` (= rounds * check_every)."""
    return (s.status == _RUNNING) & (s.iters < cap)


def pdhg_round(s: PdhgState, active, *, tol: float,
               check_every: int = CHECK_EVERY,
               mv: Matvecs = DENSE_MV) -> PdhgState:
    """One round of the LPs in ``active``: ``check_every`` fixed-step
    iterations, then ``_pdhg_check``.  Other LPs change nothing."""
    act = active[:, None]
    tau = s.eta / s.omega
    sig = s.eta * s.omega
    x, y, xs, ys, cnt = s.x, s.y, s.xs, s.ys, s.cnt
    for _ in range(check_every):
        aty = mv.aty(s.A, y)
        xn = clip(x + tau * (s.c - aty), s.ub)
        ax2 = mv.ax(s.A, 2.0 * xn - x)
        yn = torch.clamp(y + sig * (ax2 - s.b), min=0.0)
        x = torch.where(act, xn, x)
        y = torch.where(act, yn, y)
        xs = torch.where(act, xs + x, xs)
        ys = torch.where(act, ys + y, ys)
        cnt = torch.where(active, cnt + 1.0, cnt)
    s = _count_round(s._replace(x=x, y=y, xs=xs, ys=ys, cnt=cnt),
                     active, check_every)
    return _pdhg_check(s, active, tol=tol, mv=mv)


def _count_round(s: PdhgState, active, check_every: int) -> PdhgState:
    """``check_every`` more iterations for the LPs in ``active``, in
    ``iters`` and in the counter lanes."""
    inc = torch.where(active, check_every, 0).to(torch.int32)
    tel = s.tel if s.tel is None else tel_pdhg_update(s.tel, inc_iters=inc)
    return s._replace(iters=s.iters + inc, tel=tel)


def _pdhg_check(s: PdhgState, active, *, tol: float,
                mv: Matvecs = DENSE_MV) -> PdhgState:
    """The round's convergence / restart / certificate check, shared by
    both step rules."""
    cc = torch.clamp(s.cnt, min=1.0)[:, None]
    xa, ya = s.xs / cc, s.ys / cc
    parts_cur = kkt_residual_parts(s, s.x, s.y, mv)
    parts_avg = kkt_residual_parts(s, xa, ya, mv)
    res_cur = _max3(parts_cur)
    res_avg = _max3(parts_avg)
    use_avg = res_avg < res_cur
    res = torch.where(use_avg, res_avg, res_cur)
    xc = torch.where(use_avg[:, None], xa, s.x)
    yc = torch.where(use_avg[:, None], ya, s.y)

    converged = active & (res <= tol)
    restart = (res <= RESTART_SUFFICIENT * s.last_res) \
        | ((res <= RESTART_NECESSARY * s.last_res) & (res > s.prev_res))
    restart = active & ~converged & restart
    adopt = (converged | restart)[:, None]
    rs = restart[:, None]
    x = torch.where(adopt, xc, s.x)
    y = torch.where(adopt, yc, s.y)
    xs = torch.where(rs, 0.0, s.xs)
    ys = torch.where(rs, 0.0, s.ys)
    cnt = torch.where(restart, 0.0, s.cnt)
    last_res = torch.where(restart, res, s.last_res)
    prev_res = torch.where(restart, torch.inf,
                           torch.where(active, res, s.prev_res))

    # adaptive primal weight, its logarithms and exponential in float64
    dx = norm2(xc - s.xr)
    dy = norm2(yc - s.yr)
    can_adapt = restart & (dx > 1e-10) & (dy > 1e-10)
    om = s.omega[:, 0]
    ratio = torch.clamp(dy, min=1e-12) / torch.clamp(dx, min=1e-12)
    om_new = torch.exp(OMEGA_SMOOTHING * torch.log(ratio.double())
                       + (1.0 - OMEGA_SMOOTHING) * torch.log(om.double())
                       ).float()
    omega = torch.where(can_adapt,
                        torch.clamp(om_new, min=OMEGA_MIN, max=OMEGA_MAX),
                        om)[:, None]
    xr = torch.where(rs, xc, s.xr)
    yr = torch.where(rs, yc, s.yr)

    infeas, unbounded = _ray_certificates(s, active & ~converged, mv)
    status = torch.where(converged, OPTIMAL, s.status)
    status = torch.where(infeas, INFEASIBLE, status)
    status = torch.where(unbounded, UNBOUNDED, status).to(torch.int32)
    tel = s.tel
    if tel is not None:
        # the candidate's triple, for the LPs that ran the round
        kkt = tuple(torch.where(active, torch.where(use_avg, a, c), old)
                    for a, c, old in zip(parts_avg, parts_cur,
                                         (tel.kkt_primal, tel.kkt_dual,
                                          tel.kkt_gap)))
        tel = tel_pdhg_update(tel, restart=restart, kkt=kkt,
                              omega=torch.where(active, omega[:, 0],
                                                tel.omega))
    return s._replace(x=x, y=y, xs=xs, ys=ys, xr=xr, yr=yr, cnt=cnt,
                      last_res=last_res, prev_res=prev_res, omega=omega,
                      status=status, tel=tel)


def pdhg_round_mp(s: PdhgState, active, tau, tprev, *, tol: float,
                  check_every: int = CHECK_EVERY, mv: Matvecs = DENSE_MV):
    """Malitsky-Pock round: ``check_every`` iterations with a dual
    linesearch each (the MP_* constants), then ``_pdhg_check``.
    ``tau``/``tprev`` are the (B, 1) primal steps carried across rounds;
    returns ``(state, tau, tprev)``."""
    act = active[:, None]
    beta = s.omega * s.omega
    sqb = s.omega
    tau0 = s.eta / s.omega
    sig0 = s.eta * s.omega
    x, y, xs, ys, cnt = s.x, s.y, s.xs, s.ys, s.cnt
    for _ in range(check_every):
        aty = mv.aty(s.A, y)
        xn = clip(x + tau * (s.c - aty), s.ub)
        theta0 = tau / torch.clamp(tprev, min=1e-30)
        tau_t = tau * sqrt_rn(1.0 + theta0)
        y_acc = torch.zeros_like(y)
        t_acc = torch.zeros_like(tau)
        done = torch.zeros_like(tau, dtype=torch.bool)
        for _ in range(MP_TRIALS):
            theta = tau_t / torch.clamp(tau, min=1e-30)
            xbar = xn + theta * (xn - x)
            y_try = torch.clamp(y + beta * tau_t * (mv.ax(s.A, xbar) - s.b),
                                min=0.0)
            lhs = sqb * tau_t * norm2(mv.aty(s.A, y_try) - aty)[:, None]
            rhs = MP_DELTA * norm2(y_try - y)[:, None]
            ok = ~done & (lhs <= rhs + 1e-30)
            y_acc = torch.where(ok, y_try, y_acc)
            t_acc = torch.where(ok, tau_t, t_acc)
            done = done | ok
            tau_t = torch.where(done, tau_t, tau_t * MP_MU)
            if bool(done.all()):    # later trials would change nothing
                break
        if bool(done.all()):
            yn = y_acc
        else:
            y_fb = torch.clamp(
                y + sig0 * (mv.ax(s.A, 2.0 * xn - x) - s.b), min=0.0)
            yn = torch.where(done, y_acc, y_fb)
        tau_n = torch.where(done, t_acc, tau0)
        tprev_n = torch.where(done, tau, tau0)
        x = torch.where(act, xn, x)
        y = torch.where(act, yn, y)
        tau = torch.where(act, tau_n, tau)
        tprev = torch.where(act, tprev_n, tprev)
        xs = torch.where(act, xs + x, xs)
        ys = torch.where(act, ys + y, ys)
        cnt = torch.where(active, cnt + 1.0, cnt)
    s = _count_round(s._replace(x=x, y=y, xs=xs, ys=ys, cnt=cnt),
                     active, check_every)
    return _pdhg_check(s, active, tol=tol, mv=mv), tau, tprev


def segment_pdhg(state: PdhgState, steps: int, *, tol: float,
                 max_rounds: int, check_every: int = CHECK_EVERY,
                 mv: Matvecs = DENSE_MV):
    """At most ``steps`` fixed-step rounds per LP, the segment kernel's
    function in torch.  An LP runs while ``pending`` holds for it under
    the cap ``max_rounds * check_every``; afterwards an LP still running
    at that cap is ITERATION_LIMIT.  Returns ``(state, it)`` with ``it``
    the (B,) int32 rounds each LP ran; builds new tensors."""
    cap = int(max_rounds) * int(check_every)
    it = torch.zeros_like(state.iters)
    s = state
    for _ in range(int(steps)):
        act = pending(s, cap)
        if not bool(act.any()):
            break
        s = pdhg_round(s, act, tol=tol, check_every=check_every, mv=mv)
        it = it + act.to(torch.int32)
    capped = (s.status == _RUNNING) & (s.iters >= cap)
    return s._replace(status=torch.where(capped, ITERATION_LIMIT,
                                         s.status).to(torch.int32)), it


def run_pdhg(state: PdhgState, rounds: int, *, tol: float,
             check_every: int = CHECK_EVERY, step_rule: str = "fixed",
             mv: Matvecs = DENSE_MV) -> PdhgState:
    """The whole solve's rounds from ``state``: every LP runs until it is
    terminal or has run ``rounds`` rounds (then ITERATION_LIMIT).  The
    Malitsky-Pock steps start at eta / omega of the given state."""
    if canonicalize_step_rule(step_rule) == "fixed":
        return segment_pdhg(state, rounds, tol=tol, max_rounds=rounds,
                            check_every=check_every, mv=mv)[0]
    cap = int(rounds) * int(check_every)
    tau = state.eta / state.omega
    tprev = tau.clone()
    s = state
    for _ in range(int(rounds)):
        act = pending(s, cap)
        if not bool(act.any()):
            break
        s, tau, tprev = pdhg_round_mp(s, act, tau, tprev, tol=tol,
                                      check_every=check_every, mv=mv)
    capped = (s.status == _RUNNING) & (s.iters >= cap)
    return s._replace(status=torch.where(capped, ITERATION_LIMIT,
                                         s.status).to(torch.int32))


def extract_pdhg(s: PdhgState, mv: Matvecs = DENSE_MV):
    """``(x, obj, status, iters, y, z)`` in unscaled canonical
    coordinates; ``z = c - A^T y`` is the reduced-cost certificate.
    RUNNING reads as ITERATION_LIMIT; objective, y and z are NaN off
    OPTIMAL."""
    x = s.x * s.csc
    y = s.y * s.rsc
    obj = tree_sum(s.c * s.x, 1)
    z = s.c / s.csc - mv.aty(s.A, s.y) / s.csc
    status = torch.where(s.status == _RUNNING, ITERATION_LIMIT, s.status)
    opt = status == OPTIMAL
    return (x, torch.where(opt, obj, torch.nan), status.to(torch.int8),
            s.iters, torch.where(opt[:, None], y, torch.nan),
            torch.where(opt[:, None], z, torch.nan))


def run_and_extract(state: PdhgState, rounds: int, *, tol: float,
                    check_every: int = CHECK_EVERY, step_rule: str = "fixed",
                    mv: Matvecs = DENSE_MV):
    """``run_pdhg``, then the extraction and the warm capture: ``(x, obj,
    status, iters, y, z, warm_x, warm_y, omega, eta)``, the last four the
    terminal iterate (unscaled, before the NaN masks), primal weight and
    step, and the ``TelemetryState`` after them when the state carries
    one."""
    state = run_pdhg(state, rounds, tol=tol, check_every=check_every,
                     step_rule=step_rule, mv=mv)
    out = extract_pdhg(state, mv) + (state.x * state.csc, state.y * state.rsc,
                                     state.omega[:, 0], state.eta[:, 0])
    return out if state.tel is None else out + (state.tel,)


def solve_pdhg(A, b, c, ub=None, *, m: int, n: int, max_iters: int,
               tol: float = DEFAULT_TOL, check_every: int = CHECK_EVERY,
               warm_x=None, warm_y=None, warm_omega=None,
               step_rule: str = "fixed", run=None, telemetry: bool = False):
    """Whole solve of a float32 batch on its device: setup, warm
    injection (``warm_x``/``warm_y``/``warm_omega``, unscaled), then
    ``run(state, rounds, tol=, check_every=, step_rule=)``: by default the
    plain ``run_and_extract``; the kernel wrapper passes its launch.
    Returns run's ``(x, obj, status, iters, y, z, warm_x, warm_y, omega,
    eta)``, and with ``telemetry`` (the plain run only) the
    ``TelemetryState`` last."""
    del m, n
    rule = canonicalize_step_rule(step_rule)
    state = init_pdhg_state(A, b, c, ub)
    if warm_x is not None and warm_y is not None:
        state = inject_pdhg_warm(state, warm_x, warm_y, warm_omega)
    if telemetry:
        state = state._replace(tel=init_telemetry(A.shape[0], A.device))
    run = run_and_extract if run is None else run
    return run(state, pdhg_rounds(max_iters, check_every), tol=float(tol),
               check_every=int(check_every), step_rule=rule)


def _check_pdhg_pricing(pricing: str) -> None:
    if pricing != "dantzig":
        raise ValueError(
            f"pricing rule {pricing!r} is a simplex concept; the pdhg "
            "backend has no pivot selection (every iteration touches every "
            "column).  Use the default pricing with backend='pdhg'.")


def pdhg_result(out, *, m: int, n: int, stats=None) -> LPResult:
    """The ``LPResult`` (NumPy, with its ``WarmStart`` capture) of a
    ``solve_pdhg`` tuple's first ten entries, carrying ``stats``."""
    x, obj, status, iters, y, z, wx, wy, om, eta = (t.cpu().numpy()
                                                    for t in out[:10])
    return LPResult(x=x, objective=obj, status=status, iterations=iters,
                    y=y, z=z, warm=WarmStart(m=m, n=n, x=wx, y=wy, omega=om,
                                             eta=eta), stats=stats)


def solve_batched_pdhg(batch: LPBatch, *, device=None,
                       tol: float | None = None,
                       feas_tol: float | None = None,
                       max_iters: int | None = None,
                       check_every: int = CHECK_EVERY,
                       pricing: str = "dantzig",
                       presolve: bool = True,
                       scale: bool | None = None,
                       warm: WarmStart | None = None,
                       step_rule: str = "fixed", telemetry: bool = False,
                       tracer=None) -> LPResult:
    """Solve a batch with the plain restarted-PDHG engine, in float32 on
    ``device`` (CUDA unless ``device="cpu"``).  Counterpart of
    ``repro.core.pdhg.solve_batched_pdhg``: ``tol`` is the relative KKT
    tolerance (default 1e-5), ``iterations`` count PDHG iterations
    (quantized to ``check_every``), ``y``/``z`` are the native primal-dual
    certificate, ``warm`` a parent's ``WarmStart`` (adopted per LP behind
    the reset guard), ``step_rule`` "fixed" or "malitsky_pock"; the result
    carries its own capture (x, y, omega, eta).  ``feas_tol`` is accepted
    for a uniform signature and unused (PDHG has no phase 1).
    ``telemetry`` and ``tracer`` as in ``core.simplex.solve_batched_torch``
    (the counters: iterations, restarts, the last KKT triple, omega)."""
    _check_pdhg_pricing(pricing)
    del feas_tol
    canonicalize_step_rule(step_rule)
    with maybe_span(tracer, "canonicalize"):
        batch, rec = ensure_canonical(batch, presolve=presolve, scale=scale)
    dev = resolve_device(device)
    m, n = batch.m, batch.n
    if max_iters is None:
        max_iters = default_pdhg_max_iters(m, n)
    warm = prepare_warm(warm, rec, batch)
    t0 = time.perf_counter()
    with maybe_span(tracer, "dispatch", backend="pdhg", B=batch.batch,
                    m=m, n=n):
        A, b, c, ub = batch_tensors(batch, dev)
        out = solve_pdhg(A, b, c, ub, m=m, n=n, max_iters=int(max_iters),
                         tol=DEFAULT_TOL if tol is None else float(tol),
                         check_every=check_every, step_rule=step_rule,
                         telemetry=telemetry, **warm_tensors(warm, dev))
        res = pdhg_result(out, m=m, n=n, stats=solve_report(
            out[10] if telemetry else None, t0, "pdhg", tracer))
    with maybe_span(tracer, "recover"):
        return finish_result(rec, res)


# ---------------------------------------------------------------------------
# The compaction scheduler
# ---------------------------------------------------------------------------

class PdhgBackend(TorchBackend):
    """Scheduler backend of the first-order engine (the counterpart of the
    reference's ``PdhgBackend``): one scheduler step is one round of
    ``check_every`` iterations; ``phase`` is the constant 2, so stage p1
    has nothing to run, and there are no columns to compact.  Segments run
    ``segment_pdhg`` on any device; ``kernels.ops.PdhgKernelBackend`` runs
    the CUDA segment kernel instead.  Gathers and status reads are
    ``TorchBackend``'s."""

    def __init__(self, m: int, n: int, tol: float = DEFAULT_TOL,
                 check_every: int = CHECK_EVERY):
        self.m, self.n = m, n
        self.tol = float(tol)
        self.check_every = int(check_every)

    def init(self, A, b, c, ub=None, warm: WarmStart | None = None,
             telemetry: bool = False) -> PdhgState:
        state = init_pdhg_state(A, b, c, ub)
        w = warm_tensors(warm, A.device)
        if w["warm_x"] is not None:
            state = inject_pdhg_warm(state, w["warm_x"], w["warm_y"],
                                     w["warm_omega"])
        if telemetry:
            state = state._replace(tel=init_telemetry(A.shape[0], A.device))
        return state

    def segment(self, state, steps: int, stage: str, max_iters: int):
        """``steps`` rounds under a budget of ``max_iters`` rounds per LP
        (stage p2: with phase 2 everywhere, stage p1 never runs)."""
        return segment_pdhg(state, steps, tol=self.tol, max_rounds=max_iters,
                            check_every=self.check_every)

    def compact_columns(self, state: PdhgState) -> PdhgState:
        return state

    def extract(self, state: PdhgState, stage: str):
        return tuple(t.cpu().numpy() for t in extract_pdhg(state))

    def elements_per_step(self, stage: str) -> int:
        return self.check_every * pdhg_elements(self.m, self.n)


def schedule_pdhg(runner: PdhgBackend, batch: LPBatch, dev, *, max_iters,
                  segment_k, compact_threshold, stats_out,
                  warm=None, telemetry: bool = False,
                  tracer=None) -> LPResult:
    """Initialize ``runner`` on a canonical batch (seeded from a validated
    ``warm``, with counter lanes when ``telemetry``) and drive it through
    ``run_schedule`` with a per-LP budget of ``ceil(max_iters /
    check_every)`` rounds; ``segment_k=None`` takes the reference's
    ``max(4, rounds // 64)``."""
    m, n = batch.m, batch.n
    if max_iters is None:
        max_iters = default_pdhg_max_iters(m, n)
    rounds = pdhg_rounds(max_iters, runner.check_every)
    if segment_k is None:
        segment_k = max(4, rounds // 64)
    with maybe_span(tracer, "dispatch", backend=type(runner).__name__,
                    B=batch.batch, m=m, n=n):
        A, b, c, ub = batch_tensors(batch, dev)
        state = runner.init(A, b, c, ub, warm=warm, telemetry=telemetry)
        del A, b, c, ub
    return run_schedule(runner, state, max_iters=rounds,
                        segment_k=segment_k,
                        compact_threshold=compact_threshold,
                        stats_out=stats_out, tracer=tracer)


def solve_batched_pdhg_compacted(
        batch: LPBatch, *, device=None, tol: Optional[float] = None,
        feas_tol: Optional[float] = None, max_iters: Optional[int] = None,
        segment_k: Optional[int] = None,
        compact_threshold: Optional[float] = None,
        check_every: int = CHECK_EVERY, pricing: str = "dantzig",
        stats_out: Optional[List[SegmentStat]] = None,
        presolve: bool = True, scale: Optional[bool] = None,
        warm: WarmStart | None = None, telemetry: bool = False,
        tracer=None, step_rule: str = "fixed") -> LPResult:
    """Restarted PDHG under the compaction scheduler, in float32 on
    ``device`` (CUDA unless ``device="cpu"``): segments of at most
    ``segment_k`` rounds, survivor gathers between them.  Equal to
    ``solve_batched_pdhg`` bit for bit (statuses, iterations, x,
    objectives, y, z); the result carries no warm-start capture.  Only the
    fixed step: ``step_rule="malitsky_pock"`` raises ``ValueError``, as
    the reference's compacted entry has no linesearch.  ``telemetry`` and
    ``tracer`` as in ``core.compaction.solve_batched_compacted``."""
    _check_pdhg_pricing(pricing)
    check_compacted_step_rule(step_rule)
    del feas_tol
    with maybe_span(tracer, "canonicalize"):
        batch, rec = ensure_canonical(batch, presolve=presolve, scale=scale)
    dev = resolve_device(device)
    runner = PdhgBackend(batch.m, batch.n,
                         DEFAULT_TOL if tol is None else tol,
                         check_every=check_every)
    res = schedule_pdhg(runner, batch, dev, max_iters=max_iters,
                        segment_k=segment_k,
                        compact_threshold=compact_threshold,
                        stats_out=stats_out,
                        warm=prepare_warm(warm, rec, batch),
                        telemetry=telemetry, tracer=tracer)
    with maybe_span(tracer, "recover"):
        return finish_result(rec, res)


def check_compacted_step_rule(step_rule: str) -> None:
    if canonicalize_step_rule(step_rule) != "fixed":
        raise ValueError(
            "step_rule='malitsky_pock' runs on the whole solve only; the "
            "compaction scheduler's segments take the fixed step (as the "
            "reference's solve_batched_pdhg_compacted does)")

