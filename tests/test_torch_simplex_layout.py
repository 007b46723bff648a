"""Identities the dense-tableau simplex kernels' design rests on
(csrc/simplex_tile.cu), checked on the CPU against the plain engine bit
for bit, and the kernels against their plain versions on the card.

The whole-solve kernel keeps only the live columns of the phase-1 tableau
(the n+m structural and slack columns and the rhs): the m artificial
columns are never read, so filling them with NaN changes no output and no
work count.  A p1 segment keeps its state exact by logging each pivot (its
row, its pivot element after the complement, the complement flag and the
entering column) and replaying the log on the artificial columns: the
replay alone rebuilds ``run_segment``'s artificial columns bit for bit.
Each thread owns whole columns: it sums steepest edge's column norms in
row order as it updates them, and the block reductions find
torch.argmax's winner in any order.  This file imports no JAX; its ``gpu``
tests run on a machine with a card (``python -m pytest -m gpu -k simplex
tests/test_torch_simplex_layout.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.compaction import (CompactionState, TorchBackend,
                                         map_state, run_segment,
                                         segment_pending)
from repro_torch.core.forms import canonicalize
from repro_torch.core.fp import fma
from repro_torch.core.lp import ITERATION_LIMIT, OPTIMAL, LPBatch
from repro_torch.core.pricing import init_weights, update_weights
from repro_torch.core.reference import random_lp_batch
from repro_torch.core.simplex import (_RUNNING, SimplexState,
                                      batch_tensors, build_tableau_torch,
                                      compact_tableau, extract_duals,
                                      extract_solution, phase2_step,
                                      simplex_step, solve_two_phase)
from repro_torch.core.pricing import compact_weights
from repro_torch.io import fixture_path, perturbed_batch, read_mps
from repro_torch.kernels.simplex_tile import (WORK_COUNTERS, block_threads,
                                              segment_tile,
                                              segment_tile_plain,
                                              simplex_tile,
                                              simplex_tile_plain,
                                              tableau_in_smem)

RULES = ("dantzig", "devex", "steepest_edge")
TOL, FEAS_TOL = 1e-6, 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, any NaN equal to any NaN (two absent leaves, as
    the ``tel`` of a state without counters, are equal)."""
    if a is None or b is None:
        return a is b
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    nan = torch.isnan(a) & torch.isnan(b)
    bits = torch.int32 if a.dtype == torch.float32 else torch.int64
    return bool(((a.view(bits) == b.view(bits)) | nan).all())


def _batch(kind: str, rng) -> LPBatch:
    """lp_100d's class (random, phase 1 from the start) at a CPU size,
    afiro's canonical 35 x 32, and a batch with finite bounds (flips and
    leaving-at-upper complements)."""
    if kind == "lp100":
        return random_lp_batch(rng, B=12, m=14, n=12, feasible_start=False)
    if kind == "afiro":
        lp, _ = canonicalize(perturbed_batch(read_mps(fixture_path("afiro")),
                                             6, rng))
        return lp
    b = random_lp_batch(rng, B=16, m=20, n=24, feasible_start=False)
    ub = rng.uniform(0.05, 0.5, size=(16, 24))
    ub[:, ::3] = np.inf
    return LPBatch.from_arrays(b.A, b.b, b.c, ub=ub)


def _two_phase(A, b, c, ub, *, m, n, max_iters, rule, poison):
    """solve_two_phase's loops (cold), with the artificial columns of the
    built tableau filled with NaN when ``poison``."""
    B = A.shape[0]
    T, basis, phase = build_tableau_torch(A, b, c)
    if poison:
        T[:, :, n + m:n + 2 * m] = torch.nan
    thr = FEAS_TOL * torch.clamp(T[:, m + 1, -1], min=1.0)
    s = SimplexState(T, basis, phase,
                     torch.full((B,), _RUNNING, dtype=torch.int32),
                     torch.zeros((B,), dtype=torch.int32),
                     init_weights(rule, T, m),
                     torch.zeros((B, n), dtype=torch.bool), ub,
                     torch.zeros((B, WORK_COUNTERS), dtype=torch.int32))
    it = 0
    while it < max_iters and bool(((s.status == _RUNNING)
                                   & (s.phase == 1)).any()):
        s = simplex_step(s, n=n, m=m, tol=TOL, feas_thr=thr, rule=rule)
        it += 1
    status = torch.where((s.status == _RUNNING) & (s.phase == 1),
                         ITERATION_LIMIT, s.status)
    s = s._replace(T=compact_tableau(s.T, m=m, n=n), status=status,
                   w=compact_weights(s.w, m=m, n=n))
    while it < max_iters and bool((s.status == _RUNNING).any()):
        s = phase2_step(s, n=n, m=m, tol=TOL, rule=rule)
        it += 1
    status = torch.where(s.status == _RUNNING, ITERATION_LIMIT, s.status)
    x, obj = extract_solution(s.T, s.basis, m=m, n=n, flip=s.flip, ub=s.ub)
    y, z = extract_duals(s.T, m=m, n=n, flip=s.flip)
    opt = (status == OPTIMAL)[:, None]
    return (x, torch.where(opt[:, 0], obj, torch.nan), status.to(torch.int8),
            s.iters, torch.where(opt, y, torch.nan),
            torch.where(opt, z, torch.nan), s.work)


@pytest.mark.parametrize("kind", ["lp100", "afiro", "bounded"])
@pytest.mark.parametrize("rule", RULES)
def test_artificial_columns_are_never_read(kind, rule):
    """NaN in every artificial column of the built tableau: x, objective,
    y, z, status, iterations and work equal the clean run bit for bit, and
    the clean run is the plain version's."""
    batch = _batch(kind, np.random.default_rng(19))
    A, b, c, ub = batch_tensors(batch, torch.device("cpu"))
    m, n = batch.m, batch.n
    kw = dict(m=m, n=n, max_iters=10 * (m + n) + 50, rule=rule)
    clean = _two_phase(A, b, c, ub, poison=False, **kw)
    poisoned = _two_phase(A, b, c, ub, poison=True, **kw)
    for got, want in zip(poisoned, clean):
        assert _bits_equal(got, want)
    assert int(clean[6][:, 0].sum()) > 0           # phase-1 pivots ran
    if kind == "bounded":
        assert int(clean[6][:, 2].sum()) > 0       # and bound flips
    work = torch.zeros((A.shape[0], WORK_COUNTERS), dtype=torch.int32)
    plain = solve_two_phase(A, b, c, ub, m=m, n=n,
                            max_iters=kw["max_iters"], tol=TOL,
                            feas_tol=FEAS_TOL, pricing=rule, work=work)
    for got, want in zip(plain + (work,), clean):
        assert _bits_equal(got, want)


def _p1_state(batch, rule, steps):
    """A cold p1 state advanced ``steps`` p1 steps with the plain version."""
    m, n = batch.m, batch.n
    state = TorchBackend(m, n, TOL, FEAS_TOL, pricing=rule).init(
        *batch_tensors(batch, torch.device("cpu")))
    if steps:
        state, _ = run_segment(state, steps, stage="p1", m=m, n=n,
                               max_iters=10 * (m + n) + 50, tol=TOL,
                               rule=rule)
    return state


def _logged_segment(state, steps, *, m, n, rule, max_iters):
    """run_segment one step at a time, logging each pivot as the kernel
    does: its row l, the pivot element after the complement, the
    complement flag and the entering column before the update.  Returns
    (final state, log per LP)."""
    log = [[] for _ in range(state.T.shape[0])]
    for _ in range(steps):
        if not bool(segment_pending(state, "p1", max_iters).any()):
            break
        before = state
        state, _ = run_segment(state, 1, stage="p1", m=m, n=n,
                               max_iters=max_iters, tol=TOL, rule=rule)
        pivoted = state.work[:, 0] > before.work[:, 0]
        for lp in torch.nonzero(pivoted)[:, 0].tolist():
            l = int(torch.nonzero(state.basis[lp] != before.basis[lp])[0, 0])
            e = int(state.basis[lp, l])
            jl = int(before.basis[lp, l])
            col = before.T[lp, :, e].clone()
            pe = col[l].clone()
            comp = bool(pe < 0) and jl < n
            log[lp].append((l, -pe if comp else pe, comp, col))
    return state, log


def _replay(art: torch.Tensor, log) -> torch.Tensor:
    """The kernel's replay of one LP's log on its artificial columns
    (rows x m): per pivot the pivot-row value (negated under the
    complement) over the pivot element, then every other row minus the
    entering column's entry times it, rounded once."""
    for l, pe, comp, col in log:
        v = -art[l] if comp else art[l]
        p = v / pe
        new = fma(-col[:, None], p[None, :], art)
        new[l] = p
        art = new
    return art


@pytest.mark.parametrize("case", ["lp100", "bounded", "sc205_like",
                                  "overflow"])
def test_replay_rebuilds_the_artificial_columns(case):
    """The logged pivots replayed, in order and in rounds of any size, on
    the artificial columns of a p1 segment's input give run_segment's
    output bit for bit; the live columns and every other leaf do not
    depend on the artificial columns (NaN there changes none of them)."""
    rng = np.random.default_rng(23)
    rule, pre, steps = "dantzig", 0, 24
    if case == "sc205_like":
        batch, _ = canonicalize(perturbed_batch(
            read_mps(fixture_path("sc205_like")), 3, rng))
        pre = 40
    elif case == "overflow":
        # one member's first row scaled near the float32 limit: its pivots
        # overflow and the artificial columns reach inf and NaN
        base = _batch("bounded", rng)
        A, b = base.A.copy(), base.b.copy()
        A[0, 0] *= 3e37
        b[0, 0] *= 3e37
        batch = LPBatch.from_arrays(A, b, base.c, ub=base.ub)
        rule = "steepest_edge"
    else:
        batch = _batch(case, rng)
    m, n = batch.m, batch.n
    mi = 10 * (m + n) + 50
    state = _p1_state(batch, rule, pre)
    final, log = _logged_segment(state, steps, m=m, n=n, rule=rule,
                                 max_iters=mi)
    want, _ = run_segment(state, steps, stage="p1", m=m, n=n, max_iters=mi,
                          tol=TOL, rule=rule)
    for name, g, w in zip(CompactionState._fields, final, want):
        assert _bits_equal(g, w), name
    arts = slice(n + m, n + 2 * m)
    comps = sum(c for entries in log for _, _, c, _ in entries)
    for lp in range(state.T.shape[0]):
        start = state.T[lp, :, arts]
        assert _bits_equal(_replay(start, log[lp]), want.T[lp, :, arts])
        half = len(log[lp]) // 2                   # two rounds
        twice = _replay(_replay(start, log[lp][:half]), log[lp][half:])
        assert _bits_equal(twice, want.T[lp, :, arts])
    assert sum(len(entries) for entries in log) > 0
    if case == "bounded":
        assert comps > 0
    if case == "overflow":
        assert bool(torch.isnan(want.T[0, :, arts]).any())
    poisoned = state._replace(T=state.T.clone())
    poisoned.T[:, :, arts] = torch.nan
    got, _ = run_segment(poisoned, steps, stage="p1", m=m, n=n,
                         max_iters=mi, tol=TOL, rule=rule)
    live = torch.cat([got.T[:, :, :n + m], got.T[:, :, -1:]], dim=2)
    live_want = torch.cat([want.T[:, :, :n + m], want.T[:, :, -1:]], dim=2)
    assert _bits_equal(live, live_want)
    for name, g, w in zip(CompactionState._fields[1:], got[1:], want[1:]):
        assert _bits_equal(g, w), name


@pytest.mark.parametrize("rows,l", [(102, 37), (101, 100), (37, 0), (7, 6),
                                    (1, 0)])
def test_column_update_with_its_norm_in_row_order(rows, l):
    """A thread's column update (four rows at a time, row l replaced) and
    the squares it sums over rows < m as it goes equal the plain pivot
    update and steepest edge's recomputed weight."""
    rng = np.random.default_rng(rows)
    m = max(rows - 2, 1)
    T = torch.tensor(rng.standard_normal((1, rows, 9)), dtype=torch.float32)
    col = T[0, :, 3].clone()
    pivrow = T[0, l] / col[l]
    want = fma(-col[None, :, None], pivrow[None, None, :], T)
    want[0, l] = pivrow
    w = update_weights("steepest_edge", torch.ones((1, 9)), want, pivrow[None],
                       col[l:l + 1], torch.tensor([3]), torch.tensor([0]),
                       torch.tensor([True]), m=m, n=4)
    for k in range(9):
        acc = torch.zeros((), dtype=torch.float32)
        new = []
        for r0 in range(0, rows, 4):
            for r in range(r0, min(r0 + 4, rows)):
                v = pivrow[k] if r == l else fma(-col[r], pivrow[k], T[0, r, k])
                new.append(v)
                if r < m:
                    acc = fma(v, v, acc)
        assert _bits_equal(torch.stack(new), want[0, :, k])
        assert _bits_equal(1.0 + acc, w[0, k])


def _wins(is_max, v, i, bv, bi):
    """The kernels' order: NaN beats every number, ties to the lower
    index."""
    vn, bn = np.isnan(v), np.isnan(bv)
    if vn or bn:
        return vn and (not bn or i < bi)
    return (v > bv if is_max else v < bv) or (v == bv and i < bi)


def _order_key(v, is_max):
    """The kernels' order_key: a larger key wins an argmax, a smaller one an
    argmin, NaN wins both, -0 ties +0."""
    if np.isnan(v):
        return 0xFFFFFFFF if is_max else 0
    u = int(np.float32(0.0 if v == 0 else v).view(np.uint32))
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000


def _warp_best(entries, is_max):
    """Two warp reductions: the best key, then the lowest index holding
    it."""
    keys = [_order_key(v, is_max) for v, _ in entries]
    best = max(keys) if is_max else min(keys)
    win = min(i for k, (_, i) in zip(keys, entries) if k == best)
    return next(e for k, e in zip(keys, entries) if k == best and e[1] == win)


def _block_reduce(vals, is_max, nthreads):
    """Thread k's own candidates k, k + NT, ... under ``wins``; each warp's
    winner by its keys; then the warps' slots the same way."""
    init = (-np.inf if is_max else np.inf, 2**31 - 1)
    own = [init] * nthreads
    for k, v in enumerate(vals):
        t = k % nthreads
        if _wins(is_max, v, k, *own[t]):
            own[t] = (v, k)
    slots = [_warp_best(own[w:w + 32], is_max)
             for w in range(0, nthreads, 32)]
    return _warp_best(slots, is_max)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("is_max", [True, False])
def test_block_reductions_find_torch_argmax(seed, is_max):
    """Ties, signed zeros, infinities and NaN: the per-thread, per-warp and
    per-slot reduction finds torch.argmax's (argmin's) index whatever the
    block size, and the keys order floats as ``wins`` does."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 700))
    vals = rng.integers(-3, 4, size=n).astype(np.float32)
    vals[rng.random(n) < 0.1] = 0.0
    vals[rng.random(n) < 0.1] = -0.0
    vals[rng.random(n) < 0.05] = np.inf if is_max else -np.inf
    if seed % 2:
        vals[rng.integers(0, n, size=2)] = np.nan
    t = torch.from_numpy(vals)
    want = int(t.argmax() if is_max else t.argmin())
    for nthreads in (32, 96, 224, 256):
        got = _block_reduce(list(vals), is_max, nthreads)
        assert got[1] == want, (nthreads, got, want)
    for a, b in zip(vals[:-1], vals[1:]):
        ka, kb = _order_key(a, is_max), _order_key(b, is_max)
        assert _wins(is_max, a, 0, b, 1) == (ka >= kb if is_max else ka <= kb)


def test_odd_stride_reads_a_column_without_bank_conflicts():
    """The on-chip tableau's row stride is the live width made odd, so a
    warp reading 32 consecutive rows of one column meets 32 banks."""
    for m, n in [(100, 100), (35, 32), (27, 32), (14, 12), (1, 1), (2, 1)]:
        stride = (n + m + 1) | 1
        assert stride % 2 == 1 and n + m + 1 <= stride <= n + m + 2
        for e in (0, n + m - 1, n + m):
            banks = {((i * stride + e) % 32) for i in range(32)}
            assert len(banks) == 32


# ---- on the card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _equal_outputs(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                   msg=f"output {i}")


def _variant_batch(variant, rng):
    """60 x 50 with finite bounds (about 100 phase-1 steps) in shared
    memory; sc205_like (246 x 159) in device memory."""
    if variant == "shared":
        b = random_lp_batch(rng, B=32, m=60, n=50, feasible_start=False)
        ub = rng.uniform(0.05, 0.5, size=(32, 50))
        ub[:, ::3] = np.inf
        return LPBatch.from_arrays(b.A, b.b, b.c, ub=ub)
    lp, _ = canonicalize(perturbed_batch(read_mps(fixture_path("sc205_like")),
                                         4, rng))
    return lp


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["shared", "device"])
@pytest.mark.parametrize("rule", RULES)
def test_whole_solve_equals_plain_at_atol_0_on_the_card(variant, rule):
    """Both variants of the whole-solve kernel, every output and work count
    equal to the plain version (x, objective, y, z at atol 0)."""
    dev = _card()
    batch = _variant_batch(variant, np.random.default_rng(31))
    m, n = batch.m, batch.n
    assert tableau_in_smem(m, n, rule) == (variant == "shared")
    A, b, c, ub = batch_tensors(batch, dev)
    kw = dict(m=m, n=n, max_iters=10 * (m + n) + 50 if variant == "shared"
              else 600, pricing=rule)
    work = torch.zeros((batch.batch, WORK_COUNTERS), dtype=torch.int32,
                       device=dev)
    work_plain = torch.zeros_like(work)
    got = simplex_tile(A, b, c, ub, work=work, **kw)
    want = simplex_tile_plain(A, b, c, ub, work=work_plain, **kw)
    torch.cuda.synchronize()
    _equal_outputs(got, want)
    torch.testing.assert_close(work, work_plain, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["shared", "device"])
@pytest.mark.parametrize("rule", RULES)
def test_p1_segment_in_rounds_equals_plain_on_the_card(variant, rule):
    """A p1 segment of 70 steps (three rounds of the 32-pivot log) and the
    p2 segment after it, every leaf equal to the plain version's."""
    dev = _card()
    batch = _variant_batch(variant, np.random.default_rng(37))
    m, n = batch.m, batch.n
    be = TorchBackend(m, n, TOL, FEAS_TOL, pricing=rule)
    state = be.init(*batch_tensors(batch, dev))
    kw = dict(m=m, n=n, max_iters=10 * (m + n) + 50 if variant == "shared"
              else 600, pricing=rule)
    for stage in ("p1", "p2"):
        if stage == "p2":   # finish stage p1 first, as the scheduler does
            while bool(segment_pending(state, "p1", kw["max_iters"]).any()):
                state = segment_tile_plain(state, 32, stage="p1", **kw)[0]
            state = be.compact_columns(state)
        got, it = segment_tile(map_state(torch.clone, state),
                               70, stage=stage, **kw)
        want, want_it = segment_tile_plain(state, 70, stage=stage, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(it, want_it, rtol=0, atol=0)
        for name, g, w in zip(CompactionState._fields, got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                       msg=f"{stage} {name}")
        if stage == "p1":
            assert int(it.max()) > 64
        state = want


@pytest.mark.gpu
@pytest.mark.parametrize("rule", RULES)
def test_large_m_runs_the_device_variant_on_the_card(rule):
    """m = 700 (a 702 x 1,401 live tableau in device memory, six column
    groups for 256 threads): the whole solve and a p1 segment equal the
    plain version at a capped budget."""
    dev = _card()
    m, n = 700, 700
    batch = random_lp_batch(np.random.default_rng(41), B=2, m=m, n=n,
                            feasible_start=False)
    assert not tableau_in_smem(m, n, rule)
    assert block_threads(m, n) * 5 < n + m + 1
    A, b, c, ub = batch_tensors(batch, dev)
    kw = dict(m=m, n=n, max_iters=40, pricing=rule)
    work = torch.zeros((2, WORK_COUNTERS), dtype=torch.int32, device=dev)
    work_plain = torch.zeros_like(work)
    got = simplex_tile(A, b, c, ub, work=work, **kw)
    want = simplex_tile_plain(A, b, c, ub, work=work_plain, **kw)
    torch.cuda.synchronize()
    _equal_outputs(got, want)
    torch.testing.assert_close(work, work_plain, rtol=0, atol=0)
    assert int(work[:, 0].min()) > 0
    state = TorchBackend(m, n, TOL, FEAS_TOL, pricing=rule).init(A, b, c, ub)
    seg, it = segment_tile(map_state(torch.clone, state), 36,
                           stage="p1", **kw)
    seg_want, it_want = segment_tile_plain(state, 36, stage="p1", **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(it, it_want, rtol=0, atol=0)
    for name, g, w in zip(CompactionState._fields, seg, seg_want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                   msg=name)
