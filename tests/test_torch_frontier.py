"""The port's frontier scheduler and combined segments against the
reference's.

One plain ``segment_combined`` runs from a mid-solve full-tableau state of
the reference's ``JaxBackend`` (lanes in phase 1, in phase 2 and seeded
from a warm carrier), carried over by
``interop.compaction_state_from_reference``; every leaf equals the
reference's after its own ``segment_combined``.  ``FrontierScheduler``
drains one scripted stream in both packages (admissions mid-run, cold and
warm newcomers, lanes 4 and 8): each tag's x, objective, status,
iterations and warm basis are equal bit for bit.  The CUDA stage behind
``KernelBackend.run_combined`` is held against the plain version on the
card (tests/test_torch_package.py, marker ``gpu``; chip_smoke.py).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import WarmStart as WarmStartRef
from repro.core import random_lp_batch
from repro.core.compaction import FrontierScheduler as FrontierRef
from repro.core.compaction import JaxBackend
from repro.core.compaction import segment_combined as segment_combined_ref
from repro.core.simplex import solve_batched_jax
from repro_torch.core.compaction import (FrontierScheduler, SegmentStat,
                                         TorchBackend, map_state,
                                         segment_combined)
from repro_torch.core.lp import WarmStart
from repro_torch.interop import compaction_state_from_reference
from repro_torch.kernels.ops import KernelBackend
from repro_torch.obs import SpanTracer

RULES = ("dantzig", "devex", "steepest_edge")
LEAVES = ("T", "basis", "phase", "status", "iters", "w", "flip", "ub", "thr")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _lps(seed, B, m=7, n=6):
    """Phase-1 and feasible-start LPs, interleaved, with some native upper
    bounds: (A, b, c, ub) as NumPy."""
    rng = np.random.default_rng(seed)
    p1 = random_lp_batch(rng, B, m, n, feasible_start=False)
    fs = random_lp_batch(rng, B, m, n, feasible_start=True)
    pick = np.arange(B) % 2 == 0
    A = np.where(pick[:, None, None], p1.A, fs.A)
    b = np.where(pick[:, None], p1.b, fs.b)
    c = np.where(pick[:, None], p1.c, fs.c)
    ub = rng.uniform(0.05, 0.6, size=(B, n))
    ub[:, ::3] = np.inf
    return A, b, c, ub


def _warm_parents(A, b, c, ub, rule):
    """The terminal carrier of the batch, as a reference ``WarmStart``
    (the port's engine, bit-equal to the reference's ``solve_batched_jax``
    on these LPs, makes it without a compile)."""
    from repro_torch.core import LPBatch, solve_batched_torch
    from repro_torch.interop import warm_to_reference
    res = solve_batched_torch(LPBatch.from_arrays(A, b, c, ub=ub),
                              device="cpu", pricing=rule)
    return warm_to_reference(res.warm_start(), WarmStartRef)


def _ref_state(rule, seed=3, B=8, steps=3):
    """A reference full-tableau state after ``steps`` combined steps from
    an init whose odd lanes were seeded from a parent basis."""
    A, b, c, ub = _lps(seed, B)
    m, n = A.shape[1:]
    ws = _warm_parents(A, b, c, ub, rule)
    b2 = b * np.where(np.arange(B)[:, None] % 4 == 1, 0.7, 1.0)
    cold = WarmStartRef(m=m, n=n,
                        basis=np.tile(np.arange(n, n + m, dtype=np.int32),
                                      (B, 1)),
                        at_upper=np.zeros((B, n), bool))
    odd = (np.arange(B) % 2 == 1)
    warm = WarmStartRef(
        m=m, n=n, basis=np.where(odd[:, None], ws.basis, cold.basis),
        at_upper=np.where(odd[:, None], ws.at_upper, cold.at_upper),
        weights=None if rule != "devex" else np.asarray(ws.weights),
        pricing=rule)
    be = JaxBackend(m, n, 1e-6, 1e-5, jnp.float32, pricing=rule)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    state = be.init(f32(A), f32(b2), f32(c), ub=f32(ub), warm=warm)
    state, _ = segment_combined_ref(state, jnp.int32(steps), m=m, n=n,
                                    tol=1e-6, rule=be.rule)
    return state, m, n


@pytest.mark.parametrize("rule", RULES)
def test_segment_combined_equals_the_reference(rule):
    ref, m, n = _ref_state(rule)
    phase = np.asarray(ref.phase)
    running = np.asarray(ref.status) == -1
    assert (running & (phase == 1)).any() and (running & (phase == 2)).any()
    state = compaction_state_from_reference(ref, m=m, n=n)
    for steps in (1, 4):
        want, it_ref = segment_combined_ref(ref, jnp.int32(steps), m=m, n=n,
                                            tol=1e-6, rule=rule)
        got, it = segment_combined(state, steps, m=m, n=n, max_iters=10_000,
                                   tol=1e-6, rule=rule)
        assert int(it.max()) == int(it_ref)
        carried = compaction_state_from_reference(want, m=m, n=n)
        for leaf in LEAVES:
            torch.testing.assert_close(getattr(got, leaf),
                                       getattr(carried, leaf), rtol=0,
                                       atol=0, equal_nan=True, msg=leaf)
        # the plain run_combined of both backends is this segment
        for be in (TorchBackend(m, n, 1e-6, 1e-5, pricing=rule),
                   KernelBackend(m, n, 1e-6, 1e-5, pricing=rule)):
            again, done = be.run_combined(state, steps, 10_000)
            assert done == int(it_ref)
            for leaf in LEAVES:
                assert torch.equal(getattr(again, leaf), getattr(got, leaf))


def test_segment_combined_caps_each_lp_in_either_phase():
    """An LP still running at its own cap ends at ITERATION_LIMIT inside
    the segment, in phase 1 or in phase 2 (the reference retires it only
    after the segment; below the cap the two agree)."""
    ref, m, n = _ref_state("dantzig")
    state = compaction_state_from_reference(ref, m=m, n=n)
    cap = int(state.iters.max()) + 1
    got, it = segment_combined(state, 8, m=m, n=n, max_iters=cap, tol=1e-6)
    running = state.status == -1
    assert bool((got.iters[running] <= cap).all())
    assert not bool(((got.status == -1) & (got.iters >= cap)).any())
    capped = running & (got.status == 3)
    assert bool((capped & (got.phase == 1)).any())
    assert bool((capped & (got.phase == 2)).any())
    # one step: the same step, only the LPs that reach the cap are marked
    free, _ = segment_combined(state, 1, m=m, n=n, max_iters=10_000,
                               tol=1e-6)
    one, _ = segment_combined(state, 1, m=m, n=n, max_iters=cap, tol=1e-6)
    for leaf in LEAVES:
        if leaf != "status":
            assert torch.equal(getattr(free, leaf), getattr(one, leaf)), leaf
    marked = (free.status == -1) & (free.iters >= cap)
    assert bool(marked.any())
    assert torch.equal(torch.where(marked, 3, free.status), one.status)


def test_scatter_replaces_every_leaf_of_the_lanes():
    A, b, c, ub = (torch.as_tensor(a, dtype=torch.float32)
                   for a in _lps(5, 6))
    m, n = A.shape[1:]
    be = TorchBackend(m, n, 1e-6, 1e-5, pricing="devex")
    pool = be.init(A, b, c, ub, telemetry=True)
    pool, _ = be.run_combined(pool, 3, 100)
    new = be.init(A[:2] * 2.0, b[:2], c[:2], ub[:2], telemetry=True)
    got = be.scatter(pool, new, [4, 1])
    for g, p, w in zip(
            [t for t in got if isinstance(t, torch.Tensor)] + list(got.tel),
            [t for t in pool if isinstance(t, torch.Tensor)]
            + list(pool.tel),
            [t for t in new if isinstance(t, torch.Tensor)] + list(new.tel)):
        assert torch.equal(g[[4, 1]], w)
        assert torch.equal(g[[0, 2, 3, 5]], p[[0, 2, 3, 5]])
    clone = map_state(torch.clone, pool)
    be.scatter(pool, map_state(lambda t: t[:1], new), [0])
    assert all(torch.equal(a, b) for a, b in zip(
        [t for t in pool if isinstance(t, torch.Tensor)],
        [t for t in clone if isinstance(t, torch.Tensor)]))


# ---- the scheduler on one scripted stream in both packages ---------------

def _drive(cls, warm_cls, lanes, rule, data, **kw):
    """Drain a scripted stream through ``cls``: 12 LPs admitted at most
    three at a time; a retired LP with an even tag below 8 pushes a child
    (LP tag + 8, b scaled) that starts warm from its parent's basis.
    Returns {tag: result row}, the admissions, the retirement order and
    {tag: the parent carrier} of the warm newcomers."""
    A, b, c, ub = data
    B, m, n = A.shape
    pool = [(t, None) for t in range(6)]
    out, admitted, order, parents = {}, [], [], {}

    def cold():
        return warm_cls(m=m, n=n,
                        basis=np.arange(n, n + m, dtype=np.int32)[None],
                        at_upper=np.zeros((1, n), bool))

    def source(k):
        if not pool:
            return None
        take = pool[:min(k, 3)]
        del pool[:len(take)]
        idx = np.array([t % B for t, _ in take])
        scale = np.array([0.8 if t >= 8 else 1.0 for t, _ in take])
        parts = [w if w is not None else cold() for _, w in take]
        warm = warm_cls(
            m=m, n=n, basis=np.concatenate([p.basis for p in parts]),
            at_upper=np.concatenate([p.at_upper for p in parts]))
        admitted.append([t for t, _ in take])
        return (A[idx], b[idx] * scale[:, None], c[idx], ub[idx], warm,
                [t for t, _ in take])

    def sink(tag, row):
        out[tag] = row
        order.append(tag)
        if tag < 8 and tag % 2 == 0:
            pool.append((tag + 8, row["warm"]))
            parents[tag + 8] = row["warm"]
        if tag == 5:
            pool.extend([(6, None), (7, None)])

    got = cls(m, n, lanes=lanes, pricing=rule, segment_k=3, **kw).run(
        source, sink)
    assert got == len(out)
    return out, admitted, order, parents


def _child(data, tag, parent, copies=2):
    """The canonical batch (``copies`` copies) and carrier of warm
    newcomer ``tag`` as the reference's engine takes them."""
    from repro.core.lp import LPBatch
    A, b, c, ub = data
    i = tag % A.shape[0]
    rep = lambda a: np.repeat(a[i:i + 1], copies, axis=0)  # noqa: E731
    batch = LPBatch.from_arrays(rep(A), rep(b) * 0.8, rep(c), ub=rep(ub))
    warm = WarmStartRef(m=parent.m, n=parent.n,
                        basis=np.repeat(parent.basis, copies, axis=0),
                        at_upper=np.repeat(parent.at_upper, copies, axis=0))
    return batch, warm


@pytest.mark.parametrize("lanes,rule", [(4, "dantzig"),
                                        (8, "steepest_edge")])
def test_frontier_scheduler_equals_the_reference_per_tag(lanes, rule):
    data = _lps(11, 8)
    want, adm_ref, order_ref, parents = _drive_reference(lanes, rule)
    stats = []
    tracer = SpanTracer()
    got, adm, order, _ = _drive(FrontierScheduler, WarmStart, lanes, rule,
                                data, device="cpu", stats_out=stats,
                                tracer=tracer)
    assert adm == adm_ref and order == order_ref
    assert sorted(got) == sorted(want) and len(got) == 12
    for tag in want:
        g, w = got[tag], want[tag]
        assert g["status"] == w["status"] and \
            g["iterations"] == w["iterations"], tag
        for f in ("x", "y", "z"):
            np.testing.assert_array_equal(np.asarray(g[f]),
                                          np.asarray(w[f]), err_msg=f)
        # a warm newcomer's objective is held against the reference's
        # jitted engine: the reference's frontier injects through eager
        # ops, which round the warm vertex's objective otherwise
        # (test_reference_frontier_rounds_the_warm_objective_eagerly)
        obj = w["objective"]
        if tag in parents:
            batch, warm = _child(data, tag, parents[tag])
            obj = solve_batched_jax(batch, pricing=rule,
                                    warm=warm).objective[0]
        np.testing.assert_array_equal(np.asarray(g["objective"]),
                                      np.asarray(obj), err_msg=str(tag))
        np.testing.assert_array_equal(g["warm"].basis, w["warm"].basis)
        np.testing.assert_array_equal(g["warm"].at_upper,
                                      w["warm"].at_upper)
    assert any(got[t]["status"] == 0 for t in got)
    assert all(isinstance(s, SegmentStat) and s.stage == "frontier"
               and s.bucket == lanes for s in stats)
    spans = [s for root in tracer.roots for s in root.walk()]
    assert sum(s.name == "segment[frontier]" for s in spans) == len(stats)
    events = tracer.root_events + [e for s in spans for e in s.events]
    assert sum(e["name"] == "admit" for e in events) == len(adm)
    assert sum(e["name"] == "retire" for e in events) == 12


def test_frontier_scheduler_validates_its_source():
    data = _lps(2, 4)
    A, b, c, ub = data
    m, n = A.shape[1:]
    with pytest.raises(ValueError, match="lanes"):
        FrontierScheduler(m, n, lanes=0, device="cpu")
    sched = FrontierScheduler(m, n, lanes=2, device="cpu")
    with pytest.raises(ValueError, match="free lanes"):
        sched.run(lambda k: (A, b, c, ub, None, [0, 1, 2, 3]),
                  lambda tag, row: None)
    assert sched.lanes == 2
    assert FrontierScheduler(m, n, lanes=5, device="cpu").lanes == 8
    assert isinstance(sched.backend, TorchBackend)
    assert sched.run(lambda k: None, lambda tag, row: None) == 0


@functools.lru_cache(maxsize=None)
def _drive_reference(lanes, rule):
    return _drive(FrontierRef, WarmStartRef, lanes, rule, _lps(11, 8))


def test_reference_frontier_rounds_the_warm_objective_eagerly():
    """The reference's frontier scheduler injects a warm newcomer through
    ``JaxBackend.init`` outside ``jit``: its warm vertex's objective
    (``sum(cB * rhs)``) rounds each product before the sum, where the
    reference's jitted engine (``solve_batched_jax(warm=...)``, and so the
    port's ``fp.colsum_fma``) fuses every term into one rounding.  On one
    newcomer of the scripted stream the two differ by an ulp; the port
    follows the jitted engine (ROADMAP.md, queue 3)."""
    import jax
    from repro.core.simplex import inject_tableau_warm
    data = _lps(11, 8)
    want, _, _, parents = _drive_reference(4, "dantzig")
    batch, warm = _child(data, 12, parents[12], copies=1)
    m, n = batch.m, batch.n
    f32 = lambda a: jnp.asarray(np.asarray(a), jnp.float32)  # noqa: E731
    args = (f32(batch.A), f32(batch.b), f32(batch.c),
            f32(batch.upper_bounds()), jnp.asarray(warm.basis),
            jnp.asarray(warm.at_upper))
    eager = inject_tableau_warm(*args, m=m, n=n, feas_tol=1e-5)[0]
    fused = jax.jit(functools.partial(inject_tableau_warm, m=m, n=n,
                                      feas_tol=1e-5))(*args)[0]
    assert want[12]["iterations"] == 0
    assert -float(eager[0, m, -1]) == float(want[12]["objective"])
    assert eager[0, m, -1] != fused[0, m, -1]
    assert np.nextafter(np.float32(eager[0, m, -1]),
                        np.float32(fused[0, m, -1])) == fused[0, m, -1]
    batch2, warm2 = _child(data, 12, parents[12])
    assert -float(fused[0, m, -1]) == float(
        solve_batched_jax(batch2, warm=warm2).objective[0])
