#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from src/repro_torch/kernels/csrc (one nvcc per
source, in parallel), then drives the port's main path,
``repro_torch.core.solve_batched`` with no device argument, at two of the
paper's workloads (src/repro/configs/paper_lp.py):

1. ``lp_100d_50k``: 50,000 random 100 x 100 LPs of the Table-4 phase-1
   class; the first 64 are held against the float64 oracle with the
   reference's tolerance (status agreement >= 0.95, relative objective
   < 2e-3);
2. ``lp_afiro_100k``: 100,000 perturbed copies of Netlib AFIRO through the
   general-form pipeline; member 0 must reproduce the published optimum
   -4.6475314286E+02 (rtol 1e-4) and the first 64 hold against the oracle.

The kernel's launch counter is zeroed before the main path and must be
positive after it.  Then the kernel is held against its plain PyTorch
version on 2,048-LP slices of both batches for each pricing rule (status,
iterations and per-LP work counts equal; x, objective, y and z within 1e-5
relative; the two compute the same function, so they agree bit for bit)
and on 2,048 copies of
sc205_like, whose tableau does not fit in shared memory (the
device-memory variant; the plain version checks the first 128).

Then the compaction path: ``solve_batched(lp_100d_50k, compaction=True)``
on all 50,000 LPs goes through the segment kernel only (no whole-solve
launch) and must equal the whole-solve run bit for bit; on a 2,048-LP slice
at ``max_iters=200`` the two paths must agree, ITERATION_LIMIT included.
The segment kernel is held against its plain version on 2,048-LP slices of
lp_100d_50k and lp_afiro_100k and on sc205_like (plain version on the first
128) for every rule: one launch of each stage, leaf by leaf, and the whole
scheduled solve (status, iterations and work equal; x, objective, y, z
within rel 1e-5).  Last, the box LP: the Table-7 flow-pipe (n = 5, T = 500,
K = 40, so 20,000 box LPs) through ``solve_hyperbox`` on the card, against
the kernel's plain version (exact), the float64 oracle (rel 1e-5) and the
same LPs through ``solve_batched`` (rel 1e-4); the kernel is timed there
and at T = 50,000 (2,000,000 boxes).

The revised path (before the box LP): ``solve_batched(lp_100d_50k,
backend="revised")`` on all 50,000 LPs through the revised kernel, with
Dantzig and with partial pricing, each held against the oracle and against
the tableau run's statuses.  Warm starts: ``lp_afiro_100k`` solved cold
through the revised kernel (member 0 at the published optimum), re-solved
from its own ``warm_start()`` (every OPTIMAL member at 0 iterations), and
step 1 of a 100,000-member perturbed AFIRO trajectory solved warm from
step 0 against its cold solve (equal statuses, objectives within rel
2e-3, no more iterations).  The kernel is held against its plain version
on 2,048-LP slices of both batches for both rules (one launch of each
stage leaf by leaf, then the whole solve, every output and work count
equal) and on sc205_like's device-memory variant (plain version on the
first 128, max_iters 600); ``compaction=True`` on the slices through the
kernel equals the plain-backed schedule bit for bit and the whole solve in
statuses (objectives within rel 1e-3).  Last, the kernel is timed on all
50,000 LPs of lp_100d_50k beside its bound.

Restarted PDHG (after the revised path): ``solve_batched(lp_100d_50k,
backend="pdhg")`` on all 50,000 LPs through the whole-solve PDHG kernel
only (the first 64 against the oracle, statuses compared with the tableau
run); ``compaction=True`` on all 50,000 through the segment kernel only,
equal to the whole solve bit for bit; ``lp_afiro_100k`` cold (member 0 at
the published optimum) and re-solved from its own ``warm_start()`` (equal
statuses, objectives within rel 2e-3, at most a quarter of the cold mean
iterations).  Each kernel is held against its plain version: the whole
solve on 2,048-LP slices of lp_100d_50k (plain version on the first 512,
``max_iters`` 20,000 for both) and lp_afiro_100k, Malitsky-Pock on
lp_100d_50k (plain on 128, ``max_iters`` 1,600), sc205_like (A in shared
memory, plain on 128, 4,000) and 256 LPs of lp_300d_2k (A in device
memory, ``max_iters`` 40,000; plain on 64 of them, the members the kernel
solved first and the rest from those at the cap, at least one OPTIMAL),
every output equal; one segment launch from a mid-solve state leaf by
leaf; the kernel-backed schedule equal to the plain-backed one (plain on
512) and to the whole solve at ``max_iters`` 8,000.  The peak device
memory of each main-path solve stays within the chunk plan's bytes per LP
(``core.pdhg.pdhg_bytes_per_lp``).  The sparse engine runs
SparseLPBatch.from_dense of sc205_like on the card against the dense
kernel at ``max_iters`` 20,000 (equal statuses, objectives within rel
1e-3; its sums follow the dense kernel's order, so every output is
equal).  Last, the whole-solve kernel is timed on all 50,000 LPs beside
its bound and a torch.bmm yardstick.

Every launch counter is zeroed just before each main-path run and read just
after.  Lines of JSON report each phase; the line before the last is the
kernel table, then the card's name and power limit, and the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises and the script
exits non-zero without that line; so does a run without a card.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

AFIRO_OPT = -464.7531428571429
SLICE = 2048
PEAK_F32_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
RULES = ("dantzig", "devex", "steepest_edge")


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _wrappers():
    from repro_torch.kernels import (hyperbox_tile, pdhg_segment_tile,
                                     pdhg_tile, revised_segment_tile,
                                     segment_tile, simplex_tile)
    return {"simplex_tile": simplex_tile, "simplex_segment": segment_tile,
            "hyperbox": hyperbox_tile,
            "revised_segment": revised_segment_tile, "pdhg": pdhg_tile,
            "pdhg_segment": pdhg_segment_tile}


def zero_counts():
    for wrapper in _wrappers().values():
        wrapper.launches = 0


def counts() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


def only(name) -> int:
    """The launches of kernel ``name`` since zero_counts(); fails unless it
    launched and no other kernel did."""
    got = counts()
    assert got[name] > 0, (name, "launched no kernel", got)
    assert all(v == 0 for k, v in got.items() if k != name), (name, got)
    return got[name]


def timed(fn):
    """(result, milliseconds) of fn() on the current stream."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_oracle(name, res, ref):
    """The reference's tolerance against the float64 oracle."""
    import numpy as np
    agree = float((res.status[:len(ref.status)] == ref.status).mean())
    ok = (ref.status == 0) & (res.status[:len(ref.status)] == 0)
    rel = float(np.max(np.abs(res.objective[:len(ref.status)][ok]
                              - ref.objective[ok])
                       / np.abs(ref.objective[ok])))
    assert agree >= 0.95, (name, agree)
    assert rel < 2e-3, (name, rel)
    return {"oracle_lps": len(ref.status), "oracle_status_agree": agree,
            "oracle_max_rel_obj": rel}


def solve_main(name, batch, oracle_batch):
    """Drive solve_batched once; hold the result against the oracle."""
    import numpy as np
    from repro_torch.core import solve_batched, solve_batched_reference
    from repro_torch.kernels import simplex_tile

    zero_counts()
    t0 = time.perf_counter()
    res = solve_batched(batch)
    wall = time.perf_counter() - t0
    launches = simplex_tile.launches
    assert launches > 0, f"{name}: the main path launched no kernel"
    assert only("simplex_tile") == launches
    B = res.status.shape[0]
    assert res.x.shape == (B, batch.n) and res.objective.shape == (B,)
    opt = res.status == 0
    assert np.isfinite(res.x[opt]).all() and np.isfinite(res.objective[opt]).all()
    info = {"batch": name, "lps": B, "wall_s": wall, "lps_per_s": B / wall,
            "launches": launches,
            "status_counts": np.bincount(res.status.astype(int),
                                         minlength=4).tolist(),
            "mean_iterations": float(res.iterations.mean())}
    info.update(check_oracle(name, res, solve_batched_reference(oracle_batch)))
    emit(info)
    return res, launches, wall


def compare(name, lp, rule, n_lp=SLICE, n_plain=SLICE, max_iters=None):
    """The kernel on the first n_lp LPs of a canonical batch, against the
    plain version on the first n_plain of them (the same inputs): statuses,
    iterations and work counts equal, x, objective, y and z within 1e-5
    relative (NaN where NaN)."""
    import numpy as np
    import torch
    from repro_torch.core.lp import LPBatch, default_max_iters
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels.simplex_tile import (WORK_COUNTERS, simplex_tile,
                                                  simplex_tile_plain,
                                                  tableau_in_smem)
    sub = LPBatch(A=lp.A[:n_lp], b=lp.b[:n_lp], c=lp.c[:n_lp],
                  ub=None if lp.ub is None else lp.ub[:n_lp])
    A, b, c, ub = batch_tensors(sub, torch.device("cuda"))
    if max_iters is None:
        max_iters = default_max_iters(lp.m, lp.n)
    kw = dict(m=lp.m, n=lp.n, max_iters=max_iters, pricing=rule)
    k = n_plain
    work = torch.zeros((n_lp, WORK_COUNTERS), dtype=torch.int32,
                       device="cuda")
    work_plain = torch.zeros((k, WORK_COUNTERS), dtype=torch.int32,
                             device="cuda")
    got, ms = timed(lambda: simplex_tile(A, b, c, ub, work=work, **kw))
    want, plain_ms = timed(lambda: simplex_tile_plain(
        A[:k], b[:k], c[:k], ub[:k].contiguous(), work=work_plain, **kw))
    work = work.cpu().numpy()
    work_plain = work_plain.cpu().numpy()
    got = [t[:k].cpu().numpy() for t in got]
    want = [t.cpu().numpy() for t in want]
    st_eq = bool(np.array_equal(got[2], want[2]))
    it_diff = int((got[3] != want[3]).sum())
    work_diff = int((work[:k] != work_plain).any(axis=1).sum())
    opt = (got[2] == 0) & (want[2] == 0)
    rel = float(np.max(np.abs(got[1][opt] - want[1][opt])
                       / np.abs(want[1][opt]), initial=0.0))
    err = max(float(np.max(np.abs(g - w), initial=0.0,
                           where=np.isfinite(g) & np.isfinite(w)))
              for g, w in zip(got, want) if g.dtype.kind == "f")
    assert st_eq, (name, rule, "statuses differ")
    assert it_diff == 0, (name, rule, it_diff)
    assert work_diff == 0, (name, rule, "work counts differ", work_diff)
    assert rel <= 1e-5, (name, rule, rel)
    for i, what in ((0, "x"), (1, "objective"), (4, "y"), (5, "z")):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5, atol=0,
                                   equal_nan=True,
                                   err_msg=f"{name} {rule} {what}")
    out = {"compare": name, "pricing": rule, "lps": n_lp, "plain_lps": k,
           "max_iters": max_iters,
           "tableau_in_smem": tableau_in_smem(lp.m, lp.n, rule),
           "status_counts": np.bincount(got[2].astype(int),
                                        minlength=4).tolist(),
           "status_equal": st_eq, "iteration_diffs": it_diff,
           "work_diffs": work_diff, "max_rel_obj": rel, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms}
    out.update(bound(lp.m, lp.n, n_lp, work))
    emit(out)
    return out


def bound(m, n, B, work):
    """Least time for the work this run's data needs, from the kernel's
    per-LP counts (phase-1 pivots, phase-2 pivots, bound flips): the larger
    of the operations time and the bytes time.

    Operations, at the f32 rate outside the tensor cores: a phase-1 pivot
    divides the pivot row of the full (m+2) x (n+2m+1) tableau and updates
    its other m+1 rows (2 flops an entry); a phase-2 pivot does the same on
    the compacted (m+1) x (n+m+1) view; a flip updates one rhs entry per
    row.  Pricing and the ratio test are left out, so this is a floor.
    Bytes, at the memory rate: A, b, c and ub read once; x, y, z, the
    objective, status and iterations written once."""
    p1, p2, flips = (int(v) for v in work.sum(axis=0))
    C1, C2 = n + 2 * m + 1, n + m + 1
    flops = (p1 * (2 * (m + 1) * C1 + C1) + p2 * (2 * m * C2 + C2)
             + flips * 2 * (m + 1))
    nbytes = B * 4 * ((m * n + m + 2 * n) + (2 * n + m + 3))
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return {"phase1_pivots": p1, "phase2_pivots": p2, "flips": flips,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def kernel_at_full_batch(name, lp):
    """The wrapper once over a whole canonical batch (tableau build and
    kernel), timed on the card; not a main-path launch."""
    import torch
    from repro_torch.core.lp import default_max_iters
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels.simplex_tile import WORK_COUNTERS, simplex_tile
    A, b, c, ub = batch_tensors(lp, torch.device("cuda"))
    work = torch.zeros((lp.batch, WORK_COUNTERS), dtype=torch.int32,
                       device="cuda")
    out, ms = timed(lambda: simplex_tile(
        A, b, c, ub, m=lp.m, n=lp.n, max_iters=default_max_iters(lp.m, lp.n),
        work=work))
    iters = out[3].to(torch.int64)
    idle = iters - work.to(torch.int64).sum(dim=1)
    assert bool(((idle >= 0) & (idle <= 2)).all()), (name, "work counts")
    info = {"kernel_full_batch": name, "lps": lp.batch, "ms": ms,
            "iterations_sum": int(iters.sum())}
    info.update(bound(lp.m, lp.n, lp.batch, work.cpu().numpy()))
    emit(info)
    del A, b, c, ub, out, work
    torch.cuda.empty_cache()
    return info


def state_bytes(m, n, rule, stage):
    """Bytes one LP's segment state moves per launch when its block loads
    it: the stage's tableau, basis, weights (weighted rules), flips,
    phase, status, iterations and work counters read and written; bounds
    and threshold read; the step count written."""
    rows, cols = (m + 2, n + 2 * m + 1) if stage == "p1" else (m + 1,
                                                                n + m + 1)
    rw = 4 * (rows * cols + m + 3 + 3) + n
    if rule != "dantzig":
        rw += 4 * (n + m)
    return 2 * rw + 4 * n + 4 + 4


IDLE_BLOCK_BYTES = 16   # phase, status, iterations read; step count written


def timed_backend(cls, bytes_fn=None):
    """``cls`` (a scheduler backend) with each segment launch and each
    gather timed by CUDA events, and the state bytes each launch moves
    summed (``bytes_fn``, by default the tableau's ``state_bytes``): the
    LPs with steps to take load and store their state, the others read
    three words and write one."""
    bytes_fn = state_bytes if bytes_fn is None else bytes_fn
    from repro_torch.core.compaction import segment_pending

    class Timed(cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.segment_ms, self.gather_ms, self.launch_bytes = [], [], []

        @property
        def moved(self):
            return sum(self.launch_bytes)

        def segment(self, state, steps, stage, max_iters):
            bucket = state.status.shape[0]
            loaded = int(segment_pending(state, stage, max_iters).sum())
            out, ms = timed(lambda: super(Timed, self).segment(
                state, steps, stage, max_iters))
            self.segment_ms.append(ms)
            self.launch_bytes.append(
                loaded * bytes_fn(self.m, self.n, self.rule, stage)
                + (bucket - loaded) * IDLE_BLOCK_BYTES)
            return out

        def take(self, state, idx):
            out, ms = timed(lambda: super(Timed, self).take(state, idx))
            self.gather_ms.append(ms)
            return out
    return Timed


def schedule(backend, A, b, c, ub, *, max_iters):
    """Drive ``backend`` through run_schedule on device tensors; returns
    (result, the per-LP work counts, stats, total ms)."""
    import numpy as np
    from repro_torch.core.compaction import run_schedule
    stats = []

    def run():
        state = backend.init(A, b, c, ub)
        work = np.zeros(tuple(state.work.shape), np.int64)
        return run_schedule(backend, state, max_iters=max_iters,
                            stats_out=stats, work_out=work), work
    (res, work), ms = timed(run)
    return res, work, stats, ms


def ladder(stats):
    return [[s.stage, s.bucket, s.steps, s.survivors] for s in stats]


def same_result(a, b, fields=("status", "iterations", "x", "objective")):
    import numpy as np
    return all(np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True)
               for f in fields)


def compaction_main(lp100, res_whole, wall_whole, full_batch):
    """The compaction path: solve_batched(compaction=True) on every LP of
    lp_100d_50k, through the segment kernel only; bit-equal to the
    whole-solve run on the same batch."""
    import numpy as np
    import torch
    from repro_torch.core import LPBatch, solve_batched, solve_batched_reference
    stats = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    res = solve_batched(lp100, compaction=True, stats_out=stats)
    wall = time.perf_counter() - t0
    got = counts()
    only("simplex_segment")
    peak = torch.cuda.max_memory_allocated()
    assert same_result(res, res_whole), "compaction != whole solve"
    head = LPBatch(A=lp100.A[:64], b=lp100.b[:64], c=lp100.c[:64])
    info = {"compaction_main": "lp_100d_50k", "lps": lp100.batch,
            "wall_s": wall, "lps_per_s": lp100.batch / wall,
            "launches": got["simplex_segment"], "segments": len(stats),
            "bitwise_equal_whole_solve": True,
            "ladder_stage_bucket_steps_survivors": ladder(stats),
            "peak_device_bytes": peak,
            "device_total_bytes":
                torch.cuda.get_device_properties(0).total_memory,
            "state_bytes_per_launch_if_all_load": [
                s.bucket * state_bytes(lp100.m, lp100.n, "dantzig", s.stage)
                for s in stats],
            "whole_solve_wall_s": wall_whole,
            "bound_ms_same_pivots": full_batch["bound_ms"]}
    info.update(check_oracle("lp_100d_50k compaction", res,
                             solve_batched_reference(head)))
    emit(info)
    return got["simplex_segment"], info


def binding_budget(lp100, max_iters):
    """compaction=True against compaction=False where max_iters binds."""
    import numpy as np
    from repro_torch.core import LPBatch, solve_batched
    sub = LPBatch(A=lp100.A[:SLICE], b=lp100.b[:SLICE], c=lp100.c[:SLICE])
    seg = solve_batched(sub, compaction=True, max_iters=max_iters)
    whole = solve_batched(sub, max_iters=max_iters)
    assert same_result(seg, whole, ("status", "iterations", "x", "objective",
                                    "y", "z")), "binding budget differs"
    limited = int((whole.status == 3).sum())
    assert limited > 0, "max_iters did not bind"
    emit({"binding_budget": "lp_100d_50k", "lps": SLICE,
          "max_iters": max_iters, "iteration_limit_lps": limited,
          "status_counts": np.bincount(whole.status.astype(int),
                                       minlength=4).tolist(),
          "equal": True})


def segment_at_full_batch(lp, full_batch):
    """The scheduled solve through KernelBackend on a whole canonical
    batch, every launch and gather timed on the card; not a main-path run.
    Beside it the whole-solve wrapper's time on the same batch."""
    import torch
    from repro_torch.core.lp import default_max_iters
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels.ops import KernelBackend
    A, b, c, ub = batch_tensors(lp, torch.device("cuda"))
    kb = timed_backend(KernelBackend)(lp.m, lp.n, 1e-6, 1e-5)
    _, work, stats, ms = schedule(kb, A, b, c, ub,
                                  max_iters=default_max_iters(lp.m, lp.n))
    info = {"segment_full_batch": "lp_100d_50k", "lps": lp.batch,
            "segments": len(stats), "gathers": len(kb.gather_ms),
            "segment_ms": sum(kb.segment_ms),
            "p1_segment_ms": sum(t for t, s in zip(kb.segment_ms, stats)
                                 if s.stage == "p1"),
            "gather_ms": sum(kb.gather_ms), "scheduled_ms": ms,
            "whole_solve_ms": full_batch["ms"],
            "state_bytes_moved": kb.moved,
            "state_bytes_per_launch": kb.launch_bytes,
            "state_roundtrip_ms": kb.moved / PEAK_BYTES * 1e3}
    info.update(bound(lp.m, lp.n, lp.batch, work))
    emit(info)
    del A, b, c, ub
    torch.cuda.empty_cache()


def _clone(state):
    from repro_torch.core.compaction import CompactionState
    return CompactionState(*(leaf.clone() for leaf in state))


def _first(state, k):
    from repro_torch.core.compaction import CompactionState
    return CompactionState(*(leaf[:k].contiguous() for leaf in state))


def compare_segment_launches(name, backend, state, k, steps, max_iters):
    """One launch of each stage: the kernel on every LP, the plain version
    on the first k, every leaf equal (NaN where NaN)."""
    import torch
    from repro_torch.core.compaction import CompactionState, segment_pending
    from repro_torch.kernels.simplex_tile import (segment_tile,
                                                  segment_tile_plain)
    kw = dict(m=backend.m, n=backend.n, max_iters=max_iters,
              pricing=backend.rule)
    out = {}
    for stage in ("p1", "p2"):
        if stage == "p2":   # finish stage p1 with the kernel first
            while bool(segment_pending(state, "p1", max_iters).any()):
                state, _ = segment_tile(state, steps, stage="p1", **kw)
            state = backend.compact_columns(state)
        got, it = segment_tile(_clone(state), steps, stage=stage, **kw)
        want, want_it = segment_tile_plain(_first(state, k), steps,
                                           stage=stage, **kw)
        torch.cuda.synchronize()
        assert torch.equal(it[:k], want_it), (name, stage, "steps differ")
        for leaf, g, w in zip(CompactionState._fields, got, want):
            torch.testing.assert_close(g[:k], w, rtol=0, atol=0,
                                       equal_nan=True,
                                       msg=f"{name} {stage} {leaf}")
        out[stage] = {"steps_max": int(it.max()),
                      "running_after": int((got.status == -1).sum())}
        state = got
    return out


def compare_schedule(name, lp, rule, n_lp=SLICE, n_plain=SLICE,
                     max_iters=None):
    """The segment kernel against its plain version: one launch of each
    stage leaf by leaf, then the whole scheduled solve through KernelBackend
    (all n_lp LPs) against TorchBackend (the first n_plain): statuses,
    iterations and work equal; x, objective, y, z within rel 1e-5."""
    import numpy as np
    import torch
    from repro_torch.core.compaction import TorchBackend
    from repro_torch.core.lp import LPBatch, default_max_iters
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels.ops import KernelBackend
    from repro_torch.kernels.simplex_tile import tableau_in_smem
    sub = LPBatch(A=lp.A[:n_lp], b=lp.b[:n_lp], c=lp.c[:n_lp],
                  ub=None if lp.ub is None else lp.ub[:n_lp])
    A, b, c, ub = batch_tensors(sub, torch.device("cuda"))
    if max_iters is None:
        max_iters = default_max_iters(lp.m, lp.n)
    k = n_plain
    args = (lp.m, lp.n, 1e-6, 1e-5)
    kb = timed_backend(KernelBackend)(*args, pricing=rule)
    pb = timed_backend(TorchBackend)(*args, pricing=rule)
    launches = compare_segment_launches(name, kb, kb.init(A, b, c, ub), k,
                                        32, max_iters)
    kb = timed_backend(KernelBackend)(*args, pricing=rule)
    got, work, stats, sched_ms = schedule(kb, A, b, c, ub,
                                          max_iters=max_iters)
    want, work_plain, _, plain_sched_ms = schedule(
        pb, A[:k], b[:k], c[:k], ub[:k].contiguous(), max_iters=max_iters)
    take = lambda a: np.asarray(a)[:k]  # noqa: E731
    np.testing.assert_array_equal(take(got.status), want.status)
    np.testing.assert_array_equal(take(got.iterations), want.iterations)
    np.testing.assert_array_equal(work[:k], work_plain)
    err = 0.0
    for f in ("x", "objective", "y", "z"):
        g, w = take(getattr(got, f)), getattr(want, f)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, equal_nan=True,
                                   err_msg=f"{name} {rule} {f}")
        fin = np.isfinite(g) & np.isfinite(w)
        err = max(err, float(np.max(np.abs(g - w), initial=0.0, where=fin)))
    moved_ms = kb.moved / PEAK_BYTES * 1e3
    out = {"compare_segment": name, "pricing": rule, "lps": n_lp,
           "plain_lps": k, "max_iters": max_iters,
           "p1_tableau_in_smem": tableau_in_smem(lp.m, lp.n, rule),
           "p2_tableau_in_smem": tableau_in_smem(lp.m, lp.n, rule,
                                                 compacted=True),
           "one_launch": launches, "status_counts": np.bincount(
               np.asarray(got.status).astype(int), minlength=4).tolist(),
           "segments": len(stats), "gathers": len(kb.gather_ms),
           "ladder_stage_bucket_steps_survivors": ladder(stats),
           "max_abs_err": err, "ms": sum(kb.segment_ms),
           "gather_ms": sum(kb.gather_ms), "scheduled_ms": sched_ms,
           "plain_ms": sum(pb.segment_ms), "plain_scheduled_ms":
               plain_sched_ms, "state_bytes_moved": kb.moved,
           "state_roundtrip_ms": moved_ms}
    out.update(bound(lp.m, lp.n, n_lp, work))
    emit(out)
    return out


def flowpipe(rng, n, T):
    """The Table-7 reachability flow-pipe: T boxes of an n-dimensional
    linear system x' = A x with a slightly growing box (copied from the
    reference's benchmarks/table7_reachability.py, with a seeded rng)."""
    import numpy as np
    A = np.eye(n) + 0.01 * rng.normal(size=(n, n))
    lo, hi = [-0.1 * np.ones(n)], [0.1 * np.ones(n)]
    for _ in range(T - 1):
        c = (lo[-1] + hi[-1]) / 2
        r = (hi[-1] - lo[-1]) / 2
        c = A @ c
        r = np.abs(A) @ r + 1e-3
        lo.append(c - r)
        hi.append(c + r)
    return np.stack(lo), np.stack(hi)


def timed_avg(fn, reps=20, spin_cycles=50_000_000):
    """Mean device milliseconds of fn() over reps calls after one warm-up
    call.  A spin kernel (about 25 ms) queued before the first event keeps
    the card busy while the host enqueues the calls, so the host's time
    per call (tens of microseconds for a small launch from Python) does
    not count: the events then time the queued work back to back."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_hyperbox(lo, hi, d):
    """Kernel, plain version and the library composition on device
    tensors; the bound charges lo, hi and d read once and the output
    written once."""
    import torch
    from repro_torch.kernels import hyperbox_tile, hyperbox_tile_plain
    shared = d.shape[0] != lo.shape[0]
    ms = timed_avg(lambda: hyperbox_tile(lo, hi, d))
    plain_ms = timed_avg(lambda: hyperbox_tile_plain(lo, hi, d), reps=3)
    if shared:
        lib = lambda: (d[None] * torch.where(  # noqa: E731
            d[None] < 0, lo[:, None], hi[:, None])).sum(-1)
    else:
        lib = lambda: (d * torch.where(d < 0, lo, hi)).sum(-1)  # noqa: E731
    library_ms = timed_avg(lib)
    B, n = lo.shape
    outs = B * (d.shape[0] if shared else 1)
    nbytes = 4 * (2 * B * n + d.shape[0] * n + outs)
    return {"boxes": B, "outputs": outs, "n": n, "shared_directions": shared,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "3 calls: torch.where, multiply, sum",
            "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES * 1e3,
            "bound_by": "bytes"}


def box_lp():
    """The box-LP path: the Table-7 flow-pipe through solve_hyperbox on the
    card, held against the plain version, the float64 oracle and the
    simplex path; the kernel timed there and at T = 50,000."""
    import numpy as np
    import torch
    from repro_torch.core import (hyperbox_as_general_lp, solve_batched,
                                  solve_hyperbox, solve_hyperbox_ref)
    from repro_torch.kernels import hyperbox_tile, hyperbox_tile_plain
    rng = np.random.default_rng(2018)
    n, T, K = 5, 500, 40
    lo, hi = flowpipe(rng, n, T)
    dirs = rng.normal(size=(K, n))
    # expand to (T*K) box LPs, as the reference's Table-7 benchmark does
    lo_e, hi_e = np.repeat(lo, K, axis=0), np.repeat(hi, K, axis=0)
    d_e = np.tile(dirs, (T, 1))
    put = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                 device="cuda")
    tl, th, td = put(lo_e), put(hi_e), put(d_e)

    zero_counts()
    sup = solve_hyperbox(tl, th, td)
    torch.cuda.synchronize()
    got = counts()
    assert only("hyperbox") == 1, got
    assert sup.shape == (T * K,)
    assert torch.equal(sup, hyperbox_tile_plain(tl, th, td))
    ref = solve_hyperbox_ref(lo_e, hi_e, d_e)
    s = sup.cpu().numpy()
    rel = float(np.max(np.abs(s - ref) / np.abs(ref)))
    assert rel <= 1e-5, ("hyperbox vs oracle", rel)
    # the shared-direction form: every direction on every box
    shared = hyperbox_tile(put(lo), put(hi), put(dirs))
    assert torch.equal(shared, sup.reshape(T, K))
    assert torch.equal(shared, hyperbox_tile_plain(put(lo), put(hi),
                                                   put(dirs)))
    # the same LPs as general LPs through the simplex path
    lp, off = hyperbox_as_general_lp(lo_e, hi_e, d_e)
    res = solve_batched(lp)
    assert (res.status == 0).all()
    rel_lp = float(np.max(np.abs(res.objective + off - ref) / np.abs(ref)))
    assert rel_lp <= 1e-4, ("simplex vs support values", rel_lp)
    main = time_hyperbox(tl, th, td)
    main.update({"box_lp": "table7_flowpipe", "T": T, "K": K,
                 "launches": got["hyperbox"],
                 "max_abs_err": float((sup - hyperbox_tile_plain(
                     tl, th, td)).abs().max()),
                 "max_rel_vs_oracle": rel, "simplex_max_rel": rel_lp,
                 "simplex_mean_iterations": float(res.iterations.mean())})
    emit(main)
    # T = 50,000: the pipe's boxes grow about 2.5% a step and would
    # overflow, so the 500-step pipe is repeated 100 times
    reps = 100
    big = (put(np.tile(lo_e, (reps, 1))), put(np.tile(hi_e, (reps, 1))),
           put(np.tile(d_e, (reps, 1))))
    assert torch.equal(hyperbox_tile(*big), hyperbox_tile_plain(*big))
    emit(dict(time_hyperbox(*big), box_lp="table7_flowpipe", T=T * reps,
              K=K))
    emit(dict(time_hyperbox(put(np.tile(lo, (reps, 1))),
                            put(np.tile(hi, (reps, 1))), put(dirs)),
              box_lp="table7_flowpipe", T=T * reps, K=K))
    del big
    torch.cuda.empty_cache()
    return main


# ---- the revised simplex (core/revised.py, csrc/revised_tile.cu) ---------

REVISED_RULES = ("dantzig", "partial")


def revised_main(name, batch, oracle_batch, pricing, tableau_res=None):
    """Drive solve_batched(backend="revised") once through the revised
    kernel; hold the result against the oracle and, where given, count the
    statuses that agree with the tableau run of the same batch."""
    import numpy as np
    import torch
    from repro_torch.core import solve_batched, solve_batched_reference
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    res = solve_batched(batch, backend="revised", pricing=pricing)
    wall = time.perf_counter() - t0
    launches = only("revised_segment")
    B = res.status.shape[0]
    assert res.x.shape == (B, batch.n) and res.objective.shape == (B,)
    opt = res.status == 0
    assert np.isfinite(res.x[opt]).all() and np.isfinite(res.objective[opt]).all()
    assert res.warm is not None and res.warm.basis.shape[0] == B
    info = {"revised_main": name, "pricing": pricing, "lps": B,
            "wall_s": wall, "lps_per_s": B / wall, "launches": launches,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "status_counts": np.bincount(res.status.astype(int),
                                         minlength=4).tolist(),
            "mean_iterations": float(res.iterations.mean())}
    if tableau_res is not None:
        info["status_agree_with_tableau"] = float(
            (res.status == tableau_res.status).mean())
        both = opt & (tableau_res.status == 0)
        info["max_rel_obj_vs_tableau"] = float(np.max(
            np.abs(res.objective[both] - tableau_res.objective[both])
            / np.abs(tableau_res.objective[both]), initial=0.0))
    info.update(check_oracle(f"{name} revised {pricing}", res,
                             solve_batched_reference(oracle_batch)))
    emit(info)
    return res, launches


def same_answers(cold, warm, rtol=2e-3):
    """The reference's warm-start contract (tests/test_warm.py): equal
    statuses, OPTIMAL objectives within rtol."""
    import numpy as np
    np.testing.assert_array_equal(cold.status, warm.status)
    ok = cold.status == 0
    np.testing.assert_allclose(warm.objective[ok], cold.objective[ok],
                               rtol=rtol)
    return float(np.max(np.abs(warm.objective[ok] - cold.objective[ok])
                        / np.abs(cold.objective[ok]), initial=0.0))


def revised_warm(afiro, g, g64, traj_lps):
    """Warm starts through the revised kernel: lp_afiro_100k cold, then
    re-solved from its own optimum (0 iterations on every OPTIMAL member),
    then step 1 of a perturbed AFIRO trajectory warm from step 0, against
    its cold solve."""
    import numpy as np
    from repro_torch.core import solve_batched
    from repro_torch.io import perturbed_sequence
    res, launches = revised_main("lp_afiro_100k", g, g64, "dantzig")
    assert res.status[0] == 0
    np.testing.assert_allclose(res.objective[0], AFIRO_OPT, rtol=1e-4)
    zero_counts()
    t0 = time.perf_counter()
    again = solve_batched(g, backend="revised", warm=res.warm_start())
    wall = time.perf_counter() - t0
    launches += only("revised_segment")
    opt = res.status == 0
    assert (again.iterations[opt] == 0).all(), "warm re-solve pivoted"
    rel_again = same_answers(res, again, rtol=1e-5)
    seq = perturbed_sequence(afiro, traj_lps, 2, np.random.default_rng(2018))
    zero_counts()
    ws = solve_batched(seq[0], backend="revised").warm_start()
    cold = solve_batched(seq[1], backend="revised")
    t1 = time.perf_counter()
    warm = solve_batched(seq[1], backend="revised", warm=ws)
    wall_traj = time.perf_counter() - t1
    launches += only("revised_segment")
    rel = same_answers(cold, warm)
    cold_it = int(cold.iterations.astype(np.int64).sum())
    warm_it = int(warm.iterations.astype(np.int64).sum())
    assert warm_it <= cold_it, (warm_it, cold_it)
    emit({"revised_warm": "lp_afiro_100k", "member0_objective":
          float(res.objective[0]), "published": AFIRO_OPT,
          "resolve_wall_s": wall, "resolve_optimal_lps": int(opt.sum()),
          "resolve_max_iterations": int(again.iterations[opt].max()),
          "resolve_max_rel_obj": rel_again,
          "trajectory_lps": traj_lps, "trajectory_step": 1,
          "trajectory_status_counts": np.bincount(
              warm.status.astype(int), minlength=4).tolist(),
          "trajectory_max_rel_obj": rel, "cold_iterations_sum": cold_it,
          "warm_iterations_sum": warm_it, "warm_wall_s": wall_traj,
          "launches": launches})
    return launches


def revised_bound(m, n, B, work):
    """Least time for the revised work this run's data needed, from the
    kernel's per-LP counts (core/revised.py WORK_FIELDS: steps, pivots,
    flips, refactorizations, columns priced): the larger of the operations
    time and the bytes time.  Operations, at the f32 rate outside the
    tensor cores: BTRAN 2m^2 a step, pricing 2m a priced column, FTRAN 2m^2
    a pivot or flip, the eta update of Binv 2m^2 a pivot, a refactorization
    2m^3.  Bytes: A, b, c and ub read once; x, y, z, the objective, status,
    iterations, the basis and the bound flags written once."""
    steps, pivots, flips, refactors, priced = (int(v) for v in
                                               work.sum(axis=0))
    flops = (2 * m * m * (steps + flips + 2 * pivots) + 2 * m * priced
             + 2 * m ** 3 * refactors)
    nbytes = B * (4 * (m * n + m + 2 * n) + 4 * (2 * n + 2 * m + 3) + n)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return {"steps": steps, "pivots": pivots, "flips": flips,
            "refactors": refactors, "priced_columns": priced,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _revised_clone(state):
    from repro_torch.core.revised import RevisedState
    return RevisedState(*(leaf.clone() for leaf in state))


def _revised_first(state, k):
    from repro_torch.core.revised import RevisedState
    return RevisedState(*(leaf[:k].contiguous() for leaf in state))


def compare_revised(name, lp, rule, n_lp=SLICE, n_plain=SLICE,
                    max_iters=None):
    """The revised kernel against its plain version on the first n_lp LPs
    (plain: the first n_plain): one launch of each stage leaf by leaf, then
    the whole solve (status, iterations, x, objective, y, z, basis, bound
    flags and work counts equal, NaN where NaN)."""
    import numpy as np
    import torch
    from repro_torch.core.lp import LPBatch, default_max_iters
    from repro_torch.core.revised import (WORK_FIELDS, RevisedState,
                                          auto_refactor_period,
                                          solve_revised, warm_state)
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels.revised_tile import (revised_segment_tile,
                                                  revised_segment_tile_plain,
                                                  revised_tile,
                                                  workspace_in_smem)
    sub = LPBatch(A=lp.A[:n_lp], b=lp.b[:n_lp], c=lp.c[:n_lp],
                  ub=None if lp.ub is None else lp.ub[:n_lp])
    A, b, c, ub = batch_tensors(sub, torch.device("cuda"))
    m, n, k = lp.m, lp.n, n_plain
    if max_iters is None:
        max_iters = default_max_iters(m, n)
    K = auto_refactor_period(m, n)
    kw = dict(m=m, n=n, max_iters=max_iters, tol=1e-6, refactor_period=K,
              rule=rule)
    state = warm_state(A, b, c, ub, m=m, n=n, feas_tol=1e-5)
    one = {}
    for stage in ("p1", "p2"):
        got, it = revised_segment_tile(_revised_clone(state), 32,
                                       stage=stage, **kw)
        want, want_it = revised_segment_tile_plain(_revised_first(state, k),
                                                   32, stage=stage, **kw)
        torch.cuda.synchronize()
        assert torch.equal(it[:k], want_it), (name, rule, stage, "steps")
        for leaf, g, w in zip(RevisedState._fields, got, want):
            torch.testing.assert_close(g[:k], w, rtol=0, atol=0,
                                       equal_nan=True,
                                       msg=f"{name} {rule} {stage} {leaf}")
        one[stage] = {"steps_max": int(it.max()),
                      "running_after": int((got.status == -1).sum())}
        state = got
    del state, got, want
    wkw = dict(m=m, n=n, max_iters=max_iters, refactor_period=K,
               pricing=rule)
    work = torch.zeros((n_lp, len(WORK_FIELDS)), dtype=torch.int32,
                       device="cuda")
    work_plain = torch.zeros((k, len(WORK_FIELDS)), dtype=torch.int32,
                             device="cuda")
    got, ms = timed(lambda: revised_tile(A, b, c, ub, work=work, **wkw))
    want, plain_ms = timed(lambda: solve_revised(
        A[:k], b[:k], c[:k], ub[:k].contiguous(), tol=1e-6, feas_tol=1e-5,
        work=work_plain, **wkw))
    err = 0.0
    for i, what in enumerate(("x", "objective", "status", "iterations", "y",
                              "z", "basis", "onub")):
        torch.testing.assert_close(got[i][:k], want[i], rtol=0, atol=0,
                                   equal_nan=True,
                                   msg=f"{name} {rule} whole {what}")
        if got[i].dtype == torch.float32:
            g, w = got[i][:k], want[i]
            fin = torch.isfinite(g) & torch.isfinite(w)
            err = max(err, float((g - w).abs()[fin].max()) if fin.any()
                      else 0.0)
    assert torch.equal(work[:k], work_plain), (name, rule, "work")
    status = got[2].cpu().numpy()
    out = {"compare_revised": name, "pricing": rule, "lps": n_lp,
           "plain_lps": k, "max_iters": max_iters, "refactor_period": K,
           "workspace_in_smem": workspace_in_smem(m, n), "one_launch": one,
           "status_counts": np.bincount(status.astype(int),
                                        minlength=4).tolist(),
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    out.update(revised_bound(m, n, n_lp, work.cpu().numpy()))
    emit(out)
    return out, got


def compare_revised_schedule(name, lp, rule, whole, n_lp=SLICE):
    """compaction=True for the revised engine on the first n_lp LPs: the
    schedule through RevisedKernelBackend equals the one through the plain
    RevisedBackend bit for bit; against the whole solve ``whole`` statuses
    are equal and objectives within rel 1e-3 (the reference's contract,
    tests/test_tile_parity.py)."""
    import numpy as np
    import torch
    from repro_torch.core.lp import LPBatch, default_max_iters
    from repro_torch.core.revised import RevisedBackend
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels.ops import RevisedKernelBackend
    sub = LPBatch(A=lp.A[:n_lp], b=lp.b[:n_lp], c=lp.c[:n_lp],
                  ub=None if lp.ub is None else lp.ub[:n_lp])
    A, b, c, ub = batch_tensors(sub, torch.device("cuda"))
    mi = default_max_iters(lp.m, lp.n)
    args = (lp.m, lp.n, 1e-6, 1e-5)
    kb = timed_backend(RevisedKernelBackend, revised_state_bytes)(
        *args, pricing=rule)
    pb = timed_backend(RevisedBackend, revised_state_bytes)(*args,
                                                            pricing=rule)
    zero_counts()
    got, _, stats, ms = schedule(kb, A, b, c, ub, max_iters=mi)
    assert counts()["revised_segment"] == len(stats), (counts(), len(stats))
    want, _, _, plain_ms = schedule(pb, A, b, c, ub, max_iters=mi)
    assert same_result(got, want, ("status", "iterations", "x", "objective",
                                   "y", "z")), (name, rule, "schedules")
    status = whole[2].cpu().numpy().astype(np.int8)
    np.testing.assert_array_equal(got.status, status)
    obj = whole[1].cpu().numpy()
    ok = status == 0
    rel = float(np.max(np.abs(got.objective[ok] - obj[ok]) / np.abs(obj[ok]),
                       initial=0.0))
    assert rel <= 1e-3, (name, rule, rel)
    emit({"compare_revised_schedule": name, "pricing": rule, "lps": n_lp,
          "segments": len(stats), "gathers": len(kb.gather_ms),
          "ladder_stage_bucket_steps_survivors": ladder(stats),
          "bitwise_equal_plain_schedule": True,
          "max_rel_obj_vs_whole": rel,
          "iteration_diffs_vs_whole": int((got.iterations != whole[3]
                                           .cpu().numpy()).sum()),
          "ms": sum(kb.segment_ms), "scheduled_ms": ms,
          "plain_ms": sum(pb.segment_ms), "plain_scheduled_ms": plain_ms,
          "state_bytes_moved": kb.moved})


def revised_at_full_batch(name, lp):
    """The revised wrapper once over a whole canonical batch (state build,
    kernel, extraction), timed on the card with its bound; beside it, as a
    yardstick for the refactorization alone, torch.linalg.inv on the
    final basis matrices (the port never calls it)."""
    import torch
    from repro_torch.core.lp import default_max_iters
    from repro_torch.core.revised import (WORK_FIELDS, auto_refactor_period,
                                          warm_state)
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels.revised_tile import revised_tile
    A, b, c, ub = batch_tensors(lp, torch.device("cuda"))
    m, n = lp.m, lp.n
    work = torch.zeros((lp.batch, len(WORK_FIELDS)), dtype=torch.int32,
                       device="cuda")
    out, ms = timed(lambda: revised_tile(
        A, b, c, ub, m=m, n=n, max_iters=default_max_iters(m, n),
        refactor_period=auto_refactor_period(m, n), work=work))
    basis = out[6]
    del out
    Abar = warm_state(A, b, c, ub, m=m, n=n, feas_tol=1e-5).Abar
    Bmat = Abar.gather(2, basis.long()[:, None, :].expand(-1, m, m))
    del Abar
    torch.cuda.empty_cache()
    _, inv_ms = timed(lambda: torch.linalg.inv(Bmat))
    info = {"revised_full_batch": name, "lps": lp.batch, "ms": ms,
            "refactorizations_per_lp": float(work[:, 3].double().mean()),
            "yardstick_linalg_inv_ms": inv_ms}
    info.update(revised_bound(m, n, lp.batch, work.cpu().numpy()))
    emit(info)
    del A, b, c, ub, Bmat, work
    torch.cuda.empty_cache()
    return info


def revised_state_bytes(m, n, rule, stage):
    """Bytes one LP's revised segment state moves per launch when its block
    loads it: Abar, cvec, ub and thr read; xB, basis, bound flags, phase,
    status, iterations, y and work read and written; the step count
    written."""
    read = 4 * (m * (n + 2 * m) + (n + m) + n + 1)
    rw = 4 * (3 * m + 3 + 5) + n
    return read + 2 * rw + 4


# ---- restarted PDHG (core/pdhg.py, csrc/pdhg_tile.cu) ---------------------

PDHG_OUT = ("x", "objective", "status", "iterations", "y", "z", "warm_x",
            "warm_y", "omega", "eta")
PDHG_PLAIN_CAP = 20_000   # max_iters of the lp_100d_50k kernel/plain check


def pdhg_bound(m, n, B, iters, check_every=16):
    """Least time for the PDHG work this run's data needed, from the per-LP
    iteration counts the kernel reports: the larger of the operations time
    and the bytes time.  Operations, at the f32 rate outside the tensor
    cores: 4mn an iteration (the two matvecs), 8mn a round of check_every
    iterations (the two KKT evaluations of the check) and 2mn for the
    extraction; the Farkas-ray matvecs (only once an iterate passes
    RAY_MIN_NORM) and the linesearch's trial matvecs are left out, so this
    is a floor.  Bytes, at the memory rate: A, b, c and ub read once; x,
    z, y, the objective, status and iterations and the warm capture (x, y,
    omega, eta) written once."""
    import numpy as np
    it = int(np.asarray(iters, np.int64).sum())
    rounds = it // check_every
    flops = 4 * m * n * it + 8 * m * n * rounds + 2 * m * n * B
    nbytes = B * 4 * ((m * n + m + 2 * n) + (3 * n + 2 * m + 5))
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return {"iterations_sum": it, "rounds_sum": rounds,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _pdhg_info(res):
    import numpy as np
    return {"status_counts": np.bincount(np.asarray(res.status).astype(int),
                                         minlength=4).tolist(),
            "mean_iterations": float(np.mean(res.iterations)),
            "max_iterations": int(np.max(res.iterations))}


def planned_bytes(shape, B):
    """The chunk plan's device bytes for B LPs of canonical ``shape`` on
    the pdhg path (Eq. 5's Y, core/pdhg.py ``pdhg_bytes_per_lp``)."""
    from repro_torch.core.pdhg import pdhg_bytes_per_lp
    return B * pdhg_bytes_per_lp(*shape)


def peak_since_reset(before):
    """Device bytes the run allocated at its peak beyond what was alive
    at ``reset_peak_memory_stats``."""
    import torch
    return torch.cuda.max_memory_allocated() - before


def pdhg_main(name, batch, oracle_batch, shape, tableau_res=None):
    """Drive solve_batched(backend="pdhg") once through the whole-solve
    kernel (no segment launch); hold the result against the oracle and,
    where given, count the statuses that agree with the tableau run.  The
    peak device memory must stay within the chunk plan for the canonical
    ``shape`` (m, n)."""
    import numpy as np
    import torch
    from repro_torch.core import solve_batched, solve_batched_reference
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    res = solve_batched(batch, backend="pdhg")
    wall = time.perf_counter() - t0
    launches = only("pdhg")
    B = res.status.shape[0]
    assert res.x.shape == (B, batch.n) and res.objective.shape == (B,)
    opt = res.status == 0
    assert np.isfinite(res.x[opt]).all() and np.isfinite(res.objective[opt]).all()
    assert res.warm is not None and res.warm.omega.shape == (B,)
    peak, plan = peak_since_reset(before), planned_bytes(shape, B)
    assert peak <= plan, (name, peak, plan)
    info = {"pdhg_main": name, "lps": B, "wall_s": wall, "lps_per_s": B / wall,
            "launches": launches, "peak_device_bytes": peak,
            "planned_device_bytes": plan}
    info.update(_pdhg_info(res))
    if tableau_res is not None:
        info["status_agree_with_tableau"] = float(
            (res.status == tableau_res.status).mean())
        both = opt & (tableau_res.status == 0)
        info["max_rel_obj_vs_tableau"] = float(np.max(
            np.abs(res.objective[both] - tableau_res.objective[both])
            / np.abs(tableau_res.objective[both]), initial=0.0))
    info.update(check_oracle(f"{name} pdhg", res,
                             solve_batched_reference(oracle_batch)))
    emit(info)
    return res, launches, wall


def pdhg_compaction_main(lp100, res_whole, wall_whole):
    """solve_batched(backend="pdhg", compaction=True) on every LP of
    lp_100d_50k: only the segment kernel runs, and the result equals the
    whole-solve run bit for bit (the per-LP round budget, the state carried
    through device memory)."""
    import torch
    from repro_torch.core import solve_batched
    stats = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    res = solve_batched(lp100, backend="pdhg", compaction=True,
                        stats_out=stats)
    wall = time.perf_counter() - t0
    launches = only("pdhg_segment")
    assert same_result(res, res_whole, ("status", "iterations", "x",
                                        "objective", "y", "z")), \
        "pdhg compaction != whole solve"
    peak = peak_since_reset(before)
    plan = planned_bytes((lp100.m, lp100.n), lp100.batch)
    assert peak <= plan, ("pdhg compaction", peak, plan)
    info = {"pdhg_compaction_main": "lp_100d_50k", "lps": lp100.batch,
            "wall_s": wall, "lps_per_s": lp100.batch / wall,
            "launches": launches, "segments": len(stats),
            "buckets": sorted({s.bucket for s in stats}, reverse=True),
            "ladder_stage_bucket_rounds_survivors": ladder(stats),
            "bitwise_equal_whole_solve": True,
            "peak_device_bytes": peak, "planned_device_bytes": plan,
            "whole_solve_wall_s": wall_whole}
    info.update(_pdhg_info(res))
    emit(info)
    return launches


def pdhg_warm(g, g64, shape):
    """Warm starts through the whole-solve kernel: lp_afiro_100k cold
    (member 0 at the published optimum, the first 64 against the oracle),
    then re-solved from its own warm_start(): equal statuses, objectives
    within rel 2e-3 (the reference's contract), at most a quarter of the
    cold mean iterations."""
    import numpy as np
    from repro_torch.core import solve_batched
    cold, launches, wall_cold = pdhg_main("lp_afiro_100k", g, g64, shape)
    assert cold.status[0] == 0
    np.testing.assert_allclose(cold.objective[0], AFIRO_OPT, rtol=1e-4)
    zero_counts()
    t0 = time.perf_counter()
    warm = solve_batched(g, backend="pdhg", warm=cold.warm_start())
    wall = time.perf_counter() - t0
    launches += only("pdhg")
    rel = same_answers(cold, warm)
    cold_mean = float(np.mean(cold.iterations))
    warm_mean = float(np.mean(warm.iterations))
    assert warm_mean <= 0.25 * cold_mean, (warm_mean, cold_mean)
    emit({"pdhg_warm": "lp_afiro_100k",
          "member0_objective": float(cold.objective[0]),
          "published": AFIRO_OPT, "cold_wall_s": wall_cold,
          "warm_wall_s": wall, "cold_mean_iterations": cold_mean,
          "warm_mean_iterations": warm_mean,
          "warm_max_iterations": int(np.max(warm.iterations)),
          "warm_status_counts": np.bincount(warm.status.astype(int),
                                            minlength=4).tolist(),
          "max_rel_obj_warm_vs_cold": rel, "launches": launches})
    return launches


def _pdhg_sub(lp, k):
    import torch
    from repro_torch.core.lp import LPBatch
    from repro_torch.core.simplex import batch_tensors
    sub = LPBatch(A=lp.A[:k], b=lp.b[:k], c=lp.c[:k],
                  ub=None if lp.ub is None else lp.ub[:k])
    return sub, batch_tensors(sub, torch.device("cuda"))


def max_err(pairs):
    """Largest |kernel - plain| over the float entries finite on both
    sides of (kernel, plain) tensor pairs."""
    import torch
    err = 0.0
    for g, w in pairs:
        if g.is_floating_point():
            fin = torch.isfinite(g) & torch.isfinite(w)
            if fin.any():
                err = max(err, float((g - w).abs()[fin].max()))
    return err


def _solved_first(status, iters, k):
    """k members for a plain slice: up to three quarters the OPTIMAL ones
    the kernel solved in the fewest iterations, the rest from the others
    (so that the slice ends at the cap with both kinds in it)."""
    import torch
    opt = torch.nonzero(status == 0).flatten()
    opt = opt[torch.argsort(iters[opt], stable=True)][:3 * k // 4]
    rest = torch.nonzero(status != 0).flatten()[:k - len(opt)]
    return torch.sort(torch.cat([opt, rest])).values


def compare_pdhg(name, lp, rule, n_lp=SLICE, n_plain=512, max_iters=None,
                 solved_first=False):
    """The whole-solve kernel on the first n_lp LPs against its plain
    version on n_plain of them (the first, or with ``solved_first`` those
    of ``_solved_first``, at least one OPTIMAL): every output equal
    (status, iterations, x, objective, y, z and the warm capture; NaN
    where NaN)."""
    import numpy as np
    import torch
    from repro_torch.core.pdhg import default_pdhg_max_iters
    from repro_torch.kernels.pdhg_tile import (a_in_smem, pdhg_tile,
                                               pdhg_tile_plain)
    _, (A, b, c, ub) = _pdhg_sub(lp, n_lp)
    m, n, k = lp.m, lp.n, n_plain
    if max_iters is None:
        max_iters = default_pdhg_max_iters(m, n)
    kw = dict(m=m, n=n, max_iters=max_iters, step_rule=rule)
    got, ms = timed(lambda: pdhg_tile(A, b, c, ub, **kw))
    idx = (_solved_first(got[2], got[3], k) if solved_first
           else torch.arange(k, device=A.device))
    want, plain_ms = timed(lambda: pdhg_tile_plain(
        A[idx], b[idx], c[idx], ub[idx], **kw))
    got_k = [g[idx] for g in got]
    for what, g, w in zip(PDHG_OUT, got_k, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                   msg=f"{name} {rule} {what}")
    plain_counts = np.bincount(got_k[2].cpu().numpy().astype(int),
                               minlength=4).tolist()
    if solved_first:
        assert plain_counts[0] > 0, (name, "no OPTIMAL member compared")
    iters = got[3].cpu().numpy()
    out = {"compare_pdhg": name, "step_rule": rule, "lps": n_lp,
           "plain_lps": k, "max_iters": max_iters,
           "a_in_smem": a_in_smem(m, n),
           "status_counts": np.bincount(got[2].cpu().numpy().astype(int),
                                        minlength=4).tolist(),
           "plain_status_counts": plain_counts,
           "plain_members": "solved first" if solved_first else "first",
           "mean_iterations": float(iters.mean()),
           "max_iterations": int(iters.max()),
           "max_abs_err": max_err(zip(got_k, want)),
           "ms": ms, "plain_ms": plain_ms}
    out.update(pdhg_bound(m, n, n_lp, iters))
    emit(out)
    return out, got


def _pdhg_clone(state, k=None):
    from repro_torch.core.pdhg import PdhgState
    return PdhgState(*(leaf.clone() if k is None else leaf[:k].contiguous()
                       for leaf in state))


def compare_pdhg_segment(name, lp, n_lp=SLICE, n_plain=512, steps=8,
                         max_rounds=4375):
    """One segment launch (``steps`` rounds) from a mid-solve state (three
    plain rounds from cold) on every LP, against the plain segment on the
    first n_plain: every leaf and the rounds run equal."""
    import torch
    from repro_torch.core.pdhg import PdhgState, init_pdhg_state, segment_pdhg
    from repro_torch.kernels.pdhg_tile import (pdhg_segment_tile,
                                               pdhg_segment_tile_plain)
    _, (A, b, c, ub) = _pdhg_sub(lp, n_lp)
    mid, _ = segment_pdhg(init_pdhg_state(A, b, c, ub), 3, tol=1e-5,
                          max_rounds=max_rounds)
    k = n_plain
    (got, it), ms = timed(lambda: pdhg_segment_tile(
        _pdhg_clone(mid), steps, m=lp.m, n=lp.n, max_rounds=max_rounds))
    (want, want_it), plain_ms = timed(lambda: pdhg_segment_tile_plain(
        _pdhg_clone(mid, k), steps, max_rounds=max_rounds))
    assert torch.equal(it[:k], want_it), (name, "rounds differ")
    for leaf, g, w in zip(PdhgState._fields, got, want):
        torch.testing.assert_close(g[:k], w, rtol=0, atol=0, equal_nan=True,
                                   msg=f"{name} segment {leaf}")
    out = {"compare_pdhg_segment": name, "lps": n_lp, "plain_lps": k,
           "rounds": steps, "rounds_max": int(it.max()),
           "running_after": int((got.status == -1).sum()),
           "max_abs_err": max_err((g[:k], w) for g, w in zip(got, want)),
           "ms": ms, "plain_ms": plain_ms}
    emit(out)
    return out


def timed_pdhg_backend(cls):
    """``cls`` (a PDHG scheduler backend) with each segment launch and each
    gather timed by CUDA events."""
    class Timed(cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.segment_ms, self.gather_ms = [], []

        def segment(self, state, steps, stage, max_iters):
            out, ms = timed(lambda: super(Timed, self).segment(
                state, steps, stage, max_iters))
            self.segment_ms.append(ms)
            return out

        def take(self, state, idx):
            out, ms = timed(lambda: super(Timed, self).take(state, idx))
            self.gather_ms.append(ms)
            return out
    return Timed


def compare_pdhg_schedule(name, lp, n_lp=SLICE, n_plain=512,
                          max_iters=8000):
    """compaction=True on the first n_lp LPs through PdhgKernelBackend
    against the plain PdhgBackend on the first n_plain: equal bit for bit
    (status, iterations, x, objective, y, z); and equal to the whole-solve
    kernel on the same LPs at the same cap."""
    import numpy as np
    import torch
    from repro_torch.core.pdhg import PdhgBackend, schedule_pdhg
    from repro_torch.kernels.ops import PdhgKernelBackend
    from repro_torch.kernels.pdhg_tile import pdhg_tile
    sub, (A, b, c, ub) = _pdhg_sub(lp, n_lp)
    whole = pdhg_tile(A, b, c, ub, m=lp.m, n=lp.n, max_iters=max_iters)
    del A, b, c, ub
    plain_sub, _ = _pdhg_sub(lp, n_plain)
    dev = torch.device("cuda")
    kb = timed_pdhg_backend(PdhgKernelBackend)(lp.m, lp.n)
    pb = timed_pdhg_backend(PdhgBackend)(lp.m, lp.n)
    stats = []
    zero_counts()
    kw = dict(max_iters=max_iters, segment_k=None, compact_threshold=None)
    got, ms = timed(lambda: schedule_pdhg(kb, sub, dev, stats_out=stats,
                                          **kw))
    launches = counts()["pdhg_segment"]
    assert launches == len(stats) and counts()["pdhg"] == 0, counts()
    want, plain_ms = timed(lambda: schedule_pdhg(pb, plain_sub, dev,
                                                 stats_out=None, **kw))
    fields = ("status", "iterations", "x", "objective", "y", "z")
    k = n_plain
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f))[:k],
                                      getattr(want, f),
                                      err_msg=f"{name} schedule {f}")
    for f, t in zip(("x", "objective", "status", "iterations", "y", "z"),
                    whole[:6]):
        np.testing.assert_array_equal(getattr(got, f), t.cpu().numpy(),
                                      err_msg=f"{name} vs whole {f}")
    err = max_err((torch.as_tensor(np.asarray(getattr(got, f))[:k]),
                   torch.as_tensor(getattr(want, f)))
                  for f in ("x", "objective", "y", "z"))
    out = {"compare_pdhg_schedule": name, "lps": n_lp, "plain_lps": k,
           "max_iters": max_iters, "segments": len(stats),
           "gathers": len(kb.gather_ms),
           "ladder_stage_bucket_rounds_survivors": ladder(stats),
           "bitwise_equal_plain_schedule": True,
           "bitwise_equal_whole_solve": True, "max_abs_err": err,
           "ms": sum(kb.segment_ms), "gather_ms": sum(kb.gather_ms),
           "scheduled_ms": ms, "plain_ms": sum(pb.segment_ms),
           "plain_scheduled_ms": plain_ms}
    out.update(pdhg_bound(lp.m, lp.n, n_lp, got.iterations))
    emit(out)
    return out


def pdhg_sparse(name, lp, max_iters):
    """SparseLPBatch.from_dense of a canonical batch through the sparse
    engine on the card, against the dense kernel on the same LPs at the
    same cap: equal statuses, objectives within rel 1e-3.  The sparse sums
    follow the dense kernel's order, so every output is in fact equal."""
    import numpy as np
    from repro_torch.core.sparse import (SparseLPBatch,
                                         solve_batched_pdhg_sparse)
    from repro_torch.kernels.ops import solve_batched_kernel
    sp = SparseLPBatch.from_dense(lp)
    t0 = time.perf_counter()
    res = solve_batched_pdhg_sparse(sp, max_iters=max_iters)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense = solve_batched_kernel(lp, backend="pdhg", max_iters=max_iters)
    wall_dense = time.perf_counter() - t0
    np.testing.assert_array_equal(res.status, dense.status)
    ok = dense.status == 0
    rel = float(np.max(np.abs(res.objective[ok] - dense.objective[ok])
                       / np.abs(dense.objective[ok]), initial=0.0))
    assert rel <= 1e-3, (name, rel)
    assert same_result(res, dense, ("status", "iterations", "x", "objective",
                                    "y", "z")), (name, "sparse != dense")
    out = {"pdhg_sparse": name, "lps": lp.batch, "nnz": sp.nnz,
           "density": sp.density, "max_iters": max_iters, "wall_s": wall,
           "dense_kernel_wall_s": wall_dense, "max_rel_obj_vs_dense": rel,
           "bitwise_equal_dense_kernel": True}
    out.update(_pdhg_info(res))
    emit(out)


def pdhg_full_batch(lp):
    """The whole-solve wrapper (setup, kernel) once over all of a batch,
    timed on the card with its bound; beside it, as a yardstick and not
    used by the port, one torch.bmm pair (A x, A^T y) over the batch times
    the mean iterations."""
    import torch
    from repro_torch.core.pdhg import default_pdhg_max_iters, init_pdhg_state
    from repro_torch.core.simplex import batch_tensors
    from repro_torch.kernels.pdhg_tile import pdhg_tile
    A, b, c, ub = batch_tensors(lp, torch.device("cuda"))
    m, n, B = lp.m, lp.n, lp.batch
    out, ms = timed(lambda: pdhg_tile(
        A, b, c, ub, m=m, n=n, max_iters=default_pdhg_max_iters(m, n)))
    iters = out[3].cpu().numpy()
    del out
    _, setup_ms = timed(lambda: init_pdhg_state(A, b, c, ub))
    As = init_pdhg_state(A, b, c, ub).A
    del A
    x = torch.ones((B, n, 1), device="cuda")
    y = torch.ones((B, m, 1), device="cuda")

    def pair():
        torch.bmm(As, x)
        torch.bmm(As.transpose(1, 2), y)
    pair()
    _, pair_ms = timed(lambda: [pair() for _ in range(5)])
    pair_ms /= 5
    info = {"pdhg_full_batch": "lp_100d_50k", "lps": B, "ms": ms,
            "setup_ms": setup_ms, "mean_iterations": float(iters.mean()),
            "yardstick_bmm_pair_ms": pair_ms,
            "yardstick_bmm_pairs_times_mean_iterations_ms":
                pair_ms * float(iters.mean())}
    info.update(pdhg_bound(m, n, B, iters))
    emit(info)
    del As, x, y, b, c, ub
    torch.cuda.empty_cache()
    return info


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core import LPBatch, canonicalize, random_lp_batch
    from repro_torch.io import fixture_path, perturbed_batch, read_mps
    from repro_torch.kernels import _build
    from repro_torch.kernels.simplex_tile import tableau_in_smem

    t_start = time.perf_counter()
    took = _build.build()
    ptxas = []
    for name in _build.SOURCES:
        report = _build.library_path(name).with_suffix(".log")
        ptxas += [ln.strip() for ln in report.read_text().splitlines()
                  if "registers" in ln or "spill" in ln]
    emit({"build_s": time.perf_counter() - t_start, "nvcc_s": took,
          "ptxas": ptxas[:40]})
    # create the CUDA context before any timed run, so that no main-path
    # wall time includes it
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    emit({"cuda_context_s": time.perf_counter() - t0})

    # ---- main path: the two paper workloads through solve_batched ---------
    lp100 = random_lp_batch(np.random.default_rng(2018), B=50_000, m=100,
                            n=100, feasible_start=False)
    head = LPBatch(A=lp100.A[:64], b=lp100.b[:64], c=lp100.c[:64])
    res_100, launches_100, wall_100 = solve_main("lp_100d_50k", lp100, head)

    afiro = read_mps(fixture_path("afiro"))
    g = perturbed_batch(afiro, 100_000)
    g64 = dataclasses.replace(g, A=g.A[:64], rhs=g.rhs[:64], lb=g.lb[:64],
                              ub=g.ub[:64], c=g.c[:64], c0=g.c0[:64])
    res_af, launches_af, _ = solve_main("lp_afiro_100k", g, g64)
    assert res_af.status[0] == 0
    np.testing.assert_allclose(res_af.objective[0], AFIRO_OPT, rtol=1e-4)
    emit({"afiro_member0_objective": float(res_af.objective[0]),
          "published": AFIRO_OPT})

    # ---- kernel vs plain version on the card ------------------------------
    lp_af, _ = canonicalize(g)
    full_100 = kernel_at_full_batch("lp_100d_50k", lp100)
    kernel_at_full_batch("lp_afiro_100k", lp_af)
    rows = []
    for rule in RULES:
        rows.append(compare("lp_100d_50k", lp100, rule))
        compare("lp_afiro_100k", lp_af, rule)
    # the device-memory variant; most of these LPs run to max_iters in f32
    # (as in the reference), so the plain version takes a slice of them and,
    # for steepest edge, a shorter budget given to both
    sc205, _ = canonicalize(perturbed_batch(
        read_mps(fixture_path("sc205_like")), SLICE))
    assert not tableau_in_smem(sc205.m, sc205.n)
    for rule in RULES:
        compare("sc205_like_2k", sc205, rule, n_plain=128,
                max_iters=600 if rule == "steepest_edge" else None)

    # ---- compaction path: the segment kernel under the scheduler ----------
    launches_seg, _ = compaction_main(lp100, res_100, wall_100, full_100)
    segment_at_full_batch(lp100, full_100)
    kernel_at_full_batch("lp_100d_50k", lp100)
    segment_at_full_batch(lp100, full_100)
    for cap in (200, 420):   # all 2,048 LPs at the cap; about half
        binding_budget(lp100, cap)
    seg_rows = []
    for rule in RULES:
        seg_rows.append(compare_schedule("lp_100d_50k", lp100, rule))
        compare_schedule("lp_afiro_100k", lp_af, rule)
    # sc205_like: a 600-step budget for every rule (most members run to
    # the cap in f32), the plain version on the first 128
    for rule in RULES:
        compare_schedule("sc205_like_2k", sc205, rule, n_plain=128,
                         max_iters=600)

    # ---- revised path: the revised kernel, with warm starts ---------------
    launches_rev = 0
    for rule in REVISED_RULES:
        _, got = revised_main("lp_100d_50k", lp100, head, rule, res_100)
        launches_rev += got
    launches_rev += revised_warm(afiro, g, g64, traj_lps=100_000)
    rev_rows = []
    for rule in REVISED_RULES:
        row, whole = compare_revised("lp_100d_50k", lp100, rule)
        rev_rows.append(row)
        compare_revised_schedule("lp_100d_50k", lp100, rule, whole)
        _, whole = compare_revised("lp_afiro_100k", lp_af, rule)
        compare_revised_schedule("lp_afiro_100k", lp_af, rule, whole)
        del whole
    for rule in REVISED_RULES:   # the device-memory workspace
        compare_revised("sc205_like_2k", sc205, rule, n_plain=128,
                        max_iters=600)
    rev_full = revised_at_full_batch("lp_100d_50k", lp100)

    # ---- restarted PDHG: the whole-solve and segment kernels --------------
    res_pdhg, launches_pdhg, wall_pdhg = pdhg_main(
        "lp_100d_50k", lp100, head, (lp100.m, lp100.n), res_100)
    launches_pdhg_seg = pdhg_compaction_main(lp100, res_pdhg, wall_pdhg)
    del res_pdhg
    launches_pdhg += pdhg_warm(g, g64, (lp_af.m, lp_af.n))
    pdhg_row, _ = compare_pdhg("lp_100d_50k", lp100, "fixed",
                               max_iters=PDHG_PLAIN_CAP)
    pdhg_seg_row = compare_pdhg_schedule("lp_100d_50k", lp100)
    pdhg_launch_row = compare_pdhg_segment("lp_100d_50k", lp100)
    # the linesearch costs the plain version up to 13 matvecs an iteration:
    # a shorter budget and the first 128 LPs
    compare_pdhg("lp_100d_50k", lp100, "malitsky_pock", n_plain=128,
                 max_iters=1600)
    compare_pdhg("lp_afiro_100k", lp_af, "fixed")
    # sc205_like: A in shared memory, one block per SM, at a budget that
    # keeps the plain version's lockstep loop short; lp_300d_2k: the
    # device-memory variant, whose members need 19,000 iterations and more,
    # at a cap where some converge, the plain version on those the kernel
    # solved first and on members still running at the cap
    compare_pdhg("sc205_like_2k", sc205, "fixed", n_plain=128,
                 max_iters=4000)
    lp300 = random_lp_batch(np.random.default_rng(2018), B=256, m=300, n=300)
    compare_pdhg("lp_300d_2k", lp300, "fixed", n_lp=256, n_plain=64,
                 max_iters=40_000, solved_first=True)
    del lp300
    pdhg_sparse("sc205_like_2k", sc205, max_iters=20_000)
    pdhg_full = pdhg_full_batch(lp100)
    del lp100, res_100, g, lp_af, sc205
    torch.cuda.empty_cache()

    # ---- box LP: the hyperbox kernel --------------------------------------
    box = box_lp()
    emit({"total_s": time.perf_counter() - t_start})

    main_row = rows[0]   # lp_100d_50k slice, dantzig: the paper's rule
    seg_row = seg_rows[0]
    emit({"kernels": [{
        "name": "simplex_tile", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/simplex_tile.cu",
        "replaces": "src/repro/kernels/simplex_tile.py:421",
        "launches": launches_100 + launches_af,
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"], "library_ms": None,
        "parity": "status, iterations and work counts equal; x, objective, "
                  "y, z within rel 1e-5; every rule and batch"}, {
        "name": "simplex_segment", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/simplex_tile.cu",
        "replaces": "src/repro/kernels/simplex_tile.py:494",
        "launches": launches_seg,
        "max_abs_err": seg_row["max_abs_err"], "ms": seg_row["ms"],
        "plain_ms": seg_row["plain_ms"], "bound_ms": seg_row["bound_ms"],
        "bound_by": seg_row["bound_by"], "library_ms": None,
        "state_roundtrip_ms": seg_row["state_roundtrip_ms"],
        "parity": "one launch per stage leaf by leaf; scheduled solve: "
                  "status, iterations and work equal, x, objective, y, z "
                  "within rel 1e-5; every rule and batch"}, {
        "name": "hyperbox", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hyperbox.cu",
        "replaces": "src/repro/kernels/hyperbox_kernel.py:20",
        "launches": box["launches"], "max_abs_err": box["max_abs_err"],
        "ms": box["ms"], "plain_ms": box["plain_ms"],
        "bound_ms": box["bound_ms"], "bound_by": box["bound_by"],
        "library_ms": box["library_ms"], "library": box["library"],
        "parity": "equal to the plain version; rel 1e-5 to the float64 "
                  "oracle"}, {
        "name": "revised_segment", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/revised_tile.cu",
        "replaces": "src/repro/kernels/revised_tile.py:221",
        "launches": launches_rev,
        "max_abs_err": rev_rows[0]["max_abs_err"], "ms": rev_rows[0]["ms"],
        "plain_ms": rev_rows[0]["plain_ms"],
        "bound_ms": rev_rows[0]["bound_ms"],
        "bound_by": rev_rows[0]["bound_by"], "library_ms": None,
        "full_batch_ms": rev_full["ms"],
        "full_batch_bound_ms": rev_full["bound_ms"],
        "parity": "one launch per stage leaf by leaf and the whole solve "
                  "equal (NaN where NaN); both rules; the compaction "
                  "schedule equal to the plain one"}, {
        "name": "pdhg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pdhg_tile.cu",
        "replaces": "src/repro/kernels/pdhg_tile.py:268",
        "launches": launches_pdhg,
        "max_abs_err": pdhg_row["max_abs_err"], "ms": pdhg_row["ms"],
        "plain_ms": pdhg_row["plain_ms"], "bound_ms": pdhg_row["bound_ms"],
        "bound_by": pdhg_row["bound_by"], "library_ms": None,
        "slice_max_iters": pdhg_row["max_iters"],
        "plain_lps": pdhg_row["plain_lps"],
        "full_batch_ms": pdhg_full["ms"],
        "full_batch_bound_ms": pdhg_full["bound_ms"],
        "parity": "every output equal (NaN where NaN): both step rules, "
                  "lp_100d_50k, lp_afiro_100k, sc205_like (A in shared "
                  "memory) and lp_300d_2k (A in device memory)"}, {
        "name": "pdhg_segment", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pdhg_tile.cu",
        "replaces": "src/repro/kernels/pdhg_tile.py:469",
        "launches": launches_pdhg_seg,
        "max_abs_err": max(pdhg_seg_row["max_abs_err"],
                           pdhg_launch_row["max_abs_err"]),
        "ms": pdhg_seg_row["ms"],
        "plain_ms": pdhg_seg_row["plain_ms"],
        "bound_ms": pdhg_seg_row["bound_ms"],
        "bound_by": pdhg_seg_row["bound_by"], "library_ms": None,
        "plain_lps": pdhg_seg_row["plain_lps"],
        "parity": "one launch leaf by leaf; the kernel-backed schedule "
                  "equal to the plain-backed one and to the whole solve; "
                  "compaction=True on all 50,000 equal to the whole "
                  "solve"}]})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
