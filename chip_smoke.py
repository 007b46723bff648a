#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernel from src/repro_torch/kernels/csrc, then drives the
port's main path, ``repro_torch.core.solve_batched`` with no device
argument, at two of the paper's workloads (src/repro/configs/paper_lp.py):

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
device-memory variant; the plain version checks the first 128).  Lines of JSON report each phase; the line before
the last is the kernel table, then the card's name and power limit, and the
last line is ``{"ok": true, "device": {...}}``.  Any failed check raises and
the script exits non-zero without that line; so does a run without a card.
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

    simplex_tile.launches = 0
    t0 = time.perf_counter()
    res = solve_batched(batch)
    wall = time.perf_counter() - t0
    launches = simplex_tile.launches
    assert launches > 0, f"{name}: the main path launched no kernel"
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
    return res, launches


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

    t0 = time.perf_counter()
    took = _build.build()
    report = _build.library_path("simplex_tile").with_suffix(".log")
    emit({"build_s": time.perf_counter() - t0, "nvcc_s": took,
          "ptxas": [ln.strip() for ln in report.read_text().splitlines()
                    if "registers" in ln or "spill" in ln][:12]})

    # ---- main path: the two paper workloads through solve_batched ---------
    lp100 = random_lp_batch(np.random.default_rng(2018), B=50_000, m=100,
                            n=100, feasible_start=False)
    head = LPBatch(A=lp100.A[:64], b=lp100.b[:64], c=lp100.c[:64])
    _, launches_100 = solve_main("lp_100d_50k", lp100, head)

    afiro = read_mps(fixture_path("afiro"))
    g = perturbed_batch(afiro, 100_000)
    g64 = dataclasses.replace(g, A=g.A[:64], rhs=g.rhs[:64], lb=g.lb[:64],
                              ub=g.ub[:64], c=g.c[:64], c0=g.c0[:64])
    res_af, launches_af = solve_main("lp_afiro_100k", g, g64)
    assert res_af.status[0] == 0
    np.testing.assert_allclose(res_af.objective[0], AFIRO_OPT, rtol=1e-4)
    emit({"afiro_member0_objective": float(res_af.objective[0]),
          "published": AFIRO_OPT})

    # ---- kernel vs plain version on the card ------------------------------
    lp_af, _ = canonicalize(g)
    kernel_at_full_batch("lp_100d_50k", lp100)
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

    main_row = rows[0]   # lp_100d_50k slice, dantzig: the paper's rule
    emit({"kernels": [{
        "name": "simplex_tile", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/simplex_tile.cu",
        "replaces": "src/repro/kernels/simplex_tile.py:421",
        "launches": launches_100 + launches_af,
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"], "library_ms": None,
        "parity": "status, iterations and work counts equal; x, objective, "
                  "y, z within rel 1e-5; every rule and batch"}]})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
