"""Dry run of the paper's own workloads on the production mesh (the
reference's ``launch/dryrun_lp.py``): each workload's batch of LPs split
over all 256 (or 512) ranks, one rank's block reckoned.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_lp [--multi-pod]

For each workload of ``configs/paper_lp.WORKLOADS`` the record keeps the
reference's keys: ``mean_pivots`` from the float64 oracle
(``core/reference.py``) on a 32-LP sample drawn with ``default_rng(0)``
(one generator for all workloads, in order, as the reference draws
them); ``m_device``/``n_device``, the canonical shape a fixture workload
runs at (``core/forms.py`` ``canonical_shape``); and for each mode the
work of rank 0's block of ceil(B / chips) LPs: the whole-solve simplex
kernel's charge on fake (meta) inputs (``kernels/simplex_tile.py``, at
``default_trip = mean_pivots``) and the tableau build around it
(``flops_per_dev``, ``mem_bytes_per_dev``, ``temp_bytes``), the
reference's analytic count (``analytic_flops_per_dev``), the port's one
result gather over the abstract mesh (``core/distributed.py``: every
output all-gathered once) and the roofline terms at the H100's numbers
(``analysis/roofline.py``; the simplex runs in float32 outside the
tensor cores, so ``compute_s_f32`` divides by the data sheet's 67e12
as well).

The reference's lockstep ``pjit`` (one global while-loop, a cross-chip
all-reduce every pivot) has no counterpart: the port's kernels exit per
LP (``core/distributed.py``), so ``solve_pjit`` and ``solve_shard_map``
run the same program and both modes reckon it; the record says so.
Nothing is compiled or launched, and no card is needed.
"""
from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np

PEAK_F32_FLOPS = 67e12   # float32 outside the tensor cores, H100 SXM
SAME_PROGRAM = ("pjit and shard_map run one program in the port: the "
                "kernels exit per LP, so there is no lockstep loop and no "
                "per-pivot all-reduce (core/distributed.py)")


def block_cost(m: int, n: int, lps: int, chips: int, mean_pivots: float
               ) -> dict:
    """``analysis/op_cost.py``'s counters of one rank's solve of ``lps``
    LPs of m x n: the tableau build, one simplex charge at
    ``mean_pivots`` pivots, and the gather of its results over an
    abstract line of ``chips`` ranks."""
    import torch

    from ..analysis.op_cost import step_cost
    from ..core.lp import default_max_iters
    from ..distributed.sharding import Mesh
    from ..kernels.simplex_tile import simplex_tile

    mesh = Mesh.abstract((chips,), ("data",))
    line = mesh.axis("data")

    def solve(A, b, c, ub):
        out = simplex_tile(A, b, c, ub, m=m, n=n,
                           max_iters=default_max_iters(m, n))
        return [line.all_gather(t, 0) for t in out]

    f32 = dict(dtype=torch.float32, device="meta")
    args = (torch.zeros((lps, m, n), **f32), torch.zeros((lps, m), **f32),
            torch.zeros((lps, n), **f32),
            torch.full((lps, n), math.inf, **f32))
    return step_cost(solve, *args, default_trip=mean_pivots, mesh=mesh)


def workload_record(wl, rng, chips: int, mesh_name: str) -> dict:
    from ..configs.paper_lp import build_batch
    from ..core.forms import canonical_shape
    from ..core.reference import solve_batched_reference
    from ..core.simplex import flops_per_pivot
    from ..analysis.roofline import HBM_BW, LINK_BW, PEAK_FLOPS

    sample = build_batch(wl, batch=32, rng=rng)
    mean_pivots = float(solve_batched_reference(sample).iterations.mean())
    m_dev, n_dev = ((wl.m, wl.n) if wl.fixture is None
                    else canonical_shape(sample))
    lps = -(-wl.batch // chips)
    rec = {"workload": wl.name, "mesh": mesh_name, "chips": chips,
           "batch": wl.batch, "m": wl.m, "n": wl.n,
           "m_device": m_dev, "n_device": n_dev,
           "mean_pivots": mean_pivots, "lps_per_dev": lps,
           "modes": SAME_PROGRAM}
    cost = block_cost(m_dev, n_dev, lps, chips, mean_pivots)
    coll = cost["collectives"]["_total"]
    one = {
        "flops_per_dev": cost["flops"],
        "analytic_flops_per_dev":
            flops_per_pivot(m_dev, n_dev) * mean_pivots * wl.batch / chips,
        "mem_bytes_per_dev": cost["mem_bytes"],
        "collective_bytes_per_dev": coll["bytes"],
        "collective_count": coll["count"],
        "temp_bytes": cost["temp_size_in_bytes"],
        "kernels": cost["kernels"],
        "compute_s": cost["flops"] / PEAK_FLOPS,
        "compute_s_f32": cost["flops"] / PEAK_F32_FLOPS,
        "memory_s": cost["mem_bytes"] / HBM_BW,
        "collective_s": coll["bytes"] / LINK_BW,
    }
    rec["pjit"] = one
    rec["shard_map"] = dict(one)
    return rec


def main(argv=None):
    from ..configs.paper_lp import WORKLOADS
    from .mesh import make_production_mesh

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_lp")
    args = ap.parse_args(argv)

    mesh = make_production_mesh(multi_pod=args.multi_pod, abstract=True)
    chips = mesh.size
    mesh_name = "x".join(str(s) for s in mesh.shape.values())
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(0)
    records = []
    for wl in WORKLOADS:
        rec = workload_record(wl, rng, chips, mesh_name)
        one = rec["shard_map"]
        print(f"[dryrun-lp] {wl.name} {mesh_name}: "
              f"pivots~{rec['mean_pivots']:.0f} "
              f"flops/dev={one['flops_per_dev']:.2e} "
              f"collB/dev={one['collective_bytes_per_dev']:.2e} "
              f"coll#={one['collective_count']:.0f}", flush=True)
        with open(os.path.join(args.out,
                               f"{wl.name}__{mesh_name}.json"), "w") as f:
            json.dump(rec, f, indent=1)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
