"""Dry run of every (arch x shape x mesh) cell on the production meshes
(the reference's ``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all             # 16x16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod  # 2x16x16

Each cell is rank 0's share of the step (``launch/cells.py``) on the
abstract production mesh, traced once over fake tensors (the meta
device: shapes and dtypes, no data) on the host under
``analysis/op_cost.py``'s counter.  It launches no kernel and
needs no card, as the reference's dry run needs no TPU (it compiles for
512 placeholder host devices): it is a reckoning of the card's program
from shapes, not an entry point that runs the model on the CPU.  Every
rank of the production meshes holds blocks of the same local shapes, so
rank 0 stands for all.

Per cell it records the reference's keys where they have a meaning:
``arch``, ``shape``, ``mesh``, ``chips``, ``total_params``,
``memory_analysis`` (``argument_size_in_bytes``,
``output_size_in_bytes``, ``temp_size_in_bytes``: the fits-in-HBM
evidence), ``collectives`` (by kind, and ``_total``), ``roofline``
(``analysis/roofline.py``, at the H100's peaks), and ``skipped`` or
``error`` and ``traceback``.  The reference's ``hlo_cost`` is
``op_cost`` here (``flops``, ``mem_bytes``), its ``lower_s`` and
``compile_s`` are ``trace_s``, ``kernels`` holds the kernel charges and
``placement_gaps`` the placements the port reports but does not execute
(``launch/cells.py``).  Records land in artifacts/dryrun/*.json; a
failed cell prints FAIL and makes the exit code 1.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             cfg_override=None, tag: str = "") -> dict:
    from ..analysis.op_cost import step_cost
    from ..analysis.roofline import compute_roofline
    from ..models import shape_by_name
    from .cells import build_cell
    from .mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=multi_pod, abstract=True)
    chips = mesh.size
    mesh_name = "x".join(str(s) for s in mesh.shape.values())
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "chips": chips, "tag": tag}
    t0 = time.time()
    try:
        cell = build_cell(arch, shape_name, mesh, cfg=cfg_override)
        if "skipped" in cell:
            record["skipped"] = cell["skipped"]
            _save(record, out_dir)
            print(f"[dryrun] {arch} {shape_name} {mesh_name}: SKIP "
                  f"({cell['skipped']})")
            return record
        record["total_params"] = cell["total_params"]
        record["placement_gaps"] = cell["placement_gaps"]
        cost = step_cost(cell["fn"], *cell["args"], mesh=mesh)
        trace_s = time.time() - t0
        record["memory_analysis"] = {
            k: cost[k] for k in ("argument_size_in_bytes",
                                 "output_size_in_bytes",
                                 "temp_size_in_bytes")}
        record["op_cost"] = {"flops": cost["flops"],
                             "mem_bytes": cost["mem_bytes"]}
        record["collectives"] = cost["collectives"]
        record["kernels"] = cost["kernels"]
        record["op_histogram"] = cost["op_histogram"][:20]
        record["trace_s"] = round(trace_s, 1)
        flops, bytes_acc = cost["flops"], cost["mem_bytes"]
        coll_b = cost["collectives"]["_total"]["bytes"]
        rl = compute_roofline(
            cell["cfg"], shape_by_name(shape_name),
            per_device_flops=flops, per_device_bytes=bytes_acc,
            per_device_coll_bytes=coll_b, chips=chips,
            total_params=cell["total_params"])
        record["roofline"] = rl.as_dict()
        print(f"[dryrun] {arch} {shape_name} {mesh_name}: OK "
              f"trace={trace_s:.0f}s flops/dev={flops:.3e} "
              f"collB/dev={coll_b:.3e} bottleneck={rl.bottleneck}",
              flush=True)
    except Exception as e:  # a failed cell is a bug: record it loudly
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {arch} {shape_name} {mesh_name}: FAIL "
              f"{record['error']}", flush=True)
    _save(record, out_dir)
    return record


def _save(record: dict, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    tag = record.get("tag", "")
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}" + \
        (f"__{tag}" if tag else "")
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(record, f, indent=1, default=str)


def main(argv=None):
    from ..configs import CANONICAL
    from ..models.config import SHAPES

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="artifacts/dryrun")
    args = ap.parse_args(argv)

    archs = list(CANONICAL) if (args.all or args.arch is None) else [args.arch]
    shapes = [s.name for s in SHAPES] if (args.all or args.shape is None) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                results.append(run_cell(arch, shape, mp, args.out))
    n_ok = sum("roofline" in r for r in results)
    n_skip = sum("skipped" in r for r in results)
    n_fail = sum("error" in r for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_fail} FAILED")
    if n_fail:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
