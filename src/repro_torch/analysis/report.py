"""Tables of the dry run's records (the reference's
``analysis/report.py``), from artifacts/dryrun/*.json.

  PYTHONPATH=src python -m repro_torch.analysis.report [--dir artifacts/dryrun]

The reference's three renderings: the dry run of every cell, the
roofline of the 16 x 16 cells, and the hillclimb candidates.  "Fits" is
judged against one H100's 80 GB (``roofline.HBM_BYTES``): argument bytes
plus the peak of the step's live bytes (``temp_size_in_bytes``).  The
roofline's terms use the H100's data-sheet peaks (``roofline.py``).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from .roofline import HBM_BYTES


def load(dirpath: str):
    recs = []
    for p in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def _per_dev(r) -> float:
    ma = r.get("memory_analysis", {})
    return ma.get("argument_size_in_bytes", 0) + \
        ma.get("temp_size_in_bytes", 0)


def fits(r) -> str:
    """"yes" where a record's arguments + temp fit one card's 80 GB,
    else "NO"."""
    return "yes" if _per_dev(r) <= HBM_BYTES else "NO"


def roofline_table(recs, mesh="16x16"):
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | bottleneck | "
        "MODEL_FLOPS | useful ratio | fits HBM (GiB/card) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != mesh or r.get("tag"):
            continue
        if "skipped" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"skip | — | — | — |")
            continue
        if "roofline" not in r:
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR: "
                         f"{r.get('error', '?')} | | | | | | |")
            continue
        rl = r["roofline"]
        per_dev = _per_dev(r) / 2**30
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.3f} | "
            f"{rl['memory_s']:.3f} | {rl['collective_s']:.3f} | "
            f"{rl['bottleneck']} | {rl['model_flops']:.2e} | "
            f"{rl['useful_ratio']:.2f} | {fits(r)} ({per_dev:.1f}) |")
    return "\n".join(lines)


def dryrun_table(recs):
    lines = [
        "| arch | shape | mesh | status | trace_s | flops/dev | mem GiB/dev "
        "(traffic) | coll GiB/dev | args+temp GiB/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("tag"):
            continue
        if "skipped" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | skip "
                         f"| — | — | — | — | — |")
            continue
        if "roofline" not in r:
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"**FAIL** {r.get('error','')} | | | | | |")
            continue
        oc = r["op_cost"]
        coll = r["collectives"]["_total"]["bytes"]
        per_dev = _per_dev(r) / 2**30
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{r.get('trace_s', 0):.0f} | {oc['flops']:.2e} | "
            f"{fmt_bytes(oc['mem_bytes'])} | {fmt_bytes(coll)} | "
            f"{per_dev:.1f} |")
    return "\n".join(lines)


def pick_hillclimb(recs):
    """Worst roofline fraction / most collective-bound / paper-representative."""
    cands = []
    for r in recs:
        if r.get("mesh") != "16x16" or "roofline" not in r or r.get("tag"):
            continue
        rl = r["roofline"]
        dom = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
        frac = rl["compute_s"] / dom if dom else 0
        cands.append((frac, rl["collective_s"] / max(rl["compute_s"], 1e-9),
                      r["arch"], r["shape"], rl["bottleneck"]))
    cands.sort()
    return cands


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print("## Dry-run (all cells x both meshes)\n")
    print(dryrun_table(recs))
    print("\n## Roofline (single-pod 16x16)\n")
    print(roofline_table(recs))
    print("\n## Hillclimb candidates (sorted by compute fraction)\n")
    for frac, collr, arch, shape, b in pick_hillclimb(recs)[:12]:
        print(f"- {arch} {shape}: compute-fraction={frac:.2f} "
              f"coll/compute={collr:.1f} bottleneck={b}")


if __name__ == "__main__":
    main()
