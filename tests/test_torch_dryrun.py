"""The port's dry run (``repro_torch.launch.dryrun``, ``dryrun_lp`` and
``analysis.report``) on the host: the CLI on the reference's own test
cell, the kernel charges of the scan and the LP router inside traced
steps, the LP dry run's numbers against the reference's functions, and
the report's tables against the reference's renderings."""
import copy
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

RECORD_KEYS = ("arch", "shape", "mesh", "chips", "total_params",
               "memory_analysis", "op_cost", "collectives", "kernels",
               "roofline", "trace_s", "placement_gaps", "op_histogram")


def test_cli_on_the_reference_test_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "hymba-1.5b", "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    assert "hymba-1.5b decode_32k 16x16: OK" in r.stdout
    assert "1 ok, 0 skipped, 0 FAILED" in r.stdout
    rec = json.load(open(tmp_path / "hymba-1.5b__decode_32k__16x16.json"))
    assert set(RECORD_KEYS) <= set(rec)
    ma = rec["memory_analysis"]
    assert set(ma) == {"argument_size_in_bytes", "output_size_in_bytes",
                       "temp_size_in_bytes"}
    assert all(v > 0 for v in ma.values())
    assert rec["chips"] == 256 and rec["collectives"]["_total"]["count"] > 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                              "collective")
    # hymba's 5 KV heads do not divide 16: the cache keeps its rows
    assert [g.split(":")[0] for g in rec["placement_gaps"]] == ["kv_seq"]


def test_a_failed_cell_is_recorded_and_fails_the_run(tmp_path, monkeypatch):
    from repro_torch.launch import cells, dryrun

    def broken(*a, **k):
        raise RuntimeError("broken on purpose")
    monkeypatch.setattr(cells, "build_cell", broken)
    rec = dryrun.run_cell("hymba-1.5b", "decode_32k", False, str(tmp_path))
    assert rec["error"] == "RuntimeError: broken on purpose"
    assert "traceback" in rec
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "hymba-1.5b", "--shape", "decode_32k",
                     "--out", str(tmp_path)])


def test_skipped_cell_is_recorded(tmp_path):
    from repro_torch.launch.dryrun import run_cell
    rec = run_cell("qwen3-32b", "long_500k", False, str(tmp_path))
    assert rec["skipped"].startswith("skipped: 524k-token")
    assert (tmp_path / "qwen3-32b__long_500k__16x16.json").exists()


def test_falcon_mamba_prefill_charges_layers_times_chunks(tmp_path):
    """falcon-mamba-7b's prefill_32k on rank 0 of 16 x 16 (depth cut to
    2 layers): one scan charge a layer a 512-token chunk, at the kernel's
    shape (2 sequences, d_inner 8,192 / 16 = 512 a rank)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import run_cell
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=2)
    rec = run_cell("falcon-mamba-7b", "prefill_32k", False, str(tmp_path),
                   cfg_override=cfg, tag="cut")
    scan = rec["kernels"]["ssm_scan"]
    assert scan["launches"] == 2 * 32768 // 512
    L = 512 * 16
    assert scan["flops"] == scan["launches"] * 2 * 2 * 512 * L
    assert scan["bytes"] == scan["launches"] * 4 * (3 * 2 * 512 * L
                                                    + 2 * 2 * L)
    assert "ssm_scan_bwd" not in rec["kernels"]
    assert dict(rec["op_histogram"]).get("mm", 0) > 0


def test_moe_with_the_lp_router_charges_one_simplex_a_layer_call():
    """A reduced llama4-scout with ``lp_capacity`` on an abstract (1, 4)
    mesh (experts sharded, tokens exchanged by the abstract all-to-all):
    prefill charges one whole-solve launch a MoE layer, a train step one
    a layer a microbatch, and the plain engine never runs."""
    from repro_torch.analysis.op_cost import step_cost
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Mesh, Sharder
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.models import LM
    from repro_torch.optim import get_optimizer
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e").reduced(),
                              lp_capacity=True, n_layers=3)
    shd = Sharder(cfg, Mesh.abstract((1, 4), ("data", "model")))
    assert shd.experts_sharded()
    model = LM(cfg, device=torch.device("meta"), shd=shd)
    tokens = torch.zeros((2, 64), dtype=torch.long, device="meta")
    with torch.no_grad():
        pre = step_cost(model.prefill, tokens, mesh=shd.mesh)
    opt = get_optimizer("adamw")
    state = opt.init(list(model.named_parameters()), shd=shd)
    step = make_train_step(model, opt, microbatches=2, shd=shd,
                           local_batch=True)
    train = step_cost(step, state, {"tokens": tokens, "labels": tokens},
                      mesh=shd.mesh)
    assert pre["kernels"]["simplex_tile"]["launches"] == 3
    assert train["kernels"]["simplex_tile"]["launches"] == 3 * 2
    assert pre["collectives"]["all_to_all"]["count"] == 2 * 3
    assert "ssm_scan" not in pre["kernels"]


def test_lp_dry_run_equals_the_reference_numbers():
    from repro.configs.paper_lp import WORKLOADS as REF_WORKLOADS
    from repro.configs.paper_lp import build_batch as ref_build_batch
    from repro.core import canonical_shape as ref_canonical_shape
    from repro.core import solve_batched_reference as ref_oracle
    from repro.core.simplex import flops_per_pivot as ref_flops_per_pivot
    from repro_torch.configs.paper_lp import WORKLOADS
    from repro_torch.launch.dryrun_lp import SAME_PROGRAM, workload_record
    assert [w.name for w in WORKLOADS] == [w.name for w in REF_WORKLOADS]
    rng, ref_rng = np.random.default_rng(0), np.random.default_rng(0)
    for wl, ref_wl in zip(WORKLOADS, REF_WORKLOADS):
        rec = workload_record(wl, rng, 256, "16x16")
        sample = ref_build_batch(ref_wl, batch=32, rng=ref_rng)
        mean = float(ref_oracle(sample).iterations.mean())
        m, n = ((ref_wl.m, ref_wl.n) if ref_wl.fixture is None
                else ref_canonical_shape(sample))
        assert rec["mean_pivots"] == mean, wl.name
        assert (rec["m_device"], rec["n_device"]) == (m, n)
        want = ref_flops_per_pivot(m, n) * mean * ref_wl.batch / 256
        for mode in ("pjit", "shard_map"):
            one = rec[mode]
            assert one["analytic_flops_per_dev"] == want
            k = one["kernels"]["simplex_tile"]
            lps = -(-wl.batch // 256)
            assert k["launches"] == 1 and k["flops"] == \
                ref_flops_per_pivot(m, n) * lps * mean
            # the result gather: x, objective, status, iterations, y, z
            assert one["collective_count"] == 6
            assert one["collective_bytes_per_dev"] == \
                256 * lps * (4 * (2 * n + m + 2) + 1)
        assert rec["modes"] == SAME_PROGRAM


def _records():
    """A fixed record set in the port's keys: two ok cells, a skipped
    one, a failed one, a multi-pod one and a tagged one."""
    def ok(arch, shape, mesh, flops, coll, args, temp, bott):
        return {"arch": arch, "shape": shape, "mesh": mesh, "chips": 256,
                "tag": "", "total_params": 1e9,
                "memory_analysis": {"argument_size_in_bytes": args,
                                    "output_size_in_bytes": 1,
                                    "temp_size_in_bytes": temp},
                "op_cost": {"flops": flops, "mem_bytes": 3 * flops},
                "collectives": {"_total": {"count": 5, "bytes": coll}},
                "trace_s": 12.0,
                "roofline": {"compute_s": flops / 989e12,
                             "memory_s": 3 * flops / 3.35e12,
                             "collective_s": coll / 50e9,
                             "model_flops": 7e15, "hlo_flops_total": 1e16,
                             "useful_ratio": 0.7, "bottleneck": bott}}
    recs = [ok("qwen3-32b", "train_4k", "16x16", 2e14, 3e9, 5e9, 9e10,
               "memory"),
            ok("hymba-1.5b", "decode_32k", "16x16", 7e9, 1e8, 1e9, 6e8,
               "collective"),
            ok("qwen3-32b", "train_4k", "2x16x16", 1e14, 2e9, 4e9, 8e9,
               "memory"),
            {"arch": "qwen3-32b", "shape": "long_500k", "mesh": "16x16",
             "skipped": "skipped: x"},
            {"arch": "granite-20b", "shape": "train_4k", "mesh": "16x16",
             "error": "RuntimeError: y"}]
    tagged = copy.deepcopy(recs[0])
    tagged["tag"] = "cut"
    return recs + [tagged]


def _to_reference(rec):
    rec = copy.deepcopy(rec)
    if "op_cost" in rec:
        rec["hlo_cost"] = rec.pop("op_cost")
        rec["compile_s"] = rec.pop("trace_s")
    return rec


def _without_fits(table):
    rows = [r.split("|") for r in table.splitlines()]
    return ["|".join(r[:-2]) for r in rows]


def test_report_renders_as_the_reference():
    from repro.analysis import report as ref_report
    from repro_torch.analysis import report
    recs = _records()
    ref_recs = [_to_reference(r) for r in recs]
    ours, theirs = report.dryrun_table(recs), \
        ref_report.dryrun_table(ref_recs)
    assert ours.replace("trace_s", "compile_s") == theirs
    assert _without_fits(report.roofline_table(recs)) == \
        _without_fits(ref_report.roofline_table(ref_recs))
    assert report.pick_hillclimb(recs) == ref_report.pick_hillclimb(ref_recs)
    # fits: args + temp against the H100's 80 GB, not 16 GiB
    fits = [r.split("|")[-2].strip()
            for r in report.roofline_table(recs).splitlines()[2:]]
    assert fits[0] == "NO (88.5)" and fits[1] == "yes (1.5)"   # GiB
