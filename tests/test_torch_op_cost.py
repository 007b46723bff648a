"""The dry run's cost counter (``repro_torch.analysis.op_cost``), the
counterpart of tests/test_hlo_cost.py and test_hlo_cost_units.py, and
the kernel charges the wrappers make on fake inputs.

The reference parses compiled HLO text and multiplies each while body by
its trip count; the port traces the eager step over fake tensors (on the
meta device), so a Python loop is counted trip by trip and the counts
are exact."""
import math

import numpy as np
import pytest
import torch

from repro.core.simplex import flops_per_pivot as ref_flops_per_pivot
from repro_torch.analysis.op_cost import OpCost, charge, step_cost
from repro_torch.distributed.sharding import Axis, Mesh
from repro_torch.kernels.simplex_tile import simplex_tile
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd


@pytest.mark.parametrize("fake", (True, False), ids=("fake", "real"))
def test_loop_of_products_counts_every_trip(fake):
    M, L = 64, 17

    def f(x, ws):
        for w in ws:
            x = x @ w
        return x

    with torch.device("meta") if fake else torch.no_grad():
        x = torch.ones((M, M))
        ws = [torch.ones((M, M)) for _ in range(L)]
        cost = step_cost(f, x, ws)
    assert cost["flops"] == L * 2 * M ** 3
    assert dict(cost["op_histogram"])["mm"] == L


def test_flops_single_product():
    with torch.device("meta"):
        a, b = torch.ones((32, 48)), torch.ones((48, 16))
        cost = step_cost(lambda a, b: a @ b, a, b)
    assert cost["flops"] == 2 * 32 * 48 * 16


def test_flops_with_batch_dims():
    with torch.device("meta"):
        x, y = torch.ones((4, 8, 16)), torch.ones((4, 16, 32))
        cost = step_cost(torch.bmm, x, y)
    assert cost["flops"] == 2 * 4 * 8 * 32 * 16


def test_bytes_are_inputs_plus_outputs_and_views_are_free():
    with torch.device("meta"):
        a = torch.ones((32, 48))
        b = torch.ones((48, 16), dtype=torch.bfloat16)
        one = step_cost(lambda a, b: a @ b.float(), a, b)
        views = step_cost(lambda a: a.reshape(-1).view(48, 32).t()[:7]
                          .expand(3, 7, 48).detach(), a)
        inplace = step_cost(lambda a, b: a.add_(b), a, a.clone())
    # the cast reads b (bf16) and writes it as float32; the product reads
    # a and the cast, and writes the (32, 16) float32 result
    cast = 48 * 16 * (2 + 4)
    product = (32 * 48 + 48 * 16 + 32 * 16) * 4
    assert one["mem_bytes"] == cast + product
    assert views["mem_bytes"] == 0 and views["flops"] == 0
    assert views["temp_size_in_bytes"] == 0
    # an in-place op reads both and writes its first input, counted once
    assert inplace["mem_bytes"] == 2 * 32 * 48 * 4


def test_peak_of_a_known_sequence_of_allocations():
    def f(x):
        a = x * 2            # 4 KiB live
        b = a + 1            # 8 KiB
        del a                # 4 KiB
        c = torch.cat([b, b])    # 12 KiB
        d = c.sum(0, keepdim=True)   # 12 KiB + 128 B
        del b, c             # d alone
        return d

    with torch.device("meta"):
        x = torch.ones((32, 32))
        cost = step_cost(f, x)
    assert cost["argument_size_in_bytes"] == 32 * 32 * 4
    assert cost["temp_size_in_bytes"] == 3 * 32 * 32 * 4 + 32 * 4
    assert cost["output_size_in_bytes"] == 32 * 4


def test_peak_counts_what_autograd_keeps():
    def f(x):
        y = x.exp()          # kept for exp's backward
        z = y.sin()          # sin keeps y too
        del y
        return z.sum()

    with torch.device("meta"):
        x = torch.ones((64, 64), requires_grad=True)
        held = step_cost(f, x)
        with torch.no_grad():
            free = step_cost(f, x)
    n = 64 * 64 * 4
    assert held["temp_size_in_bytes"] == 2 * n + 4
    assert free["temp_size_in_bytes"] == 2 * n


@pytest.mark.parametrize("L", (1, 5))
def test_collectives_in_a_loop_are_counted_every_trip(L):
    """On an abstract (1, 4) mesh each collective of the loop body counts
    once a trip, at max(operand, result) bytes, and returns zeros of its
    result's shape."""
    mesh = Mesh.abstract((1, 4), ("data", "model"), rank=2)
    line = mesh.axis("model")
    assert (line.size, line.index, line.abstract) == (4, 2, True)
    M = 8

    def f(x):
        for _ in range(L):
            g = line.all_gather(x, 1)            # (8, 32) out
            r = line.all_reduce(g)
            s = line.reduce_scatter(r, 1)        # (8, 8) out
            x = line.all_to_all(s) + x
        return x, g

    with torch.device("meta"):
        x = torch.ones((M, M))
        cost = step_cost(f, x, mesh=mesh)
        out = f(x)
    assert tuple(out[1].shape) == (M, 4 * M)
    n = M * M * 4
    want = {"all_gather": 4 * n, "all_reduce": 4 * n,
            "reduce_scatter": 4 * n, "all_to_all": n}
    got = cost["collectives"]
    for kind, b in want.items():
        assert got[kind] == {"count": L, "bytes": L * b}, kind
    assert got["_total"] == {"count": 4 * L, "bytes": L * sum(want.values())}
    ex = mesh.exchanges()["kinds"]
    assert ex["all_gather"]["count"] == 2 * L   # step_cost's trace and f's
    with torch.no_grad():
        zeros = line.all_reduce(torch.ones(3))
    assert torch.equal(zeros, torch.zeros(3))


def test_a_line_of_one_rank_exchanges_nothing():
    one = Axis((), 1, 0)
    t = torch.ones(4)
    assert one.all_gather(t, 0) is t and one.all_reduce(t) is t
    assert one.kinds == {}


@pytest.mark.parametrize("B, T, d, s", ((2, 16, 8, 4), (2, 512, 512, 16)),
                         ids=("small", "sharded_falcon_chunk"))
def test_scan_charges_equal_the_formulas_and_run_no_plain_op(B, T, d, s):
    L = d * s
    with torch.device("meta"):
        dA = torch.ones((B, T, d, s))
        dBx = torch.ones((B, T, d, s))
        h0 = torch.zeros((B, d, s))
    fwd = step_cost(ssm_scan, dA, dBx, h0)
    bwd = step_cost(ssm_scan_bwd, dA, dA, h0, dA, h0)
    with OpCost():
        hs, hT = ssm_scan(dA, dBx, h0)
    assert (tuple(hs.shape), tuple(hT.shape)) == ((B, T, d, s), (B, d, s))
    # outside the counter a meta tensor is refused
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ssm_scan(dA, dBx, h0)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ssm_scan_bwd(dA, dA, h0, dA, h0)
    assert fwd["kernels"] == {"ssm_scan": {
        "launches": 1, "flops": 2 * B * T * L,
        "bytes": 4 * (3 * B * T * L + 2 * B * L)}}
    assert bwd["kernels"] == {"ssm_scan_bwd": {
        "launches": 1, "flops": 3 * B * T * L,
        "bytes": 4 * (5 * B * T * L + 3 * B * L)}}
    # the outputs are allocated; no op of the plain loop (fma, select)
    # is dispatched
    assert {k for k, _ in fwd["op_histogram"]} == {"empty_like"}
    assert {k for k, _ in bwd["op_histogram"]} == {"empty_like"}
    assert fwd["flops"] == 2 * B * T * L


def test_scan_through_autograd_charges_forward_and_backward():
    B, T, d, s = 1, 8, 4, 2
    with torch.device("meta"):
        dA = torch.ones((B, T, d, s), requires_grad=True)
        dBx = torch.ones((B, T, d, s), requires_grad=True)
        h0 = torch.zeros((B, d, s))

        def step(dA, dBx, h0):
            hs, _ = ssm_scan(dA, dBx, h0)
            return torch.autograd.grad(hs.sum(), (dA, dBx))

        cost = step_cost(step, dA, dBx, h0)
    assert cost["kernels"]["ssm_scan"]["launches"] == 1
    assert cost["kernels"]["ssm_scan_bwd"]["launches"] == 1


@pytest.mark.parametrize("trip", (1.0, 7.5))
def test_simplex_charge_is_the_pivot_count_at_the_default_trip(trip):
    B, m, n = 6, 5, 9
    with torch.device("meta"):
        A = torch.ones((B, m, n))
        b, c = torch.ones((B, m)), torch.ones((B, n))
        ub = torch.full((B, n), math.inf)
        cost = step_cost(lambda *a: simplex_tile(*a, m=m, n=n,
                                                 max_iters=50),
                         A, b, c, ub, default_trip=trip)
        with OpCost():
            out = simplex_tile(A, b, c, ub, m=m, n=n, max_iters=50)
        with pytest.raises(ValueError, match="runs on cuda or cpu"):
            simplex_tile(A, b, c, ub, m=m, n=n, max_iters=50)
    k = cost["kernels"]["simplex_tile"]
    assert k["launches"] == 1
    assert k["flops"] == ref_flops_per_pivot(m, n) * B * trip
    tableau = B * (m + 2) * (n + 2 * m + 1)
    assert k["bytes"] == 2 * 4 * (tableau + B * (m + 1)) \
        + 4 * B * (n + 1) + 4 * B * (2 * n + m + 3)
    assert [tuple(t.shape) for t in out] == [(B, n), (B,), (B,), (B,),
                                             (B, m), (B, n)]
    assert out[2].dtype == torch.int8
    # the card's path: the tableau built by a few torch ops, never the
    # engine's loop (thousands of ops at 50 iterations)
    assert sum(n for _, n in cost["op_histogram"]) < 100
    assert cost["flops"] == k["flops"]


def test_real_cpu_tensors_still_take_the_plain_version():
    rng = np.random.default_rng(0)
    dA = torch.from_numpy(rng.uniform(0.5, 1, (1, 4, 2, 2)).astype(np.float32))
    dBx = torch.from_numpy(rng.normal(size=(1, 4, 2, 2)).astype(np.float32))
    h0 = torch.zeros((1, 2, 2))
    before = ssm_scan.launches
    with OpCost() as cost:
        hs, hT = ssm_scan(dA, dBx, h0)
    assert cost.kernels == {} and ssm_scan.launches == before
    assert torch.equal(hs[:, -1], hT)
    assert cost.histogram["mul"] + cost.histogram["addcmul"] + \
        cost.histogram["add"] > 0


def test_charge_outside_a_counter_is_refused():
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        charge("nothing", flops=1.0, nbytes=2.0)   # no counter entered
    with OpCost(default_trip=3.0) as cost:
        charge("k", flops=1.0, trip_flops=2.0, nbytes=4.0)
    assert cost.kernels == {"k": {"launches": 1, "flops": 7.0,
                                  "bytes": 4.0}}
