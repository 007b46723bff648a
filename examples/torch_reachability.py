"""The paper's motivating application (Sec. 3/7) on the PyTorch/CUDA port:
state-space exploration of a linear control system via support-function
sampling, XSpeed's workload.

Computes a 2000-step flow-pipe of a 5-dim system, sampling K directions
per step: T*K = 80k box LPs solved via (a) the Sec. 5.6 closed form
(``solve_hyperbox``: the hyperbox kernel on a card) and (b) the general
batched simplex (the whole-solve simplex kernel on a card) on 4000 of
them, then chains warm starts along the flow-pipe (the tableau warm path).

    PYTHONPATH=src python examples/torch_reachability.py               # card
    PYTHONPATH=src python examples/torch_reachability.py --device cpu  # plain
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import (GeneralLPBatch, hyperbox_as_general_lp,
                              solve_batched, solve_hyperbox,
                              solve_hyperbox_ref)
from repro_torch.core.forms import canonical_shape
from repro_torch.core.lp import WarmStart
from repro_torch.device import resolve_device


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)

    rng = np.random.default_rng(1)
    n, T, K = 5, 2000, 40

    # five-dimensional linear system (Girard'05 benchmark shape): x' = Ax
    A = np.array([[-1, -4, 0, 0, 0],
                  [4, -1, 0, 0, 0],
                  [0, 0, -3, 1, 0],
                  [0, 0, -1, -3, 0],
                  [0, 0, 0, 0, -2]], float)
    dt = 0.005
    M = np.eye(n) + dt * A  # Euler step

    lo, hi = [np.full(n, 0.9)], [np.full(n, 1.1)]  # initial box around (1,..,1)
    for _ in range(T - 1):
        c = (lo[-1] + hi[-1]) / 2
        r = (hi[-1] - lo[-1]) / 2
        lo.append(M @ c - np.abs(M) @ r - 1e-4)
        hi.append(M @ c + np.abs(M) @ r + 1e-4)
    lo, hi = np.stack(lo), np.stack(hi)

    dirs = rng.normal(size=(K, n))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    lo_e = np.repeat(lo, K, axis=0)
    hi_e = np.repeat(hi, K, axis=0)
    d_e = np.tile(dirs, (T, 1))
    print(f"{T} flow-pipe steps x {K} directions = {T*K} box LPs on {dev}")

    tl, th, td = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                  for a in (lo_e, hi_e, d_e))
    sup = solve_hyperbox(tl, th, td)  # warm up (and build the kernel) + solve
    sync(dev)
    t0 = time.perf_counter()
    sup = solve_hyperbox(tl, th, td)
    sync(dev)
    t_box = time.perf_counter() - t0
    sup = sup.cpu().numpy()

    t0 = time.perf_counter()
    _ = solve_hyperbox_ref(lo_e, hi_e, d_e)
    t_np = time.perf_counter() - t0

    lp, off = hyperbox_as_general_lp(lo_e[:4000], hi_e[:4000], d_e[:4000])
    t0 = time.perf_counter()
    res = solve_batched(lp, device=dev)
    t_simplex = (time.perf_counter() - t0) * (T * K / 4000)

    print(f"hyperbox solver (paper Sec. 5.6): {t_box*1e3:8.3f} ms")
    print(f"numpy closed form (sequential-ish): {t_np*1e3:6.1f} ms "
          f"({t_np/t_box:.1f}x slower)")
    print(f"general batched simplex (extrapolated): {t_simplex*1e3:8.1f} ms "
          f"({t_simplex/t_box:.0f}x slower)")
    np.testing.assert_allclose(res.objective + off,
                               sup.reshape(T * K)[:4000], rtol=1e-4,
                               atol=1e-6)
    print("hyperbox == simplex on the same LPs (checked on 4000)")

    # warm-start chaining along the flow-pipe: the next 4000 LPs are the
    # SAME K directions against boxes drifted 100 Euler steps further, i.e.
    # the same general-form LPs with edited variable bounds.  Build the
    # slice once as a GeneralLPBatch and get the drifted slice with
    # ``with_bounds`` (a validated copy-edit: A/c untouched, only lb/ub
    # replaced).  The optimal basis of a box LP depends only on the
    # direction's sign pattern relative to the box, which the drift never
    # flips, so re-solving from the previous slice's terminal state
    # (``warm=res2.warm_start()``) needs ~0 pivots where a cold solve
    # re-pays the full pivot path.
    g1 = GeneralLPBatch.from_arrays(
        A=d_e[:4000, None, :], sense=["L"],
        rhs=np.full((4000, 1), 1e6),           # vacuous row; bounds do the work
        lb=lo_e[:4000], ub=hi_e[:4000], c=d_e[:4000], maximize=True)
    # the first slice starts from the slack basis, which is a cold start
    # through the warm path: on a card the whole-solve kernel captures no
    # terminal state, the warm path does
    mc, nc = canonical_shape(g1)
    slack = WarmStart(m=mc, n=nc,
                      basis=np.tile(np.arange(nc, nc + mc, dtype=np.int32),
                                    (4000, 1)),
                      at_upper=np.zeros((4000, nc), bool))
    res2 = solve_batched(g1, device=dev, warm=slack)
    np.testing.assert_allclose(res2.objective, sup.reshape(T * K)[:4000],
                               rtol=1e-4, atol=1e-6)
    g2 = g1.with_bounds(lb=lo_e[4000:8000], ub=hi_e[4000:8000])
    cold2 = solve_batched(g2, device=dev)
    warm2 = solve_batched(g2, device=dev, warm=res2.warm_start())
    print(f"flow-pipe warm chaining (next 4000 LPs via with_bounds): "
          f"cold {cold2.iterations.mean():.1f} pivots/LP -> "
          f"warm {warm2.iterations.mean():.1f}; statuses agree: "
          f"{bool(np.array_equal(cold2.status, warm2.status))}")
    np.testing.assert_allclose(warm2.objective,
                               sup.reshape(T * K)[4000:8000], rtol=1e-4,
                               atol=1e-6)
    print(f"state-space envelope at t=0:   {sup.reshape(T, K)[0, :4].round(3)}")
    print(f"state-space envelope at t=end: {sup.reshape(T, K)[-1, :4].round(3)}")


if __name__ == "__main__":
    main()
