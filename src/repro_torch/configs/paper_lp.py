"""The paper's own workloads: batches of small and medium LPs.

A copy of ``repro.configs.paper_lp`` on the port's own generators.  Two
workload classes:

* synthetic: random standard-form LPs at the paper's Table-2 sizes
  (``core.reference.random_lp_batch``);
* fixture-backed: a vendored general-form MPS instance
  (``tests/fixtures/``, ``io.mps``) expanded into a batch of perturbed
  copies the way the paper builds its Netlib batches (Sec. 6).  ``m``/``n``
  record the *original* shape; the solvers run at the canonical shape
  (``analysis.lp_perf.canonical_work``), which is how these workloads must
  be costed.

``build_batch`` materializes either kind, bit for bit as the reference
does from the same generator.
"""
import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class LPWorkload:
    name: str
    batch: int
    m: int
    n: int
    feasible_start: bool = True
    fixture: Optional[str] = None     # io.mps fixture name


WORKLOADS = (
    LPWorkload("lp_5d_100k", batch=100_000, m=5, n=5),
    LPWorkload("lp_28d_100k", batch=100_000, m=28, n=28),
    LPWorkload("lp_100d_50k", batch=50_000, m=100, n=100),
    LPWorkload("lp_300d_2k", batch=2048, m=300, n=300),
    # real general-form instances, batch-expanded (canonical 35x32 / 79x49)
    LPWorkload("lp_afiro_100k", batch=100_000, m=27, n=32, fixture="afiro"),
    LPWorkload("lp_sc50b_like_50k", batch=50_000, m=50, n=48,
               fixture="sc50b_like"),
)


def workload(name: str) -> LPWorkload:
    """The ``WORKLOADS`` entry called ``name``."""
    for w in WORKLOADS:
        if w.name == name:
            return w
    raise KeyError(f"unknown workload {name!r}; expected one of "
                   f"{[w.name for w in WORKLOADS]}")


def build_batch(w: LPWorkload, batch: Optional[int] = None,
                rng: Optional[np.random.Generator] = None):
    """Materialize a workload: an ``LPBatch`` for synthetic entries, a
    ``GeneralLPBatch`` (perturbed copies of the vendored instance) for
    fixture-backed ones, both solvable by every ``solve_*`` entry point.
    ``batch`` overrides the published batch size; ``rng`` defaults to
    ``default_rng(2018)``."""
    from ..core.reference import random_lp_batch

    B = batch or w.batch
    rng = rng or np.random.default_rng(2018)
    if w.fixture is None:
        return random_lp_batch(rng, B=B, m=w.m, n=w.n,
                               feasible_start=w.feasible_start)
    from ..io.mps import fixture_path, perturbed_batch, read_mps
    return perturbed_batch(read_mps(fixture_path(w.fixture)), B, rng)
