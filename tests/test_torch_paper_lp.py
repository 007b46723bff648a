"""The port's paper workloads against the reference's.

``repro_torch.configs.paper_lp.WORKLOADS`` holds the reference's six
entries, field for field, and ``build_batch`` gives arrays bit-equal to
``repro.configs.paper_lp.build_batch`` from the same generator for every
workload at batch 64 (and at the default generator), through the port's
own ``random_lp_batch`` and ``io.mps``.  The fixture-backed workloads
canonicalize to the shapes the configuration's comment names.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs import paper_lp as ref
from repro_torch.configs import paper_lp
from repro_torch.core import canonicalize
from repro_torch.core.lp import LPBatch

NAMES = [w.name for w in ref.WORKLOADS]
LP_FIELDS = ("A", "b", "c", "ub")
GENERAL_FIELDS = ("A", "sense", "rhs", "lb", "ub", "c", "c0", "ranges",
                  "integer")


def test_workloads_equal_the_reference():
    assert [dataclasses.asdict(w) for w in paper_lp.WORKLOADS] == \
        [dataclasses.asdict(w) for w in ref.WORKLOADS]
    assert [paper_lp.workload(n).name for n in NAMES] == NAMES
    with pytest.raises(KeyError, match="unknown workload"):
        paper_lp.workload("lp_7d")


def _same(got, want):
    fields = LP_FIELDS if isinstance(got, LPBatch) else GENERAL_FIELDS
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
            continue
        assert np.array_equal(np.asarray(g), np.asarray(w),
                              equal_nan=np.asarray(w).dtype.kind == "f"), f
    if not isinstance(got, LPBatch):
        assert (got.maximize, got.row_names, got.col_names) == \
            (want.maximize, want.row_names, want.col_names)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [None, 7])
def test_build_batch_is_bit_equal(name, seed):
    rng = (lambda: None) if seed is None else \
        (lambda: np.random.default_rng(seed))
    got = paper_lp.build_batch(paper_lp.workload(name), batch=64, rng=rng())
    want = ref.build_batch(next(w for w in ref.WORKLOADS if w.name == name),
                           batch=64, rng=rng())
    assert type(got).__name__ == type(want).__name__
    assert got.batch == 64
    _same(got, want)


@pytest.mark.parametrize("name,shape", [("lp_afiro_100k", (35, 32)),
                                        ("lp_sc50b_like_50k", (72, 49))])
def test_fixture_workloads_canonicalize_to_their_shape(name, shape):
    """The shapes the solvers run at, equal to the reference's (the
    configuration's comment says 79 x 49 for sc50b_like: upper bounds as
    rows; native bounds leave 72 rows in both packages)."""
    from repro.core import canonicalize as ref_canonicalize
    w = paper_lp.workload(name)
    g = paper_lp.build_batch(w, batch=4)
    assert (g.m, g.n) == (w.m, w.n)
    lp, _ = canonicalize(g)
    want, _ = ref_canonicalize(ref.build_batch(w, batch=4))
    assert (lp.m, lp.n) == (want.m, want.n) == shape
