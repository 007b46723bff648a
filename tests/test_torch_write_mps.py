"""The port's ``write_mps`` against the reference's.

For every fixture, and for instances that exercise the writer's branches
(an empty column, scattered integer markers, ranges, every bound kind and
an objective constant), the file the port writes is byte-equal to the
file ``repro.io.mps.write_mps`` writes from the same instance, and
``read_mps`` of it reproduces the instance bit for bit (at ``%.12g``,
integer markers included).  A batch is rejected, as in the reference.
"""
import numpy as np
import pytest

from repro.core import GeneralLPBatch as RefGeneralLPBatch
from repro.io.mps import read_mps as ref_read_mps
from repro.io.mps import write_mps as ref_write_mps
from repro_torch.core import GeneralLPBatch
from repro_torch.io import (FIXTURE_NAMES, MIP_FIXTURE_NAMES, fixture_path,
                            perturbed_batch, read_mps, write_mps)

FIELDS = ("A", "rhs", "c", "c0", "lb", "ub", "sense")


def _equal(g, g2):
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(g, f)),
                              np.asarray(getattr(g2, f))), f
    assert g.maximize == g2.maximize
    if g.ranges is None:
        assert g2.ranges is None or not np.isfinite(g2.ranges).any()
    else:   # a row without a range reads back as NaN
        assert np.array_equal(np.where(np.isfinite(g.ranges), g.ranges, -1),
                              np.where(np.isfinite(g2.ranges), g2.ranges, -1))
    assert tuple(g.row_names) == tuple(g2.row_names)
    assert tuple(g.col_names) == tuple(g2.col_names)
    if g.integer is None:
        assert g2.integer is None
    else:
        assert np.array_equal(g.integer, g2.integer)


def _branchy(cls):
    """One instance through every branch of the writer: a maximization
    with an objective constant, an empty zero-cost column, L/G/E rows, a
    range, and FX, FR, MI, LO, UP and default bounds."""
    inf = np.inf
    return cls.from_arrays(
        A=[[[1.0, 0.0, 2.5, -1.0, 0.0, 3.0],
            [0.0, 0.0, 1.0, 1.0, 4.0, 0.0],
            [2.0, 0.0, 0.0, 0.0, 1.0, 1.0]]],
        sense=["L", "G", "E"], rhs=[[4.0, -2.0, 0.0]],
        lb=[[0.0, 0.0, 1.5, -inf, -inf, 2.0]],
        ub=[[inf, inf, 1.5, inf, 7.25, 9.0]],
        c=[[1.0, 0.0, -2.0, 0.5, 1e-7, 123456.789]], c0=[3.25],
        maximize=True, ranges=[np.inf, 5.0, np.inf], name="BRANCHY",
        row_names=["R1", "R2", "R3"],
        col_names=["X", "ZERO", "FIX", "FREE", "MINUS", "BOX"],
        integer=[False, False, True, False, True, True])


def _cases():
    return [(name, lambda name=name: (read_mps(fixture_path(name)),
                                      ref_read_mps(fixture_path(name))))
            for name in FIXTURE_NAMES + MIP_FIXTURE_NAMES] + [
        ("branchy", lambda: (_branchy(GeneralLPBatch),
                             _branchy(RefGeneralLPBatch)))]


@pytest.mark.parametrize("name,make", _cases(), ids=[c[0] for c in _cases()])
def test_file_is_byte_equal_and_reads_back(tmp_path, name, make):
    g, g_ref = make()
    ours, theirs = tmp_path / "port.mps", tmp_path / "ref.mps"
    write_mps(g, str(ours))
    ref_write_mps(g_ref, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    g2 = read_mps(str(ours))
    _equal(g, g2)


def test_scattered_integer_markers_round_trip(tmp_path):
    src = open(fixture_path("testprob")).read()
    marked = src.replace(
        "    X2        COST",
        "    MARKER                 'MARKER'                 'INTORG'\n"
        "    X2        COST").replace(
        "    X3        COST",
        "    MARKER                 'MARKER'                 'INTEND'\n"
        "    X3        COST")
    p = tmp_path / "scattered.mps"
    p.write_text(marked)
    g = read_mps(str(p))
    assert list(g.integer) == [False, True, False]
    ours, theirs = tmp_path / "rt.mps", tmp_path / "rt_ref.mps"
    write_mps(g, str(ours))
    ref_write_mps(ref_read_mps(str(p)), str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    _equal(g, read_mps(str(ours)))


def test_a_batch_is_rejected(tmp_path):
    g = read_mps(fixture_path("testprob"))
    with pytest.raises(ValueError, match="one instance"):
        write_mps(perturbed_batch(g, 4), str(tmp_path / "nope.mps"))
    assert not (tmp_path / "nope.mps").exists()
