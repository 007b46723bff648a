"""Carry problems and results across the two packages.

The system has no model weights: its state is the batch data and the
solver's results.  ``batch_from_reference`` turns a reference ``LPBatch`` or
``GeneralLPBatch`` into the port's, and ``result_arrays`` turns either
package's ``LPResult`` into a dict of NumPy arrays, so one input can be fed
to both packages and their outputs compared field by field.  Both read
attributes only; nothing here imports the reference package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .core.forms import GeneralLPBatch
from .core.lp import LPBatch

RESULT_FIELDS = ("x", "objective", "status", "iterations", "y", "z")


def batch_from_reference(obj):
    """The port's ``GeneralLPBatch`` (when ``obj`` has row senses) or
    ``LPBatch`` with the same data."""
    if hasattr(obj, "sense"):
        kw = {f.name: getattr(obj, f.name)
              for f in dataclasses.fields(GeneralLPBatch)}
        return GeneralLPBatch(**kw)
    ub = getattr(obj, "ub", None)
    return LPBatch(A=np.asarray(obj.A), b=np.asarray(obj.b),
                   c=np.asarray(obj.c),
                   ub=None if ub is None else np.asarray(ub))


def result_arrays(res) -> dict:
    """``{field: numpy array or None}`` for the per-LP result fields."""
    return {f: None if getattr(res, f, None) is None
            else np.asarray(getattr(res, f)) for f in RESULT_FIELDS}
