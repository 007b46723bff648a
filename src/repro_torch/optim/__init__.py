"""Optimizers of the port (the reference's ``optim/``): AdamW so far."""
from .adamw import Optimizer, adamw  # noqa: F401


def get_optimizer(name: str, **kw) -> Optimizer:
    """The optimizer ``name`` built with ``kw``: "adamw"; "adafactor" is
    not ported yet."""
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        raise NotImplementedError(
            "adafactor is not ported yet (ROADMAP: the rest of the LM "
            "scaffold, optim/adafactor.py)")
    raise KeyError(name)
