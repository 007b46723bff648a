"""Optimizers of the port (the reference's ``optim/``): AdamW and
Adafactor."""
from .adafactor import adafactor  # noqa: F401
from .adamw import Optimizer, adamw  # noqa: F401


def get_optimizer(name: str, **kw) -> Optimizer:
    """The optimizer ``name`` ("adamw" or "adafactor") built with
    ``kw``."""
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise KeyError(name)
