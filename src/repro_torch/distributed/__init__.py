"""The train step of the port (the one-device part of the reference's
``distributed/``; sharding over ``torch.distributed`` is ROADMAP work)."""
from .steps import global_norm, make_train_step  # noqa: F401
