"""Atomic, asynchronous, mesh-elastic checkpoints (the reference's
``checkpoint/``)."""
from .manager import CheckpointManager  # noqa: F401
