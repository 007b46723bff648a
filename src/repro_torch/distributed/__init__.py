"""The train, prefill and decode steps of the port (the one-device part
of the reference's ``distributed/``; sharding over ``torch.distributed``
is ROADMAP work)."""
from .steps import (global_norm, make_decode_step,  # noqa: F401
                    make_prefill_step, make_train_step)
