"""The port's distributed layer: the train, prefill and decode steps
(one device or a mesh), the mesh and the sharding rules
(``sharding.py``), and int8 gradient compression (``compression.py``)."""
from .steps import (global_norm, make_decode_step,  # noqa: F401
                    make_prefill_step, make_train_step)
