"""PyTorch/CUDA port of the batched-LP solver (the JAX package ``repro`` is
its reference).

The main path is ``repro_torch.core.solve_batched(batch)``: a batch of
same-shape LPs is canonicalized, chunked against device memory and solved
by the two-phase dense-tableau simplex, on the card through the
hand-written CUDA kernel ``kernels/csrc/simplex_tile.cu``, on the CPU
(``device="cpu"``) through the plain PyTorch engine ``core/simplex.py``.
``solve_batched(batch, compaction=True)`` solves in resumable segments with
survivor gathers between them (``core/compaction.py``; on the card the
segment kernel of the same source), and ``core.solve_hyperbox`` solves box
LPs in closed form (``kernels/csrc/hyperbox.cu``).
The package imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``repro``.
"""
from .device import resolve_device  # noqa: F401
