"""Device resolution for the port's entry points.

Every public entry point runs on CUDA unless the caller passes
``device="cpu"``; without a card and without an explicit device it raises
instead of quietly running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device, or raise when there is none;
    anything else is passed to ``torch.device`` and checked the same way."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch engine")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def is_fake(t) -> bool:
    """Whether ``t`` has shape, dtype and device but no data: a tensor on
    the meta device, on which the dry run builds its cells
    (``launch/cells.py``).  Where the port branches on the device, such an
    input takes the card's branch, so that the dry run reckons the card's
    program; a kernel wrapper given one charges its launch to the cost
    counter tracing the step (``analysis/op_cost.py`` ``charge``) and
    refuses it when none is."""
    return t.is_meta


def on_card(t) -> bool:
    """``t.is_cuda``, or a tensor with no data (``is_fake``)."""
    return t.is_cuda or is_fake(t)
