"""Production mesh definitions (the reference's ``launch/mesh.py``).

One pod is a 16 x 16 mesh (data=16, model=16); two pods add a leading
pure data-parallel 'pod' axis: (pod=2, data=16, model=16), 512 ranks.
Both are functions over the caller's ``torch.distributed`` world, which
must have exactly as many ranks (``make_mesh`` raises otherwise), or,
with ``abstract=True``, rank 0's view of the mesh with no world at all
(``sharding.Mesh.abstract``, the dry run's); ``join_world`` joins a
world for the train CLI's ``--mesh``.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.sharding import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         abstract: bool = False):
    """The production mesh over the world, or with ``abstract`` rank 0's
    abstract mesh (``Mesh.abstract``: its collectives record themselves
    and exchange nothing).  Rank 0 stands for every rank there: under
    the Sharder's divisibility guard every rank of the production meshes
    holds blocks of the same local shapes, and takes the same rows of
    the batch, so its step costs what any rank's does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if abstract:
        return Mesh.abstract(shape, axes, 0, device)
    return make_mesh(shape, axes, device=device)


def make_host_mesh(shape=(2, 4), axes=("data", "model"), device="cpu"):
    """A small mesh for CPU tests: a gloo world of prod(shape) ranks,
    every rank on the CPU."""
    return make_mesh(shape, axes, device=device)


def join_world(shape, device=None) -> torch.device:
    """Join the ``torch.distributed`` world a mesh of ``shape`` runs on
    and return this rank's device.  A mesh of one rank needs no world; a
    world already initialised is used as it is; otherwise the world is
    ``torchrun``'s (its ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE`` and store address in the environment).  Ranks on
    the CPU (``device="cpu"``) and ranks that share one card exchange
    over gloo; ranks that each own a card (as many cards as local ranks)
    over NCCL, rank i on card i.  Any other arrangement raises, as does
    a mesh of more than one rank with no world to join."""
    from ..core.distributed import rank_device
    size = int(np.prod(shape))
    if dist.is_available() and dist.is_initialized():
        return rank_device(device, dist.get_rank())
    if size == 1:
        return rank_device(device, 0)
    if "WORLD_SIZE" not in os.environ:
        raise ValueError(f"a mesh of {size} ranks needs a torch.distributed "
                         f"world: run under torchrun --nproc-per-node "
                         f"{size}")
    local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE",
                                    os.environ["WORLD_SIZE"]))
    if device is not None and torch.device(device).type == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    else:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("repro_torch runs on a CUDA device and none "
                               "is available; pass device='cpu' to run the "
                               "plain PyTorch engine")
        if cards >= local_size:
            backend, dev = "nccl", torch.device("cuda", local)
        elif cards == 1:
            backend, dev = "gloo", torch.device("cuda", 0)
        else:
            raise ValueError(f"{local_size} ranks on {cards} cards: ranks "
                             "share one card (gloo) or own one each (nccl)")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://")
    return dev
