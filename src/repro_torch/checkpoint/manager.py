"""Fault-tolerant checkpointing: atomic, async, mesh-elastic (the
reference's ``checkpoint/manager.py``, same layout on disk).

* **Layout**: ``step_XXXXXXXX/`` holds ``manifest.json`` (the step, the
  leaf count, each leaf's path and dtype, ``extra``) and one
  ``leaf_XXXXX.npy`` a leaf.
* **Atomic**: a checkpoint is written into ``step_XXXXXXXX.tmp/``, every
  file fsynced, and renamed to ``step_XXXXXXXX/`` only then, so a killed
  job never leaves a half checkpoint that a resume would pick up.
* **Async**: ``save(..., blocking=False)`` copies the tree to the host at
  once (the device-to-host copy waits for the card) and writes it from a
  thread while training goes on; ``wait`` joins it.
* **Elastic**: checkpoints hold whole arrays.  With a ``sharder``,
  ``save`` gathers each sharded leaf (a collective: every rank calls it)
  and the world's rank 0 writes; ``restore(..., sharder=)`` cuts each
  leaf to the slice this rank holds on *its* mesh, which may differ from
  the one that saved.
* **Retention**: the newest ``keep`` checkpoints stay; ``latest_step``
  drives the train CLI's resume.  Each manager restores what the other
  saved.

A tree is nested dicts (flattened in key-sorted order, as a JAX pytree
is) and lists (in order) of tensors, NumPy arrays and Python ints; a
leaf's path is its keys joined by dots.  The train CLI's tree is
{"params": {name: tensor}, "opt": the optimizer's state}.  bfloat16
leaves are stored as their uint16 bits with the dtype named in the
manifest: NumPy has no bfloat16.  A leaf's sharding is found from its
path (``distributed.sharding.param_spec`` of the path, which ends in a
parameter's name, placed by ``Sharder.placement``; under ``opt.`` by the
ZeRO-1 placement of the optimizer moments, ``opt_state_spec``), or from
``specs``, {path: placement}, where the caller gives one (Adafactor's
statistics); other leaves are whole on every rank.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist


def flatten(tree, prefix: str = "") -> list:
    """[(path, leaf)] of a tree (module docstring)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def unflatten(like, leaves: list):
    """A tree shaped as ``like`` with ``leaves`` in ``flatten`` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)


def _to_host(leaf):
    """(NumPy array, dtype name) of a leaf: a copy, which the caller may
    go on changing the leaf beside."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    if isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int64), "int"
    a = np.array(leaf)
    return a, str(a.dtype)


def _from_host(arr: np.ndarray, dtype):
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()) \
            .view(torch.bfloat16)
    if dtype == "int":
        return int(arr)
    return torch.from_numpy(np.array(arr))


def _placement(path: str, sharder, specs=None):
    """The placement of the leaf at ``path`` (module docstring), None
    for a leaf whole on every rank."""
    from ..distributed.sharding import param_spec
    if specs is not None and path in specs:
        placement = specs[path]
    else:
        try:
            logical = param_spec(path, sharder.cfg)
        except KeyError:
            return None
        placement = sharder.placement(logical, zero=path.startswith("opt."))
    return placement if any(r is not None for r in placement) else None


def _writer() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0


def _fsync(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- paths -------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return max(steps) if steps else None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = True,
             extra: Optional[dict] = None, sharder=None,
             specs: Optional[dict] = None):
        """Snapshot ``tree`` to the host now (gathering sharded leaves
        with ``sharder``, placed as the module docstring says), then
        write it, from a thread unless ``blocking``.  Under a
        ``torch.distributed`` world only rank 0 writes."""
        self.wait()
        items = flatten(tree)
        if sharder is not None:
            items = [(p, self._gathered(p, leaf, sharder, specs))
                     for p, leaf in items]
        if not _writer():
            return
        host = [(p,) + _to_host(leaf) for p, leaf in items]

        def write():
            tmp = self._step_dir(step) + ".tmp"
            final = self._step_dir(step)
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest = {"step": step, "n_leaves": len(host),
                        "paths": [p for p, _, _ in host],
                        "dtypes": [d for _, _, d in host],
                        "extra": extra or {}}
            for i, (_, arr, _) in enumerate(host):
                name = os.path.join(tmp, f"leaf_{i:05d}.npy")
                np.save(name, arr)
                _fsync(name)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync(tmp)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)  # atomic publish
            _fsync(self.dir)
            self._gc()

        if blocking:
            write()
            return

        def run():
            try:
                write()
            except BaseException as e:   # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    @staticmethod
    def _gathered(path, leaf, sharder, specs):
        placement = _placement(path, sharder, specs)
        if placement is None or not isinstance(leaf, torch.Tensor):
            return leaf
        from ..distributed.sharding import gather_placed
        return gather_placed(leaf, placement, sharder.mesh)

    def wait(self):
        """Join the writer thread; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def restore(self, step: int, like: Any, *, sharder=None,
                device="cpu", specs: Optional[dict] = None) -> Any:
        """The tree saved at ``step``, shaped as ``like`` (its leaves'
        paths must be the saved ones); tensor leaves take the dtype of
        ``like``'s tensor at the same place and lie on ``device``.  With
        ``sharder`` each sharded leaf is cut to this rank's slice
        (placed as ``save`` places it)."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        items = flatten(like)
        paths = [p for p, _ in items]
        # a checkpoint of the reference names no paths and no dtypes
        if manifest["n_leaves"] != len(items) or \
                manifest.get("paths", paths) != paths:
            raise ValueError(
                f"checkpoint step {step} holds {manifest['n_leaves']} leaves "
                f"that differ from the {len(items)} asked for")
        dtypes = manifest.get("dtypes", [None] * len(items))
        out = []
        for i, ((path, ref), dtype) in enumerate(zip(items, dtypes)):
            leaf = _from_host(np.load(os.path.join(d, f"leaf_{i:05d}.npy")),
                              dtype)
            if isinstance(leaf, torch.Tensor):
                if sharder is not None:
                    placement = _placement(path, sharder, specs)
                    if placement is not None:
                        leaf = leaf[sharder.place_slices(placement,
                                                         leaf.shape)]
                if hasattr(ref, "dtype"):
                    leaf = leaf.to(_torch_dtype(ref.dtype))
                leaf = leaf.contiguous().to(device)
            out.append(leaf)
        return unflatten(like, out)

    def extra(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f).get("extra", {})


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype for a torch or NumPy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype)).dtype
