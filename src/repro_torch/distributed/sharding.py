"""Logical-axis sharding rules and the mesh over a ``torch.distributed``
world (the reference's ``distributed/sharding.py``).

Parameters carry *logical* axis tuples (``param_spec``); the ``Sharder``
resolves them against a mesh with the reference's rules, word for word:

    batch     -> ('pod','data')  (pod axis is pure DP when present)
    vocab/ff/heads/experts/d_inner -> 'model'   (tensor/expert parallel)
    residual  -> 'data' iff FSDP (2-D sharded params for the giant archs)
    seq_sp    -> 'model' iff sequence-parallel residual stream
    kv_heads  -> 'model' only when the arch's KV-head projection divides tp
    heads     -> 'model' only when H divides tp (else replicated attention)
    kv_seq    -> 'model' when the decode cache is sequence-sharded

``spec``, ``pspec``, ``opt_state_spec`` and ``act_spec`` report the
reference's placement, as tuples of mesh axes (a PartitionSpec is a
tuple).  The port executes every rule the reference resolves for a
parameter (``EXECUTED``): each rank holds only its block of each leaf
(``local_slices``, the reference's ``NamedSharding`` shard of the same
device index) and computes on it:

* ``batch``: data parallel, each rank its rows of the global batch, the
  gradients summed over the data group (``distributed/steps.py``);
* ``heads``, ``kv_heads``, ``ff``, ``ff_expert``, ``d_inner``: tensor
  parallel over the model line, the Megatron pair around each
  column-parallel product and its row-parallel partner
  (``EnterReplicated``: identity forward, the cotangent summed over the
  line backward; ``ReduceOver``: the partial products summed forward,
  identity backward);
* ``vocab``: the embedding's rows and the head's columns over the model
  line, a masked lookup summed over the line and a vocabulary-parallel
  cross entropy (``models/layers.py``), the whole logits never gathered;
* ``experts``: expert parallel, each rank its ``E / tp`` slabs of the
  MoE weights, tokens exchanged over the model group by two all-to-alls
  (``models/moe.py``);
* ``residual`` where ``fsdp`` resolves it to the data axis: FSDP, each
  leaf gathered over the data line before use (``GatherLeaf``) and its
  gradient reduce-scattered back;
* ``seq_sp``: the MoE layer routes this rank's slice of the sequence and
  gathers its output back.

ZeRO-1 (``opt_state_spec``): the optimizer moments shard ``residual``
over ``data`` even where the parameters do not (``zero_axis``).  A dim
whose size does not divide its axis stays whole, the reference's
divisibility guard.  What stays reported only: ``kv_seq`` (a sharded
decode cache; serving has no mesh) and ``seq_sp`` on the residual
stream outside the MoE layer (the activations stay whole on every rank
of the model line).

A ``Mesh`` is the reference's ``jax.sharding.Mesh`` description
(``.shape`` an ordered {axis: size}, ``.axis_names``) over the ranks of
a world in row-major order, as ``np.asarray(devices).reshape(shape)``
lays them out.  ``make_mesh`` builds one process group for each line of
each axis, and for the data-parallel axes together; a ``Mesh`` made
directly has no groups and serves the rules alone.  Collectives travel
as host tensors over gloo (ranks that share one card) or as device
tensors over NCCL (a card a rank); any other backend raises, and a mesh
whose size is not the world's raises.  ``Mesh.abstract`` is the
counterpart of the reference's placeholder host devices: a mesh of any
shape, seen from one rank, whose collectives record their kind, count
and bytes and return zeros (the dry run's, ``launch/dryrun.py``).

Replicas agree bit for bit: the ranks of a model line compute each
replicated leaf's gradient on their own, from the same inputs, so a mesh
of several ranks on cards turns on PyTorch's deterministic algorithms
(no atomics-ordered sums, as the embedding's backward would otherwise
take) and cuBLAS's fixed workspace; ``distributed/steps.py``
``check_replicas`` holds the replicas to it.
"""
from __future__ import annotations

import os
import time
from typing import TYPE_CHECKING, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

if TYPE_CHECKING:   # models/moe.py imports this module
    from ..models.config import ModelConfig

# the logical axes the port executes sharded (module docstring); the
# batch rule is the data-parallel step's, outside the parameters
EXECUTED = ("heads", "kv_heads", "ff", "ff_expert", "d_inner", "vocab",
            "experts", "residual")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Axis:
    """One line of a mesh: the ranks that differ only along ``names``,
    with this rank's index on it and the collectives over it.  A line of
    one rank makes no collective.  ``seconds`` adds up the host's wall
    time in the collectives, copies to and from the host included;
    ``kinds`` their count and bytes by kind, the bytes of one collective
    the larger of its operand and its result (the rule of the
    reference's ``analysis/hlo.py``).

    An ``abstract`` line (``Mesh.abstract``) has no process group: each
    collective records itself as a real one does and returns zeros of
    its result's shape, dtype and device, exchanging nothing."""

    def __init__(self, names: Tuple[str, ...], size: int, index: int,
                 group=None, via: Optional[torch.device] = None,
                 abstract: bool = False):
        self.names, self.size, self.index = names, size, index
        self.group, self.via = group, via
        self.abstract = abstract
        self.seconds, self.calls = 0.0, 0
        self.kinds: Dict[str, dict] = {}

    def _record(self, kind: str, nbytes: int):
        k = self.kinds.setdefault(kind, {"count": 0, "bytes": 0})
        k["count"] += 1
        k["bytes"] += nbytes

    def _run(self, t: torch.Tensor, fn, kind: str, out_shape) -> torch.Tensor:
        """fn on ``t`` moved to the exchange's device; its result, a
        tensor or a list of them to concatenate along the dim it names,
        back on ``t``'s device.  On an abstract line, zeros of
        ``out_shape`` on ``t``'s device."""
        self._record(kind, max(_nbytes(t), int(np.prod(out_shape)) *
                               t.element_size()))
        self.calls += 1
        if self.abstract:
            return t.new_zeros(out_shape)
        t0 = time.perf_counter()
        src = t.to(self.via).contiguous()
        out = fn(src)
        if isinstance(out, tuple):   # (parts, dim): joined on t's device
            out = torch.cat([o.to(t.device) for o in out[0]], dim=out[1])
        else:
            out = out.to(t.device)
        self.seconds += time.perf_counter() - t0
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Block j of axis 0 goes to rank j of the line; block j of the
        result came from rank j (``jax.lax.all_to_all`` with
        split_axis = concat_axis = 0, untiled)."""
        if self.size == 1:
            return t

        def fn(src):
            out = torch.empty_like(src)
            dist.all_to_all_single(out, src, group=self.group)
            return out
        return self._run(t, fn, "all_to_all", t.shape)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
        line order."""
        if self.size == 1:
            return t

        def fn(src):
            parts = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(parts, src, group=self.group)
            return parts, dim
        shape = list(t.shape)
        shape[dim] *= self.size
        return self._run(t, fn, "all_gather", shape)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """The sum (or ``op``) of every rank's ``t`` over the line, on
        every rank."""
        if self.size == 1:
            return t

        def fn(src):
            src = src.clone() if src.data_ptr() == t.data_ptr() else src
            dist.all_reduce(src, op=op, group=self.group)
            return src
        return self._run(t, fn, "all_reduce", t.shape)

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` of the sum of every rank's
        ``t`` over the line: block j of every rank sent to rank j by one
        all-to-all (gloo has no reduce-scatter), then summed in line
        order on ``t``'s device."""
        if self.size == 1:
            return t
        n = t.shape[dim] // self.size
        blocks = t.unflatten(dim, (self.size, n)).movedim(dim, 0)

        def fn(src):
            out = torch.empty_like(src)
            dist.all_to_all_single(out, src, group=self.group)
            return out
        if self.abstract:
            shape = list(t.shape)
            shape[dim] = n
            return self._run(t, fn, "reduce_scatter", shape)
        return self._run(blocks.contiguous(), fn, "reduce_scatter",
                         blocks.shape).sum(0)


class Mesh:
    """A mesh of ``prod(shape)`` ranks with named axes (module
    docstring).  ``rank`` places this process; ``axes`` are the
    collective lines ``make_mesh`` built (none for a description).
    ``Mesh.abstract`` makes one whose lines exchange nothing."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 rank: int = 0, axes: Optional[Dict] = None,
                 device: Optional[torch.device] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             "differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = int(np.prod(shape)) if len(shape) else 1
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in
                                np.unravel_index(rank, tuple(shape)))))
        self._axes = axes
        self.device = device
        self.is_abstract = False

    @classmethod
    def abstract(cls, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 rank: int = 0, device=None) -> "Mesh":
        """A mesh of any shape with no ``torch.distributed`` world: every
        line through ``rank`` is an abstract ``Axis`` (made when first
        asked for), whose collectives record their kind, count and bytes
        and return zeros.  The dry run (``launch/dryrun.py``) traces one
        rank's share of a step over one."""
        mesh = cls(shape, axis_names, rank, {}, device)
        mesh.is_abstract = True
        return mesh

    def axis(self, names) -> Axis:
        """The line through this rank along ``names`` (an axis name or a
        tuple of them); a line of one rank when their sizes multiply to
        one.  Raises on a description made without a world."""
        names = (names,) if isinstance(names, str) else tuple(names)
        size = int(np.prod([self.shape[a] for a in names]))
        if size == 1:
            return Axis(names, 1, 0)
        if self.is_abstract and names not in self._axes:
            index = int(np.ravel_multi_index(
                tuple(self.coords[a] for a in names),
                tuple(self.shape[a] for a in names)))
            self._axes[names] = Axis(names, size, index, abstract=True)
        if self._axes is None or names not in self._axes:
            raise ValueError(f"mesh axes {names}: this mesh has no process "
                             "groups (make it with make_mesh over an "
                             "initialised world)")
        return self._axes[names]

    def exchanges(self) -> dict:
        """The collectives every line of this rank made: their count,
        the host seconds they took, and by kind their count and bytes
        (``kinds``: {kind: {"count", "bytes"}})."""
        lines = (self._axes or {}).values()
        kinds = {}
        for a in lines:
            for kind, k in a.kinds.items():
                got = kinds.setdefault(kind, {"count": 0, "bytes": 0})
                got["count"] += k["count"]
                got["bytes"] += k["bytes"]
        return {"calls": sum(a.calls for a in lines),
                "seconds": sum(a.seconds for a in lines), "kinds": kinds}


def _line_ranks(shape, names, axis_names, fixed):
    """The world ranks of the line along ``names`` through the
    coordinates ``fixed`` of the other axes, in line order."""
    idx = [range(shape[i]) if a in names else [fixed[a]]
           for i, a in enumerate(axis_names)]
    grid = np.stack(np.meshgrid(*idx, indexing="ij"), -1).reshape(
        -1, len(shape))
    return [int(np.ravel_multi_index(tuple(c), tuple(shape))) for c in grid]


def _via(backend: str, device: torch.device) -> torch.device:
    if backend == "gloo":
        return torch.device("cpu")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"the nccl backend needs each rank on a card, "
                             f"not on {device}")
        return device
    raise ValueError(f"collectives over {backend!r}: the mesh exchanges over "
                     "gloo (host tensors) or nccl (device tensors)")


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device=None) -> Mesh:
    """The mesh ``shape`` with axis names ``axes`` over the initialised
    ``torch.distributed`` world (every rank calls it, in the same order),
    its process groups built; ``device`` is this rank's (default
    ``cuda:(rank % device_count)``, raising without a card).  A mesh of
    one rank needs no world.  Raises unless the mesh's size is the
    world's.  A mesh of several ranks on cards turns on deterministic
    algorithms for the whole process (module docstring): call it before
    the process's first matrix product on the card."""
    from ..core.distributed import rank_device
    shape = tuple(int(s) for s in shape)
    size = int(np.prod(shape)) if shape else 1
    if not (dist.is_available() and dist.is_initialized()):
        if size != 1:
            raise ValueError(f"a mesh of {size} ranks needs an initialised "
                             "torch.distributed world of as many")
        return Mesh(shape, axes, 0, {}, rank_device(device, 0))
    world = dist.get_world_size()
    if size != world:
        raise ValueError(f"mesh {shape} has {size} ranks, the world {world}")
    rank = dist.get_rank()
    dev = rank_device(device, rank)
    via = _via(dist.get_backend(), dev)
    if dev.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
    lines = [(a,) for a in axes]
    dp = tuple(a for a in ("pod", "data") if a in axes)
    if len(dp) > 1:
        lines.append(dp)
    built = {}
    for names in lines:
        others = [a for a in axes if a not in names]
        n = int(np.prod([shape[axes.index(a)] for a in names]))
        # every rank creates every group of the line family, in one order
        for fixed in np.ndindex(*[shape[axes.index(a)] for a in others]):
            ranks = _line_ranks(shape, names, axes, dict(zip(others, fixed)))
            group = dist.new_group(ranks) if n > 1 else None
            if rank in ranks:
                built[names] = Axis(names, n, ranks.index(rank), group, via)
    return Mesh(shape, axes, rank, built, dev)


# ---------------------------------------------------------------------------
# logical specs of the port's parameters (the reference's init specs)
# ---------------------------------------------------------------------------

_LEAF_SPECS = {
    ("embed", "table"): ("vocab", "residual"),
    ("head", "w"): ("residual", "vocab"),
    ("attn", "wq"): ("residual", "heads"),
    ("attn", "wk"): ("residual", "kv_heads"),
    ("attn", "wv"): ("residual", "kv_heads"),
    ("attn", "wo"): ("heads", "residual"),
    ("attn", "q_scale"): (None,),
    ("attn", "k_scale"): (None,),
    ("attn", "wq_a"): ("residual", None),
    ("attn", "wkv_a"): ("residual", None),
    ("attn", "wq_b"): (None, "heads"),
    ("attn", "wkv_b"): (None, "heads"),
    ("xattn", "wq"): ("residual", "heads"),
    ("xattn", "wk"): ("residual", "heads"),
    ("xattn", "wv"): ("residual", "heads"),
    ("xattn", "wo"): ("heads", "residual"),
    ("mlp", "w_gate"): ("residual", "ff"),
    ("mlp", "w_up"): ("residual", "ff"),
    ("mlp", "w_in"): ("residual", "ff"),
    ("mlp", "w_down"): ("ff", "residual"),
    ("ssm", "w_in"): ("residual", "d_inner"),
    ("ssm", "conv_w"): (None, "d_inner"),
    ("ssm", "conv_b"): ("d_inner",),
    ("ssm", "w_x"): ("d_inner", None),
    ("ssm", "w_dt"): (None, "d_inner"),
    ("ssm", "dt_bias"): ("d_inner",),
    ("ssm", "A_log"): ("d_inner", None),
    ("ssm", "D"): ("d_inner",),
    ("ssm", "w_out"): ("d_inner", "residual"),
}

_MOE_SPECS = {
    "router": ("residual", None),
    "w_gate": ("experts", "residual", None),
    "w_up": ("experts", "residual", None),
    "w_down": ("experts", None, "residual"),
    "ws_gate": ("residual", "ff_expert"),
    "ws_up": ("residual", "ff_expert"),
    "ws_down": ("ff_expert", "residual"),
}


def param_spec(name: str, cfg: ModelConfig) -> Tuple:
    """The logical axes of the port's parameter ``name`` (a dotted name
    of ``named_parameters()``, or any path that ends in one) under
    ``cfg``: the reference's init spec for the same leaf, without the
    stacked ``layers`` axis, since the port keeps one tensor a layer.
    Norm scales and biases are ``(None,)``."""
    parts = name.split(".")
    leaf = parts[-1]
    group = parts[-2] if len(parts) > 1 else ""
    if group == "mlp" and cfg.mlp_kind == "moe":
        return _MOE_SPECS[leaf]
    if (group, leaf) in _LEAF_SPECS:
        return _LEAF_SPECS[(group, leaf)]
    if leaf in ("scale", "bias"):
        return (None,)
    if leaf == "pos_table":     # a top-level parameter of EncDecLM
        return (None, "residual")
    raise KeyError(f"no logical spec for parameter {name!r}")


def param_specs(model) -> Dict[str, Tuple]:
    """{name: logical axes} of every parameter of ``model``."""
    return {n: param_spec(n, model.cfg) for n, _ in model.named_parameters()}


# ---------------------------------------------------------------------------
# the Sharder
# ---------------------------------------------------------------------------

def _entry(r):
    """A spec entry as a PartitionSpec holds it: one axis in a tuple is
    the axis's name."""
    return r[0] if isinstance(r, tuple) and len(r) == 1 else r


class Sharder:
    """Resolves logical axis names for one (cfg, mesh) pair."""

    def __init__(self, cfg: ModelConfig, mesh: Optional[Mesh]):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is None:
            self.tp = 1
            self.tp_axis = None
            self.dp_axes = ()
            self.rules = {}
            return
        names = mesh.axis_names
        self.tp = mesh.shape["model"] if "model" in names else 1
        self.tp_axis = "model" if "model" in names else None
        self.dp_axes = tuple(a for a in ("pod", "data") if a in names)

        n_heads = cfg.n_heads_padded or cfg.n_heads
        n_kv = cfg.n_kv_heads_padded or cfg.n_kv_heads
        heads_ok = n_heads > 0 and n_heads % self.tp == 0
        kv_ok = n_kv > 0 and n_kv % self.tp == 0
        ff_ok = cfg.d_ff > 0 and cfg.d_ff % self.tp == 0
        ffe_ok = cfg.d_ff_expert > 0 and cfg.d_ff_expert % self.tp == 0
        exp_ok = cfg.n_experts > 0 and cfg.n_experts % self.tp == 0
        din_ok = cfg.d_inner > 0 and cfg.d_inner % self.tp == 0
        fsdp = cfg.fsdp and "data" in names and \
            cfg.d_model % mesh.shape["data"] == 0

        self.rules = {
            "layers": None,
            "batch": self.dp_axes or None,
            "vocab": "model",
            "residual": "data" if fsdp else None,
            "ff": "model" if ff_ok else None,
            "ff_expert": "model" if ffe_ok else None,
            "heads": "model" if heads_ok else None,
            "kv_heads": "model" if kv_ok else None,
            "experts": "model" if exp_ok else None,
            "d_inner": "model" if din_ok else None,
            "seq_sp": "model" if cfg.seq_shard else None,
            "kv_seq": None if kv_ok else "model",
            "expert_local": None,  # inside-shard_map expert dim
        }
        # vocab divisibility (padded vocab is a multiple of 128; 128 % tp
        # == 0 for tp in {1,2,4,8,16,...,128})
        if cfg.vocab_padded % self.tp != 0:
            self.rules["vocab"] = None

    # -- params -----------------------------------------------------------
    def spec(self, logical: Tuple) -> Tuple:
        if self.mesh is None:
            return ()
        return tuple(_entry(self.rules.get(ax)) if ax is not None else None
                     for ax in logical)

    def opt_state_spec(self, logical: Tuple) -> Tuple:
        """ZeRO-1: optimizer moments additionally shard 'residual' over
        'data' even when the params themselves don't (fsdp off)."""
        if self.mesh is None:
            return ()
        axes = []
        used = set(a for a in (self.rules.get(ax) for ax in logical) if a)
        for ax in logical:
            r = self.rules.get(ax) if ax is not None else None
            if r is None and ax == "residual" and "data" not in used \
                    and "data" in self.mesh.axis_names:
                axes.append("data")
                used.add("data")
            else:
                axes.append(_entry(r))
        return tuple(axes)

    def _axis_size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return int(np.prod([self.mesh.shape[a] for a in axes]))

    def pspec(self, *logical) -> Tuple:
        return self.spec(logical)

    # -- activations --------------------------------------------------------
    def act_spec(self, shape, *logical) -> Tuple:
        """The reference's ``act`` placement for an activation of
        ``shape``, guarded: a dim is only sharded when its size divides
        the axis size (e.g. seq=1 at decode never shards)."""
        if self.mesh is None:
            return ()
        entries = []
        for dim, ax in enumerate(logical):
            r = self.rules.get(ax) if ax is not None else None
            if r is not None and shape[dim] % self._axis_size(r) != 0:
                r = None
            entries.append(_entry(r))
        return tuple(entries)

    # -- what the port executes -------------------------------------------
    def experts_sharded(self) -> bool:
        """Whether the MoE experts are sharded: ``experts`` resolves to
        'model' and tp > 1."""
        return self.mesh is not None and self.tp > 1 and \
            self.rules.get("experts") is not None

    def expert_axis(self) -> Optional[Axis]:
        """The model line the MoE layer exchanges tokens over when its
        experts are sharded, else None."""
        return self.mesh.axis("model") if self.experts_sharded() else None

    def data_axis(self) -> Axis:
        """The data-parallel line (the ``batch`` rule's axes)."""
        if self.mesh is None or not self.dp_axes:
            return Axis((), 1, 0)
        return self.mesh.axis(self.dp_axes)

    def model_axis(self) -> Axis:
        if self.mesh is None or self.tp_axis is None:
            return Axis((), 1, 0)
        return self.mesh.axis(self.tp_axis)

    def zero_axis(self) -> Optional[str]:
        """The mesh axis ZeRO-1 adds to a moment's ``residual`` dim where
        the parameter's is whole ('data', guarded as the reference's
        ``_guarded_sharding_opt``: d_model divides it), else None."""
        if self.mesh is None or "data" not in self.mesh.axis_names or \
                self.mesh.shape["data"] == 1:
            return None
        return "data" if self.cfg.d_model % self.mesh.shape["data"] == 0 \
            else None

    def placement(self, logical: Tuple, shape=None,
                  zero: bool = False) -> Tuple:
        """The mesh axes each dim of a leaf with logical axes ``logical``
        is executed sharded over (an axis name, a tuple of them, or None):
        the ``EXECUTED`` rules, a dim of ``shape`` that its axes do not
        divide left whole (the reference's guard), and with ``zero`` the
        optimizer moments' placement (``opt_state_spec``, ZeRO-1)."""
        if self.mesh is None:
            return (None,) * len(logical)
        out = []
        for dim, ax in enumerate(logical):
            r = self.rules.get(ax) if ax in EXECUTED else None
            if r is not None and self._axis_size(r) == 1:
                r = None
            if r is not None and shape is not None and \
                    shape[dim] % self._axis_size(r):
                r = None
            out.append(r)
        if zero and "residual" in logical and \
                "data" not in [a for r in out if r for a in _names(r)]:
            z = self.zero_axis()
            dim = logical.index("residual")
            if z is not None and out[dim] is None and (
                    shape is None or shape[dim] % self._axis_size(z) == 0):
                out[dim] = z
        return tuple(out)

    def shard_axes(self, logical: Tuple, zero: bool = False) -> frozenset:
        """The mesh axes (of more than one rank) that shard a leaf."""
        return frozenset(a for r in self.placement(logical, zero=zero)
                         if r for a in _names(r))

    def line(self, ax: str) -> Axis:
        """The mesh line a logical axis is executed sharded over (a line
        of one rank where it is not)."""
        r = self.placement((ax,))[0]
        return Axis((), 1, 0) if r is None else self.mesh.axis(r)

    def zero_dim(self, logical: Tuple) -> Optional[Tuple[int, Axis]]:
        """(dim, line) of the moment's ZeRO-1 cut of a leaf whose
        parameter leaves that dim whole, else None."""
        have = self.placement(logical)
        want = self.placement(logical, zero=True)
        for dim, (h, w) in enumerate(zip(have, want)):
            if h != w:
                return dim, self.mesh.axis(w)
        return None

    def place_slices(self, placement, shape) -> Tuple[slice, ...]:
        """This rank's slice of a whole array of ``shape`` placed by
        ``placement`` (``placement``'s result)."""
        out = []
        for dim, r in enumerate(placement):
            if r is None:
                out.append(slice(None))
                continue
            names = _names(r)
            n = self._axis_size(r)
            idx = int(np.ravel_multi_index(
                tuple(self.mesh.coords[a] for a in names),
                tuple(self.mesh.shape[a] for a in names)))
            step = shape[dim] // n
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def local_slices(self, logical: Tuple, shape,
                     zero: bool = False) -> Tuple[slice, ...]:
        """This rank's slice of a whole array of ``shape`` with logical
        axes ``logical`` (``placement``): each sharded dim cut into equal
        blocks by the rank's coordinate, every other dim whole."""
        return self.place_slices(self.placement(logical, shape, zero),
                                 shape)

    def is_sharded(self, logical: Tuple) -> bool:
        return bool(self.shard_axes(logical))

    def param_shardings(self, spec_tree: Dict[str, Tuple],
                        shapes: Dict[str, Tuple]) -> Dict[str, Tuple]:
        """{name: this rank's slices} for a {name: logical axes} tree of
        whole arrays of ``shapes``."""
        return {k: self.local_slices(s, shapes[k])
                for k, s in spec_tree.items()}

    def model_summed(self, name: str) -> bool:
        """Whether the gradient of parameter ``name``, replicated over
        the model line, is a partial sum there: the MoE router under
        expert parallelism, which sees only this rank's tokens (or,
        without ``seq_sp``, its 1/tp share of the cotangent); the
        qk-norm scales under sharded heads, and GQA's K and V
        projections where the heads are sharded and the KV heads are
        not, which see only the heads this rank computes."""
        group, leaf = ([""] + name.split("."))[-2:]
        if self.experts_sharded() and (group, leaf) == ("mlp", "router"):
            return True
        heads, kv = self.placement(("heads", "kv_heads"))
        if group != "attn" or heads is None:
            return False
        if leaf in ("q_scale", "k_scale"):
            return True
        return leaf in ("wk", "wv") and kv is None and \
            self.cfg.attn_kind != "mla"

    def gathered(self, p, group: str) -> dict:
        """The leaves of the parameter group ``p`` (a ``ParameterDict``
        of the group ``group``: "attn", "mlp", ...) ready for use: each
        leaf FSDP shards over the data line gathered (``GatherLeaf``,
        its gradient reduce-scattered back); ``p`` itself where none
        is."""
        axis = self.line("residual")
        if axis.size == 1:
            return p
        out = {}
        for k, v in p.items():
            out[k] = v
            if isinstance(v, torch.Tensor):
                spec = param_spec(f"{group}.{k}", self.cfg)
                if "residual" in spec:
                    out[k] = GatherLeaf.apply(v, axis, spec.index("residual"))
        return out


def _names(r) -> Tuple[str, ...]:
    return (r,) if isinstance(r, str) else tuple(r)


def line(shd: Optional[Sharder], ax: str) -> Axis:
    """``shd.line(ax)``, a line of one rank without a sharder."""
    return Axis((), 1, 0) if shd is None else shd.line(ax)


def gathered(shd: Optional[Sharder], p, group: str):
    """``shd.gathered(p, group)``, ``p`` itself without a sharder."""
    return p if shd is None else shd.gathered(p, group)


def gather_placed(t: torch.Tensor, placement: Tuple, mesh: Mesh
                  ) -> torch.Tensor:
    """The whole array of a leaf whose block this rank holds under
    ``placement`` (``Sharder.placement``), gathered over its lines (a
    collective: every rank calls it, in the same order)."""
    for dim, r in enumerate(placement):
        if r is not None:
            t = mesh.axis(r).all_gather(t.detach().contiguous(), dim)
    return t


def shard_params(tree: Dict[str, torch.Tensor], sharder: Sharder,
                 specs: Optional[Dict[str, Tuple]] = None) -> Dict:
    """{name: this rank's slice} of a {name: whole array} tree; ``specs``
    defaults to ``param_spec`` of each name."""
    specs = specs or {k: param_spec(k, sharder.cfg) for k in tree}
    slices = sharder.param_shardings(specs, {k: v.shape
                                             for k, v in tree.items()})
    return {k: v[slices[k]] for k, v in tree.items()}


def gather_params(tree: Dict[str, torch.Tensor], sharder: Sharder,
                  specs: Optional[Dict[str, Tuple]] = None) -> Dict:
    """The whole arrays of a {name: this rank's slice} tree, gathered
    over the executed axes (a collective: every rank calls it, with the
    same names in the same order)."""
    specs = specs or {k: param_spec(k, sharder.cfg) for k in tree}
    return {k: gather_placed(v, sharder.placement(specs[k]), sharder.mesh)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the exchanges as autograd functions
# ---------------------------------------------------------------------------

class AllToAll(torch.autograd.Function):
    """``Axis.all_to_all``; its backward is the inverse exchange, the
    same all-to-all of the cotangent."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_to_all(g), None


class GatherSeq(torch.autograd.Function):
    """Every rank's sequence slice (B, S / n, ...) gathered to (B, S,
    ...); the backward takes this rank's slice of the cotangent (every
    rank holds the whole one), without a sum."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.n = axis, x.shape[1]
        return axis.all_gather(x, 1)

    @staticmethod
    def backward(ctx, g):
        i, n = ctx.axis.index, ctx.n
        return g[:, i * n:(i + 1) * n].contiguous(), None


class ScatterSeq(torch.autograd.Function):
    """This rank's slice of the sequence of a replicated (B, S, ...);
    the backward gathers the slices' cotangents, so every rank holds the
    whole one."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        n = x.shape[1] // axis.size
        return x[:, axis.index * n:(axis.index + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_gather(g.contiguous(), 1), None


class EnterReplicated(torch.autograd.Function):
    """Identity into a region every rank of the line runs on the same
    tokens; the backward sums the ranks' partial cotangents (the
    reference's psum of an input not sharded over the axis)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g), None


class LeaveReplicated(torch.autograd.Function):
    """Identity out of that region: every rank holds the same output, so
    each takes 1/size of its cotangent (the reference's shard_map divides
    the cotangent of an output replicated over an axis by its size)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.axis.size, None


class ReduceOver(torch.autograd.Function):
    """The row-parallel exit: the ranks' partial products summed over
    the line forward; the backward passes the (replicated, whole)
    cotangent to each partial product unchanged."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherLeaf(torch.autograd.Function):
    """Every rank's block of ``dim`` gathered in line order (FSDP's
    gather of a leaf before use); the backward sums the whole cotangent
    over the line and takes this rank's block (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.all_gather(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.reduce_scatter(g.contiguous(), ctx.dim), None, None


def enter(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``EnterReplicated`` over ``axis``; ``x`` itself on a line of one
    rank."""
    return x if axis.size == 1 else EnterReplicated.apply(x, axis)


def reduce_over(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``ReduceOver`` over ``axis``; ``x`` itself on a line of one
    rank."""
    return x if axis.size == 1 else ReduceOver.apply(x, axis)


class VocabNLL(torch.autograd.Function):
    """The negative log likelihood of each label from this rank's block
    of the vocabulary's logits (..., n) float32, block i of the model
    line ``axis`` holding columns [i n, (i + 1) n): the maximum, the sum
    of exponentials and the gold logit reduced over the line, so each
    rank returns the whole nll (...,) and never gathers the logits.  The
    backward is this rank's block of softmax - onehot, times the
    (replicated) cotangent."""

    @staticmethod
    def forward(ctx, logits, labels, axis):
        n = logits.shape[-1]
        local = labels.long() - axis.index * n
        inside = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
        m = axis.all_reduce(logits.amax(-1), op=dist.ReduceOp.MAX)
        e = torch.exp(logits - m[..., None])
        s = axis.all_reduce(e.sum(-1))
        gold = logits.gather(-1, local[..., None])[..., 0]
        gold = axis.all_reduce(torch.where(inside, gold, gold.new_zeros(())))
        ctx.save_for_backward(e, s, local, inside)
        return (torch.log(s) + m) - gold

    @staticmethod
    def backward(ctx, g):
        e, s, local, inside = ctx.saved_tensors
        grad = e / s[..., None] * g[..., None]
        hit = torch.where(inside, g, g.new_zeros(()))
        grad = grad.scatter_add(-1, local[..., None], -hit[..., None])
        return grad, None, None
