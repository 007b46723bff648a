"""The dry run's cells (``repro_torch.launch.cells``) against the
reference's ``launch/cells.py`` on the 16 x 16 production mesh.

The reference's ``build_cell`` runs once, in a subprocess on 512 XLA
host devices, for every architecture and shape: its skip strings, its
parameter count, and the local shape of every argument (the shard shape
of its ``in_shardings``).  The port's cells are built on rank 0 of the
abstract 16 x 16 mesh over fake tensors, and every parameter, optimizer
state, batch and cache argument is held to the reference's shard shape.
Where the reference shards the decode cache's rows (``kv_seq``: the
padded KV heads do not divide the model axis) the port keeps every row
(ROADMAP queue 3): the test asserts that difference, leaf by leaf, and
lists the cells it holds in.  Nothing is traced or computed.
"""
import dataclasses

import pytest

import torch_mesh as tm
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.cells import (FULL_ATTENTION_FAMILIES, build_cell,
                                      cache_logical_spec, cell_is_skipped,
                                      placement_gaps)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import SHAPES

REFERENCE_CELLS = """
    import pickle, sys
    import jax
    from repro.configs import ARCH_IDS
    from repro.launch.cells import build_cell
    from repro.launch.mesh import make_production_mesh
    from repro.models.config import SHAPES

    def key(k):
        for a in ("name", "key", "idx"):
            if hasattr(k, a):
                return str(getattr(k, a))
        raise TypeError(k)

    def shapes(tree, shardings):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        sh = jax.tree.leaves(shardings)
        assert len(flat) == len(sh)
        return {".".join(key(k) for k in path): (tuple(leaf.shape),
                                                   s.shard_shape(leaf.shape))
                for (path, leaf), s in zip(flat, sh)}

    mesh = make_production_mesh()
    out = {}
    for arch in ARCH_IDS:
        for cell in SHAPES:
            c = build_cell(arch, cell.name, mesh)
            if "skipped" in c:
                out[(arch, cell.name)] = {"skipped": c["skipped"]}
                continue
            got = {"total_params": sum(int(x.size) for x in
                                       jax.tree.leaves(c["args"][0]))}
            names = {"train": ("params", "opt", "batch"),
                     "prefill": ("params", "tokens", "extra"),
                     "decode": ("params", "cache", "token", "pos")}[c["kind"]]
            for name, arg, sh in zip(names, c["args"], c["in_shardings"]):
                if arg is not None:
                    got[name] = shapes(arg, sh)
            out[(arch, cell.name)] = got
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference_cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cells")
    return tm.spawn_reference(REFERENCE_CELLS, 512, tmp, "cells")()


@pytest.fixture(scope="module")
def mesh():
    return make_production_mesh(abstract=True)


def _ref_name(path):
    """The port's parameter name of a reference path (layers stripped
    to layer 0, as tests/test_torch_sharding.py names them)."""
    keys = path.split(".")
    if keys[0] in ("layers", "enc_layers", "dec_layers"):
        return ".".join([{"layers": "blocks"}.get(keys[0], keys[0]), "0"]
                        + keys[1:]), 1
    return path, 0


def _flat(tree, prefix=""):
    """{dotted path: tensor} of a dict / NamedTuple tree of tensors."""
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _layer0(named):
    return {n: tuple(p.shape) for n, p in named
            if ".0." in n or not n.split(".")[0].endswith(("blocks",
                                                            "layers"))}


def _opt_shapes(cfg, model, state):
    """{reference opt-state path (layers stripped): local shape} of the
    port's optimizer state: AdamW's m and v a leaf, Adafactor's vr, vc or
    v a group (one member's: every layer's are alike)."""
    named = list(model.named_parameters())
    out = {}
    if cfg.optimizer == "adamw":
        for i, (n, _) in enumerate(named):
            if ".0." in n or not n.split(".")[0].endswith(("blocks",
                                                            "layers")):
                for k in ("m", "v"):
                    out[(k, n)] = tuple(state[k][i].shape)
        return out
    for g in state["groups"]:
        name = named[g["index"][0]][0]
        if g["kind"] == "stacked_vector":
            out[("vr", name)] = ("L",) + tuple(g["vr"].shape)[1:]
            out[("vc", name)] = tuple(g["vc"].shape)
        elif g["kind"] == "matrix":
            out[("vr", name)] = tuple(g["vr"][0].shape)
            out[("vc", name)] = tuple(g["vc"][0].shape)
        else:
            out[("v", name)] = tuple(g["v"][0].shape)
    return out


def _ref_opt(cfg, ref, params):
    out = {}
    for path, (whole, local) in ref.items():
        keys = path.split(".")
        if cfg.optimizer == "adamw":
            if keys[0] == "step":
                continue
            name, lead = _ref_name(".".join(keys[1:]))
            out[(keys[0], name)] = local[lead:]
        else:
            if keys[0] == "step":
                continue
            name, lead = _ref_name(".".join(keys[1:-1]))
            stat = keys[-1]
            if lead and len(params[".".join(keys[1:-1])][0]) == 2:
                # a stacked vector (L, D): vr (L,) a layer, vc (D,)
                out[(stat, name)] = ("L",) if stat == "vr" else local
            else:
                out[(stat, name)] = local[lead:]
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cells_have_the_reference_local_shapes(reference_cells, mesh, arch):
    cfg = get_config(arch)
    gaps = {}
    for cell in SHAPES:
        want = reference_cells[(arch, cell.name)]
        got = build_cell(arch, cell.name, mesh)
        assert ("skipped" in got) == ("skipped" in want)
        if "skipped" in want:
            assert got["skipped"] == want["skipped"]
            continue
        assert got["total_params"] == want["total_params"]
        model = got["model"]
        params = {_ref_name(p)[0]: local[_ref_name(p)[1]:]
                  for p, (_, local) in want["params"].items()}
        assert _layer0(model.named_parameters()) == params, cell.name
        if got["kind"] == "train":
            _, state, batch = got["args"]
            assert _opt_shapes(cfg, model, state) == _ref_opt(
                cfg, want["opt"], want["params"]), cell.name
            assert {k: tuple(v.shape) for k, v in batch.items()} == \
                {k: local for k, (_, local) in want["batch"].items()}
        elif got["kind"] == "prefill":
            _, tokens, extra = got["args"]
            assert tuple(tokens.shape) == want["tokens"][""][1]
            assert {k: tuple(v.shape) for k, v in (extra or {}).items()} \
                == {k: local for k, (_, local) in
                    want.get("extra", {}).items()}
        else:
            _, cache, token, pos = got["args"]
            assert tuple(token.shape) == want["token"][""][1]
            assert tuple(pos.shape) == want["pos"][""][1]
            ours = {k: tuple(v.shape) for k, v in _flat(cache).items()}
            logical = _flat(cache_logical_spec(cfg))
            assert set(ours) == set(want["cache"])
            rows = got["shd"].rules.get("kv_seq")
            for leaf, (whole, local) in want["cache"].items():
                ax = logical[leaf]
                if rows and "kv_seq" in ax and local != ours[leaf]:
                    # the kv_seq gap: every row kept, the rest the same
                    d = ax.index("kv_seq")
                    assert ours[leaf][d] == whole[d] == local[d] * 16
                    assert ours[leaf][:d] + ours[leaf][d + 1:] == \
                        local[:d] + local[d + 1:]
                    gaps.setdefault(cell.name, []).append(leaf)
                else:
                    assert ours[leaf] == local, (cell.name, leaf)
            assert bool(gaps.get(cell.name)) == \
                any("kv_seq" in g for g in got["placement_gaps"])
    kv_ok = (cfg.n_kv_heads_padded or cfg.n_kv_heads) % 16 == 0
    want_gap = cfg.n_kv_heads > 0 and not kv_ok
    assert bool(gaps) == want_gap, gaps
    if want_gap:
        assert "decode_32k" in gaps


def test_skips_are_the_reference_strings():
    from repro.launch import cells as ref_cells
    from repro.configs import get_config as ref_get_config
    from repro.models.config import SHAPES as REF_SHAPES
    assert FULL_ATTENTION_FAMILIES == ref_cells.FULL_ATTENTION_FAMILIES
    skipped = 0
    for arch in ARCH_IDS:
        for cell, ref_cell in zip(SHAPES, REF_SHAPES):
            ours = cell_is_skipped(get_config(arch), cell)
            assert ours == ref_cells.cell_is_skipped(ref_get_config(arch),
                                                     ref_cell)
            skipped += ours is not None
    assert skipped == 8


def test_placement_gaps_name_the_unexecuted_rules(mesh):
    from repro_torch.distributed.sharding import Sharder
    qwen = get_config("qwen3-32b")
    shd = Sharder(qwen, mesh)
    by = {c.name: placement_gaps(qwen, shd, c) for c in SHAPES}
    assert [g.split(":")[0] for g in by["train_4k"]] == ["seq_sp"]
    assert [g.split(":")[0] for g in by["decode_32k"]] == ["kv_seq"]
    whisper = get_config("whisper-small")     # no seq_shard, KV padded
    shd = Sharder(whisper, mesh)
    assert all(placement_gaps(whisper, shd, c) == [] for c in SHAPES)
    off = dataclasses.replace(qwen, seq_shard=False)
    assert placement_gaps(off, Sharder(off, mesh), SHAPES[0]) == []
