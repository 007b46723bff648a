"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's ``Sharder`` on the CPU, with no process group.

The reference's rules read only ``mesh.shape`` and ``mesh.axis_names``, so
it is given a stand-in mesh object with those two: every config's rules,
``spec`` and ``opt_state_spec`` of every parameter and ``pspec`` of the
activations are held equal on meshes (2,4), (4,2), (1,8), (16,16) and
(2,16,16), head padding included.  The ``act`` guard is compared through
the reference's own ``act`` with its constraint captured.  The port's
logical specs of each parameter equal the reference's init specs without
the stacked ``layers`` axis.  The executed placement (only expert slabs
cut, ``local_slices``), ``shard_params`` / ``gather_params`` in a world
of one and the mesh's rank layout are checked here too; the collectives
themselves are tests/test_torch_ep.py's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.distributed.sharding as ref_sharding
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.sharding import (EXECUTED, Mesh, Sharder,
                                              _line_ranks, gather_params,
                                              make_mesh, param_spec,
                                              param_specs, shard_params)
from repro_torch.models import build_model

MESHES = (((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((1, 8), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))
ACTIVATIONS = (("batch", "seq_sp", None), ("batch", "seq", "heads", None),
               ("batch", None, "ff"), ("batch", None, "ff_expert"),
               ("layers", "batch", "kv_seq", "kv_heads", None),
               ("layers", "batch", "d_inner", None))


class StandIn:
    """All of a mesh the reference's rules read."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


def _ref_specs(arch):
    """The reference's logical specs of the reduced ``arch``, by the
    port's parameter name (``layers`` stripped, layer 0's name)."""
    cfg = ref_get_config(arch).reduced()
    kept = {}

    def init(key):   # traced only: the specs are Python values
        params, kept["specs"] = ref_build_model(cfg).init(key)
        return params

    jax.eval_shape(init, jax.random.PRNGKey(0))
    specs = kept["specs"]
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, tuple))[0]
    out = {}
    for path, spec in flat:
        keys = [k.key for k in path]
        stacked = {"layers": "blocks"}.get(keys[0], keys[0])
        if keys[0] in ("layers", "enc_layers", "dec_layers"):
            assert spec[0] == "layers"
            keys, spec = [stacked, "0"] + keys[1:], spec[1:]
        out[".".join(keys)] = tuple(spec)
    return out


def test_ids_are_the_reference_ids():
    assert tuple(ARCH_IDS) == tuple(REF_ARCH_IDS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_parameter_specs_are_the_reference_init_specs(arch):
    model = build_model(get_config(arch).reduced(), device="cpu")
    ours = {n: s for n, s in param_specs(model).items()
            if ".0." in n or not n.split(".")[0].endswith(("blocks",
                                                            "layers"))}
    assert ours == _ref_specs(arch)


def _configs(arch):
    """The published config, and one with its heads padded up to a
    multiple of 16, as TP-16 padding does (llama4-scout ships with it)."""
    cfg = get_config(arch)
    out = [cfg]
    if cfg.n_heads:
        up = lambda n: -(-n // 16) * 16  # noqa: E731
        out.append(dataclasses.replace(cfg, n_heads_padded=up(cfg.n_heads),
                                       n_kv_heads_padded=up(cfg.n_kv_heads)))
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_specs_equal_the_reference(arch, mesh, monkeypatch):
    shape, axes = mesh
    model = build_model(get_config(arch).reduced(), device="cpu")
    logical = sorted(set(param_specs(model).values()), key=str)
    # the reference's act, its constraint captured instead of applied
    monkeypatch.setattr(ref_sharding, "NamedSharding", lambda m, s: s)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: tuple(s))
    for cfg in _configs(arch):
        ref_cfg = dataclasses.replace(ref_get_config(arch),
                                      n_heads_padded=cfg.n_heads_padded,
                                      n_kv_heads_padded=cfg.n_kv_heads_padded)
        ours = Sharder(cfg, Mesh(shape, axes))
        theirs = ref_sharding.Sharder(ref_cfg, StandIn(shape, axes))
        assert ours.rules == theirs.rules
        assert (ours.tp, ours.tp_axis, ours.dp_axes) == \
            (theirs.tp, theirs.tp_axis, theirs.dp_axes)
        for spec in logical:
            assert ours.spec(spec) == tuple(theirs.spec(spec)), spec
            assert ours.opt_state_spec(spec) == \
                tuple(theirs.opt_state_spec(spec)), spec
        for act in ACTIVATIONS:
            assert ours.pspec(*act) == tuple(theirs.pspec(*act))
            for dims in ((32, 4096, 8, 16, 8), (3, 1, 5, 1, 6)):
                x = np.zeros(dims[:len(act)], np.float32)
                assert ours.act_spec(x.shape, *act) == theirs.act(x, *act), \
                    (act, dims)


def test_without_a_mesh_every_spec_is_replicated():
    cfg = get_config("llama4-scout-17b-a16e")
    ours = Sharder(cfg, None)
    theirs = ref_sharding.Sharder(ref_get_config("llama4-scout-17b-a16e"),
                                  None)
    assert ours.rules == theirs.rules == {}
    assert ours.spec(("experts", "residual", None)) == () == \
        tuple(theirs.spec(("experts", "residual", None)))
    assert ours.opt_state_spec(("residual",)) == ()
    assert ours.act_spec((4, 8, 16), "batch", "seq_sp", None) == ()
    assert ours.expert_axis() is None
    assert ours.local_slices(("experts", None), (16, 4)) == \
        (slice(None), slice(None))


def test_padding_lifts_head_divisibility():
    cfg = dataclasses.replace(get_config("qwen3-32b").reduced(), n_heads=5,
                              n_kv_heads=2)
    mesh = Mesh((2, 4), ("data", "model"))
    assert Sharder(cfg, mesh).rules["heads"] is None
    padded = dataclasses.replace(cfg, n_heads_padded=8)
    assert Sharder(padded, mesh).rules["heads"] == "model"
    assert Sharder(cfg, mesh).rules["kv_seq"] == "model"   # 2 % 4 != 0


def test_mesh_lays_ranks_out_row_major():
    mesh = Mesh((2, 4), ("data", "model"), rank=6)
    assert mesh.coords == {"data": 1, "model": 2}
    grid = np.arange(8).reshape(2, 4)
    assert _line_ranks((2, 4), ("model",), ("data", "model"),
                       {"data": 1}) == list(grid[1])
    assert _line_ranks((2, 4), ("data",), ("data", "model"),
                       {"model": 2}) == list(grid[:, 2])
    assert _line_ranks((2, 2, 2), ("pod", "data"), ("pod", "data", "model"),
                       {"model": 1}) == [1, 3, 5, 7]
    with pytest.raises(ValueError, match="no process groups"):
        mesh.axis("model")
    assert mesh.axis(()).size == 1


def test_only_expert_slabs_are_cut():
    cfg = get_config("deepseek-v2-236b")
    for rank, want in ((0, slice(0, 40)), (3, slice(120, 160))):
        shd = Sharder(cfg, Mesh((1, 4), ("data", "model"), rank=rank))
        assert shd.rules["heads"] == "model"   # reported, not executed
        assert EXECUTED == ("experts",)
        assert shd.local_slices(param_spec("blocks.0.mlp.w_gate", cfg),
                                (160, 5120, 1536))[0] == want
        names = ("blocks.0.mlp.w_up", "blocks.0.mlp.router")
        got = shd.param_shardings(
            {n: param_spec(n, cfg) for n in names},
            {names[0]: (160, 5120, 1536), names[1]: (5120, 160)})
        assert got == {names[0]: (want, slice(None), slice(None)),
                       names[1]: (slice(None), slice(None))}
        assert shd.local_slices(param_spec("blocks.0.attn.wq_b", cfg),
                                (1536, 128 * 192)) == (slice(None),) * 2
        assert shd.is_sharded(param_spec("blocks.0.mlp.w_down", cfg))
        assert not shd.is_sharded(param_spec("head.w", cfg))
        assert shd.experts_sharded()
        assert shd.model_summed("blocks.0.mlp.router")
        assert not shd.model_summed("blocks.0.mlp.ws_gate")
    with pytest.raises(KeyError):
        param_spec("blocks.0.mlp.nothing", cfg)


def test_shard_and_gather_round_trip_in_a_world_of_one():
    cfg = get_config("llama4-scout-17b-a16e").reduced()
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    shd = Sharder(cfg, mesh)
    model = build_model(cfg, device="cpu")
    whole = {n: p.detach() for n, p in model.named_parameters()}
    mine = shard_params(whole, shd)
    back = gather_params(mine, shd)
    assert all(torch.equal(back[n], whole[n]) for n in whole)
    with pytest.raises(ValueError, match="needs an initialised"):
        make_mesh((2, 2), ("data", "model"), device="cpu")
