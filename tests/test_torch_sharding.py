"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's ``Sharder`` on the CPU, with no process group.

The reference's rules read only ``mesh.shape`` and ``mesh.axis_names``, so
it is given a stand-in mesh object with those two: every config's rules,
``spec`` and ``opt_state_spec`` of every parameter and ``pspec`` of the
activations are held equal on meshes (2,4), (4,2), (1,8), (16,16) and
(2,16,16), head padding included.  The ``act`` guard is compared through
the reference's own ``act`` with its constraint captured.  The port's
logical specs of each parameter equal the reference's init specs without
the stacked ``layers`` axis.  The executed placement (``local_slices``,
every rule the reference resolves), ``shard_params`` / ``gather_params``
in a world of one and the mesh's rank layout are checked here too; the
collectives themselves are tests/test_torch_ep.py's.

Each rank's block of every leaf, for the ten published configs on the
meshes (1,2), (1,4), (2,2) and (2,4), and of AdamW's moments under
ZeRO-1, is held to the reference's ``NamedSharding`` shard of the same
device index (``devices_indices_map``, the reference's guarded
placement of ``launch/cells.py``) on an XLA host mesh of 8 devices in a
subprocess; the reduced configs, with ``fsdp`` on, are built sharded and
each parameter's local shape held to the reference's shard shape.
Nothing is computed.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.distributed.sharding as ref_sharding
import torch_mesh as tm
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


# (config, changes, mesh, a leaf the rule cuts, its whole shape, the dim)
RULE_LEAVES = {
    "heads": ("deepseek-v2-236b", {}, (1, 4), "blocks.0.attn.wq_b",
              (1536, 128 * 192), 1),
    "kv_heads": ("qwen3-32b", {}, (1, 4), "blocks.0.attn.wk",
                 (5120, 8 * 128), 1),
    "ff": ("qwen3-32b", {}, (1, 4), "blocks.0.mlp.w_down", (25600, 5120),
           0),
    "ff_expert": ("deepseek-v2-236b", {}, (1, 4), "blocks.0.mlp.ws_gate",
                  (5120, 2 * 1536), 1),
    "d_inner": ("falcon-mamba-7b", {}, (1, 4), "blocks.0.ssm.w_x",
                (8192, 512 + 32), 0),
    "vocab": ("deepseek-v2-236b", {}, (1, 4), "head.w", (5120, 102400), 1),
    "experts": ("deepseek-v2-236b", {}, (1, 4), "blocks.0.mlp.w_gate",
                (160, 5120, 1536), 0),
    "residual": ("deepseek-v2-236b", {}, (4, 1), "blocks.0.attn.wq_a",
                 (5120, 1536), 0),
}


def test_every_reference_rule_is_executed():
    assert set(EXECUTED) == set(RULE_LEAVES)


@pytest.mark.parametrize("rule", sorted(RULE_LEAVES))
def test_each_rule_cuts_its_leaves(rule):
    """Rank r of the rule's line holds block r of the dim the rule
    names, every other dim whole; a leaf the rule does not name is not
    cut by it."""
    arch, changes, shape, name, whole, dim = RULE_LEAVES[rule]
    cfg = dataclasses.replace(get_config(arch), **changes)
    assert rule in param_spec(name, cfg)
    n = max(shape)
    for rank in (0, n - 1):
        shd = Sharder(cfg, Mesh(shape, ("data", "model"), rank=rank))
        sl = shd.local_slices(param_spec(name, cfg), whole)
        step = whole[dim] // n
        assert sl[dim] == slice(rank * step, (rank + 1) * step)
        assert all(s == slice(None) for d, s in enumerate(sl) if d != dim)
        assert shd.is_sharded(param_spec(name, cfg))
        assert not shd.is_sharded(param_spec("blocks.0.norm1.scale", cfg))
        assert shd.shard_axes(param_spec(name, cfg)) == \
            {"data" if rule == "residual" else "model"}


def test_replicated_leaves_with_partial_gradients_are_model_summed():
    cfg = get_config("deepseek-v2-236b")
    shd = Sharder(cfg, Mesh((1, 4), ("data", "model"), rank=3))
    assert shd.experts_sharded()
    assert shd.model_summed("blocks.0.mlp.router")
    assert not shd.model_summed("blocks.0.mlp.ws_gate")
    assert not shd.model_summed("blocks.0.attn.wkv_a")   # MLA: whole
    # GQA with sharded heads over unsharded KV heads (8 % 16)
    qwen = Sharder(get_config("qwen3-32b"), Mesh((1, 16), ("data", "model")))
    assert qwen.rules["heads"] and not qwen.rules["kv_heads"]
    assert qwen.model_summed("blocks.0.attn.wk")
    assert qwen.model_summed("blocks.0.attn.q_scale")
    assert not qwen.model_summed("blocks.0.attn.wq")
    qwen4 = Sharder(get_config("qwen3-32b"), Mesh((1, 4), ("data", "model")))
    assert not qwen4.model_summed("blocks.0.attn.wk")
    with pytest.raises(KeyError):
        param_spec("blocks.0.mlp.nothing", cfg)


def test_zero_one_cuts_the_moments_residual_over_data():
    cfg = get_config("qwen3-32b")      # fsdp off: the parameter keeps D
    shd = Sharder(cfg, Mesh((2, 4), ("data", "model"), rank=5))
    spec = param_spec("blocks.0.attn.wq", cfg)
    assert shd.local_slices(spec, (5120, 8192)) == \
        (slice(None), slice(2048, 4096))
    assert shd.local_slices(spec, (5120, 8192), zero=True) == \
        (slice(2560, 5120), slice(2048, 4096))
    assert shd.opt_state_spec(spec) == ("data", "model")
    # one data rank: the moments are the parameter's
    one = Sharder(cfg, Mesh((1, 4), ("data", "model"), rank=1))
    assert one.placement(spec, zero=True) == one.placement(spec)


PLACEMENT_MESHES = ((1, 2), (1, 4), (2, 2), (2, 4))

# the reference's guarded shards of every leaf (launch/cells.py), by the
# port's parameter name, for each published config and mesh
REFERENCE_SHARDS = """
    import dataclasses, pickle, sys
    import jax, numpy as np
    from repro.configs import ARCH_IDS, get_config
    from repro.distributed.sharding import Sharder, make_mesh
    from repro.launch.cells import _guarded_sharding, _guarded_sharding_opt
    from repro.models import build_model

    def port_name(path):
        keys = [k.key for k in path]
        if keys[0] in ("layers", "enc_layers", "dec_layers"):
            return ".".join([{"layers": "blocks"}.get(keys[0], keys[0]),
                             "0"] + keys[1:]), 1
        return ".".join(keys), 0

    def bounds(sharding, shape, mesh, lead):
        index = sharding.devices_indices_map(shape)
        out = []
        for dev in mesh.devices.flat:
            out.append(tuple(sl.indices(n)[:2] for sl, n in
                             zip(index[dev][lead:], shape[lead:])))
        return out

    def shards(cfg, mesh):
        model = build_model(cfg, Sharder(cfg, mesh))
        kept = {}

        def init(key):
            params, kept["specs"] = model.init(key)
            return params
        sds = jax.eval_shape(init, jax.random.PRNGKey(0))
        specs = kept["specs"]
        shd = Sharder(cfg, mesh)
        params = _guarded_sharding(shd, sds, specs)
        moments = _guarded_sharding_opt(shd, sds, specs)
        flat = jax.tree_util.tree_flatten_with_path(sds)[0]
        p_flat = jax.tree.leaves(params)
        m_flat = jax.tree.leaves(moments)
        out = {}
        for (path, leaf), ps, ms in zip(flat, p_flat, m_flat):
            name, lead = port_name(path)
            out[name] = (leaf.shape[lead:], bounds(ps, leaf.shape, mesh, lead),
                         bounds(ms, leaf.shape, mesh, lead))
        return out

    out = {}
    for shape in ((1, 2), (1, 4), (2, 2), (2, 4)):
        mesh = make_mesh(shape, ("data", "model"))
        for arch in ARCH_IDS:
            out[(arch, shape)] = shards(get_config(arch), mesh)
            small = dataclasses.replace(get_config(arch).reduced(), fsdp=True)
            out[(arch, shape, "reduced")] = shards(small, mesh)
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference_shards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shards")
    return tm.spawn_reference(REFERENCE_SHARDS, 8, tmp, "shards")()


def _bounds(slices, shape):
    return tuple(sl.indices(n)[:2] for sl, n in zip(slices, shape))


@pytest.mark.parametrize("shape", PLACEMENT_MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_rank_holds_the_reference_shard(reference_shards, arch,
                                              shape):
    """Every leaf of the published config: each rank's block of the
    parameter and of its ZeRO-1 moments is the reference's shard of the
    same device index; the reduced config (fsdp on), built sharded,
    holds each parameter at the reference's shard shape."""
    want = reference_shards[(arch, shape)]
    cfg = get_config(arch)
    for rank in range(int(np.prod(shape))):
        shd = Sharder(cfg, Mesh(shape, ("data", "model"), rank=rank))
        for name, (whole, params, moments) in want.items():
            spec = param_spec(name, cfg)
            assert _bounds(shd.local_slices(spec, whole), whole) == \
                params[rank], (name, rank)
            assert _bounds(shd.local_slices(spec, whole, zero=True),
                           whole) == moments[rank], (name, rank)
    small = dataclasses.replace(cfg.reduced(), fsdp=True)
    want = reference_shards[(arch, shape, "reduced")]
    for rank in (0, int(np.prod(shape)) - 1):
        shd = Sharder(small, Mesh(shape, ("data", "model"), rank=rank))
        model = build_model(small, device="cpu", shd=shd)
        got = {n: tuple(p.shape) for n, p in model.named_parameters()
               if ".0." in n or not n.split(".")[0].endswith(("blocks",
                                                               "layers"))}
        assert set(got) == set(want)
        for name, (whole, params, _) in want.items():
            assert got[name] == tuple(b - a for a, b in params[rank]), name


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
