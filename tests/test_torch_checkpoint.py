"""The port's checkpoint manager (``repro_torch.checkpoint``): the
reference's four tests (tests/test_checkpoint.py) mirrored, the layout
read across packages both ways, bfloat16 leaves, the atomic publish, the
writer thread's failure, and an elastic restore: a checkpoint saved from
a (2, 2) gloo world (expert slabs gathered on save) restored on (1, 4)
in the same world and on one rank, each rank holding its slice of the
whole arrays (tests/torch_mesh.py)."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh as tm
from repro.checkpoint import CheckpointManager as RefManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import flatten
from repro_torch.configs import get_config
from repro_torch.launch.train import state_tree
from repro_torch.models import build_model
from repro_torch.optim import get_optimizer

SCOUT = "llama4-scout-17b-a16e"
SEED = 3


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
            "b": {"c": torch.from_numpy(rng.integers(0, 9, (3,))
                                        .astype(np.int32))}}


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(3, t, extra={"data_step": 3})
    assert mgr.latest_step() == 3
    out = mgr.restore(3, t)
    assert torch.equal(out["a"], t["a"])
    assert torch.equal(out["b"]["c"], t["b"]["c"])
    assert out["b"]["c"].dtype == torch.int32
    assert mgr.extra(3)["data_step"] == 3


def test_async_save_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(s, _tree(s), blocking=False)
    mgr.wait()
    mgr._gc()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [3, 4]
    out = mgr.restore(4, _tree())
    assert torch.equal(out["a"], _tree(4)["a"])


def test_no_tmp_left_behind(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_dtype_cast_on_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(0, t)
    like = {"a": torch.zeros((8, 4), dtype=torch.bfloat16),
            "b": {"c": torch.zeros((3,), dtype=torch.int32)}}
    out = mgr.restore(0, like)
    assert out["a"].dtype == torch.bfloat16
    assert torch.equal(out["a"], t["a"].to(torch.bfloat16))


def test_bfloat16_leaves_keep_their_bits(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(1)) \
        .to(torch.bfloat16)
    mgr.save(2, {"w": x, "step": 9})
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["dtypes"] == ["int", "bfloat16"]   # key-sorted leaves
    assert manifest["paths"] == ["step", "w"]
    raw = np.load(tmp_path / "step_00000002" / "leaf_00001.npy")
    assert raw.dtype == np.uint16
    out = mgr.restore(2, {"w": torch.zeros(5, 7, dtype=torch.bfloat16),
                          "step": 0})
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], x)
    assert out["step"] == 9


def test_the_reference_reads_the_port_layout_and_back(tmp_path):
    """Same directory names, manifest keys and leaf files in key order:
    each manager restores what the other saved."""
    t = _tree(5)
    CheckpointManager(str(tmp_path / "port")).save(4, t, extra={"k": 1})
    ref = RefManager(str(tmp_path / "port"))
    assert ref.latest_step() == 4 and ref.extra(4) == {"k": 1}
    like = {"a": jnp.zeros((8, 4), jnp.float32),
            "b": {"c": jnp.zeros((3,), jnp.int32)}}
    out = ref.restore(4, like)
    np.testing.assert_array_equal(np.asarray(out["a"]), t["a"].numpy())
    np.testing.assert_array_equal(np.asarray(out["b"]["c"]),
                                  t["b"]["c"].numpy())
    RefManager(str(tmp_path / "ref")).save(
        6, {"a": jnp.asarray(t["a"].numpy()),
            "b": {"c": jnp.asarray(t["b"]["c"].numpy())}})
    back = CheckpointManager(str(tmp_path / "ref")).restore(6, t)
    assert torch.equal(back["a"], t["a"])
    assert torch.equal(back["b"]["c"], t["b"]["c"])


def test_a_mismatched_tree_or_a_failed_write_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    with pytest.raises(ValueError, match="differ"):
        mgr.restore(1, {"a": _tree()["a"]})
    bad = CheckpointManager(str(tmp_path / "gone"))
    os.rmdir(tmp_path / "gone")
    (tmp_path / "gone").write_text("a file where the directory was")
    bad.save(2, _tree(), blocking=False)
    with pytest.raises(NotADirectoryError):
        bad.wait()


def test_train_state_tree_names_every_leaf(tmp_path):
    cfg = get_config(SCOUT).reduced()
    model = build_model(cfg, device="cpu")
    state = get_optimizer("adamw").init(list(model.named_parameters()))
    paths = [p for p, _ in flatten(state_tree(model, state))]
    names = [n for n, _ in model.named_parameters()]
    assert sorted(paths) == paths
    assert set(paths) == ({f"params.{n}" for n in names} |
                          {f"opt.{k}.{n}" for k in "mv" for n in names} |
                          {"opt.step"})


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    job = {"arch": SCOUT, "changes": {"top_k": 2}, "seed": SEED,
           "dir": str(tmp / "ckpt"), "af_dir": str(tmp / "adafactor")}
    return tm.spawn(4, "checkpoint_elastic", job, tmp, "world")(), job


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=str)
def test_elastic_restore_on_a_mesh(elastic, shape):
    got, _ = elastic
    same, ok, sliced = got[shape]
    assert same and ok and sliced


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=str)
def test_elastic_adafactor_restore_on_a_mesh(elastic, shape):
    """Adafactor's statistics of the sharded leaves, saved from a 2 x 2
    mesh with their placements, restore to each rank's blocks."""
    got, _ = elastic
    assert got[("adafactor",) + shape]


def test_elastic_adafactor_restore_on_one_rank(elastic):
    """The 2 x 2 world's Adafactor checkpoint holds the whole
    statistics."""
    _, job = elastic
    cfg = dataclasses.replace(get_config(SCOUT).reduced(), **job["changes"])
    whole = build_model(cfg, device="cpu", seed=SEED)
    want = tm.adafactor_stats(whole)
    state = get_optimizer("adafactor").init(list(whole.named_parameters()))
    got = CheckpointManager(job["af_dir"]).restore(1, state_tree(whole,
                                                                 state))
    for g, w in zip(got["opt"]["groups"], want["groups"]):
        for k in g:
            for a, b in zip(tm._leaves(g[k]), tm._leaves(w[k])):
                assert torch.equal(a, b), (w["key"], k)


def test_elastic_restore_on_one_rank(elastic):
    """The world's checkpoint holds whole arrays: one rank restores the
    whole model, and its moments, from it."""
    _, job = elastic
    cfg = dataclasses.replace(get_config(SCOUT).reduced(), **job["changes"])
    whole = build_model(cfg, device="cpu", seed=SEED)
    state = get_optimizer("adamw").init(list(whole.named_parameters()))
    got = CheckpointManager(job["dir"]).restore(1, state_tree(whole, state))
    for n, p in whole.named_parameters():
        assert torch.equal(got["params"][n], p.detach()), n
        assert torch.equal(got["opt"]["m"][n], p.detach() + 0.5), n
    assert got["opt"]["step"] == 7
