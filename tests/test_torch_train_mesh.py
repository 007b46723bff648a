"""The train CLI over a mesh (``launch/train.py`` ``--mesh``,
``--checkpoint-dir``, ``--save-every``) on the CPU.

Resume is exact: 4 steps straight equal 2 steps, a checkpoint, and 2
more in new processes that resume from it, bit for bit in every loss and
parameter, in a world of one and over a 2 x 2 gloo world (the reduced
llama4-scout, every leaf the rules shard held in blocks, AdamW's
moments under ZeRO-1; tests/torch_mesh.py spawns the ranks); a resume from a checkpoint written from the writer
thread while training went on is exact too.  The 2 x 2 run's checkpoint holds whole arrays: one
rank restores the gathered parameters from it.  A mesh with no world to
run on and ranks that neither share one card nor own one each raise;
Adafactor with sharded experts no longer does."""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import torch_mesh as tm
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import Mesh, Sharder
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import (join_world, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.train import main, state_tree, train
from repro_torch.models import build_model
from repro_torch.optim import get_optimizer

SCOUT = "llama4-scout-17b-a16e"
ARGV = ["--arch", SCOUT, "--reduced", "--batch", "4", "--seq", "16",
        "--device", "cpu", "--log-every", "1", "--lr", "1e-3",
        "--save-every", "3"]


def _in_process(argv, monkeypatch):
    """main(argv) in this process: its losses and final parameters."""
    seen = {}
    real = train_mod.train

    def keep(cfg, model, **kw):
        seen["model"] = model
        return real(cfg, model, **kw)

    monkeypatch.setattr(train_mod, "train", keep)
    res = main(argv)
    return {"losses": res["losses"], "start": res["start"],
            "params": {n: p.detach().numpy().copy()
                       for n, p in seen["model"].named_parameters()}}


def _equal_runs(straight, first, second):
    assert first["losses"] + second["losses"] == straight["losses"]
    assert (first["start"], second["start"]) == (0, 2)
    for n, p in straight["params"].items():
        np.testing.assert_array_equal(second["params"][n], p, err_msg=n)


def test_resume_is_exact_in_a_world_of_one(tmp_path, monkeypatch):
    straight = _in_process(ARGV + ["--steps", "4", "--checkpoint-dir",
                                   str(tmp_path / "a")], monkeypatch)
    run = ARGV + ["--checkpoint-dir", str(tmp_path / "b")]
    first = _in_process(run + ["--steps", "2"], monkeypatch)
    second = _in_process(run + ["--steps", "4"], monkeypatch)
    _equal_runs(straight, first, second)
    # --save-every 3 saved step 3 on the way; the end saved step 4
    assert sorted(int(p.name[5:]) for p in (tmp_path / "a").iterdir()) == \
        [3, 4]
    assert CheckpointManager(str(tmp_path / "a")).extra(3) == \
        {"data_step": 3}
    # a finished run resumes to nothing
    again = _in_process(run + ["--steps", "4"], monkeypatch)
    assert again["losses"] == [] and again["start"] == 4


def test_resume_from_a_save_written_while_training_goes_on(tmp_path,
                                                         monkeypatch):
    """--save-every 2 writes step 2 from a thread while steps 3 and 4
    update the parameters and AdamW's moments in place: the checkpoint is
    the state after step 2, so a resume from it alone equals the straight
    run bit for bit."""
    straight = _in_process(ARGV + ["--steps", "4", "--save-every", "2",
                                   "--checkpoint-dir", str(tmp_path / "a")],
                           monkeypatch)
    shutil.copytree(tmp_path / "a" / "step_00000002",
                    tmp_path / "b" / "step_00000002")
    second = _in_process(ARGV + ["--steps", "4", "--checkpoint-dir",
                                 str(tmp_path / "b")], monkeypatch)
    assert second["start"] == 2
    assert second["losses"] == straight["losses"][2:]
    for n, p in straight["params"].items():
        np.testing.assert_array_equal(second["params"][n], p, err_msg=n)


@pytest.fixture(scope="module")
def two_by_two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    mesh = ["--mesh", "2x2"]
    straight = tm.spawn(4, "train_cli", {"argv": ARGV + mesh + [
        "--steps", "4", "--checkpoint-dir", str(tmp / "a")]}, tmp, "a")
    run = ARGV + mesh + ["--checkpoint-dir", str(tmp / "b")]
    first = tm.spawn(4, "train_cli", {"argv": run + ["--steps", "2"]}, tmp,
                     "b1")()
    second = tm.spawn(4, "train_cli", {"argv": run + ["--steps", "4"]}, tmp,
                      "b2")()
    return straight(), first, second, tmp


def test_resume_is_exact_at_two_by_two(two_by_two):
    straight, first, second, _ = two_by_two
    _equal_runs(straight, first, second)
    assert np.isfinite(straight["losses"]).all()


def test_the_mesh_checkpoint_restores_whole_on_one_rank(two_by_two):
    straight, _, _, tmp = two_by_two
    cfg = get_config(SCOUT).reduced()
    model = build_model(cfg, device="cpu")
    state = get_optimizer("adamw").init(list(model.named_parameters()))
    got = CheckpointManager(str(tmp / "a")).restore(
        4, state_tree(model, state))
    assert got["opt"]["step"] == 4
    for n, p in straight["params"].items():
        np.testing.assert_array_equal(got["params"][n].numpy(), p,
                                      err_msg=n)
    assert straight["params"]["blocks.0.mlp.w_gate"].shape[0] == \
        cfg.n_experts


def test_a_mesh_without_a_world_raises(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="needs a torch.distributed world"):
        main(ARGV + ["--mesh", "2x2", "--steps", "1"])


def test_ranks_that_neither_share_a_card_nor_own_one_raise(monkeypatch):
    for k, v in {"WORLD_SIZE": "4", "RANK": "0", "LOCAL_RANK": "0",
                 "LOCAL_WORLD_SIZE": "4"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="4 ranks on 2 cards"):
        join_world((2, 2))


def test_adafactor_with_sharded_experts_raises():
    """Adafactor with sharded experts raises no NotImplementedError any
    more: its statistics of the sharded leaves are summed over the lines
    that cut them (held to the reference's step on a mesh in
    tests/test_torch_ep.py).  Without a world, only the mesh's missing
    process groups stop it, as they stop AdamW's ZeRO-1 placement."""
    cfg = dataclasses.replace(get_config(SCOUT).reduced(), top_k=2)
    model = build_model(cfg, device="cpu")
    shd = Sharder(cfg, Mesh((1, 2), ("data", "model")))
    for optimizer in ("adafactor", "adamw"):
        with pytest.raises(ValueError, match="no process groups"):
            train(cfg, model, batch=2, seq=8, steps=1, device="cpu",
                  optimizer=optimizer, shd=shd)


def test_production_meshes_need_their_worlds():
    """(16, 16) and (2, 16, 16) need 256 and 512 ranks; a host mesh of
    one rank needs none."""
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"a mesh of {n} ranks"):
            make_production_mesh(multi_pod=multi_pod)
    mesh = make_host_mesh((1, 1))
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert mesh.device == torch.device("cpu")
