"""Training the dense family (qwen3-32b, llama3-405b) in the port against
the reference: loss, gradients and three optimizer steps on the reduced
configs (float32), and ``train`` and its CLI with the config's optimizer,
or AdamW under ``--reduced`` as the reference's CLI
(tests/torch_train_parity.py)."""
import numpy as np
import pytest
import torch

import torch_train_parity as tp
from repro_torch.configs import get_config
from repro_torch.data import DataPipeline
from repro_torch.distributed import make_train_step
from repro_torch.launch import train as train_mod
from repro_torch.models import build_model
from repro_torch.optim import adamw


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("arch", ["qwen3-32b", "llama3-405b"])
def test_loss_and_gradients_match_the_reference(arch, remat):
    tp.check_loss_and_grads(arch, remat=remat)


@pytest.mark.parametrize("microbatches,remat", [(1, "none"), (2, "block")])
def test_three_adamw_steps_match_the_reference(microbatches, remat):
    tp.check_train_steps("qwen3-32b", microbatches=microbatches, remat=remat)


def test_reduced_cli_trains_llama3_405b_with_adamw(monkeypatch, capsys):
    """The reference's CLI trains a reduced config with AdamW whatever the
    config names (its launch/train.py); llama3-405b's config names
    Adafactor.  The port's CLI did not: it kept the config's optimizer."""
    built = []
    real = train_mod.get_optimizer

    def record(name, **kw):
        built.append(name)
        return real(name, **kw)

    monkeypatch.setattr(train_mod, "get_optimizer", record)
    res = train_mod.main(["--arch", "llama3-405b", "--reduced", "--device",
                          "cpu", "--steps", "2", "--batch", "2", "--seq",
                          "16", "--log-every", "1"])
    assert built == ["adamw"]
    assert "optimizer=adamw" in capsys.readouterr().out
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()


def test_train_takes_the_config_optimizer_unless_told(monkeypatch):
    built = []
    real = train_mod.get_optimizer

    def record(name, **kw):
        built.append(name)
        return real(name, **kw)

    monkeypatch.setattr(train_mod, "get_optimizer", record)
    cfg, lm = tp.port("llama3-405b")
    assert cfg.optimizer == "adafactor"
    for optimizer in (None, "adamw"):
        res = train_mod.train(cfg, lm, batch=2, seq=16, steps=1,
                              device="cpu", optimizer=optimizer)
        assert np.isfinite(res["losses"]).all()
    assert built == ["adafactor", "adamw"]
    with pytest.raises(KeyError):
        train_mod.train(cfg, lm, batch=2, seq=16, steps=1, device="cpu",
                        optimizer="sgd")


def test_train_runs_the_dense_models_on_their_pipeline_batches():
    """``train`` with a built model (seed 0) against the same steps taken by
    hand on ``DataPipeline.batch_at``: equal losses."""
    cfg = get_config("qwen3-32b").reduced()
    res = train_mod.train(cfg, build_model(cfg, device="cpu", seed=0),
                          batch=2, seq=16, steps=2, device="cpu", seed=3)
    lm = build_model(cfg, device="cpu", seed=0)
    opt = adamw(lr=3e-3)
    state = opt.init(list(lm.parameters()))
    step = make_train_step(lm, opt)
    data = DataPipeline(vocab=cfg.vocab, batch=2, seq=16, seed=3)
    for s in range(2):
        m = step(state, {k: torch.from_numpy(v).long()
                         for k, v in data.batch_at(s).items()})
        assert float(m["loss"]) == res["losses"][s]
