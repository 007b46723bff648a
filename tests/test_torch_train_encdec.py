"""Training the encdec family (whisper-small: encoder and decoder stacks,
a tied head) in the port against the reference: loss, gradients and three
AdamW steps on the reduced config (float32) with stub frames, both stacks
rematerialized under ``remat="block"``, and ``train`` drawing the frames
each step (tests/torch_train_parity.py).  The reference's CLI cannot
train whisper (its batches carry no frames; ROADMAP queue 3), so the port
is held to its jitted ``loss_fn`` and ``make_train_step``."""
import numpy as np
import pytest
import torch

import torch_train_parity as tp
from repro_torch.data import DataPipeline
from repro_torch.launch.train import step_batch, train
from repro_torch.models import encdec

ARCH = "whisper-small"


@pytest.mark.parametrize("remat", ["none", "block"])
def test_loss_and_gradients_match_the_reference(remat):
    lm, grads = tp.check_loss_and_grads(ARCH, remat=remat)
    # the head is tied: the embedding's gradient holds both uses
    assert len(lm.head) == 0
    names = [n for n, _ in lm.named_parameters()]
    assert float(grads[names.index("embed.table")].abs().max()) > 0


@pytest.mark.parametrize("microbatches,remat", [(1, "none"), (2, "block")])
def test_three_adamw_steps_match_the_reference(microbatches, remat):
    tp.check_train_steps(ARCH, microbatches=microbatches, remat=remat)


@pytest.mark.parametrize("remat,runs", [("none", 1), ("block", 2)])
def test_both_stacks_are_rematerialized(remat, runs, monkeypatch):
    """Each encoder and decoder block's forward runs once in the loss and,
    under ``remat="block"``, once more in the backward, as the reference
    checkpoints both scans (models/encdec.py)."""
    cfg, lm = tp.port(ARCH, remat=remat)
    seen = {"enc": 0, "dec": 0}
    for kind, cls in (("enc", encdec.EncBlock), ("dec", encdec.DecBlock)):
        real = cls.forward

        def count(self, *a, _real=real, _kind=kind, **kw):
            if type(self).__name__[:3].lower() == _kind:
                seen[_kind] += 1
            return _real(self, *a, **kw)
        monkeypatch.setattr(cls, "forward", count)
    loss = lm.loss_fn(tp.to_torch(tp.batch(cfg, 2, 32, 1)))
    torch.autograd.grad(loss, list(lm.parameters()))
    assert seen == {"enc": runs * cfg.n_encoder_layers,
                    "dec": runs * cfg.n_layers}


def test_step_batch_draws_frames_from_the_step_seed():
    """Tokens and labels as int64 from ``batch_at``; frames in the config's
    dtype from ``default_rng((seed, step))``, ``n_frames`` rows; another
    step draws other frames."""
    cfg, _ = tp.cfgs(ARCH)
    data = DataPipeline(vocab=cfg.vocab, batch=2, seq=16, seed=4)
    b = step_batch(cfg, data, 3, seed=4, n_frames=40, device="cpu")
    assert set(b) == {"tokens", "labels", "frames"}
    assert b["tokens"].dtype == b["labels"].dtype == torch.long
    np.testing.assert_array_equal(b["tokens"].numpy(),
                                  data.batch_at(3)["tokens"])
    want = np.random.default_rng((4, 3)).standard_normal(
        (2, 40, cfg.d_model), dtype=np.float32)
    assert b["frames"].dtype == torch.float32
    np.testing.assert_array_equal(b["frames"].numpy(), want)
    other = step_batch(cfg, data, 4, seed=4, n_frames=40, device="cpu")
    assert not torch.equal(other["frames"], b["frames"])


def test_train_feeds_frames_each_step():
    cfg, lm = tp.port(ARCH, remat="block")
    res = train(cfg, lm, batch=2, seq=16, steps=3, microbatches=2,
                device="cpu", n_frames=48)
    assert np.isfinite(res["losses"]).all()
    with pytest.raises(ValueError, match="n_frames"):
        train(cfg, lm, batch=2, seq=16, steps=1, device="cpu", n_frames=0)
