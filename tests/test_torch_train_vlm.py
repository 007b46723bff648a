"""Training the VLM family (phi-3-vision: a dense GQA backbone with
precomputed patch embeddings before the text) in the port against the
reference: loss, gradients and three AdamW steps on the reduced config
(float32, 8 patches), the loss on text positions only, and the train
step's microbatches slicing the patches untouched
(tests/torch_train_parity.py)."""
import jax
import numpy as np
import pytest
import torch

import torch_train_parity as tp
from repro_torch.distributed import make_train_step
from repro_torch.launch.train import train
from repro_torch.optim import adamw

ARCH = "phi-3-vision-4.2b"


@pytest.mark.parametrize("remat", ["none", "block"])
def test_loss_and_gradients_match_the_reference(remat):
    tp.check_loss_and_grads(ARCH, remat=remat)


@pytest.mark.parametrize("microbatches,remat", [(1, "none"), (2, "block")])
def test_three_adamw_steps_match_the_reference(microbatches, remat):
    tp.check_train_steps(ARCH, microbatches=microbatches, remat=remat)


def test_loss_covers_the_text_positions_and_patches_take_no_gradient():
    """Masking every label gives a zero loss however the patches change;
    the patches are inputs: no parameter of theirs, no gradient kept."""
    cfg, lm = tp.port(ARCH)
    b = tp.to_torch(tp.batch(cfg, 2, 16, 2))
    assert b["patches"].shape[1] == cfg.n_patches
    masked = dict(b, labels=torch.full_like(b["labels"], -1))
    with torch.no_grad():
        assert float(lm.loss_fn(masked)) == 0.0
    loss = lm.loss_fn(b)
    loss.backward()
    assert b["patches"].grad is None and not b["patches"].requires_grad
    n_params = sum(p.numel() for p in lm.parameters())
    ref = sum(a.size for a in jax.tree.leaves(tp.params_np(ARCH)))
    assert n_params == ref


def test_microbatches_slice_the_patches_and_leave_the_batch_untouched(
        monkeypatch):
    cfg, lm = tp.port(ARCH)
    b = tp.to_torch(tp.batch(cfg, 4, 16, 3))
    kept = {k: v.clone() for k, v in b.items()}
    seen = []
    real = lm.loss_sum   # the train step's loss: its (sum, count)
    monkeypatch.setattr(lm, "loss_sum",
                        lambda mb: seen.append(mb) or real(mb))
    opt = adamw()
    make_train_step(lm, opt, microbatches=2)(
        opt.init(list(lm.parameters())), b)
    assert len(seen) == 2
    for i, mb in enumerate(seen):
        assert mb["patches"].dtype == torch.float32
        assert torch.equal(mb["patches"], kept["patches"][2 * i:2 * i + 2])
        assert torch.equal(mb["tokens"], kept["tokens"][2 * i:2 * i + 2])
    for k in b:
        assert torch.equal(b[k], kept[k]), k


def test_train_feeds_patches_each_step():
    cfg, lm = tp.port(ARCH, remat="block")
    res = train(cfg, lm, batch=2, seq=16, steps=3, microbatches=2,
                device="cpu")
    assert np.isfinite(res["losses"]).all()
