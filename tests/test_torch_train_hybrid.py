"""Training the hybrid family (hymba-1.5b: GQA with a sliding window and
Mamba on the same input, mean-fused) in the port against the reference:
loss, gradients and three AdamW steps on the reduced config (float32,
window 32), at 64 tokens so that the window masks keys in train mode, the
scan through the interpret-mode Pallas kernel in the reference and its
plain versions in the port (tests/torch_train_parity.py)."""
import dataclasses

import pytest
import torch

import torch_train_parity as tp
from repro_torch.launch.train import train

ARCH = "hymba-1.5b"
S = 64                   # twice the reduced window


@pytest.mark.parametrize("remat", ["none", "block"])
def test_loss_and_gradients_match_the_reference(remat):
    tp.check_loss_and_grads(ARCH, S=S, remat=remat, ssm_impl="kernel")


@pytest.mark.parametrize("microbatches,remat", [(1, "none"), (2, "block")])
def test_three_adamw_steps_match_the_reference(microbatches, remat):
    tp.check_train_steps(ARCH, microbatches=microbatches, S=S, remat=remat,
                         ssm_impl="kernel")


def test_the_window_masks_keys_in_train_mode():
    """At 64 tokens the reduced window of 32 changes the loss: the checks
    above run where the mask bites."""
    cfg, lm = tp.port(ARCH)
    assert cfg.sliding_window == 32
    b = tp.to_torch(tp.batch(cfg, 2, S, 0))
    with torch.no_grad():
        windowed = float(lm.loss_fn(b))
        for block in lm.blocks:
            block.cfg = dataclasses.replace(cfg, sliding_window=None)
        full = float(lm.loss_fn(b))
    assert abs(windowed - full) > 1e-4


def test_train_runs_the_hybrid_family_with_two_microbatches():
    cfg, lm = tp.port(ARCH, remat="block")
    res = train(cfg, lm, batch=2, seq=S, steps=2, microbatches=2,
                device="cpu")
    assert len(res["losses"]) == 2
    assert all(x == x for x in res["losses"] + res["grad_norms"])
