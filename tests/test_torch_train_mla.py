"""Training the MoE family with MLA in the port against the reference:
the reduced deepseek-v2 (MLA, 8 experts, top-2 plus a shared expert) with
the LP capacity router; loss, gradients, three AdamW steps and the
routing of the recompute under ``remat="block"``
(tests/torch_train_parity.py)."""
import pytest

import torch_train_parity as tp

MLA = "deepseek-v2-236b"


@pytest.mark.parametrize("remat", ["none", "block"])
def test_loss_and_gradients_match_the_reference(remat):
    tp.check_loss_and_grads(MLA, lp_capacity=True, remat=remat)


@pytest.mark.parametrize("remat,microbatches", [("none", 1), ("block", 2)])
def test_three_adamw_steps_match_the_reference(remat, microbatches):
    tp.check_train_steps(MLA, microbatches=microbatches, lp_capacity=True,
                         remat=remat)


def test_loss_and_gradients_without_the_router_match_the_reference():
    tp.check_loss_and_grads(MLA, lp_capacity=False, remat="block")


def test_recompute_routes_as_the_forward(monkeypatch):
    tp.recompute_routes_as_the_forward(MLA, monkeypatch)
