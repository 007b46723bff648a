"""Training the MoE family with GQA in the port against the reference: the
reduced llama4-scout (8 experts, top-1 plus a shared expert) with the LP
capacity router on and off; loss, gradients, three AdamW steps, the
layer's gradients where tokens are dropped, and the routing of the
recompute under ``remat="block"`` (tests/torch_train_parity.py; the MLA
MoE model, deepseek-v2, is tests/test_torch_train_mla.py's).

The router's caps carry no gradient (``core/lp_router.py`` detaches them,
as the reference's ``stop_gradient`` does), so the keep mask is a
constant of the backward and the router's weights get their gradient
through the softmax and the renormalized top-k weights only.  At top-1
the renormalized weight is p / p = 1, so the router gets no gradient at
all: both frameworks return float32 rounding noise there, which AdamW's
per-entry normalization turns into steps of about lr either way.  The
AdamW steps of scout therefore run at top-2, where the router learns.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_parity as tp
from repro.models import moe as ref_moe
from repro_torch.models import moe

SCOUT = "llama4-scout-17b-a16e"


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("lp", [False, True])
def test_loss_and_gradients_match_the_reference(lp, remat):
    tp.check_loss_and_grads(SCOUT, lp_capacity=lp, remat=remat)


@pytest.mark.parametrize("lp,remat,microbatches", [(False, "none", 1),
                                                   (True, "block", 2)])
def test_three_adamw_steps_match_the_reference(lp, remat, microbatches):
    tp.check_train_steps(SCOUT, microbatches=microbatches, top_k=2,
                         lp_capacity=lp, remat=remat)


def _layer_grads_reference(p, x, w, cfg):
    def loss(p, x):
        return (ref_moe.moe_apply(p, x, cfg) * w).sum()
    return tp.reference_jit(jax.grad(loss, argnums=(0, 1)),
                            cfg.lp_capacity)(p, x)


@pytest.mark.parametrize("top_k,lp", [(1, False), (2, True)])
def test_layer_gradients_with_dropped_tokens_match_the_reference(top_k, lp):
    """moe_apply's gradients for every parameter and the input, at
    capacity factor 1.25 on skewed tokens, so the sentinel row takes
    dropped tokens: the dispatch ``index_add_``, the combine's gather, the
    stable sort's values and the keep mask as a constant, against the
    reference's ``.at[].add`` and ``lax.top_k``."""
    kw = dict(top_k=top_k, capacity_factor=1.25, lp_capacity=lp)
    ref_cfg, cfg = tp.cfgs(SCOUT, **kw)
    _, lm = tp.port(SCOUT, **kw)
    rng = np.random.default_rng(top_k)
    x = rng.normal(size=(2, 48, 64)).astype(np.float32)
    x = x + np.float32(1.5) * rng.normal(size=64).astype(np.float32)
    # a loss of order one: the gradients' float32 sums stay within 1e-4
    w = (rng.normal(size=x.shape) / x.size).astype(np.float32)
    p_ref = {k: jnp.asarray(v[0])
             for k, v in tp.params_np(SCOUT)["layers"]["mlp"].items()}
    g_ref, gx_ref = _layer_grads_reference(p_ref, jnp.asarray(x),
                                           jnp.asarray(w), ref_cfg)
    p = lm.blocks[0].mlp
    xt = torch.from_numpy(x).requires_grad_()
    y = moe.moe_apply(p, xt, cfg)
    N = x.shape[0] * x.shape[1]
    r = moe.route(xt.detach().reshape(N, -1), p["router"], cfg,
                  moe._capacity(N, top_k, cfg.n_experts,
                                cfg.capacity_factor))
    assert not bool(r.keep.all())          # tokens were dropped
    names = list(p.keys())
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(),
                                [p[k] for k in names] + [xt])
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_ref[k]),
                                   atol=tp.GRAD_TOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(gx_ref),
                               atol=tp.GRAD_TOL, rtol=0)
    router = np.abs(grads[names.index("router")].numpy()).max()
    largest = max(np.abs(g.numpy()).max() for g in grads)
    if top_k == 1:     # p / p = 1: rounding noise only
        assert router < 1e-5 * largest
    else:
        assert router > 1e-2 * largest


def test_recompute_routes_as_the_forward(monkeypatch):
    tp.recompute_routes_as_the_forward(SCOUT, monkeypatch)


def test_without_remat_the_router_runs_once_a_layer(monkeypatch):
    cfg, lm = tp.port(SCOUT, lp_capacity=True, remat="none")
    calls = []
    real = moe.route
    monkeypatch.setattr(moe, "route",
                        lambda *a: calls.append(1) or real(*a))
    loss = lm.loss_fn(tp.to_torch(tp.batch(cfg, 2, 32, 5)))
    torch.autograd.grad(loss, list(lm.parameters()))
    assert len(calls) == cfg.n_layers
