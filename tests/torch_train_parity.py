"""Shared checks of the port's training path against the reference, one
family at a time (tests/test_torch_train_*.py).

A reduced config (float32) of the reference is initialized from
``PRNGKey(0)`` and carried into the port with ``interop.lm_from_reference``;
gradients and parameters come back with ``interop.lm_to_reference``.
Tokens, labels and the encdec and VLM families' frames and patches are
drawn with NumPy from a seed and fed to both packages: the reference's
own CLI feeds no frames or patches, so the port is held to the
reference's jitted ``loss_fn``, ``jax.grad`` and ``make_train_step``.

With ``lp_capacity`` the reference's router solves its batch of one
group, whose build differs in the last bit from the same row of a larger
batch (ROADMAP queue 3); as in tests/test_torch_moe.py it is patched, at
trace time, to solve the demand as row 0 of a two-group batch.

The bars: loss within 1e-5, gradients within 1e-4, parameters after
three optimizer steps within 1e-5 (``PARAM_TOL``).  The steps run at
``LR`` from the first (``WARMUP`` 1), so each moves every parameter by
about ``LR`` and an update wrong by a few percent fails the bar.  AdamW
divides each gradient entry by its own running size, so an entry whose
gradient is float32 rounding noise moves by a share of lr_t that the two
frameworks' sums decide differently (tests/test_torch_train.py); the
share scales with ``LR``, and at ``LR`` it stays below the bar (at most
4e-6 on these configs).  A router that gets no gradient makes every one
of its entries such an entry: see tests/test_torch_train_moe.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.core.lp_router as ref_lp_router
from repro.configs import get_config as ref_get_config
from repro.distributed.steps import make_train_step as ref_make_train_step
from repro.models import build_model as ref_build_model
from repro.optim import get_optimizer as ref_get_optimizer
from repro_torch.configs import get_config
from repro_torch.distributed import make_train_step
from repro_torch.interop import lm_from_reference, lm_to_reference
from repro_torch.models import moe
from repro_torch.optim import get_optimizer

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
LR = 1e-4
WARMUP = 1
STEPS = 3
N_FRAMES = 24        # whisper's stub frames in the reduced checks


def cfgs(arch, **kw):
    """(reference config, port config): the reduced ``arch`` with ``kw``."""
    return (dataclasses.replace(ref_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


@functools.cache
def params_np(arch):
    """The reference's reduced parameters as NumPy (remat, lp_capacity
    and the routing options leave the tree as it is)."""
    cfg, _ = cfgs(arch)
    model = ref_build_model(cfg)
    params = jax.jit(lambda key: model.init(key)[0])(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def port(arch, **kw):
    _, cfg = cfgs(arch, **kw)
    return cfg, lm_from_reference(cfg, params_np(arch), "cpu")


def batch(cfg, B, S, seed, n_frames=N_FRAMES):
    """NumPy inputs: tokens and labels (B, S) int32, whisper's frames
    (B, n_frames, D) and phi-3-vision's patches (B, n_patches, D)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    rows = {"encdec": ("frames", n_frames),
            "vlm": ("patches", cfg.n_patches)}.get(cfg.family)
    if rows:
        out[rows[0]] = rng.normal(size=(B, rows[1], cfg.d_model)) \
            .astype(np.float32)
    return out


def to_torch(b):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in b.items()}


def _two_group_router(real):
    def two_groups(demand, total_slots, c_max):
        both = jnp.concatenate([demand, demand], axis=0)
        return real(both, total_slots=total_slots, c_max=c_max)[:1]
    return two_groups


def reference_jit(fn, lp):
    """``jax.jit(fn)``, traced with the two-group router when ``lp``."""
    if not lp:
        return jax.jit(fn)
    real = ref_lp_router.expert_capacity_lp

    def call(*args):
        ref_lp_router.expert_capacity_lp = _two_group_router(real)
        try:
            return fn(*args)
        finally:
            ref_lp_router.expert_capacity_lp = real
    return jax.jit(call)


def max_diff(got_tree, want_tree):
    got, want = jax.tree.leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    return max(float(np.abs(np.asarray(g) - np.asarray(w)).max())
               for g, w in zip(got, want))


def check_loss_and_grads(arch, *, S=32, seed=0, **kw):
    """The port's loss and every gradient against the reference's jitted
    ``jax.value_and_grad(loss_fn)`` on one batch of 2 x S."""
    ref_cfg, cfg = cfgs(arch, **kw)
    model = ref_build_model(ref_cfg)
    params = jax.tree.map(jnp.asarray, params_np(arch))
    b = batch(cfg, 2, S, seed)
    loss_r, grads_r = reference_jit(jax.value_and_grad(model.loss_fn),
                                    cfg.lp_capacity)(
        params, jax.tree.map(jnp.asarray, b))
    _, lm = port(arch, **kw)
    loss = lm.loss_fn(to_torch(b))
    grads = torch.autograd.grad(loss, list(lm.parameters()))
    assert abs(float(loss.detach()) - float(loss_r)) < LOSS_TOL
    assert max_diff(lm_to_reference(lm, grads), grads_r) < GRAD_TOL
    return lm, grads


def check_train_steps(arch, *, microbatches, optimizer="adamw", S=32,
                      **kw):
    """``STEPS`` steps of the port's ``make_train_step`` against the
    reference's jitted one with the same optimizer (``LR``, ``WARMUP``),
    batches of 4 x S from seeds 10, 11, ...: losses within 1e-5 and
    grad norms within rel 1e-5 at every step, the parameters within
    ``PARAM_TOL`` after the last, and every leaf moved by it."""
    ref_cfg, cfg = cfgs(arch, **kw)
    model = ref_build_model(ref_cfg)
    params = jax.tree.map(jnp.asarray, params_np(arch))
    ref_opt = ref_get_optimizer(optimizer, lr=LR, warmup=WARMUP)
    ref_step = reference_jit(ref_make_train_step(
        model, ref_opt, microbatches=microbatches), cfg.lp_capacity)
    ref_state = ref_opt.init(params)
    _, lm = port(arch, **kw)
    opt = get_optimizer(optimizer, lr=LR, warmup=WARMUP)
    state = opt.init(list(lm.named_parameters()))
    step = make_train_step(lm, opt, microbatches=microbatches)
    for s in range(STEPS):
        b = batch(cfg, 4, S, 10 + s)
        params, ref_state, m_r = ref_step(params, ref_state,
                                          jax.tree.map(jnp.asarray, b))
        m = step(state, to_torch(b))
        assert abs(float(m["loss"]) - float(m_r["loss"])) < LOSS_TOL, s
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(m_r["grad_norm"]), rtol=1e-5)
    assert state["step"] == STEPS
    got = lm_to_reference(lm)
    assert max_diff(got, params) < PARAM_TOL
    moved = [float(np.abs(g - w).max()) for g, w in
             zip(jax.tree.leaves(got), jax.tree.leaves(params_np(arch)))]
    assert min(moved) > 0.5 * LR, moved
    return lm, state


def recompute_routes_as_the_forward(arch, monkeypatch):
    """Under ``remat="block"`` the backward recomputes each block, and the
    router's LP is solved again: the recompute gives the forward's demand,
    caps, experts, slots and keep mask bit for bit, layer by layer, so the
    gradients belong to the routing the loss was taken with."""
    cfg, lm = port(arch, lp_capacity=True, remat="block")
    calls = []
    real = moe.route

    def record(*args):
        calls.append(real(*args))
        return calls[-1]

    monkeypatch.setattr(moe, "route", record)
    loss = lm.loss_fn(to_torch(batch(cfg, 2, 32, 5)))
    forward = list(calls)
    assert len(forward) == cfg.n_layers
    torch.autograd.grad(loss, list(lm.parameters()))
    recompute = calls[len(forward):][::-1]    # the backward runs last-first
    assert len(recompute) == cfg.n_layers
    for layer, (f, r) in enumerate(zip(forward, recompute)):
        for name, a, b in zip(f._fields, f, r):
            assert torch.equal(a, b), (layer, name)
        assert r.caps is not None
