"""The port's expert-parallel MoE (``models/moe.py`` with a sharder) and
its data-parallel loss and gradients (``distributed/steps.py``
``loss_and_grads``) over gloo worlds on the CPU, against the reference's
``shard_map`` path on an XLA host mesh of the same shape.

Two worlds are spawned beside one another (tests/torch_mesh.py): two
ranks for the (1, 2) mesh and four for (1, 4) and (2, 2); the reference
runs the same cases in subprocesses on 4 host devices, its router patched
at trace time to solve each shard's demand as row 0 of a two-group batch
(tests/torch_train_parity.py: its batch of one is built otherwise).  The
reduced llama4-scout runs at top-2 (at top-1 the router's gradient is
rounding noise), with ``lp_capacity`` on and off and ``seq_shard`` on
and off; the reduced deepseek-v2 (MLA) at (1, 4) with the router and
``seq_shard`` on, as its config ships them.
Both packages get the reference's parameters from ``PRNGKey(0)``, cut to
the first layer (the reference's compiles take most of the file's time),
and one batch of 4 x 32 tokens.  Bars: the loss within 1e-5, every gradient
(gathered to whole arrays) within 1e-4, and the replicated leaves'
gradients equal on every rank.

With ``seq_shard`` off every model rank routes the same tokens; with it
on, each routes its slice of the sequence.  With ``lp_capacity`` each
shard solves its own LP on its own tokens, so at (2, 2) the sharded
result moves away from the single device's by design, in the reference
as in the port; where the reference's sharded run matches its single
device, so does the port's.  The exchanges' backward rules are checked
on a stand-in line here too.

The sharded train step (``make_train_step(shd=)``) is held to the
reference's jitted ``make_train_step`` on the same host mesh: three AdamW
steps of the reduced llama4-scout (top-2, the router and ``seq_shard``
on) at (1, 4) and (2, 2), one and two microbatches of 8 x 32 tokens
(two rows a rank and microbatch at (2, 2), so each shard's LP pools
rows and a wrong split of the microbatches shows), each step's gradient
norm about 19, so the clip acts at every step.  Bars: the losses within
1e-5, the gradient norms within 1e-5 relative, the parameters within
1e-5 (tests/torch_train_parity.py), the replicated leaves equal on every
rank of the model line (``check_replicas``, which raises once one entry
of one rank moves by an ulp).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_mesh as tm
import torch_train_parity as tp
from repro_torch.distributed.sharding import (AllToAll, EnterReplicated,
                                              GatherSeq, LeaveReplicated,
                                              ScatterSeq)

SCOUT = "llama4-scout-17b-a16e"
MLA = "deepseek-v2-236b"
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
B, S = 4, 32


def _kw(lp, seq, top_k=2):
    return (("n_layers", 1), ("top_k", top_k), ("lp_capacity", lp),
            ("seq_shard", seq))


CASES = [(SCOUT, mesh, _kw(lp, seq)) for mesh in ((1, 2), (1, 4), (2, 2))
         for lp in (False, True) for seq in (False, True)] + \
    [(MLA, (1, 4), _kw(True, True))]


def _one_layer(params):
    """The reference's reduced parameters cut to their first layer."""
    return dict(params, layers=jax.tree.map(lambda a: a[:1],
                                            params["layers"]))

# the reference's setup, its router patched as the module docstring says
REFERENCE_HEAD = """
    import dataclasses, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    import repro.core.lp_router as lp_router
    from repro.configs import get_config
    from repro.distributed.sharding import Sharder, make_mesh
    from repro.models import build_model
    real = lp_router.expert_capacity_lp

    def two_groups(demand, total_slots, c_max):
        both = jnp.concatenate([demand, demand], axis=0)
        return real(both, total_slots=total_slots, c_max=c_max)[:1]

    lp_router.expert_capacity_lp = two_groups
    with open(sys.argv[1], "rb") as f:
        job = pickle.load(f)
"""

REFERENCE = REFERENCE_HEAD + """
    batch = jax.tree.map(jnp.asarray, job["batch"])
    out = {}
    for case in job["cases"]:
        arch, shape, kw = case
        cfg = dataclasses.replace(get_config(arch).reduced(), **dict(kw))
        params = jax.tree.map(jnp.asarray, job["params"][arch])
        if shape is None:
            model = build_model(cfg)
            got = jax.jit(jax.value_and_grad(model.loss_fn))(params, batch)
        else:
            mesh = make_mesh(shape, ("data", "model"))
            model = build_model(cfg, Sharder(cfg, mesh))
            with mesh:
                got = jax.jit(jax.value_and_grad(model.loss_fn))(params,
                                                                 batch)
        out[case] = (float(got[0]), jax.tree.map(np.asarray, got[1]))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
"""


STEP_CASES = [(SCOUT, mesh, _kw(True, True), mb)
              for mesh in ((1, 4), (2, 2)) for mb in (1, 2)]

REFERENCE_STEPS = REFERENCE_HEAD + """
    from repro.distributed.steps import make_train_step
    from repro.optim import get_optimizer
    out = {}
    for case in job["cases"]:
        arch, shape, kw, microbatches = case
        cfg = dataclasses.replace(get_config(arch).reduced(), **dict(kw))
        params = jax.tree.map(jnp.asarray, job["params"][arch])
        mesh = make_mesh(shape, ("data", "model"))
        model = build_model(cfg, Sharder(cfg, mesh))
        opt = get_optimizer("adamw", lr=job["lr"], warmup=job["warmup"])
        state = opt.init(params)
        step = jax.jit(make_train_step(model, opt,
                                       microbatches=microbatches))
        losses, norms = [], []
        with mesh:
            for b in job["batches"]:
                params, state, m = step(params, state,
                                        jax.tree.map(jnp.asarray, b))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        out[case] = (losses, norms, jax.tree.map(np.asarray, params))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
"""


def _single(case):
    """The single-device case of the same config."""
    return (case[0], None, case[2])


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Every world and reference subprocess of the file, started side by
    side (the reference's compiles dominate): the loss-and-gradient
    waiters and the train-step waiters."""
    tmp = tmp_path_factory.mktemp("ep")
    params = {a: _one_layer(tp.params_np(a)) for a in (SCOUT, MLA)}
    batch = tp.batch(tp.cfgs(SCOUT)[1], B, S, 0)
    job = {"params": params, "batch": batch, "cases": CASES}
    singles = sorted(set(_single(c) for c in CASES), key=str)
    parts = [CASES[0:4], CASES[4:8], CASES[8:] + singles[:1],
             singles[1:]]
    refs = [tm.spawn_reference(REFERENCE, 4, tmp, f"ref{i}",
                               dict(job, cases=part))
            for i, part in enumerate(parts)]
    worlds = [tm.spawn(n, "loss_and_grads", job, tmp, f"world{n}")
              for n in (2, 4)]
    steps = {"params": {SCOUT: params[SCOUT]}, "lr": tp.LR,
             "warmup": tp.WARMUP, "cases": STEP_CASES,
             "batches": [tp.batch(tp.cfgs(SCOUT)[1], 2 * B, S, 10 + s)
                         for s in range(tp.STEPS)]}
    step_refs = [tm.spawn_reference(REFERENCE_STEPS, 4, tmp, f"steps{i}",
                                    dict(steps, cases=STEP_CASES[i::2]))
                 for i in range(2)]
    step_world = tm.spawn(4, "train_steps", steps, tmp, "steps")
    return (params, batch, singles, refs, worlds), (step_refs, step_world)


@pytest.fixture(scope="module")
def runs(started):
    """{case: (loss, grads[, replicated equal])} of the port's worlds,
    the reference's meshes and both single devices."""
    (params, batch, singles, refs, worlds), _ = started
    port = {}
    for w in worlds:
        port.update(w())
    ref = {}
    for r in refs:
        ref.update(r())
    for case in singles:
        arch, _, kw = case
        ref_cfg, cfg = tp.cfgs(arch, **dict(kw))
        lm = tp.lm_from_reference(cfg, params[arch], "cpu")
        loss = lm.loss_fn(tp.to_torch(batch))
        grads = torch.autograd.grad(loss, list(lm.parameters()))
        port[case] = (float(loss.detach()), tp.lm_to_reference(lm, grads))
    return port, ref


@pytest.fixture(scope="module")
def step_runs(started):
    """{case: (losses, grad norms, parameters[, replicated leaves
    checked])} of the port's sharded train step and the reference's."""
    _, (step_refs, step_world) = started
    ref = {}
    for r in step_refs:
        ref.update(r())
    return step_world(), ref


def _gap(a, b):
    return max(abs(a[0] - b[0]) / LOSS_TOL, tp.max_diff(a[1], b[1]) / GRAD_TOL)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_sharded_loss_and_gradients_match_the_reference(runs, case):
    port, ref = runs
    loss, grads, same = port[case]
    assert abs(loss - ref[case][0]) < LOSS_TOL, (loss, ref[case][0])
    assert tp.max_diff(grads, ref[case][1]) < GRAD_TOL
    assert same, "replicated gradients differ across ranks"


@pytest.mark.parametrize("case", CASES, ids=str)
def test_where_the_reference_follows_its_single_device_so_does_the_port(
        runs, case):
    port, ref = runs
    single = _single(case)
    # away from it where a shard's capacity (or its own LP) drops other
    # tokens than the single device's
    assert (_gap(ref[case], ref[single]) < 1) == \
        (_gap(port[case], port[single]) < 1)


def test_per_shard_lp_moves_the_result_at_two_by_two(runs):
    """At (2, 2) with the router each data shard solves its own LP: the
    loss leaves the single device's in both packages."""
    port, ref = runs
    case = (SCOUT, (2, 2), _kw(True, False))
    assert abs(ref[case][0] - ref[_single(case)][0]) > 1e-3
    assert abs(port[case][0] - port[_single(case)][0]) > 1e-3


@pytest.mark.parametrize("case", STEP_CASES, ids=str)
def test_sharded_train_steps_match_the_reference(step_runs, case):
    port, ref = step_runs
    losses, norms, params, checked, caught = port[case]
    ref_losses, ref_norms, ref_params = ref[case]
    assert min(ref_norms) > 1.0, ref_norms      # the clip acts
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(norms, ref_norms, rtol=1e-5)
    assert tp.max_diff(params, ref_params) < tp.PARAM_TOL
    # every leaf but the expert slabs is replicated over the model line
    assert checked == len(jax.tree.leaves(params)) - 3
    # and one ulp of one entry on one rank of it is caught
    assert caught


class Line:
    """A stand-in model line of two ranks that hold the same tensors:
    what the exchanges' backward rules see."""
    size, index = 2, 1

    def all_to_all(self, t):
        return t.flip(0)

    def all_gather(self, t, dim):
        return torch.cat([t, t], dim)

    def all_reduce(self, t):
        return 2 * t


def test_exchange_backward_rules():
    line = Line()
    x = torch.arange(24.0).reshape(2, 4, 3).requires_grad_()
    g = torch.randn(2, 4, 3)
    # all-to-all: the backward is the same exchange of the cotangent
    (gx,) = torch.autograd.grad(AllToAll.apply(x, line), x, g)
    assert torch.equal(gx, g.flip(0))
    # the sequence slice: rank 1 of 2 takes positions 2..3; its backward
    # gathers the slices' cotangents
    y = ScatterSeq.apply(x, line)
    assert torch.equal(y, x[:, 2:].detach())
    (gx,) = torch.autograd.grad(y, x, g[:, :2])
    assert torch.equal(gx, torch.cat([g[:, :2], g[:, :2]], 1))
    # the gather's backward takes this rank's slice and does not sum
    z = GatherSeq.apply(x, line)
    (gx,) = torch.autograd.grad(z, x, torch.cat([g, 2 * g], 1))
    assert torch.equal(gx, 2 * g)
    # the replicated region: the output's cotangent split, the input's
    # summed over the line
    (gx,) = torch.autograd.grad(LeaveReplicated.apply(x, line), x, g)
    assert torch.equal(gx, g / 2)
    (gx,) = torch.autograd.grad(EnterReplicated.apply(x, line), x, g)
    assert torch.equal(gx, 2 * g)


def test_moe_without_a_sharded_expert_axis_is_the_one_device_layer():
    """A sharder whose mesh has one model rank (or none) leaves moe_apply
    the tp = 1 body, bit for bit."""
    from repro_torch.distributed.sharding import Mesh, Sharder
    from repro_torch.models import moe
    cfg, lm = tp.port(SCOUT, top_k=2, lp_capacity=True)
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().
                    manual_seed(0))
    p = lm.blocks[0].mlp
    want = moe.moe_apply(p, x, cfg)
    for mesh in (None, Mesh((4, 1), ("data", "model"))):
        shd = Sharder(dataclasses.replace(cfg, seq_shard=True), mesh)
        assert shd.expert_axis() is None
        assert torch.equal(moe.moe_apply(p, x, cfg, shd=shd), want)
