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

Every placement of the Sharder acts in the six families' cases
(``FAMILIES``, at (1, 2), (1, 4) and (2, 2)): the dense qwen3 and the MoE
scout with ``fsdp`` and ``seq_shard`` on (FSDP's ``residual`` over data
at (2, 2)), deepseek-v2's MLA with the router, falcon-mamba's
``d_inner`` (the plain scan), hymba's hybrid block and whisper's
encoder-decoder (its frames in the batch), each rank holding only its
blocks of the reduced model; the reference's parameters are placed by
its ``param_shardings``.  At (1, 4) the reduced configs' two KV heads
do not divide the line while the four query heads do: each rank reads
the KV head its query head needs.

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
rank of each line they are not sharded on (``check_replicas``, which
raises once one entry of one rank moves by an ulp).  The six families
take the same three steps at (2, 2), where every rule acts and AdamW's
moments are cut by ZeRO-1 over the data line, and the dense one at
(1, 2) too (the clip acts in every family's steps but whisper's, whose
gradient norm is about 0.74); the reduced llama3-405b (FSDP on, at
(2, 2)) and nemotron-4-340b (at (1, 4)) take them with their config's
Adafactor, whose factored statistics of the sharded leaves are summed
over the lines that cut them.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

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


ONE = (("n_layers", 1),)
FSDP = (("fsdp", True), ("seq_shard", True))
FAMILIES = (("qwen3-32b", ONE + FSDP), (SCOUT, _kw(False, True) + FSDP[:1]),
            (MLA, _kw(True, True) + FSDP[:1]), ("falcon-mamba-7b", ONE),
            ("hymba-1.5b", ONE),
            ("whisper-small", ONE + (("n_encoder_layers", 1),)))
MESHES = ((1, 2), (1, 4), (2, 2))
ARCHS = sorted({a for a, _ in FAMILIES})

CASES = [(SCOUT, mesh, _kw(lp, seq)) for mesh in MESHES
         for lp in (False, True) for seq in (False, True)] + \
    [(MLA, (1, 4), _kw(True, True))] + \
    [(arch, mesh, kw) for arch, kw in FAMILIES for mesh in MESHES]


def _one_layer(params):
    """The reference's reduced parameters cut to their first layer (of
    each stack)."""
    return {k: jax.tree.map(lambda a: a[:1], v)
            if k in ("layers", "enc_layers", "dec_layers") else v
            for k, v in params.items()}

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

REFERENCE_HEAD += """
    def placed(model, shd, params):
        kept = {}

        def init(key):
            p, kept["specs"] = model.init(key)
            return p
        jax.eval_shape(init, jax.random.PRNGKey(0))
        return jax.device_put(params, shd.param_shardings(kept["specs"]))
"""

REFERENCE = REFERENCE_HEAD + """
    out = {}
    for case in job["cases"]:
        arch, shape, kw = case
        batch = jax.tree.map(jnp.asarray, job.get("arch_batch", {}).get(
            arch, job["batch"]))
        cfg = dataclasses.replace(get_config(arch).reduced(), **dict(kw))
        params = jax.tree.map(jnp.asarray, job["params"][arch])
        if shape is None:
            model = build_model(cfg)
            got = jax.jit(jax.value_and_grad(model.loss_fn))(params, batch)
        else:
            mesh = make_mesh(shape, ("data", "model"))
            shd = Sharder(cfg, mesh)
            model = build_model(cfg, shd)
            params = placed(model, shd, params)
            with mesh:
                got = jax.jit(jax.value_and_grad(model.loss_fn))(params,
                                                                 batch)
        out[case] = (float(got[0]), jax.tree.map(np.asarray, got[1]))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
"""


STEP_CASES = [(SCOUT, mesh, _kw(True, True), mb)
              for mesh in ((1, 4), (2, 2)) for mb in (1, 2)] + \
    [(arch, (2, 2), kw, 1) for arch, kw in FAMILIES] + \
    [("qwen3-32b", (1, 2), FAMILIES[0][1], 1),
     ("llama3-405b", (2, 2), ONE + FSDP, 1),
     ("nemotron-4-340b", (1, 4), ONE, 1)]
# the cases whose sharded result may leave the single device's by design
# (a shard's capacity, or its own LP, drops other tokens): the MoE ones
MOE_CASES = [c for c in CASES if c[0] in (SCOUT, MLA)]

REFERENCE_STEPS = REFERENCE_HEAD + """
    from repro.distributed.steps import make_train_step
    from repro.optim import get_optimizer
    out = {}
    for case in job["cases"]:
        arch, shape, kw, microbatches = case
        cfg = dataclasses.replace(get_config(arch).reduced(), **dict(kw))
        params = jax.tree.map(jnp.asarray, job["params"][arch])
        mesh = make_mesh(shape, ("data", "model"))
        shd = Sharder(cfg, mesh)
        model = build_model(cfg, shd)
        params = placed(model, shd, params)
        opt = get_optimizer(cfg.optimizer, lr=job["lr"],
                            warmup=job["warmup"])
        state = opt.init(params)
        step = jax.jit(make_train_step(model, opt,
                                       microbatches=microbatches))
        losses, norms = [], []
        with mesh:
            for b in job.get("arch_batches", {}).get(arch,
                                                     job["batches"]):
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


def _chunks(items, n):
    return [items[i::n] for i in range(n)]


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Every world and reference subprocess of the file, started side by
    side (the reference's compiles dominate): the loss-and-gradient
    waiters and the train-step waiters."""
    tmp = tmp_path_factory.mktemp("ep")
    step_archs = sorted({c[0] for c in STEP_CASES})
    archs = sorted(set(ARCHS) | set(step_archs))
    # the reference's draws, side by side (XLA compiles without the GIL)
    with ThreadPoolExecutor(len(archs)) as pool:
        params = dict(zip(archs, pool.map(
            lambda a: _one_layer(tp.params_np(a)), archs)))
    batch = tp.batch(tp.cfgs(SCOUT)[1], B, S, 0)
    whisper = tp.cfgs("whisper-small")[1]
    job = {"params": params, "batch": batch, "cases": CASES,
           "arch_batch": {"whisper-small": tp.batch(whisper, B, S, 0)}}
    singles = sorted(set(_single(c) for c in MOE_CASES), key=str)
    refs = [tm.spawn_reference(REFERENCE, 4, tmp, f"ref{i}",
                               dict(job, cases=part))
            for i, part in enumerate(_chunks(CASES + singles, 6))]
    worlds = [tm.spawn(n, "loss_and_grads", job, tmp, f"world{n}")
              for n in (2, 4)]
    steps = {"params": {a: params[a] for a in step_archs}, "lr": tp.LR,
             "warmup": tp.WARMUP, "cases": STEP_CASES,
             "batches": [tp.batch(tp.cfgs(SCOUT)[1], 2 * B, S, 10 + s)
                         for s in range(tp.STEPS)],
             "arch_batches": {"whisper-small": [
                 tp.batch(whisper, 2 * B, S, 10 + s)
                 for s in range(tp.STEPS)]}}
    step_refs = [tm.spawn_reference(REFERENCE_STEPS, 4, tmp, f"steps{i}",
                                    dict(steps, cases=part))
                 for i, part in enumerate(_chunks(STEP_CASES, 6))]
    step_worlds = [tm.spawn(n, "train_steps", steps, tmp,
                            f"step_world{n}")
                   for n in (2, 4)]
    return (params, job, singles, refs, worlds), (step_refs, step_worlds)


@pytest.fixture(scope="module")
def runs(started):
    """{case: (loss, grads[, replicated equal])} of the port's worlds,
    the reference's meshes and both single devices."""
    (params, job, singles, refs, worlds), _ = started
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
        batch = job["arch_batch"].get(arch, job["batch"])
        loss = lm.loss_fn(tp.to_torch(batch))
        grads = torch.autograd.grad(loss, list(lm.parameters()))
        port[case] = (float(loss.detach()), tp.lm_to_reference(lm, grads))
    return port, ref


@pytest.fixture(scope="module")
def step_runs(started):
    """{case: (losses, grad norms, parameters[, replicated leaves
    checked])} of the port's sharded train step and the reference's."""
    _, (step_refs, step_worlds) = started
    ref, port = {}, {}
    for r in step_refs:
        ref.update(r())
    for w in step_worlds:
        port.update(w())
    return port, ref


def _gap(a, b):
    return max(abs(a[0] - b[0]) / LOSS_TOL, tp.max_diff(a[1], b[1]) / GRAD_TOL)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_sharded_loss_and_gradients_match_the_reference(runs, case):
    port, ref = runs
    loss, grads, same = port[case]
    assert abs(loss - ref[case][0]) < LOSS_TOL, (loss, ref[case][0])
    assert tp.max_diff(grads, ref[case][1]) < GRAD_TOL
    assert same, "replicated gradients differ across ranks"


@pytest.mark.parametrize("case", MOE_CASES, ids=str)
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
    # the clip acts, but in whisper's steps (gradient norm about 0.74)
    assert min(ref_norms) > 1.0 or case[0] == "whisper-small", ref_norms
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(norms, ref_norms, rtol=1e-5)
    assert tp.max_diff(params, ref_params) < tp.PARAM_TOL
    # every leaf is compared over each line that does not shard it
    assert checked == _replicated_pairs(case)
    # and one ulp of one entry on one rank of the model line is caught
    assert caught


def _replicated_pairs(case):
    """The (leaf, line) pairs of ``case``'s model that ``check_replicas``
    compares: each leaf once for each line of several ranks that does
    not shard it."""
    from repro_torch.distributed.sharding import Mesh, Sharder, param_spec
    arch, shape, kw, _ = case
    cfg = dataclasses.replace(tp.cfgs(arch)[1], **dict(kw))
    shd = Sharder(cfg, Mesh(shape, ("data", "model")))
    lm = tp.lm_from_reference(cfg, _one_layer(tp.params_np(arch)), "cpu")
    return sum(size > 1 and ax not in shd.shard_axes(param_spec(n, cfg))
               for n, _ in lm.named_parameters()
               for ax, size in zip(("data", "model"), shape))


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
