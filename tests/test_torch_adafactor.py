"""The port's Adafactor (``optim/adafactor.py``) against the reference's.

The reference updates its stacked tree (layers on axis 0), so a per-layer
vector is a factored (L, D) leaf there and the clip's RMS spans the whole
stack; the port groups its per-layer parameters by name into those
leaves.  The trees here hold a per-layer 1-D leaf, an (L, E, D, F) expert
leaf, an (L, D, F) leaf, unstacked matrices and a vector, with gradient
draws that make the clip bind; the port runs with its row blocks as
shipped and cut small, so the blocked walk is checked too."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_parity as tp
from repro.optim import adafactor as ref_adafactor
from repro_torch.optim import adafactor, get_optimizer

# the module (the package exports the function under the same name)
af = importlib.import_module("repro_torch.optim.adafactor")

L, E, D, F, V = 3, 4, 8, 6, 20
LEAVES = (("norm1", "scale"), ("mlp", "w_gate"), ("attn", "wq"))


def _tree(rng, scale=1.0):
    def draw(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {"embed": {"table": draw(V, D)}, "final_norm": {"scale": draw(D)},
            "layers": {"norm1": {"scale": draw(L, D)},
                       "mlp": {"w_gate": draw(L, E, D, F)},
                       "attn": {"wq": draw(L, D, F)}}}


def _named(tree):
    """The port's (name, array) list of a stacked tree, in the order of a
    model's named_parameters: unstacked leaves, then layer by layer."""
    out = [("embed.table", tree["embed"]["table"]),
           ("final_norm.scale", tree["final_norm"]["scale"])]
    for i in range(L):
        out += [(f"blocks.{i}.{g}.{k}", tree["layers"][g][k][i])
                for g, k in LEAVES]
    return out


def _reference_rms(g_tree, state, step, decay=0.8, eps=1e-30):
    """The reference's RMS(u) of the stacked mlp leaf at ``step``, from its
    state after the step (to show the clip binds)."""
    v = state["v"]["layers"]["mlp"]["w_gate"]
    g = np.asarray(g_tree["layers"]["mlp"]["w_gate"], np.float64)
    vr, vc = np.asarray(v["vr"], np.float64), np.asarray(v["vc"], np.float64)
    denom = np.sqrt(vr[..., None] * vc[..., None, :]
                    / vr.mean(-1, keepdims=True)[..., None])
    return float(np.sqrt(np.mean(np.square(g / denom))))


@pytest.mark.parametrize("block", [af.BLOCK, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_matches_the_reference_on_the_stacked_tree(block, dtype,
                                                          monkeypatch):
    monkeypatch.setattr(af, "BLOCK", block)
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    ref = ref_adafactor(lr=0.05, warmup=2)
    opt = adafactor(lr=0.05, warmup=2)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    state = ref.init(params)
    tparams = [torch.from_numpy(a).to(getattr(torch, dtype))
               for _, a in _named(tree)]
    tstate = opt.init([(n, t) for (n, _), t in zip(_named(tree), tparams)])
    rms = []
    for step in range(5):
        # small gradients, then a spike on a few expert entries: the
        # stacked leaf's RMS(u) passes the clip
        g_tree = _tree(rng, scale=0.01)
        if step == 3:
            g_tree["layers"]["mlp"]["w_gate"][1, 2, :3] *= 1000.0
        params, state = ref.update(
            jax.tree.map(lambda a: jnp.asarray(a, dtype), g_tree), state,
            params)
        opt.update([torch.from_numpy(a).to(getattr(torch, dtype))
                    for _, a in _named(g_tree)], tstate, tparams)
        rms.append(_reference_rms(g_tree, state, step))
    assert max(rms) > 1.0, rms
    want = _named(jax.tree.map(lambda a: np.asarray(a, np.float32), params))
    for t, (name, w) in zip(tparams, want):
        assert t.dtype == getattr(torch, dtype)
        atol = 1e-6 if dtype == "float32" else 0.0
        np.testing.assert_allclose(t.float().numpy(), w, rtol=0,
                                   atol=atol, err_msg=name)
    # the per-layer vector is factored across the layers, as the stacked
    # reference leaf is
    groups = {g["key"]: g for g in tstate["groups"]}
    norm = groups["blocks.norm1.scale"]
    ref_v = state["v"]["layers"]["norm1"]["scale"]
    assert norm["kind"] == "stacked_vector"
    np.testing.assert_allclose(norm["vr"].numpy(), np.asarray(ref_v["vr"]),
                               rtol=1e-5)
    np.testing.assert_allclose(norm["vc"].numpy(), np.asarray(ref_v["vc"]),
                               rtol=1e-5)


def test_state_is_rows_plus_columns_a_group():
    rng = np.random.default_rng(1)
    named = [(n, torch.from_numpy(a)) for n, a in _named(_tree(rng))]
    state = adafactor().init(named)
    kinds = {g["key"]: g["kind"] for g in state["groups"]}
    assert kinds == {(0,): "matrix", (1,): "vector",
                     "blocks.norm1.scale": "stacked_vector",
                     "blocks.mlp.w_gate": "matrix",
                     "blocks.attn.wq": "matrix"}

    def size(g):
        if g["kind"] == "vector":
            return sum(v.numel() for v in g["v"])
        if g["kind"] == "stacked_vector":
            return g["vr"].numel() + g["vc"].numel()
        return sum(a.numel() + b.numel() for a, b in zip(g["vr"], g["vc"]))

    want = {(0,): V + D, (1,): D, "blocks.norm1.scale": L + D,
            "blocks.mlp.w_gate": L * E * (D + F),
            "blocks.attn.wq": L * (D + F)}
    assert {g["key"]: size(g) for g in state["groups"]} == want
    # unnamed tensors are groups of their own, as unstacked leaves
    alone = adafactor().init([t for _, t in named])
    assert len(alone["groups"]) == len(named)


def test_get_optimizer_builds_adafactor():
    opt = get_optimizer("adafactor", lr=1e-2)
    p = [torch.ones(4, 3)]
    state = opt.init(p)
    opt.update([torch.full((4, 3), 0.5)], state, p)
    assert state["step"] == 1 and float(p[0].max()) < 1.0


@pytest.mark.parametrize("microbatches,remat", [(1, "none"), (2, "block")])
def test_reduced_llama3_train_step_matches_the_reference(microbatches,
                                                        remat):
    """llama3-405b's config selects Adafactor: three make_train_step steps
    of the reduced model against the reference's."""
    tp.check_train_steps("llama3-405b", microbatches=microbatches,
                         optimizer="adafactor", remat=remat)
