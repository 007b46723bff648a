"""The port's MoE layer (``models/moe.py``) and the MoE LM
(llama4-scout-17b-a16e) against the reference.

The reference's reduced scout (float32, 2 layers, 8 experts of 32, top-1
plus one shared expert) is initialized from ``PRNGKey(0)`` and carried
into the port with ``interop.lm_from_reference``; inputs are made with
NumPy from a seed.  Outputs, logits and caches are held to atol 1e-5:
float32 products summed in other orders, the bar of the other LM tests.

Routing follows the reference decision by decision: the same experts
(ties broken to the lower index, as ``jax.lax.top_k`` does), the same
slots, the same keep mask, so a dropped token is dropped in both.  With
``lp_capacity`` the reference solves the router's LP as a batch of one
group, and its batch-of-one build differs from the same row of a larger
batch in the last bit (ROADMAP queue 3); the port's is batch-shape
invariant.  So the layer with ``lp_capacity`` is held against the
reference with its router patched to solve the demand as a row of a
two-group batch (``_two_group_router``), and the unpatched reference is
held to the same bar in a test of its own, which shows the last-bit
difference moves no keep decision on these inputs.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.lp_router as ref_lp_router
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import moe as ref_moe
from repro_torch.configs import get_config
from repro_torch.interop import lm_from_reference, lm_to_reference
from repro_torch.kernels import simplex_tile
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import pad_kv, serve
from repro_torch.models import LM, build_model
from repro_torch.models import moe
from repro_torch.models.attention import KVCache

ATOL = 1e-5
ARCH = "llama4-scout-17b-a16e"
N_TOK = (2, 48)             # the layer's input: 96 tokens
P = 40                      # prompt length of the LM tests


def _cfgs(**kw):
    return (dataclasses.replace(ref_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


@functools.cache
def _params_np():
    """The reference's reduced scout parameters as NumPy (lp_capacity,
    top_k and capacity_factor leave the parameter tree as it is)."""
    cfg, _ = _cfgs()
    params, _ = ref_build_model(cfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _port(**kw):
    _, cfg = _cfgs(**kw)
    return cfg, lm_from_reference(cfg, _params_np(), "cpu")


def _layer_params(layer=0):
    return {k: jnp.asarray(v[layer])
            for k, v in _params_np()["layers"]["mlp"].items()}


def _x(seed=0, hot=0.0, shape=N_TOK):
    """(B, S, 64) float32 tokens; ``hot`` adds a shared direction to every
    token, which skews the routing toward a few experts."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape + (64,)).astype(np.float32)
    return x + np.float32(hot) * rng.normal(size=64).astype(np.float32)


def _close(got, want, name=""):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=0, err_msg=name)


def _two_group_router(real):
    """The reference's router solving the (1, E) demand as row 0 of a
    two-group batch (the demand twice)."""
    def two_groups(demand, total_slots, c_max):
        both = jnp.concatenate([demand, demand], axis=0)
        return real(both, total_slots=total_slots, c_max=c_max)[:1]
    return two_groups


@pytest.fixture
def two_group_router(monkeypatch):
    """Patch the router the reference's MoE layer imports at call time."""
    monkeypatch.setattr(ref_lp_router, "expert_capacity_lp",
                        _two_group_router(ref_lp_router.expert_capacity_lp))


def _ref_layer(x, cfg, layer=0):
    return np.asarray(ref_moe.moe_apply(_layer_params(layer),
                                        jnp.asarray(x), cfg))


def _port_layer(x, cfg, lm, layer=0):
    with torch.inference_mode():
        return moe.moe_apply(lm.blocks[layer].mlp, torch.from_numpy(x), cfg)


def _routing(x, cfg, lm, layer=0):
    N = x.shape[0] * x.shape[1]
    C = moe._capacity(N, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    with torch.inference_mode():
        return moe.route(torch.from_numpy(x).reshape(N, -1),
                         lm.blocks[layer].mlp["router"], cfg, C)


def _ref_routing(x, cfg, layer=0):
    """The reference's routing, step by step as its ``_moe_local`` takes
    it: (experts (N*K,), slots (N*K,), keep (N*K,))."""
    p = _layer_params(layer)
    xs = jnp.asarray(x.reshape(-1, x.shape[-1]))
    N, K, E = xs.shape[0], cfg.top_k, cfg.n_experts
    probs = jax.nn.softmax((xs @ p["router"]).astype(jnp.float32), axis=-1)
    _, top_e = jax.lax.top_k(probs, K)
    flat_e = top_e.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    ranks = jnp.cumsum(onehot, axis=0) - onehot
    slot = jnp.take_along_axis(ranks, flat_e[:, None], 1)[:, 0]
    C = ref_moe._capacity(N, K, E, cfg.capacity_factor)
    if cfg.lp_capacity:
        caps = ref_lp_router.expert_capacity_lp(
            probs.sum(0)[None, :] * K, total_slots=float(N * K),
            c_max=float(C))[0]
        keep = slot < jnp.take(caps, flat_e)
    else:
        keep = slot < C
    return np.asarray(flat_e), np.asarray(slot), np.asarray(keep)


# ---- parameters and capacity ---------------------------------------------------

def test_moe_init_has_the_reference_names_shapes_and_dtypes():
    for cfg_of in (lambda a: a, lambda a: a.reduced()):
        ref_cfg, cfg = cfg_of(ref_get_config(ARCH)), cfg_of(get_config(ARCH))
        want = jax.eval_shape(lambda k: ref_moe.moe_init(k, ref_cfg)[0],
                              jax.ShapeDtypeStruct((2,), jnp.uint32))
        got = moe.moe_init(None, cfg, torch.device("meta"))
        assert set(got) == set(want) == {"router", "w_gate", "w_up",
                                         "w_down", "ws_gate", "ws_up",
                                         "ws_down"}
        for k, w in want.items():
            assert tuple(got[k].shape) == w.shape, k
            assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype)
    full = moe.moe_init(None, get_config(ARCH), torch.device("meta"))
    assert tuple(full["w_gate"].shape) == (16, 5120, 8192)
    assert tuple(full["ws_down"].shape) == (8192, 5120)
    assert full["w_down"].dtype == torch.bfloat16


def test_moe_init_draws_at_the_reference_scales():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), d_model=256,
                              d_ff_expert=512)
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, cfg, torch.device("cpu"))
    for name, fan_in in (("router", 256), ("w_gate", 256), ("w_up", 256),
                         ("w_down", 512), ("ws_gate", 256), ("ws_up", 256),
                         ("ws_down", 512)):
        assert abs(float(p[name].std()) * fan_in ** 0.5 - 1.0) < 0.05, name
        assert abs(float(p[name].mean())) * fan_in ** 0.5 < 0.1, name


@pytest.mark.parametrize("n_tok", [1, 4, 7, 96, 8192])
@pytest.mark.parametrize("k,E", [(1, 8), (2, 8), (1, 16), (6, 160)])
@pytest.mark.parametrize("cf", [1.0, 1.25, 100.0])
def test_capacity_is_the_reference_one(n_tok, k, E, cf):
    assert moe._capacity(n_tok, k, E, cf) == \
        ref_moe._capacity(n_tok, k, E, cf)


# ---- the layer -----------------------------------------------------------------

@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cf", [1.25, 100.0])
@pytest.mark.parametrize("lp", [False, True])
def test_layer_matches_the_reference(top_k, cf, lp, two_group_router):
    """_moe_local's routing decision by decision and moe_apply (routed
    plus shared experts) within atol 1e-5; at capacity factor 1.25 the
    skewed inputs drop tokens, at 100 only the LP's caps do."""
    ref_cfg, cfg = _cfgs(top_k=top_k, capacity_factor=cf, lp_capacity=lp)
    _, lm = _port(top_k=top_k, capacity_factor=cf, lp_capacity=lp)
    x = _x(seed=top_k, hot=1.5)
    r = _routing(x, cfg, lm)
    e, s, keep = _ref_routing(x, ref_cfg)
    np.testing.assert_array_equal(r.expert.numpy(), e)
    np.testing.assert_array_equal(r.slot.numpy(), s)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    if cf == 1.25 or lp:
        assert not keep.all()           # tokens dropped
    else:
        assert keep.all()
    assert (r.caps is not None) == lp
    got = _port_layer(x, cfg, lm)
    _close(got, _ref_layer(x, ref_cfg), "moe_apply")
    N = x.shape[0] * x.shape[1]
    with torch.inference_mode():
        local = moe._moe_local(torch.from_numpy(x).reshape(N, 64),
                               lm.blocks[0].mlp, cfg)
    want = ref_moe._moe_local(jnp.asarray(x.reshape(N, 64)),
                              {k: v for k, v in _layer_params().items()
                               if not k.startswith("ws_")},
                              ref_cfg, tp=1, tp_axis=None)
    _close(local, want, "_moe_local")


def test_a_dropped_token_gets_only_the_shared_experts():
    _, cfg = _cfgs(capacity_factor=1.25)
    _, lm = _port(capacity_factor=1.25)
    x = _x(seed=1, hot=1.5)
    r = _routing(x, cfg, lm)
    N = x.shape[0] * x.shape[1]
    with torch.inference_mode():
        routed = moe._moe_local(torch.from_numpy(x).reshape(N, 64),
                                lm.blocks[0].mlp, cfg)
    dropped = ~r.keep
    assert dropped.any()
    assert float(routed[dropped].abs().max()) == 0.0
    assert (routed[~dropped].abs().sum(-1) > 0).all()


@pytest.mark.parametrize("top_k", [1, 2])
def test_an_exact_tie_picks_the_experts_jax_picks(top_k):
    """A zero router gives every expert the probability 1/E exactly: the
    port's stable sort and jax.lax.top_k both take experts 0..k-1 (a
    plain torch.topk need not), so all tokens crowd the first k experts
    and the capacity drops the rest, as in the reference."""
    ref_cfg, cfg = _cfgs(top_k=top_k)
    _, lm = _port(top_k=top_k)
    x = _x(seed=5)
    with torch.no_grad():
        lm.blocks[0].mlp["router"].zero_()
    params = dict(_layer_params(), router=jnp.zeros((64, 8), jnp.float32))
    probs = jnp.full((x.shape[0] * x.shape[1], 8), 1 / 8, jnp.float32)
    want_e = np.asarray(jax.lax.top_k(probs, top_k)[1]).reshape(-1)
    r = _routing(x, cfg, lm)
    np.testing.assert_array_equal(r.expert.numpy(), want_e)
    assert set(want_e.tolist()) == set(range(top_k))
    assert not r.keep.all()
    got = _port_layer(x, cfg, lm)
    want = ref_moe.moe_apply(params, jnp.asarray(x), ref_cfg)
    _close(got, want, "tied moe_apply")


def test_the_unpatched_reference_router_moves_no_keep_decision():
    """The reference's router solves its batch of one with XLA's
    batch-of-one build, whose caps may differ from the two-group row in
    the last bit (ROADMAP queue 3).  On every input of the layer tests,
    its keep mask and output equal the port's all the same: the caps'
    last bit moves no integer slot across them."""
    for top_k in (1, 2):
        for cf in (1.25, 100.0):
            ref_cfg, cfg = _cfgs(top_k=top_k, capacity_factor=cf,
                                 lp_capacity=True)
            _, lm = _port(top_k=top_k, capacity_factor=cf, lp_capacity=True)
            x = _x(seed=top_k, hot=1.5)
            np.testing.assert_array_equal(_routing(x, cfg, lm).keep.numpy(),
                                          _ref_routing(x, ref_cfg)[2])
            _close(_port_layer(x, cfg, lm), _ref_layer(x, ref_cfg),
                   f"unpatched, top_k {top_k}, cf {cf}")


def test_the_router_runs_the_plain_simplex_on_cpu_tensors():
    _, cfg = _cfgs(lp_capacity=True)
    _, lm = _port(lp_capacity=True)
    x = _x(seed=3, hot=1.5)
    before = simplex_tile.launches
    r = _routing(x, cfg, lm)
    assert simplex_tile.launches == before     # CPU: the plain version
    N = x.shape[0] * x.shape[1]
    C = moe._capacity(N, 1, 8, cfg.capacity_factor)
    assert r.demand.shape == (1, 8) and r.caps.shape == (8,)
    caps = r.caps.numpy()
    assert (caps <= C + 1e-3).all() and caps.sum() <= N + 1e-2
    assert (caps <= r.demand.numpy()[0] + 1e-3).all()
    np.testing.assert_allclose(float(r.demand.sum()), N, rtol=1e-5)


# ---- the LM -------------------------------------------------------------------

@functools.cache
def _reference_lm(lp, patched):
    """(reference cfg, params, jitted prefill, jitted decode) for the
    reduced scout; ``patched`` traces the two-group router."""
    cfg, _ = _cfgs(lp_capacity=lp)
    model = ref_build_model(cfg)
    params = jax.tree.map(jnp.asarray, _params_np())
    real = ref_lp_router.expert_capacity_lp
    router = _two_group_router(real) if patched else real

    def traced(fn):
        def call(*args):
            ref_lp_router.expert_capacity_lp = router
            try:
                return fn(*args)
            finally:
                ref_lp_router.expert_capacity_lp = real
        return jax.jit(call)
    return cfg, params, traced(model.prefill), traced(model.decode_step)


def _ref_pad_kv(caches, total):
    pad = [(0, 0), (0, 0), (0, total - caches.k.shape[2]), (0, 0), (0, 0)]
    return type(caches)(*(jnp.pad(t, pad) for t in caches))


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape)


@pytest.mark.parametrize("lp", [False, True])
def test_prefill_and_decode_logits_and_caches_match_the_reference(lp):
    _, params, prefill, decode = _reference_lm(lp, patched=lp)
    _, lm = _port(lp_capacity=lp)
    steps = 3
    prompts = _tokens((2, P), seed=6)
    toks = _tokens((steps, 2), seed=7)
    logits_r, caches_r = prefill(params, jnp.asarray(prompts, jnp.int32))
    with torch.inference_mode():
        logits, caches = lm.prefill(torch.from_numpy(prompts))
    _close(logits, logits_r, "prefill logits")
    assert isinstance(caches, KVCache)
    assert caches.k.shape == (2, 2, P, 2, 16)
    _close(caches.k, caches_r.k, "k")
    _close(caches.v, caches_r.v, "v")
    caches_r = _ref_pad_kv(caches_r, P + steps)
    caches = pad_kv(caches, P + steps)
    for k, tok in enumerate(toks):
        pos = np.full((2,), P + k)
        logits_r, caches_r = decode(params, caches_r,
                                    jnp.asarray(tok, jnp.int32),
                                    jnp.asarray(pos, jnp.int32))
        with torch.inference_mode():
            logits, caches = lm.decode_step(caches, torch.from_numpy(tok),
                                            torch.from_numpy(pos))
        _close(logits, logits_r, f"decode {k} logits")
        _close(caches.k, caches_r.k, f"decode {k} k")
        _close(caches.v, caches_r.v, f"decode {k} v")


def test_prefill_then_decode_equals_a_longer_prefill():
    """With no capacity drops (lp_capacity off, capacity factor 100, as
    the reference's test_decode_matches_prefill sets it) routing does not
    depend on the batch, so decode through the cache is prefill."""
    cfg, lm = _port(capacity_factor=100.0)
    k = 4
    toks = torch.from_numpy(_tokens((2, P + k), seed=8))
    with torch.inference_mode():
        _, caches = lm.prefill(toks[:, :P])
        caches = pad_kv(caches, P + k)
        for g in range(k):
            stepped, caches = lm.decode_step(caches, toks[:, P + g],
                                             torch.full((2,), P + g))
        whole, c_whole = lm.prefill(toks)
    _close(stepped, whole, "logits")
    _close(caches.k, c_whole.k, "k")
    _close(caches.v, c_whole.v, "v")


def test_full_size_parameter_count_and_cache_shape_are_the_reference_ones():
    ref_cfg, cfg = ref_get_config(ARCH), get_config(ARCH)
    lm = LM(cfg, device=torch.device("meta"))
    ref_model = ref_build_model(ref_cfg)
    shapes = jax.eval_shape(lambda k: ref_model.init(k)[0],
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    n = sum(p.numel() for p in lm.parameters())
    assert n == sum(int(x.size) for x in jax.tree.leaves(shapes))
    assert set(dict(lm.blocks[0].named_children())) == \
        set(shapes["layers"]) == {"norm1", "attn", "norm2", "mlp"}
    # the 40 heads padded to 48 add wq and wo columns the formula leaves out
    assert 1.0 <= n / cfg.n_params() <= 1.03
    assert 107e9 <= n <= 110e9
    want = ref_model.cache_shape(4, 2080)
    got = lm.cache_shape(4, 2080)
    assert isinstance(got, KVCache)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (48, 4, 2080, 8, 128)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)


def test_config_is_the_reference_one():
    cfg, ref = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_heads_padded, cfg.n_kv_heads, cfg.d_head, cfg.d_ff,
            cfg.n_experts, cfg.top_k, cfg.n_shared_experts, cfg.d_ff_expert,
            cfg.vocab, cfg.rope_theta, cfg.q_chunk, cfg.kv_chunk,
            cfg.lp_capacity) == \
        ("moe", 48, 5120, 40, 48, 8, 128, 0, 16, 1, 1, 8192, 202048,
         500000.0, 2048, 2048, False)


def test_parameters_round_trip_through_interop():
    """lm_from_reference and lm_to_reference carry the MoE block's mlp
    group, its stacked (L, E, D, Fe) expert leaves included."""
    params = _params_np()
    back = lm_to_reference(_port()[1])
    assert back["layers"]["mlp"]["w_gate"].shape == (2, 8, 64, 32)
    for group, leaves in params["layers"].items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(back["layers"][group][k], v)
    for group in ("embed", "final_norm", "head"):
        for k, v in params[group].items():
            np.testing.assert_array_equal(back[group][k], v)


# ---- serving -----------------------------------------------------------------

def _reference_greedy(params, prompts, gen, lp=False):
    cfg, _, prefill, decode = _reference_lm(lp, patched=lp)
    B, Pl = prompts.shape
    logits, caches = prefill(params, jnp.asarray(prompts, jnp.int32))
    caches = _ref_pad_kv(caches, Pl + gen)
    tok = jnp.argmax(logits[:, :cfg.vocab], -1).astype(jnp.int32)
    out = [np.asarray(tok)]
    for g in range(gen - 1):
        pos = jnp.full((B,), Pl + g, jnp.int32)
        logits, caches = decode(params, caches, tok, pos)
        tok = jnp.argmax(logits[:, :cfg.vocab], -1).astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.stack(out, 1)


def test_greedy_serve_loop_with_the_lp_router_gives_the_reference_tokens():
    cfg, lm = _port(lp_capacity=True)
    res = serve(cfg, lm, batch=2, prompt_len=P, gen=6, requests=2, seed=0,
                device="cpu")
    params = jax.tree.map(jnp.asarray, _params_np())
    rng = np.random.default_rng(0)     # serve's prompt stream
    for wave in range(2):
        prompts = rng.integers(0, cfg.vocab, (2, P))
        np.testing.assert_array_equal(
            res["tokens"][wave], _reference_greedy(params, prompts, 6,
                                                   lp=True))


def test_serve_cli_gives_the_reference_tokens(capsys):
    """The CLI's model (build_model, seed 0) carried to the reference
    with lm_to_reference: the reference's jitted loop gives the CLI's
    greedy tokens."""
    res = serve_main(["--arch", ARCH, "--reduced", "--batch", "2",
                      "--prompt-len", str(P), "--gen", "4", "--requests",
                      "1", "--device", "cpu"])
    assert "[serve] wave 0: generated 2x4 tokens" in capsys.readouterr().out
    cfg = get_config(ARCH).reduced()
    lm = build_model(cfg, device="cpu", seed=0)
    params = jax.tree.map(jnp.asarray, lm_to_reference(lm))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, P))
    np.testing.assert_array_equal(res["tokens"][0],
                                  _reference_greedy(params, prompts, 4))
