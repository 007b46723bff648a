"""The port's Multi-head Latent Attention (``models/mla.py``) and the MLA
MoE LM (deepseek-v2-236b) against the reference.

The reference's reduced deepseek-v2 (float32, 2 layers, 4 heads, latent
16, q_lora 24, nope 16 + rope 8, v 16; 8 experts of 32, top-2 plus one
shared expert) is initialized from ``PRNGKey(0)`` and carried into the
port with ``interop.lm_from_reference``; inputs are made with NumPy from a
seed.  Outputs, logits and caches are held to atol 1e-5: float32 products
summed in other orders, the bar of the other LM tests.

Train and prefill materialize per-head K/V; decode is the absorbed form
against the latent cache, so decode against a longer prefill compares
the two forms.  With ``lp_capacity`` the reference's router is patched to
solve its batch of one as row 0 of a two-group batch, as
``tests/test_torch_moe.py`` does (ROADMAP queue 3, batch-of-one).
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
from repro.models import mla as ref_mla
from repro_torch.configs import get_config
from repro_torch.interop import lm_from_reference, lm_to_reference
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import pad_kv, serve
from repro_torch.models import LM, build_model
from repro_torch.models.mla import MLACache, mla_apply

ATOL = 1e-5
ARCH = "deepseek-v2-236b"
P = 40                      # prompt length: two q/kv chunks of the reduced


def _cfgs(**kw):
    return (dataclasses.replace(ref_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


@functools.cache
def _params_np():
    cfg, _ = _cfgs()
    params, _ = ref_build_model(cfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _port(**kw):
    _, cfg = _cfgs(**kw)
    return cfg, lm_from_reference(cfg, _params_np(), "cpu")


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


@functools.cache
def _reference_lm(lp):
    """(reference cfg, params, jitted prefill, jitted decode) of the
    reduced deepseek-v2; with ``lp`` the router traced is the two-group
    one."""
    cfg, _ = _cfgs(lp_capacity=lp)
    model = ref_build_model(cfg)
    params = jax.tree.map(jnp.asarray, _params_np())
    real = ref_lp_router.expert_capacity_lp
    router = _two_group_router(real) if lp else real

    def traced(fn):
        def call(*args):
            ref_lp_router.expert_capacity_lp = router
            try:
                return fn(*args)
            finally:
                ref_lp_router.expert_capacity_lp = real
        return jax.jit(call)
    return cfg, params, traced(model.prefill), traced(model.decode_step)


def _ref_pad(caches, total):
    pad = [(0, 0), (0, 0), (0, total - caches.c_kv.shape[2]), (0, 0)]
    return type(caches)(*(jnp.pad(t, pad) for t in caches))


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape + (64,)) \
        .astype(np.float32)


# ---- config, parameters, cache shapes ------------------------------------------

def test_config_is_the_reference_one():
    cfg, ref = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert (cfg.family, cfg.attn_kind, cfg.n_layers, cfg.d_model,
            cfg.n_heads, cfg.kv_lora, cfg.q_lora, cfg.qk_nope_dim,
            cfg.qk_rope_dim, cfg.v_head_dim, cfg.n_experts, cfg.top_k,
            cfg.n_shared_experts, cfg.d_ff_expert, cfg.vocab) == \
        ("moe", "mla", 60, 5120, 128, 512, 1536, 128, 64, 128, 160, 6, 2,
         1536, 102400)


def test_parameters_have_the_reference_names_shapes_and_round_trip():
    params = _params_np()
    lm = build_model(_cfgs()[1], device="cpu", seed=0)
    assert set(dict(lm.blocks[0].named_children())) == \
        {"norm1", "attn", "norm2", "mlp"}
    assert set(lm.blocks[0].attn.keys()) == set(params["layers"]["attn"]) \
        == {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}
    back = lm_to_reference(_port()[1])
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, want)
    assert back["layers"]["attn"]["q_norm"]["scale"].shape == (2, 24)
    # the port's own draw: the reference's (in, out) scales
    wkv_b = lm.blocks[0].attn["wkv_b"].detach()
    assert wkv_b.shape == (16, 4 * (16 + 16))
    assert abs(float(wkv_b.std()) - 16 ** -0.5) < 0.03


def test_full_size_parameter_count_and_cache_shape_are_the_reference_ones():
    ref_cfg, cfg = ref_get_config(ARCH), get_config(ARCH)
    lm = LM(cfg, device=torch.device("meta"))
    ref_model = ref_build_model(ref_cfg)
    shapes = jax.eval_shape(lambda k: ref_model.init(k)[0],
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    n = sum(p.numel() for p in lm.parameters())
    assert n == sum(int(x.size) for x in jax.tree.leaves(shapes))
    assert 1.0 <= n / cfg.n_params() <= 1.002
    want = ref_model.cache_shape(3, 77)
    got = lm.cache_shape(3, 77)
    assert isinstance(got, MLACache)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (60, 3, 77, g.shape[-1])
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
    assert (got.c_kv.shape[-1], got.k_rope.shape[-1]) == (512, 64)


# ---- the attention layer ---------------------------------------------------------

@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mla_apply_matches_the_reference(mode):
    """Layer 1's MLA in every mode.  Decode writes rows 40 and 37 of a
    44-row latent cache from a 40-row prefill: the second sequence
    overwrites a prompt row and masks the rows after it."""
    ref_cfg, cfg = _cfgs()
    lm = _port()[1]
    p_ref = jax.tree.map(lambda a: jnp.asarray(a[1]),
                         _params_np()["layers"]["attn"])
    p = lm.blocks[1].attn
    x = _x((2, P), seed=1)
    positions = np.broadcast_to(np.arange(P), (2, P))
    want, want_c = ref_mla.mla_apply(
        p_ref, jnp.asarray(x), ref_cfg, positions=jnp.asarray(positions),
        mode="train" if mode == "train" else "prefill")
    with torch.inference_mode():
        got, got_c = mla_apply(p, torch.from_numpy(x), cfg,
                               positions=torch.from_numpy(positions.copy()),
                               mode="train" if mode == "train"
                               else "prefill")
    if mode == "train":
        assert got_c is None and want_c is None
        _close(got, want)
        return
    if mode == "prefill":
        _close(got, want)
        for g, w, name in zip(got_c, want_c, MLACache._fields):
            _close(g, w, name)
        return
    pos = np.array([P, 37])
    xs = _x((2, 1), seed=2)
    ref_cache = ref_mla.MLACache(*(jnp.pad(t, [(0, 0), (0, 4), (0, 0)])
                                   for t in want_c))
    want, want_c = ref_mla.mla_apply(
        p_ref, jnp.asarray(xs), ref_cfg, positions=jnp.asarray(pos[:, None]),
        mode="decode", cache=ref_cache, pos=jnp.asarray(pos, jnp.int32))
    cache = MLACache(*(torch.nn.functional.pad(t, (0, 0, 0, 4))
                       for t in got_c))
    with torch.inference_mode():
        got, got_c = mla_apply(p, torch.from_numpy(xs), cfg,
                               positions=torch.from_numpy(pos[:, None]),
                               mode="decode", cache=cache,
                               pos=torch.from_numpy(pos))
    _close(got, want)
    for g, w, name in zip(got_c, want_c, MLACache._fields):
        _close(g, w, name)


def test_decode_outside_the_latent_cache_raises():
    cfg, lm = _port()
    toks = torch.from_numpy(_tokens((2, 8), seed=3))
    with torch.inference_mode():
        _, caches = lm.prefill(toks)
        with pytest.raises(IndexError, match="outside the cache"):
            lm.decode_step(caches, toks[:, 0], torch.tensor([7, 8]))


# ---- the LM ----------------------------------------------------------------------

@pytest.mark.parametrize("lp", [False, True])
def test_prefill_and_decode_logits_and_caches_match_the_reference(lp):
    _, params, prefill, decode = _reference_lm(lp)
    _, lm = _port(lp_capacity=lp)
    toks = _tokens((2, P + 3), seed=4)
    want, want_c = prefill(params, jnp.asarray(toks[:, :P], jnp.int32))
    with torch.inference_mode():
        got, got_c = lm.prefill(torch.from_numpy(toks[:, :P]))
    want_c = _ref_pad(want_c, P + 3)
    got_c = pad_kv(got_c, P + 3)
    for g in range(4):
        _close(got, want, f"logits {g}")
        for a, b, name in zip(got_c, want_c, MLACache._fields):
            _close(a, b, f"{name} {g}")
        if g == 3:
            break
        want, want_c = decode(params, want_c,
                              jnp.asarray(toks[:, P + g], jnp.int32),
                              jnp.full((2,), P + g, jnp.int32))
        with torch.inference_mode():
            got, got_c = lm.decode_step(got_c,
                                        torch.from_numpy(toks[:, P + g]),
                                        torch.full((2,), P + g))


def test_absorbed_decode_equals_a_longer_materialized_prefill():
    """prefill(P) then decode steps (the absorbed form) against a prefill
    of each longer prompt (the materialized form); routing kept out of
    it with no capacity drops, as the reference's
    test_decode_matches_prefill does."""
    cfg, lm = _port(capacity_factor=100.0)
    toks = torch.from_numpy(_tokens((2, P + 4), seed=5))
    with torch.inference_mode():
        _, caches = lm.prefill(toks[:, :P])
        caches = pad_kv(caches, P + 4)
        for g in range(4):
            stepped, caches = lm.decode_step(caches, toks[:, P + g],
                                             torch.full((2,), P + g))
            whole, _ = lm.prefill(toks[:, :P + g + 1])
            _close(stepped, whole, f"step {g}")


def test_loss_matches_the_reference():
    """The train mode through every block: materialized MLA, then the
    MoE layer (lp_capacity off), and the chunked cross entropy."""
    ref_cfg, _ = _cfgs()
    params = jax.tree.map(jnp.asarray, _params_np())
    _, lm = _port()
    toks = _tokens((2, P), seed=6)
    labels = _tokens((2, P), seed=7)
    labels[1, :4] = -1
    want = ref_build_model(ref_cfg).loss_fn(
        params, {"tokens": jnp.asarray(toks, jnp.int32),
                 "labels": jnp.asarray(labels, jnp.int32)})
    got = lm.loss_fn({"tokens": torch.from_numpy(toks),
                      "labels": torch.from_numpy(labels)})
    _close(got, want)


# ---- serving -----------------------------------------------------------------------

def _reference_greedy(params, prompts, gen, lp=False):
    cfg, _, prefill, decode = _reference_lm(lp)
    B, Pl = prompts.shape
    logits, caches = prefill(params, jnp.asarray(prompts, jnp.int32))
    caches = _ref_pad(caches, Pl + gen)
    tok = jnp.argmax(logits[:, :cfg.vocab], -1).astype(jnp.int32)
    out = [np.asarray(tok)]
    for g in range(gen - 1):
        logits, caches = decode(params, caches, tok,
                                jnp.full((B,), Pl + g, jnp.int32))
        tok = jnp.argmax(logits[:, :cfg.vocab], -1).astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.stack(out, 1)


def test_greedy_serve_loop_with_the_lp_router_gives_the_reference_tokens():
    cfg, lm = _port(lp_capacity=True)
    res = serve(cfg, lm, batch=2, prompt_len=P, gen=5, requests=2, seed=0,
                device="cpu")
    params = jax.tree.map(jnp.asarray, _params_np())
    rng = np.random.default_rng(0)     # serve's prompt stream
    for wave in range(2):
        prompts = rng.integers(0, cfg.vocab, (2, P))
        np.testing.assert_array_equal(
            res["tokens"][wave], _reference_greedy(params, prompts, 5,
                                                   lp=True))


def test_serve_cli_gives_the_reference_tokens(capsys):
    """``serve --arch deepseek-v2-236b --reduced --device cpu``: its
    seed-0 model carried to the reference with lm_to_reference, whose
    jitted loop (the latent leaves padded) gives the CLI's tokens."""
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
