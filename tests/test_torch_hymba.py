"""The port's hymba-1.5b serving path (the hybrid block, ``LM``,
``launch.serve``) against the reference LM.

The reference's reduced hymba (float32, 2 layers, window 32, chunks of
32) is initialized from ``PRNGKey(0)`` with ``ssm_impl="kernel"`` (its
Pallas scan in interpret mode, as its own tests run it) and carried into
the port with ``interop.lm_from_reference``; prompts are made with NumPy
from a seed.  Logits and caches are held to atol 1e-5, the bar of
tests/test_torch_mamba.py.  Prompts are longer than the window, so the
window masks whole kv chunks in prefill and old keys in decode.

The reference's decode writes each K/V row at its absolute position
(``dynamic_update_slice``, which clamps an index past the end), so its
caches are padded to the full length before decoding, as its serve
driver pads them; the port pads the KV leaves only (``pad_kv``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import PORTED, get_config
from repro_torch.distributed import make_decode_step, make_prefill_step
from repro_torch.interop import lm_from_reference, lm_to_reference
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import pad_kv, serve
from repro_torch.launch.train import train
from repro_torch.models import LM, build_model
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba import MambaCache
from repro_torch.models.transformer import HymbaCache, map_cache

ATOL = 1e-5
ARCH = "hymba-1.5b"
P = 96                      # three windows of the reduced config


def _cfgs(impl="kernel"):
    return (dataclasses.replace(ref_get_config(ARCH).reduced(),
                                ssm_impl=impl),
            dataclasses.replace(get_config(ARCH).reduced(), ssm_impl=impl))


@functools.cache
def _reference(impl="kernel"):
    """(reference cfg, model, params, jitted prefill, jitted decode,
    params as NumPy)."""
    cfg, _ = _cfgs(impl)
    model = ref_build_model(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    return (cfg, model, params, jax.jit(model.prefill),
            jax.jit(model.decode_step), jax.tree.map(np.asarray, params))


def _port(impl="kernel"):
    _, cfg = _cfgs(impl)
    return cfg, lm_from_reference(cfg, _reference(impl)[5], "cpu")


def _close(got, want, name=""):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=0, err_msg=name)


def _close_cache(got, want):
    _close(got.kv.k, want.kv.k, "k")
    _close(got.kv.v, want.kv.v, "v")
    _close(got.ssm.h, want.ssm.h, "h")
    _close(got.ssm.conv, want.ssm.conv, "conv")


def _ref_pad_kv(caches, total):
    """The reference's caches with the KV leaves (L, B, S, KV, dh) padded
    to ``total`` rows, the SSM leaves unchanged."""
    pad = [(0, 0), (0, 0), (0, total - caches.kv.k.shape[2]), (0, 0), (0, 0)]
    return caches._replace(kv=type(caches.kv)(
        *(jnp.pad(t, pad) for t in caches.kv)))


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape)


# ---- configs, parameters, cache shapes ---------------------------------------

def test_config_is_the_reference_one():
    assert "hymba_1_5b" in PORTED
    for arch in (ARCH, "hymba_1_5b"):
        cfg, ref = get_config(arch), ref_get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert cfg.n_params() == ref.n_params()
        assert dataclasses.asdict(cfg.reduced()) == \
            dataclasses.asdict(ref.reduced())
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab, cfg.sliding_window,
            cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.q_chunk,
            cfg.kv_chunk, cfg.dtype) == \
        (32, 1600, 25, 5, 64, 5504, 32001, 1024, 3200, 16, 100, 256, 512,
         "bfloat16")


def test_parameters_have_the_reference_names_shapes_and_dtypes():
    cfg, _, params, *_ = _reference()
    lm = build_model(get_config(ARCH).reduced(), device="cpu", seed=0)
    ref = {"embed.table": params["embed"]["table"],
           "final_norm.scale": params["final_norm"]["scale"],
           "head.w": params["head"]["w"]}
    assert set(params["layers"]) == {"norm1", "attn", "ssm", "norm2", "mlp"}
    for group, leaves in params["layers"].items():
        for k, v in leaves.items():
            for i in range(cfg.n_layers):
                ref[f"blocks.{i}.{group}.{k}"] = v[i]
    got = dict(lm.named_parameters())
    assert set(got) == set(ref)
    for name, p in got.items():
        assert tuple(p.shape) == ref[name].shape, name
        assert str(p.dtype).removeprefix("torch.") == str(ref[name].dtype)
        assert p.requires_grad
    # the reference's scales: N(0, 1/in) weights
    wq = lm.blocks[0].attn["wq"].detach()
    assert abs(float(wq.std()) - 64 ** -0.5) < 0.02
    # lm_to_reference is lm_from_reference's inverse
    back = lm_to_reference(_port()[1])
    for group, leaves in params["layers"].items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(back["layers"][group][k],
                                          np.asarray(v))


def test_full_size_parameter_count_is_the_reference_one():
    cfg = get_config(ARCH)
    lm = LM(cfg, device=torch.device("meta"))
    n = sum(p.numel() for p in lm.parameters())
    ref_model = ref_build_model(ref_get_config(ARCH))
    shapes = jax.eval_shape(lambda k: ref_model.init(k)[0],
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    assert n == sum(int(x.size) for x in jax.tree.leaves(shapes))
    assert 0.9 <= n / cfg.n_params() <= 1.1
    assert 1.5e9 <= n <= 1.8e9
    bf16 = {p.dtype for p in lm.parameters()} - {torch.float32}
    assert bf16 == {torch.bfloat16}


@pytest.mark.parametrize("seq", [20, P])
def test_cache_shapes_are_the_reference_ones(seq):
    _, model = _reference()[:2]
    _, lm = _port()
    want = jax.tree.leaves(model.cache_shape(3, seq))
    got = jax.tree.leaves(lm.cache_shape(3, seq),
                          is_leaf=lambda x: hasattr(x, "dtype"))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
    assert got[0].shape == (2, 3, min(seq, 32), 2, 16)


def test_the_reference_window_sized_cache_writes_the_wrong_row():
    """The reference's ``cache_shape`` gives window-sized KV leaves, and
    its decode writes at the absolute position, clamped to the last row:
    past the window it overwrites row 31 (ROADMAP queue 3).  The serving
    path keeps all rows; the port raises instead of clamping."""
    cfg, _, params, prefill, decode, _ = _reference()
    prompts = _tokens((2, P), seed=11)
    tok = jnp.asarray(_tokens((2,), seed=12), jnp.int32)
    pos = jnp.full((2,), P, jnp.int32)
    _, caches = prefill(params, jnp.asarray(prompts, jnp.int32))
    window = cfg.sliding_window
    short = caches._replace(kv=type(caches.kv)(
        *(t[:, :, P - window:] for t in caches.kv)))
    assert short.kv.k.shape[2] == 32
    _, new = decode(params, short, tok, pos)
    changed = np.flatnonzero(np.abs(np.asarray(new.kv.k)
                                    - np.asarray(short.kv.k)).max((0, 1, 3,
                                                                   4)))
    assert changed.tolist() == [window - 1]
    _, lm = _port()
    with torch.inference_mode():
        _, port_caches = lm.prefill(torch.from_numpy(prompts))
        with pytest.raises(IndexError, match="outside the cache's 96 rows"):
            lm.decode_step(port_caches, torch.from_numpy(np.array(tok)),
                           torch.full((2,), P))


# ---- the LM -------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["kernel", "assoc"])
def test_prefill_and_decode_logits_and_caches_match_the_reference(impl):
    ref_cfg, _, params, prefill, decode, _ = _reference(impl)
    _, lm = _port(impl)
    steps = 3
    prompts = _tokens((2, P), seed=6)
    toks = _tokens((steps, 2), seed=7)
    logits_r, caches_r = prefill(params, jnp.asarray(prompts, jnp.int32))
    with torch.inference_mode():
        logits, caches = lm.prefill(torch.from_numpy(prompts))
    _close(logits, logits_r, "prefill logits")
    assert isinstance(caches, HymbaCache)
    assert isinstance(caches.kv, KVCache) and isinstance(caches.ssm,
                                                         MambaCache)
    assert caches.kv.k.shape == (2, 2, P, 2, 16)
    _close_cache(caches, caches_r)
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
        _close_cache(caches, caches_r)


def test_prefill_then_decode_equals_a_longer_prefill():
    _, lm = _port()
    k = 5
    toks = torch.from_numpy(_tokens((2, P + k), seed=8))
    with torch.inference_mode():
        _, caches = lm.prefill(toks[:, :P])
        caches = pad_kv(caches, P + k)
        for g in range(k):
            stepped, caches = lm.decode_step(caches, toks[:, P + g],
                                             torch.full((2,), P + g))
        whole, c_whole = lm.prefill(toks)
    _close(stepped, whole, "logits")
    _close(caches.kv.k, c_whole.kv.k, "k")
    _close(caches.kv.v, c_whole.kv.v, "v")
    _close(caches.ssm.h, c_whole.ssm.h, "h")
    _close(caches.ssm.conv, c_whole.ssm.conv, "conv")


def test_each_sequence_decodes_at_its_own_position():
    """pos differs across the batch: each row is written and attends as
    if it decoded alone."""
    _, lm = _port()
    toks = torch.from_numpy(_tokens((2, 80), seed=9))
    with torch.inference_mode():
        _, caches = lm.prefill(toks[:, :70])
        caches = pad_kv(caches, 80)
        # row 1 skips to 75: rows 70-74 of its cache stay zero
        pos = torch.tensor([70, 75])
        got, _ = lm.decode_step(caches, toks[:, 70], pos)
        alone = []
        for b in range(2):
            one = map_cache(lambda t: t[:, b:b + 1], caches)
            logit, _ = lm.decode_step(one, toks[b:b + 1, 70], pos[b:b + 1])
            alone.append(logit)
    _close(got, torch.cat(alone), "logits")


def test_the_block_is_the_mean_of_attention_and_mamba():
    """Zeroing the attention's output projection leaves half the Mamba
    branch: 0.5 * (a1 + a2) with a1 = 0."""
    from repro_torch.models.mamba import mamba_apply
    from repro_torch.models.layers import apply_norm, mlp_apply
    cfg, lm = _port()
    block = lm.blocks[0]
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 32, 64)).astype(np.float32))
    with torch.no_grad():
        block.attn["wo"].zero_()
        out, _ = block(x, mode="train", positions=torch.arange(32)[None])
        h = apply_norm(block.norm1, x, cfg.norm_kind)
        a2, _ = mamba_apply(block.ssm, h, cfg, mode="train")
        y = x + 0.5 * a2
        want = y + mlp_apply(block.mlp, apply_norm(block.norm2, y,
                                                   cfg.norm_kind), cfg)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)


# ---- serving -----------------------------------------------------------------

def _reference_greedy(prompts, gen, impl="kernel"):
    """The reference's jitted prefill/decode loop with the KV leaves padded
    to the full length (its serve driver's padding, KV leaves only)."""
    cfg, _, params, prefill, decode, _ = _reference(impl)
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


def test_greedy_serve_loop_gives_the_reference_tokens(capsys):
    cfg, _ = _cfgs()
    res = serve(cfg, lm_from_reference(cfg, _reference()[5], "cpu"),
                batch=2, prompt_len=40, gen=8, requests=2, seed=0,
                device="cpu")
    rng = np.random.default_rng(0)     # serve's prompt stream
    for wave in range(2):
        prompts = rng.integers(0, cfg.vocab, (2, 40))
        np.testing.assert_array_equal(res["tokens"][wave],
                                      _reference_greedy(prompts, 8))
    assert res["n_tokens"] == 32 and len(res["decode_s"]) == 2
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "[serve] 32 tokens in ")


def _longer_prefill_tokens(lm, prompts, generated):
    """The greedy token after each prefix prompt + generated[:, :g], by
    prefill alone."""
    seq = torch.from_numpy(np.concatenate([prompts, generated], 1))
    P0 = prompts.shape[1]
    with torch.inference_mode():
        return np.stack([lm.prefill(seq[:, :P0 + g])[0][:, :lm.cfg.vocab]
                         .argmax(-1).numpy()
                         for g in range(generated.shape[1])], 1)


def test_serving_at_a_prompt_of_conv_width_decodes_what_prefill_predicts():
    """At P = conv_dim - 1 = 3 the reference's serve driver would pad the
    conv window (its axis 2 equals P); the port pads the KV leaves only
    and decodes what a longer prefill predicts, and what the reference's
    model gives with its KV leaves padded."""
    cfg, lm = _port()
    assert cfg.conv_dim - 1 == 3
    res = serve(cfg, lm, batch=2, prompt_len=3, gen=6, requests=1, seed=0,
                device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 3))
    np.testing.assert_array_equal(res["tokens"][0],
                                  _longer_prefill_tokens(lm, prompts,
                                                         res["tokens"][0]))
    np.testing.assert_array_equal(res["tokens"][0],
                                  _reference_greedy(prompts, 6))


def test_pad_kv_pads_only_the_kv_leaves():
    _, lm = _port()
    with torch.inference_mode():
        _, caches = lm.prefill(torch.from_numpy(_tokens((2, 3), seed=1)))
    padded = pad_kv(caches, 10)
    assert padded.kv.k.shape == (2, 2, 10, 2, 16)
    assert torch.equal(padded.kv.k[:, :, :3], caches.kv.k)
    assert float(padded.kv.v[:, :, 3:].abs().max()) == 0
    assert padded.ssm is caches.ssm and padded.ssm.conv.shape[2] == 3
    ssm_only = MambaCache(torch.zeros(1, 2, 3), torch.zeros(1, 3, 2))
    assert pad_kv(ssm_only, 10) is ssm_only


def test_prefill_and_decode_steps_are_the_models():
    _, lm = _port()
    toks = torch.from_numpy(_tokens((2, 40), seed=2))
    prefill, decode = make_prefill_step(lm), make_decode_step(lm)
    with torch.inference_mode():
        logits, caches = prefill(toks, extra={"other": 1})
        want, _ = lm.prefill(toks)
        assert torch.equal(logits, want)
        caches = pad_kv(caches, 41)
        pos = torch.full((2,), 40)
        got, _ = decode(caches, toks[:, 0], pos)
        want, _ = lm.decode_step(caches, toks[:, 0], pos)
        assert torch.equal(got, want)


def test_patches_on_hymba_go_before_the_text_as_in_the_reference():
    """make_prefill_step hands "patches" to every LM family's prefill, as
    the reference's does: hymba's logits and every cache leaf (KV rows of
    the 8 patches, then the 40 tokens) are the reference's."""
    _, _, params, prefill_ref, _, _ = _reference()
    _, lm = _port()
    toks = _tokens((2, 40), seed=3)
    patches = np.random.default_rng(4).normal(size=(2, 8, 64)) \
        .astype(np.float32)
    want, want_c = prefill_ref(params, jnp.asarray(toks, jnp.int32),
                               jnp.asarray(patches))
    with torch.inference_mode():
        got, got_c = make_prefill_step(lm)(
            torch.from_numpy(toks), extra={"patches":
                                           torch.from_numpy(patches)})
    assert got_c.kv.k.shape[2] == 48
    _close(got, want)
    _close_cache(got_c, want_c)


def test_serve_cli_serves_hymba_by_default(capsys):
    res = serve_main(["--reduced", "--batch", "2", "--prompt-len", "40",
                      "--gen", "4", "--requests", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] wave 0: generated 2x4 tokens" in out
    cfg = get_config(ARCH).reduced()
    lm = build_model(cfg, device="cpu", seed=0)
    assert lm.cfg.family == "hybrid"
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 40))
    np.testing.assert_array_equal(
        res["tokens"][0], _longer_prefill_tokens(lm, prompts,
                                                 res["tokens"][0]))


def test_training_the_hybrid_family_is_refused():
    """Named for the refusal ``train`` made before the hybrid family was
    trained: it now trains it (tests/test_torch_train_hybrid.py holds the
    steps to the reference)."""
    cfg, lm = _port()
    res = train(cfg, lm, batch=2, seq=32, steps=1, device="cpu")
    assert np.isfinite(res["losses"]).all()
