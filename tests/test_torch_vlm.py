"""The port's VLM family (phi-3-vision-4.2b: a dense GQA backbone whose
prefill takes precomputed patch embeddings before the text) against the
reference.

The reference's reduced phi-3-vision (float32, 2 layers, d_model 64, 4
heads over 2 KV heads, SwiGLU, 8 patches, chunks of 32) is initialized
from ``PRNGKey(0)`` and carried into the port with
``interop.lm_from_reference``; patches and prompts are made with NumPy
from a seed.  Logits, caches and losses are held to atol 1e-5, the bar of
the other LM tests.  Decode positions start after the patches: the KV
leaves hold n_patches + P prompt rows, padded to n_patches + P + G.
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
from repro_torch.configs import get_config
from repro_torch.distributed import make_prefill_step
from repro_torch.interop import lm_from_reference, lm_to_reference
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import pad_kv, serve
from repro_torch.models import LM, build_model

ATOL = 1e-5
ARCH = "phi-3-vision-4.2b"
P = 40                      # text tokens; with the 8 patches, 48 rows
NP = 8                      # the reduced config's patches


def _cfgs():
    return ref_get_config(ARCH).reduced(), get_config(ARCH).reduced()


@functools.cache
def _reference():
    """(reference cfg, model, params, jitted prefill, jitted decode,
    params as NumPy) of the reduced phi-3-vision."""
    cfg, _ = _cfgs()
    model = ref_build_model(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    return (cfg, model, params, jax.jit(model.prefill),
            jax.jit(model.decode_step), jax.tree.map(np.asarray, params))


def _port():
    _, cfg = _cfgs()
    return cfg, lm_from_reference(cfg, _reference()[5], "cpu")


def _close(got, want, name=""):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=0, err_msg=name)


def _ref_pad_kv(caches, total):
    pad = [(0, 0), (0, 0), (0, total - caches.k.shape[2]), (0, 0), (0, 0)]
    return type(caches)(*(jnp.pad(t, pad) for t in caches))


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape)


def _patches(B, seed, n=NP):
    return np.random.default_rng(seed).normal(size=(B, n, 64)) \
        .astype(np.float32)


# ---- config, parameters, cache shapes ------------------------------------------

def test_config_is_the_reference_one():
    cfg, ref = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_head, cfg.d_ff, cfg.vocab, cfg.n_patches,
            cfg.mlp_kind) == \
        ("vlm", 32, 3072, 32, 32, 96, 8192, 32064, 256, "swiglu")


def test_full_size_parameter_count_and_cache_shape_are_the_reference_ones():
    ref_cfg, cfg = ref_get_config(ARCH), get_config(ARCH)
    lm = LM(cfg, device=torch.device("meta"))
    ref_model = ref_build_model(ref_cfg)
    shapes = jax.eval_shape(lambda k: ref_model.init(k)[0],
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    n = sum(p.numel() for p in lm.parameters())
    assert n == sum(int(x.size) for x in jax.tree.leaves(shapes))
    assert 1.0 <= n / cfg.n_params() <= 1.002
    for g, w in zip(lm.cache_shape(3, 77), ref_model.cache_shape(3, 77)):
        assert g.shape == w.shape == (32, 3, 77, 32, 96)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
    back = lm_to_reference(_port()[1])
    for got, want in zip(jax.tree.leaves(back),
                         jax.tree.leaves(_reference()[5])):
        np.testing.assert_array_equal(got, want)


# ---- the model ---------------------------------------------------------------------

def test_prefill_with_patches_and_decode_match_the_reference():
    """Prefill of 8 patches and 40 tokens, then decode at positions 48,
    49, 50: logits and both KV leaves at every step."""
    _, _, params, prefill, decode, _ = _reference()
    _, lm = _port()
    toks = _tokens((2, P + 3), seed=1)
    patches = _patches(2, seed=2)
    want, want_c = prefill(params, jnp.asarray(toks[:, :P], jnp.int32),
                           jnp.asarray(patches))
    with torch.inference_mode():
        got, got_c = lm.prefill(torch.from_numpy(toks[:, :P]),
                                torch.from_numpy(patches))
    assert got_c.k.shape == (2, 2, NP + P, 2, 16)
    S = NP + P
    want_c, got_c = _ref_pad_kv(want_c, S + 3), pad_kv(got_c, S + 3)
    for g in range(4):
        _close(got, want, f"logits {g}")
        _close(got_c.k, want_c.k, f"k {g}")
        _close(got_c.v, want_c.v, f"v {g}")
        if g == 3:
            break
        want, want_c = decode(params, want_c,
                              jnp.asarray(toks[:, P + g], jnp.int32),
                              jnp.full((2,), S + g, jnp.int32))
        with torch.inference_mode():
            got, got_c = lm.decode_step(got_c,
                                        torch.from_numpy(toks[:, P + g]),
                                        torch.full((2,), S + g))


def test_decode_after_patches_equals_a_longer_prefill():
    _, lm = _port()
    toks = torch.from_numpy(_tokens((2, P + 4), seed=3))
    patches = torch.from_numpy(_patches(2, seed=4))
    S = NP + P
    with torch.inference_mode():
        _, caches = lm.prefill(toks[:, :P], patches)
        caches = pad_kv(caches, S + 4)
        for g in range(4):
            stepped, caches = lm.decode_step(caches, toks[:, P + g],
                                             torch.full((2,), S + g))
            whole, _ = lm.prefill(toks[:, :P + g + 1], patches)
            _close(stepped, whole, f"step {g}")


@pytest.mark.parametrize("with_patches", [True, False])
def test_loss_matches_the_reference(with_patches):
    """With patches the loss is taken on the text positions only."""
    _, model, params, *_ = _reference()
    _, lm = _port()
    toks = _tokens((2, P), seed=5)
    labels = _tokens((2, P), seed=6)
    labels[1, -3:] = -1
    batch = {"tokens": toks, "labels": labels}
    if with_patches:
        batch["patches"] = _patches(2, seed=7)
    want = model.loss_fn(params, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    got = lm.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    _close(got, want)


def test_patches_are_put_before_the_text():
    _, lm = _port()
    toks = torch.from_numpy(_tokens((2, 5), seed=8))
    patches = torch.from_numpy(_patches(2, seed=9, n=3))
    x = lm._embed_inputs(toks, patches)
    assert x.shape == (2, 8, 64)
    assert torch.equal(x[:, :3], patches)
    assert torch.equal(x[:, 3:], lm._embed_inputs(toks))


def test_prefill_step_passes_patches_and_refuses_frames():
    _, lm = _port()
    toks = torch.from_numpy(_tokens((2, 8), seed=10))
    patches = torch.from_numpy(_patches(2, seed=11))
    step = make_prefill_step(lm)
    with torch.inference_mode():
        got, _ = step(toks, extra={"patches": patches})
        want, _ = lm.prefill(toks, patches)
        assert torch.equal(got, want)
        with pytest.raises(TypeError):
            step(toks, extra={"frames": torch.zeros(2, 8, 64)})


# ---- serving -------------------------------------------------------------------------

def _reference_greedy(params, prompts, patches, gen):
    cfg, _, _, prefill, decode, _ = _reference()
    B, Pl = prompts.shape
    S = Pl + patches.shape[1]
    logits, caches = prefill(params, jnp.asarray(prompts, jnp.int32),
                             jnp.asarray(patches))
    caches = _ref_pad_kv(caches, S + gen)
    tok = jnp.argmax(logits[:, :cfg.vocab], -1).astype(jnp.int32)
    out = [np.asarray(tok)]
    for g in range(gen - 1):
        logits, caches = decode(params, caches, tok,
                                jnp.full((B,), S + g, jnp.int32))
        tok = jnp.argmax(logits[:, :cfg.vocab], -1).astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.stack(out, 1)


def test_greedy_serve_loop_gives_the_reference_tokens():
    """Two waves: each wave's patches drawn after its prompts."""
    cfg, lm = _port()
    res = serve(cfg, lm, batch=2, prompt_len=P, gen=5, requests=2, seed=0,
                device="cpu")
    params = _reference()[2]
    rng = np.random.default_rng(0)
    for wave in range(2):
        prompts = rng.integers(0, cfg.vocab, (2, P))
        patches = rng.standard_normal((2, NP, 64), dtype=np.float32)
        np.testing.assert_array_equal(
            res["tokens"][wave], _reference_greedy(params, prompts, patches,
                                                   5))


def test_serve_cli_gives_the_reference_tokens(capsys):
    """``serve --arch phi-3-vision-4.2b --reduced --device cpu``: its
    seed-0 model carried to the reference with lm_to_reference, whose
    jitted loop (KV leaves padded, positions after the patches) gives
    the CLI's tokens."""
    res = serve_main(["--arch", ARCH, "--reduced", "--batch", "2",
                      "--prompt-len", str(P), "--gen", "4", "--requests",
                      "1", "--device", "cpu"])
    assert "[serve] wave 0: generated 2x4 tokens" in capsys.readouterr().out
    cfg = get_config(ARCH).reduced()
    lm = build_model(cfg, device="cpu", seed=0)
    params = jax.tree.map(jnp.asarray, lm_to_reference(lm))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (2, P))
    patches = rng.standard_normal((2, NP, 64), dtype=np.float32)
    np.testing.assert_array_equal(
        res["tokens"][0], _reference_greedy(params, prompts, patches, 4))
