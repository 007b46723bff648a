"""The port's encoder-decoder (``models/encdec.py``, whisper-small) and
its cross-attention (``models/attention.py``) against the reference.

The reference's reduced whisper (float32, 2 encoder and 2 decoder
layers, d_model 64, 4 heads over 2 KV heads, LayerNorm, GELU, a tied
head, chunks of 32) is initialized from ``PRNGKey(0)`` and carried into
the port with ``interop.lm_from_reference``; frames and prompts are made
with NumPy from a seed.  Outputs, logits and caches are held to atol
1e-5, the bar of the other LM tests.

The reference's jitted ``prefill`` and ``decode_step`` are the reference
here, not its serving CLI: that CLI feeds no frames, and its cache
padding would pad the cross K/V whenever the frames are as long as the
prompt (ROADMAP queue 3; ``test_padding_the_cross_leaves_changes_decode``
shows the second).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attention
from repro.models import build_model as ref_build_model
from repro.models import encdec as ref_encdec
from repro_torch.configs import get_config
from repro_torch.distributed import make_prefill_step
from repro_torch.interop import lm_from_reference, lm_to_reference
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import pad_kv, serve
from repro_torch.models import EncDecLM, build_model
from repro_torch.models.attention import (cross_attn_apply, cross_kv,
                                          KVCache)
from repro_torch.models.encdec import EncDecCache, sinusoids

ATOL = 1e-5
ARCH = "whisper-small"
P = 40                      # prompt length: two q/kv chunks of the reduced
F = 48                      # frames: two chunks of the encoder's


def _cfgs(**kw):
    return (dataclasses.replace(ref_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


@functools.cache
def _reference():
    """(reference cfg, model, params, jitted prefill, jitted decode,
    params as NumPy) of the reduced whisper."""
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


def _leaves(c):
    return {"k": c.self_kv.k, "v": c.self_kv.v, "cross_k": c.cross_k,
            "cross_v": c.cross_v}


def _close_cache(got, want, tag=""):
    w = _leaves(want)
    for name, g in _leaves(got).items():
        _close(g, w[name], f"{name} {tag}")


def _ref_pad_self(caches, total):
    """The reference's caches with only the self-attention KV padded."""
    pad = [(0, 0), (0, 0), (0, total - caches.self_kv.k.shape[2]), (0, 0),
           (0, 0)]
    kv = type(caches.self_kv)(*(jnp.pad(t, pad) for t in caches.self_kv))
    return caches._replace(self_kv=kv)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape)


def _frames(B, n, seed):
    return np.random.default_rng(seed).normal(size=(B, n, 64)) \
        .astype(np.float32)


# ---- config, parameters, cache shapes ----------------------------------------

def test_config_is_the_reference_one():
    cfg, ref = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert (cfg.family, cfg.n_layers, cfg.n_encoder_layers, cfg.d_model,
            cfg.n_heads, cfg.n_heads_padded, cfg.d_head, cfg.d_ff,
            cfg.vocab, cfg.norm_kind, cfg.mlp_kind, cfg.use_rope,
            cfg.tie_embeddings) == \
        ("encdec", 12, 12, 768, 12, 16, 64, 3072, 51865, "layernorm",
         "gelu", False, True)


def test_parameters_have_the_reference_tree_and_round_trip():
    params = _reference()[5]
    lm = build_model(_cfgs()[1], device="cpu", seed=0)
    assert isinstance(lm, EncDecLM)
    back = lm_to_reference(_port()[1])
    assert jax.tree.structure(back) == jax.tree.structure(params)
    assert set(back) == {"embed", "pos_table", "enc_layers", "dec_layers",
                         "enc_norm", "dec_norm", "head"}
    assert back["head"] == {} and back["pos_table"].shape == (32768, 64)
    assert set(back["dec_layers"]) == {"norm1", "attn", "norm_x", "xattn",
                                       "norm2", "mlp"}
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, want)
    own = dict(lm.named_parameters())
    for name, p in own.items():
        assert str(p.dtype).removeprefix("torch.") == "float32", name
    assert abs(float(own["pos_table"].detach().std()) - 0.01) < 1e-3
    with pytest.raises(ValueError, match="differ from the port's"):
        lm_from_reference(_cfgs()[1], {**params, "extra": {"w": np.zeros(1)}},
                          "cpu")


def test_full_size_parameter_count_and_cache_shape_are_the_reference_ones():
    ref_cfg, cfg = ref_get_config(ARCH), get_config(ARCH)
    lm = EncDecLM(cfg, device=torch.device("meta"))
    ref_model = ref_build_model(ref_cfg)
    shapes = jax.eval_shape(lambda k: ref_model.init(k)[0],
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    n = sum(p.numel() for p in lm.parameters())
    assert n == sum(int(x.size) for x in jax.tree.leaves(shapes))
    for seq, enc in ((77, None), (448, 1500)):
        want = ref_model.cache_shape(3, seq, enc)
        got = lm.cache_shape(3, seq, enc)
        w_leaves = _leaves(want)
        for name, g in _leaves(got).items():
            w = w_leaves[name]
            assert tuple(g.shape) == w.shape, name
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
    assert got.cross_k.shape == (12, 3, 1500, 16, 64)
    assert got.self_kv.k.shape == (12, 3, 448, 16, 64)


# ---- the pieces ------------------------------------------------------------------

@pytest.mark.parametrize("length,channels", [(1500, 768), (48, 64), (1, 8)])
def test_sinusoids_match_the_reference(length, channels):
    """The port's table is the float64 one rounded once; the reference's
    float32 argument t * inv carries about half an ulp of rounding and up
    to an ulp of inv (XLA's exp and the host's differ in the last bit),
    so row t may differ by up to 1.5 t 2^-23 (1.8e-4 at row 1,499) and
    the first rows by float32 rounding."""
    got = sinusoids(length, channels).numpy()
    want = np.asarray(ref_encdec.sinusoids(length, channels))
    assert got.shape == want.shape == (length, channels)
    t = np.arange(length)[:, None]
    assert (np.abs(got - want) <= 1e-6 + 1.5 * t * 2.0 ** -23).all()
    if length <= 48:
        _close(got, want)


def test_encode_matches_the_reference():
    ref_cfg, model, params, *_ = _reference()
    _, lm = _port()
    frames = _frames(2, F, seed=1)
    want = model.encode(params, jnp.asarray(frames))
    with torch.inference_mode():
        got = lm.encode(torch.from_numpy(frames))
    _close(got, want)
    with pytest.raises(ValueError, match="needs frames"):
        lm.encode(None)


@pytest.mark.parametrize("S", [1, 40])
def test_cross_attention_matches_the_reference_with_padding_heads_zeroed(S):
    """Decode (one query through decode_attention at Senc - 1) and
    prefill (non-causal blockwise) with 4 heads padded to 8: the padding
    heads' output is zeroed, so their weights change nothing."""
    ref_cfg, cfg = _cfgs(n_heads_padded=8, n_kv_heads_padded=4)
    p_ref, _ = ref_attention.cross_attn_init(jax.random.PRNGKey(3), ref_cfg)
    p = {k: torch.from_numpy(np.array(v)) for k, v in p_ref.items()}
    assert p["wk"].shape == (64, 8 * 16)
    enc = _frames(2, F, seed=4)
    x = _frames(2, S, seed=5)
    ck, cv = ref_attention.cross_kv(p_ref, jnp.asarray(enc), ref_cfg)
    want = ref_attention.cross_attn_apply(p_ref, jnp.asarray(x), (ck, cv),
                                          ref_cfg)
    k, v = cross_kv(p, torch.from_numpy(enc), cfg)
    _close(k, ck)
    _close(v, cv)
    got = cross_attn_apply(p, torch.from_numpy(x), (k, v), cfg)
    _close(got, want)
    # the padding heads' rows of wo, and their queries, change nothing
    p2 = dict(p, wo=p["wo"].clone(), wq=p["wq"].clone())
    p2["wo"][4 * 16:] = 7.0
    p2["wq"][:, 4 * 16:] = -3.0
    torch.testing.assert_close(cross_attn_apply(p2, torch.from_numpy(x),
                                                (k, v), cfg), got,
                               rtol=0, atol=0)


# ---- the model ---------------------------------------------------------------------

def test_prefill_and_decode_logits_and_every_cache_leaf_match_the_reference():
    _, _, params, prefill, decode, _ = _reference()
    _, lm = _port()
    toks = _tokens((2, P + 3), seed=6)
    frames = _frames(2, F, seed=7)
    want, want_c = prefill(params, jnp.asarray(toks[:, :P], jnp.int32),
                           jnp.asarray(frames))
    with torch.inference_mode():
        got, got_c = lm.prefill(torch.from_numpy(toks[:, :P]),
                                torch.from_numpy(frames))
    assert isinstance(got_c, EncDecCache)
    assert got_c.cross_k.shape == (2, 2, F, 4, 16)
    want_c = _ref_pad_self(want_c, P + 3)
    got_c = pad_kv(got_c, P + 3)
    assert got_c.cross_k.shape[2] == F
    for g in range(4):
        _close(got, want, f"logits {g}")
        _close_cache(got_c, want_c, str(g))
        if g == 3:
            break
        want, want_c = decode(params, want_c,
                              jnp.asarray(toks[:, P + g], jnp.int32),
                              jnp.full((2,), P + g, jnp.int32))
        with torch.inference_mode():
            got, got_c = lm.decode_step(got_c,
                                        torch.from_numpy(toks[:, P + g]),
                                        torch.full((2,), P + g))


def test_decode_equals_a_longer_prefill():
    _, lm = _port()
    toks = torch.from_numpy(_tokens((2, P + 4), seed=8))
    frames = torch.from_numpy(_frames(2, F, seed=9))
    with torch.inference_mode():
        _, caches = lm.prefill(toks[:, :P], frames)
        caches = pad_kv(caches, P + 4)
        for g in range(4):
            stepped, caches = lm.decode_step(caches, toks[:, P + g],
                                             torch.full((2,), P + g))
            whole, _ = lm.prefill(toks[:, :P + g + 1], frames)
            _close(stepped, whole, f"step {g}")
        with pytest.raises(IndexError, match="outside the cache"):
            lm.decode_step(caches, toks[:, 0], torch.full((2,), P + 4))


def test_loss_matches_the_reference():
    _, model, params, *_ = _reference()
    _, lm = _port()
    toks = _tokens((2, P), seed=10)
    labels = _tokens((2, P), seed=11)
    labels[0, :5] = -1
    frames = _frames(2, F, seed=12)
    want = model.loss_fn(params, {"frames": jnp.asarray(frames),
                                  "tokens": jnp.asarray(toks, jnp.int32),
                                  "labels": jnp.asarray(labels, jnp.int32)})
    got = lm.loss_fn({"frames": torch.from_numpy(frames),
                      "tokens": torch.from_numpy(toks),
                      "labels": torch.from_numpy(labels)})
    _close(got, want)


def test_prefill_step_passes_frames_and_refuses_patches():
    _, lm = _port()
    toks = torch.from_numpy(_tokens((2, 8), seed=13))
    frames = torch.from_numpy(_frames(2, 16, seed=14))
    step = make_prefill_step(lm)
    with torch.inference_mode():
        got, _ = step(toks, extra={"frames": frames, "other": 1})
        want, _ = lm.prefill(toks, frames)
        assert torch.equal(got, want)
        with pytest.raises(TypeError):
            step(toks, extra={"frames": frames,
                              "patches": torch.zeros(2, 8, 64)})


def test_padding_the_cross_leaves_changes_decode():
    """With frames as long as the prompt, the reference's serving CLI
    pads every cache leaf whose axis 2 is the prompt length: the cross
    K/V gain zero rows, which decode's cross-attention reads as encoder
    rows.  Its decode logits then move away from the self-only padding
    that the port's ``pad_kv`` does."""
    _, _, params, prefill, decode, _ = _reference()
    toks = _tokens((2, P + 1), seed=15)
    frames = _frames(2, P, seed=16)
    _, caches = prefill(params, jnp.asarray(toks[:, :P], jnp.int32),
                        jnp.asarray(frames))

    def pad_all(x):   # the reference CLI's pad_caches
        if x.ndim >= 3 and x.shape[2] == P:
            return jnp.pad(x, [(0, 0), (0, 0), (0, 8)] + [(0, 0)] *
                           (x.ndim - 3))
        return x

    args = (jnp.asarray(toks[:, P], jnp.int32), jnp.full((2,), P, jnp.int32))
    padded_all = jax.tree.map(pad_all, caches)
    assert padded_all.cross_k.shape[2] == P + 8
    right, _ = decode(params, _ref_pad_self(caches, P + 8), *args)
    wrong, _ = decode(params, padded_all, *args)
    assert float(jnp.abs(right - wrong).max()) > 1e-3
    _, lm = _port()
    with torch.inference_mode():
        _, got_c = lm.prefill(torch.from_numpy(toks[:, :P]),
                              torch.from_numpy(frames))
        got, _ = lm.decode_step(pad_kv(got_c, P + 8),
                                torch.from_numpy(toks[:, P]),
                                torch.full((2,), P))
    _close(got, right)


# ---- serving -------------------------------------------------------------------------

def _reference_greedy(params, prompts, frames, gen):
    cfg, _, _, prefill, decode, _ = _reference()
    B, Pl = prompts.shape
    logits, caches = prefill(params, jnp.asarray(prompts, jnp.int32),
                             jnp.asarray(frames))
    caches = _ref_pad_self(caches, Pl + gen)
    tok = jnp.argmax(logits[:, :cfg.vocab], -1).astype(jnp.int32)
    out = [np.asarray(tok)]
    for g in range(gen - 1):
        logits, caches = decode(params, caches, tok,
                                jnp.full((B,), Pl + g, jnp.int32))
        tok = jnp.argmax(logits[:, :cfg.vocab], -1).astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.stack(out, 1)


def test_greedy_serve_loop_with_longer_frames_gives_the_reference_tokens():
    """Two waves of 2 prompts of 40 tokens over 56 frames: each wave's
    frames drawn after its prompts."""
    cfg, lm = _port()
    res = serve(cfg, lm, batch=2, prompt_len=P, gen=5, requests=2, seed=0,
                device="cpu", n_frames=56)
    params = _reference()[2]
    rng = np.random.default_rng(0)
    for wave in range(2):
        prompts = rng.integers(0, cfg.vocab, (2, P))
        frames = rng.standard_normal((2, 56, 64), dtype=np.float32)
        np.testing.assert_array_equal(
            res["tokens"][wave], _reference_greedy(params, prompts, frames,
                                                   5))


def test_serve_cli_gives_the_reference_tokens(capsys):
    """``serve --arch whisper-small --reduced --device cpu`` (frames as
    long as the prompt): its seed-0 model carried to the reference with
    lm_to_reference, whose jitted loop with only the self-attention KV
    padded gives the CLI's tokens."""
    res = serve_main(["--arch", ARCH, "--reduced", "--batch", "2",
                      "--prompt-len", str(P), "--gen", "4", "--requests",
                      "1", "--device", "cpu"])
    assert "[serve] wave 0: generated 2x4 tokens" in capsys.readouterr().out
    cfg = get_config(ARCH).reduced()
    lm = build_model(cfg, device="cpu", seed=0)
    params = jax.tree.map(jnp.asarray, lm_to_reference(lm))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (2, P))
    frames = rng.standard_normal((2, P, 64), dtype=np.float32)
    np.testing.assert_array_equal(
        res["tokens"][0], _reference_greedy(params, prompts, frames, 4))


def test_self_kv_leaves_are_the_reference_layout():
    _, lm = _port()
    with torch.inference_mode():
        _, c = lm.prefill(torch.from_numpy(_tokens((1, 4), seed=17)),
                          torch.from_numpy(_frames(1, 6, seed=18)))
    assert isinstance(c.self_kv, KVCache)
    assert c.self_kv.k.shape == (2, 1, 4, 2, 16)
    assert c.cross_v.shape == (2, 1, 6, 4, 16)
