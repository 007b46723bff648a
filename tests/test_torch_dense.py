"""The port's dense family (qwen3-32b, granite-20b, nemotron-4-340b,
llama3-405b) against the reference LM, and the port's boundary: every
architecture builds, and ``train`` runs every family (the training parity
checks are tests/test_torch_train_*.py).

Each reduced config (float32, 2 layers, d_model 64, chunks of 32) is
initialized by the reference from ``PRNGKey(0)`` and carried into the
port with ``interop.lm_from_reference``; prompts are made with NumPy from
a seed.  The four cover the dense block's variants: SwiGLU (llama3),
tanh GELU with one KV head (granite, MQA), squared ReLU (nemotron) and
qk-norm (qwen3).  Logits and caches are held to atol 1e-5, the bar of
the other LM tests (float32 products summed in other orders).
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
from repro_torch.interop import lm_from_reference, lm_to_reference
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import pad_kv
from repro_torch.launch.train import train
from repro_torch.models import LM, build_model
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import apply_norm, mlp_apply
from repro_torch.models.transformer import check_ported

ATOL = 1e-5
DENSE = ("qwen3-32b", "granite-20b", "nemotron-4-340b", "llama3-405b")
P = 40                      # prompt length: two kv chunks of the reduced
LAST_THREE = ("deepseek-v2-236b", "whisper-small", "phi-3-vision-4.2b")


@functools.cache
def _reference(arch, d_ff=None):
    """(reference cfg, params, jitted prefill, jitted decode, params as
    NumPy) of the reduced ``arch`` (``d_ff`` replaced where given)."""
    cfg = ref_get_config(arch).reduced()
    if d_ff is not None:
        cfg = dataclasses.replace(cfg, d_ff=d_ff)
    model = ref_build_model(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    return (cfg, params, jax.jit(model.prefill), jax.jit(model.decode_step),
            jax.tree.map(np.asarray, params))


def _port(arch, d_ff=None):
    cfg = get_config(arch).reduced()
    if d_ff is not None:
        cfg = dataclasses.replace(cfg, d_ff=d_ff)
    return cfg, lm_from_reference(cfg, _reference(arch, d_ff)[4], "cpu")


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


# ---- configs, parameters, cache shapes ---------------------------------------

def test_registry_names_the_seven_ported_architectures():
    """The seven of the earlier slices, then the last three: all ten."""
    assert PORTED[:7] == ("falcon_mamba_7b", "hymba_1_5b", "qwen3_32b",
                          "granite_20b", "nemotron_4_340b", "llama3_405b",
                          "llama4_scout_17b_a16e")
    assert PORTED[7:] == ("deepseek_v2_236b", "whisper_small",
                          "phi_3_vision_4_2b")


@pytest.mark.parametrize("arch", DENSE)
def test_config_is_the_reference_one(arch):
    cfg, ref = get_config(arch), ref_get_config(arch)
    assert cfg.family == "dense"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.n_params() == ref.n_params()
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert get_config(arch.replace("-", "_").replace(".", "_")) == cfg


def test_qwen3_is_the_published_config():
    cfg = get_config("qwen3-32b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab, cfg.qk_norm, cfg.rope_theta,
            cfg.mlp_kind, cfg.param_dtype) == \
        (64, 5120, 64, 8, 128, 25600, 151936, True, 1e6, "swiglu",
         "bfloat16")
    assert cfg.n_params() == 32_761_446_400


@pytest.mark.parametrize("arch", DENSE)
def test_full_size_parameter_count_and_cache_shape_are_the_reference_ones(
        arch):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    lm = LM(cfg, device=torch.device("meta"))
    ref_model = ref_build_model(ref_cfg)
    shapes = jax.eval_shape(lambda k: ref_model.init(k)[0],
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    assert set(dict(lm.blocks[0].named_children())) == \
        set(shapes["layers"]) == {"norm1", "attn", "norm2", "mlp"}
    n = sum(p.numel() for p in lm.parameters())
    assert n == sum(int(x.size) for x in jax.tree.leaves(shapes))
    # the formula leaves out the norms and the vocabulary's padding rows
    assert 1.0 <= n / cfg.n_params() <= 1.002
    want = ref_model.cache_shape(3, 77)
    got = lm.cache_shape(3, 77)
    assert isinstance(got, KVCache)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (cfg.n_layers, 3, 77, cfg.n_kv_heads,
                                      cfg.d_head)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)


@pytest.mark.parametrize("arch", DENSE)
def test_parameters_have_the_reference_names_shapes_and_dtypes(arch):
    _, params, *_ = _reference(arch)
    lm = build_model(get_config(arch).reduced(), device="cpu", seed=0)
    ref = {f"{g}.{k}": v for g in ("embed", "final_norm", "head")
           for k, v in params[g].items()}
    for group, leaves in params["layers"].items():
        for k, v in leaves.items():
            for i in range(v.shape[0]):
                ref[f"blocks.{i}.{group}.{k}"] = v[i]
    got = dict(lm.named_parameters())
    assert set(got) == set(ref)
    for name, p in got.items():
        assert tuple(p.shape) == ref[name].shape, name
        assert str(p.dtype).removeprefix("torch.") == str(ref[name].dtype)
    back = lm_to_reference(_port(arch)[1])
    for group, leaves in params["layers"].items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(back["layers"][group][k],
                                          np.asarray(v))


# ---- the LM -------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_logits_and_caches_match_the_reference(arch):
    _, params, prefill, decode, _ = _reference(arch)
    cfg, lm = _port(arch)
    steps = 3
    prompts = _tokens((2, P), seed=6)
    toks = _tokens((steps, 2), seed=7)
    logits_r, caches_r = prefill(params, jnp.asarray(prompts, jnp.int32))
    with torch.inference_mode():
        logits, caches = lm.prefill(torch.from_numpy(prompts))
    _close(logits, logits_r, "prefill logits")
    assert isinstance(caches, KVCache)
    assert caches.k.shape == (2, 2, P, cfg.n_kv_heads, 16)
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


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_equals_a_longer_prefill(arch):
    _, lm = _port(arch)
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
    _close(caches.k, c_whole.k, "k")
    _close(caches.v, c_whole.v, "v")


def test_the_dense_block_is_attention_then_the_mlp():
    """Zeroing the attention's output projection leaves x + mlp(norm2(x))."""
    cfg, lm = _port("qwen3-32b")
    block = lm.blocks[0]
    assert not hasattr(block, "ssm")
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 32, 64)).astype(np.float32))
    with torch.no_grad():
        block.attn["wo"].zero_()
        out, _ = block(x, mode="train", positions=torch.arange(32)[None])
        want = x + mlp_apply(block.mlp, apply_norm(block.norm2, x,
                                                   cfg.norm_kind), cfg)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)


def test_an_attention_only_block_matches_the_reference():
    """d_ff = 0 in a dense config: the reference builds no norm2 and no
    MLP, and neither does the port; lm_from_reference carries the
    attention-only block."""
    _, params, prefill, _, _ = _reference("llama3-405b", d_ff=0)
    _, lm = _port("llama3-405b", d_ff=0)
    assert set(params["layers"]) == {"norm1", "attn"}
    assert set(dict(lm.blocks[0].named_children())) == {"norm1", "attn"}
    prompts = _tokens((2, P), seed=4)
    want, _ = prefill(params, jnp.asarray(prompts, jnp.int32))
    with torch.inference_mode():
        got, _ = lm.prefill(torch.from_numpy(prompts))
    _close(got, want, "logits")


# ---- serving -----------------------------------------------------------------

def test_serve_cli_gives_the_reference_tokens(capsys):
    """The CLI's model (build_model, seed 0) carried to the reference with
    lm_to_reference: the reference's jitted greedy loop gives the CLI's
    tokens."""
    arch = "qwen3-32b"
    res = serve_main(["--arch", arch, "--reduced", "--batch", "2",
                      "--prompt-len", str(P), "--gen", "5", "--requests",
                      "1", "--device", "cpu"])
    assert "[serve] wave 0: generated 2x5 tokens" in capsys.readouterr().out
    cfg = get_config(arch).reduced()
    lm = build_model(cfg, device="cpu", seed=0)
    params = jax.tree.map(jnp.asarray, lm_to_reference(lm))
    _, _, prefill, decode, _ = _reference(arch)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, P))
    logits, caches = prefill(params, jnp.asarray(prompts, jnp.int32))
    caches = _ref_pad_kv(caches, P + 5)
    tok = jnp.argmax(logits[:, :cfg.vocab], -1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for g in range(4):
        logits, caches = decode(params, caches, tok,
                                jnp.full((2,), P + g, jnp.int32))
        tok = jnp.argmax(logits[:, :cfg.vocab], -1).astype(jnp.int32)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(res["tokens"][0], np.stack(want, 1))


# ---- the boundary ------------------------------------------------------------

@pytest.mark.parametrize("arch", LAST_THREE)
def test_mla_encdec_and_vlm_build_and_their_configs_are_the_reference_ones(
        arch):
    cfg, ref = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(ref.reduced())
    lm = build_model(cfg.reduced(), device="cpu", seed=0)
    assert type(lm).__name__ == ("EncDecLM" if cfg.family == "encdec"
                                 else "LM")
    if cfg.family == "encdec":   # LM runs every family but encdec
        with pytest.raises(NotImplementedError, match="EncDecLM"):
            check_ported(cfg)
    else:
        check_ported(cfg)


@pytest.mark.parametrize("arch,family", [("qwen3-32b", "dense"),
                                         ("llama4-scout-17b-a16e", "moe"),
                                         ("hymba-1.5b", "hybrid")])
def test_train_refuses_every_family_but_ssm(arch, family):
    """Named for the refusal ``train`` made before these families were
    trained: it now trains each, with the config's optimizer, and the
    loss is finite."""
    cfg = get_config(arch).reduced()
    assert cfg.family == family
    lm = build_model(cfg, device="cpu", seed=0)
    res = train(cfg, lm, batch=2, seq=32, steps=1, device="cpu")
    assert len(res["losses"]) == 1 and np.isfinite(res["losses"]).all()
