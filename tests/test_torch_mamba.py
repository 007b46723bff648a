"""The port's falcon-mamba serving path (repro_torch.models,
repro_torch.launch.serve) against the reference LM.

The reference's reduced falcon-mamba config (float32) is initialized from
``PRNGKey(0)`` and carried into the port with ``interop.lm_from_reference``,
so both compute the same function; inputs are made with NumPy from a seed.
Outputs, logits and caches are held to atol 1e-5, the reference's own bar
between its two scan paths (tests/test_ssm_kernel.py).  The ops whose
rounding differs between the two frameworks are the float32 matrix
products (another summation order), exp and softplus, and the "assoc"
scan's association order; the "kernel" scan is bit-equal
(tests/test_torch_ssm.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import CANONICAL as REF_CANONICAL
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models.layers import apply_norm as ref_apply_norm
from repro.models.layers import logits_apply as ref_logits_apply
from repro.models.mamba import MambaCache as RefCache
from repro.models.mamba import mamba_apply as ref_mamba_apply
from repro_torch.configs import ARCH_IDS, CANONICAL, PORTED, get_config
from repro_torch.interop import lm_from_reference
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve
from repro_torch.launch.train import train
from repro_torch.models import LM, build_model
from repro_torch.models.layers import apply_norm, logits_apply
from repro_torch.models.mamba import MambaCache, mamba_apply

ATOL = 1e-5
ARCH = "falcon-mamba-7b"


def _cfgs(impl):
    ref = dataclasses.replace(ref_get_config(ARCH).reduced(), ssm_impl=impl)
    port = dataclasses.replace(get_config(ARCH).reduced(), ssm_impl=impl)
    return ref, port


@functools.cache
def _reference(impl):
    """(reference cfg, model, params, jitted prefill, jitted decode, params
    as NumPy)."""
    cfg, _ = _cfgs(impl)
    model = ref_build_model(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    prefill = jax.jit(model.prefill)
    decode = jax.jit(model.decode_step)
    return cfg, model, params, prefill, decode, jax.tree.map(np.asarray,
                                                             params)


def _port(impl):
    _, port_cfg = _cfgs(impl)
    return port_cfg, lm_from_reference(port_cfg, _reference(impl)[5], "cpu")


def _close(got, want, name=""):
    if isinstance(got, torch.Tensor):    # trainable parameters: detach
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=0, err_msg=name)


def _close_cache(got, want):
    _close(got.h, want.h, "h")
    _close(got.conv, want.conv, "conv")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


# ---- configs and layers -----------------------------------------------------

def test_config_registry_is_the_reference_one():
    assert ARCH_IDS == REF_ARCH_IDS and CANONICAL == REF_CANONICAL
    for arch in (ARCH, "falcon_mamba_7b"):
        cfg, ref = get_config(arch), ref_get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert cfg.n_params() == ref.n_params()
        assert dataclasses.asdict(cfg.reduced()) == \
            dataclasses.asdict(ref.reduced())
    assert set(PORTED) == set(ARCH_IDS) == set(CANONICAL.values())
    for arch, key in CANONICAL.items():
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(ref_get_config(key))
    with pytest.raises(KeyError):
        get_config("gpt-2")


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_the_reference(kind):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.normal(size=64).astype(np.float32),
         "bias": rng.normal(size=64).astype(np.float32)}
    want = ref_apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), kind)
    got = apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), kind)
    _close(got, want)


def test_logits_mask_the_padded_vocabulary_as_the_reference_does():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), vocab=200)
    assert cfg.vocab_padded == 256
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 64)).astype(np.float32)
    w = rng.normal(size=(64, 256)).astype(np.float32)
    ref_cfg = dataclasses.replace(ref_get_config(ARCH).reduced(), vocab=200)
    want = ref_logits_apply({"w": jnp.asarray(w)}, jnp.asarray(x), ref_cfg)
    got = logits_apply({"w": torch.from_numpy(w)}, torch.from_numpy(x), cfg)
    _close(got, want)
    assert (got[:, 200:] == -1e9).all()


def test_parameters_have_the_reference_names_shapes_and_dtypes():
    cfg, params = _reference("assoc")[0], _reference("assoc")[2]
    lm = build_model(get_config(ARCH).reduced(), device="cpu", seed=0)
    ref = {"embed.table": params["embed"]["table"],
           "final_norm.scale": params["final_norm"]["scale"],
           "head.w": params["head"]["w"]}
    for group in ("norm1", "ssm"):
        for k, v in params["layers"][group].items():
            for i in range(cfg.n_layers):
                ref[f"blocks.{i}.{group}.{k}"] = v[i]
    got = dict(lm.named_parameters())
    assert set(got) == set(ref)
    for name, p in got.items():
        assert tuple(p.shape) == ref[name].shape, name
        assert str(p.dtype).removeprefix("torch.") == str(ref[name].dtype)
        assert p.requires_grad
    # the reference's scales: N(0, 1/in) weights, N(0, 0.01^2) embedding
    w_in = lm.blocks[0].ssm["w_in"].detach()
    assert abs(float(w_in.std()) - 64 ** -0.5) < 0.01
    assert abs(float(lm.embed["table"].detach().std()) - 0.01) < 0.001
    same = build_model(get_config(ARCH).reduced(), device="cpu", seed=0)
    other = build_model(get_config(ARCH).reduced(), device="cpu", seed=1)
    assert torch.equal(same.head["w"], lm.head["w"])
    assert not torch.equal(other.head["w"], lm.head["w"])


def test_full_size_parameter_count_is_the_reference_one():
    cfg = get_config(ARCH)
    lm = LM(cfg, device=torch.device("meta"))
    n = sum(p.numel() for p in lm.parameters())
    ref_model = ref_build_model(ref_get_config(ARCH))
    shapes = jax.eval_shape(lambda k: ref_model.init(k)[0],
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    assert n == sum(int(x.size) for x in jax.tree.leaves(shapes))
    assert 0.85 <= n / 7.3e9 <= 1.2
    bf16 = {p.dtype for p in lm.parameters()} - {torch.float32}
    assert bf16 == {torch.bfloat16}


def test_cache_shapes_are_the_reference_ones():
    ref_cfg, model = _reference("assoc")[:2]
    _, port = _port("assoc")
    want = model.cache_shape(3, 77)
    got = port.cache_shape(3, 77)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)


@pytest.mark.parametrize("arch", ["whisper-small", "phi-3-vision-4.2b",
                                  "deepseek-v2-236b"])
def test_train_still_refuses_the_encdec_vlm_and_mla_families(arch):
    """Named for the refusal ``train`` made before the three served last
    were trained: it now trains each, whisper with its stub frames and
    phi-3-vision with its patches, and the losses are finite."""
    cfg = get_config(arch).reduced()
    lm = build_model(cfg, device="cpu", seed=0)
    res = train(cfg, lm, batch=2, seq=32, steps=2, device="cpu")
    assert np.isfinite(res["losses"]).all()
    assert np.isfinite(res["grad_norms"]).all()


def test_an_ssm_block_with_an_mlp_matches_the_reference():
    """falcon-mamba with d_ff set: the reference builds norm2 and an MLP
    of its own kind ("none" falls through to the tanh GELU) after the
    Mamba mixer, and so does the port."""
    ref_cfg = dataclasses.replace(ref_get_config(ARCH).reduced(), d_ff=128,
                                  ssm_impl="kernel")
    cfg = dataclasses.replace(get_config(ARCH).reduced(), d_ff=128,
                              ssm_impl="kernel")
    model = ref_build_model(ref_cfg)
    params, _ = model.init(jax.random.PRNGKey(1))
    assert set(params["layers"]) == {"norm1", "ssm", "norm2", "mlp"}
    assert set(params["layers"]["mlp"]) == {"w_in", "w_down"}
    lm = lm_from_reference(cfg, jax.tree.map(np.asarray, params), "cpu")
    prompts = _tokens(ref_cfg, (2, 24), seed=12)
    tok = _tokens(ref_cfg, (2,), seed=13)
    pos = np.full((2,), 24)
    logits_r, caches_r = jax.jit(model.prefill)(
        params, jnp.asarray(prompts, jnp.int32))
    step_r, _ = jax.jit(model.decode_step)(params, caches_r,
                                           jnp.asarray(tok, jnp.int32),
                                           jnp.asarray(pos, jnp.int32))
    with torch.inference_mode():
        logits, caches = lm.prefill(torch.from_numpy(prompts))
        step, _ = lm.decode_step(caches, torch.from_numpy(tok),
                                 torch.from_numpy(pos))
    _close(logits, logits_r, "prefill logits")
    _close_cache(caches, caches_r)
    _close(step, step_r, "decode logits")


# ---- mamba_apply ------------------------------------------------------------

@pytest.mark.parametrize("impl", ["assoc", "kernel"])
@pytest.mark.parametrize("chunk", [512, 16])
def test_mamba_apply_matches_the_reference(impl, chunk):
    ref_cfg, _, params, *_ = _reference(impl)
    port_cfg, lm = _port(impl)
    p_ref = jax.tree.map(lambda a: a[1], params["layers"]["ssm"])
    p = lm.blocks[1].ssm
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 48, 64)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, 64)).astype(np.float32)

    apply = jax.jit(functools.partial(ref_mamba_apply, cfg=ref_cfg,
                                      chunk=chunk),
                    static_argnames=("mode",))
    y_r, c_r = apply(p_ref, jnp.asarray(x), mode="prefill")
    y, c = mamba_apply(p, torch.from_numpy(x), port_cfg, mode="prefill",
                       chunk=chunk)
    _close(y, y_r, "prefill out")
    _close_cache(c, c_r)

    y1_r, c1_r = apply(p_ref, jnp.asarray(x1), mode="decode", cache=c_r)
    y1, c1 = mamba_apply(p, torch.from_numpy(x1), port_cfg, mode="decode",
                         cache=c)
    _close(y1, y1_r, "decode out")
    _close_cache(c1, c1_r)

    y_t, c_t = mamba_apply(p, torch.from_numpy(x), port_cfg, mode="train",
                           chunk=chunk)
    assert c_t is None and torch.equal(y_t, y)


def test_mamba_apply_rejects_a_sequence_that_does_not_divide_into_chunks():
    port_cfg, lm = _port("kernel")
    x = torch.zeros((1, 20, 64))
    with pytest.raises(ValueError, match="chunks of 16"):
        mamba_apply(lm.blocks[0].ssm, x, port_cfg, mode="prefill", chunk=16)


# ---- LM ---------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["assoc", "kernel"])
def test_prefill_and_decode_logits_and_caches_match_the_reference(impl):
    ref_cfg, _, params, prefill, decode, _ = _reference(impl)
    port_cfg, lm = _port(impl)
    prompts = _tokens(ref_cfg, (2, 24), seed=6)
    steps = _tokens(ref_cfg, (3, 2), seed=7)
    logits_r, caches_r = prefill(params, jnp.asarray(prompts, jnp.int32))
    with torch.inference_mode():
        logits, caches = lm.prefill(torch.from_numpy(prompts))
    _close(logits, logits_r, "prefill logits")
    _close_cache(caches, caches_r)
    assert isinstance(caches, MambaCache) and isinstance(caches_r, RefCache)
    for k, tok in enumerate(steps):
        pos = np.full((2,), 24 + k)
        logits_r, caches_r = decode(params, caches_r,
                                    jnp.asarray(tok, jnp.int32),
                                    jnp.asarray(pos, jnp.int32))
        with torch.inference_mode():
            logits, caches = lm.decode_step(caches, torch.from_numpy(tok),
                                            torch.from_numpy(pos))
        _close(logits, logits_r, f"decode {k} logits")
        _close_cache(caches, caches_r)


@pytest.mark.parametrize("impl", ["assoc", "kernel"])
def test_prefill_then_decode_equals_a_longer_prefill(impl):
    port_cfg, lm = _port(impl)
    toks = torch.from_numpy(_tokens(port_cfg, (2, 33), seed=8))
    with torch.inference_mode():
        _, caches = lm.prefill(toks[:, :32])
        stepped, c_step = lm.decode_step(caches, toks[:, 32],
                                         torch.full((2,), 32))
        whole, c_whole = lm.prefill(toks)
    _close(stepped, whole, "logits")
    _close_cache(c_step, c_whole)


def _reference_greedy(impl, prompts, gen):
    """The reference's jitted prefill/decode loop, without padding the
    caches (see ROADMAP queue 3 on the reference's serve driver)."""
    cfg, _, params, prefill, decode, _ = _reference(impl)
    logits, caches = prefill(params, jnp.asarray(prompts, jnp.int32))
    tok = jnp.argmax(logits[:, :cfg.vocab], -1).astype(jnp.int32)
    out = [np.asarray(tok)]
    for g in range(gen - 1):
        pos = jnp.full((prompts.shape[0],), prompts.shape[1] + g, jnp.int32)
        logits, caches = decode(params, caches, tok, pos)
        tok = jnp.argmax(logits[:, :cfg.vocab], -1).astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.stack(out, 1)


@pytest.mark.parametrize("impl", ["assoc", "kernel"])
def test_greedy_serve_loop_gives_the_reference_tokens(impl, capsys):
    ref_cfg, params_np = _reference(impl)[0], _reference(impl)[5]
    port_cfg, _ = _cfgs(impl)
    res = serve(port_cfg, lm_from_reference(port_cfg, params_np, "cpu"),
                batch=2, prompt_len=16, gen=8, requests=2, seed=0,
                device="cpu")
    rng = np.random.default_rng(0)     # serve's prompt stream
    for wave in range(2):
        prompts = rng.integers(0, ref_cfg.vocab, (2, 16))
        np.testing.assert_array_equal(res["tokens"][wave],
                                      _reference_greedy(impl, prompts, 8))
    assert res["n_tokens"] == 32 and len(res["prefill_s"]) == 2
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("[serve] 32 tokens in ")


def test_serving_at_a_prompt_length_equal_to_d_inner_decodes_correctly():
    """The reference's serve driver pads the SSM state when the prompt
    length equals d_inner (128 in the reduced config) and then fails; the
    port pads nothing and decodes as the reference's model does."""
    ref_cfg, params_np = _reference("kernel")[0], _reference("kernel")[5]
    port_cfg, _ = _cfgs("kernel")
    assert port_cfg.d_inner == 128
    res = serve(port_cfg, lm_from_reference(port_cfg, params_np, "cpu"),
                batch=2, prompt_len=128, gen=4, requests=1, seed=0,
                device="cpu")
    prompts = np.random.default_rng(0).integers(0, ref_cfg.vocab, (2, 128))
    np.testing.assert_array_equal(res["tokens"][0],
                                  _reference_greedy("kernel", prompts, 4))


def test_serve_cli_on_the_cpu_decodes_what_a_longer_prefill_predicts(capsys):
    res = serve_main(["--arch", ARCH, "--reduced", "--batch", "2",
                      "--prompt-len", "128",
                      "--gen", "4", "--requests", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "allow_bf16_reduced_precision_reduction': False" in out
    assert "[serve] wave 0: generated 2x4 tokens" in out
    cfg = get_config(ARCH).reduced()
    lm = build_model(cfg, device="cpu", seed=0)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 128))
    seq = torch.from_numpy(np.concatenate([prompts, res["tokens"][0]], 1))
    with torch.inference_mode():
        for g in range(4):
            logits, _ = lm.prefill(seq[:, :128 + g])
            np.testing.assert_array_equal(
                logits[:, :cfg.vocab].argmax(-1).numpy(),
                res["tokens"][0][:, g])
