"""The port's attention, MLPs and RoPE (repro_torch.models.attention,
repro_torch.models.layers) against the reference's.

Inputs and weights are made with NumPy from a seed and fed to both
packages in float32; outputs and caches are held to atol 1e-5, the bar of
tests/test_torch_mamba.py (float32 products summed in another order, and
exp, sin, cos and tanh that differ in the last bit).  The configs are the
reference's reduced hymba-1.5b (window 32, chunks of 32, 4 heads over 2
KV heads of 16), replaced where a case needs qk-norm or padded heads.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models.layers import apply_rope as ref_apply_rope
from repro.models.layers import mlp_apply as ref_mlp_apply
from repro.models.layers import rope_frequencies as ref_rope_frequencies
from repro_torch.configs import get_config
from repro_torch.models import attention
from repro_torch.models.layers import (apply_rope, mlp_apply, mlp_init,
                                       rope_frequencies)

ATOL = 1e-5
ARCH = "hymba-1.5b"


def _cfgs(**kw):
    return (dataclasses.replace(ref_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def _close(got, want, name="", atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().float()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=name)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---- MLPs and RoPE ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["swiglu", "relu2", "gelu"])
def test_mlp_apply_matches_the_reference(kind):
    ref_cfg, cfg = _cfgs(mlp_kind=kind)
    rng = np.random.default_rng(1)
    p = mlp_init(None, cfg, "cpu")
    names = {"swiglu": ("w_gate", "w_up", "w_down")}.get(kind,
                                                         ("w_in", "w_down"))
    assert sorted(p) == sorted(names)
    weights = {k: _normal(rng, *p[k].shape, scale=0.3) for k in names}
    x = _normal(rng, 2, 7, cfg.d_model)
    want = ref_mlp_apply({k: jnp.asarray(v) for k, v in weights.items()},
                         jnp.asarray(x), ref_cfg)
    got = mlp_apply({k: torch.from_numpy(v) for k, v in weights.items()},
                    torch.from_numpy(x), cfg)
    assert got.shape == (2, 7, cfg.d_model) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("shape,heads", [((2, 9, 3, 16), True),
                                         ((2, 9, 24), False)])
def test_apply_rope_matches_the_reference(shape, heads):
    rng = np.random.default_rng(2)
    x = _normal(rng, *shape)
    positions = rng.integers(0, 3000, shape[:2])
    want = ref_apply_rope(jnp.asarray(x), jnp.asarray(positions), 10000.0)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(positions),
                     10000.0)
    _close(got, want)
    assert got.shape == shape and (got.dim() == 4) == heads
    _close(rope_frequencies(shape[-1], 10000.0),
           ref_rope_frequencies(shape[-1], 10000.0))


def test_apply_rope_rotates_halves_and_keeps_the_dtype():
    x = torch.zeros((1, 1, 1, 8), dtype=torch.bfloat16)
    x[..., 0] = 1                        # first half, frequency 1
    out = apply_rope(x, torch.tensor([[1]]), 10000.0)
    assert out.dtype == torch.bfloat16
    # (cos 1, sin 1) lands in lanes 0 and 4, not in an interleaved pair
    assert float(out[..., 4]) == pytest.approx(np.sin(1.0), abs=4e-3)
    assert float(out[..., 0]) == pytest.approx(np.cos(1.0), abs=4e-3)
    assert float(out[..., 1].abs()) == 0


# ---- blockwise and decode attention -------------------------------------------

def test_fit_chunk_and_neg_inf_are_the_reference_ones():
    assert attention.NEG_INF == ref_attn.NEG_INF == -1e30
    for S in (1, 7, 32, 50, 96, 2048):
        for c in (1, 5, 12, 16, 32, 512):
            assert attention._fit_chunk(S, c) == ref_attn._fit_chunk(S, c)


# (Sq, Sk, q_chunk, kv_chunk, window, q_offset, causal)
BLOCKWISE = [
    (48, 48, 16, 16, None, 0, True),
    (50, 50, 16, 12, None, 0, True),      # chunks fit to 10 and 10
    (96, 96, 32, 32, 32, 0, True),        # the reduced hymba's schedule
    (96, 96, 16, 32, 20, 0, True),        # the window masks whole chunks
    (90, 90, 32, 64, 7, 0, True),         # 30 and 45: a ragged schedule
    (64, 64, 16, 16, None, 0, False),
    (64, 64, 16, 16, 24, 0, False),
    (16, 40, 8, 16, 16, 24, True),        # queries past the keys' start
    (24, 64, 8, 16, None, 40, True),
]


@pytest.mark.parametrize("Sq,Sk,qc,kc,window,q_offset,causal", BLOCKWISE)
def test_blockwise_attention_matches_the_reference(Sq, Sk, qc, kc, window,
                                                   q_offset, causal):
    rng = np.random.default_rng(Sq + Sk + qc)
    q, k, v = (_normal(rng, 2, S, 4, 16) for S in (Sq, Sk, Sk))
    kw = dict(causal=causal, q_chunk=qc, kv_chunk=kc, window=window,
              q_offset=q_offset)
    want = ref_attn.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                        **kw)
    got = attention.blockwise_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), **kw)
    assert got.shape == (2, Sq, 4, 16) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    _close(got, want)


def test_blockwise_attention_in_bfloat16_follows_the_reference():
    """bf16 operands: products and sums in float32, p cast to V's dtype
    before the PV product, the output in bf16.  The two packages' exp
    differ in the last float32 bit, which can move a rounding of p to
    bf16, so the outputs agree to a bf16 step of an O(1) value."""
    rng = np.random.default_rng(3)
    q, k, v = (_normal(rng, 2, 96, 4, 16) for _ in range(3))
    kw = dict(causal=True, q_chunk=32, kv_chunk=32, window=32)
    want = ref_attn.blockwise_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), **kw)
    got = attention.blockwise_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), **kw)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)), atol=2 ** -7)


@pytest.mark.parametrize("window", [None, 8, 32])
def test_decode_attention_matches_the_reference(window):
    rng = np.random.default_rng(4)
    q = _normal(rng, 3, 1, 4, 16)
    kc, vc = _normal(rng, 3, 50, 4, 16), _normal(rng, 3, 50, 4, 16)
    pos = np.array([0, 17, 49])
    want = ref_attn.decode_attention(*(jnp.asarray(a) for a in (q, kc, vc)),
                                     jnp.asarray(pos), window=window)
    got = attention.decode_attention(
        *(torch.from_numpy(a) for a in (q, kc, vc)), torch.from_numpy(pos),
        window=window)
    assert got.shape == (3, 1, 4, 16)
    _close(got, want)


def test_repeat_kv_is_kv_major():
    rng = np.random.default_rng(5)
    k = _normal(rng, 2, 5, 3, 4)
    got = attention.repeat_kv(torch.from_numpy(k), 4)
    _close(got, ref_attn.repeat_kv(jnp.asarray(k), 4))
    for h in range(12):
        assert torch.equal(got[:, :, h], torch.from_numpy(k)[:, :, h // 4])


# ---- gqa_apply ------------------------------------------------------------------

# (qk_norm, n_heads_padded, n_kv_heads_padded)
GQA_CASES = [(False, 0, 0), (True, 0, 0), (False, 6, 0), (True, 8, 4)]


def _gqa_weights(cfg, seed):
    """NumPy weights of gqa_init's shapes, norm scales away from 1."""
    rng = np.random.default_rng(seed)
    p = attention.gqa_init(None, cfg, "cpu")
    out = {k: _normal(rng, *t.shape, scale=cfg.d_model ** -0.5)
           for k, t in p.items()}
    for k in ("q_scale", "k_scale"):
        if k in out:
            out[k] = 1 + _normal(rng, *p[k].shape, scale=0.2)
    return out


@pytest.mark.parametrize("qk_norm,h_pad,kv_pad", GQA_CASES)
def test_gqa_apply_matches_the_reference_in_every_mode(qk_norm, h_pad,
                                                       kv_pad):
    ref_cfg, cfg = _cfgs(qk_norm=qk_norm, n_heads_padded=h_pad,
                         n_kv_heads_padded=kv_pad)
    w = _gqa_weights(cfg, seed=6 + h_pad)
    p_ref = {k: jnp.asarray(v) for k, v in w.items()}
    p = {k: torch.from_numpy(v) for k, v in w.items()}
    H = h_pad or cfg.n_heads
    KV = kv_pad or cfg.n_kv_heads
    assert p["wq"].shape == (64, H * 16) and p["wk"].shape == (64, KV * 16)
    assert ("q_scale" in p) == qk_norm
    rng = np.random.default_rng(7)
    B, S = 2, 70
    x = _normal(rng, B, S, cfg.d_model)
    positions = np.tile(np.arange(S), (B, 1))
    for mode in ("train", "prefill"):
        want, want_c = ref_attn.gqa_apply(p_ref, jnp.asarray(x), ref_cfg,
                                          positions=jnp.asarray(positions),
                                          mode=mode)
        got, got_c = attention.gqa_apply(p, torch.from_numpy(x), cfg,
                                         positions=torch.from_numpy(
                                             positions), mode=mode)
        _close(got, want, mode)
        if mode == "train":
            assert got_c is None and want_c is None
        else:
            _close(got_c.k, want_c.k, "k")
            _close(got_c.v, want_c.v, "v")
            cache = attention.KVCache(*(torch.nn.functional.pad(
                t, (0, 0, 0, 0, 0, 4)) for t in got_c))
            ref_cache = ref_attn.KVCache(*(jnp.pad(
                t, ((0, 0), (0, 4), (0, 0), (0, 0))) for t in want_c))
    # decode one token a sequence at different positions
    x1 = _normal(rng, B, 1, cfg.d_model)
    pos = np.array([S, S + 2])
    want, want_c = ref_attn.gqa_apply(p_ref, jnp.asarray(x1), ref_cfg,
                                      positions=jnp.asarray(pos[:, None]),
                                      mode="decode", cache=ref_cache,
                                      pos=jnp.asarray(pos))
    got, got_c = attention.gqa_apply(p, torch.from_numpy(x1), cfg,
                                     positions=torch.from_numpy(pos[:, None]),
                                     mode="decode", cache=cache,
                                     pos=torch.from_numpy(pos))
    _close(got, want, "decode")
    _close(got_c.k, want_c.k, "decode k")
    _close(got_c.v, want_c.v, "decode v")
    # the input cache is left as it was
    assert float(cache.k[0, S].abs().max()) == 0


def test_padded_heads_contribute_nothing():
    """The TP-padding heads are zeroed before wo: changing their rows of
    wo changes nothing."""
    _, cfg = _cfgs(n_heads_padded=6)
    w = {k: torch.from_numpy(v) for k, v in _gqa_weights(cfg, 8).items()}
    x = torch.from_numpy(_normal(np.random.default_rng(9), 1, 40, 64))
    positions = torch.arange(40)[None]
    out, _ = attention.gqa_apply(w, x, cfg, positions=positions, mode="train")
    w["wo"][4 * 16:] = 7.0
    again, _ = attention.gqa_apply(w, x, cfg, positions=positions,
                                   mode="train")
    assert torch.equal(out, again)


def test_decode_past_the_cache_raises():
    _, cfg = _cfgs()
    p = {k: torch.from_numpy(v) for k, v in _gqa_weights(cfg, 10).items()}
    cache = attention.KVCache(torch.zeros(2, 8, 2, 16), torch.zeros(2, 8, 2,
                                                                    16))
    x1 = torch.zeros(2, 1, 64)
    for bad in ([3, 8], [-1, 2]):
        pos = torch.tensor(bad)
        with pytest.raises(IndexError, match="outside the cache's 8 rows"):
            attention.gqa_apply(p, x1, cfg, positions=pos[:, None],
                                mode="decode", cache=cache, pos=pos)
    with pytest.raises(ValueError, match="unknown mode"):
        attention.gqa_apply(p, x1, cfg, positions=torch.zeros(2, 1),
                            mode="serve")


@pytest.mark.parametrize("seq", [20, 96])
def test_gqa_cache_shape_is_the_reference_one(seq):
    ref_cfg, cfg = _cfgs(n_kv_heads_padded=4)
    want = ref_attn.gqa_cache_shape(ref_cfg, 3, seq)
    got = attention.gqa_cache_shape(cfg, 3, seq)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (3, min(seq, 32), 4, 16)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
