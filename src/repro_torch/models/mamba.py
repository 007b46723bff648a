"""Mamba-1 selective SSM (falcon-mamba-7b), the reference's
``models/mamba.py`` in PyTorch.

Train and prefill run the sequence in chunks: a Python loop over chunks
carries (h, conv_tail), so the (B, chunk, d_inner, state) discretization
tensors stay bounded.  Within a chunk the scan on the card is always the
CUDA kernel (``kernels.ssm_scan.ssm_scan_bt_ds``), as it is for the fake
tensors of the dry run (``device.on_card``).  On the CPU
``cfg.ssm_impl`` picks which reference path to reproduce: "kernel" the
kernel's plain version, "assoc" a log-depth doubling scan in torch ops with
the reference's ``combine``.  Decode is the exact O(1) recurrence, its
state update one fused multiply-add (``core/fp.py`` ``fma``), as the
reference's jitted decode and the scan round it.  Types follow the
reference op by op: activations and matmuls in the activation dtype; dt,
dA, dBx, the scan, y, ``D``, ``A_log`` and the silu gate in float32, cast
back where the reference casts.  Train mode is the prefill body without a
cache; autograd carries gradients through the conv, the discretization,
the scan (its backward kernel on the card) and the y contraction.

With a sharder (``distributed/sharding.py``) a rank computes its block
of the ``d_inner`` channels: ``w_in`` and ``w_dt`` column-parallel, the
conv, ``dt_bias``, ``A_log`` and ``D`` per channel, the scan (the CUDA
kernels on the card) on the rank's d_inner / tp channels, and ``w_x``
and ``w_out`` row-parallel, summed over the model line.  ``w_in``'s
block of the reference's layout is a block of the [x, z] columns, not
the rank's x and z channels, so its product is gathered over the line
and the rank takes its channels of each half; the backward sums the
cotangent back to each block.  ``dt_r``, B and C, summed over the line,
enter it again, since every channel reads them.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..core.fp import fma
from ..device import on_card
from ..distributed.sharding import (GatherLeaf, enter, gathered, line,
                                    reduce_over)
from ..kernels.ssm_scan import ssm_scan_bt_ds
from .config import ModelConfig
from .layers import TensorSpec, dense_init, normal_init, torch_dtype


class MambaCache(NamedTuple):
    h: torch.Tensor     # (B, d_inner, state) f32 SSM state
    conv: torch.Tensor  # (B, conv_dim - 1, d_inner) rolling conv window


def mamba_init(gen, cfg: ModelConfig, device) -> dict:
    D, di, st, dr, cv = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                         cfg.dt_rank, cfg.conv_dim)
    dtype = torch_dtype(cfg.param_dtype)
    f32 = torch.float32
    p = {}
    p["w_in"] = dense_init(gen, D, 2 * di, dtype, device)
    p["conv_w"] = normal_init(gen, (cv, di), 0.2, dtype, device)
    p["conv_b"] = torch.zeros(di, dtype=dtype, device=device)
    p["w_x"] = dense_init(gen, di, dr + 2 * st, dtype, device)
    p["w_dt"] = dense_init(gen, dr, di, dtype, device)
    p["dt_bias"] = torch.full((di,), -4.6, dtype=dtype, device=device)
    # S4D-real init: A = -[1..state] per channel
    p["A_log"] = torch.log(torch.arange(1, st + 1, dtype=f32, device=device)
                           ).expand(di, st).contiguous()
    p["D"] = torch.ones(di, dtype=f32, device=device)
    p["w_out"] = dense_init(gen, di, D, dtype, device)
    return p


def _ssm_coeffs(p, xc, cfg: ModelConfig, dl=None):
    """xc: (B, T, di) post-conv activations -> discretized (dA, dBx, Cc),
    float32, (B, T, di, st) and (B, T, st).  ``dl`` is the model line the
    channels are sharded over (module docstring)."""
    st, dr = cfg.ssm_state, cfg.dt_rank
    proj = xc @ p["w_x"]                                    # (B, T, dr+2st)
    if dl is not None and dl.size > 1:
        proj = enter(reduce_over(proj, dl), dl)
    dt_r, B_ssm, C_ssm = proj.split([dr, st, st], dim=-1)
    dt = F.softplus((dt_r @ p["w_dt"]).float()
                    + p["dt_bias"].float())                 # (B, T, di)
    A = -torch.exp(p["A_log"])                              # (di, st)
    # exp in place: at the serving shape each (B, T, di, st) temporary is
    # a gigabyte (in training too: mul saves its inputs, not its output)
    dA = (dt[..., None] * A).exp_()                         # (B, T, di, st)
    dBx = (dt * xc.float())[..., None] \
        * B_ssm.float()[..., None, :]                       # (B, T, di, st)
    return dA, dBx, C_ssm.float()


def _chunk_scan(h0, dA, dBx):
    """Scan of h_t = dA_t h_{t-1} + dBx_t within a chunk, seeded with h0 by
    prepending the identity element carrying h0: a Hillis-Steele doubling
    scan (log2(T + 1) levels) with the reference's ``combine``."""
    B, T, di, st = dA.shape
    a = torch.cat([torch.ones((B, 1, di, st), dtype=dA.dtype,
                              device=dA.device), dA], dim=1)
    b = torch.cat([h0[:, None], dBx], dim=1)
    k = 1
    while k < T + 1:
        # combine(x, y) = (ax * ay, ay * bx + by), x the element k before y
        ax, bx, ay, by = a[:, :-k], b[:, :-k], a[:, k:], b[:, k:]
        a = torch.cat([a[:, :k], ax * ay], dim=1)
        b = torch.cat([b[:, :k], ay * bx + by], dim=1)
        k *= 2
    return b[:, 1:], b[:, -1]                               # (B,T,di,st), h_T


def _causal_conv_chunk(p, x_chunk, tail, cv):
    """x_chunk: (B, T, di); tail: (B, cv-1, di) previous inputs."""
    xin = torch.cat([tail, x_chunk], dim=1)                 # (B, T+cv-1, di)
    T = x_chunk.shape[1]
    out = sum(xin[:, i:i + T] * p["conv_w"][i] for i in range(cv))
    new_tail = xin[:, -(cv - 1):] if cv > 1 else tail
    return out + p["conv_b"], new_tail


def _in_proj(p, x, dl):
    """x @ w_in split into (x, z), each (B, S, di) of this rank's
    channels (module docstring)."""
    xz = enter(x, dl) @ p["w_in"]
    di = xz.shape[-1] // 2
    if dl.size == 1:
        return xz.split([di, di], dim=-1)
    whole = GatherLeaf.apply(xz, dl, xz.dim() - 1)
    half = whole.shape[-1] // 2
    lo = dl.index * di
    return whole[..., lo:lo + di], whole[..., half + lo:half + lo + di]


def mamba_apply(p, x, cfg: ModelConfig, *, mode: str,
                cache: MambaCache | None = None,
                chunk: int = 512, shd=None
                ) -> Tuple[torch.Tensor, MambaCache | None]:
    """x: (B, S, D) (S == 1 for decode).  Returns (out (B, S, D), the new
    cache in prefill and decode mode, else None).  With ``shd``, this
    rank's channels (module docstring); the cache holds them."""
    B, S, D = x.shape
    st, cv = cfg.ssm_state, cfg.conv_dim
    p = gathered(shd, p, "ssm")
    dl = line(shd, "d_inner")
    xr, z = _in_proj(p, x, dl)                              # (B, S, di) each
    di = xr.shape[-1]

    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        conv_win = torch.cat([cache.conv, xr], dim=1)       # (B, cv, di)
        xc = torch.einsum("bcd,cd->bd", conv_win, p["conv_w"]) + p["conv_b"]
        xc = F.silu(xc)[:, None]                            # (B, 1, di)
        dA, dBx, C_ssm = _ssm_coeffs(p, xc, cfg, dl)
        h = fma(cache.h, dA[:, 0], dBx[:, 0])               # (B, di, st)
        y = torch.einsum("bds,bs->bd", h, C_ssm[:, 0])[:, None]
        y = y + p["D"] * xc.float()
        new_cache = MambaCache(h=h, conv=conv_win[:, 1:])
        out = (y * F.silu(z.float())).to(x.dtype)
        return reduce_over(out @ p["w_out"], dl), new_cache
    if mode not in ("train", "prefill"):
        raise ValueError(f"unknown mode {mode!r}")

    # train / prefill: chunked scan over sequence
    T = min(chunk, S)
    if S % T:
        raise ValueError(f"seq {S} must divide into ssm chunks of {T}")
    h = torch.zeros((B, di, st), dtype=torch.float32, device=x.device)
    tail = torch.zeros((B, cv - 1, di), dtype=x.dtype, device=x.device)
    ys = []
    for c0 in range(0, S, T):
        xc, tail = _causal_conv_chunk(p, xr[:, c0:c0 + T], tail, cv)
        xc = F.silu(xc)
        dA, dBx, C_ssm = _ssm_coeffs(p, xc, cfg, dl)
        if on_card(x) or cfg.ssm_impl == "kernel":
            hs, h = ssm_scan_bt_ds(dA, dBx, h)
        else:
            hs, h = _chunk_scan(h, dA, dBx)
        del dA, dBx   # a gigabyte each at the serving shape
        y = torch.einsum("btds,bts->btd", hs, C_ssm)
        del hs
        y = y + p["D"] * xc.float()
        ys.append((y * F.silu(z[:, c0:c0 + T].float())).to(x.dtype))
    y = torch.cat(ys, dim=1)
    new_cache = None
    if mode == "prefill":
        new_cache = MambaCache(h=h, conv=tail[:, -(cv - 1):].to(x.dtype)
                               if cv > 1 else tail)
    return reduce_over(y @ p["w_out"], dl), new_cache


def mamba_cache_shape(cfg: ModelConfig, batch: int) -> MambaCache:
    return MambaCache(
        h=TensorSpec((batch, cfg.d_inner, cfg.ssm_state), torch.float32),
        conv=TensorSpec((batch, cfg.conv_dim - 1, cfg.d_inner),
                        torch_dtype(cfg.dtype)),
    )
