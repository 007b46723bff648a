"""Mamba-1 selective SSM (falcon-mamba-7b), the reference's
``models/mamba.py`` in PyTorch.

Train and prefill run the sequence in chunks: a Python loop over chunks
carries (h, conv_tail), so the (B, chunk, d_inner, state) discretization
tensors stay bounded.  Within a chunk the scan on the card is always the
CUDA kernel (``kernels.ssm_scan.ssm_scan_bt_ds``).  On the CPU
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
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..core.fp import fma
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


def _ssm_coeffs(p, xc, cfg: ModelConfig):
    """xc: (B, T, di) post-conv activations -> discretized (dA, dBx, Cc),
    float32, (B, T, di, st) and (B, T, st)."""
    st, dr = cfg.ssm_state, cfg.dt_rank
    proj = xc @ p["w_x"]                                    # (B, T, dr+2st)
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


def mamba_apply(p, x, cfg: ModelConfig, *, mode: str,
                cache: MambaCache | None = None,
                chunk: int = 512) -> Tuple[torch.Tensor, MambaCache | None]:
    """x: (B, S, D) (S == 1 for decode).  Returns (out (B, S, D), the new
    cache in prefill and decode mode, else None)."""
    B, S, D = x.shape
    di, st, cv = cfg.d_inner, cfg.ssm_state, cfg.conv_dim
    xz = x @ p["w_in"]
    xr, z = xz.split([di, di], dim=-1)                      # (B, S, di) each

    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        conv_win = torch.cat([cache.conv, xr], dim=1)       # (B, cv, di)
        xc = torch.einsum("bcd,cd->bd", conv_win, p["conv_w"]) + p["conv_b"]
        xc = F.silu(xc)[:, None]                            # (B, 1, di)
        dA, dBx, C_ssm = _ssm_coeffs(p, xc, cfg)
        h = fma(cache.h, dA[:, 0], dBx[:, 0])               # (B, di, st)
        y = torch.einsum("bds,bs->bd", h, C_ssm[:, 0])[:, None]
        y = y + p["D"] * xc.float()
        new_cache = MambaCache(h=h, conv=conv_win[:, 1:])
        out = (y * F.silu(z.float())).to(x.dtype)
        return out @ p["w_out"], new_cache
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
        dA, dBx, C_ssm = _ssm_coeffs(p, xc, cfg)
        if x.is_cuda or cfg.ssm_impl == "kernel":
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
    return y @ p["w_out"], new_cache


def mamba_cache_shape(cfg: ModelConfig, batch: int) -> MambaCache:
    return MambaCache(
        h=TensorSpec((batch, cfg.d_inner, cfg.ssm_state), torch.float32),
        conv=TensorSpec((batch, cfg.conv_dim - 1, cfg.d_inner),
                        torch_dtype(cfg.dtype)),
    )
