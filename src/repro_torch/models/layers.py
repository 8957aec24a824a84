"""Shared model layers: norms, rotary and sinusoidal positions, the swiglu
FFN, inits and dtype helpers — the PyTorch counterparts of
``repro.models.layers``.

Conventions (as in the reference)
---------------------------------
* Parameters live in ``cfg.param_dtype``; compute casts to
  ``cfg.compute_dtype``; norms and rope run in fp32 and cast back.
* Weights keep the reference's layouts (``w_gate (d, ff)``,
  ``wq (d, H, hd)``, ...), so every product reads like its JAX einsum.
* Inits draw from an explicit ``torch.Generator`` with the reference's
  shapes and scales; the draws themselves differ from ``jax.random``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def dt(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Initializers (same shapes/scales as repro.models.layers)
# ---------------------------------------------------------------------------


def dense_init(gen, d_in, d_out, dtype, device, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dt(dtype))


def embed_init(gen, vocab, d, dtype, device):
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dt(dtype))


def init_norm(cfg, device):
    p = {"scale": torch.ones((cfg.d_model,), dtype=dt(cfg.param_dtype),
                             device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dt(cfg.param_dtype),
                                device=device)
    return p


def init_ffn(cfg, gen, device):
    d, ff, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
    return {"w_gate": dense_init(gen, d, ff, pd, device),
            "w_up": dense_init(gen, d, ff, pd, device),
            "w_down": dense_init(gen, ff, d, pd, device)}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def apply_norm(cfg, p, x):
    """rmsnorm or layernorm (with its bias) in fp32, cast back to ``x``'s
    dtype (layers.py:59-71)."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps)
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary positions (split-half, not interleaved)
# ---------------------------------------------------------------------------


def rope_angles(positions, d_head, theta):
    """positions (…,) int → (…, d_head/2) fp32 angles."""
    half = d_head // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    return positions.float()[..., None] * freqs


def apply_rope(x, positions, theta):
    """x (B, S, H, hd); positions (S,) or (B, S)."""
    ang = rope_angles(positions, x.shape[-1], theta)
    ang = ang[None, :, None, :] if ang.dim() == 2 else ang[:, :, None, :]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n_pos, d, offset=0):
    """(n_pos, d) fp32 sinusoidal table, computed in numpy exactly as the
    reference computes it."""
    pos = np.arange(offset, offset + n_pos, dtype=np.float32)
    half = d // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half, dtype=np.float32)
                   / half)
    ang = pos[:, None] * freqs[None, :]
    return torch.from_numpy(np.concatenate([np.sin(ang), np.cos(ang)],
                                           axis=-1).astype(np.float32))


def add_abs_positions(x):
    """x (B, S, D) + the sinusoidal table of positions 0..S-1."""
    table = sinusoidal_positions(x.shape[1], x.shape[2]).to(x.device)
    return x + table[None].to(x.dtype)


def abs_position_vector(pos, d):
    """Sinusoidal embedding of a position tensor (…,) → (…, d) fp32."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=pos.device) / half)
    ang = pos.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Dense FFN (swiglu)
# ---------------------------------------------------------------------------


def apply_ffn(cfg, p, x):
    if cfg.ffn_kind != "swiglu":
        raise NotImplementedError(f"ffn {cfg.ffn_kind!r} is not ported yet")
    cd = dt(cfg.compute_dtype)
    x = x.to(cd)
    g = x @ p["w_gate"].to(cd)
    u = x @ p["w_up"].to(cd)
    return (F.silu(g) * u) @ p["w_down"].to(cd)
