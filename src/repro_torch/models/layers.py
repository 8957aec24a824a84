"""Shared model layers: norms, rotary positions, the swiglu FFN, inits and
dtype helpers — the PyTorch counterparts of ``repro.models.layers``.

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
    return {"scale": torch.ones((cfg.d_model,), dtype=dt(cfg.param_dtype),
                                device=device)}


def init_ffn(cfg, gen, device):
    d, ff, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
    return {"w_gate": dense_init(gen, d, ff, pd, device),
            "w_up": dense_init(gen, d, ff, pd, device),
            "w_down": dense_init(gen, ff, d, pd, device)}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def apply_norm(cfg, p, x):
    """rmsnorm in fp32, cast back to ``x``'s dtype (layers.py:59-71)."""
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + cfg.norm_eps)
    return (y * p["scale"].float()).to(x.dtype)


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
