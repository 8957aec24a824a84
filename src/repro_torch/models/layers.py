"""Shared model layers: norms, rotary and sinusoidal positions, the swiglu
and GELU FFNs, the softmax cross-entropy loss, inits and dtype helpers —
the PyTorch counterparts of ``repro.models.layers``.

Conventions (as in the reference)
---------------------------------
* Parameters live in ``cfg.param_dtype``; compute casts to
  ``cfg.compute_dtype`` (once, ``Model.compute_params``); norms and rope
  run in fp32 and cast back.
* Weights keep the reference's layouts (``w_gate (d, ff)``,
  ``wq (d, H, hd)``, ...), so every product reads like its JAX einsum.
* Inits draw from an explicit ``torch.Generator`` with the reference's
  shapes and scales; the draws themselves differ from ``jax.random``.
"""
from __future__ import annotations

import functools
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
    # scaled in place: a leaf of kimi-k2's experts is 22.5 GB in fp32
    return w.mul_(scale).to(dt(dtype))


def embed_init(gen, vocab, d, dtype, device):
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(0.02).to(dt(dtype))


def init_norm(cfg, device):
    p = {"scale": torch.ones((cfg.d_model,), dtype=dt(cfg.param_dtype),
                             device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dt(cfg.param_dtype),
                                device=device)
    return p


def init_ffn(cfg, gen, device, kind, d_ff):
    """A dense FFN of width ``d_ff``: ``swiglu`` or ``gelu`` (with the
    biases ``b_up`` / ``b_down``); the layer's spec gives both, as kimi's
    dense first layer differs from the config's FFN."""
    d, ff, pd = cfg.d_model, d_ff, cfg.param_dtype
    if kind == "swiglu":
        return {"w_gate": dense_init(gen, d, ff, pd, device),
                "w_up": dense_init(gen, d, ff, pd, device),
                "w_down": dense_init(gen, ff, d, pd, device)}
    if kind == "gelu":
        return {"w_up": dense_init(gen, d, ff, pd, device),
                "b_up": torch.zeros((ff,), dtype=dt(pd), device=device),
                "w_down": dense_init(gen, ff, d, pd, device),
                "b_down": torch.zeros((d,), dtype=dt(pd), device=device)}
    raise ValueError(kind)


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


@functools.lru_cache(maxsize=None)
def _inv_freqs(half, theta, device):
    """theta^(-i/half) for i < half, fp32, made once per (half, theta,
    device): a decode step would otherwise rebuild it in every layer."""
    with torch.inference_mode(False), torch.no_grad():
        exps = torch.arange(half, dtype=torch.float32, device=device) / half
        return 1.0 / (theta ** exps)


def rope_angles(positions, d_head, theta):
    """positions (…,) int → (…, d_head/2) fp32 angles."""
    return positions.float()[..., None] * _inv_freqs(d_head // 2, theta,
                                                     positions.device)


def rope_tables(positions, d_head, theta):
    """(sin, cos) of the angles, shaped to broadcast over (B, S, H,
    d_head/2); positions (S,) or (B, S)."""
    ang = rope_angles(positions, d_head, theta)
    ang = ang[None, :, None, :] if ang.dim() == 2 else ang[:, :, None, :]
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, positions, theta, tables=None):
    """x (B, S, H, hd); positions (S,) or (B, S); ``tables`` the
    :func:`rope_tables` of these positions when the caller has them."""
    sin, cos = tables if tables is not None else \
        rope_tables(positions, x.shape[-1], theta)
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
# Dense FFNs (swiglu / gelu)
# ---------------------------------------------------------------------------


def apply_ffn(cfg, p, x, kind, mesh=None):
    """swiglu, or the GELU MLP with biases in ``jax.nn.gelu``'s default
    tanh form (the exact erf form differs by ~1e-3). On a mesh whose
    rules split the hidden width over "model" (``w_down``'s rows), the
    rank runs
    its columns and rows, and the partial sums meet in one
    ``all_reduce`` (``b_down`` is added after it)."""
    cd = dt(cfg.compute_dtype)
    x = x.to(cd)
    split = mesh is not None and mesh.split("w_down", 0)
    if kind == "swiglu":
        g = x @ p["w_gate"].to(cd)
        u = x @ p["w_up"].to(cd)
        y = (F.silu(g) * u) @ p["w_down"].to(cd)
        return mesh.all_reduce(y, ("model",)) if split else y
    if kind == "gelu":
        h = F.gelu(x @ p["w_up"].to(cd) + p["b_up"].to(cd),
                   approximate="tanh")
        y = h @ p["w_down"].to(cd)
        if split:
            y = mesh.all_reduce(y, ("model",))
        return y + p["b_down"].to(cd)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def sharded_cross_entropy(logits, labels, mask, mesh, split):
    """:func:`softmax_cross_entropy` on a mesh, over the rank's batch
    rows; with ``split`` the rank holds a block of the vocab (the
    ``mesh.tp_rank``-th of the columns), and the maxima meet in an
    ``all_reduce(MAX)``, the exponential sums and the picked logits in
    ``all_reduce`` over "model", and the masked sums and counts over the
    batch axes when the rows are split there. With nothing split over
    more than one rank it is :func:`softmax_cross_entropy` itself."""
    axes = [a for a in mesh.batch_spec_axes() if mesh.sizes[a] > 1]
    if not split and not axes:
        return softmax_cross_entropy(logits, labels, mask)
    lf = logits.float()
    V = lf.shape[-1]
    lo = mesh.tp_rank * V if split else 0
    m = lf.detach().amax(dim=-1)
    if split:
        m = mesh.all_reduce(m, ("model",), op="max")
    z = torch.exp(lf - m[..., None]).sum(-1)
    ids = labels.long() - lo
    ok = (ids >= 0) & (ids < V)
    picked = lf.gather(-1, ids.clamp(0, V - 1)[..., None])[..., 0]
    picked = torch.where(ok, picked, 0.0)
    if split:
        z = mesh.all_reduce(z, ("model",))
        picked = mesh.all_reduce(picked, ("model",))
    nll = torch.log(z) + m - picked
    mask = torch.ones_like(nll) if mask is None else mask.float()
    num, n = (nll * mask).sum(), mask.sum()
    num = mesh.all_reduce(num, axes)
    n = mesh.all_reduce(n, axes).clamp_min(1.0)
    return num / n, n


def softmax_cross_entropy(logits, labels, mask=None):
    """logits (B,S,V) any dtype; labels (B,S) int; mask (B,S) optional →
    (mean loss over the masked tokens, their count): fp32 logsumexp, the
    count clamped at 1 (reference ``layers.py:169-182``)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = lf.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - picked
    mask = torch.ones_like(nll) if mask is None else mask.float()
    n = mask.sum().clamp_min(1.0)
    return (nll * mask).sum() / n, n
