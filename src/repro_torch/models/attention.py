"""Attention, dense subset — the PyTorch counterparts of
``repro.models.attention``: QKV projection with bias, the direct
(one masked score tensor) attention core, full-sequence self-attention
through the flash op, paged decode through the fused op, and chunked
prefill against leased pages in plain PyTorch.

GQA is computed in grouped form where a kernel does it (head
arithmetic, no repeated K/V) and with ``repeat_kv`` in the plain core,
as in the reference.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.decode_attention.ops import fused_decode_step_op
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.models.layers import apply_rope, dense_init, dt

_NEG = -1e30


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_attn(cfg, gen, device):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    pd = cfg.param_dtype
    p = {"wq": dense_init(gen, d, hq * hd, pd, device).reshape(d, hq, hd),
         "wk": dense_init(gen, d, hkv * hd, pd, device).reshape(d, hkv, hd),
         "wv": dense_init(gen, d, hkv * hd, pd, device).reshape(d, hkv, hd),
         "wo": dense_init(gen, hq * hd, d, pd, device).reshape(hq, hd, d)}
    if cfg.qkv_bias:
        for name, h in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros((h, hd), dtype=dt(pd), device=device)
    return p


def _project_qkv(cfg, p, x):
    cd = dt(cfg.compute_dtype)
    x = x.to(cd)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cd))
    if "bq" in p:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return q, k, v


def _out_proj(cfg, p, o):
    cd = dt(cfg.compute_dtype)
    return torch.einsum("bshk,hkd->bsd", o.to(cd), p["wo"].to(cd))


# ---------------------------------------------------------------------------
# Core attention maths (plain PyTorch, the reference's ``_direct`` path)
# ---------------------------------------------------------------------------


def repeat_kv(k, n_rep):
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


def attention_core(q, k, v, *, q_pos, k_pos):
    """Causal attention by absolute positions: q (B,Sq,Hq,hd); k/v
    (B,Sk,Hkv,hd) → (B,Sq,Hq,hd). One dense masked score tensor for
    every Sk in this slice (the reference's ``_direct``); its chunked
    and banded paths for Sk > 2048 are not ported yet."""
    Hq, hd = q.shape[2], q.shape[3]
    k = repeat_kv(k, Hq // k.shape[2])
    v = repeat_kv(v, Hq // v.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (1.0 / math.sqrt(hd))
    ok = q_pos[:, None] >= k_pos[None, :]
    s = s + torch.where(ok, 0.0, _NEG)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", pr.to(v.dtype), v)
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------


def attn_full(cfg, p, x, positions):
    """Causal self-attention over a full sequence through the flash op.
    Returns (y, {"k","v"}) with the roped K/V (B,S,Hkv,hd) in compute
    dtype — the cache the engine scatters into its pages."""
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    y = flash_attention_op(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True)
    return _out_proj(cfg, p, y), {"k": k, "v": v}


# ---------------------------------------------------------------------------
# Paged decode and chunked prefill (pools updated in place)
# ---------------------------------------------------------------------------


def attn_decode_paged(cfg, p, x1, pools, positions, block_tables, live):
    """Paged decode: one token per slot against shared page pools.

    x1 (B,1,D); pools {"k","v"} (P, ps, Hkv, hd) — **updated in place**:
    the new token's K/V are written at page ``bt[b, pos // ps]`` offset
    ``pos % ps`` for every live slot; positions (B,) int32 with -1 for a
    dead slot (no write, zero attention output); block_tables (B, nb)
    int32. Attention always runs through the fused op, which reads the
    pools *before* the write and substitutes the new K/V at
    ``lengths-1``. ``live`` holds the indices of the slots with
    ``positions >= 0``; only those rows are written — an explicit
    mask instead of the reference's out-of-range sentinel page with
    ``mode="drop"``, which torch indexing would reject. Returns y
    (B,1,D)."""
    ps = pools["k"].shape[1]
    q, k, v = _project_qkv(cfg, p, x1)
    pos_c = positions.clamp_min(0)
    q = apply_rope(q, pos_c[:, None], cfg.rope_theta)
    k = apply_rope(k, pos_c[:, None], cfg.rope_theta)
    lengths = (positions + 1).clamp_min(0).to(torch.int32)
    o = fused_decode_step_op(q.contiguous(), k.contiguous(), v.contiguous(),
                             pools["k"], pools["v"], lengths, block_tables)
    nb = block_tables.shape[1]
    blk = (pos_c // ps).clamp(0, nb - 1).long()
    page = block_tables.gather(1, blk[:, None])[:, 0]
    at = (page[live].long(), (pos_c % ps)[live].long())
    pools["k"].index_put_(at, k[live, 0])
    pools["v"].index_put_(at, v[live, 0])
    return _out_proj(cfg, p, o)


def attn_prefill_chunk_paged(cfg, p, x, pools, positions, block_row):
    """One slot's prompt chunk against its leased pages (plain PyTorch:
    the reference has no kernel here). x (1, L, D); positions (L,)
    absolute token indices; block_row (nb,) the slot's block table.
    The chunk's K/V are written into the pools **in place**, then the
    chunk attends causally over the slot's gathered pages; stale rows
    past the chunk are masked by causality. Returns y (1, L, D)."""
    _, ps, Hkv, hd = pools["k"].shape
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    pages = block_row[positions // ps].long()
    offs = positions % ps
    pools["k"].index_put_((pages, offs), k[0])
    pools["v"].index_put_((pages, offs), v[0])
    S = block_row.shape[0] * ps
    kb = pools["k"][block_row.long()].reshape(1, S, Hkv, hd)
    vb = pools["v"][block_row.long()].reshape(1, S, Hkv, hd)
    y = attention_core(q, kb, vb, q_pos=positions,
                       k_pos=torch.arange(S, device=x.device))
    return _out_proj(cfg, p, y)
