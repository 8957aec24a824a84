"""Attention — the PyTorch counterparts of ``repro.models.attention``:
QKV projection with bias, the direct (one masked score tensor) attention
core, full-sequence self-attention through the flash op (with ring
caches of any capacity; the non-causal encoder through the plain core,
as in the reference), one-token decode against a ring cache through
the ring decode op, paged decode through the fused op, chunked
prefill against leased pages in plain PyTorch, and the enc-dec cross
attention (``cross_kv``, ``cross_attn_full``, ``cross_attn_decode``,
plain PyTorch as in the reference). Every path that a sliding-window
(``swa``) layer runs takes its ``window``; rope is applied only when
``cfg.use_rope`` (whisper adds sinusoidal positions to its embeddings
instead).

GQA is computed in grouped form where a kernel does it (head
arithmetic, no repeated K/V) and with ``repeat_kv`` in the plain core,
as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention.ops import (decode_attention_op,
                                                      fused_decode_step_op)
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


def _rope(cfg, t, positions):
    return apply_rope(t, positions, cfg.rope_theta) if cfg.use_rope else t


def _out_proj(cfg, p, o):
    cd = dt(cfg.compute_dtype)
    return torch.einsum("bshk,hkd->bsd", o.to(cd), p["wo"].to(cd))


# ---------------------------------------------------------------------------
# Core attention maths (plain PyTorch, the reference's ``_direct`` path)
# ---------------------------------------------------------------------------


def repeat_kv(k, n_rep):
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


def attention_core(q, k, v, *, q_pos, k_pos, window=0, causal=True):
    """Attention by absolute positions — causal unless ``causal`` is
    False (the encoder, cross attention), with a sliding window when
    ``window > 0`` (``(q_pos - k_pos) < window``, the reference's
    ``_mask_bias``): q (B,Sq,Hq,hd); k/v (B,Sk,Hkv,hd) → (B,Sq,Hq,hd).
    One dense masked score tensor for every Sk in this slice (the
    reference's ``_direct``; its ``_banded_swa`` computes the same
    function); its chunked and banded memory-saving paths for
    Sk > 2048 are not ported yet."""
    Hq, hd = q.shape[2], q.shape[3]
    k = repeat_kv(k, Hq // k.shape[2])
    v = repeat_kv(v, Hq // v.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (1.0 / math.sqrt(hd))
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    s = s + torch.where(ok, 0.0, _NEG)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", pr.to(v.dtype), v)
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------


def attn_full(cfg, p, x, positions, cache_capacity=0, window=0,
              causal=True, make_cache=True):
    """Causal (sliding-window when ``window > 0``) self-attention over a
    full sequence through the flash op; with ``causal=False`` (the
    encoder) through the plain core, as the reference does (its flash
    path is causal only). Returns (y, {"k","v"}) with the roped K/V in
    compute dtype (None without ``make_cache``: training). With no
    ``cache_capacity`` (or C == S) the cache is (B,S,Hkv,hd) — what the
    engine scatters into its pages; with C > S it is padded with zeros to
    C slots; with C < S it keeps the last C tokens, rolled so that
    position p lives at ring slot p % C (``attention.py:252-262`` of the
    reference)."""
    S = x.shape[1]
    q, k, v = _project_qkv(cfg, p, x)
    q = _rope(cfg, q, positions)
    k = _rope(cfg, k, positions)
    if causal:
        y = flash_attention_op(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True, window=window)
    else:
        y = attention_core(q, k, v, q_pos=positions, k_pos=positions,
                           window=window, causal=False)
    if not make_cache:
        return _out_proj(cfg, p, y), None
    C = cache_capacity or S
    if C >= S:
        pad = (0, 0, 0, 0, 0, C - S)
        cache = {"k": F.pad(k, pad), "v": F.pad(v, pad)}
    else:
        shift = (S - C) % C
        cache = {"k": torch.roll(k[:, S - C:], shift, dims=1),
                 "v": torch.roll(v[:, S - C:], shift, dims=1)}
    return _out_proj(cfg, p, y), cache


# ---------------------------------------------------------------------------
# Decode: one token against a contiguous ring cache (updated in place)
# ---------------------------------------------------------------------------


def position_vector(pos, device):
    """The decode position as a (1,) int64 tensor on ``device``: from a
    Python int, or from a 0-d device tensor without a host sync."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).to(device=device, dtype=torch.long)
    return torch.tensor([int(pos)], dtype=torch.long, device=device)


def attn_decode(cfg, p, x1, cache, pos, pvec, window=0):
    """x1 (B,1,D); cache ring {"k","v"} (B,C,Hkv,hd) — **updated in
    place**: the new token's K/V are written at slot ``pos % C`` with
    ``index_copy_`` on a device index (no host sync), then the token
    attends over the ``min(pos+1, C)`` valid slots through the ring
    decode op, within ``window`` when it is > 0 (reference
    ``attention.py:283``). A ring of C <= window (what ``init_cache`` and
    ``prefill(capacity=)`` give a ``swa`` layer) already holds only the
    window; the window still reaches the op, since a reference cache
    carried over by the bridge keeps ``capacity`` slots. ``pos`` is the
    shared position (int or 0-d int32 tensor, handed to the kernel as
    is); ``pvec`` the same as a (1,) int64 tensor. Returns y (B,1,D)."""
    C = cache["k"].shape[1]
    q, k, v = _project_qkv(cfg, p, x1)
    q = _rope(cfg, q, pvec)
    k = _rope(cfg, k, pvec)
    slot = torch.remainder(pvec, C)
    cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    o = decode_attention_op(q.contiguous(), cache["k"], cache["v"], pos,
                            window=window)
    return _out_proj(cfg, p, o)


# ---------------------------------------------------------------------------
# Paged decode and chunked prefill (pools updated in place)
# ---------------------------------------------------------------------------


def attn_decode_paged(cfg, p, x1, pools, positions, block_tables, live,
                      window=0):
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
    ``mode="drop"``, which torch indexing would reject. A sliding window
    keeps tokens ``t >= length - window``. Returns y (B,1,D)."""
    ps = pools["k"].shape[1]
    q, k, v = _project_qkv(cfg, p, x1)
    pos_c = positions.clamp_min(0)
    q = _rope(cfg, q, pos_c[:, None])
    k = _rope(cfg, k, pos_c[:, None])
    lengths = (positions + 1).clamp_min(0).to(torch.int32)
    o = fused_decode_step_op(q.contiguous(), k.contiguous(), v.contiguous(),
                             pools["k"], pools["v"], lengths, block_tables,
                             window=window)
    nb = block_tables.shape[1]
    blk = (pos_c // ps).clamp(0, nb - 1).long()
    page = block_tables.gather(1, blk[:, None])[:, 0]
    at = (page[live].long(), (pos_c % ps)[live].long())
    pools["k"].index_put_(at, k[live, 0])
    pools["v"].index_put_(at, v[live, 0])
    return _out_proj(cfg, p, o)


def attn_prefill_chunk_paged(cfg, p, x, pools, positions, block_row,
                             window=0):
    """One slot's prompt chunk against its leased pages (plain PyTorch:
    the reference has no kernel here). x (1, L, D); positions (L,)
    absolute token indices; block_row (nb,) the slot's block table.
    The chunk's K/V are written into the pools **in place**, then the
    chunk attends causally (within ``window`` when it is > 0) over the
    slot's gathered pages; stale rows past the chunk are masked by
    causality. Returns y (1, L, D)."""
    _, ps, Hkv, hd = pools["k"].shape
    q, k, v = _project_qkv(cfg, p, x)
    q = _rope(cfg, q, positions)
    k = _rope(cfg, k, positions)
    pages = block_row[positions // ps].long()
    offs = positions % ps
    pools["k"].index_put_((pages, offs), k[0])
    pools["v"].index_put_((pages, offs), v[0])
    S = block_row.shape[0] * ps
    kb = pools["k"][block_row.long()].reshape(1, S, Hkv, hd)
    vb = pools["v"][block_row.long()].reshape(1, S, Hkv, hd)
    y = attention_core(q, kb, vb, q_pos=positions,
                       k_pos=torch.arange(S, device=x.device), window=window)
    return _out_proj(cfg, p, y)


# ---------------------------------------------------------------------------
# Cross attention (enc-dec): K/V of the encoder output, plain PyTorch
# ---------------------------------------------------------------------------


def cross_kv(cfg, p, enc_out):
    """Cross-attention K/V of the encoder output (B, S_enc, D) →
    {"k","v"} (B, S_enc, Hkv, hd) in the compute dtype — computed once at
    prefill and kept in the slot's rows."""
    cd = dt(cfg.compute_dtype)
    e = enc_out.to(cd)
    k = torch.einsum("bsd,dhk->bshk", e, p["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", e, p["wv"].to(cd))
    if "bk" in p:
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return {"k": k, "v": v}


def _cross_q(cfg, p, x, dtype):
    q = torch.einsum("bsd,dhk->bshk", x.to(dtype), p["wq"].to(dtype))
    if "bq" in p:
        q = q + p["bq"].to(dtype)
    return q


def cross_attn_full(cfg, p, x, ckv):
    """Every query position of x (B, S, D) over all encoder rows of
    ``ckv`` (no mask; reference ``lm.py:196-206``) → y (B, S, D)."""
    q = _cross_q(cfg, p, x, ckv["k"].dtype)
    Sq, Sk = q.shape[1], ckv["k"].shape[1]
    o = attention_core(q, ckv["k"], ckv["v"], causal=False,
                       q_pos=torch.arange(Sq, device=x.device),
                       k_pos=torch.arange(Sk, device=x.device))
    return _out_proj(cfg, p, o)


def cross_attn_decode(cfg, p, x1, ckv):
    """One token a slot (B, 1, D) against the slot's encoder K/V rows
    (B, S_enc, Hkv, hd), grouped GQA as in the reference → y (B, 1, D)."""
    B = x1.shape[0]
    q = _cross_q(cfg, p, x1, dt(cfg.compute_dtype))
    hd = q.shape[-1]
    Hkv = ckv["k"].shape[2]
    qg = q.reshape(B, 1, Hkv, -1, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ckv["k"]).float() \
        / math.sqrt(hd)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pr.to(ckv["v"].dtype), ckv["v"])
    return _out_proj(cfg, p, o.reshape(B, 1, -1, hd))
