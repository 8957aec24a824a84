"""Attention — the PyTorch counterparts of ``repro.models.attention``:
QKV projection with bias, the direct (one masked score tensor) attention
core, full-sequence self-attention through the flash op (with ring
caches of any capacity; the non-causal encoder through the plain core,
as in the reference), one-token decode against a ring cache through
the ring decode op, paged decode through the fused op, chunked
prefill against leased pages in plain PyTorch, and the enc-dec cross
attention (``cross_kv``, ``cross_attn_full``, ``cross_attn_decode``,
plain PyTorch as in the reference). The plain core keeps the
reference's memory-saving paths for Sk > 2048: a banded sliding window
and a chunked online softmax. Every path that a sliding-window
(``swa``) layer runs takes its ``window``; rope is applied only when
``cfg.use_rope`` (whisper adds sinusoidal positions to its embeddings
instead).

GQA is computed in grouped form where a kernel does it (head
arithmetic, no repeated K/V) and with ``repeat_kv`` in the plain core,
as in the reference.
"""
from __future__ import annotations

import collections
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention.ops import (decode_attention_op,
                                                      fused_decode_step_op)
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.models.layers import (apply_rope, dense_init, dt,
                                       rope_tables)

_DIRECT_MAX = 2048      # Sk at or below which the dense path is used
_CHUNK_Q = 512
_CHUNK_K = 512
_NEG = -1e30
#: attention_core's calls by route ("direct", "banded", "chunked")
ROUTES = collections.Counter()


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


def _rope(cfg, q, k, positions):
    """q and k roped at ``positions``, from one sin/cos table."""
    if not cfg.use_rope:
        return q, k
    tables = rope_tables(positions, q.shape[-1], cfg.rope_theta)
    return (apply_rope(q, positions, cfg.rope_theta, tables),
            apply_rope(k, positions, cfg.rope_theta, tables))


def _out_proj(cfg, p, o):
    cd = dt(cfg.compute_dtype)
    return torch.einsum("bshk,hkd->bsd", o.to(cd), p["wo"].to(cd))


# ---------------------------------------------------------------------------
# Core attention maths (plain PyTorch: the reference computes these in XLA)
# ---------------------------------------------------------------------------


def repeat_kv(k, n_rep):
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


def _grouped(q, n_kv):
    B, S, Hq, hd = q.shape
    return q.reshape(B, S, n_kv, Hq // n_kv, hd)


def _mask_bias(q_pos, k_pos, causal, window):
    """(Sq, Sk) additive fp32 bias from absolute positions."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    return torch.where(ok, 0.0, _NEG).float()


def _direct(q, k, v, bias, scale):
    """q (B,Sq,Hkv,G,hd); k/v (B,Sk,Hkv,hd); bias (Sq,Sk): one dense
    masked score tensor."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() * scale
    s = s + bias
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)


def _chunked_full(q, k, v, q_pos, k_pos, causal, scale):
    """Query chunks of ``_CHUNK_Q``, each an online softmax over KV
    chunks of ``_CHUNK_K`` in order from the first: O(Sq) live memory.
    A KV chunk masked entirely before any unmasked one would add weight
    exp(0) per masked key, which the next unmasked chunk's rescale
    (exp(-1e30 - m) = 0) wipes out; with ``k_pos`` from 0 every query's
    first chunk holds its own unmasked keys, as in the reference."""
    B, Sq, Hkv, G, hd = q.shape
    Sk = k.shape[1]
    cq = min(_CHUNK_Q, Sq)
    ck = min(_CHUNK_K, Sk)
    nq, nk = Sq // cq, Sk // ck
    assert Sq % cq == 0 and Sk % ck == 0, (Sq, Sk, cq, ck)
    outs = []
    for i in range(nq):
        q_i = q[:, i * cq:(i + 1) * cq]
        qp_i = q_pos[i * cq:(i + 1) * cq]
        acc = torch.zeros((B, cq, Hkv, G, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, cq, Hkv, G), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, cq, Hkv, G), dtype=torch.float32,
                        device=q.device)
        for j in range(nk):
            k_j = k[:, j * ck:(j + 1) * ck]
            v_j = v[:, j * ck:(j + 1) * ck]
            s = torch.einsum("bqhgd,bkhd->bqhgk", q_i, k_j).float() * scale
            if causal:
                bad = qp_i[:, None] < k_pos[None, j * ck:(j + 1) * ck]
                s = s + torch.where(bad, _NEG, 0.0).float()[
                    None, :, None, None, :]
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p.to(v_j.dtype), v_j).float()
            m = m_new
        outs.append(acc / l.clamp_min(1e-30)[..., None])
    return torch.cat(outs, dim=1).to(q.dtype)


def _banded_swa(q, k, v, q_pos, k_pos, window, causal, scale):
    """Sliding-window attention: each query chunk of ``_CHUNK_Q`` attends
    over a band of KV rows of one static size that covers its window,
    taken at a start computed on the device (no host sync)."""
    B, Sq, Hkv, G, hd = q.shape
    Sk = k.shape[1]
    cq = min(_CHUNK_Q, Sq)
    nq = Sq // cq
    assert Sq % cq == 0, (Sq, cq)
    band = int(min(Sk, (math.ceil(window / cq) + 1) * cq))
    offs = torch.arange(band, device=q.device)
    outs = []
    for i in range(nq):
        q_i = q[:, i * cq:(i + 1) * cq]
        qp_i = q_pos[i * cq:(i + 1) * cq]
        # band start: aligned so that [start, start+band) covers
        # [chunk_end - window + 1, chunk_end], offset by k_pos[0]
        start = (qp_i[-1] - (band - 1)).clamp(0, Sk - band)
        start = (start - k_pos[0]).clamp(0, Sk - band)
        idx = start + offs
        k_b = k.index_select(1, idx)
        v_b = v.index_select(1, idx)
        kp_b = k_pos.index_select(0, idx)
        s = torch.einsum("bqhgd,bkhd->bqhgk", q_i, k_b).float() * scale
        ok = (qp_i[:, None] - kp_b[None, :]) < window
        if causal:
            ok &= qp_i[:, None] >= kp_b[None, :]
        s = s + torch.where(ok, 0.0, _NEG).float()[None, :, None, None, :]
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bqhgk,bkhd->bqhgd", p.to(v_b.dtype), v_b))
    return torch.cat(outs, dim=1).to(q.dtype)


def check_chunk_prefill(chunk_tokens, row_tokens, windows):
    """The long paths' divisibility, checked once for an engine whose
    chunk-prefill calls attend at most ``chunk_tokens`` queries over a
    slot's page row of ``row_tokens`` keys, in attention layers of
    ``windows`` (0: full attention). Past ``_DIRECT_MAX`` a chunk must be
    one query chunk or a whole number of them, and a prompt's last chunk
    can be any length, so ``chunk_tokens`` ≤ ``_CHUNK_Q``; a layer on the
    chunked path (no window, or one as long as the row) needs the row in
    whole KV chunks. Raises ValueError."""
    if row_tokens <= _DIRECT_MAX:
        return
    if chunk_tokens > _CHUNK_Q:
        raise ValueError(f"chunked prefill over page rows of {row_tokens} "
                         f"tokens needs chunk_tokens <= {_CHUNK_Q}; got "
                         f"{chunk_tokens}")
    if any(not 0 < w < row_tokens for w in windows) \
            and row_tokens % _CHUNK_K:
        raise ValueError(f"chunked prefill over page rows of {row_tokens} "
                         f"tokens needs rows of a multiple of {_CHUNK_K} "
                         "tokens (the capacity, in whole pages)")


def attention_core(q, k, v, *, q_pos, k_pos, window=0, causal=True):
    """Attention by absolute positions — causal unless ``causal`` is
    False (the encoder, cross attention), with a sliding window when
    ``window > 0`` (``(q_pos - k_pos) < window``): q (B,Sq,Hq,hd); k/v
    (B,Sk,Hkv,hd) → (B,Sq,Hq,hd). The reference's dispatch: one dense
    masked score tensor while Sk ≤ ``_DIRECT_MAX`` (short self-attention
    and long-query × short-KV cross attention); past it the banded path
    when 0 < window < Sk, else the chunked online softmax. Each call
    counts its route in ``ROUTES``."""
    Hq, hd = q.shape[2], q.shape[3]
    k = repeat_kv(k, Hq // k.shape[2])
    v = repeat_kv(v, Hq // v.shape[2])
    scale = 1.0 / math.sqrt(hd)
    qg = _grouped(q, k.shape[2])
    Sq, Sk = q.shape[1], k.shape[1]
    if Sk <= _DIRECT_MAX:
        ROUTES["direct"] += 1
        o = _direct(qg, k, v, _mask_bias(q_pos, k_pos, causal, window),
                    scale)
    elif 0 < window < Sk:
        ROUTES["banded"] += 1
        o = _banded_swa(qg, k, v, q_pos, k_pos, window, causal, scale)
    else:
        ROUTES["chunked"] += 1
        o = _chunked_full(qg, k, v, q_pos, k_pos, causal, scale)
    return o.reshape(q.shape[0], Sq, Hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------


def attn_full(cfg, p, x, positions, cache_capacity=0, window=0,
              causal=True, make_cache=True, mesh=None):
    """Causal (sliding-window when ``window > 0``) self-attention over a
    full sequence through the flash op; with ``causal=False`` (the
    encoder) through the plain core, as the reference does (its flash
    path is causal only). Returns (y, {"k","v"}) with the roped K/V in
    compute dtype (None without ``make_cache``: training). With no
    ``cache_capacity`` (or C == S) the cache is (B,S,Hkv,hd) — what the
    engine scatters into its pages; with C > S it is padded with zeros to
    C slots; with C < S it keeps the last C tokens, rolled so that
    position p lives at ring slot p % C (``attention.py:252-262`` of the
    reference).

    On a mesh (``mesh``, a rank's :class:`RankMesh` narrowed to the
    layer's mixer, whose specs say what the rules split) the rank runs its
    own q-heads (all of them when the rules leave ``wq`` replicated),
    against its own K/V heads, or, when the rules leave K/V replicated
    (Hkv not divisible by the model axis), against the K/V heads its
    q-heads read; the out-projection's partial sums meet in one
    ``all_reduce`` over "model". Its cache is its block under the
    rules: its K/V heads, or its block of the ring's sequence
    (split-KV)."""
    S = x.shape[1]
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _rope(cfg, q, k, positions)
    kq, vq = _kv_for_local_heads(cfg, mesh, q, k, v)
    if causal:
        y = flash_attention_op(q.contiguous(), kq.contiguous(),
                               vq.contiguous(), causal=True, window=window)
    else:
        y = attention_core(q, kq, vq, q_pos=positions, k_pos=positions,
                           window=window, causal=False)
    y = _out_proj_mesh(cfg, p, y, mesh)
    if not make_cache:
        return y, None
    C = cache_capacity or S
    if C >= S:
        pad = (0, 0, 0, 0, 0, C - S)
        cache = {"k": F.pad(k, pad), "v": F.pad(v, pad)}
    else:
        shift = (S - C) % C
        cache = {"k": torch.roll(k[:, S - C:], shift, dims=1),
                 "v": torch.roll(v[:, S - C:], shift, dims=1)}
    if mesh is not None:
        seq_axes = _cache_seq_axes(cfg, mesh, C)
        cache = {kk: _own_block(mesh, t, seq_axes)
                 for kk, t in cache.items()}
    return y, cache


def _own_block(mesh, t, axes):
    """The rank's block of the ring ``t`` along its sequence over
    ``axes``, in storage of its own: a narrowed view (contiguous at B=1)
    would keep every rank's slots alive for as long as the cache lives."""
    block = mesh.block(t, 1, axes)
    return t if block is t else block.clone(
        memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# A rank's heads on a mesh
# ---------------------------------------------------------------------------


def _heads_split(mesh):
    """Whether this rank holds a block of the q-heads (the rules shard
    ``wq`` over "model")."""
    return mesh is not None and mesh.split("wq", 1)


def _kv_for_local_heads(cfg, mesh, q, k, v):
    """K/V heads for the q-heads ``q`` holds. With both split (or none)
    they are ``k``/``v`` as they are; with q split and K/V replicated,
    the K/V heads that the rank's q-heads read: one contiguous block
    when the groups allow it, else one K/V head per q-head."""
    if not _heads_split(mesh) or mesh.split("wk", 1):
        return k, v
    hq = q.shape[2]
    G = cfg.n_heads // cfg.n_kv_heads
    first = mesh.tp_rank * hq
    lo, hi = first // G, (first + hq - 1) // G + 1
    if hq % (hi - lo) == 0 and (hq // (hi - lo) == G or hi - lo == 1):
        return k[:, :, lo:hi], v[:, :, lo:hi]
    idx = (first + torch.arange(hq, device=k.device)) // G
    return k.index_select(2, idx), v.index_select(2, idx)


def _out_proj_mesh(cfg, p, o, mesh):
    """The out-projection of this rank's heads; partial sums over the
    q-heads meet in an ``all_reduce`` over "model"."""
    y = _out_proj(cfg, p, o)
    if _heads_split(mesh):
        y = mesh.all_reduce(y, ("model",))
    return y


def _cache_seq_axes(cfg, mesh, C):
    """The mesh axes the rules split one layer's ring sequence over
    (reference ``_cache_seq_axes``, ``attention.py:442-456``, after the
    rules' divisibility check): empty when the K/V heads split, or when
    the sequence stays replicated."""
    return mesh.kv_seq_axes(C, cfg.n_kv_heads)


# ---------------------------------------------------------------------------
# Decode: one token against a contiguous ring cache (updated in place)
# ---------------------------------------------------------------------------


def position_vector(pos, device):
    """The decode position as a (1,) int64 tensor on ``device``: from a
    Python int, or from a 0-d device tensor without a host sync."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).to(device=device, dtype=torch.long)
    return torch.tensor([int(pos)], dtype=torch.long, device=device)


def attn_decode(cfg, p, x1, cache, pos, pvec, window=0, mesh=None):
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
    is); ``pvec`` the same as a (1,) int64 tensor. Returns y (B,1,D).

    On a mesh whose rules split the cache's K/V heads, the rank runs
    the op on its own heads; when they split the ring's sequence, the
    split-KV path (:func:`_attn_decode_splitk`, with
    ``cfg.sharding.decode_splitk``) runs instead, or, without it, the
    rank gathers the ring's blocks over the sequence axes and runs the
    op over the whole ring on its own heads."""
    q, k, v = _project_qkv(cfg, p, x1)
    q, k = _rope(cfg, q, k, pvec)
    if mesh is not None:
        C = _ring_slots(cfg, mesh, window, cache["k"].shape[1])
        seq_axes = _cache_seq_axes(cfg, mesh, C)
        if seq_axes and cfg.sharding.decode_splitk:
            o = _attn_decode_splitk(cfg, q, k, v, cache, pvec, C, window,
                                    mesh, seq_axes)
            return _out_proj_mesh(cfg, p, _local_heads(o, mesh), mesh)
        if seq_axes:
            # the reference's GSPMD without split-KV: the ring's blocks
            # gathered whole, one decode over it on the rank's heads
            _write_ring_block(cache, k, v, pvec, C, mesh, seq_axes)
            ck, cv = (mesh.all_gather(cache[kk], seq_axes, 1)
                      for kk in ("k", "v"))
            ck, cv = _kv_for_local_heads(cfg, mesh, q, ck, cv)
            o = decode_attention_op(q.contiguous(), ck.contiguous(),
                                    cv.contiguous(), pos, window=window)
            return _out_proj_mesh(cfg, p, o, mesh)
    C = cache["k"].shape[1]
    slot = torch.remainder(pvec, C)
    cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    ck, cv = _kv_for_local_heads(cfg, mesh, q, cache["k"], cache["v"])
    o = decode_attention_op(q.contiguous(), ck.contiguous(),
                            cv.contiguous(), pos, window=window)
    return _out_proj_mesh(cfg, p, o, mesh)


def _ring_slots(cfg, mesh, window, c_local):
    """A ring's global slots from the rank's ``c_local`` of them: the
    port's ring of this layer (``min(window, capacity)`` for a window)
    or, for a ring carried over from the reference (which keeps
    ``capacity`` slots under a window), the capacity — whichever the
    rules would leave ``c_local`` of on this rank."""
    cap = mesh.capacity
    if cap is None:
        raise ValueError("a decode step on a mesh needs its ring capacity: "
                         "RankMesh(mesh, batch, capacity)")
    for C in (min(window, cap) if window else cap, cap):
        if C // mesh.size(_cache_seq_axes(cfg, mesh, C)) == c_local:
            return C
    raise ValueError(f"a ring of {c_local} local slots fits neither "
                     f"capacity {cap} nor window {window}")


def _local_heads(o, mesh):
    """This rank's block of all heads ``o`` (B, 1, Hq, hd) when the rules
    split the q-heads over "model" (else ``o`` itself)."""
    if not _heads_split(mesh):
        return o
    return mesh.block(o, 2, ("model",))


def _write_ring_block(cache, k_new, v_new, pvec, C, mesh, seq_axes):
    """Write the new token's K/V into a ring whose sequence the rules
    split over ``seq_axes``: the rank owns ``C / n`` slots from ``index ·
    C / n``, and only the owner of slot ``pos % C`` writes (in place, no
    host sync: the others write their slot's own value back). → the
    rank's first global slot."""
    C_loc = cache["k"].shape[1]
    base = mesh.index(seq_axes) * C_loc
    slot = torch.remainder(pvec, C)                       # (1,)
    own = (slot >= base) & (slot < base + C_loc)
    lslot = (slot - base).clamp(0, C_loc - 1)
    for t, new in ((cache["k"], k_new), (cache["v"], v_new)):
        keep = t.index_select(1, lslot)
        t.index_copy_(1, lslot, torch.where(own[:, None, None, None],
                                            new.to(t.dtype), keep))
    return base


def _attn_decode_splitk(cfg, q, k_new, v_new, cache, pvec, C, window,
                        mesh, seq_axes):
    """Split-KV decode (reference ``attention.py:458-530``): each rank
    owns a contiguous block of the ring's sequence, ``C / n`` slots from
    ``index · C / n`` over the ``seq_axes`` flattened. Only the owner of
    slot ``pos % C`` writes the new K/V (in place, no host sync: the
    others write their slot's own value back). Each rank takes the
    masked partial softmax of all q-heads (gathered over "model" when
    the rank holds a block of them) over its block — the window and the
    wrapped ring (``pos >= C``) as the reference masks them — then the
    maxima meet in an ``all_reduce(MAX)``, the sums and the weighted
    values in ``all_reduce(SUM)``s over ``seq_axes``, and the rank
    divides. → o (B, 1, Hq, hd) for all heads, in q's dtype."""
    if _heads_split(mesh):
        q = mesh.all_gather(q, ("model",), 2)
    ck, cv = cache["k"], cache["v"]
    B, _, Hq, hd = q.shape
    C_loc, Hkv = ck.shape[1], ck.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    base = _write_ring_block(cache, k_new, v_new, pvec, C, mesh, seq_axes)
    slot = torch.remainder(pvec, C)                       # (1,)
    qg = q.reshape(B, Hkv, G, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, ck).float() * scale
    gidx = base + torch.arange(C_loc, device=q.device)
    valid = (gidx <= pvec) | (pvec >= C)
    if window > 0:
        valid &= torch.remainder(slot - gidx, C) < window
    s = torch.where(valid, s, _NEG)
    m = mesh.all_reduce(s.amax(dim=-1), seq_axes, op="max")
    pr = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = mesh.all_reduce(pr.sum(dim=-1), seq_axes)
    o = torch.einsum("bhgk,bkhd->bhgd", pr.to(cv.dtype), cv).float()
    o = mesh.all_reduce(o, seq_axes)
    o = o / l.clamp_min(1e-30)[..., None]
    return o.reshape(B, Hq, hd)[:, None].to(q.dtype)


# ---------------------------------------------------------------------------
# Paged decode and chunked prefill (pools updated in place)
# ---------------------------------------------------------------------------


def paged_decode_index(step, positions, block_tables, ps):
    """What every attention layer of one paged decode step derives from
    the positions and block tables — the clamped positions, the lengths
    the fused op reads, and the (page, offset) of each live slot's new
    row — made by the first layer and kept in ``step`` (a dict holding
    ``"live"``, the indices of the slots with ``positions >= 0``)."""
    key = ("index", ps)
    if key not in step:
        live = step["live"]
        pos_c = positions.clamp_min(0)
        lengths = (positions + 1).clamp_min(0).to(torch.int32)
        nb = block_tables.shape[1]
        blk = (pos_c // ps).clamp(0, nb - 1).long()
        page = block_tables.gather(1, blk[:, None])[:, 0]
        step[key] = (pos_c, lengths,
                     (page[live].long(), (pos_c % ps)[live].long()))
    return step[key]


def attn_decode_paged(cfg, p, x1, pools, positions, block_tables, step,
                      window=0):
    """Paged decode: one token per slot against shared page pools.

    x1 (B,1,D); pools {"k","v"} (P, ps, Hkv, hd) — **updated in place**:
    the new token's K/V are written at page ``bt[b, pos // ps]`` offset
    ``pos % ps`` for every live slot; positions (B,) int32 with -1 for a
    dead slot (no write, zero attention output); block_tables (B, nb)
    int32. Attention always runs through the fused op, which reads the
    pools *before* the write and substitutes the new K/V at
    ``lengths-1``. ``step`` is the decode step's dict: ``step["live"]``
    holds the indices of the slots with ``positions >= 0``; only those
    rows are written — an explicit mask instead of the reference's
    out-of-range sentinel page with ``mode="drop"``, which torch indexing
    would reject — and the step's index tensors and rope tables are kept
    there by the first layer that makes them. A sliding window keeps
    tokens ``t >= length - window``. Returns y (B,1,D)."""
    ps = pools["k"].shape[1]
    live = step["live"]
    pos_c, lengths, at = paged_decode_index(step, positions, block_tables,
                                            ps)
    q, k, v = _project_qkv(cfg, p, x1)
    if cfg.use_rope:
        key = ("rope", q.shape[-1])
        if key not in step:
            step[key] = rope_tables(pos_c[:, None], q.shape[-1],
                                    cfg.rope_theta)
        q = apply_rope(q, None, cfg.rope_theta, step[key])
        k = apply_rope(k, None, cfg.rope_theta, step[key])
    o = fused_decode_step_op(q.contiguous(), k.contiguous(), v.contiguous(),
                             pools["k"], pools["v"], lengths, block_tables,
                             window=window)
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
    q, k = _rope(cfg, q, k, positions)
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


def cross_kv(cfg, p, enc_out, mesh=None):
    """Cross-attention K/V of the encoder output (B, S_enc, D) →
    {"k","v"} (B, S_enc, Hkv, hd) in the compute dtype — computed once at
    prefill and kept in the slot's rows. On a mesh (``mesh`` narrowed to
    the cross attention's parameters) the rank's K/V heads, the block the
    rules give its cross rows; the rules must split the K/V heads over
    "model" when they split the q-heads."""
    _check_cross_heads(cfg, mesh)
    cd = dt(cfg.compute_dtype)
    e = enc_out.to(cd)
    k = torch.einsum("bsd,dhk->bshk", e, p["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", e, p["wv"].to(cd))
    if "bk" in p:
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return {"k": k, "v": v}


def _check_cross_heads(cfg, mesh):
    if _heads_split(mesh) and not mesh.split("wk", 1):
        raise NotImplementedError(
            f"{cfg.name}: cross attention whose q-heads split over "
            "'model' and K/V heads do not (the rules would split the "
            "cross rows' sequence) is not ported")


def _cross_q(cfg, p, x, dtype):
    q = torch.einsum("bsd,dhk->bshk", x.to(dtype), p["wq"].to(dtype))
    if "bq" in p:
        q = q + p["bq"].to(dtype)
    return q


def cross_attn_full(cfg, p, x, ckv, mesh=None):
    """Every query position of x (B, S, D) over all encoder rows of
    ``ckv`` (no mask; reference ``lm.py:196-206``) → y (B, S, D). On a
    mesh the rank's heads, the out-projection's partial sums meeting in
    an ``all_reduce`` over "model"."""
    q = _cross_q(cfg, p, x, ckv["k"].dtype)
    Sq, Sk = q.shape[1], ckv["k"].shape[1]
    o = attention_core(q, ckv["k"], ckv["v"], causal=False,
                       q_pos=torch.arange(Sq, device=x.device),
                       k_pos=torch.arange(Sk, device=x.device))
    return _out_proj_mesh(cfg, p, o, mesh)


def cross_attn_decode(cfg, p, x1, ckv, mesh=None):
    """One token a slot (B, 1, D) against the slot's encoder K/V rows
    (B, S_enc, Hkv, hd), grouped GQA as in the reference → y (B, 1, D);
    on a mesh the rank's heads, as in :func:`cross_attn_full`."""
    _check_cross_heads(cfg, mesh)
    B = x1.shape[0]
    q = _cross_q(cfg, p, x1, dt(cfg.compute_dtype))
    hd = q.shape[-1]
    Hkv = ckv["k"].shape[2]
    qg = q.reshape(B, 1, Hkv, -1, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ckv["k"]).float() \
        / math.sqrt(hd)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pr.to(ckv["v"].dtype), ckv["v"])
    return _out_proj_mesh(cfg, p, o.reshape(B, 1, -1, hd), mesh)
