"""LM assembly — the PyTorch counterpart of ``repro.models.lm`` for stacks
of ``attn | swa | rglru | rwkv`` mixers with ``swiglu | channelmix`` FFNs,
mixed freely (recurrentgemma's ``(rglru, rglru, swa)`` periods, rwkv6's
``(rwkv,)``).

Parameters are a list of per-layer dicts (the reference stacks them on a
leading period axis for ``jax.lax.scan``; ``bridge.py`` converts, and
:func:`build_layout` gives the reference's segment layout).

Paged serving state is a dict:

* ``"k"``, ``"v"``: one stacked pool per K and V over the attn/swa
  layers only, ``(La, num_pages, page_size, Hkv, hd)``: attention layer
  ``a``'s pool is the contiguous slice ``state["k"][a]``, which the
  kernels read in place and the write paths update in place (``La`` is 0
  for an attention-free stack: empty pools). Block tables are shared by
  every layer and owned by the serving engine's ``PagedKVCache``.
* ``"rows"``: one dict per layer of per-slot rows, batch-indexed —
  rglru ``{"mixer": {"conv" (B,3,d), "h" (B,d) fp32}}``, rwkv
  ``{"mixer": {"s" (B,H,K,K) fp32, "shift" (B,d)}}``, channelmix
  ``{"ffn": {"shift" (B,d)}}``, ``{}`` for attention layers. Decode
  updates the live slots' rows in place; a dead slot (position -1) keeps
  its rows, and a prefill chunk reads and writes only its own slot's.

Contiguous ring caches (the VMM's decode programs) are one stacked
tensor per K and V, ``(L, B, C, Hkv, hd)``, for attention-only stacks;
decode writes each layer's slice in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import recurrent as rec
from repro_torch.models.layers import apply_ffn, apply_norm, dt, init_ffn, \
    init_norm

MIXERS = ("attn", "swa", "rglru", "rwkv")
FFNS = ("swiglu", "channelmix")


@dataclass(frozen=True)
class LayerSpec:
    mixer: str                  # attn | swa | rglru | rwkv
    ffn: str                    # swiglu | channelmix
    d_ff: int

    @property
    def is_attn(self) -> bool:
        return self.mixer in ("attn", "swa")


def layer_specs(cfg) -> Tuple[LayerSpec, ...]:
    if cfg.is_encdec:
        raise NotImplementedError("cross attention is not ported yet")
    out = []
    for i in range(cfg.n_layers):
        spec = LayerSpec(cfg.layer_mixer(i), cfg.ffn_kind, cfg.d_ff)
        if spec.mixer not in MIXERS or spec.ffn not in FFNS:
            raise NotImplementedError(
                f"layer {i}: {spec.mixer}/{spec.ffn} is not ported yet "
                f"(mixers {MIXERS}, FFNs {FFNS})")
        out.append(spec)
    return tuple(out)


def build_layout(cfg, specs):
    """The reference's segment layout (``lm.py:66-85``, no MoE prefix):
    ``[("scan", period_specs, n)]`` over whole periods of
    ``cfg.block_pattern`` plus an ``("unroll", tail_specs)`` remainder."""
    if not cfg.sharding.scan_layers:
        return [("unroll", tuple(specs))]
    p = len(cfg.block_pattern)
    n_scan, tail = divmod(len(specs), p)
    layout = []
    if n_scan:
        layout.append(("scan", tuple(specs[:p]), n_scan))
    if tail:
        layout.append(("unroll", tuple(specs[n_scan * p:])))
    return layout


def layout_layers(cfg, specs):
    """Yield ``(si, li, layers, spec, scan)`` per site of the reference's
    layout: segment ``si``, position ``li`` in it, the absolute layer
    indices that one stacked leaf covers (one for an unrolled layer, one
    per period under scan) and their spec."""
    base = 0
    for si, entry in enumerate(build_layout(cfg, specs)):
        if entry[0] == "unroll":
            for li, spec in enumerate(entry[1]):
                yield si, li, [base + li], spec, False
            base += len(entry[1])
        else:
            _, period, n = entry
            for li, spec in enumerate(period):
                yield si, li, [base + j * len(period) + li
                               for j in range(n)], spec, True
            base += n * len(period)


def attn_index(specs):
    """Layer index → index of its K/V pool (None for a non-attention
    layer)."""
    out, a = [], 0
    for spec in specs:
        out.append(a if spec.is_attn else None)
        a += spec.is_attn
    return out


def _window(cfg, spec):
    return cfg.window if spec.mixer == "swa" else 0


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_layer(cfg, gen, spec, device):
    p = {"norm1": init_norm(cfg, device), "norm2": init_norm(cfg, device)}
    if spec.is_attn:
        p["mixer"] = attn.init_attn(cfg, gen, device)
    elif spec.mixer == "rglru":
        p["mixer"] = rec.init_rglru(cfg, gen, device)
    else:
        p["mixer"] = rec.init_rwkv_tmix(cfg, gen, device)
    if spec.ffn == "channelmix":
        p["ffn"] = rec.init_channelmix(cfg, gen, device)
    else:
        p["ffn"] = init_ffn(cfg, gen, device)
    return p


def init_layer_rows(cfg, spec, batch, device):
    """Zeroed per-slot rows of one layer (``{}`` for attention)."""
    cd = dt(cfg.compute_dtype)
    d = cfg.d_model
    f32 = torch.float32
    rows = {}
    if spec.mixer == "rglru":
        rows["mixer"] = {
            "conv": torch.zeros((batch, rec.RG_CONV_WIDTH - 1, d), dtype=cd,
                                device=device),
            "h": torch.zeros((batch, d), dtype=f32, device=device)}
    elif spec.mixer == "rwkv":
        dk = cfg.rwkv_head_dim
        rows["mixer"] = {
            "s": torch.zeros((batch, d // dk, dk, dk), dtype=f32,
                             device=device),
            "shift": torch.zeros((batch, d), dtype=cd, device=device)}
    if spec.ffn == "channelmix":
        rows["ffn"] = {"shift": torch.zeros((batch, d), dtype=cd,
                                            device=device)}
    return rows


def init_paged_state(cfg, specs, batch, num_pages, page_size, device):
    """Zeroed paged serving state: K/V pools (La, P, ps, Hkv, hd) in the
    compute dtype over the attn/swa layers, and per-slot rows of ``batch``
    slots for every other leaf."""
    n_attn = sum(s.is_attn for s in specs)
    shape = (n_attn, num_pages, page_size, cfg.n_kv_heads, cfg.d_head)
    cd = dt(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=cd, device=device),
            "v": torch.zeros(shape, dtype=cd, device=device),
            "rows": [init_layer_rows(cfg, s, batch, device) for s in specs]}


def init_stack_cache(cfg, specs, batch, capacity, device):
    """Zeroed ring caches {"k","v"}: (L, B, C, Hkv, hd) in the compute
    dtype (attention-only stacks)."""
    shape = (len(specs), batch, capacity, cfg.n_kv_heads, cfg.d_head)
    cd = dt(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=cd, device=device),
            "v": torch.zeros(shape, dtype=cd, device=device)}


def write_prefill_to_state(state, caches, slot, block_row, length,
                           page_size):
    """Scatter one newcomer's batch=1 prefill caches into its leased
    pages and its slot's rows, **in place**: K/V token ``t < length``
    goes to page ``block_row[t // ps]`` offset ``t % ps`` of every
    attention layer's pool; every row leaf overwrites row ``slot``. No
    other slot's pages or rows are touched."""
    if "k" in caches:
        t = torch.arange(length, device=block_row.device)
        pages = block_row[t // page_size].long()
        offs = t % page_size
        for kk in ("k", "v"):
            state[kk][:, pages, offs] = caches[kk][:, 0, :length]
    for dst, src in zip(state["rows"], caches.get("rows", ())):
        for key, leaves in src.items():
            for name, leaf in leaves.items():
                dst[key][name][slot] = leaf[0]
    return state


# ---------------------------------------------------------------------------
# Per-layer apply
# ---------------------------------------------------------------------------


def _keep_live(rows, new, live):
    """Write the live slots' rows of ``new`` into ``rows`` in place; a
    dead slot's rows keep their state (a recurrent update driven by its
    placeholder token would corrupt what its next chunk reads back)."""
    for name, leaf in rows.items():
        leaf.index_copy_(0, live, new[name][live].to(leaf.dtype))


def _mixer_full(cfg, spec, p, h, positions, capacity, row0=None):
    """→ (y, K/V cache or None, mixer rows or None)."""
    if spec.is_attn:
        y, kv = attn.attn_full(cfg, p, h, positions, capacity,
                               window=_window(cfg, spec))
        return y, kv, None
    if spec.mixer == "rglru":
        y, mc = rec.rglru_full(
            cfg, p, h, h0=row0["h"] if row0 else None,
            conv0=row0["conv"] if row0 else None, make_cache=True)
    else:
        y, mc = rec.rwkv_tmix_full(cfg, p, h, cache=row0, make_cache=True)
    return y, None, mc


def _ffn_full(cfg, spec, p, h2, row0=None):
    """→ (y, ffn rows or None)."""
    if spec.ffn == "channelmix":
        return rec.channelmix_full(cfg, p, h2, cache=row0, make_cache=True)
    return apply_ffn(cfg, p, h2), None


def apply_layer_full(cfg, spec, p, x, positions, capacity=0):
    """Full-sequence layer → (x', K/V of this layer or None, its rows)."""
    h = apply_norm(cfg, p["norm1"], x)
    y, kv, mrows = _mixer_full(cfg, spec, p["mixer"], h, positions,
                               capacity)
    x = x + y.to(x.dtype)
    h2 = apply_norm(cfg, p["norm2"], x)
    y2, frows = _ffn_full(cfg, spec, p["ffn"], h2)
    rows = {}
    if mrows is not None:
        rows["mixer"] = mrows
    if frows is not None:
        rows["ffn"] = frows
    return x + y2.to(x.dtype), kv, rows


def apply_layer_decode_ring(cfg, p, x, cache, pos, pvec):
    h = apply_norm(cfg, p["norm1"], x)
    y = attn.attn_decode(cfg, p["mixer"], h, cache, pos, pvec)
    x = x + y.to(x.dtype)
    h2 = apply_norm(cfg, p["norm2"], x)
    return x + apply_ffn(cfg, p["ffn"], h2).to(x.dtype)


def apply_layer_decode(cfg, spec, p, x, pools, rows, positions,
                       block_tables, live):
    h = apply_norm(cfg, p["norm1"], x)
    if spec.is_attn:
        y = attn.attn_decode_paged(cfg, p["mixer"], h, pools, positions,
                                   block_tables, live,
                                   window=_window(cfg, spec))
    else:
        step = rec.rglru_decode if spec.mixer == "rglru" \
            else rec.rwkv_tmix_decode
        y, mc = step(cfg, p["mixer"], h, rows["mixer"])
        _keep_live(rows["mixer"], mc, live)
    x = x + y.to(x.dtype)
    h2 = apply_norm(cfg, p["norm2"], x)
    if spec.ffn == "channelmix":
        y2, fc = rec.channelmix_decode(cfg, p["ffn"], h2, rows["ffn"])
        _keep_live(rows["ffn"], fc, live)
    else:
        y2 = apply_ffn(cfg, p["ffn"], h2)
    return x + y2.to(x.dtype)


def apply_layer_chunk(cfg, spec, p, x, pools, rows, positions, block_row,
                      slot):
    """One slot's prompt chunk: attention through the slot's pages; every
    row leaf reads row ``slot`` as its initial state and gets the chunk's
    final state written back, so no other slot is touched."""
    def row0(key):
        return {n: leaf[slot:slot + 1] for n, leaf in rows[key].items()}

    def put(key, new):
        for n, leaf in rows[key].items():
            leaf[slot] = new[n][0]

    h = apply_norm(cfg, p["norm1"], x)
    if spec.is_attn:
        y = attn.attn_prefill_chunk_paged(cfg, p["mixer"], h, pools,
                                          positions, block_row,
                                          window=_window(cfg, spec))
    else:
        y, _, mc = _mixer_full(cfg, spec, p["mixer"], h, positions, 0,
                               row0("mixer"))
        put("mixer", mc)
    x = x + y.to(x.dtype)
    h2 = apply_norm(cfg, p["norm2"], x)
    y2, fc = _ffn_full(cfg, spec, p["ffn"], h2,
                       row0("ffn") if spec.ffn == "channelmix" else None)
    if fc is not None:
        put("ffn", fc)
    return x + y2.to(x.dtype)


# ---------------------------------------------------------------------------
# Stack apply
# ---------------------------------------------------------------------------


def _pools(state, a):
    return None if a is None else {"k": state["k"][a], "v": state["v"][a]}


def apply_stack_full(cfg, specs, layers, x, positions, capacity=0):
    """→ (x, caches): ``{"k","v"}`` stacked (La, B, C, Hkv, hd) over the
    attention layers (C = capacity or S) when there are any, and
    ``"rows"`` (per layer, batch rows) when any layer has rows."""
    ks, vs, rows = [], [], []
    for spec, p in zip(specs, layers):
        x, kv, r = apply_layer_full(cfg, spec, p, x, positions, capacity)
        if kv is not None:
            ks.append(kv["k"])
            vs.append(kv["v"])
        rows.append(r)
    caches = {}
    if ks:
        caches["k"], caches["v"] = torch.stack(ks), torch.stack(vs)
    if any(rows):
        caches["rows"] = rows
    return x, caches


def apply_stack_decode_ring(cfg, layers, x, caches, pos):
    """One token through every layer against ring caches {"k","v"}
    (L, B, C, Hkv, hd), written in place at slot ``pos % C``."""
    pvec = attn.position_vector(pos, x.device)         # once per step
    for li, p in enumerate(layers):
        x = apply_layer_decode_ring(cfg, p, x, _pools(caches, li), pos, pvec)
    return x


def apply_stack_decode(cfg, specs, layers, x, state, positions,
                       block_tables):
    live = (positions >= 0).nonzero(as_tuple=True)[0]   # once per step
    for spec, p, a, rows in zip(specs, layers, attn_index(specs),
                                state["rows"]):
        x = apply_layer_decode(cfg, spec, p, x, _pools(state, a), rows,
                               positions, block_tables, live)
    return x


def apply_stack_chunk(cfg, specs, layers, x, state, positions, block_row,
                      slot):
    for spec, p, a, rows in zip(specs, layers, attn_index(specs),
                                state["rows"]):
        x = apply_layer_chunk(cfg, spec, p, x, _pools(state, a), rows,
                              positions, block_row, slot)
    return x


# ---------------------------------------------------------------------------
# Per-slot rows: the reference's gather/scatter/reset leaf order
# ---------------------------------------------------------------------------


def _row_sites(cfg, specs, state):
    """Yield ``(leaves, scan)`` in the reference's leaf order
    (``lm.py:509-582``): layout site by site, row keys in its order
    (mixer, then ffn), leaf names sorted; ``leaves`` holds one
    batch-indexed tensor per layer the site stacks."""
    for _, _, layers, spec, scan in layout_layers(cfg, specs):
        for key in ("mixer", "ffn"):
            rows0 = state["rows"][layers[0]].get(key)
            if rows0 is None:
                continue
            for name in sorted(rows0):
                yield [state["rows"][li][key][name] for li in layers], scan


def gather_state_row(cfg, specs, state, slot):
    """Slot ``slot``'s rows → flat leaf list in the reference's order and
    shapes (a scan site stacks its layers on a leading axis; the batch
    axis is dropped)."""
    out = []
    for leaves, scan in _row_sites(cfg, specs, state):
        rows = [leaf[slot] for leaf in leaves]
        out.append(torch.stack(rows) if scan else rows[0])
    return out


def scatter_state_row(cfg, specs, state, slot, leaves):
    """Inverse of :func:`gather_state_row`, in place."""
    it = iter(leaves)
    for dsts, scan in _row_sites(cfg, specs, state):
        src = next(it)
        for j, dst in enumerate(dsts):
            dst[slot] = (src[j] if scan else src).to(dst.dtype)
    return state


def reset_state_row(cfg, specs, state, slot):
    """Zero slot ``slot``'s rows in place — a request admitted into a
    recycled slot must not read the previous occupant's state."""
    for dsts, _ in _row_sites(cfg, specs, state):
        for dst in dsts:
            dst[slot] = 0
    return state
