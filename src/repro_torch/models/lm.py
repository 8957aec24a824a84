"""LM assembly — the PyTorch counterpart of ``repro.models.lm`` for stacks
of ``attn | swa | rglru | rwkv`` mixers with ``swiglu | gelu | moe |
channelmix`` FFNs, mixed freely (recurrentgemma's ``(rglru, rglru,
swa)`` periods, rwkv6's ``(rwkv,)``, kimi's dense first layer before its
MoE layers), and with cross attention to an encoder's output in every
layer of an enc-dec decoder (whisper).

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
  ``{"ffn": {"shift" (B,d)}}``, an enc-dec decoder layer's cross K/V
  ``{"cross": {"k", "v" (B, S_enc, Hkv, hd)}}`` (written at prefill,
  read by every decode step), ``{}`` for attention layers. Decode
  updates the live slots' rows in place; a dead slot (position -1) keeps
  its rows, and a prefill chunk reads and writes only its own slot's.

Contiguous ring caches (``Model.prefill(capacity=)``, ``init_cache`` and
``decode``: the VMM's programs) have the same form: ``"k"``, ``"v"``
stacked over the attention layers, ``(La, B, C, Hkv, hd)`` — C the
capacity for ``attn``, ``min(window, capacity)`` for ``swa`` — and
``"rows"`` for the recurrent leaves; a key is absent when no layer has
such a leaf. Decode writes each layer's ring slot and every row in
place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec
from repro_torch.models.layers import apply_ffn, apply_norm, dt, init_ffn, \
    init_norm

MIXERS = ("attn", "swa", "rglru", "rwkv")
FFNS = ("swiglu", "gelu", "moe", "channelmix")


@dataclass(frozen=True)
class LayerSpec:
    mixer: str                  # attn | swa | rglru | rwkv
    ffn: str                    # swiglu | gelu | moe | channelmix
    d_ff: int
    cross: bool = False         # cross attention to the encoder output

    @property
    def is_attn(self) -> bool:
        return self.mixer in ("attn", "swa")


def layer_specs(cfg) -> Tuple[LayerSpec, ...]:
    """The decoder's layers (with cross attention in an enc-dec model); a
    MoE config's first ``first_dense_layers`` get a swiglu FFN of
    ``dense_d_ff`` (reference ``lm.py:55-63``)."""
    out = []
    for i in range(cfg.n_layers):
        ffn, d_ff = cfg.ffn_kind, cfg.d_ff
        if ffn == "moe" and i < cfg.moe.first_dense_layers:
            ffn, d_ff = "swiglu", cfg.moe.dense_d_ff
        spec = LayerSpec(cfg.layer_mixer(i), ffn, d_ff, cfg.is_encdec)
        if spec.mixer not in MIXERS or spec.ffn not in FFNS:
            raise NotImplementedError(
                f"layer {i}: {spec.mixer}/{spec.ffn} is not ported "
                f"(mixers {MIXERS}, FFNs {FFNS})")
        out.append(spec)
    return tuple(out)


def encoder_specs(cfg) -> Tuple[LayerSpec, ...]:
    """An enc-dec model's encoder: non-causal attention with the GELU
    FFN in every layer (reference ``model.py:36-39``)."""
    return tuple(LayerSpec("attn", "gelu", cfg.d_ff)
                 for _ in range(cfg.encoder.n_layers))


def build_layout(cfg, specs):
    """The reference's segment layout (``lm.py:66-85``): an
    ``("unroll", prefix)`` of a MoE config's dense first layers, then
    ``("scan", period_specs, n)`` over whole periods of
    ``cfg.block_pattern`` and an ``("unroll", tail_specs)`` remainder."""
    if not cfg.sharding.scan_layers:
        return [("unroll", tuple(specs))]
    prefix = cfg.moe.first_dense_layers if cfg.ffn_kind == "moe" else 0
    p = len(cfg.block_pattern)
    body = specs[prefix:]
    n_scan, tail = divmod(len(body), p)
    layout = []
    if prefix:
        layout.append(("unroll", tuple(specs[:prefix])))
    if n_scan:
        layout.append(("scan", tuple(body[:p]), n_scan))
    if tail:
        layout.append(("unroll", tuple(body[n_scan * p:])))
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
    if spec.cross:
        p["norm_cross"] = init_norm(cfg, device)
        p["cross"] = attn.init_attn(cfg, gen, device)
    if spec.ffn == "moe":
        p["ffn"] = moe_mod.init_moe(cfg, gen, device)
    elif spec.ffn == "channelmix":
        p["ffn"] = rec.init_channelmix(cfg, gen, device)
    else:
        p["ffn"] = init_ffn(cfg, gen, device, kind=spec.ffn, d_ff=spec.d_ff)
    return p


def init_layer_rows(cfg, spec, batch, device, enc_len=0):
    """Zeroed per-slot rows of one layer (``{}`` for self-attention
    without cross attention); cross K/V rows hold ``enc_len`` encoder
    positions."""
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
    if spec.cross:
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.d_head)
        rows["cross"] = {kk: torch.zeros(shape, dtype=cd, device=device)
                         for kk in ("k", "v")}
    if spec.ffn == "channelmix":
        rows["ffn"] = {"shift": torch.zeros((batch, d), dtype=cd,
                                            device=device)}
    return rows


def init_paged_state(cfg, specs, batch, num_pages, page_size, device,
                     enc_len=0):
    """Zeroed paged serving state: K/V pools (La, P, ps, Hkv, hd) in the
    compute dtype over the attn/swa layers, and per-slot rows of ``batch``
    slots for every other leaf (cross K/V of ``enc_len`` rows)."""
    n_attn = sum(s.is_attn for s in specs)
    shape = (n_attn, num_pages, page_size, cfg.n_kv_heads, cfg.d_head)
    cd = dt(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=cd, device=device),
            "v": torch.zeros(shape, dtype=cd, device=device),
            "rows": [init_layer_rows(cfg, s, batch, device, enc_len)
                     for s in specs]}


def ring_capacity(cfg, specs, capacity):
    """Slots of the attention layers' rings: ``capacity`` for ``attn``,
    ``min(window, capacity)`` for ``swa`` (reference ``lm.py:121``); None
    for a stack without attention. The port stacks the rings of all
    attention layers, so they must agree (every configuration of the
    repo has one attention kind)."""
    caps = {capacity if s.mixer == "attn" else min(cfg.window, capacity)
            for s in specs if s.is_attn}
    if len(caps) > 1:
        raise NotImplementedError(
            f"{cfg.name}: ring caches of attn beside swa layers (capacities "
            f"{sorted(caps)}) are not ported")
    return caps.pop() if caps else None


def init_stack_cache(cfg, specs, batch, capacity, device, enc_len=0):
    """Zeroed ring caches of any stack (reference ``lm.py:116-141``,
    ``:361-375``): ``"k"``/``"v"`` (La, B, C, Hkv, hd) in the compute dtype
    over the attention layers (C from :func:`ring_capacity`) and
    ``"rows"`` — the per-layer rows of :func:`init_layer_rows` — when a
    layer is recurrent."""
    caches = {}
    C = ring_capacity(cfg, specs, capacity)
    if C is not None:
        n_attn = sum(s.is_attn for s in specs)
        shape = (n_attn, batch, C, cfg.n_kv_heads, cfg.d_head)
        cd = dt(cfg.compute_dtype)
        caches["k"] = torch.zeros(shape, dtype=cd, device=device)
        caches["v"] = torch.zeros(shape, dtype=cd, device=device)
    rows = [init_layer_rows(cfg, s, batch, device, enc_len) for s in specs]
    if any(rows):
        caches["rows"] = rows
    return caches


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


def copy_kv_page_in_state(state, src, dst):
    """Device-side page copy ``dst ← src`` across every attention layer's
    K/V pool, in place — the copy-on-write byte move (the MMU's
    ``fork_page`` swaps the mapping, this copies the bytes). ``src`` and
    ``dst`` are (1,) int64 tensors on the pools' device, so the fork
    needs no host sync."""
    for kk in ("k", "v"):
        state[kk].index_copy_(1, dst, state[kk].index_select(1, src))
    return state


def _kv_page_sites(cfg, specs):
    """Yield ``(pool indices, scan)`` per attention site of the
    reference's layout — a scan site stacks its layers' pages."""
    aidx = attn_index(specs)
    for _, _, layers, spec, scan in layout_layers(cfg, specs):
        if spec.is_attn:
            yield [aidx[li] for li in layers], scan


def gather_kv_page(cfg, specs, state, page):
    """Physical page ``page`` of every K/V pool → flat leaf list in the
    reference's order (``lm.py:485``: layout site by site, k then v; a
    scan site's leaf is (n, ps, Hkv, hd), an unrolled one (ps, Hkv, hd))
    — the swap tier's device→host read."""
    leaves = []
    for idx, scan in _kv_page_sites(cfg, specs):
        for kk in ("k", "v"):
            leaf = state[kk][idx, page]          # a copy (list index)
            leaves.append(leaf if scan else leaf[0])
    return leaves


def scatter_kv_page(cfg, specs, state, page, leaves):
    """Inverse of :func:`gather_kv_page`, in place — the refault write."""
    it = iter(leaves)
    for idx, scan in _kv_page_sites(cfg, specs):
        for kk in ("k", "v"):
            src = next(it).to(state[kk].dtype)
            state[kk][idx, page] = src if scan else src[None]
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


def _mixer_full(cfg, spec, p, h, positions, capacity, row0=None,
                causal=True, make_cache=True, mesh=None):
    """→ (y, K/V cache or None, mixer rows or None); no cache and no rows
    without ``make_cache``. ``mesh`` (a rank's ``RankMesh`` narrowed to
    the mixer's parameters) runs the rank's blocks (see each mixer)."""
    if spec.is_attn:
        y, kv = attn.attn_full(cfg, p, h, positions, capacity,
                               window=_window(cfg, spec), causal=causal,
                               make_cache=make_cache, mesh=mesh)
        return y, kv, None
    if spec.mixer == "rglru":
        y, mc = rec.rglru_full(
            cfg, p, h, h0=row0["h"] if row0 else None,
            conv0=row0["conv"] if row0 else None, make_cache=make_cache,
            mesh=mesh)
    else:
        y, mc = rec.rwkv_tmix_full(cfg, p, h, cache=row0,
                                   make_cache=make_cache, mesh=mesh)
    return y, None, mc


def _ffn_full(cfg, spec, p, h2, row0=None, make_cache=True, mesh=None):
    """→ (y, ffn rows or None, the MoE's aux loss or None); serving
    leaves the aux loss unused."""
    if spec.ffn == "channelmix":
        y, rows = rec.channelmix_full(cfg, p, h2, cache=row0,
                                      make_cache=make_cache, mesh=mesh)
        return y, rows, None
    if spec.ffn == "moe":
        y, aux = moe_mod.apply_moe(cfg, p, h2, mesh=mesh)
        return y, None, aux
    return apply_ffn(cfg, p, h2, kind=spec.ffn, mesh=mesh), None, None


def apply_layer_full(cfg, spec, p, x, positions, capacity=0, enc_out=None,
                     causal=True, make_cache=True, mesh=None):
    """Full-sequence layer → (x', K/V of this layer or None, its rows,
    its MoE aux loss or None); an enc-dec decoder layer attends to
    ``enc_out`` after its mixer and keeps the cross K/V in its rows.
    Without ``make_cache`` (training) no K/V and no rows are kept.
    ``mesh`` is a rank's ``RankMesh`` narrowed to the layer."""
    h = apply_norm(cfg, p["norm1"], x)
    y, kv, mrows = _mixer_full(cfg, spec, p["mixer"], h, positions,
                               capacity, causal=causal,
                               make_cache=make_cache,
                               mesh=_at(mesh, "mixer"))
    x = x + y.to(x.dtype)
    rows = {}
    if mrows is not None:
        rows["mixer"] = mrows
    if spec.cross:
        hc = apply_norm(cfg, p["norm_cross"], x)
        ckv = attn.cross_kv(cfg, p["cross"], enc_out)
        x = x + attn.cross_attn_full(cfg, p["cross"], hc, ckv).to(x.dtype)
        if make_cache:
            rows["cross"] = ckv
    h2 = apply_norm(cfg, p["norm2"], x)
    y2, frows, aux = _ffn_full(cfg, spec, p["ffn"], h2,
                               make_cache=make_cache, mesh=_at(mesh, "ffn"))
    if frows is not None:
        rows["ffn"] = frows
    return x + y2.to(x.dtype), kv, rows, aux


def _at(mesh, *keys):
    """A rank's mesh view narrowed to the parameters at ``keys`` (None
    off a mesh)."""
    return None if mesh is None else mesh.at(*keys)


def _copy_rows(rows, new):
    """Ring decode: every slot is live, so each row leaf takes its new
    value in place."""
    for name, leaf in rows.items():
        leaf.copy_(new[name].to(leaf.dtype))


def apply_layer_decode_ring(cfg, spec, p, x, cache, rows, pos, pvec,
                            mesh=None):
    h = apply_norm(cfg, p["norm1"], x)
    if spec.is_attn:
        y = attn.attn_decode(cfg, p["mixer"], h, cache, pos, pvec,
                             window=_window(cfg, spec),
                             mesh=_at(mesh, "mixer"))
    else:
        step = rec.rglru_decode if spec.mixer == "rglru" \
            else rec.rwkv_tmix_decode
        y, mc = step(cfg, p["mixer"], h, rows["mixer"],
                     mesh=_at(mesh, "mixer"))
        _copy_rows(rows["mixer"], mc)
    x = _cross_decode(cfg, spec, p, x + y.to(x.dtype), rows)
    h2 = apply_norm(cfg, p["norm2"], x)
    if spec.ffn == "channelmix":
        y2, fc = rec.channelmix_decode(cfg, p["ffn"], h2, rows["ffn"],
                                       mesh=_at(mesh, "ffn"))
        _copy_rows(rows["ffn"], fc)
    else:
        y2 = _ffn_full(cfg, spec, p["ffn"], h2, mesh=_at(mesh, "ffn"))[0]
    return x + y2.to(x.dtype)


def _cross_decode(cfg, spec, p, x, rows):
    """The decode step's cross attention over the slots' encoder rows
    (identity for a layer without it)."""
    if not spec.cross:
        return x
    hc = apply_norm(cfg, p["norm_cross"], x)
    return x + attn.cross_attn_decode(cfg, p["cross"], hc,
                                      rows["cross"]).to(x.dtype)


def apply_layer_decode(cfg, spec, p, x, pools, rows, positions,
                       block_tables, step):
    """One layer of a paged decode step; ``step`` is the step's dict
    (``"live"`` and what the attention layers derive once a step, see
    :func:`~repro_torch.models.attention.attn_decode_paged`)."""
    live = step["live"]
    h = apply_norm(cfg, p["norm1"], x)
    if spec.is_attn:
        y = attn.attn_decode_paged(cfg, p["mixer"], h, pools, positions,
                                   block_tables, step,
                                   window=_window(cfg, spec))
    else:
        step = rec.rglru_decode if spec.mixer == "rglru" \
            else rec.rwkv_tmix_decode
        y, mc = step(cfg, p["mixer"], h, rows["mixer"])
        _keep_live(rows["mixer"], mc, live)
    x = _cross_decode(cfg, spec, p, x + y.to(x.dtype), rows)
    h2 = apply_norm(cfg, p["norm2"], x)
    if spec.ffn == "channelmix":
        y2, fc = rec.channelmix_decode(cfg, p["ffn"], h2, rows["ffn"])
        _keep_live(rows["ffn"], fc, live)
    else:
        # a MoE routes every slot's row, dead ones included: they take
        # capacity as the reference's do
        y2 = _ffn_full(cfg, spec, p["ffn"], h2)[0]
    return x + y2.to(x.dtype)


def apply_layer_chunk(cfg, spec, p, x, pools, rows, positions, block_row,
                      slot):
    """One slot's prompt chunk: attention through the slot's pages; every
    row leaf reads row ``slot`` as its initial state and gets the chunk's
    final state written back, so no other slot is touched."""
    if spec.cross:
        raise NotImplementedError(
            "chunked prefill: enc-dec cross attention (whisper prefills "
            "monolithically)")

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
    y2, fc, _ = _ffn_full(cfg, spec, p["ffn"], h2,
                          row0("ffn") if spec.ffn == "channelmix" else None)
    if fc is not None:
        put("ffn", fc)
    return x + y2.to(x.dtype)


# ---------------------------------------------------------------------------
# Stack apply
# ---------------------------------------------------------------------------


def _pools(state, a):
    return None if a is None else {"k": state["k"][a], "v": state["v"][a]}


def _requires_grad(tree):
    """Whether any tensor leaf of the nested dict/list ``tree`` requires
    a gradient."""
    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    if isinstance(tree, dict):
        tree = tree.values()
    return any(_requires_grad(t) for t in tree)


def _maybe_remat(cfg, fn, layers):
    """``cfg.sharding.remat`` (reference ``lm.py:_maybe_remat``) while a
    gradient reaches ``layers``' leaves: ``"none"`` runs ``fn`` as it is;
    ``"full"`` keeps only each layer's inputs and recomputes the layer in
    the backward (``torch.utils.checkpoint``, non-reentrant). XLA's
    ``"dots"`` policy (keep the projections' outputs) has no torch
    counterpart: it is taken as ``"full"``. Serving (params that require
    no gradient) never remats. The recompute gives the same numbers, so
    remat changes memory and time, never the result."""
    if (cfg.sharding.remat == "none" or not torch.is_grad_enabled()
            or not _requires_grad(layers)):
        return fn

    def remat(*args, **kw):
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return remat


def _apply_prepared(cfg, spec, p, *args, prepare=None, i=0):
    """``apply_layer_full`` on layer ``i``'s parameters as ``prepare``
    makes them: inside a remat'd layer, so a recompute makes them again
    rather than keeping them."""
    if prepare is not None:
        p = prepare(i, p)
    return apply_layer_full(cfg, spec, p, *args)


def apply_stack_full(cfg, specs, layers, x, positions, capacity=0,
                     enc_out=None, causal=True, make_cache=True, mesh=None,
                     prepare=None):
    """→ (x, caches, aux): ``aux`` the sum of the MoE layers' aux losses
    (fp32, 0 without MoE), as in the reference; ``caches`` are
    ``{"k","v"}`` stacked (La, B, C, Hkv, hd) over the attention layers
    when there are any — C = S with no ``capacity``, else the rings of
    :func:`init_stack_cache` (a ``swa`` layer keeps its last
    ``min(window, capacity)`` tokens, where the reference keeps
    ``capacity`` and masks all but the window at decode: the same tokens
    are read) — and ``"rows"`` (per layer, batch rows) when any layer
    has rows. ``enc_out`` feeds the cross attention of an enc-dec
    decoder; the encoder runs with ``causal=False``. Without
    ``make_cache`` (the training forward and the encoder) ``caches`` is
    None and each layer runs under :func:`_maybe_remat`. ``mesh`` (a
    rank's ``RankMesh`` narrowed to ``layers``) runs every layer on the
    rank's blocks;
    ``prepare(i, p)`` gives layer ``i`` its parameters (the mesh's
    ZeRO-3 gathers)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if capacity:
        capacity = ring_capacity(cfg, specs, capacity) or capacity
    layer = _apply_prepared
    if not make_cache:
        layer = _maybe_remat(cfg, layer, layers)
    ks, vs, rows = [], [], []
    for i, (spec, p) in enumerate(zip(specs, layers)):
        x, kv, r, a = layer(cfg, spec, p, x, positions, capacity, enc_out,
                            causal, make_cache, _at(mesh, i),
                            prepare=prepare, i=i)
        if a is not None:
            aux = aux + a
        if kv is not None:
            ks.append(kv["k"])
            vs.append(kv["v"])
        rows.append(r)
    if not make_cache:
        return x, None, aux
    caches = {}
    if ks:
        caches["k"], caches["v"] = torch.stack(ks), torch.stack(vs)
    if any(rows):
        caches["rows"] = rows
    return x, caches, aux


def apply_stack_decode_ring(cfg, specs, layers, x, caches, pos, pvec,
                            mesh=None, prepare=None):
    """One token through every layer against the ring caches of
    :func:`init_stack_cache`, updated in place: K/V at slot ``pos % C``,
    every recurrent row. ``pvec`` is ``pos`` as a (1,) int64 tensor;
    ``mesh`` runs the rank's blocks of the caches, ``prepare`` as in
    :func:`apply_stack_full`."""
    rows = caches.get("rows") or [{}] * len(specs)
    for i, (spec, p, a, r) in enumerate(zip(specs, layers,
                                            attn_index(specs), rows)):
        if prepare is not None:
            p = prepare(i, p)
        x = apply_layer_decode_ring(cfg, spec, p, x, _pools(caches, a), r,
                                    pos, pvec, _at(mesh, i))
    return x


def apply_stack_decode(cfg, specs, layers, x, state, positions,
                       block_tables):
    # once per step: the live slots, then what the layers derive from
    # the positions (index tensors, rope tables), kept by the first
    step = {"live": (positions >= 0).nonzero(as_tuple=True)[0]}
    for spec, p, a, rows in zip(specs, layers, attn_index(specs),
                                state["rows"]):
        x = apply_layer_decode(cfg, spec, p, x, _pools(state, a), rows,
                               positions, block_tables, step)
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
    (mixer, cross, ffn), leaf names sorted; ``leaves`` holds one
    batch-indexed tensor per layer the site stacks."""
    for _, _, layers, spec, scan in layout_layers(cfg, specs):
        for key in ("mixer", "cross", "ffn"):
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
