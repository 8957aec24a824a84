"""LM assembly for attention + swiglu stacks — the PyTorch counterpart of
the ``attn`` mixer in ``repro.models.lm``.

Parameters are a list of per-layer dicts (the reference stacks them on
a leading layer axis for ``jax.lax.scan``; ``bridge.py`` converts).
Paged serving state is one stacked pool per K and V,
``(L, num_pages, page_size, Hkv, hd)``: layer ``l``'s pool is the
contiguous slice ``state["k"][l]``, which the kernels read in place and
the write paths update in place. Block tables are shared by every
layer and owned by the serving engine's ``PagedKVCache``.

Contiguous ring caches (the VMM's decode programs) are one stacked
tensor per K and V, ``(L, B, C, Hkv, hd)``; decode writes each layer's
slice in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_ffn, apply_norm, dt


@dataclass(frozen=True)
class LayerSpec:
    mixer: str                  # attn (only mixer ported so far)
    ffn: str                    # swiglu
    d_ff: int


def layer_specs(cfg) -> Tuple[LayerSpec, ...]:
    out = []
    for i in range(cfg.n_layers):
        spec = LayerSpec(cfg.layer_mixer(i), cfg.ffn_kind, cfg.d_ff)
        if spec.mixer != "attn" or spec.ffn != "swiglu":
            raise NotImplementedError(
                f"layer {i}: {spec.mixer}/{spec.ffn} is not ported yet "
                "(this slice serves attn + swiglu stacks)")
        out.append(spec)
    return tuple(out)


def init_paged_state(cfg, specs, num_pages, page_size, device):
    """Zeroed shared page pools {"k","v"}: (L, P, ps, Hkv, hd) in the
    compute dtype."""
    shape = (len(specs), num_pages, page_size, cfg.n_kv_heads, cfg.d_head)
    cd = dt(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=cd, device=device),
            "v": torch.zeros(shape, dtype=cd, device=device)}


def init_stack_cache(cfg, specs, batch, capacity, device):
    """Zeroed ring caches {"k","v"}: (L, B, C, Hkv, hd) in the compute
    dtype."""
    shape = (len(specs), batch, capacity, cfg.n_kv_heads, cfg.d_head)
    cd = dt(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=cd, device=device),
            "v": torch.zeros(shape, dtype=cd, device=device)}


def write_prefill_to_state(state, caches, block_row, length, page_size):
    """Scatter one newcomer's batch=1 prefill K/V (``caches`` {"k","v"}
    (L, 1, S, Hkv, hd), S ≥ length) into its leased pages, **in place**:
    token ``t < length`` goes to page ``block_row[t // ps]`` offset
    ``t % ps`` of every layer's pool. No other slot's pages are touched."""
    t = torch.arange(length, device=block_row.device)
    pages = block_row[t // page_size].long()
    offs = t % page_size
    for kk in ("k", "v"):
        state[kk][:, pages, offs] = caches[kk][:, 0, :length]
    return state


def apply_layer_full(cfg, p, x, positions, capacity=0):
    """Full-sequence layer → (x', {"k","v"} of this layer)."""
    h = apply_norm(cfg, p["norm1"], x)
    y, kv = attn.attn_full(cfg, p["mixer"], h, positions, capacity)
    x = x + y.to(x.dtype)
    h2 = apply_norm(cfg, p["norm2"], x)
    return x + apply_ffn(cfg, p["ffn"], h2).to(x.dtype), kv


def apply_layer_decode_ring(cfg, p, x, cache, pos, pvec):
    h = apply_norm(cfg, p["norm1"], x)
    y = attn.attn_decode(cfg, p["mixer"], h, cache, pos, pvec)
    x = x + y.to(x.dtype)
    h2 = apply_norm(cfg, p["norm2"], x)
    return x + apply_ffn(cfg, p["ffn"], h2).to(x.dtype)


def apply_layer_decode(cfg, p, x, pools, positions, block_tables, live):
    h = apply_norm(cfg, p["norm1"], x)
    y = attn.attn_decode_paged(cfg, p["mixer"], h, pools, positions,
                               block_tables, live)
    x = x + y.to(x.dtype)
    h2 = apply_norm(cfg, p["norm2"], x)
    return x + apply_ffn(cfg, p["ffn"], h2).to(x.dtype)


def apply_layer_chunk(cfg, p, x, pools, positions, block_row):
    h = apply_norm(cfg, p["norm1"], x)
    y = attn.attn_prefill_chunk_paged(cfg, p["mixer"], h, pools, positions,
                                      block_row)
    x = x + y.to(x.dtype)
    h2 = apply_norm(cfg, p["norm2"], x)
    return x + apply_ffn(cfg, p["ffn"], h2).to(x.dtype)


def _pools(state, li):
    return {"k": state["k"][li], "v": state["v"][li]}


def apply_stack_full(cfg, layers, x, positions, capacity=0):
    """→ (x, caches {"k","v"} stacked (L, B, C, Hkv, hd)), C = capacity
    or S."""
    ks, vs = [], []
    for p in layers:
        x, kv = apply_layer_full(cfg, p, x, positions, capacity)
        ks.append(kv["k"])
        vs.append(kv["v"])
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}


def apply_stack_decode_ring(cfg, layers, x, caches, pos):
    """One token through every layer against ring caches {"k","v"}
    (L, B, C, Hkv, hd), written in place at slot ``pos % C``."""
    pvec = attn.position_vector(pos, x.device)         # once per step
    for li, p in enumerate(layers):
        x = apply_layer_decode_ring(cfg, p, x, _pools(caches, li), pos, pvec)
    return x


def apply_stack_decode(cfg, layers, x, state, positions, block_tables):
    live = (positions >= 0).nonzero(as_tuple=True)[0]   # once per step
    for li, p in enumerate(layers):
        x = apply_layer_decode(cfg, p, x, _pools(state, li), positions,
                               block_tables, live)
    return x


def apply_stack_chunk(cfg, layers, x, state, positions, block_row):
    for li, p in enumerate(layers):
        x = apply_layer_chunk(cfg, p, x, _pools(state, li), positions,
                              block_row)
    return x
