"""Parameter and state bridge between the reference's JAX pytrees and the
port.

The reference's ``Model.init`` returns ``{"tok_embed", "lm_head",
"final_norm", "segments": [...]}`` where each segment is a list of layer
dicts laid out by ``repro/models/lm.py::build_layout``: a scan segment
holds one dict per position of the block pattern, its leaves stacked on
a leading periods axis; an unrolled segment holds one dict per layer
(recurrentgemma-2b is a scan over 8 ``(rglru, rglru, swa)`` periods and
an unrolled ``(rglru, rglru)`` tail). The port keeps one dict per layer
in absolute order. Layouts are kept as they are (``wq (d,H,hd)``,
``wo (H,hd,d)``, ``w_gate (d,ff)``, ``w_ra (H,dh,dh)``), so the two
packages' einsums compare like for like.

Both directions speak numpy: a tree from JAX is taken after
``jax.device_get`` (this module imports no JAX). The round trip
``params_to_numpy(params_from_jax(tree), cfg)`` is byte-exact. A bf16
leaf (an ``ml_dtypes`` array on the JAX side) crosses as its raw bits; on
the way back it stays bits (``uint16``), since the port does not depend
on ``ml_dtypes``.

Ring caches cross the same way: the reference's ``init_cache``/
``prefill`` caches of an attention stack are ``[[{"mixer": {"k", "v"}}]]``
with leaves stacked (L, B, C, Hkv, hd); the port's are ``{"k", "v"}`` of
that shape. Paged serving states (K/V pools and per-slot rows) cross
through :func:`state_rows_from_jax` / :func:`state_rows_to_numpy`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import lm


def _to_torch(tree, device, index=None):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, index) for k, v in tree.items()}
    a = np.asarray(tree)
    if index is not None:
        a = a[index]
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _stack(*leaves):
    if isinstance(leaves[0], dict):
        return {k: _stack(*(lf[k] for lf in leaves)) for k in leaves[0]}
    return torch.stack(leaves)


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


def params_from_jax(tree, device="cpu"):
    """JAX ``Model.init`` pytree (numpy leaves) → port parameters. A
    segment is a scan when its leaves carry the periods axis (a norm
    scale of rank 2)."""
    out = {k: _to_torch(v, device) for k, v in tree.items()
           if k != "segments"}
    layers = []
    for seg in tree["segments"]:
        scale = np.asarray(seg[0]["norm1"]["scale"])
        if scale.ndim == 1:                       # unrolled
            layers += [_to_torch(layer, device) for layer in seg]
        else:                                     # scan over periods
            layers += [_to_torch(seg[li], device, index=j)
                       for j in range(scale.shape[0])
                       for li in range(len(seg))]
    out["layers"] = layers
    return out


def stacked_layout(params, cfg=None):
    """Port parameters → the JAX pytree layout with CPU tensor leaves.
    ``cfg`` gives the reference's segment layout; without it the layers
    are stacked as one scan segment of one layer kind (attention-only
    stacks)."""
    layers = [_cpu(p) for p in params["layers"]]
    out = {k: _cpu(v) for k, v in params.items() if k != "layers"}
    if cfg is None:
        out["segments"] = [[_stack(*layers)]]
        return out
    segs = []
    for si, li, idx, _, scan in lm.layout_layers(cfg, lm.layer_specs(cfg)):
        if si == len(segs):
            segs.append([])
        segs[si].append(_stack(*(layers[i] for i in idx)) if scan
                        else layers[idx[0]])
    out["segments"] = segs
    return out


def params_to_numpy(params, cfg=None):
    """Inverse of :func:`params_from_jax`: port parameters → the JAX
    pytree layout with numpy leaves (see :func:`stacked_layout`)."""
    return _to_numpy(stacked_layout(params, cfg))


def caches_from_jax(caches, device="cpu"):
    """Reference ring caches ``[[{"mixer": {"k","v"}}]]`` (numpy leaves,
    stacked (L,B,C,Hkv,hd)) → the port's ``{"k","v"}``."""
    if len(caches) != 1 or len(caches[0]) != 1:
        raise NotImplementedError("bridge: one scan segment of attn layers")
    return _to_torch(caches[0][0]["mixer"], device)


def caches_to_numpy(caches):
    """Inverse of :func:`caches_from_jax`: the port's ring caches → the
    reference's ``[[{"mixer": {"k","v"}}]]`` with numpy leaves."""
    return [[{"mixer": _to_numpy(caches)}]]


def state_rows_from_jax(state, cfg, device="cpu"):
    """Reference paged serving state (``Model.init_paged_state``'s
    segments, numpy leaves) → the port's ``{"k", "v", "rows"}``: the
    attn/swa pools stacked in layer order (empty, (0, 0, 0, Hkv, hd), for
    an attention-free stack) and one dict of batch rows per layer."""
    specs = lm.layer_specs(cfg)
    pools = {"k": [None] * sum(s.is_attn for s in specs)}
    pools["v"] = list(pools["k"])
    rows = [{} for _ in specs]
    aidx = lm.attn_index(specs)
    for si, li, idx, spec, scan in lm.layout_layers(cfg, specs):
        site = state[si][li]
        for j, layer in enumerate(idx):
            pick = j if scan else None
            for key, leaves in site.items():
                if key == "mixer" and spec.is_attn:
                    for kk in ("k", "v"):
                        pools[kk][aidx[layer]] = _to_torch(leaves[kk],
                                                           device, pick)
                else:
                    rows[layer][key] = _to_torch(leaves, device, pick)
    out = {"rows": rows}
    for kk, lst in pools.items():
        out[kk] = torch.stack(lst) if lst else torch.zeros(
            (0, 0, 0, cfg.n_kv_heads, cfg.d_head),
            dtype=getattr(torch, cfg.compute_dtype), device=device)
    return out


def state_rows_to_numpy(state, cfg):
    """Inverse of :func:`state_rows_from_jax`: the port's paged state →
    the reference's segment structure with numpy leaves."""
    specs = lm.layer_specs(cfg)
    aidx = lm.attn_index(specs)
    segs = []
    for si, li, idx, spec, scan in lm.layout_layers(cfg, specs):
        if si == len(segs):
            segs.append([])
        per_layer = []
        for layer in idx:
            site = {k: _cpu(v) for k, v in state["rows"][layer].items()}
            if spec.is_attn:
                site["mixer"] = {kk: _cpu(state[kk][aidx[layer]])
                                 for kk in ("k", "v")}
            per_layer.append(site)
        segs[si].append(_to_numpy(_stack(*per_layer) if scan
                                  else per_layer[0]))
    return segs
