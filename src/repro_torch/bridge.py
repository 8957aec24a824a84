"""Parameter and state bridge between the reference's JAX pytrees and the
port.

The reference's ``Model.init`` returns ``{"tok_embed", "lm_head",
"final_norm", "segments": [...]}`` where each segment is a list of layer
dicts laid out by ``repro/models/lm.py::build_layout``: a scan segment
holds one dict per position of the block pattern, its leaves stacked on
a leading periods axis; an unrolled segment holds one dict per layer
(recurrentgemma-2b is a scan over 8 ``(rglru, rglru, swa)`` periods and
an unrolled ``(rglru, rglru)`` tail; kimi-k2 an unrolled dense first
layer before a scan over its MoE layers, whose stacked experts carry the
periods axis before ``(E, d, de)``). The port keeps one dict per layer
in absolute order. An enc-dec model's ``encoder`` holds its own
``segments`` (the port's ``encoder["layers"]``); ``projector`` and
``enc_proj`` cross as they are. Layouts are kept as they are (``wq (d,H,hd)``,
``wo (H,hd,d)``, ``w_gate (d,ff)``, ``w_ra (H,dh,dh)``), so the two
packages' einsums compare like for like.

Both directions speak numpy: a tree from JAX is taken after
``jax.device_get`` (this module imports no JAX). The round trip
``params_to_numpy(params_from_jax(tree), cfg)`` is byte-exact. A bf16
leaf (an ``ml_dtypes`` array on the JAX side) crosses as its raw bits; on
the way back it stays bits (``uint16``), since the port does not depend
on ``ml_dtypes``.

Ring caches and paged serving states cross the same way. The
reference's are the segment structure of its layout (a scan segment's
leaves stacked on the periods axis, an unrolled one per layer), each
layer ``{"mixer": ..., "cross": ..., "ffn": ...}``; the port's are
``"k"``/``"v"``
stacked over the attention layers — (La, B, C, Hkv, hd) rings or
(La, P, ps, Hkv, hd) pools — and ``"rows"``, one dict of batch rows per
layer (:func:`caches_from_jax` / :func:`caches_to_numpy`,
:func:`state_rows_from_jax` / :func:`state_rows_to_numpy`).
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


def _stack(*leaves, join=torch.stack):
    if isinstance(leaves[0], dict):
        return {k: _stack(*(lf[k] for lf in leaves), join=join)
                for k in leaves[0]}
    return join(leaves)


class Stacked:
    """A stacked leaf of the reference's layout kept as its layers'
    tensors (no stacked copy is made): ``parts[j]`` is period ``j``."""

    def __init__(self, parts):
        self.parts = tuple(parts)


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


def _layers_from_jax(segments, device):
    """A segment is a scan when its leaves carry the periods axis (a
    norm scale of rank 2)."""
    layers = []
    for seg in segments:
        scale = np.asarray(seg[0]["norm1"]["scale"])
        if scale.ndim == 1:                       # unrolled
            layers += [_to_torch(layer, device) for layer in seg]
        else:                                     # scan over periods
            layers += [_to_torch(seg[li], device, index=j)
                       for j in range(scale.shape[0])
                       for li in range(len(seg))]
    return layers


def params_from_jax(tree, device="cpu"):
    """JAX ``Model.init`` pytree (numpy leaves) → port parameters."""
    out = {k: _to_torch(v, device) for k, v in tree.items()
           if k not in ("segments", "encoder")}
    out["layers"] = _layers_from_jax(tree["segments"], device)
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": _layers_from_jax(enc["segments"], device),
            "final_norm": _to_torch(enc["final_norm"], device)}
    return out


def stacked_layout(params, cfg=None, join=torch.stack):
    """Port parameters → the JAX pytree layout. ``cfg`` gives the
    reference's segment layout; without it the layers are stacked as one
    scan segment of one layer kind (attention-only and rwkv6 stacks).
    With the default ``join`` the leaves are CPU tensors; with
    ``join=Stacked`` they stay where they are and a scan site's leaf is a
    :class:`Stacked` of its layers' tensors."""
    copy = _cpu if join is torch.stack else (lambda t: t)
    out = {k: copy(v) for k, v in params.items()
           if k not in ("layers", "encoder")}
    if cfg is None:
        layers = [copy(p) for p in params["layers"]]
        out["segments"] = [[_stack(*layers, join=join)]]
        return out
    out["segments"] = _segments(params["layers"], cfg, lm.layer_specs(cfg),
                                join, copy)
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {
            "segments": _segments(enc["layers"], cfg, lm.encoder_specs(cfg),
                                  join, copy),
            "final_norm": copy(enc["final_norm"])}
    return out


def _segments(layers, cfg, specs, join, copy):
    layers = [copy(p) for p in layers]
    segs = []
    for si, li, idx, _, scan in lm.layout_layers(cfg, specs):
        if si == len(segs):
            segs.append([])
        segs[si].append(_stack(*(layers[i] for i in idx), join=join)
                        if scan else layers[idx[0]])
    return segs


def params_to_numpy(params, cfg=None):
    """Inverse of :func:`params_from_jax`: port parameters → the JAX
    pytree layout with numpy leaves (see :func:`stacked_layout`)."""
    return _to_numpy(stacked_layout(params, cfg))


def caches_from_jax(caches, cfg, device="cpu"):
    """Reference ring caches (``init_cache`` / ``prefill(capacity=)``,
    numpy leaves, every segment of ``cfg``'s layout) → the port's:
    ``"k"``/``"v"`` when the stack has attention layers, ``"rows"`` when
    it has recurrent ones."""
    out = state_rows_from_jax(caches, cfg, device)
    if not any(s.is_attn for s in lm.layer_specs(cfg)):
        del out["k"], out["v"]
    if not any(out["rows"]):
        del out["rows"]
    return out


def caches_to_numpy(caches, cfg):
    """Inverse of :func:`caches_from_jax`: the port's ring caches → the
    reference's segment structure with numpy leaves."""
    return state_rows_to_numpy(caches, cfg)


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
            rows = state["rows"][layer] if "rows" in state else {}
            site = {k: _cpu(v) for k, v in rows.items()}
            if spec.is_attn:
                site["mixer"] = {kk: _cpu(state[kk][aidx[layer]])
                                 for kk in ("k", "v")}
            per_layer.append(site)
        segs[si].append(_to_numpy(_stack(*per_layer) if scan
                                  else per_layer[0]))
    return segs


def opt_state_from_jax(state, device="cpu"):
    """Reference AdamW state ``{"m", "v", "step"}`` (``repro.optim.init``
    or a step's output, numpy leaves) → the port's: ``m`` and ``v`` in
    the port's parameter layout, ``step`` a 0-d int32 tensor."""
    return {"m": params_from_jax(state["m"], device),
            "v": params_from_jax(state["v"], device),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}


def opt_state_to_numpy(state, cfg=None):
    """Inverse of :func:`opt_state_from_jax`: the port's AdamW state →
    the reference's layout with numpy leaves (``step`` int32)."""
    return {"m": params_to_numpy(state["m"], cfg),
            "v": params_to_numpy(state["v"], cfg),
            "step": np.asarray(int(state["step"]), dtype=np.int32)}


def batch_from_numpy(batch, device="cpu"):
    """A pipeline batch (numpy, as ``data.pipeline_for`` and the
    reference's make them) → tensors on ``device``, dtypes kept (int32
    tokens and labels, fp32 mask, patches and frames)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
