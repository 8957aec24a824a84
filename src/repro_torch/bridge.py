"""Parameter bridge between the reference's JAX pytree and the port.

The reference's ``Model.init`` returns, for a stack of identical layers,
``{"tok_embed", "lm_head", "final_norm", "segments": [[layer]]}`` where
``segments[0][0]`` holds scan-stacked leaves with a leading ``n_layers``
axis (``repro/models/lm.py::init_stack``). The port keeps one dict per
layer. Layouts are kept as they are (``wq (d,H,hd)``, ``wo (H,hd,d)``,
``w_gate (d,ff)``), so the two packages' einsums compare like for like.

Both directions speak numpy: ``tree`` is the JAX pytree after
``jax.device_get`` (this module imports no JAX). The round trip
``params_to_numpy(params_from_jax(tree))`` is byte-exact. A bf16 leaf
(an ``ml_dtypes`` array on the JAX side) crosses as its raw bits; on the
way back it stays bits (``uint16``), since the port does not depend on
``ml_dtypes``.

Ring caches cross the same way: the reference's ``init_cache``/
``prefill`` caches are ``[[{"mixer": {"k", "v"}}]]`` with leaves stacked
(L, B, C, Hkv, hd); the port's are ``{"k", "v"}`` of that shape.
"""
from __future__ import annotations

import numpy as np
import torch


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
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_from_jax(tree, device="cpu"):
    """JAX ``Model.init`` pytree (numpy leaves) → port parameters."""
    segs = tree["segments"]
    if len(segs) != 1 or len(segs[0]) != 1:
        raise NotImplementedError(
            "bridge: only a single scan segment of one layer kind is "
            "ported (attn + swiglu stacks)")
    stacked = segs[0][0]
    n = int(np.asarray(stacked["norm1"]["scale"]).shape[0])
    out = {k: _to_torch(v, device) for k, v in tree.items()
           if k != "segments"}
    out["layers"] = [_to_torch(stacked, device, index=i) for i in range(n)]
    return out


def stacked_layout(params):
    """Port parameters → the JAX pytree layout with CPU tensor leaves
    (layers re-stacked on axis 0)."""
    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        return tree.detach().cpu()

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(lf[k] for lf in leaves)) for k in leaves[0]}
        return torch.stack(leaves)
    out = {k: cpu(v) for k, v in params.items() if k != "layers"}
    out["segments"] = [[stack(*(cpu(p) for p in params["layers"]))]]
    return out


def params_to_numpy(params):
    """Inverse of :func:`params_from_jax`: port parameters → the JAX
    pytree layout with numpy leaves (layers re-stacked on axis 0)."""
    def tree_numpy(tree):
        if isinstance(tree, dict):
            return {k: tree_numpy(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [tree_numpy(v) for v in tree]
        return _to_numpy(tree)
    return tree_numpy(stacked_layout(params))


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
