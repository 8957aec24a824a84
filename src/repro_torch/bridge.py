"""Parameter bridge between the reference's JAX pytree and the port.

The reference's ``Model.init`` returns, for a stack of identical layers,
``{"tok_embed", "lm_head", "final_norm", "segments": [[layer]]}`` where
``segments[0][0]`` holds scan-stacked leaves with a leading ``n_layers``
axis (``repro/models/lm.py::init_stack``). The port keeps one dict per
layer. Layouts are kept as they are (``wq (d,H,hd)``, ``wo (H,hd,d)``,
``w_gate (d,ff)``), so the two packages' einsums compare like for like.

Both directions speak numpy: ``tree`` is the JAX pytree after
``jax.device_get`` (this module imports no JAX). The round trip
``params_to_numpy(params_from_jax(tree))`` is byte-exact.
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
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


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


def params_to_numpy(params):
    """Inverse of :func:`params_from_jax`: port parameters → the JAX
    pytree layout with numpy leaves (layers re-stacked on axis 0)."""
    out = {k: _to_numpy(v) for k, v in params.items() if k != "layers"}
    layers = [_to_numpy(p) for p in params["layers"]]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(lf[k] for lf in leaves)) for k in leaves[0]}
        return np.stack(leaves)
    out["segments"] = [[stack(*layers)]]
    return out
