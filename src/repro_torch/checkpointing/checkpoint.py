"""Manifest-based checkpointing of trees of torch tensors, on the
reference's on-disk layout (``repro.checkpointing.checkpoint``)::

    <root>/step_000120/
        manifest.json          # key → {file, shape, dtype}, step, meta
        <leafkey>.npy          # one file per tree leaf
        _COMMITTED             # written last — crash-safe commit marker

A tree is nested dicts, lists and tuples with tensor (or numpy, or
scalar) leaves; leaf keys are the path's dict keys and list indices
joined by ``.``, as the reference forms them from JAX key paths, so
either package restores what the other wrote. bf16 leaves are stored as
their raw ``uint16`` bits with ``"dtype": "bfloat16"`` in the manifest,
as the reference stores them, and rebuilt with
``torch.from_numpy(bits).view(torch.bfloat16)`` (no ``ml_dtypes``).

Restore can target another device than the one that saved (live
migration): leaves are read on the host and moved to ``device``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

import numpy as np
import torch

_COMMIT = "_COMMITTED"


def flatten_with_path(tree, prefix=()):
    """→ [(path, leaf)] in JAX's flattening order (dict keys sorted,
    sequences in order); a path is a tuple of dict keys and int
    indices."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_path(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_path(v, prefix + (i,))
        return out
    return [(prefix, tree)]


def _leaf_key(path) -> str:
    """The reference's file key of a leaf: its path joined by ``.``."""
    return ".".join(str(p) for p in path) or "root"


def _to_numpy(leaf):
    """→ (numpy array to store, true dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(root: str, step: int, tree, meta: Optional[dict] = None) -> str:
    """Synchronous save. Returns the checkpoint directory."""
    d = os.path.join(root, f"step_{step:08d}")
    tmp = d + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "meta": meta or {}, "leaves": {}}
    for path, leaf in flatten_with_path(tree):
        key = _leaf_key(path)
        arr, true_dtype = _to_numpy(leaf)
        fn = re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][key] = {"file": fn, "shape": list(arr.shape),
                                   "dtype": true_dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(d):
        shutil.rmtree(d)
    os.rename(tmp, d)
    return d


def _load_leaf(ckpt_dir, info) -> torch.Tensor:
    arr = np.load(os.path.join(ckpt_dir, info["file"]))
    want = info["dtype"]
    if want == "bfloat16":                  # stored as its uint16 bits
        bits = arr.view(np.int16)          # np.load gives C order
        return torch.from_numpy(bits).view(torch.bfloat16)
    if str(arr.dtype) != want:
        raise TypeError(f"checkpoint leaf stored as {arr.dtype}, manifest "
                        f"says {want}")
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, template=None, device=None):
    """Restore a checkpoint directory → (step, tree, meta).

    ``template`` (a tree of like-structured tensors) defines the output
    structure, dtypes and shapes; without it a flat {key: tensor} dict is
    returned. Leaves are placed on ``device`` (default: the CPU)."""
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    dev = torch.device(device if device is not None else "cpu")
    arrays = {key: _load_leaf(ckpt_dir, info)
              for key, info in manifest["leaves"].items()}
    if template is None:
        return (manifest["step"], {k: v.to(dev) for k, v in arrays.items()},
                manifest["meta"])
    leaves = {}
    for path, tmpl in flatten_with_path(template):
        key = _leaf_key(path)
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        t = torch.as_tensor(tmpl)
        arr = arrays[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(arr.shape)} vs {tuple(t.shape)}")
        leaves[path] = arr.to(dtype=t.dtype, device=dev)
    return manifest["step"], _rebuild(template, leaves), manifest["meta"]


def _rebuild(tree, leaves, prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, leaves, prefix + (i,))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return leaves[prefix]


def latest(root: str) -> Optional[str]:
    if not os.path.isdir(root):
        return None
    best = None
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if (name.startswith("step_") and
                os.path.exists(os.path.join(d, _COMMIT))):
            best = d
    return best
