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
:class:`CheckpointManager` adds the save interval, ``keep_n`` retention
and async saves (the host copy on the caller's thread, the file I/O on
one worker thread), as the reference's does.

Over a mesh (the reference's sharded save and elastic restore): a tree
with DTensor leaves is saved as whole leaves, each gathered inside its
mesh (every rank of the mesh calls :func:`save`; collectives in leaf
order), and written once, by the mesh's first rank. ``restore(...,
shardings_tree=)`` takes, at each leaf, the port's ``NamedSharding``,
``(mesh, spec)``: every rank of that mesh reads the host array and
keeps its own block (no collective), a rank outside it gets None. The
checkpoint may be read by ranks other than those that wrote it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
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


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the like-structured
    ``rest``; dicts, lists and tuples keep their form."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(tree, leaves, prefix=()):
    """``tree``'s structure with the leaf at each path taken from
    ``leaves`` ({path: leaf}, paths as :func:`flatten_with_path` gives
    them)."""
    if isinstance(tree, dict):
        return {k: unflatten(v, leaves, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unflatten(v, leaves, prefix + (i,))
                          for i, v in enumerate(tree))
    return leaves[prefix]


def _leaf_key(path) -> str:
    """The reference's file key of a leaf: its path joined by ``.``."""
    return ".".join(str(p) for p in path) or "root"


def _whole(leaf):
    """A DTensor leaf → its whole tensor (collective inside its mesh);
    any other leaf as it is."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        return leaf.full_tensor()
    return leaf


def all_dtensors(tree) -> bool:
    """Whether every leaf of ``tree`` is a DTensor."""
    from torch.distributed.tensor import DTensor
    return all(isinstance(leaf, DTensor)
               for _, leaf in flatten_with_path(tree))


def writes(tree) -> bool:
    """Whether this process writes ``tree``'s checkpoint: always for a
    tree of plain tensors; for one with DTensor leaves, on the first rank
    of the first such leaf's mesh only."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    for _, leaf in flatten_with_path(tree):
        if isinstance(leaf, DTensor):
            return int(leaf.device_mesh.mesh.flatten()[0]) == \
                dist.get_rank()
    return True


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
    """Synchronous save. Returns the checkpoint directory. DTensor leaves
    are gathered whole (every rank of their mesh calls this) and written
    by the mesh's first rank only (:func:`writes`)."""
    d = os.path.join(root, f"step_{step:08d}")
    writer = writes(tree)
    tree = tree_map(_whole, tree)
    if not writer:
        return d
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


def restore(ckpt_dir: str, template=None, shardings_tree=None,
            device=None):
    """Restore a checkpoint directory → (step, tree, meta).

    ``template`` (a tree of like-structured tensors, meta and DTensors
    included) defines the output structure, dtypes and shapes; without it
    a flat {key: tensor} dict is returned. ``shardings_tree`` (the
    template's structure with a ``(mesh, spec)`` at each leaf) places
    each leaf over its mesh as a DTensor: each rank of the mesh keeps its
    own block, a rank outside it gets None (reading nothing). Without it
    leaves are placed on ``device`` (default: the CPU)."""
    from repro_torch.models.model import mesh_device
    from repro_torch.parallel import partition as part
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    dev = torch.device(device if device is not None else "cpu")
    infos = manifest["leaves"]
    if template is None:
        return (manifest["step"],
                {k: _load_leaf(ckpt_dir, v).to(dev) for k, v in
                 infos.items()}, manifest["meta"])
    leaves = {}
    for path, tmpl in flatten_with_path(template):
        key = _leaf_key(path)
        if key not in infos:
            raise KeyError(f"checkpoint missing leaf {key}")
        shape = tuple(tmpl.shape) if isinstance(tmpl, torch.Tensor) \
            else tuple(np.shape(tmpl))
        if tuple(infos[key]["shape"]) != shape:
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(infos[key]['shape'])} vs {shape}")
        dtype = tmpl.dtype if isinstance(tmpl, torch.Tensor) \
            else torch.as_tensor(tmpl).dtype
        sharding = part.at_path(shardings_tree, path) \
            if shardings_tree is not None else None
        if sharding is None:
            leaves[path] = _load_leaf(ckpt_dir, infos[key]).to(
                dtype=dtype, device=dev)
            continue
        mesh, spec = sharding
        if mesh.get_coordinate() is None:
            leaves[path] = None
            continue
        whole = _load_leaf(ckpt_dir, infos[key]).to(dtype=dtype)
        local = part.local_block(whole, spec, mesh).to(
            device=mesh_device(mesh), copy=True).contiguous()
        leaves[path] = part.from_local(local, spec, mesh, shape)
    return manifest["step"], unflatten(template, leaves), manifest["meta"]


def read_manifest(ckpt_dir: str):
    """→ (step, meta) of a checkpoint directory, reading no leaf."""
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    return manifest["step"], manifest["meta"]


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


def _host_copy(leaf):
    """A host copy of a tensor leaf (a copy also of a CPU tensor: the
    caller may overwrite its tensors while the save runs); a DTensor leaf
    gathered whole first."""
    leaf = _whole(leaf)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return leaf


class CheckpointManager:  # concurrency: caller thread + one I/O worker
    # the caller's thread saves, waits and restores; the worker writes
    # and collects; _pending (the last save's future) crosses under _lock
    """Interval + retention + async-save management (reference
    ``checkpoint.py:129-179``): :meth:`should_save` every
    ``save_interval`` steps; :meth:`save` takes the host copy on the
    caller's thread (a consistent snapshot) and leaves the file I/O and
    the removal of all but the newest ``keep_n`` checkpoints to a single
    worker; :meth:`wait` returns when the last save is on disk (and
    raises its error); :meth:`restore_latest` reads the newest committed
    one. :meth:`close` waits and stops the worker."""

    def __init__(self, root: str, save_interval: int = 100,
                 keep_n: int = 3, async_save: bool = True):
        self.root = root
        self.save_interval = save_interval
        self.keep_n = keep_n
        self.async_save = async_save
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None      # guarded-by: _lock
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_interval == 0

    def save(self, step: int, tree, meta=None, block=False):
        """→ the save's Future (async) or its directory (``block`` or
        ``async_save=False``). A tree with DTensor leaves is gathered on
        every rank of their mesh (each calls this) and written by its
        first rank; the others get None."""
        writer = writes(tree)
        host_tree = tree_map(_host_copy, tree)
        if not writer:
            return None

        def _do():
            path = save(self.root, step, host_tree, meta)
            self._gc()
            return path

        if self.async_save and not block:
            self.wait()
            fut = self._pool.submit(_do)
            with self._lock:
                self._pending = fut
            return fut
        return _do()

    def wait(self):
        with self._lock:
            pending = self._pending
        if pending is not None:
            pending.result()

    def restore_latest(self, template=None, shardings_tree=None,
                       device=None):
        """→ (step, tree, meta) of the newest committed checkpoint, or
        None when there is none (``shardings_tree``: see
        :func:`restore`)."""
        d = latest(self.root)
        if d is None:
            return None
        return restore(d, template, shardings_tree, device)

    def close(self):
        self.wait()
        self._pool.shutdown(wait=True)

    def _gc(self):
        names = [n for n in sorted(os.listdir(self.root))
                 if n.startswith("step_") and not n.endswith(".tmp")]
        for n in names[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.root, n), ignore_errors=True)
