"""Logical → mesh sharding rules (DP / TP / EP / FSDP / SP) over the
port's trees — the PyTorch counterpart of ``repro.parallel.partition``.

Mesh axes: ``("pod",)? + ("data", "model")``.

* batch                    → ("pod", "data")  (DP)
* attention q-heads, d_ff,
  padded vocab, rwkv heads → "model"          (TP, Megatron layout)
* experts                  → "model"          (EP)
* expert d_ff              → "data"           (2-D expert sharding)
* params' d_model row      → "data"           (FSDP when the profile asks)
* decode KV cache          → batch over DP; heads over "model" when they
  divide it, else the cache *sequence* over "model" (split-KV)
* B=1 long-context decode  → cache sequence over ("data", "model") (SP)

A spec is a tuple with one entry per dimension: an axis name, a tuple of
axis names (the dimension split over their product, major to minor), or
None. Every proposed spec passes through :func:`_sanitize`, which drops
axes whose product does not divide the dimension (that dimension is
then replicated: recurrentgemma's 10 q-heads on a 16-wide model axis
leave its attention replicated while the RG-LRU and FFN carry the TP).

The rules (:func:`_leaf_rule`, :func:`_sanitize`, the cache rule) are
the reference's, copied rule for rule. The trees differ: the port keeps
one dict per layer (no scanned periods axis) and stacks its ring caches
over the attention layers, ``(La, B, C, Hkv, hd)``, whose leading ``La``
is never sharded. The functions take a ``DeviceMesh``, anything with
``.shape``/``.axis_names`` (a mapping of sizes and a tuple of names), or
a plain ``{axis: size}`` mapping, so the production meshes' specs can be
computed without their ranks.
"""
from __future__ import annotations

import dataclasses
import math

import torch

POD, DATA, MODEL = "pod", "data", "model"


def mesh_sizes(mesh):
    """``{axis: size}`` of a DeviceMesh, a mesh-like object or a mapping."""
    if isinstance(mesh, dict):
        return {a: int(n) for a, n in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                        # torch DeviceMesh
        return {a: int(mesh.size(i)) for i, a in enumerate(names)}
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def batch_axes(mesh):
    return (POD, DATA) if POD in mesh_sizes(mesh) else (DATA,)


def _prod(sizes, axes):
    return math.prod(sizes[a] for a in axes)


def _sanitize(spec, shape, sizes):
    """Drop axes whose product does not divide the dim size."""
    out = []
    for d, ax in enumerate(spec):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        out.append(ax if shape[d] % _prod(sizes, axes) == 0 else None)
    return tuple(out)


def _entry(ax):
    """One axis in a tuple is that axis (as ``PartitionSpec`` keeps it)."""
    return ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax


def _leaf_rule(cfg, names, shape, sizes):
    """Proposed sharding (pre-sanitize) for an unstacked leaf."""
    name = str(names[-1])
    nd = len(shape)
    prof = cfg.sharding
    size = math.prod(shape) if shape else 1
    fsdp = DATA if (prof.fsdp_params and size >= prof.fsdp_min_size) else None
    group = [str(n) for n in names]

    # ---- embeddings / head -------------------------------------------------
    if name == "tok_embed":
        return (MODEL, fsdp)
    if name == "lm_head":
        return (fsdp, MODEL)
    if name == "enc_proj":
        return (None, MODEL)
    if "projector" in group:
        return (None, MODEL) if name == "w1" else (MODEL, None)

    # ---- MoE (expert-stacked, ndim 3) --------------------------------------
    if name == "router":
        return (None, None)
    if "shared" in group:           # shared expert: small, replicated
        return tuple(None for _ in shape)
    if nd == 3 and name in ("w_gate", "w_up", "w_down") \
            and "shared" not in group:
        tp = sizes.get(MODEL, 1)
        if shape[0] % tp == 0:                    # many experts → EP
            ed = DATA if prof.shard_experts_data else None
            if name == "w_down":                  # (E, d_e, d)
                return (MODEL, ed, None)
            return (MODEL, None, ed)              # (E, d, d_e)
        # few big experts (E < tp) → expert-TP: shard d_e over model
        if name == "w_down":
            return (None, MODEL, None)
        return (None, None, MODEL)

    # ---- attention ----------------------------------------------------------
    if name == "wq":                              # (d, Hq, hd)
        return (fsdp, MODEL, None)
    if name in ("wk", "wv"):                      # (d, Hkv, hd)
        return (fsdp, MODEL, None)                # sanitized→repl. if kv<tp
    if name == "wo":                              # (Hq, hd, d)
        return (MODEL, None, fsdp)
    if name == "bq":
        return (MODEL, None)
    if name in ("bk", "bv"):
        return (MODEL, None)

    # ---- dense FFN / RG-LRU / RWKV projections -------------------------------
    if name in ("w_gate", "w_up", "w_x", "w_g", "w_r", "w_k", "w_v"):
        return (fsdp, MODEL)                      # (d, ff|d)
    if name in ("w_down", "w_o"):                 # (ff|d, d)
        return (MODEL, fsdp)
    if name == "b_up":
        return (MODEL,)
    if name == "b_down":
        return (None,)
    if name == "conv_w":                          # (4, d)
        return (None, MODEL)
    if name in ("conv_b", "lam", "ln_scale", "ln_bias"):
        return (MODEL,)
    if name in ("w_ra", "w_ix"):                  # (H, dh, dh) small → repl.
        return (None, None, None)
    if name == "bonus_u":                         # (H, dk)
        return (MODEL, None)

    # ---- norms / lora mixes / everything else: replicated --------------------
    return tuple(None for _ in shape)


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (i,)) for i, v in
                enumerate(tree)]
    return fn(path, tree)


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree (same structure;
    a spec is a tuple, so the spec tree's lists and dicts lead)."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, tree[k], specs[k]) for k in specs}
    if isinstance(specs, list):
        return [map_specs(fn, t, s) for t, s in zip(tree, specs)]
    return fn(tree, specs)


def param_specs(cfg, params, mesh):
    """Spec tree matching ``params`` (tensors of any device, meta ones
    included): each leaf's rule, sanitized against its shape."""
    sizes = mesh_sizes(mesh)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        spec = _sanitize(_leaf_rule(cfg, path, shape, sizes), shape, sizes)
        assert len(spec) == len(shape), (path, shape, spec)
        return spec
    return _map_with_path(rule, params)


def fsdp_specs(cfg, params, mesh):
    """The ``"data"`` entries that ``fsdp_params`` adds to
    :func:`param_specs` (ZeRO-3: a leaf's d_model row or column, which a
    layer gathers whole where it runs), None elsewhere. An expert bank's
    d_e over "data" (``shard_experts_data``) is not among them: the MoE
    paths use it split."""
    plain = dataclasses.replace(cfg, sharding=dataclasses.replace(
        cfg.sharding, fsdp_params=False))
    return map_specs(
        lambda s0, s: tuple(e if e != e0 else None for e, e0 in zip(s, s0)),
        param_specs(plain, params, mesh), param_specs(cfg, params, mesh))


def opt_specs(cfg, p_specs):
    """Optimizer state mirrors parameter sharding; step is replicated."""
    return {"m": p_specs, "v": p_specs, "step": ()}


def batch_specs(cfg, batch, mesh):
    """Every batch leaf's rows over the batch axes when they divide them
    (else replicated, e.g. B=1 long context); a 0-d leaf replicated."""
    sizes = mesh_sizes(mesh)
    ba = batch_axes(mesh)
    dp = _prod(sizes, ba)

    def rule(path, leaf):
        if leaf.dim() == 0:
            return ()
        if leaf.shape[0] % dp != 0:
            return (None,) * leaf.dim()
        return (_entry(ba),) + (None,) * (leaf.dim() - 1)
    return _map_with_path(rule, batch)


def _kv_rule(shape, tp, bdp):
    """(B, C, Hkv, hd): heads over model when they divide it, else the
    sequence (split-KV), over (data, model) when the batch is not
    sharded (B=1 long context)."""
    if shape[2] % tp == 0:
        return (bdp, None, MODEL, None)
    if bdp is not None:
        return (bdp, MODEL, None, None)
    return (None, (DATA, MODEL), None, None)


def cache_specs(cfg, caches, mesh, batch_size):
    """Spec tree of the port's ring caches: stacked ``"k"``/``"v"`` (La,
    B, C, Hkv, hd) with ``La`` unsharded, and ``"rows"`` — rwkv's state
    ``s`` (B, H, K, V), the shifts and RG-LRU's ``h`` (B, d), its conv
    history (B, 3, d), an enc-dec layer's cross K/V (B, S_enc, Hkv, hd)."""
    sizes = mesh_sizes(mesh)
    ba = batch_axes(mesh)
    tp = sizes[MODEL]
    bdp = _entry(ba) if batch_size % _prod(sizes, ba) == 0 else None

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        name = str(path[-1])
        stacked = path[0] in ("k", "v")
        base = shape[1:] if stacked else shape
        if name in ("k", "v"):
            spec = _kv_rule(base, tp, bdp)
        elif name == "s":
            spec = (bdp, MODEL, None, None)
        elif name in ("shift", "h"):
            spec = (bdp, MODEL)
        elif name == "conv":
            spec = (bdp, None, MODEL)
        else:
            spec = tuple(None for _ in base)
        spec = _sanitize(spec, base, sizes)
        if stacked:
            spec = (None,) + spec
        assert len(spec) == len(shape), (path, shape, spec)
        return spec
    return _map_with_path(rule, caches)


def logits_spec(mesh, batch_size, vocab):
    """The prefill/decode steps' logits (B, V*): rows over the batch axes
    when they divide them, the vocab over "model" (sanitized)."""
    sizes = mesh_sizes(mesh)
    return _sanitize((_entry(batch_axes(mesh)), MODEL), (batch_size, vocab),
                     sizes)


# ---------------------------------------------------------------------------
# Placements and distribution (DTensor)
# ---------------------------------------------------------------------------


def spec_axes(entry):
    """A spec entry → the tuple of mesh axes it names (major first)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def sharded_axes(spec):
    """The mesh axes a spec shards over."""
    return {a for e in spec for a in spec_axes(e)}


_PLACEMENTS = {}


def placements(spec, mesh):
    """A spec → DTensor placements, one per mesh dimension: ``Shard(d)``
    on each mesh dimension that names tensor dimension ``d`` (a tuple of
    axes on one dimension is ``Shard(d)`` on each, major to minor, which
    must follow the mesh's order), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    key = (spec, names)
    if key in _PLACEMENTS:
        return _PLACEMENTS[key]
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} are not in the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    _PLACEMENTS[key] = tuple(out)
    return _PLACEMENTS[key]


def local_block(t, spec, mesh):
    """This rank's block of a full tensor ``t`` under ``spec`` (a view)."""
    sizes = mesh_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if not axes:
            continue
        n = _prod(sizes, axes)
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + coord[a]
        size = t.shape[d] // n
        t = t.narrow(d, idx * size, size)
    return t


def _contiguous_stride(shape):
    stride, n = [], 1
    for size in reversed(shape):
        stride.append(n)
        n *= size
    return tuple(reversed(stride))


def from_local(local, spec, mesh, shape):
    """A rank's local block → the DTensor of global ``shape`` (no
    communication: the blocks are the ranks' own)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def distribute(tree, specs, mesh, device=None):
    """Full tensors (the same on every rank) → DTensors under ``specs``:
    each rank keeps only its own block, copied when it is a part (a
    sharded leaf holds no reference to the full tensor; a whole one is
    the tensor itself), on ``device`` (the tensors' own by default)."""
    def one(t, spec):
        local = local_block(t, spec, mesh)
        if local.numel() < t.numel() or device is not None:
            local = local.to(device=device or local.device, copy=True)
        return from_local(local.contiguous(), spec, mesh, tuple(t.shape))
    return map_specs(one, tree, specs)


def to_local(tree):
    """DTensor leaves → their local tensors (no communication, no
    autograd edge: a step takes its gradients on fresh leaves)."""
    from torch.distributed.tensor import DTensor

    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [one(v) for v in t]
        return t.to_local() if isinstance(t, DTensor) else t
    with torch.no_grad():
        return one(tree)


def check_placements(tree, specs, mesh, what):
    """Raise unless every leaf is a DTensor on ``mesh`` with the
    placements ``specs`` give (a step never runs on the wrong blocks)."""
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        want = placements(spec, mesh)
        if not isinstance(t, DTensor) or tuple(t.placements) != want \
                or t.device_mesh != mesh:
            got = tuple(t.placements) if isinstance(t, DTensor) else type(t)
            raise ValueError(f"{what}: a leaf has placements {got}; the "
                             f"rules give {want}")
    map_specs(one, tree, specs)


def local_bytes(tree):
    """Bytes of the local blocks' storages (each storage counted once)."""
    from torch.distributed.tensor import DTensor
    seen, total = set(), 0

    def visit(_, t):
        nonlocal total
        if isinstance(t, DTensor):
            t = t.to_local()
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            total += st.nbytes()
        return t
    _map_with_path(visit, tree)
    return total


def share_bytes(tree, specs, mesh):
    """Bytes of this rank's blocks as the rules give them."""
    sizes = mesh_sizes(mesh)
    total = 0

    def one(t, spec):
        nonlocal total
        n = math.prod(t.shape)
        for e in spec:
            n //= _prod(sizes, spec_axes(e)) if e is not None else 1
        total += n * t.element_size()
    map_specs(one, tree, specs)
    return total
