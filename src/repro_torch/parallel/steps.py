"""Step builders: assemble a model into train / prefill / decode step
programs on one device or over a device mesh — the PyTorch counterparts
of ``repro.parallel.steps``.

The virtualization compile service (``core/reconfig.py``) builds the
VMM's programs here, and native callers use the same builders: the
paper's *fidelity* criterion (one artifact for native and virtualized
execution). Each builder returns ``(step, abstract_args)``: ``step`` is
an eager callable that runs on the device its inputs live on, and
``abstract_args`` are meta tensors (shapes and dtypes, no data), with
serving parameters in bf16 as the reference's ``dtype_override`` makes
them and training parameters in ``param_dtype``.

Every builder takes a ``torch.device`` or a ``DeviceMesh`` with axes
("data", "model") or ("pod", "data", "model"). With a mesh — the
reference's ``jax.jit(..., in_shardings=, out_shardings=)`` — a step's
parameters, optimizer state, batch and caches are DTensors whose
placements the partition rules give (``parallel.partition``), and its
outputs keep them: the abstract args are meta DTensors with those
placements, and a step refuses a leaf placed otherwise. Each rank runs
the model on its local blocks (``Model(cfg, mesh=)``), with the
collectives of ``parallel.rank_mesh``; no leaf is gathered whole.
"""
from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.checkpointing.checkpoint import flatten_with_path, unflatten
from repro_torch.models import Model
from repro_torch.parallel import partition as part

#: the CUDA kernels a step kind launches for each mixer of the stack
#: (built and loaded at compile); rwkv's one-token step is plain PyTorch.
#: A train step launches each kernel in the forward and again in each
#: rematerialised layer's recompute; the scan's backward is one more
#: launch of the scan (the WKV's and flash's backwards are torch ops).
STEP_KERNELS = {"train": {"attn": "flash_attention",
                          "swa": "flash_attention",
                          "rglru": "rglru_scan", "rwkv": "rwkv6_wkv"},
                "prefill": {"attn": "flash_attention",
                            "swa": "flash_attention",
                            "rglru": "rglru_scan", "rwkv": "rwkv6_wkv"},
                "decode": {"attn": "decode_attention",
                           "swa": "decode_attention"}}


def step_kernels(kind: str, cfg):
    """The kernels a ``kind`` step of ``cfg``'s stack launches."""
    table = STEP_KERNELS.get(kind, {})
    out = []
    for mixer in cfg.block_pattern:
        name = table.get(mixer)
        if name is not None and name not in out:
            out.append(name)
    return tuple(out)


def abstract_params(model, dtype_override=None):
    """Meta tensors with the shapes (and, with ``dtype_override``, the
    floating dtype) of ``model.init``'s parameters."""
    meta = Model(model.cfg, device="meta").init(None)
    dt = getattr(torch, dtype_override) if dtype_override else None

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [conv(v) for v in tree]
        if dt is not None and tree.is_floating_point():
            return tree.to(dt)
        return tree
    return conv(meta)


# ---------------------------------------------------------------------------
# Over a mesh
# ---------------------------------------------------------------------------


def _is_mesh(target):
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(target, DeviceMesh)


def _meta_tree(tree, specs, mesh):
    """Meta DTensors with ``tree``'s global shapes and ``specs``'
    placements (the reference's sharded ``ShapeDtypeStruct``s)."""
    def one(t, spec):
        local = torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")
        return part.from_local(part.local_block(local, spec, mesh), spec,
                               mesh, tuple(t.shape))
    return part.map_specs(one, tree, specs)


def _wrap(tree, specs, shapes, mesh):
    """A rank's local blocks → DTensors of the given global shapes."""
    return part.map_specs(
        lambda t, sp: part.from_local(t, sp[0], mesh, sp[1]), tree,
        part.map_specs(lambda s, t: (s, tuple(t.shape)), specs, shapes))


def _local_pos(pos):
    from torch.distributed.tensor import DTensor
    return pos.to_local() if isinstance(pos, DTensor) else pos


def _rank_model(cfg, mesh, params_abs, batch, capacity=None):
    """The model on a rank of ``mesh``: a ``RankMesh`` with the step's
    global batch, ring capacity and the rules' placements of
    ``params_abs`` (and, under ``fsdp_params`` over a data axis of more
    than one rank, the entries ZeRO-3 gathers) → (Model, param specs)."""
    from repro_torch.parallel.rank_mesh import RankMesh
    p_specs = part.param_specs(cfg, params_abs, mesh)
    fsdp = None
    if cfg.sharding.fsdp_params and part.mesh_sizes(mesh)["data"] > 1:
        fsdp = part.fsdp_specs(cfg, params_abs, mesh)
    rm = RankMesh(mesh, batch, capacity, specs=p_specs, fsdp=fsdp)
    return Model(cfg, mesh=rm), p_specs


def _local(tree, specs, mesh, what):
    """The rank's local blocks of ``tree``, whose placements must be the
    rules' (:func:`partition.check_placements`)."""
    part.check_placements(tree, specs, mesh, what)
    return part.to_local(tree)


def _mesh_prefill(cfg, mesh, cell):
    B, cap = cell.global_batch, cell.seq_len
    meta = Model(cfg, device="meta")
    params_abs = abstract_params(meta, dtype_override="bfloat16")
    batch_abs = meta.input_specs(cell)
    cache_abs = meta.init_cache(B, cap)
    model, p_specs = _rank_model(cfg, mesh, params_abs, B)
    b_specs = part.batch_specs(cfg, batch_abs, mesh)
    c_specs = part.cache_specs(cfg, cache_abs, mesh, B)
    l_spec = part.logits_spec(mesh, B, cfg.padded_vocab)

    def prefill_step(params, batch):
        logits, caches = model.prefill(
            _local(params, p_specs, mesh, "prefill params"),
            _local(batch, b_specs, mesh, "prefill batch"), capacity=cap)
        return (part.from_local(logits, l_spec, mesh,
                                (B, cfg.padded_vocab)),
                _wrap(caches, c_specs, cache_abs, mesh))
    prefill_step.specs = (p_specs, b_specs)
    prefill_step.out_specs = (l_spec, c_specs)
    return prefill_step, (_meta_tree(params_abs, p_specs, mesh),
                          _meta_tree(batch_abs, b_specs, mesh))


def _mesh_decode(cfg, mesh, cell):
    B = cell.global_batch
    meta = Model(cfg, device="meta")
    params_abs = abstract_params(meta, dtype_override="bfloat16")
    cache_abs = meta.init_cache(B, cell.seq_len)
    token_abs = torch.empty((B, 1), dtype=torch.int32, device="meta")
    pos_abs = torch.empty((), dtype=torch.int32, device="meta")
    model, p_specs = _rank_model(cfg, mesh, params_abs, B,
                                 capacity=cell.seq_len)
    c_specs = part.cache_specs(cfg, cache_abs, mesh, B)
    t_spec = part.batch_specs(cfg, {"t": token_abs}, mesh)["t"]
    l_spec = part.logits_spec(mesh, B, cfg.padded_vocab)

    def decode_step(params, caches, token, pos):
        # the local blocks are the DTensors' own storage: the ring
        # writes land in ``caches`` in place
        logits, _ = model.decode(
            _local(params, p_specs, mesh, "decode params"),
            _local(caches, c_specs, mesh, "decode caches"),
            _local(token, t_spec, mesh, "decode token"), _local_pos(pos))
        return part.from_local(logits, l_spec, mesh,
                               (B, cfg.padded_vocab)), caches
    decode_step.specs = (p_specs, c_specs, t_spec, ())
    decode_step.out_specs = (l_spec, c_specs)
    return decode_step, (_meta_tree(params_abs, p_specs, mesh),
                         _meta_tree(cache_abs, c_specs, mesh),
                         _meta_tree(token_abs, t_spec, mesh),
                         _meta_tree(pos_abs, (), mesh))


def _live_axes(rm, axes):
    return tuple(a for a in axes if rm.sizes[a] > 1)


def _spec_at(specs, path):
    for k in path:
        specs = specs[k]
    return specs


def _reduce_grads(rm, grads, specs):
    """Sum each gradient leaf over the live mesh axes its leaf is
    replicated on (its share from each rank → the whole), one
    ``all_reduce`` per (axes, dtype) bucket."""
    flat = flatten_with_path(grads)
    buckets = {}
    for path, g in flat:
        axes = _live_axes(rm, [a for a in rm.sizes if a not in
                               part.sharded_axes(_spec_at(specs, path))])
        if axes:
            buckets.setdefault((axes, g.dtype), []).append(path)
    out = dict(flat)
    for (axes, _), paths in buckets.items():
        buf = torch.cat([out[p].reshape(-1) for p in paths])
        buf = rm.all_reduce(buf, axes)
        off = 0
        for p in paths:
            n = out[p].numel()
            out[p] = buf[off:off + n].view_as(out[p])
            off += n
    return unflatten(grads, out)


def _global_norm(rm, grads, specs):
    """The global norm of gradients held in blocks: each leaf's squares
    summed over the live axes it is split on, once over the rest."""
    sums = {}
    for path, g in flatten_with_path(grads):
        axes = _live_axes(rm, sorted(part.sharded_axes(
            _spec_at(specs, path))))
        sums[axes] = sums.get(axes, 0.0) + g.float().square().sum()
    total = 0.0
    for axes in sorted(sums):
        total = total + rm.all_reduce(sums[axes], axes)
    return torch.sqrt(total)


def _mesh_train(cfg, mesh, cell, opt_cfg):
    if opt_cfg.micro_steps > 1:
        raise NotImplementedError(
            "gradient accumulation (micro_steps > 1) on a mesh is not "
            "ported: the reference's micro-batches are row blocks of the "
            "global batch, which the batch axes split otherwise")
    B = cell.global_batch
    meta = Model(cfg, device="meta")
    params_abs = abstract_params(meta)
    opt_abs = optim.init(opt_cfg, params_abs)
    batch_abs = meta.input_specs(cell)
    model, p_specs = _rank_model(cfg, mesh, params_abs, B)
    rm = model.mesh
    o_specs = part.opt_specs(cfg, p_specs)
    b_specs = part.batch_specs(cfg, batch_abs, mesh)

    def train_step(params, opt_state, batch):
        lp = _local(params, p_specs, mesh, "train params")
        opt_local = _local(opt_state, o_specs, mesh, "optimizer state")
        batch_local = _local(batch, b_specs, mesh, "train batch")
        live = optim.adamw.tree_map(lambda p: p.detach().requires_grad_(),
                                    lp)
        with torch.enable_grad():
            loss, metrics = model.loss(live, batch_local)
            flat = optim.adamw.leaves(live)
            # every rank holds the loss alike: its share of the seed
            seed = torch.full_like(loss, 1.0 / rm.n_ranks)
            gl = torch.autograd.grad(loss, flat, grad_outputs=seed)
        grads = unflatten(live, {path: g for (path, _), g in
                                 zip(flatten_with_path(live), gl)})
        with torch.no_grad():
            grads = _reduce_grads(rm, grads, p_specs)
            gnorm = _global_norm(rm, grads, p_specs)
            new_p, new_s, om = optim.update(opt_cfg, grads, opt_local, lp,
                                            grad_norm=gnorm)
        out = {"loss": loss.detach(), **om}
        out.update({k: v.detach() for k, v in metrics.items()
                    if k != "n_tok"})
        return (_wrap(new_p, p_specs, params_abs, mesh),
                _wrap(new_s, o_specs, opt_abs, mesh), out)
    train_step.specs = (p_specs, o_specs, b_specs)
    return train_step, (_meta_tree(params_abs, p_specs, mesh),
                        _meta_tree(opt_abs, o_specs, mesh),
                        _meta_tree(batch_abs, b_specs, mesh))


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def build_prefill(cfg, device, cell):
    """→ (prefill, abstract_args). prefill(params, batch) → (last
    logits, ring caches of capacity ``cell.seq_len`` and, for recurrent
    layers, their rows: the form the decode program takes). ``device``
    may be a ``DeviceMesh`` (see the module's doc)."""
    if _is_mesh(device):
        return _mesh_prefill(cfg, device, cell)
    model = Model(cfg, device=device)
    params_abs = abstract_params(model, dtype_override="bfloat16")
    batch_abs = model.input_specs(cell)
    cap = cell.seq_len

    def prefill_step(params, batch):
        return model.prefill(params, batch, capacity=cap)
    return prefill_step, (params_abs, batch_abs)


def build_decode(cfg, device, cell):
    """→ (decode, abstract_args). decode(params, caches, token, pos) →
    (logits, caches), the ring caches and recurrent rows updated in
    place (the reference donates them)."""
    if _is_mesh(device):
        return _mesh_decode(cfg, device, cell)
    model = Model(cfg, device=device)
    B = cell.global_batch
    params_abs = abstract_params(model, dtype_override="bfloat16")
    cache_abs = Model(cfg, device="meta").init_cache(B, cell.seq_len)
    token_abs = torch.empty((B, 1), dtype=torch.int32, device="meta")
    pos_abs = torch.empty((), dtype=torch.int32, device="meta")

    def decode_step(params, caches, token, pos):
        return model.decode(params, caches, token, pos)
    return decode_step, (params_abs, cache_abs, token_abs, pos_abs)


def build_train(cfg, device, cell, opt_cfg=None):
    """→ (train_step, abstract_args). train_step(params, opt_state,
    batch) → (params, opt_state, metrics) is ``optim.make_train_step``
    over ``Model(cfg, device).loss``: new trees, the inputs untouched
    (the reference donates them). ``opt_cfg`` defaults to
    ``OptConfig(state_dtype=cfg.opt_dtype)``. On a mesh the step sums
    each gradient leaf over the axes its parameter is replicated on and
    clips by the norm of the whole tree; gradient accumulation there is
    not ported."""
    if opt_cfg is None:
        opt_cfg = optim.OptConfig(state_dtype=cfg.opt_dtype)
    if _is_mesh(device):
        return _mesh_train(cfg, device, cell, opt_cfg)
    model = Model(cfg, device=device)
    params_abs = abstract_params(model)
    opt_abs = optim.init(opt_cfg, params_abs)
    batch_abs = model.input_specs(cell)
    return (optim.make_train_step(model, opt_cfg),
            (params_abs, opt_abs, batch_abs))


def build_step_for_cell(cfg, device, cell, opt_cfg=None):
    """Dispatch on the cell kind (``opt_cfg`` for a train cell)."""
    if cell.kind == "train":
        return build_train(cfg, device, cell, opt_cfg)
    if cell.kind == "prefill":
        return build_prefill(cfg, device, cell)
    if cell.kind == "decode":
        return build_decode(cfg, device, cell)
    raise ValueError(cell.kind)
