"""A rank's view of a device mesh, and the collectives the sharded steps
issue — what the reference leaves to GSPMD and ``shard_map``.

Every rank runs the model on its own blocks (the partition rules'
``to_local`` views) and moves values between ranks only through the
functions here, each of which counts its calls in :data:`COUNTS` by
kind. A collective over an axis of size 1 is skipped (nothing moves),
as XLA drops it.

Gradients follow one rule: on every rank, the gradient held for a value
that several ranks hold alike is that rank's *share* of the true
gradient, and the shares sum to it. Each collective's backward is
therefore its adjoint — ``all_reduce`` ↔ ``all_reduce``,
``all_gather`` ↔ reduce-scatter, ``all_to_all`` ↔ the reverse
``all_to_all`` — a slice's backward is autograd's own (zeros
elsewhere), the loss is seeded with 1 / (number of ranks), and a
parameter's gradient is summed over the mesh axes its leaf is
replicated on (``steps.build_train``).
"""
from __future__ import annotations

import collections
import copy
import math

import torch
import torch.distributed as dist

from repro_torch.parallel.partition import (DATA, MODEL, _entry, _kv_rule,
                                            _sanitize, batch_axes,
                                            mesh_sizes, spec_axes)

#: collective calls by kind ("all_reduce", "all_gather",
#: "reduce_scatter", "all_to_all"), forward and backward
COUNTS = collections.Counter()
#: bytes of those calls' results by the same kinds (the reference's
#: ``hlo_analysis`` counts a collective by its result shape): the
#: gathered tensor of an all-gather, the reduced one of an all-reduce;
#: the backward of an all-gather is an all-reduce of the whole gradient
#: (counted "reduce_scatter", with the bytes it moves)
BYTES = collections.Counter()


class RankMesh:
    """One rank's coordinates on a ``DeviceMesh`` with axes ``("data",
    "model")`` or ``("pod", "data", "model")``, its process groups, and
    the global batch of the step it runs (``batch``: whether the batch
    rows are split over the batch axes follows from it, as in the
    rules), for a decode step its rings' ``capacity`` (a sliding-window
    layer's ring holds ``min(window, capacity)``), and the placements
    of the step's parameters: ``specs``, the rules' spec tree, which
    :meth:`at` narrows to a layer's subtree and :meth:`split` reads,
    and ``fsdp``, the spec tree of the ``"data"`` entries that
    ``fsdp_params`` adds (``partition.fsdp_specs``; None without
    ZeRO-3). The model layers decide what is split from these, never
    from their blocks' shapes."""

    def __init__(self, mesh, batch=None, capacity=None, specs=None,
                 fsdp=None):
        self.mesh = mesh
        self.sizes = mesh_sizes(mesh)
        if MODEL not in self.sizes or DATA not in self.sizes:
            raise ValueError(f"mesh axes {tuple(self.sizes)}: expected "
                             "('data', 'model') or ('pod', 'data', "
                             "'model')")
        self.coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        self.tp = self.sizes[MODEL]
        self.tp_rank = self.coord[MODEL]
        self.dp_axes = batch_axes(mesh)
        self.dp = math.prod(self.sizes[a] for a in self.dp_axes)
        self.dp_rank = self.index(self.dp_axes)
        self.batch = batch
        self.capacity = capacity
        self.specs = specs
        self.fsdp = fsdp

    def at(self, *keys):
        """This view with ``specs`` narrowed to the subtree at ``keys``
        (``at("layers", i, "ffn")``)."""
        view = copy.copy(self)
        for k in keys:
            view.specs = view.specs[k]
        return view

    def split(self, name, dim, axis=MODEL):
        """Whether this rank holds a block of dimension ``dim`` of the
        leaf ``name`` of this view's subtree: the rules split it over
        ``axis``, and ``axis`` has more than one rank."""
        return (self.sizes[axis] > 1
                and axis in spec_axes(self.specs[name][dim]))

    @property
    def b_ok(self):
        """Whether the step's batch rows are split over the batch axes."""
        if self.batch is None:
            if self.dp > 1:
                raise ValueError("a mesh with batch axes of size > 1 needs "
                                 "the step's global batch: RankMesh(mesh, "
                                 "batch)")
            return True
        return self.batch % self.dp == 0

    @property
    def n_ranks(self):
        return math.prod(self.sizes.values())

    def size(self, axes):
        return math.prod(self.sizes[a] for a in axes)

    def index(self, axes):
        """This rank's index along ``axes`` flattened, major first."""
        idx = 0
        for a in axes:
            idx = idx * self.sizes[a] + self.coord[a]
        return idx

    def group(self, axis):
        return self.mesh.get_group(axis)

    def batch_spec_axes(self):
        """The axes the batch rows are split over (empty when the batch
        is replicated)."""
        return self.dp_axes if self.b_ok else ()

    def kv_spec(self, C, Hkv):
        """The rules' spec of one layer's K/V cache (B, C, Hkv, hd)."""
        bdp = _entry(self.dp_axes) if self.b_ok else None
        shape = (self.batch or self.dp, C, Hkv, 1)
        return _sanitize(_kv_rule(shape, self.tp, bdp), shape, self.sizes)

    def kv_seq_axes(self, C, Hkv):
        """The axes the rules split a ring of ``C`` slots over (empty when
        its K/V heads split, or its sequence is replicated)."""
        e = self.kv_spec(C, Hkv)[1]
        return () if e is None else (e if isinstance(e, tuple) else (e,))

    def block(self, t, dim, axes):
        """This rank's block of ``t`` along ``dim`` split over ``axes``."""
        n = self.size(axes)
        if n == 1:
            return t
        size = t.shape[dim] // n
        return t.narrow(dim, self.index(axes) * size, size)

    # ------------------------------------------------------------------
    # Collectives (skipped over axes of size 1)
    # ------------------------------------------------------------------
    def _live(self, axes):
        return [a for a in axes if self.sizes[a] > 1]

    def all_reduce(self, x, axes, op="sum"):
        """Sum (differentiable) or max (no gradient) over ``axes``."""
        axes = self._live(axes)
        if not axes:
            return x
        if op == "max":
            out = x.detach().clone()
            for a in axes:
                _count("all_reduce", out)
                dist.all_reduce(out, dist.ReduceOp.MAX, group=self.group(a))
            return out
        return _AllReduce.apply(x, self, tuple(axes))

    def all_gather(self, x, axes, dim):
        """Blocks along ``dim`` concatenated over ``axes`` (major first),
        differentiable (backward: reduce-scatter)."""
        axes = self._live(axes)
        if not axes:
            return x
        return _AllGather.apply(x, self, tuple(axes), dim)

    def all_to_all(self, x, axis):
        """``x[j]`` goes to rank ``j`` of ``axis``; the result's ``[j]``
        came from rank ``j`` (``jax.lax.all_to_all`` with ``split_axis =
        concat_axis = 0``, untiled), differentiable."""
        if self.sizes[axis] == 1:
            return x
        return _AllToAll.apply(x, self, axis)


def _count(kind, result):
    COUNTS[kind] += 1
    BYTES[kind] += result.numel() * result.element_size()


def _reduce(t, rm, axes):
    t = t.contiguous().clone()
    for a in axes:
        _count("all_reduce", t)
        dist.all_reduce(t, group=rm.group(a))
    return t


def _gather(t, rm, axes, dim):
    # minor axis first: the blocks of one major index stay together
    t = t.contiguous()
    for a in reversed(axes):
        n = rm.sizes[a]
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=rm.group(a))
        t = torch.cat(parts, dim=dim)
        _count("all_gather", t)
    return t


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rm, axes):
        ctx.rm, ctx.axes = rm, axes
        return _reduce(x, rm, axes)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.rm, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rm, axes, dim):
        ctx.rm, ctx.axes, ctx.dim = rm, axes, dim
        return _gather(x, rm, axes, dim)

    @staticmethod
    def backward(ctx, g):
        rm, axes, dim = ctx.rm, ctx.axes, ctx.dim
        total = g.contiguous().clone()
        for a in axes:
            _count("reduce_scatter", total)
            dist.all_reduce(total, group=rm.group(a))
        n = rm.size(axes)
        size = total.shape[dim] // n
        return (total.narrow(dim, rm.index(axes) * size, size).contiguous(),
                None, None, None)


def _exchange(t, rm, axis):
    t = t.contiguous()
    out = torch.empty_like(t)
    _count("all_to_all", out)
    dist.all_to_all_single(out, t, group=rm.group(axis))
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rm, axis):
        ctx.rm, ctx.axis = rm, axis
        return _exchange(x, rm, axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.rm, ctx.axis), None, None
