"""Per-rank op counting for the roofline — the counterpart of
``repro.launch.hlo_analysis``.

PyTorch makes no HLO text: a step runs eagerly, op by op. So instead of
parsing a compiled module, :class:`OpCounter` watches one rank's step
as it runs (a ``TorchDispatchMode``, on meta tensors in the dry run or
on the card) and counts what it dispatches:

* **dot FLOPs** of the aten matmul family (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``mv``, ``addmv``, ``dot``) and of ``convolution``:
  2 × result elements × contracted elements, as ``hlo_analysis`` counts
  a ``dot``;
* the **kernel ops' own records** (``kernels.common.record``): each
  hand-written kernel reports its dot FLOPs — counted as the reference's
  XLA form of the same call counts them — and the bytes it reads and
  writes, on the card and on meta alike (its launch is no aten op);
* **HBM bytes**: operands plus results of every dispatched op, views and
  allocations (``empty``) excluded, plus the kernels' bytes. This is
  *unfused eager traffic*: every intermediate of an elementwise chain is
  written and read back, where XLA's post-fusion model counts a fused
  chain once. It is not the reference's ``mem_bytes`` and no bound of
  it: at the production meshes it is 0.05–0.70 of the reference's HLO
  count in every 16×16 cell but one (rwkv6 ``long_500k``, 3.54;
  ``tests/test_torch_dryrun_account.py``);
* **collective bytes and counts** by the reference's kinds
  (``hlo_analysis.COLLECTIVE_KINDS``), from ``parallel.rank_mesh``'s ``COUNTS`` and
  ``BYTES`` (a collective's result bytes, as the reference counts them).

The same fields as ``HLOStats`` (``dot_flops``, ``mem_bytes``,
``collective_bytes``, ``collective_count``, ``total_collective_bytes()``,
``unknown_trip_whiles``, always 0: eager runs every layer, so no loop
trip count is ever unknown), so ``launch/dryrun.py`` reads them as the
reference's dry run reads its own.

**Memory** (the counterpart of ``compiled.memory_analysis()``): a
tracker of live storages. The step's arguments are the storages its
inputs hold; every storage an op creates is live until the last tensor
on it dies; ``temp_bytes`` is the peak of those beyond what the outputs
keep; an output that is an argument's storage (the decode step's cache
rings, updated in place) counts as the reference's donation
(``alias_bytes``).
"""
from __future__ import annotations

import collections
import math
import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import common
from repro_torch.parallel import rank_mesh

#: ``rank_mesh``'s kinds → the reference's (``COLLECTIVE_KINDS``; the
#: port issues no collective-permute)
KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce",
        "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}

aten = torch.ops.aten
#: allocations: no byte moves until something writes them
_ALLOC = {aten.empty.memory_format, aten.empty_like.default,
          aten.new_empty.default, aten.empty_strided.default,
          aten.new_empty_strided.default}


@dataclass
class OpStats:
    """One rank's counts for one step (``HLOStats``' fields, plus the
    kernels' records and the memory reckoning)."""
    dot_flops: int = 0
    collective_bytes: Dict[str, int] = field(default_factory=dict)
    collective_count: Dict[str, int] = field(default_factory=dict)
    mem_bytes: int = 0
    unknown_trip_whiles: int = 0
    #: kernel name → {"calls", "flops", "bytes"}
    kernels: Dict[str, dict] = field(default_factory=dict)
    #: aten op name → [calls, dot FLOPs, bytes]
    ops: Dict[str, list] = field(default_factory=dict)
    memory: Dict[str, int] = field(default_factory=dict)

    def total_collective_bytes(self) -> int:
        return sum(self.collective_bytes.values())

    def to_record(self) -> dict:
        """The JSON op record the dry run saves (``--reanalyze`` reads
        it back with :meth:`from_record`)."""
        return {"dot_flops": self.dot_flops, "mem_bytes": self.mem_bytes,
                "collective_bytes": self.collective_bytes,
                "collective_count": self.collective_count,
                "unknown_trip_whiles": self.unknown_trip_whiles,
                "kernels": self.kernels, "ops": self.ops,
                "memory": self.memory}

    @classmethod
    def from_record(cls, rec: dict) -> "OpStats":
        """Recount from a saved record: FLOPs and bytes summed again
        from its per-op and per-kernel entries."""
        st = cls(collective_bytes=dict(rec["collective_bytes"]),
                 collective_count=dict(rec["collective_count"]),
                 kernels=rec["kernels"], ops=rec["ops"],
                 memory=rec["memory"])
        st.dot_flops = (sum(v[1] for v in st.ops.values())
                        + sum(k["flops"] for k in st.kernels.values()))
        st.mem_bytes = (sum(v[2] for v in st.ops.values())
                        + sum(k["bytes"] for k in st.kernels.values()))
        return st


def _mm(a, b, *_, **__):
    return 2 * a.shape[0] * a.shape[1] * b.shape[-1]


def _addmm(_c, a, b, *_, **__):
    return _mm(a, b)


def _bmm(a, b, *_, **__):
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _baddbmm(_c, a, b, *_, **__):
    return _bmm(a, b)


def _mv(a, _x, *_, **__):
    return 2 * a.shape[0] * a.shape[1]


def _addmv(_c, a, x, *_, **__):
    return _mv(a, x)


def _dot(a, _b, *_, **__):
    return 2 * a.shape[0]


def _conv(x, w, *args, out=None, **__):
    # 2 × output elements × (input channels a group × kernel taps)
    return 2 * math.prod(out.shape) * math.prod(w.shape[1:])


_DOTS = {aten.mm.default: _mm, aten.addmm.default: _addmm,
         aten.bmm.default: _bmm, aten.baddbmm.default: _baddbmm,
         aten.mv.default: _mv, aten.addmv.default: _addmv,
         aten.dot.default: _dot, aten.convolution.default: _conv}


def _tensors(tree, out=None):
    """The tensors in nested tuples, lists and dicts of an op's
    arguments or results."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _storage_key(t):
    return t.untyped_storage()._cdata


class _Live:
    """Bytes of the storages created under the counter that are still
    referenced, and their peak."""

    def __init__(self):
        self.refs: Dict[int, list] = {}      # storage → [bytes, tensors]
        self.now = 0
        self.peak = 0

    def track(self, t, skip):
        if type(t) is not torch.Tensor and hasattr(t, "_local_tensor"):
            t = t._local_tensor                      # a DTensor's block
        key = _storage_key(t)
        if key in skip:
            return
        ent = self.refs.get(key)
        if ent is None:
            ent = self.refs[key] = [t.untyped_storage().nbytes(), 0]
            self.now += ent[0]
            self.peak = max(self.peak, self.now)
        ent[1] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key):
        ent = self.refs.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.now -= ent[0]
            del self.refs[key]


class OpCounter(TorchDispatchMode):
    """Count one rank's step: ``with OpCounter(args) as c: out =
    step(*args)``, then ``c.finish(out)`` → :class:`OpStats`. ``args``
    are the step's inputs (DTensors are read as their local blocks),
    counted as its arguments. While active it is the kernels' recorder
    and reads ``rank_mesh``'s collective counters from zero."""

    def __init__(self, args=()):
        super().__init__()
        self.stats = OpStats()
        self.live = _Live()
        self.arg_keys = {}
        for t in _local_tensors(args):
            self.arg_keys.setdefault(_storage_key(t),
                                     t.untyped_storage().nbytes())
        self._prev = None
        self._counts = self._bytes = None

    def __enter__(self):
        self._prev = common.recorder
        common.recorder = self._kernel
        self._counts = collections.Counter(rank_mesh.COUNTS)
        self._bytes = collections.Counter(rank_mesh.BYTES)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        common.recorder = self._prev
        st = self.stats
        for kind, n in (rank_mesh.COUNTS - self._counts).items():
            st.collective_count[KIND[kind]] = n
        for kind, n in (rank_mesh.BYTES - self._bytes).items():
            st.collective_bytes[KIND[kind]] = n
        return out

    def _kernel(self, name, flops, bytes_in, bytes_out):
        k = self.stats.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                                 "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += bytes_in + bytes_out
        self.stats.dot_flops += flops
        self.stats.mem_bytes += bytes_in + bytes_out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self.live.track(t, self.arg_keys)
        if func.is_view or func in _ALLOC:
            return out
        flops = 0
        fn = _DOTS.get(func)
        if fn is not None:
            flops = fn(*args, out=out, **kwargs) if func is \
                aten.convolution.default else fn(*args, **kwargs)
        nb = _nbytes(_tensors((args, kwargs))) + _nbytes(outs)
        ent = self.stats.ops.setdefault(str(func.overloadpacket), [0, 0, 0])
        ent[0] += 1
        ent[1] += flops
        ent[2] += nb
        self.stats.dot_flops += flops
        self.stats.mem_bytes += nb
        return out

    def finish(self, outputs) -> OpStats:
        """The memory reckoning once the step has returned ``outputs``
        (still referenced by the caller)."""
        outs = {}
        for t in _local_tensors(outputs):
            outs.setdefault(_storage_key(t), t.untyped_storage().nbytes())
        alias = sum(b for k, b in outs.items() if k in self.arg_keys)
        out_bytes = sum(outs.values())
        new_out = out_bytes - alias
        args = sum(self.arg_keys.values())
        temp = max(0, self.live.peak - new_out)
        self.stats.memory = {
            "argument_bytes": args, "output_bytes": out_bytes,
            "temp_bytes": temp, "alias_bytes": alias,
            "per_device_bytes": args + temp + out_bytes - alias}
        return self.stats


def _local_tensors(tree):
    from torch.distributed.tensor import DTensor
    out = []
    for t in _tensors(tree):
        out.append(t.to_local() if isinstance(t, DTensor) else t)
    return out


def count_step(step, args) -> OpStats:
    """Run ``step(*args)`` once under an :class:`OpCounter` and return its
    counts (outputs held until the memory reckoning is done)."""
    with OpCounter(args) as c:
        out = step(*args)
    return c.finish(out)
