"""Model multiplexing plane — weights as the paper's bitstreams (the
PyTorch port of ``repro.serving.model_registry``).

The paper's signature mechanism is partial reconfiguration: accelerator
bitstreams swap under a stable shell while tenants share the device.
Here the analog is *model weights*: one host serves several model
families as registered :class:`ModelBitstream`\\ s (weights + arch
descriptor, CRC-committed through ``core/reconfig.py``'s Bitfile path),
tenants bind to a model, and idle models hot-swap their weights to the
host tier under memory pressure — reconfiguration cost metered like the
paper's fig6b breakdown (``model_swap_in_s`` / ``model_swap_out_s``
histograms, a ``model_residency`` gauge, flight-recorder events).

Two layers:

* :class:`ModelRegistry` — the bitstream store. ``register()`` builds
  (or adopts) a model + params on an explicit device, fingerprints the
  weights (:func:`~repro_torch.core.reconfig.weights_fingerprint`, over
  the reference's layout, so equal weights give the reference's CRC)
  into a ``Bitfile`` whose ``slice_fingerprint`` commits to the
  parameter bytes, and tracks residency. ``params(name)`` is the
  serving-path entry: it swaps the model in if needed (CRC-verified — a
  corrupted host copy raises ``LegalityError`` instead of serving
  garbage), evicts least-recently-used idle models past the
  ``max_resident`` budget, and returns device params. Swaps go
  device→host→device through the ``TransferEngine``; a host copy keeps
  torch CPU tensors of the device dtypes (a bf16 leaf crosses as its
  int16 bits and is viewed back).
* :class:`MuxEngine` — per-model slot groups over ONE shared
  ``SegmentPool``: each family gets its own :class:`ServeEngine` (decode
  batches stay per family — the arrays differ per arch) while admission
  quotas, paging, the KV pool and the recurrent-state pool all draw from
  the same MMU segments, with per-family owner namespacing so rid spaces
  never collide into one MMU owner.
"""
from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch.core.mmu import SegmentPool
from repro_torch.core.reconfig import (Bitfile, LegalityError, ProgramLoader,
                                       weights_fingerprint)
from repro_torch.core.shell import TransferEngine
from repro_torch.kernels.common import cdiv
from repro_torch.obs import NULL_HUB
from repro_torch.serving.engine import ServeEngine

#: pool occupancy at which a mux step swaps idle families' weights out
PRESSURE_HWM = 0.9


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@dataclass
class ModelBitstream:
    """One registered model family: weights + arch descriptor, with a
    Bitfile whose CRC commits to the parameter bytes."""
    name: str
    arch: str
    cfg: object
    model: object
    bitfile: Bitfile
    device: torch.device
    params: object = None              # device tree while resident
    host_params: object = None         # host copy while swapped out
    resident: bool = False
    param_bytes: int = 0
    last_used: int = 0                 # registry clock, not wall time
    swap_outs: int = 0
    swap_ins: int = 0

    def snapshot(self) -> dict:
        return {
            "arch": self.arch,
            "resident": self.resident,
            "param_bytes": self.param_bytes,
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
            "crc": self.bitfile.crc,
        }


class ModelRegistry:
    """Weights-as-bitstreams store with residency + CRC verification."""

    def __init__(self, loader: Optional[ProgramLoader] = None,
                 max_resident: Optional[int] = None, obs=None):
        # sharing a VMM's loader routes crc_checks/crc_failures into
        # VMM.stats() — the registry is the serving-path caller of the
        # Bitfile CRC machinery
        self.loader = loader if loader is not None else ProgramLoader()
        self.max_resident = max_resident
        self.obs = obs if obs is not None else NULL_HUB
        self.transfer = TransferEngine(mode="vm_nocopy")
        self._models: Dict[str, ModelBitstream] = {}   # guarded-by: _lock
        self._clock = 0                                # guarded-by: _lock
        # one registry lock, not striped: swaps are rare and MUST
        # serialize (two serving threads racing params() with
        # max_resident=1 would otherwise interleave evict/swap-in and
        # corrupt residency). Entry fields are guarded by it too.
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    # Registration
    # ------------------------------------------------------------------
    def register(self, name: str, arch: Optional[str] = None, cfg=None,
                 model=None, params=None, seed: int = 0,
                 reduced: bool = True, device=None) -> ModelBitstream:
        """Register a model family as a bitstream. Builds cfg/model when
        not given; without ``params``, initialises them on ``device``
        from a ``torch.Generator`` seeded with ``seed`` and casts the
        product weights to the compute dtype. ``device`` None is the
        model's device (the card unless the model says otherwise).
        Fingerprints the weights; the new model is resident (evicting
        LRU idle models past ``max_resident``)."""
        arch = arch or name
        if cfg is None:
            from repro_torch.configs import get_config
            cfg = get_config(arch, reduced=reduced)
        if model is None:
            from repro_torch.models import Model
            model = Model(cfg, device=device)
        device = torch.device(device if device is not None
                              else getattr(model, "device", "cpu"))
        if params is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            params = model.init_compute_params(gen)
        fp = weights_fingerprint(params, cfg)
        pk = hashlib.sha256(repr((arch, cfg.n_layers, cfg.d_model,
                                  cfg.vocab, "serve")).encode()) \
            .hexdigest()[:16]
        bf = Bitfile(program_key=pk, topology_key="weights",
                     slice_fingerprint=fp, compiled=None,
                     abstract_args=())
        entry = ModelBitstream(
            name=name, arch=arch, cfg=cfg, model=model, bitfile=bf,
            device=device, params=params, resident=True,
            param_bytes=sum(t.numel() * t.element_size()
                            for t in _leaves(params)))
        with self._lock:
            assert name not in self._models, \
                f"model {name!r} already registered"
            self._models[name] = entry
            self._touch(entry)
            # CRC verified at load — the serving-path check the Bitfile
            # promises
            self._verify(entry, where="register")
            self._set_residency(entry)
            self._evict_over_budget(keep={name})
        return entry

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._models

    def __getitem__(self, name: str) -> ModelBitstream:
        with self._lock:
            return self._models[name]

    def names(self) -> List[str]:
        with self._lock:
            return list(self._models)

    # ------------------------------------------------------------------
    # Residency / the serving path
    # ------------------------------------------------------------------
    def params(self, name: str, keep=()):
        """Device params for ``name`` — THE serving-path entry. Swaps the
        model in when needed (CRC-verified), evicting LRU idle models not
        in ``keep`` past the residency budget."""
        with self._lock:
            entry = self._models[name]
            self._touch(entry)
            # the budget holds on every serve, not only on a miss:
            # shrinking max_resident (or a family going idle) moves idle
            # weights away
            self._evict_over_budget(keep=set(keep) | {name},
                                    incoming=0 if entry.resident else 1)
            if not entry.resident:
                self._swap_in_locked(entry)
            return entry.params

    def _touch(self, entry: ModelBitstream):  # holds: _lock
        self._clock += 1
        entry.last_used = self._clock

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        host = torch.from_numpy(self.transfer.d2h(t))
        return host.view(torch.bfloat16) if t.dtype == torch.bfloat16 \
            else host

    def _to_device(self, t: torch.Tensor, device) -> torch.Tensor:
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return self.transfer.h2d(raw.numpy(), device=device, dtype=t.dtype)

    def swap_out(self, name: str) -> float:
        """Hot-swap a model's weights to the host tier (the paper's
        reconfigure-away). Returns seconds spent."""
        with self._lock:
            return self._swap_out_locked(self._models[name])

    def _swap_out_locked(self, entry: ModelBitstream) -> float:  # holds: _lock
        name = entry.name
        if not entry.resident:
            return 0.0
        t0 = time.perf_counter()
        entry.host_params = _tree_map(self._to_host, entry.params)
        entry.params = None
        entry.resident = False
        entry.swap_outs += 1
        dt = time.perf_counter() - t0
        self._set_residency(entry)
        if self.obs.enabled:
            self.obs.observe("model_swap_out_s", dt, model=name)
            self.obs.count("model_swaps_total", model=name,
                           direction="out")
            self.obs.flight_record("registry", "model_swap_out",
                                   {"model": name, "s": dt,
                                    "bytes": entry.param_bytes})
        return dt

    def swap_in(self, name: str) -> float:
        """Reconfigure a swapped model back onto the device: CRC check
        first (metadata + weight bytes), then host→device. Returns
        seconds spent — the reconfiguration cost the paper meters."""
        with self._lock:
            return self._swap_in_locked(self._models[name])

    def _swap_in_locked(self, entry: ModelBitstream) -> float:  # holds: _lock
        name = entry.name
        if entry.resident:
            return 0.0
        t0 = time.perf_counter()
        self._verify(entry, where="swap_in")
        entry.params = _tree_map(
            lambda t: self._to_device(t, entry.device), entry.host_params)
        entry.host_params = None
        entry.resident = True
        entry.swap_ins += 1
        dt = time.perf_counter() - t0
        self._touch(entry)
        self._set_residency(entry)
        if self.obs.enabled:
            self.obs.observe("model_swap_in_s", dt, model=name)
            self.obs.count("model_swaps_total", model=name,
                           direction="in")
            self.obs.flight_record("registry", "model_swap_in",
                                   {"model": name, "s": dt,
                                    "bytes": entry.param_bytes})
        return dt

    def _evict_over_budget(self, keep=frozenset(),
                           incoming: int = 0):  # holds: _lock
        """Swap out LRU models (not in ``keep``) until the resident count
        plus ``incoming`` fits ``max_resident``."""
        if self.max_resident is None:
            return
        resident = [e for e in self._models.values() if e.resident]
        victims = sorted((e for e in resident if e.name not in keep),
                         key=lambda e: e.last_used)
        while len(resident) + incoming > self.max_resident and victims:
            v = victims.pop(0)
            self._swap_out_locked(v)
            resident.remove(v)

    # ------------------------------------------------------------------
    # Verification
    # ------------------------------------------------------------------
    def _verify(self, entry: ModelBitstream, where: str):  # holds: _lock
        """The bitstream legality gate: Bitfile metadata CRC, then the
        weights fingerprint — a flipped byte in the host copy makes the
        recomputed CRC diverge and the load is refused."""
        self.loader.verify_bitfile(entry.bitfile, owner=entry.name)
        src = entry.params if entry.resident else entry.host_params
        fp = weights_fingerprint(src, entry.cfg)
        self.loader.crc_checks += 1
        if self.obs.enabled:
            self.obs.count("model_crc_checks_total", model=entry.name)
        if fp != entry.bitfile.slice_fingerprint:
            self.loader.crc_failures += 1
            if self.loader.auditor:
                self.loader.auditor.record(
                    "bitfile_crc_fail", entry.name, {"where": where})
            if self.obs.enabled:
                self.obs.count("model_crc_failures_total",
                               model=entry.name)
                self.obs.flight_record("registry", "crc_failure",
                                       {"model": entry.name,
                                        "where": where,
                                        "expect":
                                        entry.bitfile.slice_fingerprint,
                                        "got": fp})
            raise LegalityError(
                f"model {entry.name!r} weights CRC mismatch at {where} "
                f"— refusing to load a corrupted bitstream")

    def _set_residency(self, entry: ModelBitstream):  # holds: _lock
        if self.obs.enabled:
            self.obs.set_gauge("model_residency",
                               1.0 if entry.resident else 0.0,
                               model=entry.name)

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    def residency(self) -> Dict[str, bool]:
        with self._lock:
            return {n: e.resident for n, e in self._models.items()}

    def stats(self) -> dict:
        with self._lock:
            return {
                "models": {n: e.snapshot()
                           for n, e in self._models.items()},
                "resident": sum(e.resident
                                for e in self._models.values()),
                "max_resident": self.max_resident,
                "crc_checks": self.loader.crc_checks,
                "crc_failures": self.loader.crc_failures,
            }


@dataclass
class SlotGroup:
    """One model family's serving lane inside the mux."""
    name: str
    engine: ServeEngine
    submitted: int = 0
    completed: int = 0
    tokens: int = 0
    active_s: float = 0.0              # wall time spent stepping this lane
    tenants: set = field(default_factory=set)


class MuxEngine:
    # concurrency: single-owner — one owning thread calls step()/
    # run_round()/bind(); cross-thread safety lives in the registry
    # lock, each engine's submission lock, and the shared pool lock
    """Per-model slot groups over one shared MMU pool.

    Decode steps batch per family (the arrays differ per arch);
    admission, paging quotas, the KV page pool and the paged recurrent
    state all draw from the same ``SegmentPool``, and idle families'
    *weights* hot-swap to the host tier under pressure via the
    registry."""

    def __init__(self, registry: ModelRegistry, models: List[str],
                 batch_per_model: int = 2, capacity: int = 64,
                 page_size: int = 8, chunk_tokens: int = 8,
                 pool_pages: Optional[int] = None, obs=None):
        self.registry = registry
        self.obs = obs if obs is not None else NULL_HUB
        # one segment unit serves every family: the largest page footprint
        entries = [registry[name] for name in models]
        seg = max(e.model.kv_page_bytes(page_size) for e in entries)
        if pool_pages is None:
            # default: every family's full working set fits (KV +
            # recurrent-state pages); a smaller pool_pages forces the swap
            # tier into action
            pool_pages = 0
            for e in entries:
                blocks = cdiv(capacity, page_size)
                sbytes = e.model.state_row_bytes()
                blocks += cdiv(sbytes, seg) if sbytes else 0
                pool_pages += batch_per_model * blocks
        self.pool = SegmentPool(total_bytes=pool_pages * seg,
                                backend="bitmap", segment_bytes=seg, obs=obs)
        self.groups: Dict[str, SlotGroup] = {}
        for e in entries:
            # every lane pages its recurrent state and may park slots:
            # the families share one pool that a burst can fill
            eng = ServeEngine(
                e.cfg, e.model, batch_per_model, capacity,
                page_size=page_size, pool=self.pool,
                chunk_tokens=chunk_tokens, swap=True, state_paging=True,
                obs=obs, obs_tenant=e.name, owner_prefix=f"{e.name}:")
            self.groups[e.name] = SlotGroup(name=e.name, engine=eng)
        self.bindings: Dict[str, str] = {}        # tenant → model

    # ------------------------------------------------------------------
    def bind(self, tenant: str, model: str):
        """Bind a tenant to a registered model — submissions from this
        tenant route to the model's slot group."""
        assert model in self.groups, f"model {model!r} not served"
        self.bindings[tenant] = model
        self.groups[model].tenants.add(tenant)

    def submit(self, prompt, model: Optional[str] = None,
               tenant: Optional[str] = None, **kw):
        """Submit to a family — by explicit ``model=`` or through a
        tenant binding. Returns ``(model, rid)``."""
        if model is None:
            assert tenant is not None and tenant in self.bindings, \
                f"tenant {tenant!r} is not bound to a model"
            model = self.bindings[tenant]
        g = self.groups[model]
        rid = g.engine.submit(prompt, **kw)
        g.submitted += 1
        return model, rid

    def has_work(self) -> bool:
        return any(g.engine.has_work() for g in self.groups.values())

    # ------------------------------------------------------------------
    def step(self) -> Dict[str, list]:
        """One mux sweep: every family with work steps once against its
        (swapped-in) weights; families left idle are reconfiguration
        candidates when the shared pool runs hot."""
        finished: Dict[str, list] = {}
        active = [g for g in self.groups.values() if g.engine.has_work()]
        if not active:
            return finished
        keep = {g.name for g in active}
        ms = self.pool.memory_stats()
        if ms["segments_in_use"] >= PRESSURE_HWM * max(
                ms["segments_total"], 1):
            # the paper's move: reconfigure idle bitstreams away while the
            # shared device is under pressure
            for name in self.registry.names():
                if name not in keep:
                    self.registry.swap_out(name)
        for g in active:
            params = self.registry.params(g.name, keep=keep)
            t0 = time.perf_counter()
            done = g.engine.step(params)
            g.active_s += time.perf_counter() - t0
            if done:
                g.completed += len(done)
                g.tokens += sum(len(r.out_tokens) for r in done)
                finished.setdefault(g.name, []).extend(done)
        return finished

    def run_round(self) -> Dict[str, list]:
        """Drain every family's queue."""
        finished: Dict[str, list] = {}
        while self.has_work():
            for name, done in self.step().items():
                finished.setdefault(name, []).extend(done)
        return finished

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "registry": self.registry.stats(),
            "pool": self.pool.memory_stats(),
            "groups": {
                n: {
                    "submitted": g.submitted,
                    "completed": g.completed,
                    "tokens": g.tokens,
                    "active_s": g.active_s,
                    "tenants": sorted(g.tenants),
                    "engine": dict(g.engine.stats.__dict__),
                }
                for n, g in self.groups.items()
            },
        }
