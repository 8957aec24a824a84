"""VMM — the hypervisor / resource broker (paper §III-B/C, §IV).

Policies (the paper's taxonomy, selectable per-VMM; dispatch itself
lives in :mod:`repro.core.scheduler`):

* ``fev``    — front-end virtualization: *every* data-plane operator is
  enqueued to a broker thread which round-robins across tenant queues
  (``BrokerPlane``). Maximal isolation+interposition; queueing overhead
  on the data plane.
* ``bev``    — back-end pass-through: the tenant owns its slice; ``run``
  invokes the loaded executable directly (``PassthroughPlane``, no op
  log); only load/unload is mediated.
* ``hybrid`` — the paper's design (default): control plane (open/close/
  alloc/free/reprogram/checkpoint) mediated + logged, data plane
  pass-through with op-log sampling.
* ``wfq``    — weighted fair queueing (``WFQPlane``): FEV-style
  mediation with per-tenant weights, priority classes, and op-rate
  limits for multi-tenant QoS.
* ``slo``    — deadline scheduling (``SLOPlane``): earliest-deadline-
  first within priority classes against per-tenant wait budgets, with
  an admission gate driven by the MMU paging view (memory-starved
  tenants are queued behind their class or denied).

Also implemented here: admission (floorplanner + MMU pool + completion
queue per tenant), the freeze/quiesce protocol around reconfiguration,
slice-failure handling via live migration, and the per-tenant device
memory quota. Straggler detection, op queueing, and scheduler statistics
are delegated to the selected ``DataPlane``.

This is the PyTorch port of ``repro.core.vmm``: the pod is a 2-D grid of
``torch.device`` (or any object with ``.devices``), a tenant's programs
and buffers live on its slice's single device, and each tenant's MMU
pool is sized from the free memory of its slice's cards (a card that
several grid entries name is shared among them) unless ``hbm_per_chip``
is given (which a CPU grid must give). The elastic
autoscaler is not ported yet (``autoscaler`` stays ``None``).
"""
from __future__ import annotations

import collections
import tempfile
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import mmu as mmu_mod
from repro_torch.core.interposition import OpLog, TenantCheckpointer
from repro_torch.core.isolation import IsolationAuditor
from repro_torch.core.reconfig import (Bitfile, CompileService,
                                       LegalityError, ProgramLoader)
# IRQ sources live with the scheduler; re-exported here for compatibility.
from repro_torch.core.scheduler import (IRQ_DEGRADED,  # noqa: F401
                                        IRQ_DONE, IRQ_RECONFIG, POLICIES,
                                        make_data_plane)
from repro_torch.core.shell import CompletionQueue, TransferEngine
from repro_torch.core.tenant import GuestBuffer, GuestDevice, Tenant
from repro_torch.core.vslice import Floorplanner
from repro_torch.obs import NULL_HUB, ObsHub


class AdmissionError(Exception):
    pass


def device_memory_bytes(device) -> int:
    """Free device memory of one card of the grid: what the card holds
    less what is already in use on it (weights, caches, other processes),
    as ``torch.cuda.mem_get_info`` reports it; a device without a known
    size raises."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no device memory size for {device}: pass "
                         "hbm_per_chip for a grid of non-CUDA devices")
    free, _total = torch.cuda.mem_get_info(device)
    return free


def _card(d):
    """The physical device a grid entry names (``cuda`` → the current
    CUDA device's index), so that entries naming one card compare equal."""
    d = torch.device(d)
    if d.index is None and d.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return d


class VMM:
    def __init__(self, device_grid, policy: str = "hybrid",
                 mmu_backend: str = "bitmap",
                 transfer_mode: str = "vm_copy",
                 hbm_per_chip: Optional[int] = None,
                 segment_bytes: int = mmu_mod.SEGMENT_BYTES,
                 ckpt_root: Optional[str] = None,
                 straggler_factor: float = 4.0,
                 oplog_sampling: float = 1.0,
                 scheduler_opts: Optional[dict] = None,
                 obs: Optional[ObsHub] = None):
        """``device_grid``: a 2-D array of ``torch.device`` (or an object
        whose ``.devices`` is one). ``hbm_per_chip`` is the memory of
        one grid entry; ``None`` sizes each tenant's pool from the free
        memory of its cards at admission, each card divided among the
        grid entries that name it. ``ckpt_root=None`` keeps tenant
        checkpoints in a fresh temporary directory."""
        assert policy in POLICIES
        if device_grid is None:
            raise ValueError("VMM needs a device grid (torch devices)")
        self.policy = policy
        self.mmu_backend = mmu_backend
        self.hbm_per_chip = hbm_per_chip
        self.segment_bytes = segment_bytes
        # Telemetry plane (repro.obs): every subsystem below reports
        # into this hub's registry/tracer/flight recorder. Disabled by
        # default — pass ObsHub(enabled=True) (or --metrics in
        # launch/serve.py) to turn the lights on.
        self.obs = obs if obs is not None else NULL_HUB
        self.floorplanner = Floorplanner(device_grid)
        if hbm_per_chip is None:
            # grid entries per physical card: the entries of a 1×3 view
            # of one card share that card's memory three ways
            self._views = collections.Counter(
                _card(d) for d in self.floorplanner.grid.flatten())
            for d in self._views:
                device_memory_bytes(d)          # raises on a CPU grid
        self.auditor = IsolationAuditor()
        self.oplog = OpLog(sample_data_plane=(
            oplog_sampling if policy == "hybrid" else 1.0))
        self.transfer = TransferEngine(mode=transfer_mode, obs=self.obs)
        self.compiler = CompileService()
        self.loader = ProgramLoader(auditor=self.auditor)
        self.checkpointer = TenantCheckpointer(
            ckpt_root if ckpt_root is not None
            else tempfile.mkdtemp(prefix="vmm_ckpt_"))
        self.tenants: Dict[str, Tenant] = {}   # guarded-by: _lock
        self._lock = threading.Lock()
        # Data-plane dispatch is fully delegated to the scheduler subsystem.
        self.plane = make_data_plane(policy, oplog=self.oplog,
                                     straggler_factor=straggler_factor,
                                     obs=self.obs,
                                     **(scheduler_opts or {}))
        # The elastic autoscaler hook (not ported yet: stays None).
        self.autoscaler = None
        # Legacy stats() trees re-registered as providers: the registry
        # snapshot exposes the same data the six ad-hoc dicts used to,
        # under one schema (obs.snapshot()["metrics"]["providers"]).
        reg = self.obs.registry
        reg.register_provider("scheduler", self.plane.stats)
        reg.register_provider("transfer",
                              lambda: dict(self.transfer.stats.__dict__))
        reg.register_provider("ops", self.oplog.op_latency_stats)
        reg.register_provider("memory", self._memory_stats)
        reg.register_provider(
            "floorplan",
            lambda: {"util": self.floorplanner.utilization(),
                     "fragmentation": self.floorplanner.fragmentation()})
        reg.register_provider(
            "autoscaler",
            lambda: (self.autoscaler.stats()
                     if self.autoscaler is not None else None))

    # Straggler EWMA state lives in the plane; keep the historical
    # ``vmm.straggler_factor`` knob working (tests tune it post-init).
    @property
    def straggler_factor(self) -> float:
        return self.plane.straggler_factor

    @straggler_factor.setter
    def straggler_factor(self, v: float):
        self.plane.straggler_factor = v

    def _make_pool(self, vs) -> mmu_mod.SegmentPool:
        if self.hbm_per_chip is not None:
            total = vs.n_devices * self.hbm_per_chip
        else:
            total = sum(device_memory_bytes(_card(d)) // self._views[_card(d)]
                        for d in vs.devices.flatten())
        return mmu_mod.SegmentPool(
            total_bytes=total, backend=self.mmu_backend,
            segment_bytes=self.segment_bytes, auditor=self.auditor,
            obs=self.obs)

    # ==================================================================
    # Admission / teardown
    # ==================================================================
    def create_vm(self, name: str, slice_shape: Tuple[int, int],
                  hbm_quota_bytes: Optional[int] = None,
                  sched_weight: float = 1.0,
                  sched_priority: Optional[int] = None,
                  sched_rate_limit_ops: float = 0.0,
                  sched_slo_wait_s: Optional[float] = None,
                  model: Optional[str] = None) -> Tenant:
        rec = self.oplog.begin(name, "admit", {"shape": slice_shape})
        vs = self.floorplanner.allocate(slice_shape)
        if vs is None:
            self.oplog.end(rec)
            raise AdmissionError(
                f"no {slice_shape} slice available "
                f"(util={self.floorplanner.utilization():.0%})")
        pool = self._make_pool(vs)
        t = Tenant(name=name, vslice=vs, pool=pool,
                   cq=CompletionQueue())
        t.device = GuestDevice(self, t)
        if hbm_quota_bytes is not None:
            pool.set_quota(name, hbm_quota_bytes)
        sched_kw = {"weight": sched_weight,
                    "rate_limit_ops": sched_rate_limit_ops}
        if sched_priority is not None:
            sched_kw["priority"] = sched_priority
        if sched_slo_wait_s is not None:
            sched_kw["slo_wait_s"] = sched_slo_wait_s
        if model is not None:
            # multiplexing plane: the tenant is bound to a registered
            # model family at admission time
            sched_kw["model"] = model
        with self._lock:
            self.tenants[name] = t
        self.plane.register(t, **sched_kw)
        if self.obs.enabled:
            self.obs.count("vmm_admissions_total", tenant=name)
            self.obs.flight_record(name, "admit",
                                   {"shape": list(slice_shape)})
        self.oplog.end(rec)
        return t

    def destroy_vm(self, name: str):
        rec = self.oplog.begin(name, "evict", {})
        with self._lock:
            t = self.tenants.pop(name)
        self.plane.unregister(name)
        self.loader.unload(t.vslice)
        self.floorplanner.free(t.vslice.slice_id)
        if self.obs.enabled:
            self.obs.count("vmm_evictions_total", tenant=name)
            self.obs.flight.forget(name)
        self.oplog.end(rec)

    # ==================================================================
    # Mediated operators (control plane — always through the VMM)
    # ==================================================================
    def op_open(self, t: Tenant):
        rec = self.oplog.begin(t.name, "open", {})
        self.oplog.end(rec)

    def op_close(self, t: Tenant):
        rec = self.oplog.begin(t.name, "close", {})
        self.oplog.end(rec)

    def op_get_info(self, t: Tenant) -> dict:
        rec = self.oplog.begin(t.name, "get_info", {})
        info = {
            "slice_shape": t.vslice.spec.shape,
            "n_devices": t.vslice.n_devices,
            "axis_names": t.vslice.axis_names,
            "hbm_bytes": t.pool.n_segments * t.pool.segment_bytes,
            "hbm_free_bytes":
                t.pool.free_segments() * t.pool.segment_bytes,
            "policy": self.policy,
            "healthy": t.vslice.healthy,
        }
        self.oplog.end(rec)
        return info

    def op_set_irq(self, t: Tenant, handler):
        rec = self.oplog.begin(t.name, "set_irq", {})
        t.cq.set_irq(IRQ_DONE, handler)
        self.oplog.end(rec)

    def op_set_status(self, t: Tenant, handler):
        rec = self.oplog.begin(t.name, "set_status", {})
        t.cq.set_irq(IRQ_RECONFIG, handler)
        t.cq.set_irq(IRQ_DEGRADED, handler)
        self.oplog.end(rec)

    def op_alloc(self, t: Tenant, nbytes: int, shape, dtype) -> int:
        rec = self.oplog.begin(t.name, "alloc", {"nbytes": nbytes})
        try:
            a = t.pool.alloc(nbytes, owner=t.name)
        finally:
            self.oplog.end(rec)
        t.buffers[a.handle] = GuestBuffer(a.handle, nbytes, tuple(shape),
                                          str(dtype))
        return a.handle

    def op_free(self, t: Tenant, handle: int):
        rec = self.oplog.begin(t.name, "free", {"handle": handle})
        try:
            t.pool.free(handle, owner=t.name)
            t.buffers.pop(handle, None)
        finally:
            self.oplog.end(rec)

    def op_reprogram(self, t: Tenant, request):
        """Compile (or take a warm cache hit), legality-check, freeze, load.

        Passing a raw ``Bitfile`` (rather than a ProgramRequest) skips the
        VMM's re-binding step and exercises the cross-slice attack path —
        exactly the paper's 'VM0 flashes PRR1' scenario."""
        rec = self.oplog.begin(t.name, "reprogram", {})
        try:
            if isinstance(request, Bitfile):
                bitfile = request           # unbound — validate as-is
            else:
                bitfile = self.compiler.compile(request, t.vslice)
                t.program_request = request
            prog = self.loader.load(bitfile, t.vslice, t.quiesce,
                                    owner=t.name)
            t.program = prog
            t.cq.raise_event(IRQ_RECONFIG, "reconfigured",
                             {"program": bitfile.program_key,
                              "compile_s": bitfile.compile_seconds})
            return prog
        finally:
            self.oplog.end(rec)

    # ==================================================================
    # Data plane (delegated to the scheduler subsystem — see scheduler.py)
    # ==================================================================
    def _write_work(self, t: Tenant, handle: int, data: np.ndarray):
        def work():
            t.pool.translate(handle, owner=t.name)   # ownership + bounds
            buf = t.buffers[handle]
            if data.nbytes > buf.nbytes:
                raise mmu_mod.IsolationViolation(
                    f"write of {data.nbytes} B exceeds buffer "
                    f"{buf.nbytes} B")
            buf.device_array = self.transfer.h2d(data,
                                                 device=t.vslice.device)
            return handle
        return work

    def _read_work(self, t: Tenant, handle: int):
        def work():
            t.pool.translate(handle, owner=t.name)
            buf = t.buffers[handle]
            if buf.device_array is None:
                raise mmu_mod.MMUError("buffer not written")
            return self.transfer.d2h(buf.device_array)
        return work

    def _run_work(self, t: Tenant, args, kw):
        def work():
            out = t.program(*args, **kw)
            t.cq.raise_event(IRQ_DONE, "run_done", {"step": t.step})
            t.step += 1
            return out
        return work

    def op_write(self, t: Tenant, handle: int, data: np.ndarray):
        return self.plane.execute(t, "write",
                                  self._write_work(t, handle, data),
                                  {"handle": handle, "nbytes": data.nbytes})

    def op_write_async(self, t: Tenant, handle: int, data: np.ndarray):
        return self.plane.submit(t, "write",
                                 self._write_work(t, handle, data),
                                 {"handle": handle, "nbytes": data.nbytes})

    def op_read(self, t: Tenant, handle: int) -> np.ndarray:
        return self.plane.execute(t, "read", self._read_work(t, handle),
                                  {"handle": handle})

    def op_read_async(self, t: Tenant, handle: int):
        return self.plane.submit(t, "read", self._read_work(t, handle),
                                 {"handle": handle})

    def op_run(self, t: Tenant, *args, **kw):
        if t.program is None:
            raise LegalityError("no program loaded — reprogram first")
        return self.plane.execute(t, "run", self._run_work(t, args, kw),
                                  {"step": t.step})

    def op_run_async(self, t: Tenant, *args, **kw):
        """Async data-plane submission: returns a Future for the run."""
        if t.program is None:
            raise LegalityError("no program loaded — reprogram first")
        return self.plane.submit(t, "run", self._run_work(t, args, kw),
                                 {"step": t.step})

    # ==================================================================
    # Fault tolerance: checkpoint / restore / migrate (interposition)
    # ==================================================================
    def checkpoint_tenant(self, t: Tenant) -> str:
        rec = self.oplog.begin(t.name, "checkpoint", {"step": t.step})
        meta = {"step": t.step,
                "program": (t.program_request.__dict__
                            if t.program_request else None)}
        path = self.checkpointer.snapshot(t.name, t.step, t.state, meta)
        self.oplog.end(rec)
        return path

    def restore_tenant(self, t: Tenant, template, device=None):
        """Restore the tenant's newest checkpoint onto ``device`` (default:
        its slice's device)."""
        rec = self.oplog.begin(t.name, "restore", {})
        step, state, meta = self.checkpointer.restore(
            t.name, template,
            device if device is not None else t.vslice.device)
        t.state = state
        t.step = step
        self.oplog.end(rec)
        return meta

    def mark_slice_failed(self, slice_id: int):
        with self._lock:
            tenants = list(self.tenants.values())
        for t in tenants:
            if t.vslice.slice_id == slice_id:
                t.vslice.healthy = False
                # record BEFORE raising: slice_failed is a flight-
                # recorder trigger, so the auto-dump taken here already
                # contains the failure event itself
                if self.obs.enabled:
                    self.obs.count("vmm_slice_failures_total",
                                   tenant=t.name)
                    self.obs.flight_record(t.name, "slice_failed",
                                           {"slice": slice_id})
                t.cq.raise_event(IRQ_DEGRADED, "slice_failed",
                                 {"slice": slice_id})

    def migrate_tenant(self, t: Tenant, new_shape=None,
                       state_template=None) -> Tenant:
        """Live migration: checkpoint → re-floorplan → re-bind program →
        restore onto the new slice's device."""
        rec = self.oplog.begin(t.name, "migrate",
                               {"from": t.vslice.spec.shape,
                                "to": new_shape or t.vslice.spec.shape})
        if t.state:
            self.checkpoint_tenant(t)
        shape = new_shape or t.vslice.spec.shape
        old_slice = t.vslice
        self.loader.unload(old_slice)
        self.floorplanner.free(old_slice.slice_id)
        vs = self.floorplanner.allocate(shape)
        if vs is None:
            # roll back: re-claim the old rectangle
            back = self.floorplanner.allocate(old_slice.spec.shape)
            if back is None:
                self.oplog.end(rec)
                raise AdmissionError("migration target unavailable and "
                                     "rollback failed")
            t.vslice = back
            self.oplog.end(rec)
            raise AdmissionError(f"no {shape} slice for migration")
        t.vslice = vs
        pool = self._make_pool(vs)
        q_segs = t.pool.quota_segs_of(t.name)
        if q_segs is not None:
            pool.set_quota_segs(t.name, q_segs)
        t.pool = pool
        t.buffers.clear()
        if t.program_request is not None:
            bf = self.compiler.compile(t.program_request, vs)
            t.program = self.loader.load(bf, vs, t.quiesce, owner=t.name)
        if t.state and state_template is not None:
            self.restore_tenant(t, state_template)
        self.oplog.end(rec)
        return t

    # ==================================================================
    def shutdown(self):
        self.plane.shutdown()

    def _memory_stats(self) -> dict:
        with self._lock:
            tenants = dict(self.tenants)
        return {name: t.pool.memory_stats() for name, t in tenants.items()}

    def stats(self) -> dict:
        memory = self._memory_stats()
        return {
            "tenants": len(memory),
            # per-tenant MMU paging view (pages in use, fragmentation,
            # quota denials) — the SLO scheduler follow-up reads this
            "memory": memory,
            "floorplan_util": self.floorplanner.utilization(),
            "fragmentation": self.floorplanner.fragmentation(),
            "compile_hits": self.compiler.hits,
            "compile_misses": self.compiler.misses,
            "reconfigs": self.loader.reconfigs,
            "crc_checks": self.loader.crc_checks,
            "crc_failures": self.loader.crc_failures,
            "violations": self.auditor.summary(),
            "transfer": self.transfer.stats.__dict__,
            "oplog_records": len(self.oplog.records),
            # per-op latency rollup (p50/p95/mean) from the OpRecord
            # perf_counter stamps — fig6b reads this instead of private
            # timers
            "ops": self.oplog.op_latency_stats(),
            "scheduler": self.plane.stats(),
            # elastic-resize action log (the autoscaler is not ported)
            "autoscaler": (self.autoscaler.stats()
                           if self.autoscaler is not None else None),
            # the unified telemetry tree (metrics/traces/flight); the
            # providers view inside it mirrors the legacy keys above
            "obs": self.obs.snapshot(providers=False),
        }
