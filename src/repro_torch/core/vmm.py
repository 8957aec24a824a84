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

This is the PyTorch port of ``repro.core.vmm``. The pod is one of:

* **A ``DeviceMesh``** of ranks (``launch.mesh.make_local_mesh((2,
  4))``), as the reference's VMM takes a ``Mesh``. PyTorch drives one
  card a process, so every rank runs the same script and this same
  control plane, making the same calls in the same order: every rank
  holds the same floorplan, MMU pools, oplog and program cache. A
  tenant's slice has a mesh over its rectangle of ranks; its programs
  are the mesh step builders' and its data DTensors on that mesh
  (``write(..., sharding=(mesh, spec))``). A rank outside a tenant's
  slice records each of the tenant's ops in the oplog and scheduler as
  the members do, but runs no step, moves no data and gets None back.
  The pools are sized from one table of every rank's free card memory,
  gathered once here (``all_gather_object``), so every rank sizes every
  pool alike; a CPU pod must give ``hbm_per_chip``. These control-plane
  collectives run over a group of their own (``control_group``). A
  checkpoint of a tenant waits for the tenant's submitted ops to end on
  every rank, is gathered inside its slice's mesh, written once by the
  slice's first rank, and followed by a barrier over the world before
  any rank restores it, so a migration or grow may restore it on other
  ranks (``migrate_tenant(..., shardings_fn=)``).
* **A 2-D grid of ``torch.device``** (or any object with ``.devices``),
  in one process: a tenant's programs and buffers live on its slice's
  single device, and each tenant's MMU pool is sized from the free
  memory of its slice's cards (a card that several grid entries name is
  shared among them) unless ``hbm_per_chip`` is given (which a CPU grid
  must give). A slice of k entries of a one-card view runs on that card
  with k shares of its memory, so migration and the elastic grow and
  shrink (``repro_torch.core.elastic``) work on one card.

The ``autoscaler`` hook is set by
:class:`repro_torch.core.autoscaler.Autoscaler` when one attaches.
"""
from __future__ import annotations

import collections
import tempfile
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpointing import checkpoint as ckpt_mod
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
from repro_torch.core.vslice import Floorplanner, card
from repro_torch.obs import NULL_HUB, ObsHub
from repro_torch.obs import spans as obs_spans


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


def rank_memory_table(pod_mesh, group) -> list:
    """Every rank's free card memory, indexed by rank: gathered once over
    ``group``, a group over every rank (every rank calls this), so every
    rank sizes every pool from the same table."""
    import torch.distributed as dist
    if pod_mesh.device_type != "cuda":
        raise ValueError(f"no device memory size for a pod of "
                         f"{pod_mesh.device_type} ranks: pass hbm_per_chip")
    from repro_torch.models.model import mesh_device
    table = [None] * dist.get_world_size()
    dist.all_gather_object(table,
                           device_memory_bytes(mesh_device(pod_mesh)),
                           group=group)
    return table


def world_barrier(pod_mesh, group=None):
    """A barrier over every rank (``group``, default the world's; on the
    NCCL backend, on this rank's card)."""
    import torch.distributed as dist
    if pod_mesh.device_type == "cuda":
        dist.barrier(group=group,
                     device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


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
        """``device_grid``: a pod ``DeviceMesh`` (every rank of the world
        constructs the VMM), or a 2-D array of ``torch.device`` (or an
        object whose ``.devices`` is one). ``hbm_per_chip`` is the memory
        of one grid entry; ``None`` sizes each tenant's pool from the
        free memory of its ranks' cards (gathered once, here) or, on a
        device grid, of its cards at admission, each card divided among
        the grid entries that name it. ``ckpt_root=None`` keeps tenant
        checkpoints in a fresh temporary directory (on a pod mesh, one
        that rank 0 makes and every rank of the host uses; ranks on
        several hosts need a ``ckpt_root`` they all see)."""
        assert policy in POLICIES
        if device_grid is None:
            raise ValueError("VMM needs a pod mesh or a device grid")
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
        #: the pod's DeviceMesh (None on a device grid)
        self.pod_mesh = self.floorplanner.pod_mesh
        #: on a pod mesh, a group over every rank for the control plane's
        #: own collectives (the pool table, agreements, the checkpoint
        #: barrier): never one a slice's steps use, as the world's group
        #: is when a slice's axis spans the world
        self.control_group = None
        if self.pod_mesh is not None:
            import torch.distributed as dist
            self.control_group = dist.new_group()
        if hbm_per_chip is None and self.pod_mesh is not None:
            self._rank_bytes = rank_memory_table(self.pod_mesh,
                                                 self.control_group)
        elif hbm_per_chip is None:
            # grid entries per physical card: the entries of a 1×3 view
            # of one card share that card's memory three ways
            self._views = collections.Counter(
                card(d) for d in self.floorplanner.grid.flatten())
            for d in self._views:
                device_memory_bytes(d)          # raises on a CPU grid
        self.auditor = IsolationAuditor()
        self.oplog = OpLog(sample_data_plane=(
            oplog_sampling if policy == "hybrid" else 1.0))
        self.transfer = TransferEngine(mode=transfer_mode, obs=self.obs)
        self.compiler = CompileService()
        self.loader = ProgramLoader(auditor=self.auditor)
        if ckpt_root is None and self.pod_mesh is not None:
            from repro_torch.launch.mesh import shared_tempdir
            # one for every rank
            ckpt_root = shared_tempdir("vmm_ckpt_", self.control_group)
        self.checkpointer = TenantCheckpointer(
            ckpt_root if ckpt_root is not None
            else tempfile.mkdtemp(prefix="vmm_ckpt_"))
        self.tenants: Dict[str, Tenant] = {}   # guarded-by: _lock
        self._lock = threading.Lock()
        scheduler_opts = dict(scheduler_opts or {})
        if policy == "slo" and self.pod_mesh is not None \
                and self.pod_mesh.size() > 1:
            # the admission gate decides from the pool, which every rank
            # holds alike, at each submission: no cached reading and no
            # deny window timed on one rank's clock (a denial on one rank
            # of a slice alone would leave the others in a collective)
            scheduler_opts.update(pressure_refresh_s=0.0, deny_hold_s=0.0)
        # Data-plane dispatch is fully delegated to the scheduler subsystem.
        self.plane = make_data_plane(policy, oplog=self.oplog,
                                     straggler_factor=straggler_factor,
                                     obs=self.obs, **scheduler_opts)
        # The elastic autoscaler hook: set by Autoscaler when one attaches.
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
        elif self.pod_mesh is not None:
            total = sum(self._rank_bytes[r] for r in vs.ranks)
        else:
            total = sum(device_memory_bytes(card(d)) // self._views[card(d)]
                        for d in vs.devices.flatten())
        return mmu_mod.SegmentPool(
            total_bytes=total, backend=self.mmu_backend,
            segment_bytes=self.segment_bytes, auditor=self.auditor,
            obs=self.obs)

    def agree(self, value, src: int):
        """``value`` as rank ``src`` holds it, on every rank of a pod mesh
        (every rank calls this; broadcast over the control group); on a
        device grid, ``value``."""
        if self.pod_mesh is None:
            return value
        import torch.distributed as dist
        box = [value]
        dist.broadcast_object_list(box, src=src, group=self.control_group)
        return box[0]

    def _drain(self, t: Tenant):
        """On a pod mesh, wait until every op of ``t`` submitted so far has
        run, so a gather over its slice's mesh that follows is issued after
        the ops' collectives on every rank (its ops run on a plane's worker
        thread, the gather on the caller's)."""
        if self.pod_mesh is None:
            return
        self.plane.drain(t)
        with t.quiesce():
            pass

    def card_bytes(self, device) -> int:
        """What the grid entries naming ``device``'s card divide among
        them: the card's free memory now, or ``hbm_per_chip`` for each
        entry naming it. A pool made now from k of the card's n entries
        holds k/n of it."""
        c = card(device)
        if self.hbm_per_chip is None:
            return device_memory_bytes(c)
        return self.hbm_per_chip * sum(
            1 for d in self.floorplanner.grid.flatten() if card(d) == c)

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
    # A rank outside the tenant's slice (pod mesh) runs each op's
    # bookkeeping (translation checks, IRQs, the step count) and nothing
    # of its data path: no transfer, no step, None back. Every op of one
    # tenant runs one at a time, in submission order, on every plane
    # (passthrough: the caller's thread; queued: one worker, FIFO a
    # tenant), so a slice's collectives are issued in one order on all
    # of its ranks.
    def _write_work(self, t: Tenant, handle: int, data: np.ndarray,
                    sharding):
        def work():
            t.pool.translate(handle, owner=t.name)   # ownership + bounds
            buf = t.buffers[handle]
            if data.nbytes > buf.nbytes:
                raise mmu_mod.IsolationViolation(
                    f"write of {data.nbytes} B exceeds buffer "
                    f"{buf.nbytes} B")
            if sharding is not None:
                if sharding[0] is not t.vslice.mesh:
                    raise mmu_mod.IsolationViolation(
                        "a write placed on a mesh other than the "
                        "tenant's slice's")
                buf.device_array = self.transfer.h2d(data,
                                                     sharding=sharding)
            elif t.vslice.member:
                buf.device_array = self.transfer.h2d(
                    data, device=t.vslice.device)
            return handle
        return work

    def _read_work(self, t: Tenant, handle: int):
        def work():
            t.pool.translate(handle, owner=t.name)
            buf = t.buffers[handle]
            if not t.vslice.member:
                return None
            if buf.device_array is None:
                raise mmu_mod.MMUError("buffer not written")
            return self.transfer.d2h(buf.device_array)
        return work

    def _run_work(self, t: Tenant, args, kw):
        def work():
            tl = obs_spans.ACTIVE
            sid = tl.open("tenant.program", t.step) if tl is not None \
                else 0
            out = t.program(*args, **kw) if t.vslice.member else None
            if sid:
                tl.close(sid)
                sid = tl.open("vmm.irq", t.step)
            t.cq.raise_event(IRQ_DONE, "run_done", {"step": t.step})
            if sid:
                tl.close(sid)
            t.step += 1
            return out
        return work

    def op_write(self, t: Tenant, handle: int, data: np.ndarray,
                 sharding=None):
        """``sharding``: ``(mesh, spec)`` over the tenant's slice's mesh
        (the reference's ``NamedSharding``); without it the data goes to
        the slice's one device."""
        return self.plane.execute(t, "write",
                                  self._write_work(t, handle, data, sharding),
                                  {"handle": handle, "nbytes": data.nbytes})

    def op_write_async(self, t: Tenant, handle: int, data: np.ndarray,
                       sharding=None):
        return self.plane.submit(t, "write",
                                 self._write_work(t, handle, data, sharding),
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
        """Snapshot the tenant's state. On a pod mesh every rank first
        waits for the tenant's submitted ops to end; the slice's ranks
        gather the state inside the slice's mesh and its first rank
        writes it; then every rank of the world meets at a barrier, so no
        rank restores before the commit."""
        self._drain(t)
        rec = self.oplog.begin(t.name, "checkpoint", {"step": t.step})
        meta = {"step": t.step,
                "program": (t.program_request.__dict__
                            if t.program_request else None)}
        if t.vslice.member:
            if t.vslice.mesh is not None and t.vslice.n_devices > 1 and \
                    not ckpt_mod.all_dtensors(t.state):
                # each member would write its own copy of a plain leaf
                raise ValueError("a slice over several ranks holds its "
                                 "state as DTensors over its mesh")
            path = self.checkpointer.snapshot(t.name, t.step, t.state,
                                              meta)
        else:
            path = self.checkpointer.step_path(t.name, t.step)
        if self.pod_mesh is not None:
            world_barrier(self.pod_mesh, self.control_group)
        self.oplog.end(rec)
        return path

    def restore_tenant(self, t: Tenant, template, shardings_tree=None,
                       device=None):
        """Restore the tenant's newest checkpoint: with ``shardings_tree``
        (``(mesh, spec)`` at each leaf of ``template``) as DTensors over
        those meshes, else onto ``device`` (default: its slice's device;
        a slice over several ranks has none, so its state needs
        ``shardings_tree``). A rank outside the slice reads the step and
        meta only and holds None at each leaf."""
        rec = self.oplog.begin(t.name, "restore", {})
        try:
            if shardings_tree is None and device is None \
                    and t.vslice.member:
                device = t.vslice.device    # raises over several ranks
            if shardings_tree is None and not t.vslice.member:
                step, meta = self.checkpointer.manifest(t.name)
                state = ckpt_mod.tree_map(lambda _: None, template)
            else:
                step, state, meta = self.checkpointer.restore(
                    t.name, template, shardings_tree, device)
        finally:
            self.oplog.end(rec)
        t.state = state
        t.step = step
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
                       state_template=None, shardings_fn=None) -> Tenant:
        """Live migration: checkpoint → re-floorplan → re-bind program →
        restore (re-sharded). Also the elastic grow/shrink primitive.
        ``shardings_fn(vs)`` gives the tree of ``(mesh, spec)`` that
        places the restored state over the new slice's mesh (a pod mesh
        only: a device grid has no mesh, so there it raises ValueError);
        without it the state is restored onto the new slice's device."""
        if shardings_fn is not None and self.pod_mesh is None:
            raise ValueError(
                "shardings_fn: this VMM's pod is a device grid, which has "
                "no mesh to place a state on (carve slices from a pod "
                "DeviceMesh)")
        self._drain(t)
        rec = self.oplog.begin(t.name, "migrate",
                               {"from": t.vslice.spec.shape,
                                "to": new_shape or t.vslice.spec.shape})
        # the slice's first rank holds the state: its answer is every
        # rank's, so all of them checkpoint (and meet at its barrier) or
        # none
        has_state = self.agree(bool(t.state), t.vslice.ranks[0]) \
            if self.pod_mesh is not None else bool(t.state)
        if has_state:
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
        if has_state and state_template is not None:
            shardings_tree = shardings_fn(vs) if shardings_fn else None
            self.restore_tenant(t, state_template, shardings_tree)
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
            "oplog_records": self.oplog.n_records(),
            # per-op latency rollup (p50/p95/mean) from the OpRecord
            # perf_counter stamps — fig6b reads this instead of private
            # timers
            "ops": self.oplog.op_latency_stats(),
            "scheduler": self.plane.stats(),
            # elastic-resize action log (None until an Autoscaler attaches)
            "autoscaler": (self.autoscaler.stats()
                           if self.autoscaler is not None else None),
            # the unified telemetry tree (metrics/traces/flight); the
            # providers view inside it mirrors the legacy keys above
            "obs": self.obs.snapshot(providers=False),
        }
