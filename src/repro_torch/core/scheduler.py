"""Data-plane scheduler subsystem — pluggable dispatch policies for the VMM.

The paper's taxonomy (§III-B) distinguishes *where* the virtualization
layer interposes on the data plane; this module turns that decision into
a pluggable ``DataPlane`` object the VMM delegates every data-plane
operator (``read``/``write``/``run``) to:

* ``PassthroughPlane`` — back-end virtualization (``bev``) and the
  paper's ``hybrid`` design: the caller's thread invokes the operator
  directly. ``bev`` skips the op log entirely; ``hybrid`` records ops
  through the (sampled) ``OpLog``. No queueing, no cross-tenant
  scheduling — isolation relies on the slice boundary.
* ``BrokerPlane`` — front-end virtualization (``fev``): every op is
  enqueued to a single broker thread that round-robins one op per
  tenant queue per sweep. Maximal interposition; serialization cost.
* ``WFQPlane`` — weighted fair queueing on top of the FEV broker
  model: per-tenant weights drive a virtual-time scheduler, priority
  classes preempt (at op granularity), and optional per-tenant token
  buckets cap offered op rate. This is the scheduler the multi-tenant
  QoS roadmap items build on (cf. Mbongue et al.'s shared-FPGA
  scheduling gap and SYNERGY's runtime-managed scheduling).
* ``SLOPlane`` — deadline scheduling: earliest-deadline-first within
  priority classes, where a job's deadline is its submit time plus the
  tenant's SLO wait budget (``slo_wait_s``, a p95 wait target). Weights
  express *shares*; deadlines express *latency* — under overload WFQ
  still interleaves backlogged tenants proportionally, while EDF serves
  the deadline-urgent op first. The plane also runs an **admission
  gate** on the MMU paging view (``SegmentPool.memory_stats()``): a
  tenant whose pool is under sustained memory pressure (high occupancy,
  fresh per-owner quota denials) has new submissions queued behind
  other classes or denied outright (``AdmissionPressure``) — the
  memory signal, not just op-rate token buckets, throttles admission.

All planes share one service path (:meth:`DataPlane._run_job`): op-log
begin/end, the tenant quiesce protocol (``enter_op``/``exit_op``),
straggler detection via a per-(tenant, op) EWMA deadline, and per-tenant
scheduler statistics (queue depth, wait/service time, credit balance).
Queued planes additionally raise ``IRQ_DEGRADED`` (``queue_buildup``)
on a tenant's completion queue when its backlog stays above the high
watermark for a sustained window.

Submission is available in two forms on every plane:

* ``execute(tenant, op, work, detail)`` — blocking; returns the op's
  value or re-raises its exception (the historical ``VMM._data_op``
  contract).
* ``submit(tenant, op, work, detail) -> concurrent.futures.Future`` —
  asynchronous; errors propagate through ``future.exception()`` /
  ``future.result()``. The continuous-batching serve engine and the
  fairness benchmark drive this path.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from repro_torch.analysis.lock_watchdog import note_callback
from repro_torch.core.mmu import MMUError
from repro_torch.obs import NULL_HUB
from repro_torch.obs import spans as obs_spans

# IRQ sources (shared with the VMM; re-exported from repro.core.vmm for
# backward compatibility).
IRQ_DONE = 0
IRQ_RECONFIG = 1
IRQ_DEGRADED = 2

# Priority classes: lower value = served first.
PRIORITY_HIGH = 0
PRIORITY_NORMAL = 1
PRIORITY_LOW = 2


class AdmissionPressure(MMUError):
    """Submission rejected by the SLO admission gate: the tenant's MMU
    pool is under memory pressure (occupancy past the deny watermark or
    fresh quota denials while pressured). Back off and resubmit.

    Subclasses ``MMUError``: the denial is a memory signal, so callers
    that already handle MMU exhaustion (e.g. the serve engine) degrade
    the same way instead of crashing on an unknown exception type."""


@dataclass
class TenantSchedStats:
    """Per-tenant scheduler counters (all times in seconds)."""
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    queue_depth: int = 0
    wait_s: float = 0.0
    service_s: float = 0.0
    stragglers: int = 0
    credit: float = 0.0          # WFQ virtual time; 0 for other planes
    weight: float = 1.0
    priority: int = PRIORITY_NORMAL
    model: Optional[str] = None  # bound model family (multiplexing plane)

    def snapshot(self) -> dict:
        done = max(self.completed + self.failed, 1)
        return {
            "submitted": self.submitted,
            "model": self.model,
            "completed": self.completed,
            "failed": self.failed,
            "queue_depth": self.queue_depth,
            "wait_s": self.wait_s,
            "service_s": self.service_s,
            "avg_wait_ms": 1e3 * self.wait_s / done,
            "avg_service_ms": 1e3 * self.service_s / done,
            "stragglers": self.stragglers,
            "credit": self.credit,
            "weight": self.weight,
            "priority": self.priority,
        }


@dataclass
class _Job:
    tenant: object
    op: str
    work: Callable
    detail: dict
    future: Future
    t_submit: float
    seq: int = 0


@dataclass
class _TenantEntry:
    tenant: object
    stats: TenantSchedStats
    q: deque = field(default_factory=deque)
    weight: float = 1.0
    priority: int = PRIORITY_NORMAL
    vtime: float = 0.0                    # WFQ virtual finish time
    rate_limit: float = 0.0               # ops/sec; 0 = unlimited
    tokens: float = 0.0                   # token bucket for rate limiting
    t_tokens: float = 0.0                 # last bucket refill
    buildup_since: Optional[float] = None  # queue above watermark since
    last_buildup_irq: float = 0.0
    # SLO plane bookkeeping (unused by other planes)
    slo_wait_s: Optional[float] = None    # per-op wait budget (p95 target)
    waits: deque = field(default_factory=lambda: deque(maxlen=512))
    slo_hits: int = 0
    slo_misses: int = 0
    admission_denied: int = 0
    pressure_relieved: int = 0            # denials converted to swap relief
    mem_pressure: float = 0.0             # cached MMU-pool pressure [0,1]
    has_leases: bool = False              # live page tables → demote only
    mem_denials_seen: int = 0             # quota denials at last refresh
    pressure_checked: float = 0.0
    demoted: bool = False                 # soft pressure: queue behind class
    deny_until: float = 0.0               # hard pressure: reject submissions


class DataPlane:
    """Base class: registration, the shared service path, stats, IRQs."""

    name = "base"

    def __init__(self, oplog=None, straggler_factor: float = 4.0,
                 log_ops: bool = True, queue_high_watermark: int = 64,
                 queue_buildup_s: float = 0.25,
                 queue_irq_cooldown_s: float = 1.0, obs=None):
        self.oplog = oplog
        self.obs = obs if obs is not None else NULL_HUB
        self.straggler_factor = straggler_factor
        self.log_ops = log_ops
        self.queue_high_watermark = queue_high_watermark
        self.queue_buildup_s = queue_buildup_s
        self.queue_irq_cooldown_s = queue_irq_cooldown_s
        self._ewma: Dict[tuple, float] = {}           # guarded-by: _lock
        self._entries: Dict[str, _TenantEntry] = {}   # guarded-by: _lock
        self._lock = threading.Lock()
        self._seq = 0                                 # guarded-by: _lock

    # -- tenant lifecycle ----------------------------------------------
    def register(self, tenant, weight: float = 1.0,
                 priority: int = PRIORITY_NORMAL,
                 rate_limit_ops: float = 0.0,
                 slo_wait_s: Optional[float] = None,
                 model: Optional[str] = None):
        with self._lock:
            e = _TenantEntry(tenant=tenant,
                             stats=TenantSchedStats(weight=weight,
                                                    priority=priority,
                                                    model=model),
                             weight=max(weight, 1e-6), priority=priority,
                             rate_limit=rate_limit_ops,
                             tokens=max(1.0, rate_limit_ops),
                             t_tokens=time.monotonic(),
                             slo_wait_s=slo_wait_s)
            self._entries[tenant.name] = e
        return e

    def unregister(self, name: str):
        with self._lock:
            e = self._entries.pop(name, None)
        if e is not None:
            self._drain(e, RuntimeError(f"tenant {name} destroyed"))

    def _drain(self, entry: _TenantEntry, exc: Exception):
        while entry.q:
            job = entry.q.popleft()
            job.future.set_exception(exc)

    # -- submission API ------------------------------------------------
    def submit(self, tenant, op: str, work: Callable,
               detail: Optional[dict] = None) -> Future:
        raise NotImplementedError

    def execute(self, tenant, op: str, work: Callable,
                detail: Optional[dict] = None):
        return self.submit(tenant, op, work, detail).result()

    def drain(self, tenant):
        """Return once every op submitted for ``tenant`` so far has run.
        Here ops run on their callers' threads, so there is no queue to
        wait for (the tenant's quiesce waits for those in flight)."""

    # -- shared service path -------------------------------------------
    def _make_job(self, tenant, op, work, detail) -> _Job:
        with self._lock:
            self._seq += 1
            seq = self._seq
            e = self._entries.get(tenant.name)
            if e is not None:
                e.stats.submitted += 1
        return _Job(tenant, op, work, detail or {}, Future(),
                    time.monotonic(), seq)

    def _run_job(self, job: _Job):
        # the plane.run span covers the whole service path of every op;
        # the op's service time (straggler EWMA, accounting,
        # plane_service_s) is the work alone, from after enter_op
        tl = obs_spans.ACTIVE
        sid = tl.open("plane.run", job.seq, tag=job.op) \
            if tl is not None else 0
        t = job.tenant
        with self._lock:
            e = self._entries.get(t.name)
        rec = self.oplog.begin(t.name, job.op, job.detail) \
            if (self.oplog is not None and self.log_ops) else None
        t.enter_op()
        t0 = time.monotonic()
        ok, val = True, None
        try:
            val = job.work()
        except Exception as exc:          # noqa: BLE001 — forwarded
            ok, val = False, exc
        finally:
            t.exit_op()
            dt = time.monotonic() - t0
            self._observe(t, job.op, dt)
            if rec is not None:
                self.oplog.end(rec)
            if e is not None:
                with self._lock:
                    e.stats.wait_s += max(0.0, time.monotonic()
                                          - job.t_submit - dt)
                    e.stats.service_s += dt
                    if ok:
                        e.stats.completed += 1
                    else:
                        e.stats.failed += 1
                    # plane-specific accounting hook — runs under the
                    # lock and BEFORE the future resolves, so a caller
                    # woken by the result sees stats that include it
                    self._account_locked(e, job, dt, ok)
            if self.obs.enabled:
                wait = max(0.0, time.monotonic() - job.t_submit - dt)
                self.obs.observe("plane_wait_s", wait, tenant=t.name)
                self.obs.observe("plane_service_s", dt, tenant=t.name,
                                 op=job.op)
                self.obs.count("plane_ops_total", tenant=t.name, op=job.op,
                               status="ok" if ok else "error")
        if ok:
            job.future.set_result(val)
        else:
            job.future.set_exception(val)
        if sid:
            tl.close(sid)
        return dt

    def _account_locked(self, e: "_TenantEntry", job: "_Job", dt: float,
                        ok: bool):  # holds: _lock
        """Per-plane stats hook; called with self._lock held."""

    # -- straggler detection (EWMA deadline per (tenant, op)) ----------
    def _observe(self, t, op: str, dt: float):
        key = (t.name, op)
        straggler_ew = None
        with self._lock:
            ew = self._ewma.get(key)
            if ew is not None and dt > self.straggler_factor * ew:
                straggler_ew = ew
                e = self._entries.get(t.name)
                if e is not None:
                    e.stats.stragglers += 1
            self._ewma[key] = dt if ew is None else 0.8 * ew + 0.2 * dt
        if straggler_ew is not None:
            t.straggler_count += 1
            if self.obs.enabled:
                self.obs.count("plane_stragglers_total", tenant=t.name,
                               op=op)
                self.obs.flight_record(t.name, "straggler",
                                       {"op": op, "dt": dt,
                                        "ewma": straggler_ew})
            t.cq.raise_event(IRQ_DEGRADED, "straggler",
                             {"op": op, "dt": dt, "ewma": straggler_ew})

    # -- queue-buildup IRQ ---------------------------------------------
    def _note_depth(self, e: _TenantEntry):  # holds: _lock
        """Call with self._lock held, after a depth change."""
        depth = len(e.q)
        e.stats.queue_depth = depth
        now = time.monotonic()
        if depth < self.queue_high_watermark:
            e.buildup_since = None
            return None
        if e.buildup_since is None:
            e.buildup_since = now
            return None
        if (now - e.buildup_since >= self.queue_buildup_s
                and now - e.last_buildup_irq >= self.queue_irq_cooldown_s):
            e.last_buildup_irq = now
            return {"depth": depth, "since_s": now - e.buildup_since}
        return None

    # -- introspection -------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {"policy": self.name,
                    "tenants": {n: e.stats.snapshot()
                                for n, e in self._entries.items()}}

    def shutdown(self):
        pass


class PassthroughPlane(DataPlane):
    """bev/hybrid: ops run on the caller's thread, no cross-tenant queue."""

    name = "passthrough"

    def submit(self, tenant, op, work, detail=None) -> Future:
        job = self._make_job(tenant, op, work, detail)
        self._run_job(job)
        return job.future

    def execute(self, tenant, op, work, detail=None):
        # Same as submit().result(), but raises the original traceback.
        fut = self.submit(tenant, op, work, detail)
        exc = fut.exception()
        if exc is not None:
            raise exc
        return fut.result()


class _QueuedPlane(DataPlane):
    """Common machinery for planes with a worker thread + tenant queues."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._cv = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, tenant, op, work, detail=None) -> Future:
        job = self._make_job(tenant, op, work, detail)
        buildup = None
        with self._cv:
            e = self._entries.get(tenant.name)
            if e is not None:
                e.q.append(job)
                buildup = self._note_depth(e)
                self._cv.notify()
        if e is None:
            # resolve OUTSIDE the lock: set_exception runs done-callbacks
            # (user code) on the calling thread
            job.future.set_exception(
                KeyError(f"tenant {tenant.name} not registered"))
            return job.future
        if buildup is not None:
            if self.obs.enabled:
                self.obs.count("plane_buildup_irqs_total",
                               tenant=tenant.name)
                self.obs.flight_record(tenant.name, "queue_buildup",
                                       buildup)
            tenant.cq.raise_event(IRQ_DEGRADED, "queue_buildup", buildup)
        return job.future

    # -- worker --------------------------------------------------------
    def _loop(self):
        while not self._stop.is_set():
            with self._cv:
                job, entry, delay = self._pick()
                if job is None:
                    self._cv.wait(timeout=delay if delay else 0.05)
                    continue
                entry.q.popleft()
                self._note_depth(entry)
            dt = self._run_job(job)
            self._charge(entry, dt)
            with self._cv:
                self._cv.notify_all()       # wakes drain()

    def drain(self, tenant):
        # a tenant's ops run one at a time in submission order: wait
        # until as many have ended as had been submitted
        with self._cv:
            e = self._entries.get(tenant.name)
            if e is None:
                return
            target = e.stats.submitted
            while (e.stats.completed + e.stats.failed < target
                   and self._entries.get(tenant.name) is e
                   and not self._stop.is_set()):
                self._cv.wait(timeout=0.05)

    def _pick(self):  # holds: _lock
        """Return (job, entry, retry_delay); job is peeked, not popped.
        Called with the lock held. Default: rate-limited min-key scan
        over backlogged tenants, ranking via the per-plane ``_rank``
        hook (WFQ virtual time, SLO deadline); the broker overrides the
        whole pick with its rotation instead."""
        now = time.monotonic()
        best, best_delay = None, None
        for e in self._entries.values():
            if not e.q:
                continue
            ready, delay = self._refill(e, now)
            if not ready:
                best_delay = delay if best_delay is None \
                    else min(best_delay, delay)
                continue
            key = self._rank(e, now)
            if best is None or key < best[0]:
                best = (key, e)
        if best is None:
            return None, None, best_delay
        e = best[1]
        if e.rate_limit > 0.0:
            e.tokens -= 1.0
        return e.q[0], e, None

    def _rank(self, e: _TenantEntry, now: float) -> tuple:  # holds: _lock
        """Scheduling key for ``_pick`` (smaller = served first).
        Called with the lock held."""
        raise NotImplementedError

    def _refill(self, e: _TenantEntry, now: float):  # holds: _lock
        """Token-bucket refill for per-tenant op-rate limits. Returns
        (ready, retry_delay). Called with the lock held."""
        if e.rate_limit <= 0.0:
            return True, None
        burst = max(1.0, e.rate_limit)            # ≥1 so sub-1Hz rates fire
        e.tokens = min(burst, e.tokens + (now - e.t_tokens) * e.rate_limit)
        e.t_tokens = now
        if e.tokens >= 1.0:
            return True, None
        return False, (1.0 - e.tokens) / e.rate_limit

    def _charge(self, entry: _TenantEntry, service_s: float):
        pass

    def shutdown(self):
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._worker.join(timeout=2)


class BrokerPlane(_QueuedPlane):
    """fev: single broker thread, round-robin one op per tenant per sweep."""

    name = "broker"

    def __init__(self, **kw):
        # guarded-by: _lock  (tenant-name rotation order)
        self._rr: deque = deque()
        super().__init__(**kw)

    def register(self, tenant, **kw):
        e = super().register(tenant, **kw)
        with self._cv:
            self._rr.append(tenant.name)
            self._cv.notify()
        return e

    def unregister(self, name):
        with self._cv:
            try:
                self._rr.remove(name)
            except ValueError:
                pass
        super().unregister(name)

    def _pick(self):  # holds: _lock
        for _ in range(len(self._rr)):
            self._rr.rotate(-1)
            e = self._entries.get(self._rr[-1])
            if e is not None and e.q:
                return e.q[0], e, None
        return None, None, None


class WFQPlane(_QueuedPlane):
    """Weighted fair queueing with priority classes and op-rate limits.

    Virtual-time WFQ: serving tenant *i* an op of measured service time
    *c* advances its virtual time by ``c / weight_i``; the scheduler
    always serves, within the most urgent non-empty priority class, the
    backlogged tenant with the smallest virtual time. Equal-cost ops
    therefore complete in proportion to configured weights whenever
    tenants stay backlogged. A tenant returning from idle restarts at
    the current virtual clock (no credit hoarding). Optional per-tenant
    token buckets (``rate_limit_ops`` ops/sec, burst of one second)
    bound offered rate independently of weight.
    """

    name = "wfq"

    # Floor on per-op cost so zero-duration ops still advance vtime.
    MIN_COST_S = 1e-6

    def __init__(self, **kw):
        self._vclock = 0.0                    # guarded-by: _lock
        super().__init__(**kw)

    def _rank(self, e: _TenantEntry, now: float) -> tuple:  # holds: _lock
        return (e.priority, max(e.vtime, self._vclock), e.q[0].seq)

    def _charge(self, entry: _TenantEntry, service_s: float):
        with self._lock:
            cost = max(service_s, self.MIN_COST_S)
            start = max(entry.vtime, self._vclock)
            entry.vtime = start + cost / entry.weight
            self._vclock = start
            entry.stats.credit = entry.vtime


class SLOPlane(_QueuedPlane):
    """Deadline scheduling + MMU-pressure admission (the SLO control
    plane's data-plane half).

    **EDF within priority classes.** Each queued op carries a deadline:
    its submit time plus the tenant's ``slo_wait_s`` budget (explicit at
    ``register``, else the class default). The scheduler serves, within
    the most urgent non-empty priority class, the op with the earliest
    deadline. Per-tenant attainment (hits/misses against the budget, a
    rolling p95 of observed waits) is reported through ``stats()``.

    **Admission gate on the MMU paging view.** Before queueing, the
    plane reads the tenant's ``SegmentPool.memory_stats()`` (cached for
    ``pressure_refresh_s``): occupancy plus a fragmentation term forms a
    pressure score in [0, 1]. Above ``pressure_queue_util`` the tenant
    is *demoted* one priority class (queued behind unpressured tenants);
    above ``pressure_deny_util`` — or when fresh per-owner quota
    denials arrive while already pressured — new submissions are
    *denied* with :class:`AdmissionPressure` for ``deny_hold_s``. The
    memory-starved tenant is throttled by the MMU signal itself, not
    only by op-rate token buckets (which this plane also enforces).

    Liveness carve-out: a tenant holding live *page-table leases* is
    never hard-denied, only demoted. Its in-flight ops (paged-KV decode
    steps) are the only path to EOS reclaim — denying them would
    self-sustain the very pressure the gate reads. Newcomer admission
    on that path is throttled separately by the serve engine's
    ``pool_pressure_gate``.
    """

    name = "slo"

    # Per-class default wait budgets when register() gives none.
    DEFAULT_SLO_S = {PRIORITY_HIGH: 0.05, PRIORITY_NORMAL: 0.25,
                     PRIORITY_LOW: 1.0}

    def __init__(self, default_slo_s: Optional[dict] = None,
                 pressure_queue_util: float = 0.85,
                 pressure_deny_util: float = 0.97,
                 pressure_refresh_s: float = 0.05,
                 deny_hold_s: float = 0.25,
                 relief_cb: Optional[Callable[[str], bool]] = None, **kw):
        self.default_slo_s = dict(self.DEFAULT_SLO_S)
        if default_slo_s:
            self.default_slo_s.update(default_slo_s)
        self.pressure_queue_util = pressure_queue_util
        self.pressure_deny_util = pressure_deny_util
        self.pressure_refresh_s = pressure_refresh_s
        self.deny_hold_s = deny_hold_s
        # swap-before-deny: ``relief_cb(tenant_name) -> bool`` asks the
        # memory hierarchy to shed pressure (KV swap tier parks a victim
        # slot). True → the submission is admitted instead of denied.
        self.relief_cb = relief_cb
        super().__init__(**kw)

    def _slo_s(self, e: _TenantEntry) -> float:
        if e.slo_wait_s is not None:
            return e.slo_wait_s
        return self.default_slo_s.get(e.priority, 0.25)

    # -- MMU-pressure admission gate -----------------------------------
    def _refresh_pressure(self, e: _TenantEntry, now: float):  # holds: _lock
        """Recompute cached pool pressure. Lock held by caller; the pool
        lock nests inside the plane lock (never the reverse)."""
        if now - e.pressure_checked < self.pressure_refresh_s:
            return
        e.pressure_checked = now
        pool = getattr(e.tenant, "pool", None)
        if pool is None:
            e.mem_pressure, e.demoted = 0.0, False
            return
        ms = pool.memory_stats()
        util = ms["segments_in_use"] / max(ms["segments_total"], 1)
        frag = ms.get("fragmentation", 0.0)
        denials = sum(ms.get("quota_denials", {}).values())
        fresh = denials - e.mem_denials_seen
        e.mem_denials_seen = denials
        # fragmentation makes nominally-free segments unusable for
        # contiguous asks — fold a fraction into the occupancy signal
        e.mem_pressure = min(1.0, util + 0.25 * frag * (1.0 - util))
        e.demoted = e.mem_pressure >= self.pressure_queue_util
        # liveness: a tenant with live page-table leases is only ever
        # demoted — its in-flight ops are the path to EOS reclaim
        e.has_leases = ms.get("page_tables", 0) > 0
        # fresh denials while already pressured latch a deny window;
        # occupancy past the deny watermark is checked instantaneously
        # at submit (it clears the moment the pool drains)
        if fresh > 0 and e.demoted and not e.has_leases:
            e.deny_until = now + self.deny_hold_s

    def submit(self, tenant, op, work, detail=None) -> Future:
        denied, pressure = False, 0.0
        now = time.monotonic()
        with self._lock:
            e = self._entries.get(tenant.name)
            if e is not None:
                self._refresh_pressure(e, now)
                denied = (now < e.deny_until
                          or (e.mem_pressure >= self.pressure_deny_util
                              and not e.has_leases))
                pressure = e.mem_pressure
        if e is not None:
            if denied and self.relief_cb is not None:
                note_callback("plane.relief_cb")
                if self.relief_cb(tenant.name):
                    # swap-before-deny: the hierarchy shed pressure
                    # (pages moved to the host tier) — admit instead
                    denied = False
                    with self._lock:
                        e.pressure_relieved += 1
                        e.deny_until = 0.0
                    if self.obs.enabled:
                        self.obs.count("plane_pressure_relieved_total",
                                       tenant=tenant.name)
                        self.obs.flight_record(
                            tenant.name, "pressure_relieved",
                            {"op": op, "mem_pressure": pressure})
            if denied:
                with self._lock:
                    e.admission_denied += 1
                if self.obs.enabled:
                    self.obs.count("plane_admission_denied_total",
                                   tenant=tenant.name)
                    self.obs.flight_record(
                        tenant.name, "admission_pressure",
                        {"op": op, "mem_pressure": pressure})
                fut = Future()
                fut.set_exception(AdmissionPressure(
                    f"{tenant.name}: memory pressure "
                    f"{pressure:.2f} — admission denied"))
                return fut
        return super().submit(tenant, op, work, detail)

    # -- EDF rank: deadline within (possibly demoted) priority class ---
    def _rank(self, e: _TenantEntry, now: float) -> tuple:  # holds: _lock
        self._refresh_pressure(e, now)
        prio = e.priority + (1 if e.demoted else 0)
        return (prio, e.q[0].t_submit + self._slo_s(e), e.q[0].seq)

    # -- attainment accounting (locked hook: runs before the job's
    # future resolves, so stats() is never behind a woken caller) ------
    def _account_locked(self, e: _TenantEntry, job: _Job, dt: float,
                        ok: bool):  # holds: _lock
        wait = max(0.0, time.monotonic() - job.t_submit - dt)
        e.waits.append(wait)
        # a failed op never served its caller — always an SLO miss,
        # even when it failed fast within the wait budget
        if ok and wait <= self._slo_s(e):
            e.slo_hits += 1
        else:
            e.slo_misses += 1

    def stats(self) -> dict:
        s = super().stats()
        with self._lock:
            for n, e in self._entries.items():
                snap = s["tenants"].get(n)
                if snap is None:          # registered since the base
                    continue              # snapshot — skip, don't crash
                waits = sorted(e.waits)
                p95 = waits[int(0.95 * (len(waits) - 1))] if waits else 0.0
                done = max(e.slo_hits + e.slo_misses, 1)
                snap.update({
                    "slo_wait_ms": 1e3 * self._slo_s(e),
                    "slo_hits": e.slo_hits,
                    "slo_misses": e.slo_misses,
                    "slo_attainment": e.slo_hits / done,
                    "p95_wait_ms": 1e3 * p95,
                    "mem_pressure": e.mem_pressure,
                    "admission_denied": e.admission_denied,
                    "pressure_relieved": e.pressure_relieved,
                })
        return s


# ---------------------------------------------------------------------------
# Policy string → plane factory (the VMM's single point of selection)
# ---------------------------------------------------------------------------

def make_data_plane(policy: str, oplog=None, **kw) -> DataPlane:
    """``fev``/``bev``/``hybrid``/``wfq``/``slo`` → configured DataPlane."""
    if policy == "fev":
        return BrokerPlane(oplog=oplog, log_ops=True, **kw)
    if policy == "bev":
        return PassthroughPlane(oplog=oplog, log_ops=False, **kw)
    if policy == "hybrid":
        return PassthroughPlane(oplog=oplog, log_ops=True, **kw)
    if policy == "wfq":
        return WFQPlane(oplog=oplog, log_ops=True, **kw)
    if policy == "slo":
        return SLOPlane(oplog=oplog, log_ops=True, **kw)
    raise ValueError(f"unknown data-plane policy: {policy!r}")


POLICIES = ("fev", "bev", "hybrid", "wfq", "slo")
