"""Per-tenant flight recorder — the last N control-plane events, dumped
automatically when degradation strikes.

The paper's §IV.B interrupts tell the host *that* a slice degraded;
reconstructing *why* previously required reproducing the workload with
ad-hoc prints. The flight recorder keeps a small ring of
IRQ/admission/resize events per tenant (every record is cheap: one
deque append under a lock) and snapshots the ring into a **dump** the
moment a trigger event lands — ``slice_failed``, the ``IRQ_DEGRADED``
kinds (``queue_buildup``/``straggler``), or an ``AdmissionPressure``
denial — so a degradation postmortem reads the dump instead of
reproducing the incident.

Dump storms are bounded: per-tenant dumps are rate-limited to one per
``dump_interval_s`` and the dump list itself is a ring.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

#: Event kinds that automatically snapshot the tenant's ring.
TRIGGER_KINDS = frozenset({
    "slice_failed",            # VMM fault path
    "queue_buildup",           # IRQ_DEGRADED from the data plane
    "straggler",               # IRQ_DEGRADED from the data plane
    "admission_pressure",      # SLOPlane AdmissionPressure denial
    "grow_blocked",            # autoscaler could not place a resize
    "crc_failure",             # model-registry bitstream CRC mismatch
})


class FlightRecorder:
    def __init__(self, capacity: int = 64, max_dumps: int = 32,
                 dump_interval_s: float = 1.0):
        self.capacity = capacity
        self.dump_interval_s = dump_interval_s
        self._rings: Dict[str, deque] = {}       # guarded-by: _lock
        self._last_dump: Dict[str, float] = {}   # guarded-by: _lock
        self.dumps: deque = deque(maxlen=max_dumps)  # guarded-by: _lock
        self._lock = threading.Lock()

    # -- recording -----------------------------------------------------
    def record(self, tenant: str, kind: str,
               payload: Optional[dict] = None) -> Optional[dict]:
        """Append an event; auto-dump if ``kind`` is a trigger. Returns
        the dump taken, if any."""
        now = time.monotonic()
        ev = {"t": now, "wall": time.time(), "kind": kind,
              "payload": dict(payload or {})}
        with self._lock:
            ring = self._rings.get(tenant)
            if ring is None:
                ring = self._rings[tenant] = deque(maxlen=self.capacity)
            ring.append(ev)
            if kind not in TRIGGER_KINDS:
                return None
            if now - self._last_dump.get(tenant, float("-inf")) \
                    < self.dump_interval_s:
                return None
            return self._dump_locked(tenant, reason=kind, now=now)

    def dump(self, tenant: str, reason: str = "manual") -> dict:
        """Snapshot a tenant's ring on demand (postmortem tooling)."""
        with self._lock:
            return self._dump_locked(tenant, reason, time.monotonic())

    def _dump_locked(self, tenant: str, reason: str,
                     now: float) -> dict:  # holds: _lock
        self._last_dump[tenant] = now
        d = {"tenant": tenant, "reason": reason, "t": now,
             "wall": time.time(),
             "events": [dict(e) for e in self._rings.get(tenant, ())]}
        self.dumps.append(d)
        return d

    def forget(self, tenant: str):
        """Drop a destroyed tenant's ring (dumps already taken stay)."""
        with self._lock:
            self._rings.pop(tenant, None)
            self._last_dump.pop(tenant, None)

    # -- introspection -------------------------------------------------
    def events(self, tenant: str) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._rings.get(tenant, ())]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "tenants": {t: len(r) for t, r in self._rings.items()},
                "dumps": [dict(d, events=len(d["events"]))
                          for d in self.dumps],
            }
