"""vPOD telemetry plane — metrics registry, request tracing, flight
recorder, behind one :class:`ObsHub`.

Usage from instrumented code (VMM, data planes, MMU pools, serving
engines)::

    hub = ObsHub(enabled=True)
    if hub.enabled:
        hub.registry.counter("mmu_page_faults_total", tenant="a").inc()
        hub.tracer.start("a", rid)
        hub.flight.record("a", "queue_buildup", {"depth": 80})

The hub is a **no-op when disabled**: ``enabled`` is False, and every
convenience method returns immediately — instrumentation sites guard
their work with ``if hub.enabled`` so the disabled-mode cost on a hot
path is one attribute check (measured, not assumed:
``benchmarks/obs_overhead.py`` pins disabled overhead < 1% and
enabled < 5% on the paged-KV serving path).

A module-level :data:`NULL_HUB` (disabled) is the default everywhere a
component takes an ``obs=`` parameter, so un-instrumented construction
paths keep working unchanged.
"""
from __future__ import annotations

from repro_torch.obs.flight import TRIGGER_KINDS, FlightRecorder
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry)
from repro_torch.obs.trace import (MAX_EVENTS, PHASE_ADMITTED, PHASE_DECODE,
                             PHASE_DEFERRED, PHASE_DENIED, PHASE_DONE,
                             PHASE_PREFILL, PHASE_PREFILL_CHUNK,
                             PHASE_QUEUED, PHASE_REFAULT, PHASE_SWAP_OUT,
                             RequestTracer,
                             Span)


class ObsHub:
    """One telemetry plane: registry + tracer + flight recorder.

    ``enabled=False`` constructs the same objects (so introspection
    code can always call ``snapshot()``) but instrumentation sites
    skip recording entirely.
    """

    def __init__(self, enabled: bool = True, trace_capacity: int = 1024,
                 flight_capacity: int = 64, n_stripes: int = 16):
        self.enabled = enabled
        self.registry = MetricsRegistry(n_stripes=n_stripes)
        self.tracer = RequestTracer(capacity=trace_capacity,
                                    registry=self.registry)
        self.flight = FlightRecorder(capacity=flight_capacity)

    # -- convenience recorders (no-ops when disabled) -------------------
    def count(self, name: str, n: float = 1.0, **labels):
        if self.enabled:
            self.registry.counter(name, **labels).inc(n)

    def observe(self, name: str, value: float, **labels):
        if self.enabled:
            self.registry.histogram(name, **labels).observe(value)

    def set_gauge(self, name: str, value: float, **labels):
        if self.enabled:
            self.registry.gauge(name, **labels).set(value)

    def flight_record(self, tenant: str, kind: str, payload=None):
        if self.enabled:
            self.flight.record(tenant, kind, payload)

    # -- export ---------------------------------------------------------
    def snapshot(self, providers: bool = True) -> dict:
        """The unified telemetry tree (stable schema — golden-tested)."""
        m = self.registry.snapshot()
        if not providers:
            m.pop("providers", None)
        return {
            "enabled": self.enabled,
            "metrics": m,
            "traces": self.tracer.snapshot(),
            "flight": self.flight.snapshot(),
        }

    def prometheus(self) -> str:
        return self.registry.prometheus()


#: Shared disabled hub — the default for every ``obs=`` parameter.
NULL_HUB = ObsHub(enabled=False)


__all__ = [
    "Counter", "FlightRecorder", "Gauge", "Histogram", "MAX_EVENTS",
    "MetricsRegistry",
    "NULL_HUB", "ObsHub", "PHASE_ADMITTED", "PHASE_DECODE",
    "PHASE_DEFERRED", "PHASE_DENIED", "PHASE_DONE", "PHASE_PREFILL",
    "PHASE_PREFILL_CHUNK", "PHASE_QUEUED", "PHASE_REFAULT",
    "PHASE_SWAP_OUT", "RequestTracer", "Span", "TRIGGER_KINDS",
]
