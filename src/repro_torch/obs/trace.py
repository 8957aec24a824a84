"""Request-lifecycle tracing — one span per serving request.

A :class:`Span` is the ordered event chain of a request's life through
the serving stack::

    queued → admitted → prefill (per chunk) → decode × N → done
                    ↘ deferred / denied (with a cause)

Every event carries a ``time.monotonic()`` timestamp (the same clock
the scheduler and autoscaler do latency math on); a wall-clock stamp is
kept once per span for display only. From the chain the tracer derives
the numbers the paper's §V evaluation is built on, per tenant:

* **queue wait** — queued → admitted;
* **TTFT** — queued → first emitted token;
* **tokens/s** — emitted tokens over admitted → done;
* **denial-cause attribution** — deferred/denied counts by cause.

Finished spans land in a fixed-size ring buffer (oldest evicted);
derived latencies feed the shared :class:`~repro_torch.obs.metrics
.MetricsRegistry` histograms (``serve_queue_wait_s``, ``serve_ttft_s``,
``serve_tokens_per_s`` — labeled by tenant), so snapshots stay O(ring)
while percentiles cover every request ever finished.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

#: Canonical span phases, in lifecycle order.
PHASE_QUEUED = "queued"
PHASE_ADMITTED = "admitted"
PHASE_PREFILL = "prefill"
PHASE_PREFILL_CHUNK = "prefill_chunk"
PHASE_DECODE = "decode"
PHASE_DONE = "done"
PHASE_DEFERRED = "deferred"
PHASE_DENIED = "denied"
#: KV page-hierarchy phases: a slot suspended to the host swap tier
#: mid-decode, and its pages refaulted back on resume.
PHASE_SWAP_OUT = "swap_out"
PHASE_REFAULT = "refault"

#: Per-span event-list cap; decode chatter beyond it is counted, not
#: stored (the span keeps exact n_decode_steps / n_tokens regardless).
MAX_EVENTS = 128


@dataclass
class SpanEvent:
    phase: str
    t: float                      # time.monotonic()
    detail: dict = field(default_factory=dict)


@dataclass
class Span:
    tenant: str
    rid: int
    t_wall: float = field(default_factory=time.time)   # display only
    events: List[SpanEvent] = field(default_factory=list)
    dropped_events: int = 0
    status: Optional[str] = None           # done | denied | None=open
    n_decode_steps: int = 0
    n_tokens: int = 0
    n_prefill_chunks: int = 0
    # phase timestamps (monotonic), filled as the request advances
    t_queued: Optional[float] = None
    t_admitted: Optional[float] = None
    t_prefill_start: Optional[float] = None
    t_prefill_done: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    def _add(self, phase: str, t: float, detail: dict):
        if len(self.events) < MAX_EVENTS:
            self.events.append(SpanEvent(phase, t, detail))
        else:
            self.dropped_events += 1

    # -- derived metrics ----------------------------------------------
    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.t_queued is None or self.t_admitted is None:
            return None
        return self.t_admitted - self.t_queued

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_queued is None or self.t_first_token is None:
            return None
        return self.t_first_token - self.t_queued

    @property
    def prefill_s(self) -> Optional[float]:
        """Admission → last prompt token written. Chunked prefills span
        many engine steps; without this the whole wait would be
        misattributed to the first decode."""
        end = self.t_prefill_done
        start = self.t_prefill_start or self.t_admitted
        if start is None or end is None:
            return None
        return end - start

    @property
    def tokens_per_s(self) -> Optional[float]:
        if (self.t_admitted is None or self.t_done is None
                or self.n_tokens == 0):
            return None
        return self.n_tokens / max(self.t_done - self.t_admitted, 1e-9)

    def phases(self) -> List[str]:
        return [e.phase for e in self.events]

    def to_dict(self) -> dict:
        return {
            "tenant": self.tenant,
            "rid": self.rid,
            "t_wall": self.t_wall,
            "status": self.status,
            "n_decode_steps": self.n_decode_steps,
            "n_tokens": self.n_tokens,
            "n_prefill_chunks": self.n_prefill_chunks,
            "queue_wait_s": self.queue_wait_s,
            "prefill_s": self.prefill_s,
            "ttft_s": self.ttft_s,
            "tokens_per_s": self.tokens_per_s,
            "dropped_events": self.dropped_events,
            "events": [{"phase": e.phase, "t": e.t, **(
                {"detail": e.detail} if e.detail else {})}
                for e in self.events],
        }


class RequestTracer:
    """Span store: open spans by (tenant, rid), finished spans in a
    ring. All mutation under one tracer lock — spans are touched a few
    times per engine *step* (not per op), so striping buys nothing
    here; the registry histograms it feeds are striped."""

    def __init__(self, capacity: int = 1024, registry=None):
        self.capacity = capacity
        self.registry = registry
        self._open: Dict[tuple, Span] = {}           # guarded-by: _lock
        self._ring: deque = deque(maxlen=capacity)   # guarded-by: _lock
        self._lock = threading.Lock()
        # denial/deferral attribution: (tenant, cause) → count
        self._denials: Dict[tuple, int] = {}         # guarded-by: _lock

    # -- recording -----------------------------------------------------
    def start(self, tenant: str, rid: int, **detail) -> Span:
        now = time.monotonic()
        span = Span(tenant=tenant, rid=rid)
        span.t_queued = now
        span._add(PHASE_QUEUED, now, detail)
        with self._lock:
            self._open[(tenant, rid)] = span
        return span

    def event(self, tenant: str, rid: int, phase: str, **detail):
        now = time.monotonic()
        with self._lock:
            span = self._open.get((tenant, rid))
            if span is None:
                return
            span._add(phase, now, detail)
            if phase == PHASE_ADMITTED:
                span.t_admitted = now
            elif phase == PHASE_PREFILL_CHUNK:
                span.n_prefill_chunks += 1
                if span.t_prefill_start is None:
                    span.t_prefill_start = now
            elif phase == PHASE_PREFILL:
                span.t_prefill_done = now
            elif phase == PHASE_DECODE:
                span.n_decode_steps += 1
            elif phase in (PHASE_DEFERRED, PHASE_DENIED):
                cause = detail.get("cause", phase)
                k = (tenant, cause)
                self._denials[k] = self._denials.get(k, 0) + 1
        if self.registry is not None and phase in (PHASE_DEFERRED,
                                                   PHASE_DENIED):
            self.registry.counter("serve_denials_total", tenant=tenant,
                                  cause=detail.get("cause", phase)).inc()

    def token(self, tenant: str, rid: int, n: int = 1):
        """Token emitted for rid; the first one pins TTFT."""
        now = time.monotonic()
        with self._lock:
            span = self._open.get((tenant, rid))
            if span is None:
                return
            if span.t_first_token is None:
                span.t_first_token = now
            span.n_tokens += n

    def finish(self, tenant: str, rid: int, status: str = "done",
               **detail) -> Optional[Span]:
        now = time.monotonic()
        with self._lock:
            span = self._open.pop((tenant, rid), None)
            if span is None:
                return None
            span.t_done = now
            span.status = status
            span._add(PHASE_DONE if status == "done" else status,
                      now, detail)
            self._ring.append(span)
        if self.registry is not None:
            r = self.registry
            if span.queue_wait_s is not None:
                r.histogram("serve_queue_wait_s",
                            tenant=tenant).observe(span.queue_wait_s)
            if span.prefill_s is not None:
                r.histogram("serve_prefill_s",
                            tenant=tenant).observe(span.prefill_s)
            if span.ttft_s is not None:
                r.histogram("serve_ttft_s",
                            tenant=tenant).observe(span.ttft_s)
            if span.tokens_per_s is not None:
                r.histogram("serve_tokens_per_s",
                            tenant=tenant).observe(span.tokens_per_s)
            r.counter("serve_requests_total", tenant=tenant,
                      status=status).inc()
            r.counter("serve_tokens_total", tenant=tenant).inc(span.n_tokens)
        return span

    # -- introspection -------------------------------------------------
    def spans(self, tenant: Optional[str] = None,
              rid: Optional[int] = None) -> List[Span]:
        """Finished spans (ring order, oldest first), optionally
        filtered."""
        with self._lock:
            return [s for s in self._ring
                    if (tenant is None or s.tenant == tenant)
                    and (rid is None or s.rid == rid)]

    def open_spans(self) -> List[Span]:
        with self._lock:
            return list(self._open.values())

    def snapshot(self) -> dict:
        """Per-tenant rollup of the finished-span ring + attribution."""
        with self._lock:
            ring = list(self._ring)
            n_open = len(self._open)
            denials = {f"{t}:{cause}": n
                       for (t, cause), n in sorted(self._denials.items())}
        tenants: Dict[str, dict] = {}
        for s in ring:
            d = tenants.setdefault(s.tenant, {
                "finished": 0, "tokens": 0, "decode_steps": 0,
                "queue_wait_s": [], "ttft_s": [], "tokens_per_s": []})
            d["finished"] += 1
            d["tokens"] += s.n_tokens
            d["decode_steps"] += s.n_decode_steps
            for key, v in (("queue_wait_s", s.queue_wait_s),
                           ("ttft_s", s.ttft_s),
                           ("tokens_per_s", s.tokens_per_s)):
                if v is not None:
                    d[key].append(v)
        for d in tenants.values():
            for key in ("queue_wait_s", "ttft_s", "tokens_per_s"):
                vals = sorted(d.pop(key))
                if vals:
                    d[key] = {
                        "mean": sum(vals) / len(vals),
                        "p50": vals[len(vals) // 2],
                        "p95": vals[min(int(0.95 * (len(vals) - 1)),
                                        len(vals) - 1)],
                    }
                else:
                    d[key] = None
        return {"capacity": self.capacity, "open": n_open,
                "tenants": tenants, "denials": denials}
