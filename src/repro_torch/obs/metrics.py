"""Unified metrics registry — the telemetry substrate every subsystem
reports into.

Before this module, timing and counters were scattered across six
ad-hoc ``stats()`` dicts (VMM / scheduler / MMU / autoscaler / serving
engine / shell) with no shared schema and no distributions. The
registry gives the stack one vocabulary:

* :class:`Counter` — monotonically increasing totals (ops served,
  pages leased, denials);
* :class:`Gauge`   — last-write-wins instantaneous values (queue
  depth, occupancy);
* :class:`Histogram` — log-bucketed latency/size distributions with
  p50/p95/p99 + mean, cheap enough for per-op recording (observe() is
  a bisect into ~60 geometric buckets, no sample retention).

Every metric carries a name plus optional labels (``tenant=...``,
``op=...``); the registry is **lock-striped** — metrics hash onto one
of ``n_stripes`` independent locks, so two tenants' hot paths never
serialize on a single registry-wide mutex.

Two export surfaces:

* :meth:`MetricsRegistry.snapshot` — one JSON-able tree
  ``{"counters": …, "gauges": …, "histograms": …, "providers": …}``
  keyed ``name{label=value,…}``;
* :meth:`MetricsRegistry.prometheus` — Prometheus-style text
  exposition (counters/gauges as-is, histograms as summaries with
  quantile lines).

Legacy ``stats()`` dicts re-register through
:meth:`MetricsRegistry.register_provider`: a provider is a callable
returning a JSON-able dict, pulled at snapshot time — so
``VMM.stats()`` and the registry expose one coherent tree without
double-maintaining counters during the migration.
"""
from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.analysis.lock_watchdog import note_callback


def _label_key(labels: dict) -> str:
    """Canonical label string: sorted ``k=v`` pairs, '' for no labels."""
    if not labels:
        return ""
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


class Counter:
    """Monotonic counter. Thread-safe via the owning stripe's lock."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: dict, lock: threading.Lock):
        self.name = name
        self.labels = labels
        self._value = 0.0               # guarded-by: _lock
        self._lock = lock

    def inc(self, n: float = 1.0):
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: dict, lock: threading.Lock):
        self.name = name
        self.labels = labels
        self._value = 0.0               # guarded-by: _lock
        self._lock = lock

    def set(self, v: float):
        with self._lock:
            self._value = float(v)

    def add(self, n: float = 1.0):
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


# Default bucket universe: geometric from 1 µs to ~4000 s, factor 2 —
# 62 buckets covers every latency this stack measures (ns-scale MMU
# translates up through multi-second migrations) at ~±50% resolution.
_DEFAULT_BOUNDS = tuple(1e-6 * 2.0 ** i for i in range(62))


class Histogram:
    """Log-bucketed distribution: O(log buckets) observe, no sample
    retention. Percentiles are estimated at the geometric midpoint of
    the covering bucket (exact count/sum/min/max kept alongside)."""

    __slots__ = ("name", "labels", "bounds", "_counts", "_count", "_sum",
                 "_min", "_max", "_lock")

    def __init__(self, name: str, labels: dict, lock: threading.Lock,
                 bounds: Tuple[float, ...] = _DEFAULT_BOUNDS):
        self.name = name
        self.labels = labels
        self.bounds = bounds                  # bucket upper edges
        self._counts = [0] * (len(bounds) + 1)  # guarded-by: _lock
        self._count = 0                         # guarded-by: _lock
        self._sum = 0.0                         # guarded-by: _lock
        self._min = math.inf                    # guarded-by: _lock
        self._max = -math.inf                   # guarded-by: _lock
        self._lock = lock

    def observe(self, v: float):
        i = bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def _bucket_mid(self, i: int) -> float:  # holds: _lock
        """Geometric midpoint of bucket i (clamped to observed range)."""
        if i == 0:
            lo, hi = 0.0, self.bounds[0]
            mid = hi / 2.0
        elif i >= len(self.bounds):
            mid = self._max if self._max > -math.inf else self.bounds[-1]
        else:
            mid = math.sqrt(self.bounds[i - 1] * self.bounds[i])
        if self._min <= self._max:           # clamp into observed range
            mid = min(max(mid, self._min), self._max)
        return mid

    def _percentile_locked(self, q: float) -> float:  # holds: _lock
        if self._count == 0:
            return 0.0
        target = q * (self._count - 1)
        seen = 0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            seen += c
            if seen > target:
                return self._bucket_mid(i)
        return self._bucket_mid(len(self.bounds))

    def percentile(self, q: float) -> float:
        with self._lock:
            return self._percentile_locked(q)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def summary(self) -> dict:
        with self._lock:
            if self._count == 0:
                return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                        "max": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
            return {
                "count": self._count,
                "sum": self._sum,
                "mean": self._sum / self._count,
                "min": self._min,
                "max": self._max,
                "p50": self._percentile_locked(0.50),
                "p95": self._percentile_locked(0.95),
                "p99": self._percentile_locked(0.99),
            }


class MetricsRegistry:
    """Named, labeled metrics behind ``n_stripes`` independent locks.

    ``counter()/gauge()/histogram()`` are get-or-create: the first call
    registers the metric, later calls with the same (name, labels)
    return the same object — call sites just describe what they record.
    """

    def __init__(self, n_stripes: int = 16):
        self._stripes = [threading.Lock() for _ in range(n_stripes)]
        # stripe list itself is immutable after init; each element dict
        # is guarded by the same-index stripe lock
        self._maps: List[Dict[tuple, object]] = [dict() for _ in
                                                 range(n_stripes)]  # guarded-by: _stripes
        self._providers: Dict[str, Callable[[], dict]] = {}  # guarded-by: _providers_lock
        self._providers_lock = threading.Lock()

    # -- get-or-create -------------------------------------------------
    def _get(self, cls, name: str, labels: dict, **kw):
        key = (cls.__name__, name, _label_key(labels))
        i = hash(key) % len(self._stripes)
        lock = self._stripes[i]
        with lock:
            m = self._maps[i]
            obj = m.get(key)
            if obj is None:
                obj = cls(name, labels, lock, **kw)
                m[key] = obj
        return obj

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    # -- legacy stats() providers --------------------------------------
    def register_provider(self, prefix: str, fn: Callable[[], dict]):
        """Attach a legacy ``stats()``-style callable; its dict appears
        under ``snapshot()["providers"][prefix]``. Re-registering a
        prefix replaces the provider (tenant churn, engine restarts)."""
        with self._providers_lock:
            self._providers[prefix] = fn

    def unregister_provider(self, prefix: str):
        with self._providers_lock:
            self._providers.pop(prefix, None)

    # -- export --------------------------------------------------------
    def _all_metrics(self) -> List[object]:
        out: List[object] = []
        for i, lock in enumerate(self._stripes):
            with lock:
                out.extend(self._maps[i].values())
        return out

    def snapshot(self) -> dict:
        """One JSON-able tree. Schema (stable — pinned by the golden
        schema test)::

            {"counters":   {name: {label_key: value}},
             "gauges":     {name: {label_key: value}},
             "histograms": {name: {label_key: {count,sum,mean,min,max,
                                               p50,p95,p99}}},
             "providers":  {prefix: <provider dict>}}
        """
        counters: Dict[str, dict] = {}
        gauges: Dict[str, dict] = {}
        hists: Dict[str, dict] = {}
        for obj in self._all_metrics():
            lk = _label_key(obj.labels)
            if isinstance(obj, Counter):
                counters.setdefault(obj.name, {})[lk] = obj.value
            elif isinstance(obj, Gauge):
                gauges.setdefault(obj.name, {})[lk] = obj.value
            elif isinstance(obj, Histogram):
                hists.setdefault(obj.name, {})[lk] = obj.summary()
        with self._providers_lock:
            providers = dict(self._providers)
        # provider callables run OUTSIDE the providers lock: they are
        # user code (VMM.stats, plane.stats) that takes subsystem locks
        note_callback("metrics.provider")
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
            "providers": {p: fn() for p, fn in providers.items()},
        }

    def prometheus(self) -> str:
        """Prometheus-style text exposition (histograms as summaries)."""
        lines: List[str] = []
        seen_type: set = set()

        def _labels(obj, extra: Optional[dict] = None) -> str:
            items = dict(obj.labels)
            if extra:
                items.update(extra)
            if not items:
                return ""
            body = ",".join(f'{k}="{items[k]}"' for k in sorted(items))
            return "{" + body + "}"

        for obj in sorted(self._all_metrics(), key=lambda o: o.name):
            if isinstance(obj, Counter):
                if obj.name not in seen_type:
                    lines.append(f"# TYPE {obj.name} counter")
                    seen_type.add(obj.name)
                lines.append(f"{obj.name}{_labels(obj)} {obj.value:g}")
            elif isinstance(obj, Gauge):
                if obj.name not in seen_type:
                    lines.append(f"# TYPE {obj.name} gauge")
                    seen_type.add(obj.name)
                lines.append(f"{obj.name}{_labels(obj)} {obj.value:g}")
            elif isinstance(obj, Histogram):
                if obj.name not in seen_type:
                    lines.append(f"# TYPE {obj.name} summary")
                    seen_type.add(obj.name)
                s = obj.summary()
                for q in ("0.5", "0.95", "0.99"):
                    key = "p" + str(int(float(q) * 100))
                    lines.append(f"{obj.name}{_labels(obj, {'quantile': q})}"
                                 f" {s[key]:g}")
                lines.append(f"{obj.name}_sum{_labels(obj)} {s['sum']:g}")
                lines.append(f"{obj.name}_count{_labels(obj)} {s['count']}")
        return "\n".join(lines) + ("\n" if lines else "")
