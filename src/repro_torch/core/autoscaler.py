"""IRQ-driven elastic autoscaler — the control loop the paper's §IV
degradation interrupts were built for.

The data-plane scheduler raises ``IRQ_DEGRADED`` on a tenant's
completion queue when its backlog stays above the high watermark
(``queue_buildup``) or an op blows its EWMA deadline (``straggler``).
Until now nothing consumed those interrupts; this module closes the
loop: sustained pressure, filtered through hysteresis and a cooldown,
triggers a slice resize through the elastic re-slicing primitive
(:func:`repro_torch.core.elastic.resize`, i.e. checkpoint → re-floorplan →
re-bind → restore), and a sustained calm period shrinks the tenant back
toward its baseline shape.

Design points:

* **Event subscription, decision polling.** The IRQ handler only
  records timestamped pressure events (handlers run on whatever thread
  raised the event — a submitter or the plane worker — so they must
  stay O(1)). Scaling decisions happen in :meth:`poll`, either driven
  explicitly (tests, serving loops) or by the optional background
  thread (:meth:`start`).
* **Hysteresis.** A resize requires ``sustain`` pressure events inside
  ``window_s``; after any action the tenant is immune for
  ``cooldown_s``; scale-down requires ``calm_s`` with no events and
  only ever retraces the grow history (never below baseline).
* **Failure is data.** A grow that cannot be placed first tries
  :func:`~repro_torch.core.elastic.defragment`; if the retry still fails the
  action is recorded as ``grow_blocked`` (and the cooldown still
  applies, so a full floorplan is not hammered).

All actions are visible in ``VMM.stats()["autoscaler"]``. This is the
port of ``repro.core.autoscaler``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.analysis.lock_watchdog import note_callback
from repro_torch.core.elastic import defragment, resize
from repro_torch.core.scheduler import IRQ_DEGRADED
from repro_torch.core.vmm import AdmissionError

#: IRQ_DEGRADED event kinds that count as scaling pressure. Other kinds
#: on the same line (e.g. ``slice_failed``) have their own consumers.
PRESSURE_KINDS = ("queue_buildup", "straggler")


@dataclass
class _Watch:
    tenant: object
    baseline: Tuple[int, int]
    state_template: object = None
    shardings_fn: object = None
    events: deque = field(default_factory=lambda: deque(maxlen=256))
    history: List[Tuple[int, int]] = field(default_factory=list)
    # -inf: a fresh watch is neither cooling down nor recently pressured
    last_event: float = float("-inf")
    last_action: float = float("-inf")


class Autoscaler:
    """Subscribe to degradation IRQs; resize slices under sustained
    pressure. One instance per VMM (it registers itself so
    ``VMM.stats()`` surfaces its action log)."""

    def __init__(self, vmm, sustain: int = 3, window_s: float = 2.0,
                 cooldown_s: float = 5.0, calm_s: float = 10.0,
                 max_devices: Optional[int] = None,
                 scale_down: bool = True,
                 time_fn: Callable[[], float] = time.monotonic,
                 swap_cb: Optional[Callable[[str], bool]] = None):
        self.vmm = vmm
        self.sustain = sustain
        self.window_s = window_s
        self.cooldown_s = cooldown_s
        self.calm_s = calm_s
        self.max_devices = max_devices
        self.scale_down = scale_down
        self.time_fn = time_fn
        # swap-before-deny at the capacity layer: when a grow cannot be
        # placed even after defragmentation, ``swap_cb(tenant_name)``
        # asks the KV swap tier to shed device pressure to host memory;
        # True turns ``grow_blocked`` into ``swap_relief``.
        self.swap_cb = swap_cb
        self.actions: deque = deque(maxlen=256)  # guarded-by: _lock
        self._watched: Dict[str, _Watch] = {}    # guarded-by: _lock
        # tenants whose cq has our handler
        self._hooked: set = set()                # guarded-by: _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        vmm.autoscaler = self

    # -- subscription ---------------------------------------------------
    def watch(self, tenant, state_template=None, shardings_fn=None):
        """Start consuming ``tenant``'s degradation IRQs. Chains any
        previously installed IRQ_DEGRADED handler. Idempotent: a
        re-watch (e.g. to refresh the state template) replaces the
        watch record without chaining our own handler into itself."""
        w = _Watch(tenant=tenant, baseline=tuple(tenant.vslice.spec.shape),
                   state_template=state_template, shardings_fn=shardings_fn)
        with self._lock:
            self._watched[tenant.name] = w
            hook = tenant.name not in self._hooked
            if hook:
                self._hooked.add(tenant.name)
        if hook:
            prev = tenant.cq.handlers.get(IRQ_DEGRADED)

            def handler(ev, _name=tenant.name, _prev=prev):
                self._on_irq(_name, ev)   # no-op if no longer watched
                if _prev is not None:
                    _prev(ev)

            tenant.cq.set_irq(IRQ_DEGRADED, handler)
        return w

    def unwatch(self, name: str):
        with self._lock:
            self._watched.pop(name, None)

    def _on_irq(self, name: str, ev):
        if ev.kind not in PRESSURE_KINDS:
            return
        now = self.time_fn()
        with self._lock:
            w = self._watched.get(name)
            if w is None:
                return
            w.events.append((now, ev.kind))
            w.last_event = now

    # -- control loop ---------------------------------------------------
    def poll(self, now: Optional[float] = None) -> List[dict]:
        """Evaluate every watched tenant once; perform at most one
        scaling action per tenant. Returns the actions taken."""
        now = self.time_fn() if now is None else now
        taken = []
        with self._lock:
            watches = list(self._watched.values())
        for w in watches:
            with self._lock:
                while w.events and now - w.events[0][0] > self.window_s:
                    w.events.popleft()
                n_events = len(w.events)
                last_event, last_action = w.last_event, w.last_action
            if now - last_action < self.cooldown_s:
                continue
            act = None
            try:
                if n_events >= self.sustain:
                    act = self._grow(w, now, n_events)
                elif (self.scale_down and w.history
                        and now - last_event >= self.calm_s):
                    act = self._shrink(w, now)
            except Exception as exc:       # noqa: BLE001
                # a resize can fail beyond AdmissionError (re-bind,
                # checkpoint I/O, ...) — record it and keep the control
                # loop alive rather than silently killing the thread
                act = self._record(w, now, action="error",
                                   error=f"{type(exc).__name__}: {exc}")
            if act is not None:
                taken.append(act)
        return taken

    def _candidates(self, shape: Tuple[int, int]) -> List[Tuple[int, int]]:
        r, c = shape
        fp = self.vmm.floorplanner
        cap = self.max_devices or fp.rows * fp.cols
        cands = [(r, 2 * c), (2 * r, c)]
        return [(nr, nc) for nr, nc in cands
                if nr <= fp.rows and nc <= fp.cols and nr * nc <= cap]

    def _resize(self, w: _Watch, shape: Tuple[int, int]) -> bool:
        try:
            resize(self.vmm, w.tenant, shape,
                   state_template=w.state_template,
                   shardings_fn=w.shardings_fn)
            return True
        except AdmissionError:
            return False

    def _record(self, w: _Watch, now: float, **fields) -> dict:
        act = {"t": now, "tenant": w.tenant.name, **fields}
        with self._lock:
            self.actions.append(act)
            w.last_action = now
            w.events.clear()
        obs = getattr(self.vmm, "obs", None)
        if obs is not None and obs.enabled:
            obs.count("autoscaler_actions_total", tenant=w.tenant.name,
                      action=fields.get("action", "unknown"))
            # grow_blocked is a flight-recorder trigger — the dump shows
            # the IRQ pressure that led to the unplaceable resize
            obs.flight_record(w.tenant.name, fields.get("action", "action"),
                              {k: v for k, v in act.items() if k != "tenant"})
        return act

    def _grow(self, w: _Watch, now: float, n_events: int) -> Optional[dict]:
        old = tuple(w.tenant.vslice.spec.shape)
        cands = self._candidates(old)
        if not cands:
            if self.swap_cb is not None:
                note_callback("autoscaler.swap_cb")
            if self.swap_cb is not None and self.swap_cb(w.tenant.name):
                return self._record(w, now, action="swap_relief", frm=old,
                                    to=None, pressure_events=n_events,
                                    reason="at capacity")
            return self._record(w, now, action="grow_blocked", frm=old,
                                to=None, pressure_events=n_events,
                                reason="at capacity")
        for shape in cands:
            if self._resize(w, shape):
                w.history.append(old)
                return self._record(w, now, action="grow", frm=old,
                                    to=shape, pressure_events=n_events)
        # nothing placed: defragment the floorplan and retry the
        # preferred candidate once
        defragment(self.vmm)
        if self._resize(w, cands[0]):
            w.history.append(old)
            return self._record(w, now, action="grow", frm=old,
                                to=cands[0], pressure_events=n_events,
                                defragmented=True)
        if self.swap_cb is not None:
            note_callback("autoscaler.swap_cb")
        if self.swap_cb is not None and self.swap_cb(w.tenant.name):
            # device capacity is exhausted but the KV swap tier absorbed
            # the pressure (a victim slot parked to host memory) — the
            # tenant keeps serving instead of waiting out the block
            return self._record(w, now, action="swap_relief", frm=old,
                                to=cands[0], pressure_events=n_events,
                                reason="swapped under capacity block")
        return self._record(w, now, action="grow_blocked", frm=old,
                            to=cands[0], pressure_events=n_events,
                            reason="no slice even after defrag")

    def _shrink(self, w: _Watch, now: float) -> Optional[dict]:
        old = tuple(w.tenant.vslice.spec.shape)
        target = w.history[-1]
        if self._resize(w, target):
            w.history.pop()
            return self._record(w, now, action="shrink", frm=old,
                                to=target)
        return self._record(w, now, action="shrink_blocked", frm=old,
                            to=target)

    # -- background driver ----------------------------------------------
    def start(self, interval_s: float = 0.25):
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                self.poll()
                self._stop.wait(interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    # -- introspection ---------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "watched": {
                    n: {"baseline": list(w.baseline),
                        "shape": list(w.tenant.vslice.spec.shape),
                        "pending_events": len(w.events),
                        "grows_outstanding": len(w.history)}
                    for n, w in self._watched.items()},
                "actions": [dict(a) for a in self.actions],
            }
