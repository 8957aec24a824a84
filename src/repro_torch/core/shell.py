"""The shell — the paper's static region, in host-runtime form.

Two components adapted from the paper's hardware shell:

* ``TransferEngine`` — the DMA path. Implements the paper's **VM-copy**
  (guest buffer → pinned host staging → device DMA; two copies) and its
  named-future-work **VM-nocopy** (the guest array is handed to
  ``Tensor.to(device)`` directly). Per-stage timing feeds fig6b's
  overhead breakdown.

* ``CompletionQueue`` — the MSI/IRQ controller. One "MSI line" per slice:
  events from sources are concatenated into a ring buffer, a status word
  marks pending sources, a mask register suppresses sources while the host
  runs the ISR, and ``set_irq``-registered handlers are invoked on
  delivery — mirroring §IV.B's IRQ handler design.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.analysis.lock_watchdog import note_callback


# ===========================================================================
# Transfer engine (DMA)
# ===========================================================================


@dataclass
class TransferStats:
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    guest_copy_ns: int = 0       # guest → staging (VM-copy only)
    dma_ns: int = 0              # staging → device, synchronised
    d2h_ns: int = 0

    def bandwidth_gbps(self):
        t = (self.guest_copy_ns + self.dma_ns) / 1e9
        return self.h2d_bytes / max(t, 1e-12) / 1e9


class TransferEngine:
    """Host↔device data path with VM-copy / VM-nocopy modes.

    VM-copy stages the guest array in one shared byte buffer — pinned
    host memory when the target is a CUDA device — and copies it to the
    device with ``non_blocking=True``. The staging lock is held until the
    copy's stream is synchronised: the next write must not overwrite
    staging while the DMA still reads it. On the CPU the device "copy"
    of a staging view would alias staging, so ``h2d`` clones it there.

    Locking: the byte/nanosecond counters are read-modify-write state
    shared by every concurrent transfer, so *all* updates go through a
    dedicated ``_stats_lock``. The separate ``_lock`` protects only the
    shared staging buffer (VM-copy), so VM-nocopy transfers never
    serialize on the engine.
    """

    def __init__(self, mode: str = "vm_copy", staging_bytes: int = 2 ** 28,
                 obs=None):
        assert mode in ("vm_copy", "vm_nocopy")
        self.mode = mode
        self.stats = TransferStats()
        self.obs = obs
        self._staging_bytes = staging_bytes      # guarded-by: _lock
        self._staging = None                     # guarded-by: _lock
        self._lock = threading.Lock()          # staging buffer only
        self._stats_lock = threading.Lock()    # all counter updates

    def _account_h2d(self, nbytes: int, guest_copy_ns: int, dma_ns: int):
        with self._stats_lock:
            self.stats.guest_copy_ns += guest_copy_ns
            self.stats.dma_ns += dma_ns
            self.stats.h2d_bytes += nbytes
        if self.obs is not None and self.obs.enabled:
            self.obs.count("dma_h2d_bytes_total", nbytes)
            self.obs.observe("dma_h2d_s", (guest_copy_ns + dma_ns) / 1e9)

    def _staging_for(self, nbytes: int,
                     device: torch.device):  # holds: _lock
        pin = device.type == "cuda"
        st = self._staging
        if st is None or st.numel() < nbytes or st.is_pinned() != pin:
            n = max(nbytes, self._staging_bytes)
            self._staging = torch.empty(n, dtype=torch.uint8,
                                        pin_memory=pin)
            self._staging_bytes = n
        return self._staging

    def h2d(self, guest_array: np.ndarray, device=None,
            dtype: torch.dtype = None) -> torch.Tensor:
        """Guest buffer → device tensor. ``device`` None means the card
        (raises when there is none), as for ``jax.device_put`` with no
        target; CPU callers pass ``device="cpu"``. ``dtype=torch.bfloat16``
        takes ``guest_array`` as the int16 bits :meth:`d2h` gives for a
        bf16 tensor and views the result back as bf16."""
        device = _resolve_device(device)
        guest_array = np.ascontiguousarray(guest_array)
        if dtype == torch.bfloat16 and guest_array.dtype != np.int16:
            raise ValueError("a bf16 tensor crosses as int16 bits, got "
                             f"{guest_array.dtype}")
        nbytes = guest_array.nbytes
        if self.mode == "vm_copy":
            # the staging buffer is shared: hold its lock from the copy
            # until the DMA out of it has finished
            with self._lock:
                t0 = time.perf_counter_ns()
                raw = self._staging_for(nbytes, device)[:nbytes]
                raw.numpy()[:] = guest_array.reshape(-1).view(np.uint8)
                staged = raw.view(_torch_dtype(guest_array.dtype)).reshape(
                    guest_array.shape)
                t1 = time.perf_counter_ns()
                if device.type == "cpu":
                    out = staged.clone()         # never a view of staging
                else:
                    out = staged.to(device, non_blocking=True)
                    torch.cuda.current_stream(device).synchronize()
                t2 = time.perf_counter_ns()
            self._account_h2d(nbytes, t1 - t0, t2 - t1)
        else:
            t1 = time.perf_counter_ns()
            out = torch.from_numpy(guest_array).to(device)
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
            t2 = time.perf_counter_ns()
            self._account_h2d(nbytes, 0, t2 - t1)
        return out.view(dtype) if dtype == torch.bfloat16 else out

    def d2h(self, device_array: torch.Tensor) -> np.ndarray:
        """Device tensor → host array. numpy has no bfloat16, so a bf16
        tensor crosses as its int16 bits (``h2d(..., dtype=torch.bfloat16)``
        views them back)."""
        t0 = time.perf_counter_ns()
        if device_array.device.type == "cuda":
            torch.cuda.current_stream(device_array.device).synchronize()
        t = device_array.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        out = t.cpu().numpy()
        dt = time.perf_counter_ns() - t0
        with self._stats_lock:
            self.stats.d2h_ns += dt
            self.stats.d2h_bytes += out.nbytes
        if self.obs is not None and self.obs.enabled:
            self.obs.count("dma_d2h_bytes_total", out.nbytes)
            self.obs.observe("dma_d2h_s", dt / 1e9)
        return out


def _resolve_device(device=None) -> torch.device:
    """``None`` means the card: raise when there is none rather than run
    on the CPU unasked (the same rule as ``models.resolve_device``; core
    does not import models)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to "
                               "transfer to the CPU")
        device = "cuda"
    return torch.device(device)


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dt)).dtype


# ===========================================================================
# Completion queue (IRQ controller)
# ===========================================================================


@dataclass
class Event:
    """One completion-queue event.

    ``ts`` is ``time.monotonic()`` — the clock every latency consumer
    (scheduler wait math, autoscaler hysteresis windows, the tracer)
    already runs on, so event ages are safe to subtract. ``wall`` is
    wall-clock for display/log correlation only; never do arithmetic
    across the two.
    """
    source: int
    kind: str
    payload: dict = field(default_factory=dict)
    ts: float = field(default_factory=time.monotonic)
    wall: float = field(default_factory=time.time)


class CompletionQueue:
    """Per-slice MSI-style event delivery with status/mask registers."""

    def __init__(self, n_sources: int = 32, depth: int = 1024):
        self.n_sources = n_sources
        self.ring: deque = deque(maxlen=depth)   # guarded-by: _lock
        # pending-source bitmask
        self.status: int = 0                     # guarded-by: _lock
        self.mask: int = 0                       # guarded-by: _lock (1 = suppressed)
        self.handlers: Dict[int, Callable] = {}  # guarded-by: _lock
        self.dropped = 0                         # guarded-by: _lock
        self._lock = threading.Lock()
        # single-deliverer flag
        self._delivering = False                 # guarded-by: _lock

    # -- guest/VMM API ---------------------------------------------------
    def set_irq(self, source: int, handler: Callable):
        with self._lock:
            self.handlers[source] = handler

    def set_mask(self, source: int, masked: bool):
        with self._lock:
            if masked:
                self.mask |= (1 << source)
            else:
                self.mask &= ~(1 << source)
        if not masked:
            self._deliver_pending()

    # -- device side -------------------------------------------------------
    def raise_event(self, source: int, kind: str, payload=None):
        ev = Event(source, kind, payload or {})
        with self._lock:
            if len(self.ring) == self.ring.maxlen:
                self.dropped += 1
            self.ring.append(ev)
            self.status |= (1 << source)
        self._deliver_pending()

    def _deliver_pending(self):
        """Iterative, non-reentrant delivery loop.

        Exactly one thread at a time acts as the deliverer; any call
        arriving while delivery is in progress (a handler unmasking its
        source via ``set_mask``, a handler raising a new event, or a
        concurrent ``raise_event``) returns immediately — the active
        loop re-scans the ring after every handler, so those events are
        still picked up, in ring order, without recursion.
        """
        with self._lock:
            if self._delivering:
                return
            self._delivering = True
        owner = True
        try:
            while True:
                with self._lock:
                    # deliver only unmasked sources WITH a registered
                    # handler — orphan events stay pending (status bit
                    # set) until the host installs an ISR, per the
                    # paper's status-register protocol
                    ev = next((e for e in self.ring
                               if not (self.mask >> e.source) & 1
                               and e.source in self.handlers), None)
                    if ev is None:
                        # clear the flag in the same critical section as
                        # the emptiness check: a concurrent raise_event
                        # either lands before (we'd have found it) or
                        # after (it sees the flag down and delivers)
                        self._delivering = False
                        owner = False
                        return
                    self.ring.remove(ev)
                    self.status = 0
                    for e in self.ring:
                        self.status |= (1 << e.source)
                    h = self.handlers[ev.source]
                    # host ISR: mask the source while the handler runs
                    # (§IV.B) — inline, so the unmask below cannot
                    # recurse back into delivery
                    self.mask |= (1 << ev.source)
                try:
                    # handler runs OUTSIDE the cq lock (user code: obs
                    # providers, autoscaler subscription, test ISRs)
                    note_callback("cq.handler")
                    h(ev)
                finally:
                    with self._lock:
                        self.mask &= ~(1 << ev.source)
        finally:
            # only on the exceptional path: a handler raised before the
            # normal handoff above. An unconditional clear here could
            # stomp a new deliverer that took over after that handoff.
            if owner:
                with self._lock:
                    self._delivering = False

    def pending(self) -> List[Event]:
        with self._lock:
            return list(self.ring)
