"""What a traced run (``--trace 1``) records: the harness's own host spans
around the calls into each layer, and a profiler trace of the card over
the window's last ``TRACE_SECONDS``.

Host spans are ``(name, t0, t1)`` on ``time.monotonic`` (the clock the
port's request tracer stamps), kept in memory. The profiler's kernel
times are put on the same clock through a marker kernel launched on an
idle card right after the host reads its clock, so each idle gap of the
card can be labelled by the innermost host span open at the time.
"""
from __future__ import annotations

import collections
import time

#: the profiled part of a traced run: the last seconds of its window
TRACE_SECONDS = 8.0
_MARKER = "spin_kernel"          # torch.cuda._sleep's kernel


class Spans:
    """Host spans, kept only when ``on``."""

    def __init__(self, on: bool):
        self.on = on
        self.rows = []

    def add(self, name, t0, t1):
        if self.on:
            self.rows.append((name, t0, t1))


class DeviceTrace:
    """A ``torch.profiler`` trace of the card between :meth:`start` and
    :meth:`stop`; ``cpu`` adds the host's ops (needed to attribute
    kernels to an autograd node)."""

    def __init__(self, device, cpu=False):
        self.device = device
        self.cpu = cpu
        self.prof = None
        self.h0 = self.h1 = None
        self.note = None

    def _activities(self):
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CUDA]
        if self.cpu:
            acts.append(ProfilerActivity.CPU)
        return acts

    def open(self):
        """Start the profiler's session in set-up with collection off:
        starting one late in a long run takes seconds (CUPTI's set-up),
        and a second session after an early first one was seen to record
        no device event."""
        from torch.profiler import profile
        self.prof = profile(activities=self._activities())
        self.prof.start()
        self.prof.toggle_collection_dynamic(False, self._activities())

    def start(self):
        import torch
        torch.cuda.synchronize(self.device)
        self.prof.toggle_collection_dynamic(True, self._activities())
        torch.cuda.synchronize(self.device)
        self.h0 = time.monotonic()
        torch.cuda._sleep(1000)

    def stop(self):
        import torch
        torch.cuda.synchronize(self.device)
        self.h1 = time.monotonic()
        self.prof.stop()

    def read(self, spans):
        """→ a :class:`TraceSummary` of the traced interval."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        events = self.prof.events()
        kern = [(e.name, e.time_range.start, e.time_range.end)
                for e in events if e.device_type == cuda]
        marks = [k for k in kern if _MARKER in k[0]]
        self.note = (f"trace: {len(events)} events, {len(kern)} on the "
                     f"card, {len(marks)} markers")
        if not marks:
            return TraceSummary([], self.h0, self.h1, spans, None)
        g0 = min(k[1] for k in marks)
        rows = [(n, self.h0 + (a - g0) / 1e6, self.h0 + (b - g0) / 1e6)
                for n, a, b in kern if _MARKER not in n]
        return TraceSummary(rows, self.h0, self.h1, spans,
                            self.prof if self.cpu else None)


class TraceSummary:
    """Kernels ``(name, t0, t1)`` on the host clock inside [h0, h1]."""

    def __init__(self, kernels, h0, h1, spans, prof):
        self.kernels = [k for k in kernels if k[2] > h0 and k[1] < h1]
        self.h0, self.h1 = h0, h1
        self.spans = spans
        self.prof = prof
        self.window_s = h1 - h0
        self.merged = _merge([(max(a, h0), min(b, h1))
                              for _, a, b in self.kernels])
        self.busy_s = sum(b - a for a, b in self.merged)

    def kernel_time(self, match):
        """Seconds of the kernels whose name contains ``match``, and
        their (name, t0, t1)."""
        rows = [k for k in self.kernels if match in k[0]]
        return sum(b - a for _, a, b in rows), rows

    def device_ops(self, n=10):
        by = collections.Counter()
        for name, a, b in self.kernels:
            by[name[:120]] += b - a
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n=10):
        """Idle time of the card by the innermost host span open in the
        middle of each gap, largest first."""
        by = collections.Counter()
        edges = [self.h0] + [x for ab in self.merged for x in ab] + [self.h1]
        rows = sorted(self.spans.rows, key=lambda r: r[1])
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            open_ = [r for r in rows if r[1] <= mid <= r[2]]
            label = min(open_, key=lambda r: r[2] - r[1])[0] if open_ \
                else "harness loop"
            by[label] += b - a
        return [[k, v] for k, v in by.most_common(n)]

    def autograd_device_s(self, node):
        """Device seconds of the kernels run under the autograd node
        ``node``'s backward (needs a trace with the host's ops)."""
        if self.prof is None:
            return None
        best = 0.0
        for e in self.prof.key_averages():
            if f"{node}Backward" in e.key:
                dev = getattr(e, "device_time_total", None)
                if dev is None:
                    dev = e.cuda_time_total
                best = max(best, dev / 1e6)
        return best


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]
