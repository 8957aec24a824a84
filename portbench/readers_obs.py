"""The arithmetic of the readings taken from the port's own span timeline
(``repro_torch.obs.spans``): a run's record carries the hub it recorded
into as ``rec.obs``. Spans and the profiler's kernels share the host's
monotonic clock (``trace.py`` puts the kernels on it through its
marker), so the card's idle time can be put down to the program span
that was innermost while it lasted.

A reader returns None when there is nothing to read: no hub, no device
trace (``dispatch_idle_share``), or an interval that lost records to the
ring (never a number from part of the records).
"""
from __future__ import annotations

import collections
import heapq

#: prefixes of the spans in which the host enqueues the program's own
#: kernels (the model's layers, the train step, the mixers' backward)
DISPATCH = ("model.", "train.", "mixer.")
#: label of idle time under no program span
NO_SPAN = "(no program span)"


def _records(rec, t0):
    """The hub's records, or None when there is no hub or records opened
    after ``t0`` were lost to the ring."""
    hub = getattr(rec, "obs", None)
    if hub is None:
        return None
    r = hub.spans.records()
    if r.dropped and (not len(r) or r.t0[0] > t0):
        return None
    return r


def _spans_in(r, name, t0, t1):
    """Rows of the closed ``name`` spans that lie inside [t0, t1]."""
    rows = r.select(name)
    keep = (r.t0[rows] >= t0) & (r.t1[rows] <= t1)
    return rows[keep]


def vmm_self_us(rec):
    """Mean host time of a ``plane.run`` span in the window, less the
    ``tenant.program`` inside it: the VMM's own path per op (µs)."""
    t0, t1 = rec.counts["window"]
    r = _records(rec, t0)
    if r is None:
        return None
    rows = _spans_in(r, "plane.run", t0, t1)
    if not len(rows):
        return None
    own = (r.t1[rows] - r.t0[rows]) - r.children_time(rows, "tenant.program")
    return 1e6 * float(own.mean())


def tax_split(rec):
    """Where the harness's tax goes, per op in the window (µs): the
    ``plane.run`` self time, its ``vmm.irq``, and the time of each
    harness ``tenant:*`` span outside its ``plane.run`` (mean, median,
    largest)."""
    t0, t1 = rec.counts["window"]
    r = _records(rec, t0)
    if r is None or rec.spans is None:
        return None
    runs = _spans_in(r, "plane.run", t0, t1)
    if not len(runs):
        return None
    own = (r.t1[runs] - r.t0[runs]) - r.children_time(runs, "tenant.program")
    irq = r.children_time(runs, "vmm.irq")
    a, b = r.t0[runs], r.t1[runs]
    outside = []
    for n, h0, h1 in rec.spans.rows:
        if n.startswith("tenant:") and t0 <= h0 and h1 <= t1:
            inner = (a >= h0) & (b <= h1)
            outside.append(h1 - h0 - float((b[inner] - a[inner]).sum()))
    out = {"plane_self_us": 1e6 * float(own.mean()),
           "irq_us": 1e6 * float(irq.mean())}
    if outside:
        outside = sorted(outside)
        out["outside_plane_us"] = {
            "mean": 1e6 * sum(outside) / len(outside),
            "p50": 1e6 * outside[len(outside) // 2],
            "max": 1e6 * outside[-1]}
    return out


def host_syncs_per_step(rec):
    """Host synchronisations in the window made under a program span
    other than ``engine.step`` itself, per engine or train step."""
    t0, t1 = rec.counts["window"]
    r = _records(rec, t0)
    if r is None:
        return None
    steps = _spans_in(r, "engine.step", t0, t1)
    if not len(steps):
        steps = _spans_in(r, "train.step", t0, t1)
    if not len(steps):
        return None
    n = 0
    for i in r.select("sync", kind=1):
        if not t0 <= r.t0[i] <= t1 or r.parent[i] == 0:
            continue
        p = r.row_of(r.parent[i])
        if p is None or r.name_of(p) != "engine.step":
            n += 1
    return n / len(steps)


def syncs_by_span(rec):
    """Host synchronisations in the window by their innermost open
    program span."""
    t0, t1 = rec.counts["window"]
    r = _records(rec, t0)
    if r is None:
        return None
    by = collections.Counter()
    for i in r.select("sync", kind=1):
        if t0 <= r.t0[i] <= t1:
            p = r.row_of(r.parent[i]) if r.parent[i] else None
            by[NO_SPAN if p is None else r.name_of(p)] += 1
    return dict(by.most_common())


def idle_by_span(busy, h0, h1, spans):
    """Idle time of the card in [h0, h1] (outside the merged ``busy``
    intervals) by the innermost (shortest) span open across every
    thread: ``spans`` [(name, t0, t1)] → {name: seconds}; idle time under
    no span is labelled :data:`NO_SPAN`."""
    events = []
    for k, (name, a, b) in enumerate(spans):
        if b > h0 and a < h1:
            events.append((max(a, h0), 1, k))
            events.append((min(b, h1), 0, k))
    events.sort()
    gaps = []
    edges = [h0] + [x for ab in busy for x in ab] + [h1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    out = collections.Counter()
    heap, live = [], set()
    e, g, t = 0, 0, h0
    while g < len(gaps):
        nxt = events[e][0] if e < len(events) else h1
        # account [t, nxt) to the innermost open span, over the gaps
        while heap and heap[0][1] not in live:
            heapq.heappop(heap)
        label = spans[heap[0][1]][0] if heap else NO_SPAN
        while g < len(gaps) and gaps[g][0] < nxt:
            a, b = max(gaps[g][0], t), min(gaps[g][1], nxt)
            if b > a:
                out[label] += b - a
            if gaps[g][1] <= nxt:
                g += 1
            else:
                break
        if e >= len(events):
            break
        t, opening, k = events[e]
        if opening:
            live.add(k)
            heapq.heappush(heap, (spans[k][2] - spans[k][1], k))
        else:
            live.discard(k)
        e += 1
    return dict(out)


def program_idle(rec):
    """{program span name: idle seconds} over the traced interval, or
    None without a device trace or with records lost."""
    tr = rec.trace
    if tr is None or not tr.window_s:
        return None
    r = _records(rec, tr.h0)
    if r is None:
        return None
    return idle_by_span(tr.merged, tr.h0, tr.h1, r.spans(tr.h0, tr.h1))


def dispatch_idle_share(rec):
    """Share of the traced window in which the card ran nothing while the
    innermost open program span was the model's, the train step's or a
    mixer's backward: the host enqueuing the program's kernels (%).
    Notes the idle time by program span."""
    idle = program_idle(rec)
    if idle is None:
        return None
    tr = rec.trace
    rec.notes.append("idle by program span (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(idle.items(),
                                          key=lambda kv: -kv[1])))
    return 100.0 * sum(v for k, v in idle.items()
                       if k.startswith(DISPATCH)) / tr.window_s


def named_share(rec):
    """Of the idle time that the harness's own spans put under a
    ``tenant:*`` or ``engine step`` span, the share that a program span
    names once the program's spans are laid over them (%)."""
    tr = rec.trace
    if tr is None or rec.spans is None:
        return None
    r = _records(rec, tr.h0)
    if r is None:
        return None
    mark = "harness|"
    harness = [(mark + n, a, b) for n, a, b in rec.spans.rows
               if n.startswith("tenant:") or n == "engine step"]
    alone = idle_by_span(tr.merged, tr.h0, tr.h1, harness)
    both = idle_by_span(tr.merged, tr.h0, tr.h1,
                        harness + r.spans(tr.h0, tr.h1))
    base = sum(v for k, v in alone.items() if k.startswith(mark))
    left = sum(v for k, v in both.items() if k.startswith(mark))
    return 100.0 * (base - left) / base if base else None
