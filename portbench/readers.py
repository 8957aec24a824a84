"""The arithmetic of the per-layer metrics, from a run's record: the
harness's host spans and call rows, the engine's counters and the
profiler trace. Each ``portbench/metrics/<name>.py``
calls one of these. A reader that finds nothing to read returns None,
and the harness leaves the metric out of the result."""
from __future__ import annotations

import statistics

from portbench.counts import peaks


def _calls(rec, kind=None):
    calls = rec.counts.get("calls")
    if calls is None:
        return []
    return [r for r in calls.rows if kind is None or r[0] == kind]


def vmm_tax_us(rec):
    """Mean host time, per data-plane op in the window, of the tenant's
    run less the program it ran (µs)."""
    if "tax" in rec.counts:
        taxes = rec.counts["tax"]
    else:
        taxes = [r[2] - r[3] for r in _calls(rec)]
    return 1e6 * statistics.fmean(taxes) if taxes else None


def engine_step_ms(rec):
    """The window over the engine steps that ended in it (ms)."""
    n = len(rec.counts.get("steps", ()))
    return 1e3 * rec.ctx.seconds / n if n else None


def page_faults_per_req(rec):
    """The engine's page faults in the window over the requests that
    completed in it."""
    c = rec.counts
    if not c.get("completed"):
        return None
    return (c["stats1"]["page_faults"] - c["stats0"]["page_faults"]) \
        / c["completed"]


def call_ms_per_ktok(rec, kind):
    """Time of the ``kind`` calls between two synchronisations, per 1000
    of their tokens (ms)."""
    rows = _calls(rec, kind)
    tok = sum(r[1] for r in rows)
    return 1e6 * sum(r[5] - r[4] for r in rows) / tok if tok else None


def call_ms(rec, kind):
    """Mean time of a ``kind`` call between two synchronisations (ms)."""
    rows = _calls(rec, kind)
    return 1e3 * statistics.fmean(r[5] - r[4] for r in rows) if rows \
        else None


def mixer_bwd_share(rec):
    """Share of the traced device time spent under the backward of the
    family's mixer node (its ``MIXER_NODE``: ``_Flash``, ``_Wkv``), %."""
    tr = rec.trace
    if tr is None or not tr.busy_s:
        return None
    s = tr.autograd_device_s(rec.ctx.arch.MIXER_NODE)
    return 100.0 * s / tr.busy_s if s else None


def idle_share(rec):
    """Share of the traced window in which no operation ran on the card,
    %."""
    tr = rec.trace
    if tr is None or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline(rec, kernel, bound_s, call_kind=None):
    """A kernel's share of its roofline over the traced window: the sum
    of each of its launches' least time over their device time, %. With
    ``call_kind`` each launch is bounded by the work of the harness's
    call it ran in (``bound_s(conf, tokens)``), else every launch by the
    cell's shape (``bound_s(conf, mix)``). None without a launch."""
    tr = rec.trace
    if tr is None:
        return None
    dur, rows = tr.kernel_time(kernel)
    if not dur:
        return None
    conf = rec.ctx.conf
    if call_kind is None:
        return 100.0 * len(rows) * bound_s(conf, rec.ctx.mix) / dur
    calls = _calls(rec, call_kind)
    bound, matched = 0.0, 0.0
    for _, a, b in rows:
        mid = 0.5 * (a + b)
        owner = [r for r in calls if r[4] <= mid <= r[5]]
        if owner:
            bound += bound_s(conf, owner[0][1])
            matched += b - a
    rec.notes.append(f"{kernel}: {len(rows)} launches traced, "
                     f"{matched / dur:.4f} of their time matched to a "
                     f"{call_kind} call")
    return 100.0 * bound / matched if matched else None


def mfu_busy_steps(rec):
    """Model FLOPs of the window's work over the time of the engine steps
    that did it, against the bf16 peak, %."""
    steps = rec.counts.get("steps")
    if not steps:
        return None
    busy = sum(t1 - t0 for t0, t1, _ in steps)
    return 100.0 * rec.counts["flops"] / (busy * peaks.BF16_FLOPS)


def mfu_window(rec):
    """Model FLOPs of the window's work over the window, against the
    bf16 peak, %."""
    if not rec.counts.get("flops"):
        return None
    t0, _ = rec.counts["window"]
    span = rec.ctx.seconds
    if "step_ends" in rec.counts:
        ends = [t for t in rec.counts["step_ends"]
                if t <= rec.counts["window"][1]]
        span = ends[-1] - t0
    return 100.0 * rec.counts["flops"] / (span * peaks.BF16_FLOPS)
