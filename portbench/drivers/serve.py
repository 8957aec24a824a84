"""Serving cells: ``repro_torch.serving.ServeEngine`` on a one-slice VMM
tenant under the ``hybrid`` policy (``launch/serve.py``'s
``virtual_server`` and ``virtualized_engine_kw``), so that every prefill
and decode runs through ``tenant.device.run`` and every page is leased
from the tenant's MMU pool.

The traffic mix is ``open`` (requests due at fixed offsets; each timed
from its due time to the engine step in which its first token appeared;
with ``after_close`` "wait", the default, each request due in the window
is waited for up to a minute past the close, with "stop" — a cell above
the knee, judged by the tokens it serves — the run ends at the close)
or ``closed`` (clients that each send their next request when the last
one finishes; with ``first_turns_in_setup``, the clients' first requests
are prefilled in set-up, else the window opens on them fresh). After the
window: the card's peak memory is read, the
program's state is freed, and a sample of the finished requests, drawn
from the seed with the longest among them, goes to the plain reference.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np

from portbench import generator, harness, weights
from portbench.counts import model as model_counts
from portbench.reference import model as ref
from portbench.trace import TRACE_SECONDS, DeviceTrace, Spans


class Calls:
    """The harness's record of each program call: its kind, its work
    (from shapes, on the host), the host time of the tenant's run and of
    the program inside it, and, in a traced run, the time of the call
    between two synchronisations."""

    def __init__(self, arch, conf, spans, sync):
        self.arch, self.conf = arch, conf
        self.spans = spans
        self.sync = sync
        self.on = False
        self.flops = 0
        self.rows = []          # (kind, tokens, tenant s, program s, t0, t1)
        self.engine = None
        self._decode = {}       # position → a decode token's FLOPs there

    def _work(self, kind, a):
        arch, conf = self.arch, self.conf
        if kind == "prefill":
            n = int(a[1]["tokens"].shape[1])
            return n, model_counts.forward_flops(arch, conf, n, 0)
        if kind == "prefill_chunk_paged":
            n = int(a[2].shape[1])
            return n, model_counts.forward_flops(arch, conf, n, int(a[5]))
        pos = self.engine.positions
        live = pos[pos >= 0].tolist()
        for p in live:
            if p not in self._decode:
                self._decode[p] = model_counts.forward_flops(arch, conf, 1, p)
        return len(live), sum(self._decode[p] for p in live)

    def wrap(self, mediate):
        """``mediate`` (a ``virtualized_engine_kw`` wrap) with the
        harness's spans around the tenant's run and the program."""
        import torch

        def wrap(fn):
            kind = fn.__name__
            inner_s = [0.0]

            def program(*a):
                t0 = time.monotonic()
                out = fn(*a)
                inner_s[0] = time.monotonic() - t0
                return out
            routed = mediate(program)

            def call(*a):
                n, flops = self._work(kind, a)
                if self.sync:
                    torch.cuda.synchronize()
                t0 = time.monotonic()
                out = routed(*a)
                t1 = time.monotonic()
                if self.sync:
                    torch.cuda.synchronize()
                t2 = time.monotonic()
                if self.on:
                    self.flops += flops
                    self.rows.append((kind, n, t1 - t0, inner_s[0], t0, t2))
                self.spans.add(f"tenant:{kind}", t0, t1)
                self.spans.add(f"call:{kind}", t0, t2)
                return out
            return call
        return wrap


def _warm(engine, params, mix, vocab):
    """The cell's shapes once: the longest and the shortest prompt, a
    few decode steps at the cell's batch."""
    for plen, new in mix["warmup"]:
        engine.submit(np.arange(plen) % vocab, max_new_tokens=new)
    while engine.has_work():
        engine.step(params)


def _requests(mix, seed, seconds, vocab):
    if mix["loop"] == "open":
        arr = generator.open_arrivals(mix, seed, seconds)
        return [(due, generator.request_tokens(seed, i, p, vocab), o)
                for i, (due, p, o) in enumerate(arr)]
    return None


def run(ctx, check=True):
    """``check`` False (the knee sweep) skips the reference."""
    import torch
    from repro_torch.launch.serve import (virtual_server,
                                          virtualized_engine_kw)
    from repro_torch.models import Model
    from repro_torch.serving import ServeEngine

    cfg, conf, mix, dev = ctx.cfg, ctx.conf, ctx.mix, ctx.device
    on_card = dev.type == "cuda"
    rec = harness.Record()
    rec.ctx = ctx
    spans = rec.spans = Spans(ctx.trace)
    calls = Calls(ctx.arch, conf, spans, ctx.trace and on_card)
    rec.counts["calls"] = calls

    model = Model(cfg, device=dev)
    params = weights.make_tree(ctx.arch, conf, ctx.seed, dev, "serve")
    vmm, tenant = virtual_server(dev, "hybrid")
    kw = virtualized_engine_kw(tenant)
    kw["prefill_wrap"] = calls.wrap(kw["prefill_wrap"])
    kw["decode_wrap"] = calls.wrap(kw["decode_wrap"])
    engine = ServeEngine(cfg, model, mix["slots"], mix["capacity"],
                         page_size=mix["page_size"],
                         chunk_tokens=mix.get("chunk_tokens", 0),
                         state_paging=True, seed=ctx.seed, **kw)
    calls.engine = engine
    _warm(engine, params, mix, cfg.vocab)
    dtrace = DeviceTrace(dev) if ctx.trace and on_card else None
    if dtrace is not None:
        dtrace.open()
    opened = _requests(mix, ctx.seed, ctx.seconds, cfg.vocab)
    pool = None if opened is not None else generator.closed_pool(mix,
                                                                 ctx.seed)
    if on_card:
        torch.cuda.synchronize(dev)
    gc.collect()

    info = {}           # rid → dict(index, due, max_new, prompt, first)
    done = []
    steps = []          # (t0, t1, generated tokens after the step)
    waiting_first = set()
    nxt = 0
    traced = False

    def submit(index, prompt, new, due):
        rid = engine.submit(prompt, max_new_tokens=new, temperature=0.0)
        info[rid] = {"index": index, "due": due, "max_new": new,
                     "prompt": prompt, "first": None}
        waiting_first.add(rid)

    def client_next(index):
        """A closed-loop client's next request (pool index)."""
        plen, new = pool[index]
        submit(index, generator.request_tokens(ctx.seed, index, plen,
                                               cfg.vocab), new,
               time.monotonic())

    def one_step():
        t0 = time.monotonic()
        finished = engine.step(params)
        t1 = time.monotonic()
        spans.add("engine step", t0, t1)
        steps.append((t0, t1, engine.stats.generated_tokens))
        for r in [s for s in engine.slots if s is not None] + finished:
            if r.rid in waiting_first and r.out_tokens:
                info[r.rid]["first"] = t1
                waiting_first.discard(r.rid)
        for r in finished:
            info[r.rid]["done"] = t1
            if pool is not None and t1 < end:
                client_next(info[r.rid]["index"] + mix["clients"])
        done.extend(finished)

    end = math.inf      # the closed loop's clients go on until the close
    if pool is not None:
        for c in range(mix["clients"]):
            client_next(c)
        # prefilled in set-up, the window opens on every client decoding
        while mix.get("first_turns_in_setup") and waiting_first:
            one_step()
    if on_card:
        torch.cuda.synchronize(dev)

    # ---- the window ------------------------------------------------
    stats0 = dict(engine.stats.__dict__)
    t_start = time.monotonic()
    rec.e2e["setup_s"] = t_start - ctx.t_process
    end = t_start + ctx.seconds
    trace_from = end - min(TRACE_SECONDS, ctx.seconds)
    calls.on = True
    n_setup_steps = len(steps)

    while True:
        t = time.monotonic()
        if t >= end:
            break
        if dtrace is not None and not traced and t >= trace_from:
            dtrace.start()
            traced = True
        if opened is not None:
            while nxt < len(opened) and t_start + opened[nxt][0] <= t:
                due, prompt, new = opened[nxt]
                submit(nxt, prompt, new, t_start + due)
                nxt += 1
        if engine.has_work():
            one_step()
        elif opened is not None and nxt < len(opened):
            time.sleep(max(0.0, min(t_start + opened[nxt][0], end)
                           - time.monotonic()))
    calls.on = False
    if traced:
        dtrace.stop()
    stats1 = dict(engine.stats.__dict__)
    rec.counts["backlog_at_close"] = len(waiting_first)
    if opened is not None and mix.get("after_close", "wait") == "wait":
        # the requests due before the close: submitted late if need be;
        # each is waited for up to a minute past the close
        for i in range(nxt, len(opened)):
            due, prompt, new = opened[i]
            submit(i, prompt, new, t_start + due)
        while waiting_first and time.monotonic() < end + 60.0:
            one_step()
    if on_card:
        torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    # ---- end-to-end metrics -----------------------------------------
    in_window = [s for s in steps[n_setup_steps:] if s[1] <= end]
    emitted = (in_window[-1][2] if in_window else stats0["generated_tokens"]
               ) - stats0["generated_tokens"]
    rec.attempted = len(info)
    truncated = sum(1 for r in done if len(r.out_tokens) < r.max_new_tokens)
    if opened is not None and mix.get("after_close", "wait") == "wait":
        ttft = [(v["first"] - v["due"]) if v["first"] is not None
                else math.inf for v in info.values()]
        rec.failed = sum(1 for x in ttft if x == math.inf) + truncated
        rec.e2e["ttft_p90_ms"] = 1e3 * harness.quantile(ttft, 0.90)
        rec.e2e["ttft_p95_ms"] = 1e3 * harness.quantile(ttft, 0.95)
        rec.counts["ttft_s"] = ttft
    else:
        rec.failed = truncated
    rec.e2e["serve_tok_s"] = emitted / ctx.seconds
    rec.counts.update(
        window=(t_start, end), steps=in_window, stats0=stats0,
        stats1=stats1, info=info, flops=calls.flops,
        completed=sum(1 for r in done if info[r.rid]["done"] <= end))
    rec.trace = dtrace.read(spans) if traced else None
    if traced:
        rec.notes.append(dtrace.note)
    rec.device = harness.device_info(dev, peak)

    # ---- correctness: the reference over a sample -----------------------
    sample = rec.counts["sample"] = _sample(done, ctx.seed,
                                            mix["check"]["requests"], info)
    calls.engine = None
    del engine, params, kw
    vmm.shutdown()
    if not check:
        return rec
    del vmm, tenant
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    readings = {"served_logit_gap": _widest_gap(ctx.arch, conf, ctx.seed,
                                                dev, sample)}
    rec.correct, rec.checks = harness.judge(readings, ctx.limits)
    rec.correct = rec.correct and bool(sample)
    return rec


def _sample(done, seed, k, info):
    """The finished request with the longest context and k - 1 others
    drawn from the seed → [(prompt, served tokens)]."""
    full = [r for r in done if r.out_tokens]
    if not full:
        return []
    longest = max(full, key=lambda r: len(r.prompt) + len(r.out_tokens))
    rest = [r for r in full if r is not longest]
    rng = np.random.default_rng([int(seed), 5])
    pick = [rest[i] for i in rng.permutation(len(rest))[:k - 1]]
    return [(np.asarray(r.prompt).tolist(), list(r.out_tokens))
            for r in [longest] + pick]


def reference_top(arch, conf, seed, device):
    top = {}
    for name in arch.top_groups(conf):
        top.update(weights.make_top(arch, conf, seed, name, device, "serve"))
    return top


def _widest_gap(arch, conf, seed, device, sample):
    """The widest gap, over every served token of the sample, between
    the reference's best logit and its logit of the served token."""
    if not sample:
        return None
    top = reference_top(arch, conf, seed, device)
    gaps = ref.served_gaps(
        arch, conf,
        lambda i: weights.make_layer(arch, conf, seed, i, device, "serve"),
        top, sample)
    return float(max(g.max() for g in gaps))
