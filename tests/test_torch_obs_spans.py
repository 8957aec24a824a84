"""The telemetry plane's span timeline (``repro_torch.obs.spans``): the
ring and its counts, nesting per thread, the clock, the cost while off,
the span tree the engine, the VMM, the model and the train step record
through a ``hybrid`` tenant, the routing of the host's sync warnings, and
the timers that share the spans' clock reads. Also the op log's bounded
data-plane ring, whose counts stay exact."""
import inspect
import math
import os
import sys
import threading
import time
import tracemalloc
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.core import ProgramRequest
from repro_torch.core.interposition import OpLog
from repro_torch.launch.serve import virtual_server, virtualized_engine_kw
from repro_torch.models import Model
from repro_torch.obs import ObsHub, spans
from repro_torch.serving import ServeEngine

torch.set_num_threads(2)


@pytest.fixture
def hub():
    h = ObsHub(enabled=True).activate()
    yield h
    h.deactivate()


def _tree(r):
    """→ [(name, key, tag, parent name or None)] in record order."""
    out = []
    for i in range(len(r)):
        p = r.row_of(r.parent[i]) if r.parent[i] else None
        out.append((r.name_of(i), int(r.key[i]), r.names[r.tag[i]],
                    None if p is None else r.name_of(p)))
    return out


# -- the timeline ----------------------------------------------------------
def test_ring_keeps_the_newest_and_counts_what_it_dropped():
    tl = spans.SpanTimeline(capacity=8)
    tl._allocate()
    for k in range(20):
        tl.close(tl.open("s", k))
    r = tl.records()
    assert (tl.written, tl.dropped, r.dropped) == (20, 12, 12)
    assert list(r.ids) == list(range(13, 21))
    assert list(r.key) == list(range(12, 20))
    assert not np.isnan(r.t1).any()


def test_nesting_instants_and_self_time():
    tl = spans.SpanTimeline(capacity=64)
    tl._allocate()
    a = tl.open("outer", 7)
    b = tl.open("inner", tag="x")
    time.sleep(0.002)
    tl.instant("sync")
    tl.close(b)
    c = tl.open("inner")
    tl.close(c)
    tl.close(a)
    r = tl.records()
    assert _tree(r) == [("outer", 7, "", None), ("inner", -1, "x", "outer"),
                        ("sync", -1, "", "inner"), ("inner", -1, "", "outer")]
    outer = r.select("outer")
    kids = r.children_time(outer, "inner")
    inner = r.select("inner")
    assert kids[0] == pytest.approx(float((r.t1[inner] - r.t0[inner]).sum()))
    assert 0.002 <= kids[0] < r.t1[outer[0]] - r.t0[outer[0]]
    assert list(r.select("sync", kind=spans.KIND_INSTANT)) == [2]


def test_close_pops_spans_an_exception_left_open():
    tl = spans.SpanTimeline(capacity=16)
    tl._allocate()
    a = tl.open("a")
    tl.open("left-open")
    tl.close(a)
    b = tl.open("b")
    tl.close(b)
    r = tl.records()
    assert _tree(r)[2] == ("b", -1, "", None)
    assert math.isnan(r.t1[1]) and not r.spans()[0][0] == "left-open"


def test_spans_are_on_the_monotonic_clock():
    tl = spans.SpanTimeline(capacity=4)
    tl._allocate()
    t0 = time.monotonic()
    tl.close(tl.open("s"))
    t1 = time.monotonic()
    r = tl.records()
    assert t0 <= r.t0[0] <= r.t1[0] <= t1


def test_threads_record_whole_and_nest_on_their_own():
    # more threads than cores, switching often: a lost update of the
    # shared count or a parent taken from another thread shows below
    n, per = min(16, (os.cpu_count() or 2) + 2), 250
    tl = spans.SpanTimeline(capacity=2 * n * per)
    tl._allocate()
    together = threading.Barrier(n, timeout=30)

    def work(k):
        together.wait()
        for j in range(per):
            o = tl.open("outer", k)
            tl.close(tl.open("inner", k))
            tl.close(o)
        together.wait()             # none ends (and lends its id) early
    threads = [threading.Thread(target=work, args=(k,)) for k in range(n)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    r = tl.records()
    assert tl.written == len(r) == 2 * n * per and r.dropped == 0
    for i in r.select("inner"):
        p = r.row_of(r.parent[i])
        assert r.name_of(p) == "outer"
        assert r.key[p] == r.key[i] and r.thread[p] == r.thread[i]
    assert len(set(r.thread.tolist())) == n


def _peak_bytes(fn, n=1000):
    """Traced memory's peak over ``n`` calls of ``fn`` above where it
    started: an object made and freed each call still raises it."""
    tracemalloc.start()
    try:
        fn()
        tracemalloc.reset_peak()
        cur = tracemalloc.get_traced_memory()[0]
        for _ in range(n):
            fn()
        return tracemalloc.get_traced_memory()[1] - cur
    finally:
        tracemalloc.stop()


def off_sites():
    tl = spans.ACTIVE
    sid = tl.open("x", 3) if tl is not None else 0
    if sid:
        tl.close(sid)


def test_off_records_nothing_and_allocates_nothing():
    assert spans.ACTIVE is None
    hub = ObsHub(enabled=False)
    assert hub.spans._t0 is None            # no ring until activated
    # a site's off path: one check, no object made (a `with` block would
    # make a bound method a call, which this measure sees)
    assert _peak_bytes(off_sites) <= _peak_bytes(lambda: None)
    # the real sites, over engine steps and a train step: no function of
    # the timeline's runs (so none allocates)
    cfg, vmm, eng, params = _engine("qwen1.5-0.5b", 0, None)
    mon = sys.monitoring
    tool = next(i for i in range(6) if mon.get_tool(i) is None)
    mon.use_tool_id(tool, "spans-off")
    codes = [f.__code__ for f in vars(spans).values()
             if inspect.isfunction(f)] + [
        f.__code__ for f in vars(spans.SpanTimeline).values()
        if inspect.isfunction(f)]
    calls = []
    mon.register_callback(tool, mon.events.PY_START,
                          lambda code, off: calls.append(code.co_name))
    for c in codes:
        mon.set_local_events(tool, c, mon.events.PY_START)
    try:
        eng.submit(np.arange(9) % cfg.vocab, max_new_tokens=3)
        eng.run_round(params)
        _train_step(vmm.tenants["server"], cfg)
    finally:
        for c in codes:
            mon.set_local_events(tool, c, 0)
        mon.free_tool_id(tool)
        vmm.shutdown()
    assert len(codes) > 10 and calls == []
    assert hub.spans.written == 0


# -- the sync counter ----------------------------------------------------------
def test_sync_warnings_become_instants_under_the_open_span(monkeypatch):
    shown = []
    monkeypatch.setattr(warnings, "showwarning",
                        lambda *a, **kw: shown.append(str(a[0])))
    filters = warnings.filters[:]
    hub = ObsHub(enabled=False).activate()
    try:
        tl = hub.spans
        sid = tl.open("engine.upload")
        for _ in range(3):          # one line three times: none deduplicated
            warnings.warn(spans.SYNC_WARNING, UserWarning)
        tl.close(sid)
        warnings.warn("something else", UserWarning)
    finally:
        hub.deactivate()
    r = hub.spans.records()
    syncs = r.select(spans.SYNC, kind=spans.KIND_INSTANT)
    assert len(syncs) == 3
    assert {r.name_of(r.row_of(r.parent[i])) for i in syncs} == \
        {"engine.upload"}
    assert shown == ["something else"]
    assert spans.ACTIVE is None and warnings.filters == filters
    warnings.warn(spans.SYNC_WARNING, UserWarning)
    assert shown[-1] == spans.SYNC_WARNING       # shown again once off


def test_one_timeline_active_at_a_time(hub):
    with pytest.raises(RuntimeError):
        ObsHub().activate()


# -- the sites, through a hybrid tenant ------------------------------------
def _engine(arch, chunk, obs):
    cfg = get_config(arch, reduced=True)
    m = Model(cfg, device="cpu")
    params = m.init_compute_params(torch.Generator().manual_seed(0))
    vmm, tenant = virtual_server("cpu", "hybrid", obs=obs)
    eng = ServeEngine(cfg, m, 2, 64, page_size=8, chunk_tokens=chunk,
                      state_paging=True, obs=obs,
                      **virtualized_engine_kw(tenant))
    return cfg, vmm, eng, params


@pytest.mark.parametrize("arch,chunk,prefill,decode", [
    ("qwen1.5-0.5b", 0, "model.prefill", "model.decode_paged"),
    ("rwkv6-7b", 8, "model.prefill_chunk_paged",
     "model.decode_paged_fused")])
def test_engine_step_span_tree(hub, arch, chunk, prefill, decode):
    cfg, vmm, eng, params = _engine(arch, chunk, hub)
    try:
        rid = eng.submit(np.arange(11) % cfg.vocab, max_new_tokens=3)
        eng.run_round(params)
    finally:
        vmm.shutdown()
    r = hub.spans.records()
    tree = _tree(r)
    names = {t[0] for t in tree}
    assert {"engine.step", "engine.admit", "engine.lease", "engine.upload",
            "engine.readback", "engine.sample", "engine.release",
            "plane.run", "tenant.program", "vmm.irq", prefill, decode,
            "model.embed", "model.layer", "model.head",
            "model.prep"} <= names
    parent = {(n, p) for n, _, _, p in tree}
    assert {("engine.admit", "engine.step"), ("plane.run", "engine.step"),
            ("tenant.program", "plane.run"), ("vmm.irq", "plane.run"),
            (prefill, "tenant.program"), ("model.layer", prefill),
            ("model.prep", "model.decode_paged"),
            ("model.layer", "model.decode_paged"),
            ("model.head", "model.decode_paged"),
            ("engine.upload", "engine.step")} <= parent
    if chunk:
        assert {("model.decode_paged", decode),
                ("model.sample", decode)} <= parent
    else:
        assert {("engine.lease", "engine.admit"),
                (decode, "tenant.program")} <= parent
    # one layer span per layer and call, keyed by its index, tagged
    # with its mixer
    first = r.ids[r.select("model.decode_paged")[0]]
    layers = [(int(r.key[i]), r.names[r.tag[i]])
              for i in r.select("model.layer") if r.parent[i] == first]
    assert layers == [(i, s.mixer) for i, s in enumerate(eng.model.specs)]
    # the request's spans carry its rid, as its tracer chain does
    keyed = {n for n, k, _, _ in tree if k == rid
             and n in ("engine.admit", "engine.lease", "engine.release")}
    assert keyed == {"engine.admit", "engine.lease", "engine.release"}
    assert [s.rid for s in hub.tracer.spans()] == [rid]


def _train_step(tenant, cfg):
    """One train step of ``cfg`` (reduced) through ``tenant``'s program."""
    from repro_torch import optim
    from repro_torch.bridge import batch_from_numpy
    from repro_torch.data import pipeline_for
    cell = ShapeCell("t", 16, 2, "train")
    tenant.device.reprogram(ProgramRequest(
        arch=cfg.name, kind="train", seq_len=16, global_batch=2))
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    state = optim.init(optim.OptConfig(), params)
    batch = batch_from_numpy(pipeline_for(cfg, cell).batch(0))
    return tenant.device.run(params, state, batch)


@pytest.mark.parametrize("arch,mixer", [("qwen1.5-0.5b", "attn"),
                                        ("rwkv6-7b", "rwkv")])
def test_train_step_span_tree(hub, arch, mixer):
    cfg = get_config(arch, reduced=True)
    vmm, tenant = virtual_server("cpu", "hybrid")
    try:
        _train_step(tenant, cfg)
    finally:
        vmm.shutdown()
    tree = _tree(hub.spans.records())
    parent = {(n, p) for n, _, _, p in tree}
    assert {("plane.run", None), ("tenant.program", "plane.run"),
            ("train.step", "tenant.program"),
            ("train.forward", "train.step"), ("train.backward", "train.step"),
            ("train.optimizer", "train.step"),
            ("model.embed", "train.forward"),
            ("model.layer", "train.forward"),
            ("model.head", "train.forward")} <= parent
    # the CPU's autograd runs the backward on the calling thread
    bwd = [(tag, p) for n, _, tag, p in tree if n == "mixer.backward"]
    assert bwd and set(bwd) == {(mixer, "train.backward")}


@pytest.mark.parametrize("arch,builds", [("rwkv6-7b", [1, 0]),
                                         ("qwen1.5-0.5b", [0, 0])])
def test_pos_table_opens_once_in_the_first_step(hub, arch, builds):
    """A model without rope makes its position table in its first
    forward, under ``model.embed``, and slices it after; rope makes
    none."""
    from repro_torch import optim
    from repro_torch.bridge import batch_from_numpy
    from repro_torch.data import pipeline_for
    cfg = get_config(arch, reduced=True)
    cell = ShapeCell("t", 16, 2, "train")
    vmm, tenant = virtual_server("cpu", "hybrid")
    try:
        tenant.device.reprogram(ProgramRequest(
            arch=cfg.name, kind="train", seq_len=16, global_batch=2))
        params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
        state = optim.init(optim.OptConfig(), params)
        data = pipeline_for(cfg, cell)
        for step in range(2):
            params, state, _ = tenant.device.run(
                params, state, batch_from_numpy(data.batch(step)))
    finally:
        vmm.shutdown()
    r = hub.spans.records()
    steps = [int(r.ids[i]) for i in r.select("train.step")]
    assert len(steps) == 2

    def chain(i):
        out = []
        while r.parent[i]:
            i = r.row_of(r.parent[i])
            out.append(i)
        return out
    got = [0, 0]
    for i in r.select("model.pos_table"):
        up = chain(i)
        assert [r.name_of(j) for j in up[:3]] == [
            "model.embed", "train.forward", "train.step"]
        got[steps.index(int(r.ids[up[2]]))] += 1
    assert got == builds


def test_timers_share_the_spans_clock_reads(hub):
    cfg, vmm, eng, params = _engine("qwen1.5-0.5b", 0, hub)
    try:
        eng.submit(np.arange(9) % cfg.vocab, max_new_tokens=4)
        eng.run_round(params)
    finally:
        vmm.shutdown()
    r = hub.spans.records()
    steps = r.select("engine.step")
    h = hub.registry.histogram("engine_step_s", tenant="serve")
    h = h.summary()
    assert h["count"] == len(steps)
    assert h["sum"] == pytest.approx(
        float((r.t1[steps] - r.t0[steps]).sum()), rel=1e-9)
    runs = r.select("plane.run")
    svc = hub.registry.histogram("plane_service_s", tenant="server",
                                 op="run")
    svc = svc.summary()
    assert svc["count"] == len(runs)
    # the service time starts after enter_op, inside the span
    assert 0 < svc["sum"] <= float((r.t1[runs] - r.t0[runs]).sum())


# -- the op log ------------------------------------------------------------
@pytest.mark.parametrize("sampling", [1.0, 0.5])
def test_oplog_data_plane_ring_keeps_exact_counts(sampling, monkeypatch):
    monkeypatch.setattr(OpLog, "DATA_CAPACITY", 16)
    log = OpLog(sample_data_plane=sampling)
    log.end(log.begin("t", "admit"))
    for i in range(100):
        log.end(log.begin("t", "run" if i % 3 else "write"))
    log.end(log.begin("t", "checkpoint"))
    logged = int(100 * sampling)
    assert log.n_records() == 2 + logged
    assert log.completeness() == pytest.approx(sampling)
    assert len(log.records) == 2 + 16
    assert [r.op for r in log.records][0] == "admit"
    assert [r.op for r in log.records][-1] == "checkpoint"
    assert log.ops_seen() == {"admit", "run", "write", "checkpoint"}
    assert len(log.query(op="checkpoint")) == 1
    assert set(log.op_latency_stats()) <= {"admit", "run", "write",
                                           "checkpoint"}
