"""The readings taken from the port's span timeline (``readers_obs``,
``obs_run.py``): a tiny traced run of each serving kind and of training
on the CPU reads the VMM's own time and the host's synchronisations a
step, and leaves out the dispatch share, which needs the card's trace;
no hub stays active after a run; the idle-time arithmetic on made-up
intervals; and a reader that lost records to the ring reads nothing."""
import argparse
import math
import time
import types

import pytest
import torch

import portbench_tiny as tiny
from portbench import obs_run, readers_obs
from repro_torch.obs import ObsHub, spans

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("portbench_obs"))


def _run(root, cell, trace, hub=True):
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 29,
                              seconds=1.5, trace=trace)
    return obs_run.run(args, time.monotonic(), hub=hub,
                       device=torch.device("cpu"), root=root)


@pytest.mark.parametrize("cell,sfx", [("sc2-serve-code", "code"),
                                      ("rwkv6-serve-chat", "chat"),
                                      ("sc2-train-4k", "train")])
def test_a_traced_run_reads_the_vmm_and_the_syncs(root, cell, sfx):
    res = _run(root, cell, trace=1)
    obs = res["obs"]
    for name in ("vmm_self_us", "host_syncs_per_step"):
        assert math.isfinite(obs[f"{name}.{sfx}"]), obs
    # the CPU gives no device trace: nothing to put the idle time down to
    assert f"dispatch_idle_share.{sfx}" not in obs
    assert obs["idle_by_program_span_s"] is None
    assert obs["ring"]["dropped"] == 0 and obs["ring"]["written"] > 0
    assert 0 < obs[f"vmm_self_us.{sfx}"] < res["metrics"][
        f"vmm_tax_us.{sfx}"]["value"]
    assert spans.ACTIVE is None


def test_an_untraced_run_leaves_no_hub_active(root):
    res = tiny.run_cell(root, "sc2-serve-code", seconds=1.0)
    assert res["correct"] and spans.ACTIVE is None
    res = _run(root, "sc2-serve-code", trace=0, hub=False)
    assert "obs" not in res and spans.ACTIVE is None


def test_idle_time_goes_to_the_innermost_span_open():
    # the card is busy over [1, 2] and [3, 4] of [0, 6]
    busy = [(1.0, 2.0), (3.0, 4.0)]
    rows = [("outer", 0.5, 5.5),            # main thread
            ("inner", 2.5, 2.75),           # main thread, nested
            ("other", 2.6, 3.5),            # another thread, shorter
            ("late", 4.5, 7.0)]
    got = readers_obs.idle_by_span(busy, 0.0, 6.0, rows)
    # gaps [0, 1], [2, 3], [4, 6]; in each piece the shortest span open
    want = {readers_obs.NO_SPAN: 0.5,     # [0, 0.5]
            "outer": 0.5 + 0.5 + 0.5,     # [0.5, 1], [2, 2.5], [4, 4.5]
            "inner": 0.25,                # [2.5, 2.75], inside other too
            "other": 0.25,                # [2.75, 3]
            "late": 1.5}                  # [4.5, 6], shorter than outer
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v), (k, got)
    assert sum(got.values()) == pytest.approx(6.0 - 2.0)


def _rec(hub, window, trace=None):
    rec = types.SimpleNamespace(obs=hub, counts={"window": window},
                                trace=trace, spans=None, notes=[])
    return rec


def test_a_reader_that_lost_records_reads_nothing():
    hub = ObsHub(enabled=False)
    hub.spans = spans.SpanTimeline(capacity=8)
    hub.activate()
    try:
        t0 = time.monotonic()
        for k in range(6):
            s = hub.spans.open("engine.step", k)
            r = hub.spans.open("plane.run", k)
            hub.spans.close(hub.spans.open("tenant.program", k))
            hub.spans.close(r)
            hub.spans.close(s)
        t1 = time.monotonic()
    finally:
        hub.deactivate()
    assert hub.spans.dropped == 10
    assert readers_obs.vmm_self_us(_rec(hub, (t0, t1))) is None
    assert readers_obs.host_syncs_per_step(_rec(hub, (t0, t1))) is None
    # a window after the lost records is whole
    r = hub.spans.records()
    late = (float(r.t0[0]), t1)
    assert readers_obs.vmm_self_us(_rec(hub, late)) > 0
    assert readers_obs.vmm_self_us(_rec(None, late)) is None


def test_syncs_under_engine_step_itself_or_no_span_are_not_counted():
    hub = ObsHub(enabled=False).activate()
    try:
        tl = hub.spans
        t0 = time.monotonic()
        tl.instant("sync")                  # outside every program span
        for k in range(2):
            s = tl.open("engine.step", k)
            tl.instant("sync")              # the harness's, in the step
            u = tl.open("engine.upload")
            tl.instant("sync")
            tl.instant("sync")
            tl.close(u)
            tl.close(s)
        t1 = time.monotonic()
    finally:
        hub.deactivate()
    rec = _rec(hub, (t0, t1))
    assert readers_obs.host_syncs_per_step(rec) == 2.0
    assert readers_obs.syncs_by_span(rec) == {
        "engine.upload": 4, "engine.step": 2, readers_obs.NO_SPAN: 1}
