"""The IRQ-driven elastic autoscaler on the port
(``repro_torch.core.autoscaler``): the seven cases of
``tests/test_autoscaler.py`` and the swap-relief case of
``tests/test_kv_hierarchy.py`` on port VMMs over a one-device CPU view;
one synthetic IRQ sequence under a fake clock fed to the reference's
and the port's ``Autoscaler``, whose action logs and floorplans must be
equal entry by entry; and a grow on a one-device view that doubles the
pool."""
import threading
import time

import numpy as np
import pytest
import torch

from test_elastic import _patch_mesh, fake_vmm

from repro.core.autoscaler import Autoscaler as JaxAutoscaler
from repro.core.scheduler import IRQ_DEGRADED as JAX_IRQ_DEGRADED
from repro_torch.core import VMM, Autoscaler
from repro_torch.core.scheduler import IRQ_DEGRADED

torch.set_num_threads(1)


class Clock:
    """Injectable monotonic clock for deterministic hysteresis tests."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def port_vmm(tmp_path, rows=4, cols=4, policy="hybrid", **plane_kw):
    grid = np.empty((rows, cols), dtype=object)
    grid[:] = torch.device("cpu")
    return VMM(grid, policy=policy, hbm_per_chip=1 << 24,
               segment_bytes=1 << 20, ckpt_root=str(tmp_path / "ck"),
               scheduler_opts=plane_kw or None)


def _irq(tenant, kind="queue_buildup", payload=None, irq=IRQ_DEGRADED):
    tenant.cq.raise_event(irq, kind, payload or {"depth": 9})


# ===========================================================================
# The reference's cases, on the port
# ===========================================================================

def test_sustained_buildup_irq_triggers_grow(tmp_path):
    vmm = port_vmm(tmp_path, policy="slo", queue_high_watermark=4,
                   queue_buildup_s=0.02, queue_irq_cooldown_s=0.01)
    t = vmm.create_vm("a", (1, 1))
    scaler = Autoscaler(vmm, sustain=2, window_s=30.0, cooldown_s=0.0,
                        calm_s=999.0)
    scaler.watch(t)
    gate = threading.Event()
    try:
        vmm.plane.submit(t, "run", gate.wait, {})
        time.sleep(0.02)                       # worker holds the gate op
        futs = [vmm.plane.submit(t, "run", lambda: None, {})
                for _ in range(8)]             # backlog above watermark
        for _ in range(3):                     # hold it past the window
            time.sleep(0.03)
            futs.append(vmm.plane.submit(t, "run", lambda: None, {}))
        gate.set()
        for f in futs:
            f.result(timeout=10)

        actions = scaler.poll()
        assert [a["action"] for a in actions] == ["grow"]
        assert t.vslice.spec.shape == (1, 2)
        s = vmm.stats()["autoscaler"]
        assert s["actions"][0]["action"] == "grow"
        assert s["actions"][0]["frm"] == (1, 1)
        assert s["actions"][0]["to"] == (1, 2)
        assert s["watched"]["a"]["shape"] == [1, 2]
    finally:
        gate.set()
        vmm.shutdown()


def test_hysteresis_cooldown_and_calm_shrink(tmp_path):
    vmm = port_vmm(tmp_path)
    t = vmm.create_vm("a", (1, 1))
    clk = Clock()
    scaler = Autoscaler(vmm, sustain=3, window_s=2.0, cooldown_s=5.0,
                        calm_s=10.0, time_fn=clk)
    scaler.watch(t)
    _irq(t)
    _irq(t)
    assert scaler.poll() == []                 # below the sustain bar
    _irq(t, kind="straggler")                  # stragglers count too
    assert [a["action"] for a in scaler.poll()] == ["grow"]
    assert t.vslice.spec.shape == (1, 2)
    clk.t = 1.0
    for _ in range(3):
        _irq(t)
    assert scaler.poll() == []                 # cooldown (5s) suppresses
    assert t.vslice.spec.shape == (1, 2)
    clk.t = 6.0                                # window emptied
    assert scaler.poll() == []
    clk.t = 12.0                               # calm ≥ 10s since t=1
    assert [a["action"] for a in scaler.poll()] == ["shrink"]
    assert t.vslice.spec.shape == (1, 1)       # back to baseline
    clk.t = 30.0
    assert scaler.poll() == []                 # never below baseline
    assert [a["action"] for a in vmm.stats()["autoscaler"]["actions"]] \
        == ["grow", "shrink"]
    vmm.shutdown()


def test_non_pressure_irq_kinds_ignored(tmp_path):
    vmm = port_vmm(tmp_path)
    t = vmm.create_vm("a", (1, 1))
    scaler = Autoscaler(vmm, sustain=1, cooldown_s=0.0, time_fn=Clock())
    scaler.watch(t)
    for _ in range(5):
        _irq(t, kind="slice_failed", payload={"slice": 0})
    assert scaler.poll() == []
    assert t.vslice.spec.shape == (1, 1)
    vmm.shutdown()


def test_watch_chains_existing_irq_handler(tmp_path):
    vmm = port_vmm(tmp_path)
    t = vmm.create_vm("a", (1, 1))
    seen = []
    t.cq.set_irq(IRQ_DEGRADED, lambda ev: seen.append(ev.kind))
    scaler = Autoscaler(vmm, sustain=1, cooldown_s=0.0, time_fn=Clock())
    scaler.watch(t)
    _irq(t)
    assert seen == ["queue_buildup"]           # user handler still runs
    assert scaler.poll() and t.vslice.spec.shape == (1, 2)
    vmm.shutdown()


def test_rewatch_does_not_double_count_irqs(tmp_path):
    vmm = port_vmm(tmp_path)
    t = vmm.create_vm("a", (1, 1))
    scaler = Autoscaler(vmm, sustain=2, window_s=10.0, cooldown_s=0.0,
                        time_fn=Clock())
    scaler.watch(t)
    scaler.watch(t)                            # refresh, not re-chain
    _irq(t)
    assert vmm.stats()["autoscaler"]["watched"]["a"]["pending_events"] == 1
    assert scaler.poll() == []                 # 1 < sustain=2
    vmm.shutdown()


def test_resize_error_recorded_loop_survives(tmp_path):
    vmm = port_vmm(tmp_path)
    t = vmm.create_vm("a", (1, 1))
    scaler = Autoscaler(vmm, sustain=1, window_s=10.0, cooldown_s=0.0,
                        time_fn=Clock())
    scaler.watch(t)
    boom = RuntimeError("re-bind exploded")
    orig = vmm.migrate_tenant
    vmm.migrate_tenant = lambda *a, **k: (_ for _ in ()).throw(boom)
    _irq(t)
    acts = scaler.poll()
    assert [a["action"] for a in acts] == ["error"]
    assert "re-bind exploded" in acts[0]["error"]
    vmm.migrate_tenant = orig
    _irq(t)
    assert [a["action"] for a in scaler.poll()] == ["grow"]
    assert t.vslice.spec.shape == (1, 2)
    vmm.shutdown()


def test_grow_blocked_is_recorded_not_fatal(tmp_path):
    vmm = port_vmm(tmp_path, rows=2, cols=2)
    t = vmm.create_vm("a", (1, 1))
    for i in range(3):                         # fill the rest of the grid
        vmm.create_vm(f"filler{i}", (1, 1))
    clk = Clock()
    scaler = Autoscaler(vmm, sustain=1, window_s=5.0, cooldown_s=5.0,
                        time_fn=clk)
    scaler.watch(t)
    _irq(t)
    assert [a["action"] for a in scaler.poll()] == ["grow_blocked"]
    assert t.vslice.spec.shape == (1, 1)       # tenant intact
    _irq(t)
    clk.t = 1.0
    assert scaler.poll() == []                 # cooldown applies here too
    vmm.shutdown()


def test_autoscaler_swap_relief_replaces_grow_blocked(tmp_path):
    """``tests/test_kv_hierarchy.py``'s case: a full floorplan with a
    swap hook records swap_relief; a failing hook falls back to
    grow_blocked."""
    vmm = port_vmm(tmp_path, rows=2, cols=2)
    t = vmm.create_vm("a", (1, 1))
    for i in range(3):
        vmm.create_vm(f"filler{i}", (1, 1))
    clk = {"t": 0.0}
    asked = []
    scaler = Autoscaler(vmm, sustain=1, window_s=5.0, cooldown_s=0.0,
                        time_fn=lambda: clk["t"],
                        swap_cb=lambda n: asked.append(n) or True)
    scaler.watch(t)
    _irq(t)
    assert [a["action"] for a in scaler.poll()] == ["swap_relief"]
    assert asked == ["a"]
    assert t.vslice.spec.shape == (1, 1)
    blocked = Autoscaler(vmm, sustain=1, window_s=5.0, cooldown_s=0.0,
                         time_fn=lambda: clk["t"], swap_cb=lambda n: False)
    blocked.watch(t)
    _irq(t)
    assert [a["action"] for a in blocked.poll()] == ["grow_blocked"]
    vmm.shutdown()


# ===========================================================================
# The same IRQ sequence through both packages
# ===========================================================================

ACTION_KEYS = ("action", "frm", "to", "reason", "defragmented")


def autoscale_script(vmm, scaler, irq):
    """A (1, 1) tenant on a 2×4 grid: a grow, a calm shrink, a grow
    again, three (1, 1) fillers placed so that neither (1, 4) nor (2, 2)
    fits, a grow that defragments first, a grid filled up (grow_blocked)
    and a swap hook that relieves it. Returns (floorplan after each poll,
    the action log's comparable fields)."""
    clk = scaler.time_fn
    t = vmm.create_vm("t", (1, 1))
    scaler.watch(t)
    plans = []

    def pressure(n=3):
        for _ in range(n):
            irq(t)
        plans.append((scaler.poll(), vmm.floorplanner.snapshot(),
                      tuple(t.vslice.spec.shape)))

    pressure()                                  # grow (1,1) → (1,2)
    clk.t = 20.0
    plans.append((scaler.poll(), vmm.floorplanner.snapshot(),
                  tuple(t.vslice.spec.shape)))  # calm: shrink to (1,1)
    # place the tenant's next (1,2) in row 1, then fragment row 0
    p1 = vmm.create_vm("p1", (1, 1))            # (0,1)
    vmm.create_vm("f2", (1, 1))                 # (0,2)
    p2 = vmm.create_vm("p2", (1, 1))            # (0,3)
    clk.t = 40.0
    pressure()                                  # grow → (1,0)-(1,1)
    vmm.create_vm("f1", (1, 1))                 # (0,0)
    p4 = vmm.create_vm("p4", (1, 1))            # (1,2)
    vmm.create_vm("f3", (1, 1))                 # (1,3)
    for p in (p1, p2, p4):
        vmm.destroy_vm(p.name)
    clk.t = 60.0
    pressure()                                  # defragment, then (1,4)
    vmm.create_vm("full", (1, 1))               # the grid's last cell
    clk.t = 80.0
    pressure()                                  # grow_blocked
    clk.t = 100.0
    scaler.swap_cb = lambda name: True
    pressure()                                  # swap_relief
    log = [tuple(a.get(k) for k in ACTION_KEYS)
           for a in vmm.stats()["autoscaler"]["actions"]]
    return plans, log


def test_irq_sequence_matches_reference(tmp_path, monkeypatch):
    _patch_mesh(monkeypatch)
    ref = fake_vmm(tmp_path, rows=2, cols=4)
    jscaler = JaxAutoscaler(ref, sustain=3, window_s=2.0, cooldown_s=5.0,
                            calm_s=10.0, time_fn=Clock())
    want = autoscale_script(ref, jscaler, lambda t: _irq(
        t, irq=JAX_IRQ_DEGRADED))
    ref.plane.shutdown()
    vmm = port_vmm(tmp_path, rows=2, cols=4)
    scaler = Autoscaler(vmm, sustain=3, window_s=2.0, cooldown_s=5.0,
                        calm_s=10.0, time_fn=Clock())
    try:
        got = autoscale_script(vmm, scaler, _irq)
    finally:
        vmm.shutdown()
    assert got[1] == want[1]
    for (g_acts, g_plan, g_shape), (w_acts, w_plan, w_shape) in zip(*(
            got[0], want[0])):
        assert [a["action"] for a in g_acts] == \
            [a["action"] for a in w_acts]
        assert g_plan == w_plan and g_shape == w_shape
    assert [a[0] for a in got[1]] == ["grow", "shrink", "grow", "grow",
                                      "grow_blocked", "swap_relief"]
    assert got[1][3][4] is True                 # defragmented
    assert got[0][3][2] == (1, 4)


def test_buildup_grow_doubles_the_pool(tmp_path):
    """A real queue_buildup IRQ grows a tenant on a one-device view: the
    pool doubles and the program is re-bound to the (1, 2) slice."""
    from repro_torch.core import ProgramRequest
    vmm = port_vmm(tmp_path, rows=2, cols=4, policy="slo",
                   queue_high_watermark=2, queue_buildup_s=0.01,
                   queue_irq_cooldown_s=0.005)
    t = vmm.create_vm("a", (1, 1))
    t.device.reprogram(ProgramRequest("qwen1.5-0.5b", "decode", 16, 1))
    before = t.pool.n_segments * t.pool.segment_bytes
    scaler = Autoscaler(vmm, sustain=1, window_s=30.0, cooldown_s=0.0,
                        calm_s=999.0)
    scaler.watch(t)
    gate = threading.Event()
    try:
        futs = [vmm.plane.submit(t, "run", gate.wait, {})]
        time.sleep(0.02)
        futs += [vmm.plane.submit(t, "run", lambda: None, {})
                 for _ in range(6)]
        for _ in range(3):
            time.sleep(0.02)
            futs.append(vmm.plane.submit(t, "run", lambda: None, {}))
        gate.set()
        for f in futs:
            f.result(timeout=10)
        assert [a["action"] for a in scaler.poll()] == ["grow"]
    finally:
        gate.set()
        vmm.shutdown()
    assert t.vslice.spec.shape == (1, 2)
    assert t.pool.n_segments * t.pool.segment_bytes == 2 * before
    assert t.program.bitfile.slice_fingerprint == t.vslice.fingerprint
    assert t.program.bitfile.topology_key == "1x2"
