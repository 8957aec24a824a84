"""Elastic re-slicing on the port (``repro_torch.core.elastic``) against
the reference (``repro.core.elastic``): the four scenarios of
``tests/test_elastic.py``, each run on the reference's fake-grid VMM and
on a port VMM over a one-device CPU view of the same shape, must give
the same floorplan snapshots, move counts and raised errors. Then what
the port adds on one card: a grow doubles the pool, re-binds the
program and restores the state onto the slice's one device; a
non-``None`` ``shardings_fn`` raises."""
import numpy as np
import pytest
import torch

from test_elastic import _patch_mesh, fake_vmm

from repro.core import AdmissionError as JaxAdmissionError
from repro.core import elastic as jax_elastic
from repro_torch.core import VMM, AdmissionError, ProgramRequest, elastic
from repro_torch.core import vmm as vmm_mod

torch.set_num_threads(1)

CPU = torch.device("cpu")


def port_vmm(tmp_path, rows=4, cols=4, **kw):
    """A port VMM over a rows×cols view of the CPU with the fake VMM's
    sizes (16 MiB a grid entry, 1 MiB segments)."""
    grid = np.empty((rows, cols), dtype=object)
    grid[:] = CPU
    return VMM(grid, hbm_per_chip=1 << 24, segment_bytes=1 << 20,
               ckpt_root=str(tmp_path / "port_ck"), **kw)


def _grow_and_shrink(vmm, el, err):
    t = vmm.create_vm("a", (1, 2))
    out = [vmm.floorplanner.snapshot()]
    el.resize(vmm, t, (2, 4))
    out += [t.vslice.spec.shape, vmm.floorplanner.utilization(),
            vmm.floorplanner.snapshot()]
    el.resize(vmm, t, (1, 1))
    out += [t.vslice.spec.shape, vmm.floorplanner.snapshot(),
            len(vmm.oplog.query(op="migrate"))]
    return out


def _impossible_rolls_back(vmm, el, err):
    t = vmm.create_vm("a", (2, 2))
    with pytest.raises(err) as info:
        el.resize(vmm, t, (8, 8))            # bigger than the grid
    return [str(info.value), t.vslice.spec.shape,
            vmm.floorplanner.utilization(), vmm.floorplanner.snapshot()]


def _defragment(vmm, el, err):
    vmm.create_vm("a", (1, 2))
    vmm.create_vm("b", (1, 2))
    vmm.create_vm("c", (2, 2))
    vmm.destroy_vm("a")                      # hole at the origin
    before = vmm.floorplanner.fragmentation()
    moves = el.defragment(vmm)
    return [before, moves, vmm.floorplanner.fragmentation(),
            sorted(t.vslice.spec.origin for t in vmm.tenants.values()),
            vmm.floorplanner.snapshot()]


def _multiplexing(vmm, el, err):
    for i in range(8):
        vmm.create_vm(f"t{i}", (1, 2))
    with pytest.raises(err) as info:
        vmm.create_vm("overflow", (1, 1))
    return [vmm.floorplanner.utilization(), str(info.value),
            vmm.floorplanner.snapshot()]


@pytest.mark.parametrize("scenario", [_grow_and_shrink,
                                      _impossible_rolls_back, _defragment,
                                      _multiplexing],
                         ids=lambda f: f.__name__.strip("_"))
def test_scenario_matches_reference(scenario, tmp_path, monkeypatch):
    _patch_mesh(monkeypatch)
    ref = fake_vmm(tmp_path)
    want = scenario(ref, jax_elastic, JaxAdmissionError)
    ref.plane.shutdown()
    vmm = port_vmm(tmp_path)
    try:
        got = scenario(vmm, elastic, AdmissionError)
    finally:
        vmm.shutdown()
    assert got == want


def test_expected_values_of_the_scenarios(tmp_path):
    """The reference test's own assertions, on the port."""
    vmm = port_vmm(tmp_path)
    try:
        _, shape, util, _, small, _, migrations = _grow_and_shrink(
            vmm, elastic, AdmissionError)
        assert shape == (2, 4) and util == 8 / 16
        assert small == (1, 1) and migrations == 2
    finally:
        vmm.shutdown()
    vmm = port_vmm(tmp_path)
    try:
        before, moves, after, origins, _ = _defragment(
            vmm, elastic, AdmissionError)
        assert moves >= 1 and origins[0] == (0, 0) and after <= before
    finally:
        vmm.shutdown()


def test_grow_on_one_device_doubles_the_pool(tmp_path):
    """A (1, 1) → (1, 2) → (2, 4) grow on a 2×4 view of one device: the
    pool takes 2, then 8 grid entries' shares; the program is re-bound
    to the new slice; the checkpointed state comes back onto the one
    device, equal."""
    vmm = port_vmm(tmp_path, rows=2, cols=4)
    try:
        t = vmm.create_vm("a", (1, 1))
        req = ProgramRequest("qwen1.5-0.5b", "decode", 16, 1)
        t.device.reprogram(req)
        state = {"x": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                 "step": torch.tensor(7)}
        t.state = {k: v.clone() for k, v in state.items()}
        template = {k: torch.empty_like(v) for k, v in state.items()}
        sizes = [t.pool.n_segments * t.pool.segment_bytes]
        for shape in ((1, 2), (2, 4)):
            elastic.resize(vmm, t, shape, state_template=template)
            sizes.append(t.pool.n_segments * t.pool.segment_bytes)
            assert t.vslice.spec.shape == shape
            assert t.vslice.cards == (CPU,) and t.vslice.device == CPU
            assert t.program.bitfile.slice_fingerprint == \
                t.vslice.fingerprint
            assert t.program.bitfile.topology_key == f"{shape[0]}x{shape[1]}"
            for k, v in state.items():
                assert t.state[k].device == CPU
                assert torch.equal(t.state[k], v)
        assert sizes == [1 << 24, 2 << 24, 8 << 24]
        assert vmm.compiler.misses == 3      # one build per topology
    finally:
        vmm.shutdown()


def test_grow_on_a_card_view_doubles_its_shares(tmp_path, monkeypatch):
    """Pools sized from the card (no ``hbm_per_chip``): on a 2×4 view of
    one card a (1, 4) slice holds 4/8 of its free memory and the grow to
    (2, 4) all of it; the slice's device is that card. No card is
    needed: the card's size is stubbed."""
    card = 8 << 30
    monkeypatch.setattr(vmm_mod, "device_memory_bytes", lambda d: card)
    grid = np.empty((2, 4), dtype=object)
    grid[:] = torch.device("cuda", 0)
    vmm = VMM(grid, segment_bytes=1 << 20, ckpt_root=str(tmp_path))
    try:
        t = vmm.create_vm("trainer", (1, 4))
        half = t.pool.n_segments * t.pool.segment_bytes
        elastic.resize(vmm, t, (2, 4))
        assert t.vslice.device == torch.device("cuda", 0)
        assert half == card // 2
        assert t.pool.n_segments * t.pool.segment_bytes == card
    finally:
        vmm.shutdown()


def test_sharded_restore_is_refused(tmp_path):
    vmm = port_vmm(tmp_path, rows=1, cols=2)
    try:
        t = vmm.create_vm("a", (1, 1))
        with pytest.raises(NotImplementedError, match="item 9"):
            elastic.resize(vmm, t, (1, 2), shardings_fn=lambda vs: None)
        assert t.vslice.spec.shape == (1, 1)
    finally:
        vmm.shutdown()
