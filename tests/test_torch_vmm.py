"""The port's virtualization layer (``repro_torch.core``) against the
behaviours the reference's tests pin (tests/test_vmm.py, test_reconfig.py,
test_shell.py, a subset of test_scheduler.py, test_system.py's paper
scenario and test_stats_schema.py's golden key sets), plus parity with
the JAX package where both compute the same thing: program keys, bitfile
CRCs, weights fingerprints, checkpoints (either package restores what the
other wrote, bf16 included) and the step programs.

Tolerances: step-program logits in the configs' bf16 compute at 5e-2
(tests/test_kernel_integration.py's value); everything else exact.
"""
import threading
import time
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import test_stats_schema as golden
from repro.checkpointing import restore as jax_ckpt_restore
from repro.checkpointing import save as jax_ckpt_save
from repro.configs import get_config as jax_get_config
from repro.core import VMM as JaxVMM
from repro.core.reconfig import Bitfile as JaxBitfile
from repro.core.reconfig import ProgramRequest as JaxProgramRequest
from repro.core.reconfig import weights_fingerprint as jax_fingerprint
from repro.models import build_model as jax_build_model
from repro_torch.bridge import caches_to_numpy, params_from_jax
from repro_torch.checkpointing import latest, restore, save
from repro_torch.configs import get_config
from repro_torch.core import vmm as vmm_mod
from repro_torch.core import (VMM, AdmissionError, AdmissionPressure,
                              IsolationViolation, LegalityError,
                              ProgramRequest, QuotaExceeded, SegmentPool,
                              make_data_plane, report)
from repro_torch.core.interposition import OpLog
from repro_torch.core.isolation import IsolationAuditor
from repro_torch.core.reconfig import (Bitfile, CompileService,
                                       ProgramLoader, weights_fingerprint)
from repro_torch.core.scheduler import IRQ_DEGRADED
from repro_torch.core.shell import CompletionQueue, TransferEngine
from repro_torch.core.tenant import Tenant
from repro_torch.core.vslice import Floorplanner, SliceSpec, VSlice

torch.set_num_threads(2)

CPU = torch.device("cpu")
PLANES = ["fev", "bev", "hybrid", "wfq", "slo"]


def grid(rows=1, cols=1, device=CPU):
    g = np.empty((rows, cols), dtype=object)
    g[:, :] = device
    return g


def mk_vmm(tmp_path, policy="hybrid", cols=1, **kw):
    kw.setdefault("hbm_per_chip", 1 << 28)
    kw.setdefault("segment_bytes", 1 << 20)
    return VMM(grid(1, cols), policy=policy, ckpt_root=str(tmp_path / "ck"),
               **kw)


# ===========================================================================
# VMM (tests/test_vmm.py)
# ===========================================================================

@pytest.mark.parametrize("policy", ["fev", "bev", "hybrid"])
def test_guest_device_full_lifecycle(tmp_path, policy):
    vmm = mk_vmm(tmp_path, policy)
    t = vmm.create_vm("alice", (1, 1), hbm_quota_bytes=32 << 20)
    dev = t.device
    dev.open()
    info = dev.get_info()
    assert info["slice_shape"] == (1, 1) and info["policy"] == policy
    h = dev.alloc(1 << 20, shape=(512, 512), dtype="float32")
    x = np.random.default_rng(0).standard_normal((512, 512), np.float32)
    dev.write(h, x)
    assert isinstance(t.buffers[h].device_array, torch.Tensor)
    np.testing.assert_array_equal(dev.read(h), x)
    with pytest.raises(QuotaExceeded):
        dev.alloc(1 << 30)
    with pytest.raises(IsolationViolation):
        dev.write(h, np.zeros((1024, 1024), np.float32))
    dev.free(h)
    dev.close()
    vmm.destroy_vm("alice")
    assert vmm.floorplanner.utilization() == 0.0
    vmm.shutdown()


def test_vmm_needs_devices_and_a_size_for_cpu_grids(tmp_path):
    """Given no grid, or a CPU grid without ``hbm_per_chip``, the VMM
    raises (a CUDA grid sizes each pool from its cards)."""
    with pytest.raises(ValueError):
        VMM(None, hbm_per_chip=1 << 28)
    with pytest.raises(ValueError, match="hbm_per_chip"):
        VMM(grid(), ckpt_root=str(tmp_path))


def test_card_sized_pools_share_one_card(tmp_path, monkeypatch):
    """Pools sized from the card (no ``hbm_per_chip``): the three tenants
    of a 1×3 view of one card split its free memory, so their pools sum
    to at most one card; a 1×1 grid of the same card gets all of it."""
    card = 3 << 30
    monkeypatch.setattr(vmm_mod, "device_memory_bytes", lambda d: card)
    seg = 1 << 20
    vmm = VMM(grid(1, 3), segment_bytes=seg, ckpt_root=str(tmp_path))
    pools = [vmm.create_vm(f"t{i}", (1, 1)).pool for i in range(3)]
    sizes = [p.n_segments * p.segment_bytes for p in pools]
    assert sum(sizes) <= card
    assert all(s >= card // 3 - seg for s in sizes)
    vmm.shutdown()
    one = VMM(grid(), segment_bytes=seg, ckpt_root=str(tmp_path))
    pool = one.create_vm("solo", (1, 1)).pool
    assert pool.n_segments * pool.segment_bytes == card
    one.shutdown()


def test_run_without_program_rejected(tmp_path):
    vmm = mk_vmm(tmp_path)
    t = vmm.create_vm("a", (1, 1))
    with pytest.raises(LegalityError):
        t.device.run()
    vmm.shutdown()


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros(v) for v in tree]
    return torch.zeros(tree.shape, dtype=tree.dtype)


def test_reprogram_and_run_real_program(tmp_path):
    vmm = mk_vmm(tmp_path)
    t = vmm.create_vm("a", (1, 1))
    req = ProgramRequest("qwen1.5-0.5b", "decode", 32, 2)
    prog = t.device.reprogram(req)
    params = _zeros(prog.bitfile.abstract_args[0])
    caches = _zeros(prog.bitfile.abstract_args[1])
    logits, _ = t.device.run(params, caches,
                             torch.zeros((2, 1), dtype=torch.int32),
                             torch.tensor(3, dtype=torch.int32))
    assert logits.shape[0] == 2
    t.device.reprogram(req)                     # warm reconfig
    assert vmm.compiler.hits == 1
    vmm.shutdown()


def test_train_program_not_ported(tmp_path):
    """Named for the slices before training was ported: the train
    program now compiles, loads and takes one step through the guest
    API (it raised ``NotImplementedError`` then)."""
    from repro_torch import optim
    from repro_torch.bridge import batch_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import pipeline_for
    from repro_torch.models import Model
    vmm = mk_vmm(tmp_path)
    t = vmm.create_vm("a", (1, 1))
    t.device.reprogram(ProgramRequest("qwen1.5-0.5b", "train", 32, 2))
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    batch = pipeline_for(cfg, ShapeCell("t", 32, 2, "train")).batch(0)
    _, state, m = t.device.run(params, optim.init(optim.OptConfig(), params),
                               batch_from_numpy(batch))
    assert int(state["step"]) == 1 and np.isfinite(float(m["loss"]))
    vmm.shutdown()


def test_fev_broker_round_trips_data_ops(tmp_path):
    vmm = mk_vmm(tmp_path, policy="fev")
    t = vmm.create_vm("a", (1, 1))
    h = t.device.alloc(1 << 20, (128,), "float32")
    for i in range(5):
        t.device.write(h, np.full((128,), i, np.float32))
        assert vmm.oplog.completeness() == 1.0
    assert len(vmm.oplog.query(op="write")) == 5
    vmm.shutdown()


def test_straggler_detection(tmp_path):
    vmm = mk_vmm(tmp_path)
    vmm.straggler_factor = 3.0
    t = vmm.create_vm("a", (1, 1))
    events = []
    t.device.set_status(lambda ev: events.append(ev.kind))
    n = {"i": 0}

    def slow():
        n["i"] += 1
        time.sleep(0.2 if n["i"] == 5 else 0.01)
        return n["i"]
    t.program = slow
    for _ in range(5):
        t.device.run()
    assert t.straggler_count >= 1
    assert "straggler" in events
    vmm.shutdown()


def test_checkpoint_restore_roundtrip(tmp_path):
    vmm = mk_vmm(tmp_path)
    t = vmm.create_vm("a", (1, 1))
    t.state = {"params": {"w": torch.arange(12.0).reshape(3, 4)},
               "step_arr": torch.tensor(7, dtype=torch.int32)}
    t.step = 7
    vmm.checkpoint_tenant(t)
    t.state = {}
    template = {"params": {"w": torch.zeros((3, 4))},
                "step_arr": torch.tensor(0, dtype=torch.int32)}
    vmm.restore_tenant(t, template)
    assert torch.equal(t.state["params"]["w"],
                       torch.arange(12.0).reshape(3, 4))
    assert t.step == 7 and int(t.state["step_arr"]) == 7
    vmm.shutdown()


def test_slice_failure_and_migration(tmp_path):
    vmm = mk_vmm(tmp_path)
    t = vmm.create_vm("a", (1, 1))
    t.state = {"w": torch.ones(4)}
    events = []
    t.device.set_status(lambda ev: events.append(ev.kind))
    vmm.mark_slice_failed(t.vslice.slice_id)
    assert not t.vslice.healthy and "slice_failed" in events
    vmm.migrate_tenant(t, state_template={"w": torch.zeros(4)})
    assert t.vslice.healthy
    assert torch.equal(t.state["w"], torch.ones(4))
    assert len(vmm.oplog.query(op="migrate")) == 1
    vmm.shutdown()


def test_migration_without_room_rolls_back(tmp_path):
    vmm = mk_vmm(tmp_path)
    t = vmm.create_vm("a", (1, 1))
    with pytest.raises(AdmissionError):
        vmm.migrate_tenant(t, new_shape=(1, 2))
    assert t.vslice.spec.shape == (1, 1)
    vmm.shutdown()


def test_quiesce_blocks_data_plane(tmp_path):
    vmm = mk_vmm(tmp_path)
    t = vmm.create_vm("a", (1, 1))
    t.program = lambda: "ok"
    order = []
    with t.quiesce():
        th = threading.Thread(
            target=lambda: (t.device.run(), order.append("ran")))
        th.start()
        time.sleep(0.05)
        assert order == []
        order.append("frozen")
    th.join(timeout=5)
    assert not th.is_alive()
    assert order == ["frozen", "ran"]
    vmm.shutdown()


def test_criteria_report(tmp_path):
    vmm = mk_vmm(tmp_path)
    t = vmm.create_vm("a", (1, 1))
    d = t.device
    d.open()
    d.get_info()
    d.set_irq(lambda ev: None)
    d.set_status(lambda ev: None)
    h = d.alloc(1 << 20, (4,), "float32")
    d.write(h, np.zeros(4, np.float32))
    d.read(h)
    d.reprogram(ProgramRequest("qwen1.5-0.5b", "decode", 16, 1))
    d.close()
    rep = report(vmm, perf_ratio=1.02, same_artifact=True)
    assert rep.fidelity_operator_coverage == 1.0
    assert rep.tenants == 1 and rep.oplog_records > 0
    md = rep.to_markdown()
    assert "fidelity" in md and "1.020" in md
    vmm.shutdown()


def test_paper_scenario_end_to_end(tmp_path):
    """tests/test_system.py's Figure-2 scenario on the port: the matmul
    app through the guest API, the criteria observable."""
    from repro_torch.kernels.matmul.ops import matmul_op
    vmm = VMM(grid(), policy="hybrid", hbm_per_chip=1 << 28,
              segment_bytes=1 << 20, ckpt_root=str(tmp_path))
    tenant = vmm.create_vm("user0", (1, 1), hbm_quota_bytes=128 << 20)
    dev = tenant.device
    dev.open()
    h_in = dev.alloc(2 * 256 * 256 * 4, (2, 256, 256), "float32")
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 256), np.float32)
    b = rng.standard_normal((256, 256), np.float32)
    dev.write(h_in, np.stack([a, b]))
    tenant.program = lambda ab: matmul_op(ab[0], ab[1])
    result = dev.run(tenant.buffers[h_in].device_array)
    np.testing.assert_allclose(result.numpy(), a @ b, atol=1e-3)
    rep = report(vmm, perf_ratio=1.0, same_artifact=True)
    assert rep.tenants == 1 and rep.oplog_records >= 4
    assert rep.isolation_violations == {}
    dev.close()
    vmm.shutdown()


# ===========================================================================
# Reconfiguration (tests/test_reconfig.py)
# ===========================================================================

class FakeDev:
    def __init__(self, i):
        self.id = i


def mkslice(sid, origin=(0, 0), shape=(1, 1), base=0):
    n = shape[0] * shape[1]
    devs = np.array([FakeDev(base + i) for i in range(n)],
                    dtype=object).reshape(shape)
    return VSlice(sid, SliceSpec(origin, shape), devs)


def mkbitfile(vs, key="prog"):
    return Bitfile(key, vs.topology_key, vs.fingerprint,
                   compiled=lambda *a: "ran", abstract_args=())


@contextmanager
def _noop():
    yield


def test_load_and_run():
    vs = mkslice(0)
    loader = ProgramLoader()
    prog = loader.load(mkbitfile(vs), vs, _noop)
    assert prog() == "ran" and loader.reconfigs == 1


def test_crc_tamper_detected():
    vs = mkslice(0)
    bf = mkbitfile(vs)
    bf.crc = "deadbeef00000000"
    loader = ProgramLoader(auditor=IsolationAuditor())
    with pytest.raises(LegalityError, match="CRC"):
        loader.load(bf, vs, _noop)
    assert loader.auditor.count("bitfile_crc_fail") == 1


def test_topology_mismatch_rejected():
    bf = mkbitfile(mkslice(0, shape=(1, 1)))
    loader = ProgramLoader(auditor=IsolationAuditor())
    with pytest.raises(LegalityError, match="topology"):
        loader.load(bf, mkslice(1, shape=(1, 2), base=10), _noop)


def test_cross_slice_reprogram_attack_rejected(tmp_path):
    """VM0's bitfile flashed into VM1's slice of the same topology is
    refused — with fake devices and through a real VMM on a 1×2 view of
    one device (the slices differ only by origin)."""
    vs0 = mkslice(0, origin=(0, 0), base=0)
    vs1 = mkslice(1, origin=(0, 1), base=100)
    loader = ProgramLoader(auditor=IsolationAuditor())
    with pytest.raises(LegalityError, match="bound to a different slice"):
        loader.load(mkbitfile(vs0), vs1, _noop, owner="vm0")
    assert loader.auditor.count("cross_slice_reprogram") == 1
    vmm = mk_vmm(tmp_path, cols=2)
    a, b = vmm.create_vm("vm0", (1, 1)), vmm.create_vm("vm1", (1, 1))
    bf = vmm.compiler.compile(ProgramRequest("qwen1.5-0.5b", "decode", 16,
                                             1), a.vslice)
    with pytest.raises(LegalityError):
        b.device.reprogram(bf)
    assert vmm.stats()["violations"] == {"cross_slice_reprogram": 1}
    vmm.shutdown()


def test_compile_cache_warm_rebind():
    def fake_builder(cfg, device, cell):
        return (lambda *a: "ran"), ()
    svc = CompileService(step_builder=fake_builder)
    req = ProgramRequest("qwen1.5-0.5b", "decode", 32, 2)
    vs0, vs1 = mkslice(0, base=0), mkslice(1, base=50)
    bf0 = svc.compile(req, vs0)
    assert svc.misses == 1 and bf0.compile_seconds > 0
    bf1 = svc.compile(req, vs1)
    assert svc.hits == 1 and bf1.compile_seconds == 0.0
    assert bf1.slice_fingerprint == vs1.fingerprint
    ProgramLoader().load(bf1, vs1, _noop)


@pytest.mark.parametrize("entries,card", [
    ((CPU, CPU), CPU),
    ((torch.device("cuda", 0), torch.device("cuda", 1)), None)],
    ids=["one-device", "two-cards"])
def test_multi_device_slice_has_no_single_device(entries, card):
    """A (1, 2) slice whose entries name one device runs on that device
    (two shares of it); one whose entries name two cards has no single
    device and raises, naming the mesh a slice over several cards runs
    on (no ``torch.device`` needs a card to exist)."""
    g = np.empty((1, 2), dtype=object)
    g[0, :] = list(entries)
    vs = Floorplanner(g).allocate((1, 2))
    assert vs.n_devices == 2
    if card is None:
        assert len(vs.cards) == 2
        with pytest.raises(ValueError, match="mesh"):
            vs.device
    else:
        assert vs.cards == (card,)
        assert vs.device == card


@pytest.mark.parametrize("kind,seq,batch,reduced",
                         [("decode", 32, 2, True), ("prefill", 4096, 4,
                                                    False)])
def test_program_key_and_crc_match_reference(kind, seq, batch, reduced):
    """The same request on the same 1×1 CPU slice gives the JAX package's
    program key, slice fingerprint and bitfile CRC."""
    mine = ProgramRequest("qwen1.5-0.5b", kind, seq, batch, reduced=reduced)
    ref = JaxProgramRequest("qwen1.5-0.5b", kind, seq, batch,
                            reduced=reduced)
    assert mine.program_key == ref.program_key
    from repro.core.vslice import Floorplanner as JaxFloorplanner
    jvs = JaxFloorplanner(Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                               ("data", "model"))).allocate((1, 1))
    vs = Floorplanner(grid()).allocate((1, 1))
    assert vs.fingerprint == jvs.fingerprint
    assert Bitfile(mine.program_key, vs.topology_key, vs.fingerprint,
                   None, ()).crc == JaxBitfile(
        ref.program_key, jvs.topology_key, jvs.fingerprint, None, ()).crc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_fingerprint_matches_reference(dtype):
    cfg = jax_get_config("qwen1.5-0.5b", reduced=True)
    jp = jax_build_model(cfg).init(jax.random.PRNGKey(4))
    jp = jax.tree.map(lambda x: x.astype(jnp.dtype(dtype)), jp)
    p = params_from_jax(jax.device_get(jp))
    pcfg = get_config("qwen1.5-0.5b", reduced=True)
    assert weights_fingerprint(p, pcfg) == jax_fingerprint(jp)
    p["final_norm"]["scale"][0] += 1
    assert weights_fingerprint(p, pcfg) != jax_fingerprint(jp)


# ===========================================================================
# Step programs against the reference's (same bf16 params)
# ===========================================================================

@pytest.fixture(scope="module")
def programs():
    """JAX and port prefill/decode programs for one small cell, built by
    each package's CompileService on its own 1×1 CPU slice."""
    jvmm = JaxVMM(Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                       ("data", "model")), hbm_per_chip=1 << 28,
                  segment_bytes=1 << 20)
    vmm = VMM(grid(), hbm_per_chip=1 << 28, segment_bytes=1 << 20)
    jt, t = jvmm.create_vm("a", (1, 1)), vmm.create_vm("a", (1, 1))
    out = {}
    for kind in ("prefill", "decode"):
        out[kind] = (jt.device.reprogram(JaxProgramRequest(
            "qwen1.5-0.5b", kind, 16, 2)), t.device.reprogram(
            ProgramRequest("qwen1.5-0.5b", kind, 16, 2)))
    cfg = jax_get_config("qwen1.5-0.5b", reduced=True)
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                      jax_build_model(cfg).init(jax.random.PRNGKey(6)))
    yield out, jp, params_from_jax(jax.device_get(jp))
    jvmm.shutdown()
    vmm.shutdown()


def _close(got, want, tol=5e-2):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_abstract_args_match_reference(programs):
    """Parameter paths, shapes and dtypes (bf16) of both packages'
    programs agree; the decode program takes the reference's cache,
    token and position shapes."""
    from repro_torch.bridge import stacked_layout
    from repro_torch.checkpointing.checkpoint import flatten_with_path
    from repro_torch.core.reconfig import keystr
    out, _, _ = programs
    for kind in ("prefill", "decode"):
        jabs = out[kind][0].bitfile.abstract_args
        mabs = out[kind][1].bitfile.abstract_args
        assert all(x.device.type == "meta"
                   for x in jax.tree_util.tree_leaves(mabs))
        want = [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
                for p, x in jax.tree_util.tree_flatten_with_path(jabs[0])[0]]
        got = [(keystr(k), tuple(x.shape), str(x.dtype)[6:]) for k, x in
               flatten_with_path(stacked_layout(_zeros(mabs[0])))]
        assert got == want
    jabs = out["decode"][0].bitfile.abstract_args
    mabs = out["decode"][1].bitfile.abstract_args
    assert tuple(mabs[1]["k"].shape) == jabs[1][0][0]["mixer"]["k"].shape
    assert [tuple(x.shape) for x in mabs[2:]] == [tuple(x.shape)
                                                  for x in jabs[2:]]
    assert mabs[2].dtype == mabs[3].dtype == torch.int32


def test_programs_match_reference(programs):
    """Prefill (ring caches of capacity 16, the program's seq_len) and
    three decode steps that wrap the ring, JAX programs vs port programs,
    logits and caches at 5e-2."""
    out, jp, p = programs
    toks = np.random.default_rng(3).integers(0, 512, (2, 16)).astype(
        np.int32)
    jpf, mpf = out["prefill"]
    jlog, jc = jpf(jp, {"tokens": jnp.asarray(toks)})
    mlog, mc = mpf(p, {"tokens": torch.from_numpy(toks)})
    _close(mlog[:, :512], np.asarray(jlog)[:, :512])
    for kk in ("k", "v"):
        _close(mc[kk], caches_to_numpy(
            {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
             jc[0][0]["mixer"].items()}, get_config(
                 "qwen1.5-0.5b", reduced=True))[0][0]["mixer"][kk])
    jdc, mdc = out["decode"]
    tok = np.argmax(np.asarray(jlog)[:, :512], -1)[:, None].astype(np.int32)
    for pos in (16, 17, 18):
        jlog, jc = jdc(jp, jc, jnp.asarray(tok), jnp.int32(pos))
        mlog, mc = mdc(p, mc, torch.from_numpy(tok),
                       torch.tensor(pos, dtype=torch.int32))
        _close(mlog[:, :512], np.asarray(jlog)[:, :512])
        tok = np.argmax(np.asarray(jlog)[:, :512], -1)[:, None].astype(
            np.int32)


# ===========================================================================
# Checkpoints: either package restores what the other wrote
# ===========================================================================

def test_jax_checkpoint_restores_in_port(tmp_path):
    tree = {"params": {"w": jnp.arange(6.0, dtype=jnp.bfloat16).reshape(2, 3),
                       "b": [jnp.ones(2), jnp.zeros(3, jnp.int32)]},
            "step_arr": jnp.int32(7)}
    jax_ckpt_save(str(tmp_path), 7, tree, {"who": "jax"})
    template = {"params": {"w": torch.zeros((2, 3), dtype=torch.bfloat16),
                           "b": [torch.zeros(2),
                                 torch.zeros(3, dtype=torch.int32)]},
                "step_arr": torch.tensor(0, dtype=torch.int32)}
    step, got, meta = restore(latest(str(tmp_path)), template)
    assert step == 7 and meta == {"who": "jax"}
    assert got["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"],
                       torch.arange(6.0).reshape(2, 3).to(torch.bfloat16))
    assert torch.equal(got["params"]["b"][0], torch.ones(2))
    assert int(got["step_arr"]) == 7


def test_port_checkpoint_restores_in_jax(tmp_path):
    tree = {"params": {"w": torch.linspace(-2, 2, 6).reshape(2, 3).to(
        torch.bfloat16), "b": [torch.ones(2)]},
        "step_arr": torch.tensor(9, dtype=torch.int32)}
    save(str(tmp_path), 9, tree, {"who": "port"})
    template = {"params": {"w": jnp.zeros((2, 3), jnp.bfloat16),
                           "b": [jnp.zeros(2)]},
                "step_arr": jnp.int32(0)}
    from repro.checkpointing import latest as jax_latest
    step, got, meta = jax_ckpt_restore(jax_latest(str(tmp_path)), template)
    assert step == 9 and meta == {"who": "port"}
    assert got["params"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(got["params"]["w"], np.float32),
        tree["params"]["w"].float().numpy())
    assert int(got["step_arr"]) == 9


# ===========================================================================
# Shell (tests/test_shell.py)
# ===========================================================================

@pytest.mark.parametrize("mode", ["vm_copy", "vm_nocopy"])
def test_transfer_roundtrip(mode):
    te = TransferEngine(mode=mode)
    x = np.random.default_rng(1).standard_normal((64, 128), np.float32)
    dev = te.h2d(x, device="cpu")
    np.testing.assert_array_equal(te.d2h(dev), x)
    assert te.stats.h2d_bytes == te.stats.d2h_bytes == x.nbytes
    if mode == "vm_copy":
        assert te.stats.guest_copy_ns > 0
    else:
        assert te.stats.guest_copy_ns == 0


def test_vm_copy_returns_no_view_of_staging():
    """On the CPU the staged copy must not alias the shared staging
    buffer: a second write would otherwise change the first's data."""
    te = TransferEngine(mode="vm_copy", staging_bytes=16)
    a = te.h2d(np.arange(8, dtype=np.int32), device="cpu")
    te.h2d(np.full(8, -1, np.int32), device="cpu")
    assert te._staging.nbytes >= 32
    np.testing.assert_array_equal(a.numpy(), np.arange(8))


def test_h2d_without_device_targets_the_card(monkeypatch):
    """``h2d`` with no device means the card, as ``jax.device_put`` with
    no target means the default accelerator: with no CUDA it raises
    rather than land on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("vm_copy", "vm_nocopy"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TransferEngine(mode=mode).h2d(np.zeros(4, np.float32))


@pytest.mark.parametrize("mode", ["vm_copy", "vm_nocopy"])
def test_bf16_roundtrip_is_bit_exact(mode):
    """numpy has no bfloat16: ``d2h`` hands back a bf16 tensor's int16
    bits and ``h2d(..., dtype=torch.bfloat16)`` views them back."""
    te = TransferEngine(mode=mode)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 5, 7), np.float32)).to(torch.bfloat16)
    host = te.d2h(x)
    assert host.dtype == np.int16 and host.shape == (3, 5, 7)
    back = te.h2d(host, device="cpu", dtype=torch.bfloat16)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), x.view(torch.int16))
    assert te.stats.h2d_bytes == te.stats.d2h_bytes == x.numel() * 2


def test_completion_queue_delivery_mask_and_pending():
    cq = CompletionQueue()
    got = []
    cq.set_irq(0, lambda ev: got.append(ev.kind))
    cq.raise_event(0, "done", {"step": 1})
    assert got == ["done"] and cq.status == 0
    cq.set_irq(3, lambda ev: got.append(ev.kind))
    cq.set_mask(3, True)
    cq.raise_event(3, "a")
    cq.raise_event(3, "b")
    assert got == ["done"] and cq.status & (1 << 3)
    cq.set_mask(3, False)
    assert got == ["done", "a", "b"] and cq.status == 0
    cq.raise_event(5, "orphan")
    assert cq.status & (1 << 5) and len(cq.pending()) == 1


def test_delivery_is_not_reentrant():
    cq = CompletionQueue(depth=2048)
    depth = {"cur": 0, "max": 0, "n": 0}

    def handler(ev):
        depth["cur"] += 1
        depth["max"] = max(depth["max"], depth["cur"])
        depth["n"] += 1
        if depth["n"] < 1000:
            cq.raise_event(7, "again")
        depth["cur"] -= 1
    cq.set_irq(7, handler)
    cq.raise_event(7, "first")
    assert depth["n"] == 1000 and depth["max"] == 1 and not cq.pending()


def test_event_ts_is_monotonic_clock():
    t0 = time.monotonic()
    cq = CompletionQueue()
    cq.raise_event(1, "probe")
    assert t0 <= cq.pending()[0].ts <= time.monotonic()


def test_transfer_counters_atomic_under_concurrency():
    te = TransferEngine(mode="vm_nocopy")
    x = np.ones(1024, dtype=np.float32)
    errs = []

    def work():
        try:
            for _ in range(16):
                te.d2h(te.h2d(x, device="cpu"))
        except Exception as exc:          # noqa: BLE001 — reported below
            errs.append(exc)
    ts = [threading.Thread(target=work) for _ in range(8)]
    [t.start() for t in ts]
    [t.join(timeout=30) for t in ts]
    assert not errs and not any(t.is_alive() for t in ts)
    assert te.stats.h2d_bytes == te.stats.d2h_bytes == 8 * 16 * x.nbytes


# ===========================================================================
# Scheduler planes (a subset of tests/test_scheduler.py)
# ===========================================================================

def mk_tenant(name="a", pool=None):
    return Tenant(name=name, vslice=None, pool=pool, cq=CompletionQueue())


@pytest.mark.parametrize("policy", PLANES)
def test_plane_execute_async_fifo_and_stats(policy):
    p = make_data_plane(policy, oplog=OpLog())
    t = mk_tenant()
    p.register(t, weight=2.0)
    try:
        assert p.execute(t, "run", lambda: 41 + 1, {}) == 42
        bad = p.submit(t, "run", lambda: 1 / 0, {})
        assert isinstance(bad.exception(timeout=5), ZeroDivisionError)
        got = []
        futs = [p.submit(t, "run", (lambda i=i: got.append(i)), {})
                for i in range(16)]
        for f in futs:
            f.result(timeout=5)
        assert got == list(range(16))
        st = p.stats()["tenants"]["a"]
        assert st["submitted"] == 18 and st["completed"] == 17
        assert st["failed"] == 1 and st["queue_depth"] == 0
        assert st["weight"] == 2.0
    finally:
        p.shutdown()


@pytest.mark.parametrize("policy", PLANES)
def test_plane_straggler_irq(policy):
    p = make_data_plane(policy, oplog=OpLog(), straggler_factor=3.0)
    t = mk_tenant()
    p.register(t)
    events = []
    t.cq.set_irq(IRQ_DEGRADED, lambda ev: events.append(ev.kind))
    try:
        for i in range(5):
            p.execute(t, "run",
                      lambda d=(0.08 if i == 4 else 0.005): time.sleep(d),
                      {})
        assert t.straggler_count >= 1 and "straggler" in events
    finally:
        p.shutdown()


def test_slo_admission_gate_denies_under_hard_pressure():
    seg = 1 << 20
    p = make_data_plane("slo", pressure_refresh_s=0.0, deny_hold_s=0.0)
    t = mk_tenant("hog", SegmentPool(total_bytes=8 * seg, segment_bytes=seg))
    p.register(t)
    try:
        a = t.pool.alloc(8 * seg, "hog")
        fut = p.submit(t, "run", lambda: 1, {})
        assert isinstance(fut.exception(timeout=5), AdmissionPressure)
        st = p.stats()["tenants"]["hog"]
        assert st["admission_denied"] == 1 and st["mem_pressure"] == 1.0
        t.pool.free(a.handle, "hog")
        assert p.submit(t, "run", lambda: 2, {}).result(timeout=5) == 2
    finally:
        p.shutdown()


# ===========================================================================
# Stats schemas (tests/test_stats_schema.py's golden sets)
# ===========================================================================

def _has(got, want):
    missing = set(want) - set(got)
    assert not missing, sorted(missing)


def test_vmm_stats_schema(tmp_path):
    from repro_torch.obs import ObsHub
    vmm = mk_vmm(tmp_path, policy="slo", obs=ObsHub(enabled=True))
    t = vmm.create_vm("a", (1, 1))
    t.device.open()
    t.program = lambda x: x
    t.device.run(np.ones(4, np.float32))
    s = vmm.stats()
    try:
        _has(s, golden.VMM_STATS_KEYS)
        _has(s["memory"]["a"], golden.MEMORY_STATS_KEYS)
        _has(s["transfer"], golden.TRANSFER_STATS_KEYS)
        assert s["scheduler"]["policy"] == "slo"
        _has(s["scheduler"]["tenants"]["a"],
             golden.PLANE_TENANT_KEYS | golden.SLO_TENANT_EXTRA_KEYS)
        _has(s["ops"]["run"], {"count", "mean_ms", "p50_ms", "p95_ms"})
        _has(s["obs"], golden.OBS_SNAPSHOT_KEYS)
        assert s["autoscaler"] is None
    finally:
        vmm.shutdown()


@pytest.mark.parametrize("policy", ["hybrid", "wfq", "slo"])
def test_plane_tenant_snapshot_schema(policy):
    plane = make_data_plane(policy)
    t = mk_tenant()
    try:
        plane.register(t)
        plane.execute(t, "run", lambda: 1)
        want = golden.PLANE_TENANT_KEYS | (golden.SLO_TENANT_EXTRA_KEYS
                                           if policy == "slo" else set())
        _has(plane.stats()["tenants"]["a"], want)
    finally:
        plane.shutdown()
