"""The model mux in the port — weights as bitstreams
(``ModelRegistry``), the ``MuxEngine`` over one shared pool, and paged
recurrent state under it — held against the reference's scenarios
(tests/test_model_mux.py) and its JAX registry and mux on the same
converted weights, on the CPU.

Registry level: LRU residency under ``max_resident`` round-trips weights
byte-identically; a flipped byte in the host copy raises
``LegalityError`` and surfaces in the registry's stats, ``VMM.stats()``
(a shared loader), the obs counters and a flight dump; equal weights
give the reference's CRC for all three families. Engine level: a
three-family ``MuxEngine`` gives the greedy ids of per-family solo
engines and of the JAX mux, before and after hot-swap churn under
``max_resident=1`` (reduced configs in fp32 compute, so ids compare
exactly). State level: both recurrent families' real state rows park to
zeros and refault to their values on one shared pool. The reference's
fake-model lifecycle sweep is in tests/test_torch_recurrent_layers.py.
"""
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.reconfig import weights_fingerprint as jax_fingerprint
from repro.models import build_model as jax_build_model
from repro.serving import ModelRegistry as JaxModelRegistry
from repro.serving import MuxEngine as JaxMuxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.mmu import SegmentPool
from repro_torch.core.reconfig import LegalityError, weights_fingerprint
from repro_torch.models import Model
from repro_torch.obs import ObsHub
from repro_torch.serving import (ModelRegistry, MuxEngine,
                                 PagedRecurrentState, ServeEngine)

torch.set_num_threads(2)

FAMILIES = ["qwen1.5-0.5b", "rwkv6-7b", "recurrentgemma-2b"]


# ===========================================================================
# Registry: LRU residency, byte-identical round trip, CRC gate
# ===========================================================================

def _tiny(name, seed):
    """A registry entry that is pure weights — the registry never calls
    into the model object unless a MuxEngine serves it."""
    w = torch.from_numpy(np.random.default_rng(seed).standard_normal(16)
                         .astype(np.float32))
    return (name, SimpleNamespace(n_layers=1, d_model=4, vocab=7),
            {"w": w})


def test_lru_eviction_and_byte_identical_roundtrip():
    reg = ModelRegistry(max_resident=2)
    orig = {}
    for seed, name in enumerate(("a", "b", "c")):
        _, cfg, params = _tiny(name, seed)
        orig[name] = params["w"].clone()
        reg.register(name, arch=name, cfg=cfg, model=object(),
                     params=params, device="cpu")
    # registering c evicted the LRU resident (a)
    assert reg.residency() == {"a": False, "b": True, "c": True}
    w = reg.params("a")["w"]
    assert torch.equal(w, orig["a"])             # host round trip exact
    assert reg.residency() == {"a": True, "b": False, "c": True}
    assert reg["a"].swap_ins == 1 and reg["a"].swap_outs == 1
    assert reg.stats()["crc_failures"] == 0
    # crc verified at register (×3) and again on the swap-in
    assert reg.stats()["crc_checks"] >= 4


def test_crc_failure_surfaces_in_stats_obs_and_flight():
    hub = ObsHub(enabled=True)
    name, cfg, params = _tiny("tiny", 7)
    reg = ModelRegistry(obs=hub)
    reg.register(name, arch=name, cfg=cfg, model=object(), params=params,
                 device="cpu")
    reg.swap_out(name)
    reg[name].host_params["w"][3] += 1.0         # flip a host-tier byte
    with pytest.raises(LegalityError):
        reg.params(name)                         # serving path refuses
    s = reg.stats()
    assert s["crc_failures"] >= 1
    assert reg.residency()[name] is False        # never loaded
    snap = hub.snapshot()
    assert "model_crc_failures_total" in snap["metrics"]["counters"]
    assert snap["flight"]["dumps"], \
        "crc_failure must trigger a flight-recorder dump"


def test_registry_shares_vmm_loader_and_model_binding():
    """A registry built on a VMM's loader lands crc_checks/crc_failures
    in ``VMM.stats()``, and ``create_vm(model=...)`` surfaces the binding
    in the scheduler's tenant snapshot."""
    from repro_torch.core import VMM
    grid = np.empty((1, 1), dtype=object)
    grid[0, 0] = torch.device("cpu")
    vmm = VMM(grid, hbm_per_chip=1 << 26, segment_bytes=1 << 20)
    try:
        reg = ModelRegistry(loader=vmm.loader)
        name, cfg, params = _tiny("tiny", 11)
        reg.register(name, arch=name, cfg=cfg, model=object(),
                     params=params, device="cpu")
        assert vmm.stats()["crc_checks"] >= 1
        reg.swap_out(name)
        reg[name].host_params["w"][0] += 2.0
        with pytest.raises(LegalityError):
            reg.params(name)
        assert vmm.stats()["crc_failures"] >= 1
        t = vmm.create_vm("app", (1, 1), model="tiny")
        assert t is not None
        assert vmm.stats()["scheduler"]["tenants"]["app"]["model"] == "tiny"
    finally:
        vmm.shutdown()


# ===========================================================================
# Three families, both packages, the same weights
# ===========================================================================

@pytest.fixture(scope="module")
def families():
    """family → (JAX cfg, model, params; port cfg, model, params), fp32
    compute, the port's weights converted from the JAX ones."""
    out = {}
    for name in FAMILIES:
        jcfg = dataclasses.replace(jax_get_config(name, reduced=True),
                                   compute_dtype="float32")
        cfg = dataclasses.replace(get_config(name, reduced=True),
                                  compute_dtype="float32")
        jm = jax_build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        out[name] = (jcfg, jm, jp, cfg, Model(cfg, device="cpu"),
                     params_from_jax(jax.device_get(jp)))
    return out


def test_equal_weights_give_the_reference_crc(families):
    """Per family, the port's fingerprint of the converted weights and
    the registered bitstream's CRC are the JAX registry's."""
    reg, jreg = ModelRegistry(), JaxModelRegistry()
    for name, (jcfg, jm, jp, cfg, m, p) in families.items():
        assert weights_fingerprint(p, cfg) == jax_fingerprint(jp)
        mine = reg.register(name, cfg=cfg, model=m, params=p)
        want = jreg.register(name, cfg=jcfg, model=jm, params=jp)
        assert mine.bitfile.crc == want.bitfile.crc
        assert mine.bitfile.slice_fingerprint == \
            want.bitfile.slice_fingerprint
        assert mine.param_bytes == want.param_bytes


def _prompts(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(6 + i,)).astype(np.int32)
            for i in range(n)]


def _ordered(done):
    return [tuple(r.out_tokens) for r in sorted(done, key=lambda r: r.rid)]


def _mux_run(reg_cls, mux_cls, fams, prompts, jax_side):
    """Register every family, serve two interleaved prompts a family, then
    churn under ``max_resident=1`` with one request a family in turn →
    (ids of the first round, ids of the churn, registry, mux)."""
    reg = reg_cls()
    for name, (jcfg, jm, jp, cfg, m, p) in fams.items():
        if jax_side:
            reg.register(name, cfg=jcfg, model=jm, params=jp)
        else:
            reg.register(name, cfg=cfg, model=m, params=p)
    mux = mux_cls(reg, FAMILIES, batch_per_model=2, capacity=16,
                  page_size=8, chunk_tokens=8)
    for name in FAMILIES:
        mux.bind(f"tenant-{name}", name)
    for i in range(2):                      # interleave the families
        for name in FAMILIES:
            mux.submit(prompts[name][i], tenant=f"tenant-{name}",
                       max_new_tokens=4)
    finished = mux.run_round()
    first = {name: _ordered(finished[name]) for name in FAMILIES}
    reg.max_resident = 1
    churn = {}
    for name in FAMILIES:
        mux.submit(prompts[name][0], tenant=f"tenant-{name}",
                   max_new_tokens=4)
        churn[name] = _ordered(mux.run_round()[name])[0]
    return first, churn, reg, mux


def test_mux_outputs_match_solo_and_survive_hot_swap(families):
    """A three-family mux over one pool gives each family's solo-engine
    ids and the JAX mux's, and so does every request served after
    hot-swap churn under ``max_resident=1`` (every lane change moves
    weights through the host tier); no CRC failure, refcounts clean."""
    prompts = {name: _prompts(f[3].vocab, 2, seed=i)
               for i, (name, f) in enumerate(families.items())}
    solo = {}
    for name, (jcfg, jm, jp, cfg, m, p) in families.items():
        eng = ServeEngine(cfg, m, 2, 16, page_size=8, chunk_tokens=8,
                          state_paging=True)
        for pr in prompts[name]:
            eng.submit(pr, max_new_tokens=4)
        solo[name] = _ordered(eng.run_round(p))
        assert len(solo[name]) == 2
    first, churn, reg, mux = _mux_run(ModelRegistry, MuxEngine, families,
                                      prompts, False)
    jfirst, jchurn, _, _ = _mux_run(JaxModelRegistry, JaxMuxEngine,
                                    families, prompts, True)
    for name in FAMILIES:
        assert first[name] == solo[name] == jfirst[name], name
        assert churn[name] == solo[name][0] == jchurn[name], name
    assert sum(reg[n].swap_ins for n in FAMILIES) >= 2
    assert sum(reg[n].swap_outs for n in FAMILIES) >= 2
    assert reg.stats()["crc_failures"] == 0
    assert mux.pool.refcounts_consistent()
    for g in mux.stats()["groups"].values():
        e = g["engine"]
        assert e["pages_leased"] == e["pages_freed"]
        assert e["state_pages_leased"] == e["state_pages_freed"]


# ===========================================================================
# Paged recurrent state of the real families on one shared pool
# ===========================================================================

@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_real_state_rows_park_and_refault_on_one_pool(families, order):
    """recurrentgemma's and rwkv6's state rows, leased from one pool: a
    parked slot's rows read zero on the device and its pages swap out;
    the refault restores every row leaf exactly, in either order."""
    archs = ["recurrentgemma-2b", "rwkv6-7b"]
    models = [families[a][4] for a in archs]
    seg = max(m.kv_page_bytes(8) for m in models)
    pool = SegmentPool(total_bytes=64 * seg, backend="bitmap",
                       segment_bytes=seg)
    rng = np.random.default_rng(5)
    fams = []
    for m in models:
        ps = PagedRecurrentState(m.cfg, m, 2, pool)
        state = m.init_paged_state(2, 2, 8)
        for slot in range(2):
            ps.admit(slot, f"{m.cfg.name}:req{slot}")
            leaves = [torch.from_numpy(rng.standard_normal(tuple(t.shape))
                                       .astype(np.float32)).to(t.dtype)
                      for t in m.read_state_row(state, slot)]
            m.write_state_row(state, slot, leaves)
        fams.append((m, ps, state))
    want = [[[t.clone() for t in m.read_state_row(st, s)] for s in range(2)]
            for m, _, st in fams]
    for f in order:
        m, ps, st = fams[f]
        _, moved = ps.park(st, 1)
        assert moved == ps.blocks_per_slot == ps.swapped_blocks(1)
        assert all(not t.any() for t in m.read_state_row(st, 1))
        assert pool.refcounts_consistent()
    for f in order:
        m, ps, st = fams[f]
        _, back = ps.refault(st, 1)
        assert back == ps.blocks_per_slot and ps.swapped_blocks(1) == 0
        for s in range(2):
            for a, b in zip(m.read_state_row(st, s), want[f][s]):
                assert torch.equal(a, b)
    for m, ps, _ in fams:
        for s in range(2):
            ps.release(s)
        assert ps.pages_leased == ps.pages_freed
    assert pool.memory_stats()["segments_in_use"] == 0
