"""The KV page hierarchy in the port — refcounted prefix sharing,
copy-on-write and the host swap tier — held against the reference's
scenarios (tests/test_kv_hierarchy.py) and against its JAX engine on the
same converted weights, on the CPU.

Pool level: frame refcounts freed exactly at the last drop, a fork that
remaps only the forker, the refcount lifecycle under random
interleavings. Cache level: prefix-cache pins survive the owner's free.
Engine level (reduced configs in fp32 compute, so token ids compare
exactly): warm admission matches cold, a swap round trip restores every
KV byte, a pressured pool with swap on completes every request with the
unpressured ids, and recurrentgemma parks and refaults its state rows —
each with the JAX engine's ids; a family with recurrent rows is refused
a shared prefix. Page helpers: ``read_kv_page`` leaves
equal the reference's, leaf by leaf and byte for byte, and the copy and
scatter agree with its own. The SLO plane's relief hooks are the
reference's. The reference's autoscaler case
(``test_autoscaler_swap_relief_replaces_grow_blocked``) waits for the
port of ``core/autoscaler.py`` (ROADMAP queue 1 item 9).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:            # fall back to seeded-random sweeps
    from _hyp_fallback import given, settings, strategies as st

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serving import ServeEngine as JaxServeEngine
from repro.core.mmu import SegmentPool as JaxSegmentPool
from repro_torch.bridge import params_from_jax, state_rows_from_jax
from repro_torch.configs import get_config
from repro_torch.core.mmu import SWAPPED, OutOfMemory, SegmentPool
from repro_torch.models import Model
from repro_torch.obs import PHASE_REFAULT, PHASE_SWAP_OUT, ObsHub
from repro_torch.serving import PrefixCache, ServeEngine

torch.set_num_threads(2)

SEG = 1 << 12


def _pool(n_segs):
    return SegmentPool(total_bytes=n_segs * SEG, backend="bitmap",
                       segment_bytes=SEG)


# ===========================================================================
# MMU frame refcounts
# ===========================================================================

def test_frame_freed_exactly_at_last_ref_drop():
    """A frame shared by three tables survives the first two frees and
    returns to the pool exactly when the last ref drops."""
    pool = _pool(8)
    base = pool.alloc_pages(2, "a")
    shared = list(base.pages)
    t1 = pool.alloc_pages(1, "b", shared_prefix=shared)
    t2 = pool.alloc_pages(0, "c", shared_prefix=shared)
    assert all(pool.frame_ref(p) == 3 for p in shared)
    pool.free_pages(base.handle, "a")
    assert all(pool.frame_ref(p) == 2 for p in shared)
    pool.free_pages(t1.handle, "b")          # also drops t1's private page
    assert all(pool.frame_ref(p) == 1 for p in shared)
    assert pool.memory_stats()["segments_in_use"] == 2
    pool.free_pages(t2.handle, "c")
    assert pool.memory_stats()["segments_in_use"] == 0
    assert pool.refcounts_consistent()


def test_fork_page_remaps_only_the_forker():
    pool = _pool(8)
    base = pool.alloc_pages(2, "a")
    t2 = pool.alloc_pages(1, "b", shared_prefix=list(base.pages))
    shared0 = base.pages[0]
    assert pool.frame_ref(shared0) == 2
    old, new = pool.fork_page(t2.handle, "b", 0)
    assert old == shared0 and new != old
    assert t2.pages[0] == new                # forker remapped …
    assert base.pages[0] == shared0          # … sharer untouched
    assert pool.frame_ref(shared0) == 1 and pool.frame_ref(new) == 1
    assert pool.refcounts_consistent()
    pool.free_pages(t2.handle, "b")
    pool.free_pages(base.handle, "a")
    assert pool.memory_stats()["segments_in_use"] == 0


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**32 - 1))
def test_refcount_lifecycle_random_interleavings(seed):
    """Random share/fork/pin/swap/free interleavings: refcounts stay
    consistent after every op, and tearing everything down empties the
    pool."""
    rng = np.random.default_rng(seed)
    pool = _pool(24)
    base = pool.alloc_pages(int(rng.integers(1, 4)), "base")
    tables = [("base", base)]
    pins = []
    for i in range(int(rng.integers(1, 5))):
        k = int(rng.integers(0, base.n_pages + 1))
        try:
            t = pool.alloc_pages(int(rng.integers(1, 3)), f"t{i}",
                                 shared_prefix=list(base.pages[:k]) or None)
        except OutOfMemory:
            break
        tables.append((f"t{i}", t))
        assert pool.refcounts_consistent()
    for _ in range(int(rng.integers(0, 10))):
        op = int(rng.integers(0, 4))
        owner, t = tables[int(rng.integers(0, len(tables)))]
        blk = int(rng.integers(0, t.n_pages))
        page = t.pages[blk]
        if page == SWAPPED:
            if op == 0:
                pool.swap_in_page(t.handle, owner, blk)
        elif op == 0 and pool.frame_ref(page) > 1:
            try:
                pool.fork_page(t.handle, owner, blk)
            except OutOfMemory:
                break
        elif op == 1:
            pool.retain_frame(page)
            pins.append(page)
        elif op == 2 and pool.frame_ref(page) == 1:
            pool.swap_out_page(t.handle, owner, blk)
        assert pool.refcounts_consistent()
    for p in pins:
        pool.release_frame(p, owner="pin")
        assert pool.refcounts_consistent()
    order = list(range(len(tables)))
    rng.shuffle(order)
    for idx in order:
        owner, t = tables[idx]
        pool.free_pages(t.handle, owner)
        assert pool.refcounts_consistent()
    assert pool.memory_stats()["segments_in_use"] == 0


def test_prefix_cache_pins_survive_owner_free():
    pool = _pool(8)
    table = pool.alloc_pages(2, "a")
    pages = list(table.pages)
    pc = PrefixCache(pool, 8)
    prompt = np.arange(16, dtype=np.int32)
    assert pc.insert(prompt, pages) == 2
    pool.free_pages(table.handle, "a")       # owner EOS: pins hold on
    assert pool.memory_stats()["segments_in_use"] == 2
    probe = np.concatenate([prompt, np.arange(5, dtype=np.int32)])
    shared, frames = pc.lookup(probe, max_tokens=len(probe) - 1)
    assert shared == 16 and frames == pages
    # different history, same length: the hash chain must not match
    assert pc.lookup(probe + 1, max_tokens=len(probe) - 1)[0] == 0
    assert pc.evict_all() == 2               # dropping pins frees frames
    assert pool.memory_stats()["segments_in_use"] == 0
    assert pc.lookup(probe, max_tokens=len(probe) - 1)[0] == 0


# ===========================================================================
# Engine scenarios, held against the JAX engine on converted weights
# ===========================================================================

def _pair(arch, seed):
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return (jcfg, jm, jp), (cfg, Model(cfg, device="cpu"),
                            params_from_jax(jax.device_get(jp)))


@pytest.fixture(scope="module")
def qwen():
    return _pair("qwen1.5-0.5b", 0)


def _family_prompts(vocab, n=3, prefix_tokens=16):
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, size=(prefix_tokens,))
    return [np.concatenate([prefix, rng.integers(0, vocab, size=(5 + j,))])
            .astype(np.int32) for j in range(n)]


def _engine(side, cfg, model, B, cap, pool_pages=None, **kw):
    """A port (``side`` "port") or JAX ("jax") engine; ``pool_pages``
    sizes its own pool in KV pages of 8 tokens."""
    if pool_pages is not None:
        pb = model.kv_page_bytes(8)
        cls = SegmentPool if side == "port" else JaxSegmentPool
        kw["pool"] = cls(total_bytes=pool_pages * pb, backend="bitmap",
                         segment_bytes=pb)
    eng_cls = ServeEngine if side == "port" else JaxServeEngine
    return eng_cls(cfg, model, B, cap, page_size=8, **kw)


def test_warm_admission_shares_pages_and_matches_cold(qwen):
    """Requests sharing a 2-page prefix, submitted one after another so
    each sees the pages the one before published: the same greedy ids
    with sharing on and off and as the JAX engine with sharing on, fewer
    prefill chunks, CoW forks fired (the pinned partial tail makes the
    first decode write hit refcount 2), and the obs counters recorded."""
    (jcfg, jm, jp), (cfg, m, p) = qwen
    prompts = _family_prompts(cfg.vocab)
    outs, chunks = {}, {}
    for side, share in (("port", False), ("port", True), ("jax", True)):
        hub = ObsHub(enabled=True) if side == "port" else None
        c, model, params = (cfg, m, p) if side == "port" else (jcfg, jm, jp)
        eng = _engine(side, c, model, 2, 64, chunk_tokens=8,
                      share_prefix=share, obs=hub, obs_tenant="t")
        rids = []
        for prompt in prompts:
            rids.append(eng.submit(prompt, max_new_tokens=4,
                                   temperature=0.0))
            eng.run_round(params)
        outs[side, share] = [eng.completed[r].out_tokens for r in rids]
        chunks[side, share] = eng.stats.prefill_chunks
        if side == "port" and share:
            s = eng.stats
            assert s.shared_prefix_hits == 2
            assert s.shared_prefix_tokens == 32          # 2 × 2 pages
            assert s.cow_forks > 0
            assert eng.kv.no_double_mapping()
            assert eng.kv.prefix.stats()["entries"] > 0
            snap = hub.registry.snapshot()
            assert "kv_shared_pages_total" in snap["counters"]
            assert "kv_cow_forks_total" in snap["counters"]
            port_eng = eng
        if side == "jax":
            js = eng.stats
            assert (js.shared_prefix_hits, js.shared_prefix_tokens,
                    js.cow_forks) == (s.shared_prefix_hits,
                                      s.shared_prefix_tokens, s.cow_forks)
    assert outs["port", True] == outs["port", False] == outs["jax", True]
    assert chunks["port", True] < chunks["port", False]
    assert chunks["port", True] == chunks["jax", True]
    # after EOS only the prefix pins hold frames; shedding them drains
    # the pool — no leaked refs from shared mappings
    assert port_eng.kv.pool.refcounts_consistent()
    port_eng.kv.prefix.evict_all()
    assert port_eng.kv.memory_stats()["segments_in_use"] == 0


def test_swap_roundtrip_restores_kv_bytes_exactly(qwen):
    """Park a decoding slot (device→host gather), resume it (host→device
    scatter): every KV page byte-identical, the host tier empty
    afterwards, and generation completes with the ids of an unswapped
    port run and of the JAX engine."""
    (jcfg, jm, jp), (cfg, m, p) = qwen
    prompt = (np.arange(20) % cfg.vocab).astype(np.int32)
    ref = ServeEngine(cfg, m, 2, 64, page_size=8, chunk_tokens=8)
    r_ref = ref.submit(prompt, max_new_tokens=6, temperature=0.0)
    ref.run_round(p)
    jref = JaxServeEngine(jcfg, jm, 2, 64, page_size=8, chunk_tokens=8)
    j_ref = jref.submit(prompt, max_new_tokens=6, temperature=0.0)
    jref.run_round(jp)

    eng = ServeEngine(cfg, m, 2, 64, page_size=8, chunk_tokens=8, swap=True)
    rid = eng.submit(prompt, max_new_tokens=6, temperature=0.0)
    while eng.stats.prefills == 0:           # prefill + first token
        eng.step(p)
    kv = eng.kv
    pages = list(kv.tables[0].pages)
    before = [[t.clone() for t in m.read_kv_page(kv.state, pg)]
              for pg in pages]
    in_use0 = kv.memory_stats()["segments_in_use"]
    assert eng._park(0)
    assert kv.swapped_blocks(0) == len(pages)
    assert len(kv.swap_tier) == len(pages)
    assert kv.memory_stats()["segments_in_use"] == in_use0 - len(pages)
    assert eng.positions[0] == -1
    for pg in pages:                 # the freed frames: poisoned with NaN
        poison = [torch.full_like(t, float("nan"))
                  for t in m.read_kv_page(kv.state, pg)]
        m.write_kv_page(kv.state, pg, poison)

    eng._try_resume()
    assert 0 not in eng._parked and eng.positions[0] >= 0
    assert len(kv.swap_tier) == 0
    for b, want in enumerate(before):
        got = m.read_kv_page(kv.state, kv.tables[0].pages[b])
        for x, y in zip(want, got):
            assert x.dtype == y.dtype and torch.equal(x, y), \
                f"page {b} KV bytes changed across the swap round trip"
    eng.run_round(p)
    assert eng.completed[rid].out_tokens == ref.completed[r_ref].out_tokens \
        == jref.completed[j_ref].out_tokens
    assert eng.stats.swap_outs == eng.stats.swap_ins == len(pages)


def _pressure_run(side, cfg, model, params, prompts, pool_pages, swap,
                  hub=None, **kw):
    eng = _engine(side, cfg, model, 4, 64, pool_pages=pool_pages,
                  chunk_tokens=32, swap=swap, obs=hub, obs_tenant="t", **kw)
    rids = [eng.submit(pr, max_new_tokens=12, temperature=0.0)
            for pr in prompts]
    eng.run_round(params)
    return [eng.completed[r].out_tokens for r in rids], eng


def test_swap_pressure_outputs_exact_and_complete(qwen):
    """A pool at ~28% of the working set with swap on: every request gets
    its full token budget, ids equal an unpressured run and the JAX
    engine under the same pressure (denials became swaps, not
    truncations), and the telemetry plane saw it."""
    (jcfg, jm, jp), (cfg, m, p) = qwen
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, size=(24,)).astype(np.int32)
               for _ in range(6)]
    ref, _ = _pressure_run("port", cfg, m, p, prompts, None, False)
    hub = ObsHub(enabled=True)
    got, eng = _pressure_run("port", cfg, m, p, prompts, 9, True, hub)
    want, jeng = _pressure_run("jax", jcfg, jm, jp, prompts, 9, True)
    assert got == ref == want
    assert all(len(o) == 12 for o in got)
    s = eng.stats
    assert s.swap_outs > 0 and s.swap_ins > 0
    assert s.swap_outs == s.swap_ins == jeng.stats.swap_outs
    assert s.pages_leased == s.pages_freed
    assert len(eng.kv.swap_tier) == 0
    assert eng.kv.pool.refcounts_consistent()
    assert eng.kv.memory_stats()["segments_in_use"] == 0
    snap = hub.registry.snapshot()
    for c in ("kv_swapped_pages_total", "kv_refaults_total",
              "kv_swap_bytes_total"):
        assert c in snap["counters"], f"missing counter {c}"
    for h in ("kv_swap_out_s", "kv_refault_s"):
        assert h in snap["histograms"], f"missing histogram {h}"
    phases = [ph for sp in hub.tracer.spans("t") for ph in sp.phases()]
    assert PHASE_SWAP_OUT in phases and PHASE_REFAULT in phases


def test_recurrent_state_swap_keeps_the_ids():
    """recurrentgemma with paged state rows and swap on, on a 9-page pool:
    parked slots move their KV pages and state rows to the host tier
    (``state_swap_outs`` > 0) and refault them, and the ids equal the
    unpressured run and the JAX engine's under the same pressure."""
    (jcfg, jm, jp), (cfg, m, p) = _pair("recurrentgemma-2b", 1)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=(24,)).astype(np.int32)
               for _ in range(6)]
    kw = {"state_paging": True}
    ref, _ = _pressure_run("port", cfg, m, p, prompts, None, False, **kw)
    got, eng = _pressure_run("port", cfg, m, p, prompts, 9, True, **kw)
    want, jeng = _pressure_run("jax", jcfg, jm, jp, prompts, 9, True, **kw)
    assert got == ref == want
    assert all(len(o) == 12 for o in got)
    s, js = eng.stats, jeng.stats
    assert s.state_swap_outs > 0
    assert s.state_swap_outs == s.state_swap_ins == js.state_swap_outs
    assert s.swap_outs == s.swap_ins == js.swap_outs
    assert s.state_pages_leased == s.state_pages_freed > 0
    assert eng.kv.memory_stats()["segments_in_use"] == 0


@pytest.mark.parametrize("surface", ["engine", "serve"])
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b"])
def test_prefix_sharing_refused_for_recurrent_rows(arch, surface):
    """A shared prefix carries KV pages only: a family with recurrent
    state rows would decode from rows that never saw the prefix, so the
    engine and ``serve --share-prefix`` refuse it (the reference accepts
    it and decodes wrong tokens; ROADMAP queue 3)."""
    if surface == "engine":
        cfg = get_config(arch, reduced=True)
        with pytest.raises(NotImplementedError, match="prefix sharing"):
            ServeEngine(cfg, Model(cfg, device="cpu"), 2, 64, page_size=8,
                        chunk_tokens=8, share_prefix=True)
    else:
        from repro_torch.launch.serve import main
        with pytest.raises(SystemExit) as e:
            main(["--device", "cpu", "--arch", arch, "--chunk-tokens", "8",
                  "--share-prefix", "--requests", "1"])
        assert e.value.code == 2


# ===========================================================================
# Page helpers against the reference's
# ===========================================================================

@pytest.mark.parametrize("arch,kw", [
    ("qwen1.5-0.5b", {}),
    ("qwen1.5-0.5b", {"scan": False}),
    ("recurrentgemma-2b", {"n_layers": 5}),
])
def test_kv_page_helpers_match_reference(arch, kw):
    """On one random paged state: ``read_kv_page`` gives the reference's
    leaves in its order (layout site by site, k then v), byte for byte;
    ``copy_kv_page`` and ``write_kv_page`` leave the pools the
    reference's helpers leave."""
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    if "scan" in kw:
        rep = {"sharding": dataclasses.replace(jcfg.sharding,
                                               scan_layers=False)}
        jcfg = dataclasses.replace(jcfg, **rep)
        cfg = dataclasses.replace(cfg, sharding=dataclasses.replace(
            cfg.sharding, scan_layers=False))
    if "n_layers" in kw:
        jcfg = dataclasses.replace(jcfg, n_layers=kw["n_layers"])
        cfg = dataclasses.replace(cfg, n_layers=kw["n_layers"])
    jm, m = jax_build_model(jcfg), Model(cfg, device="cpu")
    rng = np.random.default_rng(4)
    host = jax.tree.map(
        lambda a: np.asarray(rng.standard_normal(a.shape), a.dtype),
        jax.device_get(jm.init_paged_state(2, 5, 8)))
    ts = state_rows_from_jax(host, cfg)
    js = jax.tree.map(jnp.asarray, host)

    def same(got, want):
        want = jax.device_get(want)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            b = np.asarray(b)
            assert tuple(a.shape) == b.shape
            assert a.view(torch.int16).numpy().view(np.uint16).tobytes() \
                == b.view(np.uint16).tobytes()

    for page in range(5):
        same(m.read_kv_page(ts, page), jm.read_kv_page(js, page))
    js = jm.copy_kv_page(js, jnp.int32(1), jnp.int32(3))
    m.copy_kv_page(ts, torch.tensor([1]), torch.tensor([3]))
    leaves = jm.read_kv_page(js, 0)
    js = jm.write_kv_page(js, 4, leaves)
    m.write_kv_page(ts, 4, m.read_kv_page(ts, 0))
    for page in range(5):
        same(m.read_kv_page(ts, page), jm.read_kv_page(js, page))


# ===========================================================================
# Control plane: swap-before-deny hooks of the SLO plane
# ===========================================================================

def _pool_tenant(name, n_segs=8):
    from repro_torch.core.shell import CompletionQueue
    from repro_torch.core.tenant import Tenant
    return Tenant(name=name, vslice=None,
                  pool=SegmentPool(total_bytes=n_segs * SEG,
                                   segment_bytes=SEG),
                  cq=CompletionQueue())


def _slo_plane(**kw):
    from repro_torch.core.interposition import OpLog
    from repro_torch.core.scheduler import make_data_plane
    return make_data_plane("slo", oplog=OpLog(), pressure_refresh_s=0.0,
                           deny_hold_s=0.0, **kw)


def test_slo_relief_cb_converts_denial_to_admission():
    """Hard MMU pressure that would deny admission asks the relief hook
    (the engine's swap path) to shed pages; when it succeeds the op is
    admitted and counted as pressure_relieved."""
    state = {}

    def relief(name):
        state["asked"] = name
        t.pool.free(state["lease"].handle, "hog")    # swap freed pages
        return True

    plane = _slo_plane(relief_cb=relief)
    t = _pool_tenant("hog")
    plane.register(t)
    try:
        state["lease"] = t.pool.alloc(8 * SEG, "hog")  # occupancy 1.0
        assert plane.submit(t, "run", lambda: 7, {}).result(timeout=5) == 7
        assert state["asked"] == "hog"
        s = plane.stats()["tenants"]["hog"]
        assert s["pressure_relieved"] == 1
        assert s["admission_denied"] == 0
    finally:
        plane.shutdown()


def test_slo_relief_cb_failure_still_denies():
    from repro_torch.core.scheduler import AdmissionPressure
    plane = _slo_plane(relief_cb=lambda name: False)
    t = _pool_tenant("hog")
    plane.register(t)
    try:
        t.pool.alloc(8 * SEG, "hog")
        fut = plane.submit(t, "run", lambda: 7, {})
        assert isinstance(fut.exception(timeout=5), AdmissionPressure)
        s = plane.stats()["tenants"]["hog"]
        assert s["pressure_relieved"] == 0 and s["admission_denied"] == 1
    finally:
        plane.shutdown()
