"""Ring caches and the VMM's programs for the recurrent families:
``recurrentgemma-2b`` (rglru, rglru, swa) and ``rwkv6-7b`` (rwkv with
channel-mix), the port against the reference's JAX package on the same
weights (carried across by ``repro_torch.bridge``), on the CPU.

Tolerances: logits and K/V caches at 1e-5 in fp32 compute (the
reference runs its Pallas kernels in interpret mode,
``use_pallas=True``); the recurrent state rows at 1e-4, since the RWKV
state sums k·v outer products of magnitude ~20 over the prompt and the
two WKV forms sum in different orders (3.5e-5 apart here); the bridge's
round trip byte-exact; token ids exactly — the engine's (fp32) against
the JAX engine's, and the programs' (the configs' bf16) against the
port's native decode, which does the same arithmetic; against the JAX
programs, bf16 logits at 5e-2 (see the programs test).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_config as jax_get_config
from repro.core import VMM as JaxVMM
from repro.core.reconfig import ProgramRequest as JaxProgramRequest
from repro.models import build_model as jax_build_model
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.bridge import (caches_from_jax, caches_to_numpy,
                                params_from_jax)
from repro_torch.configs import get_config
from repro_torch.core import VMM, ProgramRequest
from repro_torch.models import Model
from repro_torch.serving import ServeEngine, pool_pressure_gate

torch.set_num_threads(2)

ARCHS = ["recurrentgemma-2b", "rwkv6-7b"]
CPU = torch.device("cpu")
TOL = 1e-5
ROW_TOL = 1e-4
BF16_TOL = 5e-2


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               compute_dtype="float32", **kw)
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32", **kw)
    return jcfg, cfg


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg, cfg = _cfgs(request.param)
    jm = jax_build_model(dataclasses.replace(jcfg, use_pallas=True))
    jp = jm.init(jax.random.PRNGKey(2))
    return cfg, jm, jp, Model(cfg, device="cpu"), params_from_jax(
        jax.device_get(jp))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _toks(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _assert_caches(cfg, tc, jc):
    """Every leaf of the port's caches, state rows included, equals the
    reference's after the bridge."""
    ref = caches_from_jax(jax.device_get(jc), cfg)
    assert sorted(tc) == sorted(ref)
    for kk in ("k", "v"):
        if kk in ref:
            _close(tc[kk], ref[kk].numpy())
    for got, want in zip(tc.get("rows", ()), ref.get("rows", ())):
        assert sorted(got) == sorted(want)
        for key in want:
            for name, leaf in want[key].items():
                _close(got[key][name], leaf.numpy(), ROW_TOL)


@pytest.mark.parametrize("C,S", [(12, 10), (8, 13)])
def test_ring_decode_matches_reference(pair, C, S):
    """JAX ``prefill(capacity=C)`` plus 8 ring ``decode`` steps against the
    port's, C below the window (16), so the swa ring wraps: logits at
    every step and the caches, state rows included, at the end."""
    cfg, jm, jp, m, p = pair
    toks = _toks(2, S, cfg.vocab, 9)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, capacity=C)
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(toks)}, capacity=C)
    _close(tl[:, :cfg.vocab], np.asarray(jl)[:, :cfg.vocab])
    _assert_caches(cfg, tc, jc)
    jdec = jax.jit(jm.decode)
    tok = np.argmax(np.asarray(jl)[:, :cfg.vocab], -1)[:, None].astype(
        np.int32)
    for i, pos in enumerate(range(S, S + 8)):
        jl, jc = jdec(jp, jc, jnp.asarray(tok), jnp.int32(pos))
        tpos = pos if i % 2 else torch.tensor(pos, dtype=torch.int32)
        tl, tc = m.decode(p, tc, torch.from_numpy(tok), tpos)
        _close(tl[:, :cfg.vocab], np.asarray(jl)[:, :cfg.vocab])
        tok = np.argmax(np.asarray(jl)[:, :cfg.vocab], -1)[:, None].astype(
            np.int32)
    _assert_caches(cfg, tc, jc)


def test_swa_ring_of_the_window_and_the_reference_ring_agree():
    """Capacity 24 above recurrentgemma's window of 16: the port's prefill
    keeps a 16-slot swa ring, the reference a 24-slot one masked to the
    window at decode. Both forms decode in the port (the reference's
    through the bridge, the window handed to the ring op) to the
    reference's logits, past a wrap of either ring."""
    jcfg, cfg = _cfgs("recurrentgemma-2b")
    jm = jax_build_model(dataclasses.replace(jcfg, use_pallas=True))
    jp = jm.init(jax.random.PRNGKey(5))
    m, p = Model(cfg, device="cpu"), params_from_jax(jax.device_get(jp))
    toks = _toks(2, 20, cfg.vocab, 4)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, capacity=24)
    _, own = m.prefill(p, {"tokens": torch.from_numpy(toks)}, capacity=24)
    assert own["k"].shape[2] == 16 == m.init_cache(2, 24)["k"].shape[2]
    bridged = caches_from_jax(jax.device_get(jc), cfg)
    assert bridged["k"].shape[2] == 24
    jdec = jax.jit(jm.decode)
    tok = np.argmax(np.asarray(jl)[:, :cfg.vocab], -1)[:, None].astype(
        np.int32)
    for pos in range(20, 30):
        jl, jc = jdec(jp, jc, jnp.asarray(tok), jnp.int32(pos))
        for tc in (own, bridged):
            tl, _ = m.decode(p, tc, torch.from_numpy(tok), pos)
            _close(tl[:, :cfg.vocab], np.asarray(jl)[:, :cfg.vocab])
        tok = np.argmax(np.asarray(jl)[:, :cfg.vocab], -1)[:, None].astype(
            np.int32)


@pytest.mark.parametrize("arch,n_layers", [("recurrentgemma-2b", 5),
                                           ("recurrentgemma-2b", 3),
                                           ("rwkv6-7b", 2)])
def test_bridge_round_trip_is_exact(arch, n_layers):
    """Every layout segment of the reference — a scan segment stacked on
    its periods axis and, at 5 layers, an unrolled (rglru, rglru) tail —
    crosses both ways byte for byte, ``"mixer"`` and ``"ffn"`` leaves and
    state rows; ``init_cache`` has the reference's shapes and dtypes."""
    jcfg, cfg = _cfgs(arch, n_layers=n_layers)
    jm = jax_build_model(jcfg)
    rng = np.random.default_rng(1)
    jc = jax.tree.map(
        lambda a: np.asarray(rng.standard_normal(a.shape), a.dtype),
        jax.device_get(jm.init_cache(2, 12)))
    back = caches_to_numpy(caches_from_jax(jc, cfg), cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(jc)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), path
    mine = caches_to_numpy(Model(cfg, device="cpu").init_cache(2, 12), cfg)
    for (path, a), (_, b) in zip(
            flat_a, jax.tree_util.tree_leaves_with_path(mine)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert not np.asarray(b).any()


# ===========================================================================
# The VMM's programs (steps.build_prefill / build_decode)
# ===========================================================================

def _grid():
    g = np.empty((1, 1), dtype=object)
    g[0, 0] = CPU
    return g


def _greedy_program_ids(pf, dc, params, toks, S, n, vocab, jax_side,
                        forced=None):
    """Prefill ``toks`` then ``n`` decode steps at pos S…S+n-1, each fed
    the greedy id of the step before (or ``forced``'s) → (the greedy ids
    step by step, the logits of each step as fp32 numpy)."""
    arr = jnp.asarray if jax_side else torch.from_numpy
    logits, caches = pf(params, {"tokens": arr(toks)})
    ids, seen = [], []
    for i, pos in enumerate(range(S, S + n)):
        lg = np.asarray(logits if jax_side else logits.float(),
                        np.float32)[:, :vocab]
        seen.append(lg)
        ids.append(np.argmax(lg, -1).tolist())
        tok = np.asarray(ids[-1] if forced is None else forced[i],
                         np.int32)[:, None]
        pos_t = jnp.int32(pos) if jax_side else torch.tensor(
            pos, dtype=torch.int32)
        logits, caches = dc(params, caches, arr(tok), pos_t)
    return ids, seen


@pytest.mark.parametrize("arch,S", [("recurrentgemma-2b", 16),
                                    ("recurrentgemma-2b", 24),
                                    ("rwkv6-7b", 16)])
def test_programs_through_a_port_vmm(arch, S):
    """The prefill (capacity S, the program's seq_len) and decode programs
    of one family, reprogrammed into a port tenant on a CPU grid and run
    through the guest API for 10 greedy steps that wrap the rings: the
    ids equal native port ``prefill``/``decode``. Against the JAX VMM's
    programs on the same bf16 weights, each package fed the JAX ids, the
    logits agree within 5e-2 (the bf16 value of
    tests/test_kernel_integration.py) and so do the ids wherever the
    reference's top two logits lie further apart: greedy bf16 ids of
    two packages part ways at the first near-tie (rwkv6's do at its 8th
    step here).

    At S = 24, above the reduced window of 16, the reference's prefill
    program gives its swa layer a 24-slot ring while its decode program
    was built for ``init_cache``'s 16-slot one, and the decode program
    refuses the prefill's caches (a fault of the reference, pinned here);
    the port's prefill gives the 16-slot ring, so its programs chain."""
    B, n = 2, 10
    cfg = get_config(arch, reduced=True)
    vmm = VMM(_grid(), hbm_per_chip=1 << 28, segment_bytes=1 << 20)
    jvmm = JaxVMM(Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                       ("data", "model")), hbm_per_chip=1 << 28,
                  segment_bytes=1 << 20)
    try:
        dev = vmm.create_vm("a", (1, 1)).device
        jdev = jvmm.create_vm("a", (1, 1)).device
        jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                          jax_build_model(jax_get_config(
                              arch, reduced=True)).init(
                                  jax.random.PRNGKey(6)))
        p = params_from_jax(jax.device_get(jp))
        toks = _toks(B, S, cfg.vocab, 3)

        def programs(device, request):
            """(prefill, decode) through ``device``: the prefill program
            is loaded, run, and replaced by the decode program."""
            def pf(*a):
                device.reprogram(request(arch, "prefill", S, B))
                out = device.run(*a)
                device.reprogram(request(arch, "decode", S, B))
                return out
            return pf, device.run

        model = Model(cfg, device="cpu")
        native, _ = _greedy_program_ids(
            lambda *a: model.prefill(*a, capacity=S), model.decode, p, toks,
            S, n, cfg.vocab, False)
        got, _ = _greedy_program_ids(*programs(dev, ProgramRequest), p,
                                     toks, S, n, cfg.vocab, False)
        assert got == native
        st = vmm.stats()
        assert st["crc_failures"] == 0 and st["reconfigs"] == 2
        jpf, jdc = programs(jdev, JaxProgramRequest)
        if "swa" in cfg.block_pattern and S > cfg.window:
            with pytest.raises(TypeError, match="caches"):
                _greedy_program_ids(jpf, jdc, jp, toks, S, n, cfg.vocab,
                                    True)
            return
        want, jlogits = _greedy_program_ids(jpf, jdc, jp, toks, S, n,
                                            cfg.vocab, True)
        # fed the JAX programs' ids, the port's programs give their
        # logits within bf16's 5e-2 and the same id wherever the JAX
        # top two are further apart than that
        forced, mlogits = _greedy_program_ids(
            *programs(dev, ProgramRequest), p, toks, S, n, cfg.vocab, False,
            forced=want)
        for step, (a, b) in enumerate(zip(mlogits, jlogits)):
            np.testing.assert_allclose(a, b, atol=BF16_TOL, rtol=BF16_TOL)
            top2 = np.sort(b, -1)[:, -2:]
            sure = top2[:, 1] - top2[:, 0] > 2 * BF16_TOL
            assert (np.asarray(forced[step])[sure]
                    == np.asarray(want[step])[sure]).all(), step
    finally:
        vmm.shutdown()
        jvmm.shutdown()


# ===========================================================================
# serve --virtualized for the recurrent families
# ===========================================================================

def _mediate(tenant, writable=False):
    def wrap(fn):
        def run(*a):
            tenant.program = fn
            out, state = tenant.device.run(*a)
            return (np.array(out) if writable else out), state
        return run
    return wrap


def _serve(engine, params, vocab):
    rng = np.random.default_rng(0)
    rids = [engine.submit(rng.integers(0, vocab, (n,)),
                          max_new_tokens=4 + (j % 3), temperature=0.0)
            for j, n in enumerate((5, 9, 13, 17, 11))]
    engine.run_round(params)
    return [engine.completed[r].out_tokens for r in rids]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("chunk", [0, 8])
def test_engine_through_a_port_vmm_gives_native_ids(arch, chunk):
    """Both families through a port VMM tenant (policy ``slo``, paged
    recurrent state, KV and state pages from the tenant's pool) give the
    port's native ids and the JAX engine's through a JAX VMM tenant,
    monolithic and chunked; every page returns."""
    jcfg, cfg = _cfgs(arch)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    m, p = Model(cfg, device="cpu"), params_from_jax(jax.device_get(jp))
    kw = dict(page_size=8, chunk_tokens=chunk, seed=3, state_paging=True)
    native = _serve(ServeEngine(cfg, m, 2, 64, **kw), p, cfg.vocab)

    vmm = VMM(_grid(), policy="slo", hbm_per_chip=1 << 28,
              segment_bytes=1 << 20)
    t = vmm.create_vm("server", (1, 1), sched_slo_wait_s=0.05)
    t.device.open()
    eng = ServeEngine(cfg, m, 2, 64, pool=t.pool, prefill_wrap=_mediate(t),
                      decode_wrap=_mediate(t),
                      admission_gate=pool_pressure_gate(t.pool), **kw)
    got = _serve(eng, p, cfg.vocab)
    st = vmm.stats()
    vmm.shutdown()

    jvmm = JaxVMM(Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                       ("data", "model")), policy="slo",
                  hbm_per_chip=1 << 28, segment_bytes=1 << 20)
    jt = jvmm.create_vm("server", (1, 1), sched_slo_wait_s=0.05)
    jt.device.open()
    jeng = JaxServeEngine(jcfg, jm, 2, 64, pool=jt.pool,
                          prefill_wrap=_mediate(jt),
                          decode_wrap=_mediate(jt, writable=True), **kw)
    want = _serve(jeng, jp, cfg.vocab)
    jvmm.shutdown()

    assert got == native == want
    s = eng.stats
    assert s.full_prefills == 0 and s.pages_leased == s.pages_freed > 0
    assert s.state_pages_leased == s.state_pages_freed > 0
    assert st["scheduler"]["tenants"]["server"]["failed"] == 0
    assert st["memory"]["server"]["pages_in_use"] == 0
