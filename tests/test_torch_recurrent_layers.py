"""The recurrent families' kernels and layers in the port against the
reference's JAX package: the RG-LRU scan and the RWKV-6 WKV plain
versions against the reference's Pallas kernels (interpret mode on the
CPU, as tests/test_kernels.py runs them), the no-new-token paged decode,
the recurrent layers and layernorm on carried-over parameters (fp32
compute), the bridge's multi-segment layouts (parameters and paged
state, byte-exact), the host swap tier, and ``PagedRecurrentState``'s
lifecycle under random interleavings (tests/test_model_mux.py's
property, on the port's class).

Tolerances: the scan at 2e-4 and the WKV at 2e-3 (the reference's own
kernel-test tolerances; the WKV's chunked form sums in another order);
the paged decode at 2e-5 (fp32, online-softmax reassociation only);
layers at 1e-4 for the full-sequence forms (associative or chunked scan
against the sequential one) and 1e-5 for the one-token forms and the
norm (1e-2 for a bf16 norm: one bf16 rounding).
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
from repro.kernels.decode_attention.ops import \
    decode_attention_op as jax_decode
from repro.kernels.rglru_scan.ops import rglru_scan_op as jax_rglru
from repro.kernels.rwkv6_wkv.ops import rwkv6_wkv_op as jax_wkv
from repro.models import build_model as jax_build_model
from repro.models import layers as jlayers
from repro.models import recurrent as jrec
from repro_torch.bridge import (params_from_jax, params_to_numpy,
                                state_rows_from_jax, state_rows_to_numpy)
from repro_torch.configs import get_config
from repro_torch.core.mmu import SWAPPED, MMUError, SegmentPool
from repro_torch.kernels.decode_attention.ops import decode_attention_op
from repro_torch.kernels.rglru_scan.ops import rglru_scan_op
from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv_op
from repro_torch.models import recurrent as rec
from repro_torch.models.layers import apply_norm, init_norm
from repro_torch.serving import HostSwapTier, PagedRecurrentState

torch.set_num_threads(2)



def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(tree):
    """A JAX parameter dict (leaves as numpy) → torch tensors."""
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return _t(jax.device_get(tree))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, np.float32),
        np.asarray(want, np.float32), atol=tol, rtol=tol)


# ===========================================================================
# Kernels: plain versions against the reference's Pallas kernels
# ===========================================================================

@pytest.mark.parametrize("S,D", [(64, 128), (100, 300), (256, 512)])
def test_rglru_scan_matches_pallas(S, D):
    rng = np.random.default_rng(S + D)
    a = rng.uniform(0.5, 0.999, (2, S, D)).astype(np.float32)
    b = rng.standard_normal((2, S, D)).astype(np.float32)
    h0 = rng.standard_normal((2, D)).astype(np.float32)
    want = jax_rglru(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    got = rglru_scan_op(_t(a), _t(b), _t(h0))
    assert got.shape == (2, S, D) and got.dtype == torch.float32
    _close(got, want, 2e-4)


def _wkv_inputs(B, H, S, K, seed):
    rng = np.random.default_rng(seed)
    rn = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (rn(B, H, S, K), rn(B, H, S, K), rn(B, H, S, K),
            -np.exp(rn(B, H, S, K)), rn(H, K), rn(B, H, K, K))


@pytest.mark.parametrize("S,K,chunk", [(64, 32, 32), (70, 32, 16),
                                       (128, 64, 32)])
def test_rwkv6_wkv_matches_pallas(S, K, chunk):
    ins = _wkv_inputs(2, 2, S, K, seed=S + K)
    o_want, s_want = jax_wkv(*map(jnp.asarray, ins), chunk=chunk)
    o, s_fin = rwkv6_wkv_op(*map(_t, ins))
    assert o.shape == (2, 2, S, K) and s_fin.shape == (2, 2, K, K)
    _close(o, o_want, 2e-3)
    _close(s_fin, s_want, 2e-3)


def test_rwkv6_wkv_extreme_decay_underflows_to_zero():
    """logw = -50 per step: the output stays finite, and the carried
    state's contribution underflows to exactly 0 (from the third step
    on), in the plain version and in the reference's kernel alike."""
    B, H, S, K = 1, 1, 64, 32
    one = np.ones((B, H, S, K), np.float32)
    ins = (one, np.zeros_like(one), one, np.full_like(one, -50.0),
           np.zeros((H, K), np.float32), np.full((B, H, K, K), 1e3,
                                                 np.float32))
    o, s_fin = rwkv6_wkv_op(*map(_t, ins))
    o_ref, s_ref = jax_wkv(*map(jnp.asarray, ins))
    for out, sf in ((o.numpy(), s_fin.numpy()),
                    (np.asarray(o_ref), np.asarray(s_ref))):
        assert np.isfinite(out).all() and np.isfinite(sf).all()
        assert (out[:, :, 3:] == 0).all() and (sf == 0).all()
    # with live inputs (k = v = r = 1) the output is finite too
    o, s_fin = rwkv6_wkv_op(_t(one), _t(one), _t(one), _t(ins[3]),
                            _t(ins[4]), torch.zeros((B, H, K, K)))
    assert torch.isfinite(o).all() and torch.isfinite(s_fin).all()


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("Hq,Hkv,hd", [(4, 2, 32), (10, 1, 256)])
def test_paged_decode_matches_pallas(window, Hq, Hkv, hd):
    """The no-new-token paged decode over a permuted pool, a dead slot
    (length 0 → zeros) and NaN in every masked pool row: the plain
    version never reads them; the reference kernel reads them (it leaks
    NaN, ROADMAP faults), so its copy of the pools has them zeroed."""
    B, ps, nb = 3, 8, 4
    P = B * nb + 2
    rng = np.random.default_rng(window + hd)
    q = rng.standard_normal((B, 1, Hq, hd)).astype(np.float32)
    kp = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
    bt = rng.permutation(P)[:B * nb].reshape(B, nb).astype(np.int32)
    lens = np.array([13, 0, 32], np.int32)
    live = np.zeros((P, ps), bool)
    for b, L in enumerate(lens):
        for t in range(max(0, L - window) if window else 0, L):
            live[bt[b, t // ps], t % ps] = True
    kn, vn = kp.copy(), vp.copy()
    kn[~live], vn[~live] = np.nan, np.nan
    kz, vz = np.where(live[..., None, None], kp, 0), \
        np.where(live[..., None, None], vp, 0)
    want = jax_decode(jnp.asarray(q), jnp.asarray(kz), jnp.asarray(vz),
                      jnp.asarray(lens), window=window,
                      block_tables=jnp.asarray(bt))
    got = decode_attention_op(_t(q), _t(kn), _t(vn), _t(lens),
                              window=window, block_tables=_t(bt))
    assert torch.isfinite(got).all() and bool((got[1] == 0).all())
    _close(got, want, 2e-5)


# ===========================================================================
# Layers on carried-over parameters (fp32 compute)
# ===========================================================================

def _cfgs(arch, cd="float32", **kw):
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               compute_dtype=cd, **kw)
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype=cd, **kw)
    return jcfg, cfg


@pytest.mark.parametrize("S,state", [(13, False), (13, True), (1, True),
                                     (2, False)])
def test_rglru_layer_matches_reference(S, state):
    """Full-sequence block (from zero state, from a carried h0/conv0, a
    1-token chunk — the conv-history fix — and a chunk shorter than the
    conv window), then one decode step from the block's cache."""
    jcfg, cfg = _cfgs("recurrentgemma-2b")
    jp = jrec.init_rglru(jcfg, jax.random.PRNGKey(S))
    p = _tree(jp)
    rng = np.random.default_rng(S)
    d = cfg.d_model
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    h0 = rng.standard_normal((2, d)).astype(np.float32) if state else None
    c0 = rng.standard_normal((2, 3, d)).astype(np.float32) if state else None
    yj, cj = jrec.rglru_full(jcfg, jp, jnp.asarray(x),
                             h0=None if h0 is None else jnp.asarray(h0),
                             conv0=None if c0 is None else jnp.asarray(c0),
                             make_cache=True)
    y, c = rec.rglru_full(cfg, p, _t(x),
                          h0=None if h0 is None else _t(h0),
                          conv0=None if c0 is None else _t(c0),
                          make_cache=True)
    _close(y, yj, 1e-4)
    for k in ("h", "conv"):
        _close(c[k], cj[k], 1e-4)
    x1 = rng.standard_normal((2, 1, d)).astype(np.float32)
    tc = {k: _t(v) for k, v in jax.device_get(cj).items()}
    yj, cj = jrec.rglru_decode(jcfg, jp, jnp.asarray(x1), cj)
    y, c = rec.rglru_decode(cfg, p, _t(x1), tc)
    _close(y, yj, 1e-5)
    for k in ("h", "conv"):
        _close(c[k], cj[k], 1e-5)


@pytest.mark.parametrize("S,state", [(1, False), (19, False), (19, True)])
def test_rwkv_layers_match_reference(S, state):
    """Time-mix and channel-mix, full sequence (from zero or a carried
    state) and one decode step."""
    jcfg, cfg = _cfgs("rwkv6-7b")
    jt = jrec.init_rwkv_tmix(jcfg, jax.random.PRNGKey(S))
    jc = jrec.init_channelmix(jcfg, jax.random.PRNGKey(S + 1))
    pt, pc = _tree(jt), _tree(jc)
    rng = np.random.default_rng(S)
    d, dk = cfg.d_model, cfg.rwkv_head_dim
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    cache = None
    if state:
        cache = {"shift": rng.standard_normal((2, d)).astype(np.float32),
                 "s": rng.standard_normal((2, d // dk, dk, dk)).astype(
                     np.float32)}
    jcache = None if cache is None else {k: jnp.asarray(v)
                                         for k, v in cache.items()}
    tcache = None if cache is None else {k: _t(v) for k, v in cache.items()}
    yj, cj = jrec.rwkv_tmix_full(jcfg, jt, jnp.asarray(x), cache=jcache,
                                 make_cache=True)
    y, c = rec.rwkv_tmix_full(cfg, pt, _t(x), cache=tcache, make_cache=True)
    _close(y, yj, 1e-4)
    for k in ("shift", "s"):
        _close(c[k], cj[k], 1e-4)
    x1 = rng.standard_normal((2, 1, d)).astype(np.float32)
    tc = {k: _t(v) for k, v in jax.device_get(cj).items()}
    yj, cj = jrec.rwkv_tmix_decode(jcfg, jt, jnp.asarray(x1), cj)
    y, c = rec.rwkv_tmix_decode(cfg, pt, _t(x1), tc)
    _close(y, yj, 1e-5)
    for k in ("shift", "s"):
        _close(c[k], cj[k], 1e-5)

    fc = {"shift": rng.standard_normal((2, d)).astype(np.float32)}
    yj, cj = jrec.channelmix_full(jcfg, jc, jnp.asarray(x),
                                  cache={"shift": jnp.asarray(fc["shift"])},
                                  make_cache=True)
    y, c = rec.channelmix_full(cfg, pc, _t(x), cache={"shift": _t(
        fc["shift"])}, make_cache=True)
    _close(y, yj, 1e-5)
    _close(c["shift"], cj["shift"], 1e-5)
    tc = {"shift": _t(jax.device_get(cj["shift"]))}
    yj, cj = jrec.channelmix_decode(jcfg, jc, jnp.asarray(x1), cj)
    y, c = rec.channelmix_decode(cfg, pc, _t(x1), tc)
    _close(y, yj, 1e-5)
    _close(c["shift"], cj["shift"], 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    jcfg, cfg = _cfgs("rwkv6-7b")
    assert cfg.norm == "layernorm"
    p = init_norm(cfg, "cpu")
    assert sorted(p) == sorted(jlayers.init_norm(jcfg)) == ["bias", "scale"]
    rng = np.random.default_rng(4)
    d = cfg.d_model
    p = {"scale": _t(rng.standard_normal(d).astype(np.float32)),
         "bias": _t(rng.standard_normal(d).astype(np.float32))}
    x = (rng.standard_normal((2, 5, d)) * 3 + 1).astype(np.float32)
    want = jlayers.apply_norm(jcfg, {k: jnp.asarray(v.numpy())
                                     for k, v in p.items()},
                              jnp.asarray(x, jnp.dtype(dtype)))
    got = apply_norm(cfg, p, _t(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, 1e-5 if dtype == "float32" else 1e-2)


# ===========================================================================
# Bridge: multi-segment layouts
# ===========================================================================

@pytest.mark.parametrize("arch,n_layers", [("recurrentgemma-2b", 5),
                                           ("rwkv6-7b", 2)])
def test_param_and_state_round_trip_is_byte_exact(arch, n_layers):
    """recurrentgemma with 5 layers is a scan over one (rglru, rglru,
    swa) period plus an unrolled (rglru, rglru) tail."""
    jcfg, cfg = _cfgs(arch, "bfloat16", n_layers=n_layers)
    jm = jax_build_model(jcfg)
    tree = jax.device_get(jm.init(jax.random.PRNGKey(2)))
    if arch == "recurrentgemma-2b":
        assert len(tree["segments"]) == 2
    p = params_from_jax(tree)
    assert len(p["layers"]) == n_layers
    back = params_to_numpy(p, cfg)
    rng = np.random.default_rng(3)
    state = jax.tree_util.tree_map(
        lambda a: np.asarray(rng.standard_normal(a.shape), a.dtype),
        jax.device_get(jm.init_paged_state(2, 3, 4)))
    back_state = state_rows_to_numpy(state_rows_from_jax(state, cfg), cfg)
    for a_tree, b_tree in ((tree, back), (state, back_state)):
        flat_a = jax.tree_util.tree_leaves_with_path(a_tree)
        flat_b = jax.tree_util.tree_leaves_with_path(b_tree)
        assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
        for (path, a), (_, b) in zip(flat_a, flat_b):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape and a.tobytes() == b.tobytes(), path


# ===========================================================================
# The swap tier and PagedRecurrentState
# ===========================================================================

def test_swap_tier_round_trips_bf16_rows():
    tier = HostSwapTier()
    leaves = [torch.randn(3, 5).to(torch.bfloat16), torch.randn(2, 4, 4)]
    tier.put((7, 0), leaves)
    assert tier.stats()["bytes_stored"] == 3 * 5 * 2 + 2 * 4 * 4 * 4
    back = tier.load(tier.pop((7, 0)), "cpu")
    for a, b in zip(back, leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert len(tier) == 0 and tier.stats()["bytes_stored"] == 0


SEG = 256
W = 4          # elements per state row in the fake model
B = 3          # slots per family


class _RowModel:
    """Minimal recurrent-model surface: state is a (B, W) f32 row set
    updated in place; ``row_bytes`` is the footprint the pool sees."""

    device = torch.device("cpu")

    def __init__(self, row_bytes):
        self._rb = int(row_bytes)

    def state_row_bytes(self):
        return self._rb

    def read_state_row(self, state, slot):
        return [state[slot].clone()]

    def write_state_row(self, state, slot, leaves):
        state[slot] = leaves[0]
        return state

    def reset_state_row(self, state, slot):
        state[slot] = 0.0
        return state


@settings(max_examples=20, deadline=None)
@given(ops=st.lists(
    st.tuples(st.integers(min_value=0, max_value=1),      # family
              st.integers(min_value=0, max_value=B - 1),  # slot
              st.integers(min_value=0, max_value=3)),     # lifecycle op
    min_size=1, max_size=40))
def test_state_lifecycle_random_interleavings(ops):
    """Two families (1-block and 3-block rows) interleave
    admit/park/refault/release on one 8-page pool — small enough that
    leases bounce: refcounts stay consistent, no frame is mapped twice,
    and every row holds its own value (zeros while parked)."""
    pool = SegmentPool(total_bytes=8 * SEG, backend="bitmap",
                       segment_bytes=SEG)
    pss = [PagedRecurrentState(None, _RowModel(rb), B, pool)
           for rb in (SEG - 40, 3 * SEG - 16)]
    states = [torch.zeros((B, W)), torch.zeros((B, W))]
    assert pss[0].blocks_per_slot == 1 and pss[1].blocks_per_slot == 3
    expect = [[None] * B for _ in range(2)]
    lease = 0

    for step, (f, slot, op) in enumerate(ops):
        ps = pss[f]
        if op == 0 and ps.tables[slot] is None:
            try:
                ps.admit(slot, f"fam{f}:req{lease}")
                lease += 1
            except MMUError:
                assert ps.tables[slot] is None   # bounced lease is clean
            else:
                # the engine zeroes an admitted slot's rows itself
                states[f] = ps.model.reset_state_row(states[f], slot)
                val = float(step + 1)            # distinct per lease
                states[f][slot] = val
                expect[f][slot] = val
        elif op == 1:
            states[f], _ = ps.park(states[f], slot)
        elif op == 2:
            try:
                states[f], _ = ps.refault(states[f], slot)
            except MMUError:
                pass                             # retryable, not corrupting
        elif op == 3:
            ps.release(slot)
            expect[f][slot] = None

        assert pool.refcounts_consistent()
        live = [pg for g in range(2)
                for pages in pss[g].live_pages().values()
                for pg in pages if pg != SWAPPED]
        assert len(live) == len(set(live)), \
            f"physical frame mapped twice: {sorted(live)}"
        for g in range(2):
            for s in range(B):
                if expect[g][s] is None:
                    continue
                want = 0.0 if pss[g].swapped_blocks(s) else expect[g][s]
                assert bool((states[g][s] == want).all()), \
                    (g, s, states[g][s].tolist(), want)

    for g in range(2):
        for s in range(B):
            pss[g].release(s)
    assert pool.memory_stats()["segments_in_use"] == 0
    assert pool.refcounts_consistent()
