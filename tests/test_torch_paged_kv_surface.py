"""``PagedKVCache``'s isolation and inspection surface in the port —
``translate`` (the ownership-checked logical block → physical address),
``live_pages`` and ``kv_stats`` — and ``Request.context``, held against
the reference's (``repro.serving.paged_kv``, ``repro.serving.engine``):
the cross-slot cases of ``tests/test_paged_kv.py``, the same mappings and
addresses for the same admissions, and the same ``kv_stats()`` after one
shared-prefix run of the two engines (reduced qwen, fp32 compute,
greedy) on the same converted weights.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.mmu import IsolationViolation as JaxIsolationViolation
from repro.models import build_model as jax_build_model
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving.engine import Request as JaxRequest
from repro.serving.paged_kv import PagedKVCache as JaxPagedKVCache
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.mmu import IsolationViolation, MMUError
from repro_torch.models import Model
from repro_torch.serving import ServeEngine
from repro_torch.serving.engine import Request
from repro_torch.serving.paged_kv import PagedKVCache

torch.set_num_threads(2)


class _StubModel:
    """Mapping-only stand-in (as in ``tests/test_paged_kv.py``): these
    cases exercise the lease bookkeeping, not the device arrays."""
    device = torch.device("cpu")

    def kv_page_bytes(self, page_size):
        return 1024

    def init_paged_state(self, batch, num_pages, page_size, enc_len=None):
        return []

    def write_prefill_paged(self, state, caches, slot, block_row, length,
                            page_size):
        return state


def _cache(cls=PagedKVCache, batch=4, capacity=64, page_size=8):
    return cls(cfg=None, model=_StubModel(), batch_size=batch,
               capacity=capacity, page_size=page_size)


def test_cross_slot_access_raises():
    """Touching another request's mapping is an IsolationViolation
    through the MMU's ownership gate (the paper's data-protection
    half)."""
    kv = _cache()
    kv.admit(0, "alice", 10)
    kv.admit(1, "bob", 10)
    assert kv.translate(0, 0, "alice") >= 0
    with pytest.raises(IsolationViolation):
        kv.translate(0, 0, "bob")
    with pytest.raises(IsolationViolation):
        kv.translate(1, 1, "alice")        # bob's second page: unmapped
    with pytest.raises(IsolationViolation):
        kv.translate(1, 0, "alice")


def test_translate_out_of_table_and_swapped_blocks():
    kv = _cache()
    kv.admit(0, "alice", 10)               # 2 pages of 8 tokens
    with pytest.raises(IsolationViolation):
        kv.translate(0, 2, "alice")
    kv.pool.swap_out_page(kv.tables[0].handle, "alice", 1)
    with pytest.raises(MMUError, match="swapped out"):
        kv.translate(0, 1, "alice")


def test_live_pages_and_addresses_match_reference():
    """The same admissions, growths and releases on both caches: the same
    live pages slot by slot and the same physical addresses; a released
    slot leaves the map."""
    caches = {"port": _cache(), "jax": _cache(JaxPagedKVCache)}
    for kv in caches.values():
        kv.admit(0, "a", 10)
        kv.admit(2, "c", 3)
        kv.ensure(2, 20)
        kv.admit(1, "b", 17)
        kv.release(0)
    port, ref = caches["port"], caches["jax"]
    assert port.live_pages() == ref.live_pages()
    assert sorted(port.live_pages()) == [1, 2]
    for slot, owner in ((1, "b"), (2, "c")):
        for blk in range(len(port.live_pages()[slot])):
            assert port.translate(slot, blk, owner) == \
                ref.translate(slot, blk, owner)
        with pytest.raises(IsolationViolation):
            port.translate(slot, 0, "a")
        with pytest.raises(JaxIsolationViolation):
            ref.translate(slot, 0, "a")


def test_request_context_matches_reference():
    prompt = np.arange(5, dtype=np.int32)
    for out in ([], [7], [9, 3, 1]):
        got = Request(0, prompt, out_tokens=list(out)).context()
        want = JaxRequest(0, prompt, out_tokens=list(out)).context()
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert Request(0, prompt).context() is prompt


def test_kv_stats_match_reference_after_a_shared_prefix_run():
    """Three requests sharing a 16-token prefix, one after another, on
    both engines with sharing on: the same hierarchy counters and prefix
    cache stats (warm admissions, shared tokens, CoW forks)."""
    arch = "qwen1.5-0.5b"
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jp))
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab, size=(16,))
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab,
                                                    size=(5 + j,))])
               .astype(np.int32) for j in range(3)]
    stats, outs = {}, {}
    for side, eng, p in (
            ("port", ServeEngine(cfg, Model(cfg, device="cpu"), 2, 64,
                                 page_size=8, chunk_tokens=8,
                                 share_prefix=True), params),
            ("jax", JaxServeEngine(jcfg, jm, 2, 64, page_size=8,
                                   chunk_tokens=8, share_prefix=True), jp)):
        rids = []
        for prompt in prompts:
            rids.append(eng.submit(prompt, max_new_tokens=4,
                                   temperature=0.0))
            eng.run_round(p)
        stats[side] = eng.kv.kv_stats()
        outs[side] = [eng.completed[r].out_tokens for r in rids]
    assert outs["port"] == outs["jax"]
    assert stats["port"] == stats["jax"]
    assert stats["port"]["prefix_hits"] == 2
    assert stats["port"]["shared_tokens_total"] == 32
    assert stats["port"]["cow_forks"] > 0
    assert "swap_tier" not in stats["port"]
