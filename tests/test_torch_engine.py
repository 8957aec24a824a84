"""The port's ``ServeEngine`` against the reference's JAX ``ServeEngine``
on the same prompts and weights (reduced ``qwen1.5-0.5b``, fp32 compute
so token ids can match exactly), in monolithic mode with mixed
temperatures (host sampling draws from the same seeded numpy RNG) and
in chunked mode at T = 0 (on-device sampling)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.mmu import SegmentPool
from repro_torch.models import Model
from repro_torch.serving import ServeEngine

torch.set_num_threads(2)

PLENS = [5, 8, 13, 17, 11]         # straddle the 8-token pages


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_get_config("qwen1.5-0.5b", reduced=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b", reduced=True),
                              compute_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    m = Model(cfg, device="cpu")
    return jcfg, cfg, jm, jp, m, params_from_jax(jax.device_get(jp))


def _writable_logits(decode_fn):
    """The reference engine keeps ``jax.device_get`` of the decode
    logits as its host buffer and later writes a newcomer's prefill
    logits into it; on jax 0.9 that array is read-only, so its
    monolithic mode fails at the first mid-decode admission. Hand it a
    writable copy (the numbers are unchanged)."""
    def run(*args):
        logits, state = decode_fn(*args)
        return np.array(logits), state
    return run


def _serve(engine, params, temps, vocab):
    rng = np.random.default_rng(0)
    rids = [engine.submit(rng.integers(0, vocab, (n,)),
                          max_new_tokens=4 + (j % 3), temperature=t)
            for j, (n, t) in enumerate(zip(PLENS, temps))]
    engine.run_round(params)
    return {r: engine.completed[r].out_tokens for r in rids}


@pytest.mark.parametrize("batch,chunk,temps", [
    (2, 0, (0.0, 0.8, 0.0, 1.3, 0.5)),
    (3, 0, (0.9, 0.0, 0.0, 0.0, 2.0)),
    (2, 8, (0.0,) * 5),
    (3, 8, (0.0,) * 5),
])
def test_engine_tokens_match_reference(models, batch, chunk, temps):
    jcfg, cfg, jm, jp, m, p = models
    kw = dict(page_size=8, chunk_tokens=chunk, seed=3)
    jeng = JaxServeEngine(jcfg, jm, batch, 64, decode_wrap=_writable_logits,
                          **kw)
    eng = ServeEngine(cfg, m, batch, 64, **kw)
    want = _serve(jeng, jp, temps, cfg.vocab)
    got = _serve(eng, p, temps, cfg.vocab)
    assert got == want
    s = eng.stats
    assert s.full_prefills == 0 and s.completed == len(PLENS)
    assert s.pages_leased == s.pages_freed > 0
    assert s.page_faults == jeng.stats.page_faults
    assert eng.kv.memory_stats()["pages_in_use"] == 0
    if chunk:
        assert s.prefill_chunks == sum(-(-n // chunk) for n in PLENS)


def test_engine_defers_on_small_pool_then_drains(models):
    """A pool that holds one slot's working set: newcomers bounce on the
    MMU, are requeued at the front and admitted as EOS recycling returns
    pages; every request still completes and the pages balance."""
    jcfg, cfg, jm, jp, m, p = models
    pool = SegmentPool(total_bytes=8 * m.kv_page_bytes(8),
                       segment_bytes=m.kv_page_bytes(8))
    eng = ServeEngine(cfg, m, 2, 64, page_size=8, pool=pool)
    _serve(eng, p, (0.0,) * 5, cfg.vocab)
    assert eng.stats.completed == len(PLENS)
    assert eng.stats.pages_leased == eng.stats.pages_freed
    assert eng.kv.no_double_mapping() and eng.kv.tables_in_bounds()


def test_engine_future_resolves(models):
    jcfg, cfg, jm, jp, m, p = models
    eng = ServeEngine(cfg, m, 2, 64, page_size=8, chunk_tokens=8)
    rid = eng.submit(np.arange(6), max_new_tokens=3)
    eng.run_round(p)
    assert eng.future(rid).result(timeout=0).out_tokens == \
        eng.completed[rid].out_tokens


def test_unported_options_raise(models):
    jcfg, cfg, jm, jp, m, p = models
    for kw in ({"share_prefix": True}, {"swap": True},
               {"extra_batch": {"frames": 0}}):
        with pytest.raises(NotImplementedError):
            ServeEngine(cfg, m, 2, 64, page_size=8, chunk_tokens=8, **kw)
