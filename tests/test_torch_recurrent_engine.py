"""The port's ``ServeEngine`` serving the reduced recurrent families
against the reference's JAX ``ServeEngine`` on the same prompts and
weights (fp32 compute, so token ids can match exactly): monolithic with
mixed temperatures (host sampling from the same seeded numpy RNG) and
chunked at T = 0 (on-device sampling; prompts of 9 and 17 tokens leave
a 1-token last chunk), with paged recurrent state on and off — the
reference runs with it on, and the tokens may not depend on it."""
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
from repro_torch.models import Model
from repro_torch.serving import ServeEngine

torch.set_num_threads(2)

PLENS = [5, 9, 13, 17, 11]         # straddle the 8-token pages and chunks


@pytest.fixture(scope="module", params=["recurrentgemma-2b", "rwkv6-7b"])
def models(request):
    arch = request.param
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    m = Model(cfg, device="cpu")
    return jcfg, cfg, jm, jp, m, params_from_jax(jax.device_get(jp))


def _writable_logits(decode_fn):
    """The reference engine writes newcomers' prefill logits into the
    host copy of its decode logits, which jax 0.9 returns read-only:
    hand it a writable copy (the numbers are unchanged)."""
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


@pytest.mark.parametrize("chunk,temps", [
    (0, (0.0, 0.8, 0.0, 1.3, 0.5)),
    (8, (0.0,) * 5),
])
def test_engine_tokens_match_reference(models, chunk, temps):
    jcfg, cfg, jm, jp, m, p = models
    kw = dict(page_size=8, chunk_tokens=chunk, seed=3)
    jeng = JaxServeEngine(jcfg, jm, 2, 64, decode_wrap=_writable_logits,
                          state_paging=True, **kw)
    want = _serve(jeng, jp, temps, cfg.vocab)
    js = jeng.stats
    assert js.state_pages_leased == js.state_pages_freed > 0
    for paging in (True, False):
        eng = ServeEngine(cfg, m, 2, 64, state_paging=paging, **kw)
        assert _serve(eng, p, temps, cfg.vocab) == want
        s = eng.stats
        assert s.full_prefills == 0 and s.completed == len(PLENS)
        assert s.pages_leased == s.pages_freed > 0
        assert s.page_faults == js.page_faults
        if paging:
            assert s.state_pages_leased == s.state_pages_freed \
                == js.state_pages_leased
            assert eng.rstate.stats()["row_bytes"] == m.state_row_bytes()
        else:
            assert eng.rstate is None and s.state_pages_leased == 0
        assert eng.kv.memory_stats()["pages_in_use"] == 0
        if chunk:
            assert s.prefill_chunks == sum(-(-n // chunk) for n in PLENS)


def test_state_pages_share_the_kv_pool(models):
    """State pages lease from the engine's own pool, which it sizes for
    the rows too; while a request is in flight its state pages are in
    use, under the ``<owner>/state`` quota."""
    jcfg, cfg, jm, jp, m, p = models
    eng = ServeEngine(cfg, m, 2, 64, page_size=8, chunk_tokens=8,
                      state_paging=True)
    rs = eng.rstate
    kv_pages = 2 * eng.kv.blocks_per_slot
    assert eng.kv.pool.n_segments == kv_pages + 2 * rs.blocks_per_slot
    eng.submit(np.arange(6), max_new_tokens=3)
    eng.step(p)
    assert rs.tables[0] is not None and rs.owners[0] == "req0/state"
    in_use = eng.kv.memory_stats()["segments_in_use"]
    assert in_use == eng.kv.tables[0].n_pages + rs.blocks_per_slot
    eng.run_round(p)
    assert eng.kv.memory_stats()["segments_in_use"] == 0
    assert eng.stats.state_pages_leased == eng.stats.state_pages_freed \
        == rs.blocks_per_slot
