"""The model mux (``ModelRegistry`` / ``MuxEngine``) with the repo's five
other decoder-only families — internlm2-1.8b, phi3-mini-3.8b,
starcoder2-15b, mixtral-8x7b and kimi-k2 (gather MoE) — held against
the reference's registry and mux on the same converted weights, on the
CPU (reduced configs in fp32 compute, greedy, so ids compare exactly):
the same bitstream CRCs, and request for request the ids of solo
engines and of the JAX mux, before and after hot-swap churn under
``max_resident=1``.

internvl2-2b and whisper-medium stay outside the mux, as in the
reference: its ``serve --models`` is chunked only and passes no frontend
inputs, and a chunked prefill of either family is refused by both
packages.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serving import ModelRegistry as JaxModelRegistry
from repro.serving import MuxEngine as JaxMuxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.serving import ModelRegistry, MuxEngine, ServeEngine

torch.set_num_threads(2)

FAMILIES = ["internlm2-1.8b", "phi3-mini-3.8b", "starcoder2-15b",
            "mixtral-8x7b", "kimi-k2-1t-a32b"]


def _family(name, seed=0):
    jcfg = dataclasses.replace(jax_get_config(name, reduced=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config(name, reduced=True),
                              compute_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return (jcfg, jm, jp, cfg, Model(cfg, device="cpu"),
            params_from_jax(jax.device_get(jp)))


@pytest.fixture(scope="module")
def families():
    return {name: _family(name) for name in FAMILIES}


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
    for i in range(2):
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


def test_equal_weights_give_the_reference_crc(families):
    reg, jreg = ModelRegistry(), JaxModelRegistry()
    for name, (jcfg, jm, jp, cfg, m, p) in families.items():
        mine = reg.register(name, cfg=cfg, model=m, params=p)
        want = jreg.register(name, cfg=jcfg, model=jm, params=jp)
        assert mine.bitfile.crc == want.bitfile.crc, name
        assert mine.param_bytes == want.param_bytes, name


def test_mux_ids_match_solo_and_reference_through_churn(families):
    rng = np.random.default_rng(0)
    prompts = {name: [rng.integers(0, f[3].vocab, size=(6 + i,))
                      .astype(np.int32) for i in range(2)]
               for name, f in families.items()}
    solo = {}
    for name, (_, _, _, cfg, m, p) in families.items():
        eng = ServeEngine(cfg, m, 2, 16, page_size=8, chunk_tokens=8)
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
    st = reg.stats()
    assert sum(m["swap_ins"] for m in st["models"].values()) >= 4
    assert sum(m["swap_outs"] for m in st["models"].values()) >= 4
    assert st["crc_failures"] == 0
    assert mux.pool.refcounts_consistent()
    for g in mux.stats()["groups"].values():
        e = g["engine"]
        assert e["pages_leased"] == e["pages_freed"]


@pytest.mark.parametrize("arch", ["internvl2-2b", "whisper-medium"])
def test_frontend_families_stay_outside_the_mux(arch):
    """Both packages refuse a chunked prefill of a family with a frontend,
    and the mux serves chunked only."""
    jcfg, jm, jp, cfg, m, p = _family(arch)
    prompt = np.arange(6, dtype=np.int32)
    with pytest.raises(NotImplementedError):
        jm.prefill_chunk_paged(jp, None, prompt[None], 0, None, 0)
    with pytest.raises(NotImplementedError):
        m.prefill_chunk_paged(p, None, torch.from_numpy(prompt[None]), 0,
                              None, 0)
