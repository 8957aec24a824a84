"""Virtualized execution on the port: the serving engine through a VMM
tenant (``serve --virtualized``) and the paper's three apps through three
bound tenants (``launch/apps.py``), on the CPU.

The engine runs reduced ``qwen1.5-0.5b`` in fp32 compute on weights
carried over from JAX, so token ids can be compared exactly: the port
through a port VMM must give the port's native ids and the JAX engine's
ids through the JAX VMM, in monolithic and chunked mode, and the same
number of pool-pressure deferrals on a tight pool. The reference engine
gets a writable copy of its decode logits (see tests/test_torch_engine.py
for that reference fault). The apps must give their plain versions'
outputs exactly (the CPU path is the plain version).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_config as jax_get_config
from repro.core import VMM as JaxVMM
from repro.models import build_model as jax_build_model
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import pool_pressure_gate as jax_pool_pressure_gate
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import VMM
from repro_torch.launch import apps, serve
from repro_torch.models import Model
from repro_torch.serving import ServeEngine, pool_pressure_gate

torch.set_num_threads(2)

PLENS = [5, 8, 13, 17, 11]
CPU = torch.device("cpu")


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


def _serve(engine, params, vocab, temps=(0.0,) * 5):
    rng = np.random.default_rng(0)
    rids = [engine.submit(rng.integers(0, vocab, (n,)),
                          max_new_tokens=4 + (j % 3), temperature=t)
            for j, (n, t) in enumerate(zip(PLENS, temps))]
    engine.run_round(params)
    return [engine.completed[r].out_tokens for r in rids]


def _jax_tenant(policy, hbm, seg):
    vmm = JaxVMM(Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                      ("data", "model")), policy=policy, hbm_per_chip=hbm,
                 segment_bytes=seg)
    kw = {"sched_slo_wait_s": 0.05} if policy == "slo" else {}
    t = vmm.create_vm("server", (1, 1), **kw)
    t.device.open()
    return vmm, t


def _port_tenant(policy, hbm, seg):
    g = np.empty((1, 1), dtype=object)
    g[0, 0] = CPU
    vmm = VMM(g, policy=policy, hbm_per_chip=hbm, segment_bytes=seg)
    kw = {"sched_slo_wait_s": 0.05} if policy == "slo" else {}
    t = vmm.create_vm("server", (1, 1), **kw)
    t.device.open()
    return vmm, t


def _mediate(tenant, writable=False):
    """Every step through ``tenant.device.run`` (as launch/serve.py
    wires it); ``writable`` hands the reference engine a writable copy of
    what it keeps on the host."""
    def wrap(fn):
        def run(*a):
            tenant.program = fn
            out, state = tenant.device.run(*a)
            return (np.array(out) if writable else out), state
        return run
    return wrap


@pytest.mark.parametrize("policy", ["hybrid", "fev", "slo"])
@pytest.mark.parametrize("chunk", [0, 8])
def test_virtualized_tokens_match_native_and_reference(models, policy, chunk):
    jcfg, cfg, jm, jp, m, p = models
    temps = (0.0, 0.8, 0.0, 1.3, 0.5) if chunk == 0 else (0.0,) * 5
    kw = dict(page_size=8, chunk_tokens=chunk, seed=3)
    native = _serve(ServeEngine(cfg, m, 2, 64, **kw), p, cfg.vocab, temps)

    vmm, t = _port_tenant(policy, 1 << 26, 1 << 20)
    eng = ServeEngine(cfg, m, 2, 64, pool=t.pool, prefill_wrap=_mediate(t),
                      decode_wrap=_mediate(t),
                      admission_gate=pool_pressure_gate(t.pool), **kw)
    got = _serve(eng, p, cfg.vocab, temps)
    st = vmm.stats()
    vmm.shutdown()

    jvmm, jt = _jax_tenant(policy, 1 << 26, 1 << 20)
    jeng = JaxServeEngine(jcfg, jm, 2, 64, pool=jt.pool,
                          prefill_wrap=_mediate(jt),
                          decode_wrap=_mediate(jt, writable=True),
                          admission_gate=jax_pool_pressure_gate(jt.pool),
                          **kw)
    want = _serve(jeng, jp, cfg.vocab, temps)
    jvmm.shutdown()

    assert got == native == want
    s = eng.stats
    assert s.full_prefills == 0 and s.pages_leased == s.pages_freed > 0
    assert st["scheduler"]["tenants"]["server"]["failed"] == 0
    assert st["oplog_records"] >= s.steps
    assert st["memory"]["server"]["pages_in_use"] == 0


@pytest.mark.parametrize("chunk", [0, 8])
def test_deferred_matches_reference_on_a_tight_pool(models, chunk):
    """A pool of 7 one-page segments behind ``pool_pressure_gate``:
    newcomers are deferred under pressure, the same number of times and
    with the same tokens as the reference."""
    jcfg, cfg, jm, jp, m, p = models
    seg = m.kv_page_bytes(8)
    kw = dict(page_size=8, chunk_tokens=chunk, seed=3)
    vmm, t = _port_tenant("hybrid", 7 * seg, seg)
    eng = ServeEngine(cfg, m, 3, 32, pool=t.pool, prefill_wrap=_mediate(t),
                      decode_wrap=_mediate(t),
                      admission_gate=pool_pressure_gate(t.pool), **kw)
    got = _serve(eng, p, cfg.vocab)
    vmm.shutdown()
    jvmm, jt = _jax_tenant("hybrid", 7 * seg, seg)
    jeng = JaxServeEngine(jcfg, jm, 3, 32, pool=jt.pool,
                          prefill_wrap=_mediate(jt),
                          decode_wrap=_mediate(jt, writable=True),
                          admission_gate=jax_pool_pressure_gate(jt.pool),
                          **kw)
    want = _serve(jeng, jp, cfg.vocab)
    jvmm.shutdown()
    assert got == want
    assert eng.stats.deferred == jeng.stats.deferred > 0
    assert eng.stats.completed == len(PLENS)
    assert eng.stats.pages_leased == eng.stats.pages_freed


def test_pool_pressure_gate_rule():
    from repro_torch.core import SegmentPool
    pool = SegmentPool(total_bytes=10 << 20, segment_bytes=1 << 20)
    gate = pool_pressure_gate(pool, util_hwm=0.5, headroom_pages=1)
    assert gate("a", 4)
    pool.alloc_pages(3, "x")
    assert gate("a", 2) and not gate("a", 3)


@pytest.mark.parametrize("policy", ["hybrid", "slo"])
def test_serve_virtualized_on_cpu(capsys, policy):
    eng = serve.main(["--device", "cpu", "--virtualized", "--policy",
                      policy, "--requests", "3", "--max-new", "3",
                      "--prompt-len", "9", "--chunk-tokens", "8"])
    out = capsys.readouterr().out
    assert eng.stats.completed == 3 and eng.stats.full_prefills == 0
    assert "vmm stats:" in out and "'failed': 0" in out


def test_apps_through_three_bound_tenants():
    res = apps.run(CPU, "fig6a", warmup=0, iters=1, log=lambda *a: None)
    assert [w.app for w in res["workloads"]] == ["matmul", "sobel", "vecadd"]
    for w in res["workloads"]:
        assert w.results["native_err"] == w.results["virt_err"] == 0.0
    st = res["stats"]
    assert {n: s["model"] for n, s in st["scheduler"]["tenants"].items()} \
        == {"matmul": "matmul", "sobel": "sobel", "vecadd": "vecadd"}
    assert st["floorplan_util"] == 1.0 and st["violations"] == {}
    assert st["transfer"]["h2d_bytes"] == sum(
        2 * w.nbytes_in for w in res["workloads"])  # checked + timed cycle
    crit = res["criteria"]
    assert crit.tenants == 3 and crit.oplog_completeness == 1.0
    assert crit.fidelity_operator_coverage >= 5 / 8


def test_apps_and_serve_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        apps.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--virtualized"])
