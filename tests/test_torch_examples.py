"""The port's multi-tenant and failover examples on the CPU with the
reduced configs: every tenant's logits equal the native program's bit
for bit, the cross-slice attack is denied and audited, the warm
reprogram hits once, every submitted op completes; the failover's 18
losses (resumed after the migration, then on the grown slice) equal an
uninterrupted run's, the grow doubles the pool on one device, and its
first step's loss is the reference's ``optim.make_train_step`` on the
same parameters."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import optim as jax_optim
from repro.configs import get_config as jax_get_config
from repro.data import pipeline_for as jax_pipeline_for
from repro.models import build_model as jax_build_model
from repro_torch.bridge import params_to_numpy
from repro_torch.configs.base import ShapeCell
from repro_torch.models import Model

torch.set_num_threads(2)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("policy", ["wfq", "slo"])
def test_multi_tenant_serving(policy, capsys):
    ex = _example("torch_multi_tenant_serving")
    out = ex.main(["--device", "cpu", "--policy", policy])
    assert set(out["tenants"]) == {"alice", "bob"}
    for name, t in out["tenants"].items():
        assert t["native_equal"] and t["finite"], name
        assert len(t["logits"]) == ex.TOKENS
        assert t["pool_bytes"] == 4 * ex.CPU_HBM        # 4/8 of the view
        assert t["share"] == 0.5
        assert out["sched"][name]["completed"] == t["ops"]
        assert out["sched"][name]["failed"] == 0
    assert out["attack_denied"]
    assert out["violations"].get("cross_slice_reprogram") == 1
    assert out["hits"] == 1 and out["misses"] == 2
    if policy == "slo":
        assert "slo_attainment" in out["sched"]["alice"]
    printed = capsys.readouterr().out
    assert "cross-slice reprogram denied" in printed
    assert "equal to the native run" in printed


def test_elastic_failover():
    ex = _example("torch_elastic_failover")
    out = ex.main(["--device", "cpu"])
    n = 3 * ex.PHASE_STEPS
    assert len(out["losses"]) == n
    assert all(x == x and abs(x) != float("inf") for x in out["losses"])
    assert out["losses"] == out["uninterrupted"]      # bit for bit
    assert "slice_failed" in out["events"]
    assert out["pool_after"] == 2 * out["pool_before"]
    assert (out["share_before"], out["share_after"]) == (0.5, 1.0)
    assert out["slice"] == {"shape": (2, 4), "entries": 8, "cards": ["cpu"]}
    assert out["checkpoint_bytes"] > 0
    st = out["stats"]
    assert st["ops"]["migrate"]["count"] == 2         # failover + grow
    assert st["scheduler"]["tenants"]["trainer"]["failed"] == 0

    # step 0 against the reference's train step on the same parameters
    cfg = ex.train_config()
    jcfg = jax_get_config(ex.ARCH, reduced=True)
    jm = jax_build_model(jcfg)
    params = Model(cfg, device="cpu").init(
        torch.Generator(device="cpu").manual_seed(0))
    jparams = jax.tree.map(jnp.asarray, params_to_numpy(params, cfg))
    jopt = jax_optim.OptConfig(warmup_steps=2, decay_steps=30)
    step = jax.jit(jax_optim.make_train_step(jm, jopt))
    batch = jax_pipeline_for(jcfg, ShapeCell("ef", 64, 4, "train")).batch(0)
    _, _, m = step(jparams, jax_optim.init(jopt, jparams),
                   {k: jnp.asarray(v) for k, v in batch.items()})
    # bf16 compute in both packages (the reduced config), fp32 loss
    assert out["losses"][0] == pytest.approx(float(m["loss"]), rel=1e-4)
