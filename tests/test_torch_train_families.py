"""Training of the repo's other attention-bearing families, the port
against the reference's JAX package on the CPU (reduced configs, fp32
compute, the reference with ``use_pallas=False``, its default):
internlm2-1.8b, phi3-mini-3.8b, starcoder2-15b (GELU FFN, layernorm),
mixtral-8x7b and kimi-k2 (gather MoE, the aux loss in the loss),
internvl2-2b (the image rows first, masked out of the loss) and
whisper-medium (the encoder over the stub frames).

Tolerances: the loss, its ce and aux parts and every gradient leaf
within 1e-4 (fp32, sums in another order), and each gradient leaf within
1e-4 of the reference's by relative norm, ||g - w|| <= 1e-4 ||w|| + 1e-8,
so that a leaf whose gradient is small throughout is held too. The 1e-8
floor is for a gradient that is zero in exact arithmetic, where both
sides hold rounding alone: whisper's ``bk`` without rotary embedding
adds one constant to each query's scores, which the softmax cancels
(the reference's is 3e-10 by norm).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch import optim
from repro_torch.bridge import batch_from_numpy, params_from_jax
from repro_torch.checkpointing.checkpoint import flatten_with_path
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data import pipeline_for
from repro_torch.models import Model

torch.set_num_threads(2)

FAMILIES = ["internlm2-1.8b", "phi3-mini-3.8b", "starcoder2-15b",
            "mixtral-8x7b", "kimi-k2-1t-a32b", "internvl2-2b",
            "whisper-medium"]
TOL = 1e-4


def _cfgs(arch):
    return (dataclasses.replace(jax_get_config(arch, reduced=True),
                                compute_dtype="float32"),
            dataclasses.replace(get_config(arch, reduced=True),
                                compute_dtype="float32"))


def _init(jcfg, seed):
    jm = jax_build_model(jcfg)
    return jm, jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_step_loss_and_gradients_match_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jm, jp = _init(jcfg, 5)
    batch = pipeline_for(cfg, ShapeCell("t", 32, 2, "train"),
                         seed=2).batch(1)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = optim.loss_and_grads(
        Model(cfg, device="cpu"), params_from_jax(jp),
        batch_from_numpy(batch))
    assert float(loss) == pytest.approx(float(jl), abs=TOL)
    for k in ("ce", "aux", "n_tok"):
        assert float(metrics[k]) == pytest.approx(float(jaux[k]), abs=TOL)
    if cfg.ffn_kind == "moe":
        assert float(metrics["aux"]) > 0
    if cfg.family == "vlm":          # the image rows carry no loss
        assert float(metrics["n_tok"]) == 2 * (32 - cfg.frontend.n_tokens)
    want = flatten_with_path(params_from_jax(jax.device_get(jg)))
    got = flatten_with_path(grads)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.float().numpy(), atol=TOL,
                                   rtol=TOL, err_msg=str(path))
        d = float((g.double() - w.double()).norm())
        assert d <= TOL * float(w.double().norm()) + 1e-8, (path, d)
