"""An image of all-zero patch embeddings, the port against the
reference's JAX package on the CPU (reduced internvl2-2b at the full
config's 24 layers, fp32 compute, the reference with
``use_pallas=False``): the projector maps zero patches to zero rows,
which every layer keeps at zero, and each layer's RMSNorm meets them at
its steepest, 1/sqrt(eps); over 24 layers the gradient that flows back
into those rows overflows, and the leaves it reaches (the projector's
among them) get non-finite gradients. Both packages do so on the same
leaves with the same finite loss: a property of the model's formula,
pinned here so that a change to it in either package shows."""
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

ARCH, LAYERS, TOL = "internvl2-2b", 24, 1e-4


def _cfg(get):
    return dataclasses.replace(get(ARCH, reduced=True), n_layers=LAYERS,
                               compute_dtype="float32")


@pytest.mark.parametrize("zero", [True, False])
def test_zero_patches_overflow_the_same_leaves_as_the_reference(zero):
    jcfg, cfg = _cfg(jax_get_config), _cfg(get_config)
    batch = pipeline_for(cfg, ShapeCell("t", 40, 1, "train"),
                         seed=0).batch(0)
    if zero:
        batch["patches"] = np.zeros_like(batch["patches"])
    jm = jax_build_model(jcfg)
    jp = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, grads = optim.loss_and_grads(Model(cfg, device="cpu"),
                                          params_from_jax(jp),
                                          batch_from_numpy(batch))
    assert np.isfinite(float(jl))
    assert float(loss) == pytest.approx(float(jl), abs=TOL, rel=TOL)
    want = flatten_with_path(params_from_jax(jax.device_get(jg)))
    got = flatten_with_path(grads)
    bad_want = [p for p, w in want if not bool(torch.isfinite(w).all())]
    bad_got = [p for p, g in got if not bool(torch.isfinite(g).all())]
    assert bad_got == bad_want
    if zero:
        assert ("projector", "w1") in bad_got
    else:
        assert bad_got == []
