"""The port's training path against the reference's JAX package on the
CPU, reduced configs: the synthetic pipeline, flash's gradient and
qwen's loss, gradients and train steps, on the same parameters (carried
over by ``repro_torch.bridge``) and the same batches.

Tolerances:

* pipeline batches: equal bit for bit;
* flash's dq, dk, dv against ``jax.vjp`` of the reference's
  ``flash_attention_op`` (Pallas in interpret mode, its backward the XLA
  recompute): 1e-5 in fp32, 3e-2 in bf16;
* qwen in fp32 compute (the reference with ``use_pallas=False``, its
  default): the loss and every gradient leaf within 1e-4, and each
  gradient leaf within 1e-4 of the reference's by relative norm
  (||g - w|| / ||w||);
* five train steps: losses within 1e-4; the parameters after step 1
  within 2·lr of the reference's, element by element (AdamW's first
  update is ±lr wherever a gradient is near zero, so a fixed tolerance
  would depend on which side of zero a rounding falls); ``m`` and ``v``
  after step 1 (fixed by the clipped gradient alone) within 1e-5 by
  relative norm per leaf, one bf16 ulp (2**-8) with ``grad_compress``;
  each leaf's update over the five steps (params after step 5 less the
  start) within 1e-3 of the reference's by relative norm, 2**-8 with
  ``grad_compress``. An update that does nothing is off by 1, one of
  the wrong sign by 2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeCell as JaxShapeCell
from repro.data import pipeline_for as jax_pipeline_for
from repro.kernels.flash_attention.ops import (
    flash_attention_op as jax_flash)
from repro.models import build_model as jax_build_model
from repro_torch import optim
from repro_torch.bridge import (batch_from_numpy, opt_state_from_jax,
                                params_from_jax)
from repro_torch.checkpointing.checkpoint import flatten_with_path
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data import pipeline_for
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.models import Model

torch.set_num_threads(2)

ARCH = "qwen1.5-0.5b"
B, S = 4, 32


def _cfgs(arch, cd="float32"):
    return (dataclasses.replace(jax_get_config(arch, reduced=True),
                                compute_dtype=cd),
            dataclasses.replace(get_config(arch, reduced=True),
                                compute_dtype=cd))


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _tree_rel_close(got, want, tol):
    """Every leaf of ``got`` within ``tol`` of ``want``'s by relative
    norm, ||g - w|| <= tol * ||w|| (fp64)."""
    got, want = flatten_with_path(got), flatten_with_path(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        d = float((g.double() - w.double()).norm())
        assert d <= tol * float(w.double().norm()), (path, d)


def _tree_close(got, want_jax, tol):
    """Every leaf of the port's tree against the reference's (numpy
    leaves, carried into the port's layout)."""
    want = flatten_with_path(params_from_jax(want_jax))
    got = flatten_with_path(got)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   atol=tol, rtol=tol, err_msg=str(path))


@pytest.fixture(scope="module")
def qwen():
    """The reference's model (fp32 compute, ``use_pallas=False``) and
    init, the port's model on the CPU and the same parameters."""
    jcfg, cfg = _cfgs(ARCH)
    jm = jax_build_model(jcfg)
    jp = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    return jcfg, cfg, jm, jp, Model(cfg, device="cpu")


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,host", [("qwen1.5-0.5b", (0, 1)),
                                       ("qwen1.5-0.5b", (1, 2)),
                                       ("internvl2-2b", (0, 1)),
                                       ("whisper-medium", (0, 1))])
def test_pipeline_batches_bit_for_bit(arch, host):
    """``pipeline_for`` makes the reference's batches, every key and
    byte, for a dense model (one host and the second of two), the VLM
    (patches, image-row labels and mask) and the enc-dec (frames)."""
    jcfg, cfg = _cfgs(arch)
    mine = pipeline_for(cfg, ShapeCell("t", 48, 4, "train"), seed=3,
                        host_id=host[0], n_hosts=host[1])
    ref = jax_pipeline_for(jcfg, JaxShapeCell("t", 48, 4, "train"), seed=3,
                           host_id=host[0], n_hosts=host[1])
    for step in (0, 1, 7):
        got, want = mine.batch(step), ref.batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), (k, step)


def test_pipeline_prefetch_in_order():
    """The prefetch thread hands out the batches of consecutive steps."""
    _, cfg = _cfgs(ARCH)
    pipe = pipeline_for(cfg, ShapeCell("t", 16, 2, "train"), seed=1)
    it = pipe.prefetch(start_step=4)
    try:
        for step in (4, 5, 6):
            got = next(it)
            assert got["tokens"].tobytes() == pipe.batch(step)[
                "tokens"].tobytes()
    finally:
        it.close()


# ---------------------------------------------------------------------------
# flash's gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Hq,Hkv,hd,window",
                         [(40, 4, 4, 32, 0),          # causal
                          (70, 4, 4, 16, 24),         # sliding window
                          (33, 8, 2, 64, 0)],         # GQA, ragged S
                         ids=["causal", "window", "gqa"])
def test_flash_grad_matches_reference_vjp(Sq, Hq, Hkv, hd, window, dtype):
    """dq, dk, dv of the port's ``autograd.Function`` against ``jax.vjp``
    of the reference's custom_vjp op, with one upstream gradient."""
    rng = np.random.default_rng(Sq + hd)
    q = rng.standard_normal((2, Sq, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((2, Sq, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((2, Sq, Hkv, hd)).astype(np.float32)
    g = rng.standard_normal((2, Sq, Hq, hd)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=True,
                                               window=window),
                     *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want = vjp(jnp.asarray(g, jdt))
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    out = flash_attention_op(tq, tk, tv, causal=True, window=window)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g).to(tdt))
    tol = {"float32": 1e-5, "bfloat16": 3e-2}[dtype]
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == tdt
        _close(got, np.asarray(w.astype(jnp.float32)), tol)


# ---------------------------------------------------------------------------
# qwen: loss, gradients, train steps
# ---------------------------------------------------------------------------


def _batch(cfg, step=0, b=B, s=S, seed=0):
    return pipeline_for(cfg, ShapeCell("t", s, b, "train"),
                        seed=seed).batch(step)


def test_loss_and_every_gradient_match_reference(qwen):
    jcfg, cfg, jm, jp, m = qwen
    batch = _batch(cfg)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, _jax_batch(batch))
    loss, metrics, grads = optim.loss_and_grads(m, params_from_jax(jp),
                                                batch_from_numpy(batch))
    assert float(loss) == pytest.approx(float(jl), abs=1e-4)
    for k in ("ce", "aux", "n_tok"):
        assert float(metrics[k]) == pytest.approx(float(jaux[k]), abs=1e-4)
    _tree_close(grads, jax.device_get(jg), 1e-4)
    _tree_rel_close(grads, params_from_jax(jax.device_get(jg)), 1e-4)


def test_remat_changes_no_number(qwen):
    """``remat="full"`` (each layer recomputed in the backward) gives the
    loss and gradients of ``remat="none"`` exactly."""
    _, cfg, _, jp, _ = qwen
    batch = batch_from_numpy(_batch(cfg))
    out = {}
    for remat in ("none", "full", "dots"):
        c = dataclasses.replace(cfg, sharding=dataclasses.replace(
            cfg.sharding, remat=remat))
        out[remat] = optim.loss_and_grads(Model(c, device="cpu"),
                                          params_from_jax(jp), batch)
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for (_, a), (_, b) in zip(flatten_with_path(out[remat][2]),
                                  flatten_with_path(out["none"][2])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("micro,compress", [(1, False), (2, False),
                                            (2, True)],
                         ids=["plain", "micro2", "micro2-bf16"])
def test_train_steps_match_reference(qwen, micro, compress):
    """Five steps of ``make_train_step`` from one state: the losses (and
    grad norms); after step 1 the parameters within 2·lr and ``m``, ``v``
    by relative norm; after step 5 each leaf's update by relative
    norm."""
    jcfg, cfg, jm, jp, m = qwen
    kw = dict(warmup_steps=2, decay_steps=10, micro_steps=micro,
              grad_compress=compress)
    jopt, opt = jax_optim.OptConfig(**kw), optim.OptConfig(**kw)
    jstep = jax.jit(jax_optim.make_train_step(jm, jopt))
    step = optim.make_train_step(m, opt)
    jparams, jstate = jp, jax_optim.init(jopt, jp)
    params = params_from_jax(jp)
    state = opt_state_from_jax(jax.device_get(jstate))
    tol = 2.0 ** -8 if compress else 1e-5
    for i in range(5):
        batch = _batch(cfg, step=i)
        jparams, jstate, jm_ = jstep(jparams, jstate, _jax_batch(batch))
        params, state, met = step(params, state, batch_from_numpy(batch))
        assert sorted(met) == sorted(jm_)
        for k in ("loss", "grad_norm", "lr"):
            assert float(met[k]) == pytest.approx(float(jm_[k]), abs=1e-4,
                                                  rel=1e-4), (i, k)
        if i == 0:
            lr = float(jm_["lr"])
            want = flatten_with_path(params_from_jax(
                jax.device_get(jparams)))
            for (path, g), (_, w) in zip(flatten_with_path(params), want):
                assert float((g - w).abs().max()) <= 2 * lr, path
            want = opt_state_from_jax(jax.device_get(jstate))
            _tree_rel_close(state["m"], want["m"], tol)
            _tree_rel_close(state["v"], want["v"], tol)
    assert int(state["step"]) == int(jstate["step"]) == 5
    start = flatten_with_path(params_from_jax(jp))
    want = flatten_with_path(params_from_jax(jax.device_get(jparams)))
    got = flatten_with_path(params)
    _tree_rel_close([g - a for (_, g), (_, a) in zip(got, start)],
                    [w - a for (_, w), (_, a) in zip(want, start)],
                    2.0 ** -8 if compress else 1e-3)
