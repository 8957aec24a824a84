"""Training of the recurrent families, the port against the reference's
JAX package on the CPU: the RG-LRU scan's and the RWKV-6 WKV's
``autograd.Function`` (``_Scan``: its backward one more scan over the
time-reversed inputs; ``_Wkv``: its backward the chunked form
recomputed), then recurrentgemma-2b's and rwkv6-7b's loss, every
gradient leaf and one AdamW step (reduced configs, fp32 compute, the
reference with ``use_pallas=False``, its default).

Tolerances:
* the two Functions' input gradients against ``jax.vjp`` of the
  reference's XLA forms (the RG-LRU's ``associative_scan`` as
  ``repro.models.recurrent.rglru_full`` writes it, and
  ``_wkv_chunk_scan``) at ragged S (1, 17, 130), K in {16, 64}, a nonzero
  h0 / s0 and random upstream gradients on both WKV outputs: each
  element within 1e-4 (absolute and relative) and each gradient within
  1e-5 of the reference's by relative norm (fp32 sums in another order:
  the scan is serial against a parallel prefix; measured ≤ 5e-7);
* the loss, its ce part and every gradient leaf within 1e-4, and each
  leaf ||g - w|| <= 1e-4 ||w|| + 1e-8, the rule of
  ``tests/test_torch_train_families.py``;
* one train step through ``make_train_step``: loss, grad_norm and lr
  within 1e-4, each leaf's update (the parameters after the step less
  those before) within 1e-3 of the reference's by relative norm (the
  rule of ``tests/test_torch_train.py``; a skipped update is off by 1, a
  sign-flipped one by 2), ``m`` and ``v`` within 1e-5 by relative norm
  per leaf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.recurrent import _wkv_chunk_scan
from repro_torch import optim
from repro_torch.bridge import (batch_from_numpy, opt_state_from_jax,
                                params_from_jax)
from repro_torch.checkpointing.checkpoint import flatten_with_path
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data import pipeline_for
from repro_torch.kernels import common
from repro_torch.kernels.rglru_scan.ops import rglru_scan_op
from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv_op
from repro_torch.models import Model

torch.set_num_threads(2)

ARCHS = ["recurrentgemma-2b", "rwkv6-7b"]
TOL = 1e-4
UPDATE_TOL = 1e-3
OP_TOL, OP_REL = 1e-4, 1e-5


def _jax_scan(a, b, h0):
    """The reference's training form of the RG-LRU recurrence
    (``rglru_full`` with ``use_pallas=False``): h0 folded in as a step at
    t = -1, then ``jax.lax.associative_scan``."""
    B, _, d = a.shape
    a = jnp.concatenate([jnp.zeros((B, 1, d), jnp.float32), a], axis=1)
    b = jnp.concatenate([h0[:, None], b], axis=1)

    def combine(l, r):
        return l[0] * r[0], l[1] * r[0] + r[1]
    _, h = jax.lax.associative_scan(combine, (a, b), axis=1)
    return h[:, 1:]


def _jax_wkv(r, k, v, logw, u, s0):
    """``_wkv_chunk_scan`` in the kernel's (B, H, S, K) layout."""
    tr = lambda t: jnp.transpose(t, (0, 2, 1, 3))
    o, s = _wkv_chunk_scan(tr(r), tr(k), tr(v), tr(logw), u, s0)
    return tr(o), s


def _grads_close(got, want, names):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), w, atol=OP_TOL, rtol=OP_TOL,
                                   err_msg=name)
        d = float(np.linalg.norm(g.numpy().astype(np.float64) - w))
        assert d <= OP_REL * float(np.linalg.norm(w)), (name, d)


@pytest.mark.parametrize("S", [1, 17, 130])
def test_scan_gradient_matches_reference(S):
    rng = np.random.default_rng(S)
    B, D = 2, 48
    a = rng.uniform(0.3, 1.0, (B, S, D)).astype(np.float32)
    b, g = (rng.standard_normal((B, S, D)).astype(np.float32)
            for _ in range(2))
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    want_h, vjp = jax.vjp(jax.jit(_jax_scan), a, b, h0)
    ins = [torch.tensor(x, requires_grad=True) for x in (a, b, h0)]
    h = rglru_scan_op(*ins)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h),
                               atol=OP_TOL, rtol=OP_TOL)
    h.backward(torch.tensor(g))
    _grads_close([t.grad for t in ins], vjp(g), ("da", "db", "dh0"))


def test_scan_backward_is_the_reversed_scan():
    """The backward is the forward recurrence over flipped, shifted
    inputs: a loss of the last state alone gives db_t = Π_{s>t} a_s and
    dh0 = Π_s a_s."""
    a = torch.tensor([[[0.5], [0.25], [2.0]]], requires_grad=True)
    b = torch.zeros((1, 3, 1), requires_grad=True)
    h0 = torch.ones((1, 1), requires_grad=True)
    rglru_scan_op(a, b, h0)[:, -1].sum().backward()
    assert b.grad.flatten().tolist() == [0.5, 2.0, 1.0]
    assert h0.grad.item() == 0.25
    # da_t = λ_t h_{t-1}: h = 0.5, 0.125, 0.25
    assert a.grad.flatten().tolist() == [0.5, 1.0, 0.125]


@pytest.mark.parametrize("S,K", [(1, 16), (17, 16), (130, 16), (1, 64),
                                 (17, 64), (130, 64)])
def test_wkv_gradient_matches_reference(S, K):
    rng = np.random.default_rng(100 * S + K)
    B, H = 2, 2
    r, k, v = (0.5 * rng.standard_normal((B, H, S, K)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.uniform(-4, 1, (B, H, S, K))).astype(np.float32)
    u = 0.3 * rng.standard_normal((H, K)).astype(np.float32)
    s0 = 0.3 * rng.standard_normal((B, H, K, K)).astype(np.float32)
    go = rng.standard_normal((B, H, S, K)).astype(np.float32)
    gs = rng.standard_normal((B, H, K, K)).astype(np.float32)
    (jo, js), vjp = jax.vjp(jax.jit(_jax_wkv), r, k, v, logw, u, s0)
    ins = [torch.tensor(x, requires_grad=True)
           for x in (r, k, v, logw, u, s0)]
    o, s = rwkv6_wkv_op(*ins)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               atol=OP_TOL, rtol=OP_TOL)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js),
                               atol=OP_TOL, rtol=OP_TOL)
    torch.autograd.backward((o, s), (torch.tensor(go), torch.tensor(gs)))
    _grads_close([t.grad for t in ins], vjp((go, gs)),
                 ("dr", "dk", "dv", "dlogw", "du", "ds0"))


def test_wkv_state_only_loss_reaches_every_input_but_u():
    """A loss of the final state alone: the output's gradient is zero,
    u (the bonus reads only the output) gets a zero gradient."""
    rng = np.random.default_rng(3)
    B, H, S, K = 1, 2, 20, 16
    ins = [torch.tensor(0.5 * rng.standard_normal(shape).astype(np.float32),
                        requires_grad=True)
           for shape in [(B, H, S, K)] * 3 + [(B, H, S, K), (H, K),
                                              (B, H, K, K)]]
    with torch.no_grad():
        ins[3].copy_(-ins[3].abs())
    _, s = rwkv6_wkv_op(*ins)
    s.sum().backward()
    assert float(ins[4].grad.abs().max()) == 0.0
    assert float(ins[0].grad.abs().max()) == 0.0           # r: output only
    for t in (ins[1], ins[2], ins[3], ins[5]):
        assert bool(torch.isfinite(t.grad).all()) and bool(
            (t.grad != 0).any())


def test_recurrent_ops_launch_only_from_their_functions():
    """On the CPU neither op counts a launch (the plain versions run), and
    both go through their Function under grad mode."""
    common.reset_launches()
    a = torch.rand((1, 4, 8), requires_grad=True)
    h = rglru_scan_op(a, torch.rand((1, 4, 8)), torch.zeros((1, 8)))
    assert h.grad_fn is not None and "_Scan" in type(h.grad_fn).__name__
    r = torch.rand((1, 1, 4, 16), requires_grad=True)
    o, _ = rwkv6_wkv_op(r, r.detach(), r.detach(), -r.detach(),
                        torch.zeros((1, 16)), torch.zeros((1, 1, 16, 16)))
    assert "_Wkv" in type(o.grad_fn).__name__
    assert sum(common.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# the two families: loss, every leaf, one AdamW step
# ---------------------------------------------------------------------------


def _cfgs(arch):
    return (dataclasses.replace(jax_get_config(arch, reduced=True),
                                compute_dtype="float32"),
            dataclasses.replace(get_config(arch, reduced=True),
                                compute_dtype="float32"))


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    jcfg, cfg = _cfgs(request.param)
    jm = jax_build_model(jcfg)
    jp = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(5)))
    batch = pipeline_for(cfg, ShapeCell("t", 32, 2, "train"),
                         seed=2).batch(1)
    return jcfg, cfg, jm, jp, batch


def test_one_step_loss_and_gradients_match_reference(family):
    _, cfg, jm, jp, batch = family
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = optim.loss_and_grads(
        Model(cfg, device="cpu"), params_from_jax(jp),
        batch_from_numpy(batch))
    assert float(loss) == pytest.approx(float(jl), abs=TOL)
    for k in ("ce", "n_tok"):
        assert float(metrics[k]) == pytest.approx(float(jaux[k]), abs=TOL)
    want = flatten_with_path(params_from_jax(jax.device_get(jg)))
    got = flatten_with_path(grads)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.float().numpy(), atol=TOL,
                                   rtol=TOL, err_msg=str(path))
        d = float((g.double() - w.double()).norm())
        assert d <= TOL * float(w.double().norm()) + 1e-8, (path, d)


def _updates_close(params, jparams, jp, tol=UPDATE_TOL):
    """Each leaf's update (the parameters after the step less those
    before it) within ``tol`` of the reference's by relative norm (fp64):
    an update that does nothing is off by 1, one of the wrong sign by
    2."""
    start = flatten_with_path(params_from_jax(jp))
    want = flatten_with_path(params_from_jax(jax.device_get(jparams)))
    got = flatten_with_path(params)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w), (_, a) in zip(got, want, start):
        du, dw = g.double() - a.double(), w.double() - a.double()
        d = float((du - dw).norm())
        assert d <= tol * float(dw.norm()), (path, d)


def test_adamw_step_matches_reference(family):
    _, cfg, jm, jp, batch = family
    kw = dict(warmup_steps=2, decay_steps=10)
    jopt, opt = jax_optim.OptConfig(**kw), optim.OptConfig(**kw)
    jstate = jax_optim.init(jopt, jp)
    jparams, jstate, jmet = jax.jit(jax_optim.make_train_step(jm, jopt))(
        jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    params, state, met = optim.make_train_step(Model(cfg, "cpu"), opt)(
        params_from_jax(jp), opt_state_from_jax(jax.device_get(
            jax_optim.init(jopt, jp))), batch_from_numpy(batch))
    for k in ("loss", "grad_norm", "lr"):
        assert float(met[k]) == pytest.approx(float(jmet[k]), abs=TOL,
                                              rel=TOL), k
    _updates_close(params, jparams, jp)
    want = opt_state_from_jax(jax.device_get(jstate))
    for key in ("m", "v"):
        for (path, g), (_, w) in zip(flatten_with_path(state[key]),
                                     flatten_with_path(want[key])):
            d = float((g.double() - w.double()).norm())
            assert d <= 1e-5 * float(w.double().norm()), (key, path, d)


def test_remat_changes_no_number(family):
    """``remat="full"`` recomputes each layer, the two Functions' forwards
    included, in the backward: the loss and gradients of ``"none"``
    exactly."""
    _, cfg, _, jp, batch = family
    out = {}
    for remat in ("none", "full"):
        c = dataclasses.replace(cfg, sharding=dataclasses.replace(
            cfg.sharding, remat=remat))
        out[remat] = optim.loss_and_grads(Model(c, device="cpu"),
                                          params_from_jax(jp),
                                          batch_from_numpy(batch))
    assert torch.equal(out["full"][0], out["none"][0])
    for (_, a), (_, b) in zip(flatten_with_path(out["full"][2]),
                              flatten_with_path(out["none"][2])):
        assert torch.equal(a, b)


def test_update_in_row_blocks_gives_the_whole_leaf_bits(monkeypatch):
    """AdamW updates a leaf above ``UPDATE_BLOCK`` elements in blocks of
    rows (to bound its fp32 temporaries on the card): the same bits as the
    whole leaf at once, fp32 and bf16 leaves, a 0-d leaf, a ragged last
    block."""
    from repro_torch.optim import adamw
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((301, 7), generator=gen),
              "e": torch.randn((100, 3, 5), generator=gen).bfloat16(),
              "bias": torch.randn((9,), generator=gen),
              "lam": torch.randn((), generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen).to(v.dtype)
             for k, v in params.items()}
    for sdt in ("float32", "bfloat16"):
        opt = adamw.OptConfig(warmup_steps=2, state_dtype=sdt)
        state = adamw.init(opt, params)
        state["m"] = {k: torch.randn(v.shape, generator=gen).to(v.dtype)
                      for k, v in state["m"].items()}
        state["v"] = {k: torch.rand(v.shape, generator=gen).to(v.dtype)
                      for k, v in state["v"].items()}
        whole = adamw.update(opt, grads, state, params)
        monkeypatch.setattr(adamw, "UPDATE_BLOCK", 40)
        assert len(adamw._row_blocks(params["w"])) == 61
        blocks = adamw.update(opt, grads, state, params)
        monkeypatch.undo()
        for a, b in zip(adamw.leaves([whole[0], whole[1]["m"],
                                      whole[1]["v"]]),
                        adamw.leaves([blocks[0], blocks[1]["m"],
                                      blocks[1]["v"]])):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_driver_trains_the_family_natively_and_virtualized(arch,
                                                                tmp_path):
    """``python -m repro_torch.launch.train --arch`` on the CPU: finite
    losses, the same through a VMM tenant's train program."""
    from repro_torch.launch import train
    args = ["--device", "cpu", "--arch", arch, "--steps", "3", "--batch",
            "2", "--seq", "32", "--ckpt-dir"]
    native = train.main(args + [str(tmp_path / "n")])
    virt = train.main(args + [str(tmp_path / "v"), "--virtualized"])
    assert sorted(native) == [0, 1, 2]
    assert all(np.isfinite(v) for v in native.values())
    assert virt == native
