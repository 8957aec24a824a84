"""The VMM's programs of the repo's seven other families (internlm2,
phi3-mini, starcoder2, mixtral, kimi-k2, internvl2 with its ``patches``,
whisper with its ``frames``), each built by the port's
``CompileService`` and by the reference's on a 1×1 CPU slice and run
through a tenant's guest API, on the same JAX-initialised weights
(reduced configs, the reference with ``use_pallas=False``):

* abstract args equal by path, shape and dtype (prefill and decode bf16
  params, train fp32 params and AdamW state, the batch with its frontend
  input);
* the prefill program's logits and three decode steps, each fed the
  reference's greedy id, within 5e-2 (the bf16 value of
  ``tests/test_kernel_integration.py``);
* one train step (``ProgramRequest(kind="train")``, no ``opt_flags``:
  both sides the default ``OptConfig``) on fp32 weights, in fp32 compute
  (each VMM's ``CompileService`` gets a step builder that hands its own
  package's ``build_step_for_cell`` the config with
  ``compute_dtype="float32"``: the reduced configs compute in bf16, whose
  sums in another order differ by ~1e-3): loss and grad_norm within
  1e-4 (relative and absolute), every updated parameter within 1e-4,
  and each leaf's update (step 1's learning rate is 3e-6, well inside
  1e-4) within 1e-3 of the reference's by relative norm, the rule of
  ``tests/test_torch_train.py`` (a skipped update is off by 1, a
  sign-flipped one by 2); but for whisper's key biases (``bk``), whose
  gradient is zero but for rounding (softmax ignores a shift of every
  key), so that AdamW moves them by g/(|g| + eps), noise on both sides.

The families are split over this file and
``tests/test_torch_family_programs_moe.py`` to keep each under a minute.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_config as jax_get_config
from repro.core import VMM as JaxVMM
from repro.core.reconfig import CompileService as JaxCompileService
from repro.core.reconfig import ProgramRequest as JaxProgramRequest
from repro.data import pipeline_for as jax_pipeline_for
from repro.configs.base import ShapeCell as JaxShapeCell
from repro.models import build_model as jax_build_model
from repro.parallel.steps import \
    build_step_for_cell as jax_build_step_for_cell
from repro_torch.bridge import (batch_from_numpy, caches_to_numpy,
                                params_from_jax, stacked_layout)
from repro_torch.checkpointing.checkpoint import flatten_with_path
from repro_torch.configs import get_config
from repro_torch.core import VMM, ProgramRequest
from repro_torch.core.reconfig import CompileService, keystr
from repro_torch.parallel import build_step_for_cell

torch.set_num_threads(2)

FAMILIES = ["internlm2-1.8b", "phi3-mini-3.8b", "starcoder2-15b"]
S, B = 16, 2
LOGIT_TOL, TRAIN_TOL, UPDATE_TOL = 5e-2, 1e-4, 1e-3


def _grid():
    g = np.empty((1, 1), dtype=object)
    g[0, 0] = torch.device("cpu")
    return g


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros(v) for v in tree]
    return torch.zeros(tree.shape, dtype=tree.dtype)


def _jax_sig(tree):
    return [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_sig(tree):
    return [(keystr(k), tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for k, x in flatten_with_path(tree)]


def _numpy_sig(tree):
    """Signature of the bridge's numpy trees, whose bf16 leaves are
    uint16 views (numpy has no bf16)."""
    return [(p, shape, "bfloat16" if dt == "uint16" else dt)
            for p, shape, dt in _jax_sig(tree)]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _batch(cfg, abstract, seed, jax_side):
    """Random tokens (and frontend embeddings) with the shapes of a
    program's abstract batch."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, x in abstract.items():
        if k in ("patches", "frames"):
            out[k] = rng.standard_normal(tuple(x.shape)).astype(np.float32)
        else:
            out[k] = rng.integers(0, cfg.vocab, tuple(x.shape)).astype(
                np.int32)
    return {k: (jnp.asarray(v) if jax_side else torch.from_numpy(v))
            for k, v in out.items()}


def _fp32(build):
    def builder(cfg, where, cell, **kw):
        return build(dataclasses.replace(cfg, compute_dtype="float32"),
                     where, cell, **kw)
    return builder


def _vmms(fp32):
    vmm = VMM(_grid(), hbm_per_chip=1 << 28, segment_bytes=1 << 20)
    jvmm = JaxVMM(Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                       ("data", "model")), hbm_per_chip=1 << 28,
                  segment_bytes=1 << 20)
    if fp32:
        vmm.compiler = CompileService(_fp32(build_step_for_cell))
        jvmm.compiler = JaxCompileService(_fp32(jax_build_step_for_cell))
    return vmm, jvmm


@pytest.fixture(scope="module")
def serve_vmms():
    """(port tenant device, reference tenant device), default builders."""
    yield from _devices(fp32=False)


@pytest.fixture(scope="module")
def train_vmms():
    """The same, both compile services building in fp32 compute."""
    yield from _devices(fp32=True)


def _devices(fp32):
    vmm, jvmm = _vmms(fp32)
    try:
        yield vmm.create_vm("a", (1, 1)).device, \
            jvmm.create_vm("a", (1, 1)).device
    finally:
        vmm.shutdown()
        jvmm.shutdown()


def _programs(vmms, arch, kind):
    """(port program, reference program) for ``kind``: each reprogrammed
    into its tenant (the last one loaded is the one ``run`` drives)."""
    dev, jdev = vmms
    return (dev.reprogram(ProgramRequest(arch, kind, S, B)),
            jdev.reprogram(JaxProgramRequest(arch, kind, S, B)))


def check_serving_programs(vmms, arch):
    cfg = get_config(arch, reduced=True)
    jp32 = jax_build_model(jax_get_config(arch, reduced=True)).init(
        jax.random.PRNGKey(6))
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp32)
    p = params_from_jax(jax.device_get(jp))
    dev, jdev = vmms
    progs = {kind: _programs(vmms, arch, kind)
             for kind in ("prefill", "decode")}
    for kind, (prog, jprog) in progs.items():
        mabs = prog.bitfile.abstract_args
        jabs = jprog.bitfile.abstract_args
        assert _port_sig(stacked_layout(_zeros(mabs[0]), cfg)) == \
            _jax_sig(jabs[0]), kind
        if kind == "prefill":
            assert _port_sig(mabs[1]) == _jax_sig(jabs[1])
        else:
            assert _numpy_sig(caches_to_numpy(_zeros(mabs[1]), cfg)) == \
                _jax_sig(jabs[1])
            assert [(tuple(x.shape), str(x.dtype)[6:]) for x in mabs[2:]] \
                == [(tuple(x.shape), str(x.dtype)) for x in jabs[2:]]
    pf, jpf = progs["prefill"]
    mabs = pf.bitfile.abstract_args[1]
    jlog, jc = jpf(jp, _batch(cfg, mabs, 3, True))
    mlog, mc = pf(p, _batch(cfg, mabs, 3, False))
    _close(mlog[:, :cfg.vocab], np.asarray(jlog)[:, :cfg.vocab], LOGIT_TOL)
    dc, jdc = progs["decode"]
    pos = S
    for _ in range(3):
        tok = np.argmax(np.asarray(jlog, np.float32)[:, :cfg.vocab],
                        -1)[:, None].astype(np.int32)
        jlog, jc = jdc(jp, jc, jnp.asarray(tok), jnp.int32(pos))
        mlog, mc = dc(p, mc, torch.from_numpy(tok),
                      torch.tensor(pos, dtype=torch.int32))
        _close(mlog[:, :cfg.vocab], np.asarray(jlog)[:, :cfg.vocab],
               LOGIT_TOL)
        pos += 1


def check_train_program(vmms, arch):
    from repro import optim as jax_optim
    from repro_torch.bridge import opt_state_from_jax
    cfg = get_config(arch, reduced=True)
    prog, jprog = _programs(vmms, arch, "train")
    mabs, jabs = prog.bitfile.abstract_args, jprog.bitfile.abstract_args
    assert _port_sig(stacked_layout(_zeros(mabs[0]), cfg)) == \
        _jax_sig(jabs[0])
    for key in ("m", "v"):
        assert _port_sig(stacked_layout(_zeros(mabs[1][key]), cfg)) == \
            _jax_sig(jabs[1][key])
    assert (tuple(mabs[1]["step"].shape), str(mabs[1]["step"].dtype)[6:]) \
        == (tuple(jabs[1]["step"].shape), str(jabs[1]["step"].dtype))
    assert _port_sig(mabs[2]) == _jax_sig(jabs[2])
    jcfg = jax_get_config(arch, reduced=True)
    jp = jax.device_get(jax_build_model(jcfg).init(jax.random.PRNGKey(5)))
    jstate = jax.device_get(jax_optim.init(jax_optim.OptConfig(
        state_dtype=jcfg.opt_dtype), jp))
    batch = jax_pipeline_for(jcfg, JaxShapeCell("t", S, B, "train"),
                             seed=2).batch(0)
    jnew, _, jm = jprog(jp, jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    new, _, m = prog(params_from_jax(jp), opt_state_from_jax(jstate),
                     batch_from_numpy(batch))
    for k in ("loss", "grad_norm"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=TRAIN_TOL,
                                            abs=TRAIN_TOL), k
    start = flatten_with_path(params_from_jax(jp))
    want = flatten_with_path(params_from_jax(jax.device_get(jnew)))
    got = flatten_with_path(new)
    assert [q for q, _ in got] == [q for q, _ in want]
    for (path, g), (_, w), (_, a) in zip(got, want, start):
        _close(g, w.float().numpy(), TRAIN_TOL)
        if path[-1] == "bk":
            continue
        du, dw = g.double() - a.double(), w.double() - a.double()
        d = float((du - dw).norm())
        assert d <= UPDATE_TOL * float(dw.norm()), (path, d)


@pytest.mark.parametrize("arch", FAMILIES)
def test_serving_programs_match_reference(serve_vmms, arch):
    check_serving_programs(serve_vmms, arch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_program_matches_reference(train_vmms, arch):
    check_train_program(train_vmms, arch)
