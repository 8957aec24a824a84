"""The other dense families — ``internlm2-1.8b`` (GQA 16/8 at full
width), ``phi3-mini-3.8b`` (MHA) and ``starcoder2-15b`` (GELU FFN with
biases, layernorm, QKV bias) — the port against the reference's JAX
package on the same weights (carried across by ``repro_torch.bridge``),
reduced configs on the CPU.

Tolerances: logits at 1e-5 in fp32 compute (the reference runs its
Pallas kernels in interpret mode, ``use_pallas=True``) and 5e-2 in the
configs' bf16, the reference's own; the GELU FFN at 1e-5; engine token
ids exactly (fp32), the port's against the reference engine's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import layers
from repro_torch.serving import ServeEngine

torch.set_num_threads(2)

ARCHS = ["internlm2-1.8b", "phi3-mini-3.8b", "starcoder2-15b"]
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
PS, NB = 8, 4
PLENS = [5, 9, 13, 17, 11]         # straddle the 8-token pages and chunks


def _cfgs(arch, cd="float32"):
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               compute_dtype=cd)
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype=cd)
    return jcfg, cfg


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """One reference init per family (fp32): the jitted model with its
    Pallas kernels in interpret mode, the port's model and params."""
    jcfg, cfg = _cfgs(request.param)
    jm = _jit(jax_build_model(dataclasses.replace(jcfg,
                                                use_pallas=True)))
    jp = jm.init(jax.random.PRNGKey(3))
    return cfg, jm, jp, Model(cfg, device="cpu"), params_from_jax(
        jax.device_get(jp))


def _jit(jm):
    """The reference model with its entry points jitted: eager JAX runs
    its scans op by op, hundreds of times slower on these shapes."""
    class Jitted:
        init = staticmethod(jax.jit(jm.init))
        prefill = staticmethod(jax.jit(jm.prefill,
                                       static_argnames="capacity"))
        decode = staticmethod(jax.jit(jm.decode))
        decode_paged = staticmethod(jax.jit(jm.decode_paged))
        write_prefill_paged = staticmethod(jax.jit(
            jm.write_prefill_paged, static_argnums=(4, 5)))
        init_paged_state = staticmethod(jm.init_paged_state)
        read_state_row = staticmethod(jm.read_state_row)
        encode = staticmethod(jax.jit(jm.encode))
        _project_patches = staticmethod(jax.jit(jm._project_patches))
    return Jitted


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _prompt(n, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (n,)).astype(
        np.int32)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_prefill_logits(pair, cd):
    """Prefill logits and K/V caches in fp32 and in the configs' bf16
    (the same weights, computed in bf16 on both sides)."""
    cfg, jm, jp, m, p = pair
    if cd == "bfloat16":
        jcfg, cfg = _cfgs(cfg.name, cd)
        jm = _jit(jax_build_model(dataclasses.replace(jcfg,
                                                    use_pallas=True)))
        m = Model(cfg, device="cpu")
    toks = np.stack([_prompt(21, 1, cfg.vocab), _prompt(21, 2, cfg.vocab)])
    want, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    got, caches = m.prefill(p, {"tokens": torch.from_numpy(toks).long()})
    _close(got[:, :cfg.vocab], np.asarray(want)[:, :cfg.vocab], TOL[cd])
    assert bool((got[:, cfg.vocab:] < -1e29).all())
    _close(caches["k"][0], np.asarray(jc[0][0]["mixer"]["k"])[0], TOL[cd])


def test_ring_decode(pair):
    """Prefill into ring caches of 32 slots, then 4 greedy decode steps
    at the shared position: logits at every step."""
    cfg, jm, jp, m, p = pair
    toks = np.stack([_prompt(13, 5, cfg.vocab), _prompt(13, 6, cfg.vocab)])
    want, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, capacity=32)
    got, tc = m.prefill(p, {"tokens": torch.from_numpy(toks).long()},
                        capacity=32)
    for pos in range(13, 17):
        _close(got[:, :cfg.vocab], np.asarray(want)[:, :cfg.vocab],
               TOL["float32"])
        nxt = np.argmax(np.asarray(want)[:, :cfg.vocab], -1)[:, None].astype(
            np.int32)
        want, jc = jm.decode(jp, jc, jnp.asarray(nxt), jnp.int32(pos))
        got, tc = m.decode(p, tc, torch.from_numpy(nxt).long(), pos)
    _close(got[:, :cfg.vocab], np.asarray(want)[:, :cfg.vocab],
           TOL["float32"])


def test_paged_decode_dead_slot(pair):
    """Monolithic prefill of two live slots through a permuted block
    table, a dead middle slot, two paged decode steps: logits and every
    K/V pool row agree."""
    cfg, jm, jp, m, p = pair
    lens = [13, 0, 21]
    P = len(lens) * NB + 2
    bt = np.random.default_rng(5).permutation(P)[:len(lens) * NB].reshape(
        len(lens), NB).astype(np.int32)
    js = jm.init_paged_state(len(lens), P, PS)
    ts = m.init_paged_state(len(lens), P, PS)
    for b, L in enumerate(lens):
        if not L:
            continue
        toks = _prompt(L, 10 + b, cfg.vocab)[None]
        _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
        js = jm.write_prefill_paged(js, jc, jnp.int32(b), jnp.asarray(bt[b]),
                                    L, PS)
        _, tc = m.prefill(p, {"tokens": torch.from_numpy(toks).long()})
        ts = m.write_prefill_paged(ts, tc, b, torch.from_numpy(bt[b]), L, PS)
    pos = np.asarray([13, -1, 21], np.int32)
    tok = np.asarray([[3], [0], [7]], np.int32)
    for _ in range(2):
        want, js = jm.decode_paged(jp, js, jnp.asarray(tok),
                                   jnp.asarray(pos), jnp.asarray(bt))
        got, ts = m.decode_paged(p, ts, torch.from_numpy(tok).long(),
                                 torch.from_numpy(pos), torch.from_numpy(bt))
        _close(got[:, :cfg.vocab], np.asarray(want)[:, :cfg.vocab],
               TOL["float32"])
        tok = np.argmax(np.asarray(want)[:, :cfg.vocab], -1)[:, None].astype(
            np.int32)
        pos = np.where(pos >= 0, pos + 1, pos).astype(np.int32)
    for kk in ("k", "v"):
        for a in range(ts[kk].shape[0]):
            _close(ts[kk][a], np.asarray(js[0][0]["mixer"][kk])[a],
                   TOL["float32"])


@pytest.mark.parametrize("d_ff", [256, 96])
def test_gelu_ffn_tanh_form(d_ff):
    """The GELU FFN with its biases against the reference's (tanh
    approximation, ``jax.nn.gelu``'s default) at 1e-5; the exact erf form
    is further off than that."""
    jcfg, cfg = _cfgs("starcoder2-15b")
    jp = jax_layers.init_ffn(jcfg, jax.random.PRNGKey(6), kind="gelu",
                             d_ff=d_ff)
    rng = np.random.default_rng(7)
    jp = {k: np.asarray(v) + (0.1 * rng.standard_normal(v.shape).astype(
        np.float32) if k.startswith("b_") else 0) for k, v in jp.items()}
    x = (2.0 * rng.standard_normal((2, 9, cfg.d_model))).astype(np.float32)
    want = np.asarray(jax_layers.apply_ffn(
        jcfg, {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x),
        kind="gelu"))
    tp = {k: torch.from_numpy(v) for k, v in jp.items()}
    got = layers.apply_ffn(cfg, tp, torch.from_numpy(x), kind="gelu")
    _close(got, want, TOL["float32"])
    assert got.shape == (2, 9, cfg.d_model)
    init = layers.init_ffn(cfg, torch.Generator().manual_seed(0), "cpu",
                           kind="gelu", d_ff=d_ff)
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: v.shape for k, v in jp.items()}
    erf = torch.nn.functional.gelu(
        torch.from_numpy(x) @ tp["w_up"] + tp["b_up"]) @ tp["w_down"] \
        + tp["b_down"]
    assert float((erf - got).abs().max()) > 10 * TOL["float32"]


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
def test_engine_tokens_match_reference(pair, chunk, temps):
    cfg, _, jp, m, p = pair
    jcfg, _ = _cfgs(cfg.name)
    jm = jax_build_model(jcfg)
    kw = dict(page_size=8, chunk_tokens=chunk, seed=3)
    jeng = JaxServeEngine(jcfg, jm, 2, 64, decode_wrap=_writable_logits,
                          **kw)
    want = _serve(jeng, jp, temps, cfg.vocab)
    eng = ServeEngine(cfg, m, 2, 64, state_paging=True, **kw)
    assert _serve(eng, p, temps, cfg.vocab) == want
    s = eng.stats
    assert s.full_prefills == 0 and s.completed == len(PLENS)
    assert s.pages_leased == s.pages_freed > 0
    assert s.page_faults == jeng.stats.page_faults
    assert eng.rstate is None and s.state_pages_leased == 0
    if chunk:
        assert s.prefill_chunks == sum(-(-n // chunk) for n in PLENS)
