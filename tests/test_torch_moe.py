"""The MoE families — ``mixtral-8x7b`` (8 experts top-2, sliding window)
and ``kimi-k2-1t-a32b`` (a dense first layer, a shared expert) — and the
gather dispatch itself, the port against the reference's JAX package on
the same weights, reduced configs on the CPU.

The reduced configs' capacity factor of 2.0 never drops an assignment,
so every dispatch and engine test here also runs at ``capacity_factor``
0.5, where drops are the normal case (as at kimi's full width, where a
decode step's capacity is one row an expert).

Tolerances: 1e-5 in fp32 compute (the reference's Pallas kernels in
interpret mode, ``use_pallas=True``), 5e-2 in bf16; expert picks and
engine token ids exactly; the bridge's round trip byte-exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.models import Model, lm
from repro_torch.models import moe
from repro_torch.serving import ServeEngine

torch.set_num_threads(2)

ARCHS = ["mixtral-8x7b", "kimi-k2-1t-a32b"]
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
PLENS = [5, 9, 13, 17, 11]


def _cfgs(arch, cd="float32", cf=None):
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    out = []
    for c in (jcfg, cfg):
        kw = {"compute_dtype": cd}
        if cf is not None:
            kw["moe"] = dataclasses.replace(c.moe, capacity_factor=cf)
        out.append(dataclasses.replace(c, **kw))
    return out


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


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """One reference init per family at cf 0.5: the jitted model with
    its Pallas kernels in interpret mode for the model-level tests, the
    plain one for the reference engine, the port's model and params."""
    jcfg, cfg = _cfgs(request.param, cf=0.5)
    raw = jax_build_model(jcfg)
    jp = jax.jit(raw.init)(jax.random.PRNGKey(7))
    jm = _jit(jax_build_model(dataclasses.replace(jcfg, use_pallas=True)))
    return jcfg, cfg, jm, raw, jp, Model(cfg, device="cpu"), \
        params_from_jax(jax.device_get(jp))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _drops(jcfg, jp, x):
    """How many (token, k) assignments the reference drops on x."""
    m = jcfg.moe
    T = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax(jnp.asarray(x.reshape(T, -1)) @ jp["router"], -1)
    _, top_i = jax.lax.top_k(probs, m.top_k)
    C = jax_moe.capacity(T, m.top_k, m.n_experts, m.capacity_factor)
    counts = np.bincount(np.asarray(top_i).ravel(), minlength=m.n_experts)
    return int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cd,cf", [("float32", 2.0), ("float32", 0.5),
                                   ("bfloat16", 0.5)])
def test_gather_dispatch_matches_reference(arch, cd, cf):
    jcfg, cfg = _cfgs(arch, cd, cf)
    jp = jax.device_get(jax_moe.init_moe(jcfg, jax.random.PRNGKey(1)))
    x = np.random.default_rng(2).standard_normal(
        (3, 7, cfg.d_model)).astype(np.float32)
    want, jaux = jax_moe.apply_moe_gather(
        jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    got, aux = moe.apply_moe_gather(cfg, _torch_tree(jp), torch.from_numpy(x))
    assert got.dtype == getattr(torch, cd)
    _close(got, want, TOL[cd])
    _close(aux, jaux, 1e-6)
    dropped = _drops(jcfg, jp, x)
    assert (dropped > 0) == (cf < 1.0)
    assert ("shared" in jp) == (arch == "kimi-k2-1t-a32b")


def test_router_ties_go_to_the_lower_expert():
    """Experts 1 and 3 (and 0 and 2) have the same router column, so
    every token's probabilities tie in pairs: the picks are the lower
    index of each tie, as ``jax.lax.top_k`` gives them, and the layer
    output agrees with the reference's with ties and drops."""
    jcfg, cfg = _cfgs("mixtral-8x7b", cf=0.5)
    jp = jax.device_get(jax_moe.init_moe(jcfg, jax.random.PRNGKey(3)))
    r = np.array(jp["router"])
    r[:, 3], r[:, 2] = r[:, 1], r[:, 0]
    jp = dict(jp, router=r)
    x = np.random.default_rng(4).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    xf = torch.from_numpy(x.reshape(18, -1))
    probs, top_w, top_i = moe.route(cfg, _torch_tree(jp), xf)
    _, want_i = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x.reshape(18, -1))
                                             @ jnp.asarray(r), -1), 2)
    assert np.array_equal(top_i.numpy(), np.asarray(want_i))
    assert bool((probs[:, 1] == probs[:, 3]).all())
    for row in top_i.tolist():
        assert 3 not in row or 1 in row
        assert 2 not in row or 0 in row
    want, _ = jax_moe.apply_moe_gather(
        jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    got, _ = moe.apply_moe_gather(cfg, _torch_tree(jp), torch.from_numpy(x))
    _close(got, want, TOL["float32"])


def test_dense_prefix_and_shared_expert(pair):
    """kimi's first layer is a swiglu FFN of ``dense_d_ff`` outside the
    scan, and its MoE layers carry the shared expert; mixtral has
    neither. The layout and every layer's FFN leaves match the
    reference's, and so do prefill logits (fp32, drops forced)."""
    jcfg, cfg, jm, _, jp, m, p = pair
    kimi = cfg.moe.first_dense_layers > 0
    specs = lm.layer_specs(cfg)
    n_dense = cfg.moe.first_dense_layers
    assert [(s.ffn, s.d_ff) for s in specs] == \
        [("swiglu", cfg.moe.dense_d_ff)] * n_dense \
        + [("moe", cfg.d_ff)] * (cfg.n_layers - n_dense)
    from repro.models import lm as jax_lm
    jspecs = jax_lm.layer_specs(jcfg)
    assert [(e[0], len(e[1])) + e[2:] for e in
            jax_lm.build_layout(jcfg, jspecs)] == \
        [(e[0], len(e[1])) + e[2:] for e in lm.build_layout(cfg, specs)]
    for layer, spec in zip(p["layers"], specs):
        if spec.ffn == "swiglu":
            assert set(layer["ffn"]) == {"w_gate", "w_up", "w_down"}
            assert tuple(layer["ffn"]["w_up"].shape) == (
                cfg.d_model, cfg.moe.dense_d_ff)
        else:
            assert set(layer["ffn"]) == {"router", "w_gate", "w_up",
                                         "w_down"} | ({"shared"} if kimi
                                                      else set())
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 23))
    want, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    got, _ = m.prefill(p, {"tokens": torch.from_numpy(toks)})
    _close(got[:, :cfg.vocab], np.asarray(want)[:, :cfg.vocab],
           TOL["float32"])
    if kimi:
        # the shared expert matters: without it the logits move
        bare = dict(p, layers=[
            dict(layer, ffn=dict(layer["ffn"], shared=dict(
                layer["ffn"]["shared"],
                w_down=torch.zeros_like(layer["ffn"]["shared"]["w_down"]))))
            if "shared" in layer["ffn"] else layer
            for layer in p["layers"]])
        moved, _ = m.prefill(bare, {"tokens": torch.from_numpy(toks)})
        assert float((moved - got).abs().max()) > 1e-3


def test_paged_decode_routes_dead_slots(pair):
    """A dead slot's placeholder row (token 0 at position 0) is routed
    and takes capacity as in the reference: with drops forced, paged
    decode logits agree over three steps for every slot."""
    jcfg, cfg, jm, _, jp, m, p = pair
    ps, nb, lens = 8, 4, [11, 0, 19, 0]
    P = len(lens) * nb
    bt = np.arange(P, dtype=np.int32).reshape(len(lens), nb)
    js = jm.init_paged_state(len(lens), P, ps)
    ts = m.init_paged_state(len(lens), P, ps)
    rng = np.random.default_rng(8)
    for b, L in enumerate(lens):
        if L:
            toks = rng.integers(0, cfg.vocab, (1, L)).astype(np.int32)
            _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
            js = jm.write_prefill_paged(js, jc, jnp.int32(b),
                                        jnp.asarray(bt[b]), L, ps)
            _, tc = m.prefill(p, {"tokens": torch.from_numpy(toks).long()})
            ts = m.write_prefill_paged(ts, tc, b, torch.from_numpy(bt[b]),
                                       L, ps)
    pos = np.asarray([11, -1, 19, -1], np.int32)
    tok = np.asarray([[3], [0], [9], [0]], np.int32)
    for _ in range(3):
        want, js = jm.decode_paged(jp, js, jnp.asarray(tok),
                                   jnp.asarray(pos), jnp.asarray(bt))
        got, ts = m.decode_paged(p, ts, torch.from_numpy(tok).long(),
                                 torch.from_numpy(pos), torch.from_numpy(bt))
        _close(got[:, :cfg.vocab], np.asarray(want)[:, :cfg.vocab],
               TOL["float32"])
        tok = np.argmax(np.asarray(want)[:, :cfg.vocab], -1)[:, None].astype(
            np.int32)
        tok[pos < 0] = 0
        pos = np.where(pos >= 0, pos + 1, pos).astype(np.int32)


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
                          max_new_tokens=3 + 2 * (j % 3), temperature=t)
            for j, (n, t) in enumerate(zip(PLENS, temps))]
    engine.run_round(params)
    return {r: engine.completed[r].out_tokens for r in rids}


@pytest.mark.parametrize("chunk,temps", [
    (0, (0.0, 0.8, 0.0, 1.3, 0.5)),
    (8, (0.0,) * 5),
])
def test_engine_tokens_with_drops_and_dead_slots(pair, chunk, temps):
    """Batch 3 over five requests of unequal budgets: slots go dead
    between requests (and mid-prefill in chunked mode) while the others
    decode; drops forced (cf 0.5). Token ids equal the reference
    engine's."""
    jcfg, cfg, _, jm, jp, m, p = pair
    kw = dict(page_size=8, chunk_tokens=chunk, seed=3)
    jeng = JaxServeEngine(jcfg, jm, 3, 64, decode_wrap=_writable_logits,
                          **kw)
    want = _serve(jeng, jp, temps, cfg.vocab)
    eng = ServeEngine(cfg, m, 3, 64, state_paging=True, **kw)
    assert _serve(eng, p, temps, cfg.vocab) == want
    s = eng.stats
    assert s.full_prefills == 0 and s.completed == len(PLENS)
    assert s.pages_leased == s.pages_freed > 0
    assert s.page_faults == jeng.stats.page_faults


def test_bridge_round_trip_of_the_moe_tree(pair):
    """The reference tree — router, stacked experts (periods, E, d, de)
    inside the scan, kimi's unrolled dense layer and shared expert —
    crosses to the port and back byte for byte, also in bf16."""
    jcfg, cfg, _, _, jp, _, _ = pair
    tree32 = jax.device_get(jp)
    bf16 = jax.tree.map(lambda a: a if a.dtype != np.float32 or a.ndim < 2
                        else a.astype(jnp.bfloat16), tree32)
    for tree in (tree32, bf16):
        back = params_to_numpy(params_from_jax(tree), cfg)
        flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
        assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
        for (path, a), (_, b) in zip(flat_a, flat_b):
            a = np.asarray(a)
            if a.dtype.name == "bfloat16":
                a = a.view(np.uint16)
            assert a.shape == b.shape and np.array_equal(a, b), path
        experts = [leaf for path, leaf in flat_a
                   if "w_gate" in jax.tree_util.keystr(path)
                   and np.asarray(leaf).ndim == 4]
        assert experts and experts[0].shape[1] == cfg.moe.n_experts
