"""The frontend families — ``internvl2-2b`` (the VLM: projected image
patches before the prompt) and ``whisper-medium`` (the enc-dec: a
non-causal encoder over audio frames, cross attention in every decoder
layer, sinusoidal positions) — the port against the reference's JAX
package on the same weights and stub inputs, reduced configs on the CPU.

The reference engine mishandles the VLM's patch rows: it leases and
writes pages for the prompt's length only and decodes from position
``plen``, so the last ``n_img`` rows of the prefill never reach the
pages and every decode position is ``n_img`` short.
``test_reference_vlm_engine_fault`` pins that; the port's VLM engine is
held to the reference's own ``Model.prefill`` + ``Model.decode`` at
position ``n_img + plen`` instead.

Tolerances: 1e-5 in fp32 compute (the reference's Pallas kernels in
interpret mode, ``use_pallas=True``); token ids exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_jax, state_rows_from_jax
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import Model
from repro_torch.serving import ServeEngine

torch.set_num_threads(2)

TOL = 1e-5
VLM, ASR = "internvl2-2b", "whisper-medium"


def _cfgs(arch):
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    return jcfg, cfg


@pytest.fixture(scope="module", params=[VLM, ASR])
def pair(request):
    jcfg, cfg = _cfgs(request.param)
    jm = _jit(jax_build_model(dataclasses.replace(jcfg,
                                                use_pallas=True)))
    jp = jm.init(jax.random.PRNGKey(12))
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


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _stub(cfg, batch, seed=0):
    """The stub frontend input of ``cfg``, one row per slot."""
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.frontend.n_tokens, cfg.frontend.d_in), dtype=np.float32)


def _batches(cfg, toks, seed=0):
    key = "patches" if cfg.family == "vlm" else "frames"
    stub = _stub(cfg, toks.shape[0], seed)
    return ({"tokens": jnp.asarray(toks, jnp.int32), key: jnp.asarray(stub)},
            {"tokens": torch.from_numpy(toks).long(),
             key: torch.from_numpy(stub)})


def test_projector_and_encoder():
    """The VLM's patch projector (GELU, tanh form) and whisper's encoder
    (sinusoidal positions, non-causal attention, GELU FFN, final norm)
    against the reference's."""
    for arch, fn in ((VLM, "_project_patches"), (ASR, "encode")):
        jcfg, cfg = _cfgs(arch)
        jm = _jit(jax_build_model(jcfg))
        jp = jm.init(jax.random.PRNGKey(13))
        m = Model(cfg, device="cpu")
        p = params_from_jax(jax.device_get(jp))
        x = _stub(cfg, 2, seed=14)
        want = getattr(jm, fn)(jp, jnp.asarray(x))
        got = getattr(m, fn)(p, torch.from_numpy(x))
        assert tuple(got.shape) == (2, cfg.frontend.n_tokens, cfg.d_model)
        _close(got, want)
    # the encoder is bidirectional: the first frame's output depends on
    # the last frame
    x2 = x.copy()
    x2[:, -1] = _stub(cfg, 2, seed=21)[:, -1]
    moved = m.encode(p, torch.from_numpy(x2)) - got
    assert float(moved[:, 0].abs().max()) > 1e-4


def test_prefill_logits_and_caches(pair):
    cfg, jm, jp, m, p = pair
    toks = np.random.default_rng(15).integers(0, cfg.vocab, (2, 13))
    jb, tb = _batches(cfg, toks)
    want, jc = jm.prefill(jp, jb)
    got, caches = m.prefill(p, tb)
    _close(got[:, :cfg.vocab], np.asarray(want)[:, :cfg.vocab])
    n_img = m.n_prefix
    assert n_img == (cfg.frontend.n_tokens if cfg.family == "vlm" else 0)
    assert caches["k"].shape[2] == n_img + 13
    _close(caches["k"][0], np.asarray(jc[0][0]["mixer"]["k"])[0])
    if cfg.is_encdec:
        cross = caches["rows"][0]["cross"]
        assert tuple(cross["k"].shape) == (2, cfg.encoder.seq_len,
                                           cfg.n_kv_heads, cfg.d_head)
        _close(cross["v"], np.asarray(jc[0][0]["cross"]["v"])[0])


def test_ring_decode(pair):
    """Prefill into ring caches of 64 slots, then 4 greedy decode steps
    at the shared position (after the VLM's image rows)."""
    cfg, jm, jp, m, p = pair
    toks = np.random.default_rng(16).integers(0, cfg.vocab, (2, 11))
    jb, tb = _batches(cfg, toks)
    want, jc = jm.prefill(jp, jb, capacity=64)
    got, tc = m.prefill(p, tb, capacity=64)
    pos = m.n_prefix + 11
    for step in range(4):
        _close(got[:, :cfg.vocab], np.asarray(want)[:, :cfg.vocab])
        nxt = np.argmax(np.asarray(want)[:, :cfg.vocab], -1)[:, None].astype(
            np.int32)
        want, jc = jm.decode(jp, jc, jnp.asarray(nxt), jnp.int32(pos + step))
        got, tc = m.decode(p, tc, torch.from_numpy(nxt).long(), pos + step)
    _close(got[:, :cfg.vocab], np.asarray(want)[:, :cfg.vocab])


def test_paged_decode_with_cross_rows():
    """whisper: two slots prefilled into a paged state (their cross K/V
    in the slots' rows), a dead slot between them, three paged decode
    steps; the state carried over by the bridge agrees too."""
    jcfg, cfg = _cfgs(ASR)
    jm = _jit(jax_build_model(dataclasses.replace(jcfg, use_pallas=True)))
    jp = jm.init(jax.random.PRNGKey(17))
    m = Model(cfg, device="cpu")
    p = params_from_jax(jax.device_get(jp))
    ps, nb, lens = 8, 4, [9, 0, 14]
    P = len(lens) * nb
    bt = np.arange(P, dtype=np.int32)[::-1].copy().reshape(len(lens), nb)
    js = jm.init_paged_state(len(lens), P, ps)
    ts = m.init_paged_state(len(lens), P, ps)
    for b, L in enumerate(lens):
        if not L:
            continue
        toks = np.random.default_rng(18 + b).integers(0, cfg.vocab, (1, L))
        jb, tb = _batches(cfg, toks, seed=b)
        _, jc = jm.prefill(jp, jb)
        js = jm.write_prefill_paged(js, jc, jnp.int32(b), jnp.asarray(bt[b]),
                                    L, ps)
        _, tc = m.prefill(p, tb)
        ts = m.write_prefill_paged(ts, tc, b, torch.from_numpy(bt[b]), L, ps)
    pos = np.asarray([9, -1, 14], np.int32)
    tok = np.asarray([[3], [0], [5]], np.int32)
    for _ in range(3):
        want, js = jm.decode_paged(jp, js, jnp.asarray(tok),
                                   jnp.asarray(pos), jnp.asarray(bt))
        got, ts = m.decode_paged(p, ts, torch.from_numpy(tok).long(),
                                 torch.from_numpy(pos), torch.from_numpy(bt))
        _close(got[:, :cfg.vocab], np.asarray(want)[:, :cfg.vocab])
        tok = np.argmax(np.asarray(want)[:, :cfg.vocab], -1)[:, None].astype(
            np.int32)
        pos = np.where(pos >= 0, pos + 1, pos).astype(np.int32)
    bridged = state_rows_from_jax(jax.device_get(js), cfg)
    for li, rows in enumerate(ts["rows"]):
        for kk in ("k", "v"):
            _close(rows["cross"][kk], bridged["rows"][li]["cross"][kk])
    # one slot's rows: the cross K/V of every layer, in the reference's
    # leaf order (k, then v, stacked over the scanned layers)
    leaves = m.read_state_row(ts, 2)
    want_leaves = jm.read_state_row(js, 2)
    assert len(leaves) == len(want_leaves) == 2
    for got_leaf, want_leaf in zip(leaves, want_leaves):
        _close(got_leaf, want_leaf)
    assert sum(t.numel() * t.element_size() for t in leaves) == \
        m.state_row_bytes() > 0


def _writable_logits(decode_fn):
    """The reference engine writes newcomers' prefill logits into the
    host copy of its decode logits, which jax 0.9 returns read-only:
    hand it a writable copy (the numbers are unchanged)."""
    def run(*args):
        logits, state = decode_fn(*args)
        return np.array(logits), state
    return run


PLENS = [13, 9, 17]


def _submit(engine, vocab, temps=(0.0, 0.0, 0.0), budgets=(6, 4, 5)):
    rng = np.random.default_rng(1)
    return [engine.submit(rng.integers(0, vocab, (n,)).astype(np.int32),
                          max_new_tokens=b, temperature=t)
            for n, t, b in zip(PLENS, temps, budgets)]


def _engine_ids(engine, params, **kw):
    rids = _submit(engine, engine.cfg.vocab, **kw)
    engine.run_round(params)
    return [engine.completed[r].out_tokens for r in rids]


def _model_ids(jm, jp, cfg, patches, budgets=(6, 4, 5)):
    """Greedy ids of each request through the reference's own
    ``Model.prefill`` and ``Model.decode`` (contiguous cache, decode
    from ``n_img + plen``), request j with slot j's patches."""
    rng = np.random.default_rng(1)
    out = []
    for j, (n, budget) in enumerate(zip(PLENS, budgets)):
        toks = rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
        lg, c = jm.prefill(jp, {"tokens": jnp.asarray(toks[None]),
                                "patches": jnp.asarray(patches[j:j + 1])},
                           capacity=64)
        ids, pos = [], cfg.frontend.n_tokens + n
        for _ in range(budget):
            ids.append(int(np.argmax(np.asarray(lg)[0, :cfg.vocab])))
            lg, c = jm.decode(jp, c, jnp.asarray([[ids[-1]]], jnp.int32),
                              jnp.int32(pos))
            pos += 1
        out.append(ids)
    return out


@pytest.fixture(scope="module")
def vlm_run():
    """The reduced VLM through the reference engine, the reference's
    Model prefill/decode and the port's engine: three requests in three
    slots (request j in slot j, with slot j's patches), greedy."""
    jcfg, cfg = _cfgs(VLM)
    jm = jax_build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(11))
    patches = _stub(cfg, 3)
    jeng = JaxServeEngine(jcfg, jm, 3, 64, page_size=8,
                          extra_batch={"patches": jnp.asarray(patches)},
                          decode_wrap=_writable_logits)
    ref_engine = _engine_ids(jeng, jp)
    model_ids = _model_ids(_jit(jm), jp, cfg, patches)
    m = Model(cfg, device="cpu")
    eng = ServeEngine(cfg, m, 3, 64, page_size=8,
                      extra_batch={"patches": patches}, state_paging=True)
    port = _engine_ids(eng, params_from_jax(jax.device_get(jp)))
    return jeng, ref_engine, model_ids, eng, port


def test_reference_vlm_engine_fault(vlm_run):
    """Pins the reference engine's VLM fault: its first token of each
    request comes from a right prefill, its later ones from pages that
    miss the prompt's last ``n_img`` rows and decode positions ``n_img``
    short, so they differ from its own Model's; it leased fewer pages
    than the slots' sequences span."""
    jeng, ref_engine, model_ids, eng, _ = vlm_run
    assert [ids[0] for ids in ref_engine] == [ids[0] for ids in model_ids]
    assert ref_engine != model_ids
    assert jeng.stats.pages_leased < eng.stats.pages_leased


def test_vlm_engine_ids_follow_the_reference_model(vlm_run):
    """The port's VLM engine leases and writes ``n_img + plen`` rows a
    slot and decodes from there: its ids equal the reference Model's."""
    _, _, model_ids, eng, port = vlm_run
    assert port == model_ids
    s = eng.stats
    assert s.full_prefills == 0 and s.completed == 3
    assert s.pages_leased == s.pages_freed > 0
    assert s.prefill_chunks == 0


def test_whisper_engine_ids_match_reference():
    """Monolithic whisper serving, mixed temperatures, batch 2 over three
    requests (a slot admitted mid-decode reads its own cross rows): ids
    equal the reference engine's; the cross rows lease state pages."""
    jcfg, cfg = _cfgs(ASR)
    jm = jax_build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(19))
    frames = _stub(cfg, 2, seed=20)
    temps = (0.0, 0.9, 0.0)
    jeng = JaxServeEngine(jcfg, jm, 2, 64, page_size=8, seed=3,
                          extra_batch={"frames": jnp.asarray(frames)},
                          decode_wrap=_writable_logits)
    want = _engine_ids(jeng, jp, temps=temps)
    m = Model(cfg, device="cpu")
    eng = ServeEngine(cfg, m, 2, 64, page_size=8, seed=3,
                      extra_batch={"frames": frames}, state_paging=True)
    assert _engine_ids(eng, params_from_jax(jax.device_get(jp)),
                       temps=temps) == want
    s = eng.stats
    assert s.full_prefills == 0 and s.completed == 3
    assert s.pages_leased == s.pages_freed > 0
    assert s.state_pages_leased == s.state_pages_freed > 0


def test_chunked_mode_refused():
    """The VLM and the enc-dec prefill monolithically, as in the
    reference: the chunked entry point raises, an engine given
    ``chunk_tokens`` with frontend inputs stays monolithic, and the
    serve entry point rejects ``--chunk-tokens`` with a usage error."""
    for arch in (VLM, ASR):
        cfg = get_config(arch, reduced=True)
        m = Model(cfg, device="cpu")
        p = m.init(torch.Generator().manual_seed(0))
        st = m.init_paged_state(1, 4, 8)
        with pytest.raises(NotImplementedError, match="monolithically"):
            m.prefill_chunk_paged(p, st, torch.zeros((1, 4), dtype=torch.long),
                                  0, torch.arange(4, dtype=torch.int32), 0)
        key = "patches" if arch == VLM else "frames"
        eng = ServeEngine(cfg, m, 2, 64, page_size=8, chunk_tokens=8,
                          extra_batch={key: _stub(cfg, 2)})
        assert not eng._chunked
        with pytest.raises(SystemExit) as exc:
            serve_cli.main(["--device", "cpu", "--arch", arch,
                            "--chunk-tokens", "8"])
        assert exc.value.code == 2


def test_share_prefix_refused_for_whisper():
    """A shared prefix carries KV pages, not a slot's cross rows: the
    engine refuses prefix sharing for whisper by the rule it has for
    every family with state rows."""
    cfg = get_config(ASR, reduced=True)
    m = Model(cfg, device="cpu")
    assert m.state_row_bytes() > 0
    with pytest.raises(NotImplementedError, match="prefix sharing"):
        ServeEngine(cfg, m, 2, 64, page_size=8, chunk_tokens=8,
                    share_prefix=True, extra_batch={"frames": _stub(cfg, 2)})


@pytest.mark.parametrize("arch,key,shape", [
    (ASR, "frames", lambda fe: (2, fe.n_tokens - 1, fe.d_in)),
    (ASR, "frames", lambda fe: (2, fe.n_tokens + 3, fe.d_in)),
    (ASR, "frames", lambda fe: (1, fe.n_tokens, fe.d_in)),
    (VLM, "patches", lambda fe: (2, fe.n_tokens, fe.d_in + 1)),
])
def test_frontend_input_of_wrong_shape_refused(arch, key, shape):
    """A slot's cross rows and patch prefix are leased at the config's
    frontend length: the engine refuses frontend inputs of another
    length or width, or with fewer rows than slots."""
    cfg = get_config(arch, reduced=True)
    m = Model(cfg, device="cpu")
    bad = np.zeros(shape(cfg.frontend), np.float32)
    with pytest.raises(ValueError, match=key):
        ServeEngine(cfg, m, 2, 64, page_size=8, extra_batch={key: bad})
