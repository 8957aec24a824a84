"""The reduced ``recurrentgemma-2b`` and ``rwkv6-7b`` models in the port
against the reference's JAX ``Model`` (``use_pallas=False``) on the same
weights, carried across by ``repro_torch.bridge``: prefill logits, paged
decode through a permuted block table with a dead slot whose rows stay
untouched, and the paging sizes. Chunked prefill and the per-slot rows
are in tests/test_torch_recurrent_chunk.py, which uses the helpers here.

Tolerances: logits at 1e-4 with fp32 compute and 5e-2 with bf16
(tests/test_torch_model.py's values); chunked against one-shot prefill
at 1e-3; the paged decode, chunked prefill and per-slot rows run with
fp32 compute (bf16 rows differ from the reference's by rounding flips
of their inputs).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.bridge import params_from_jax, state_rows_to_numpy
from repro_torch.configs import get_config
from repro_torch.models import Model

torch.set_num_threads(2)

ARCHS = ["recurrentgemma-2b", "rwkv6-7b"]
PS, NB = 8, 4
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(tree):
    """A JAX parameter dict (leaves as numpy) → torch tensors."""
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return _t(jax.device_get(tree))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, np.float32),
        np.asarray(want, np.float32), atol=tol, rtol=tol)


def _prompt(n, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (n,)).astype(
        np.int32)


def _cfgs(arch, cd="float32", **kw):
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               compute_dtype=cd, **kw)
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype=cd, **kw)
    return jcfg, cfg


# ===========================================================================
# Models (reduced configs)
# ===========================================================================

@functools.lru_cache(maxsize=None)
def _build(arch, cd):
    jcfg, cfg = _cfgs(arch, cd)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return arch, cd, cfg, jm, jp, Model(cfg, device="cpu"), \
        params_from_jax(jax.device_get(jp))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """Both packages' reduced model, fp32 compute, same weights."""
    return _build(request.param, "float32")


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match(arch, cd):
    arch, cd, cfg, jm, jp, m, p = _build(arch, cd)
    toks = np.stack([_prompt(21, 1, cfg.vocab), _prompt(21, 2, cfg.vocab)])
    want, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    got, caches = m.prefill(p, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, cfg.padded_vocab)
    _close(got[:, :cfg.vocab], np.asarray(want)[:, :cfg.vocab], TOL[cd])
    assert ("k" in caches) == (arch == "recurrentgemma-2b")
    assert "rows" in caches


def _paged_pair(cfg, jm, jp, m, p, lens):
    """Both models' paged states after monolithic prefill of each live
    slot (lens[b] == 0 → dead slot) through a permuted block table."""
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
    return bt, js, ts


def _state_close(cfg, ts, js, tol):
    want = jax.tree_util.tree_leaves(jax.device_get(js))
    got = jax.tree_util.tree_leaves(state_rows_to_numpy(ts, cfg))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(np.asarray(a, np.float32) if a.dtype != np.uint16 else
               torch.from_numpy(a.view(np.int16)).view(torch.bfloat16),
               np.asarray(b, np.float32), tol)


def test_decode_paged_dead_slot_keeps_rows(pair):
    """Two decode steps over a permuted block table with a dead middle
    slot holding copies of slot 0's rows: logits and the whole paged
    state agree with the reference, and the dead slot's rows are left
    exactly as they were."""
    arch, cd, cfg, jm, jp, m, p = pair
    lens = [13, 0, 21]
    bt, js, ts = _paged_pair(cfg, jm, jp, m, p, lens)
    js = jm.write_state_row(js, jnp.int32(1), jm.read_state_row(js, 0))
    ts = m.write_state_row(ts, 1, m.read_state_row(ts, 0))
    dead = [leaf.clone() for leaf in m.read_state_row(ts, 1)]
    assert any(bool(leaf.any()) for leaf in dead)
    pos = np.asarray([13, -1, 21], np.int32)
    tok = np.asarray([[3], [0], [7]], np.int32)
    for _ in range(2):
        want, js = jm.decode_paged(jp, js, jnp.asarray(tok),
                                   jnp.asarray(pos), jnp.asarray(bt))
        got, ts = m.decode_paged(p, ts, torch.from_numpy(tok).long(),
                                 torch.from_numpy(pos),
                                 torch.from_numpy(bt))
        live = pos >= 0
        _close(got[live, :cfg.vocab], np.asarray(want)[live, :cfg.vocab],
               TOL[cd])
        tok = np.argmax(np.asarray(want)[:, :cfg.vocab], -1)[:, None].astype(
            np.int32)
        pos = np.where(live, pos + 1, pos).astype(np.int32)
    for before, after in zip(dead, m.read_state_row(ts, 1)):
        assert torch.equal(before, after)
    _state_close(cfg, ts, js, TOL[cd])


def test_paging_sizes_match(pair):
    arch, cd, cfg, jm, jp, m, p = pair
    assert m.state_row_bytes() == jm.state_row_bytes() > 0
    assert m.kv_page_bytes(16) == jm.kv_page_bytes(16)


def test_unported_paths_raise():
    _, cfg = _cfgs("rwkv6-7b")
    m = Model(cfg, device="cpu")                 # no rope, no attention: ok
    caches = m.init_cache(1, 8)                  # ring decode is ported
    assert "k" not in caches and len(caches["rows"]) == cfg.n_layers
    # attention with absolute positions is ported (whisper's decoder,
    # tests/test_torch_frontends.py): without rope the attention layers
    # see sinusoidal positions in the embeddings and no rotation
    qcfg = dataclasses.replace(get_config("qwen1.5-0.5b", reduced=True),
                               use_rope=False, compute_dtype="float32")
    qm = Model(qcfg, device="cpu")
    qp = qm.init(torch.Generator().manual_seed(0))
    toks = {"tokens": torch.arange(9)[None]}
    lg, qc = qm.prefill(qp, toks)
    roped, _ = Model(dataclasses.replace(qcfg, use_rope=True),
                     device="cpu").prefill(qp, toks)
    assert bool(torch.isfinite(lg).all()) and not torch.equal(lg, roped)
    # what no configuration uses stays refused
    for field, value in (("logit_softcap", 30.0), ("tie_embeddings", True)):
        with pytest.raises(NotImplementedError):
            Model(dataclasses.replace(qcfg, **{field: value}), device="cpu")
