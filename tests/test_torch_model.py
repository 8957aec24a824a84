"""The port's ``Model`` against the reference's JAX ``Model``
(``use_pallas=False``, the XLA path that tests/test_kernel_integration.py
pins to the Pallas one) on reduced ``qwen1.5-0.5b`` with the same
weights, carried across by ``repro_torch.bridge``.

Tolerances: logits at 1e-4 with fp32 compute and at 5e-2 with the
config's bf16 compute (the value in test_kernel_integration.py);
chunked-vs-one-shot prefill at 1e-3 (test_chunked_prefill.py); sampled
token ids exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model

torch.set_num_threads(2)

PS, NB = 8, 4
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    cd = request.param
    jcfg = dataclasses.replace(jax_get_config("qwen1.5-0.5b", reduced=True),
                               compute_dtype=cd)
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b", reduced=True),
                              compute_dtype=cd)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(cfg, device="cpu")
    p = params_from_jax(jax.device_get(jp))
    return cd, cfg, jm, jp, m, p


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _prompt(n, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (n,)).astype(
        np.int32)


def test_prefill_logits(pair):
    cd, cfg, jm, jp, m, p = pair
    toks = np.stack([_prompt(21, 1, cfg.vocab), _prompt(21, 2, cfg.vocab)])
    want, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    got, caches = m.prefill(p, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, cfg.padded_vocab)
    _close(got[:, :cfg.vocab], np.asarray(want)[:, :cfg.vocab], TOL[cd])
    # padded vocab columns are masked exactly as the reference masks them
    assert bool((got[:, cfg.vocab:] < -1e29).all())
    _close(caches["k"][:, :, :21],
           np.asarray(jc[0][0]["mixer"]["k"])[:, :, :21], TOL[cd])


def _paged_pair(cd, cfg, jm, jp, m, p, lens):
    """Both models' paged states after monolithic prefill of each live
    slot (lens[b] == 0 → dead slot) through a permuted block table."""
    P = len(lens) * NB + 2
    bt = np.random.default_rng(5).permutation(P)[:len(lens) * NB].reshape(
        len(lens), NB).astype(np.int32)
    js = jm.init_paged_state(len(lens), P, PS)
    ts = m.init_paged_state(P, PS)
    for b, L in enumerate(lens):
        if not L:
            continue
        toks = _prompt(L, 10 + b, cfg.vocab)[None]
        _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
        js = jm.write_prefill_paged(js, jc, jnp.int32(b), jnp.asarray(bt[b]),
                                    L, PS)
        _, tc = m.prefill(p, {"tokens": torch.from_numpy(toks).long()})
        ts = m.write_prefill_paged(ts, tc, torch.from_numpy(bt[b]), L, PS)
    return bt, js, ts


def test_decode_paged_permuted_table_dead_slot(pair):
    """Two decode steps over a permuted block table with a dead middle
    slot: logits and every K/V pool row agree; the dead slot writes
    nothing."""
    cd, cfg, jm, jp, m, p = pair
    lens = [13, 0, 21]
    bt, js, ts = _paged_pair(cd, cfg, jm, jp, m, p, lens)
    pos = np.asarray([13, -1, 21], np.int32)
    tok = np.asarray([[3], [0], [7]], np.int32)
    for _ in range(2):
        want, js = jm.decode_paged(jp, js, jnp.asarray(tok),
                                   jnp.asarray(pos), jnp.asarray(bt))
        got, ts = m.decode_paged(p, ts, torch.from_numpy(tok).long(),
                                 torch.from_numpy(pos),
                                 torch.from_numpy(bt))
        _close(got[:, :cfg.vocab], np.asarray(want)[:, :cfg.vocab], TOL[cd])
        tok = np.argmax(np.asarray(want)[:, :cfg.vocab], -1)[:, None].astype(
            np.int32)
        pos = np.where(pos >= 0, pos + 1, pos).astype(np.int32)
    for kk in ("k", "v"):
        _close(ts[kk], np.asarray(js[0][0]["mixer"][kk]), TOL[cd])


def test_chunked_prefill_matches_one_shot(pair):
    """Chunked prefill through a permuted block table: the port agrees
    with the reference chunk for chunk, and its last chunk's logits
    agree with its own one-shot prefill ≤ 1e-3."""
    cd, cfg, jm, jp, m, p = pair
    plen, chunk = 21, 8
    block_row = np.asarray([2, 0, 3, 1], np.int32)
    prompt = _prompt(plen, 3, cfg.vocab)
    js = jm.init_paged_state(1, NB, PS)
    ts = m.init_paged_state(NB, PS)
    for start in range(0, plen, chunk):
        t = prompt[None, start:start + chunk]
        want, js = jm.prefill_chunk_paged(jp, js, jnp.asarray(t),
                                          jnp.int32(0),
                                          jnp.asarray(block_row),
                                          jnp.int32(start))
        got, ts = m.prefill_chunk_paged(p, ts, torch.from_numpy(t).long(),
                                        torch.from_numpy(block_row), start)
        _close(got[:, :cfg.vocab], np.asarray(want)[:, :cfg.vocab], TOL[cd])
    one, _ = m.prefill(p, {"tokens": torch.from_numpy(prompt[None]).long()})
    tol = 1e-3 if cd == "float32" else TOL[cd]
    _close(got[:, :cfg.vocab], one[:, :cfg.vocab].float().numpy(), tol)


@pytest.mark.parametrize("temps", [(0.0, 0.0, 0.0), (0.7, 0.0, 1.3)])
def test_decode_paged_fused_tokens(pair, temps):
    """Fused decode + on-device sampling: token ids equal the
    reference's, greedy and — with the reference's Gumbel draws
    injected — at T > 0."""
    cd, cfg, jm, jp, m, p = pair
    lens = [13, 0, 21]
    bt, js, ts = _paged_pair(cd, cfg, jm, jp, m, p, lens)
    pos = np.asarray([13, -1, 21], np.int32)
    tok = np.asarray([[3], [0], [7]], np.int32)
    temps = np.asarray(temps, np.float32)
    for step in range(3):
        want, js = jm.decode_paged_fused(jp, js, jnp.asarray(tok),
                                         jnp.asarray(pos), jnp.asarray(bt),
                                         jnp.asarray(temps), jnp.int32(step))
        key = jax.random.fold_in(jax.random.PRNGKey(0x5e), step)
        noise = np.array(jax.random.gumbel(
            key, (len(lens), cfg.padded_vocab), jnp.float32))
        got, ts = m.decode_paged_fused(
            p, ts, torch.from_numpy(tok).long(), torch.from_numpy(pos),
            torch.from_numpy(bt), torch.from_numpy(temps), step,
            noise=torch.from_numpy(noise))
        live = pos >= 0
        np.testing.assert_array_equal(got.numpy()[live],
                                      np.asarray(want)[live])
        tok = np.asarray(want)[:, None].astype(np.int32)
        pos = np.where(live, pos + 1, pos).astype(np.int32)


def test_kv_page_bytes_matches(pair):
    cd, cfg, jm, jp, m, p = pair
    assert m.kv_page_bytes(16) == jm.kv_page_bytes(16)


def test_compute_params_keeps_numbers(pair):
    """Casting the product weights once at load gives the same logits
    as casting them per call (the reference's ``.astype``)."""
    cd, cfg, jm, jp, m, p = pair
    toks = torch.from_numpy(_prompt(9, 4, cfg.vocab)[None]).long()
    a, _ = m.prefill(p, {"tokens": toks})
    b, _ = m.prefill(m.compute_params(p), {"tokens": toks})
    assert torch.equal(a, b)
