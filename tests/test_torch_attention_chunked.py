"""The attention core's memory-saving paths for long KV rows
(``_chunked_full``, ``_banded_swa``) against the reference's, on the
same numpy inputs, with ``_DIRECT_MAX`` and the chunk sizes patched
small in both modules (so a 64-key row takes the long paths): causal,
non-causal, windowed, GQA, queries starting above position 0, fewer
queries than keys; fp32 within 1e-5, bf16 within 2e-2. The causal
cases also agree with the dense formula. Then a chunked prefill
through both packages' ``ServeEngine`` on reduced qwen (the chunked
path) and reduced recurrentgemma (the banded path) in fp32: the same
greedy ids."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jax_attn
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import attention as attn
from repro_torch.serving import ServeEngine

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DIRECT_MAX, CHUNK = 32, 16


@pytest.fixture(scope="module")
def small_chunks():
    """Both modules' thresholds patched small for the tests that ask
    (once for the module); JAX's trace caches cleared so that no trace
    taken under the real constants is reused, nor one taken here later."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_attn, attn):
            mp.setattr(mod, "_DIRECT_MAX", DIRECT_MAX)
            mp.setattr(mod, "_CHUNK_Q", CHUNK)
            mp.setattr(mod, "_CHUNK_K", CHUNK)
        jax.clear_caches()
        yield
    jax.clear_caches()


#: (B, Sq, Sk, Hq, Hkv, hd, causal, window, first query position)
CASES = {
    "causal": (1, 64, 64, 4, 4, 16, True, 0, 0),
    "non-causal": (2, 48, 64, 4, 4, 16, False, 0, 0),
    "windowed": (1, 64, 64, 4, 4, 16, True, 24, 0),
    "gqa": (1, 64, 64, 8, 2, 16, True, 0, 0),
    "q-above-0": (1, 16, 64, 4, 2, 16, True, 0, 40),
    "q-above-0-windowed": (1, 16, 80, 4, 2, 16, True, 20, 48),
    "sq-below-sk": (1, 32, 96, 6, 3, 8, True, 0, 64),
    "non-causal-windowed": (1, 32, 64, 4, 4, 16, False, 24, 0),
}


def _inputs(case, seed=0):
    B, Sq, Sk, Hq, Hkv, hd, _, _, q0 = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, hd), np.float32)
    k = rng.standard_normal((B, Sk, Hkv, hd), np.float32)
    v = rng.standard_normal((B, Sk, Hkv, hd), np.float32)
    return q, k, v, np.arange(q0, q0 + Sq), np.arange(Sk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_long_paths_match_reference(name, dtype, small_chunks):
    case = CASES[name]
    causal, window = case[6], case[7]
    q, k, v, qp, kp = _inputs(case)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_attn.attention_core(
        *(jnp.asarray(a).astype(jd) for a in (q, k, v)), causal=causal,
        window=window, q_pos=jnp.asarray(qp), k_pos=jnp.asarray(kp))
    attn.ROUTES.clear()
    got = attn.attention_core(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)),
        q_pos=torch.from_numpy(qp), k_pos=torch.from_numpy(kp),
        window=window, causal=causal)
    route = "banded" if 0 < window < k.shape[1] else "chunked"
    assert dict(attn.ROUTES) == {route: 1}
    assert got.dtype == td and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=0)
    if causal:
        dense = attn._direct(
            attn._grouped(torch.from_numpy(q), q.shape[2]),
            torch.from_numpy(k).repeat_interleave(q.shape[2] // k.shape[2],
                                                  dim=2),
            torch.from_numpy(v).repeat_interleave(q.shape[2] // k.shape[2],
                                                  dim=2),
            attn._mask_bias(torch.from_numpy(qp), torch.from_numpy(kp),
                            True, window), 1.0 / np.sqrt(q.shape[-1]))
        np.testing.assert_allclose(
            got.float().numpy(), dense.reshape(q.shape).numpy(),
            atol=TOL[dtype], rtol=0)


def test_short_rows_stay_dense(small_chunks):
    case = (1, 8, 32, 4, 4, 16, True, 0, 24)
    q, k, v, qp, kp = _inputs(case)
    attn.ROUTES.clear()
    attn.attention_core(*(torch.from_numpy(a) for a in (q, k, v)),
                        q_pos=torch.from_numpy(qp), k_pos=torch.from_numpy(kp))
    assert dict(attn.ROUTES) == {"direct": 1}


def test_divisibility_is_checked(monkeypatch):
    for name, value in (("_DIRECT_MAX", 2048), ("_CHUNK_Q", 512),
                        ("_CHUNK_K", 512)):      # the real thresholds
        monkeypatch.setattr(attn, name, value)
    q = torch.zeros(1, 48, 2, 8)
    kv = torch.zeros(1, 2560, 2, 8)
    with pytest.raises(AssertionError):   # 2600 keys: no whole 512-key chunks
        attn.attention_core(q, torch.zeros(1, 2600, 2, 8),
                            torch.zeros(1, 2600, 2, 8),
                            q_pos=torch.arange(48), k_pos=torch.arange(2600))
    attn.attention_core(q, kv, kv, q_pos=torch.arange(48),
                        k_pos=torch.arange(2560))
    with pytest.raises(ValueError, match="chunk_tokens"):
        attn.check_chunk_prefill(600, 4096, [0])
    with pytest.raises(ValueError, match="multiple of 512"):
        attn.check_chunk_prefill(512, 4112, [0])
    attn.check_chunk_prefill(512, 4112, [2048])  # banded rows: any length
    attn.check_chunk_prefill(4096, 2048, [0])    # dense: no condition


def _writable_logits(decode_fn):
    """The reference engine writes into its host copy of the decode
    logits, which jax 0.9 returns read-only: hand it a writable copy."""
    def run(*args):
        logits, state = decode_fn(*args)
        return np.array(logits), state
    return run


@pytest.mark.parametrize("arch,route", [("qwen1.5-0.5b", "chunked"),
                                        ("recurrentgemma-2b", "banded")])
def test_chunked_prefill_engine_ids_match_reference(arch, route,
                                                    small_chunks):
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(2))
    m = Model(cfg, device="cpu")
    p = params_from_jax(jax.device_get(jp))
    kw = dict(page_size=8, chunk_tokens=8, seed=1)
    lens = (21, 45)                  # chunks of 8 and a last one of 5
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, (n,)) for n in lens]

    def serve(eng, params):
        rids = [eng.submit(pr, max_new_tokens=6) for pr in prompts]
        eng.run_round(params)
        return [eng.completed[r].out_tokens for r in rids]

    want = serve(JaxServeEngine(jcfg, jm, 2, 64, decode_wrap=_writable_logits,
                                state_paging=True, **kw), jp)
    attn.ROUTES.clear()
    eng = ServeEngine(cfg, m, 2, 64, state_paging=True, **kw)
    got = serve(eng, p)
    assert got == want
    assert eng.stats.full_prefills == 0
    assert eng.stats.prefill_chunks == sum(-(-n // 8) for n in lens)
    assert set(attn.ROUTES) == {route}
