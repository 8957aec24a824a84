"""Plain PyTorch versions of the port's kernels against the reference's
Pallas kernels (interpret mode on the CPU, as tests/test_kernels.py runs
them), on the same numpy inputs.

Tolerances are the reference's own: fp32 at 2e-5 (online-softmax
reassociation only), bf16 at 3e-2 (one bf16 rounding of the output).
Sampled token ids must match exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import (
    fused_decode_step_op as jax_fused_decode, sample_tokens_op as jax_sample)
from repro.kernels.flash_attention.ops import (
    flash_attention_op as jax_flash)
from repro_torch.kernels.decode_attention.ops import (fused_decode_step_op,
                                                      sample_tokens_op)
from repro_torch.kernels.flash_attention.ops import flash_attention_op

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _pair(x, dtype):
    """One numpy array → (jax array, torch tensor) with identical bits."""
    return (jnp.asarray(x, jnp.dtype(dtype)),
            torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch,
                                                                  dtype)))


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# flash attention (prefill)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [96, 100])
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("window", [0, 32])
def test_flash_matches_pallas(window, G, S, dtype):
    """Causal GQA with and without a window, at lengths that are not
    block multiples (the kernel masks the ragged edge, the reference
    pads)."""
    rng = np.random.default_rng(100 * G + S + window)
    B, Hkv, hd = 2, 8 // G if G < 8 else 1, 32
    Hq = Hkv * G
    q, tq = _pair(rng.standard_normal((B, S, Hq, hd), np.float32), dtype)
    k, tk = _pair(rng.standard_normal((B, S, Hkv, hd), np.float32), dtype)
    v, tv = _pair(rng.standard_normal((B, S, Hkv, hd), np.float32), dtype)
    want = jax_flash(q, k, v, causal=True, window=window)
    got = flash_attention_op(tq, tk, tv, causal=True, window=window)
    assert got.shape == (B, S, Hq, hd) and got.dtype == tq.dtype
    _close(got, want, dtype)


# ---------------------------------------------------------------------------
# fused paged decode attention
# ---------------------------------------------------------------------------

B, HQ, HKV, HD, PS, NB = 3, 4, 2, 32, 8, 4
P = B * NB + 2


def _decode_inputs(seed, lens):
    rng = np.random.default_rng(seed)
    arrs = {
        "q": rng.standard_normal((B, 1, HQ, HD), np.float32),
        "kn": rng.standard_normal((B, 1, HKV, HD), np.float32),
        "vn": rng.standard_normal((B, 1, HKV, HD), np.float32),
        "kp": rng.standard_normal((P, PS, HKV, HD), np.float32),
        "vp": rng.standard_normal((P, PS, HKV, HD), np.float32),
    }
    perm = rng.permutation(P)[:B * NB]
    bt = perm.reshape(B, NB).astype(np.int32)        # permuted table
    return arrs, bt, np.asarray(lens, np.int32)


def _run_decode(arrs, bt, lens, dtype, window):
    j = {k: _pair(v, dtype) for k, v in arrs.items()}
    want = jax_fused_decode(j["q"][0], j["kn"][0], j["vn"][0], j["kp"][0],
                            j["vp"][0], jnp.asarray(lens), jnp.asarray(bt),
                            window=window)
    got = fused_decode_step_op(j["q"][1], j["kn"][1], j["vn"][1],
                               j["kp"][1], j["vp"][1],
                               torch.from_numpy(lens), torch.from_numpy(bt),
                               window=window)
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 6])
def test_fused_decode_matches_pallas(window, dtype):
    """Permuted block table, a dead slot (length 0 → zeros), a partial
    last page and a full table; lengths include the new token."""
    arrs, bt, lens = _decode_inputs(7, [14, 0, 32])
    got, want = _run_decode(arrs, bt, lens, dtype, window)
    assert got.shape == (B, 1, HQ, HD) and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)
    assert bool((got[1] == 0).all())                 # dead slot stays zero


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_decode_length_one_is_v_new(dtype):
    """Length 1: softmax over the new token alone returns v_new exactly,
    with every pool row poisoned with NaN (all of them are masked)."""
    arrs, bt, _ = _decode_inputs(3, [1, 1, 1])
    arrs["kp"][:] = np.nan
    arrs["vp"][:] = np.nan
    lens = np.ones((B,), np.int32)
    got, _ = _run_decode(arrs, bt, lens, dtype, 0)
    want = torch.from_numpy(arrs["vn"]).to(getattr(torch, dtype))
    want = want.repeat_interleave(HQ // HKV, dim=2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("window", [0, 6])
def test_fused_decode_nan_in_masked_rows_never_leaks(window):
    """Masked pool rows (past each slot's length, before its window,
    unused pages, the dead slot's pages) hold real NaN: the output must
    equal the reference's on the same pools with those rows zeroed.
    The reference kernel itself multiplies p = 0 into the masked rows, so
    it is run on the zeroed pools only."""
    lens = np.asarray([14, 0, 27], np.int32)
    arrs, bt, _ = _decode_inputs(11, lens)
    clean = {k: v.copy() for k, v in arrs.items()}
    for name in ("kp", "vp"):
        live = np.zeros((P, PS), bool)
        for b, L in enumerate(lens):
            lo = max(0, L - window) if window else 0
            for t in range(lo, max(L - 1, 0)):       # pool-resident rows
                live[bt[b, t // PS], t % PS] = True
        arrs[name][~live] = np.nan
        clean[name][~live] = 0.0
    got, _ = _run_decode(arrs, bt, lens, "float32", window)
    _, want = _run_decode(clean, bt, lens, "float32", window)
    assert torch.isfinite(got).all()
    _close(got, want, "float32")


# ---------------------------------------------------------------------------
# on-device sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V", [1000, 152064])
def test_sample_tokens_matches_pallas(V):
    """Greedy rows (T=0) and Gumbel rows (T>0) pick the same ids."""
    rng = np.random.default_rng(V)
    logits = (rng.standard_normal((4, V)) * 3.0).astype(np.float32)
    noise = rng.gumbel(size=(4, V)).astype(np.float32)
    temps = np.asarray([0.0, 0.8, 0.0, 1.5], np.float32)
    want = jax_sample(jnp.asarray(logits), jnp.asarray(temps),
                      jnp.asarray(noise))
    got = sample_tokens_op(torch.from_numpy(logits), torch.from_numpy(temps),
                           torch.from_numpy(noise))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("V", [4096, 152064])
def test_sample_tokens_tie_keeps_first(V):
    """Exact ties resolve to the lowest index, across 2048-wide vocab
    blocks too (→ 100) and inside one block (→ 2050)."""
    logits = np.zeros((2, V), np.float32)
    logits[0, [100, 3000]] = 5.0
    logits[1, [2050, 2051]] = 2.0
    zeros = np.zeros((2, V), np.float32)
    temps = np.zeros((2,), np.float32)
    want = np.asarray([100, 2050], np.int32)
    got = sample_tokens_op(torch.from_numpy(logits), torch.from_numpy(temps),
                           torch.from_numpy(zeros))
    np.testing.assert_array_equal(got.numpy(), want)
    ref = jax_sample(jnp.asarray(logits), jnp.asarray(temps),
                     jnp.asarray(zeros))
    np.testing.assert_array_equal(np.asarray(ref), want)


def test_wrappers_reject_mixed_devices():
    """A wrapper never picks a path by itself: tensors on a device with
    no kernel, or on several devices, raise."""
    x = torch.zeros((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError):
        flash_attention_op(x, x, x)
    lg = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        sample_tokens_op(lg, torch.zeros((2,), device="meta"), lg)


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
