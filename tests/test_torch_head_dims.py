"""The head dims of the repository's configurations beyond the served
ones: phi3-mini's hd 96 (32/32 heads) and kimi-k2's hd 112 (GQA 64/8).

Flash attention and the three decode-attention ops take them on the
card (the kernels' head-dim sets) and, on CPU tensors, hold their plain
versions against the reference's Pallas kernels (interpret mode on the
CPU, as tests/test_kernels.py runs them) at the reference's tolerances:
fp32 2e-5, bf16 3e-2. Heads are cut to 8/8 and 8/1 (G 8) to keep the
interpreted kernels small; the head dims are the configurations' own.

The split-walk core's tile arithmetic (``Shape<>`` in
``csrc/decode_core.cuh``) is mirrored in Python and checked at every
head dim the kernels take: whole rows a tile, a row's lanes dividing a
warp, the lanes past hd holding no dims, and the merge fitting the
tile ring.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.decode_attention.ops import (
    decode_attention_op as jax_decode, fused_decode_step_op as jax_fused)
from repro.kernels.flash_attention.ops import flash_attention_op as jax_flash
from repro_torch.kernels import common
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.ops import (decode_attention_op,
                                                      fused_decode_step_op)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import flash_attention_op

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
#: (hd, Hq, Hkv): phi3-mini's hd with MHA, kimi-k2's with a group of 8
SHAPES = [(96, 8, 8), (112, 8, 1)]


def _pair(x, dtype):
    return (jnp.asarray(x, jnp.dtype(dtype)),
            torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch,
                                                                  dtype)))


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_configs_need_these_head_dims():
    phi3 = jax_get_config("phi3-mini-3.8b")
    kimi = jax_get_config("kimi-k2-1t-a32b")
    assert phi3.d_model // phi3.n_heads == 96
    assert kimi.d_head == 112 and kimi.n_heads // kimi.n_kv_heads == 8
    for hd in (96, 112):
        assert hd in flash_ops.HEAD_DIMS and hd in dec_ops.HEAD_DIMS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window", [(1, 0), (65, 0), (65, 16)])
@pytest.mark.parametrize("hd,Hq,Hkv", SHAPES)
def test_flash_matches_pallas(hd, Hq, Hkv, S, window, dtype):
    rng = np.random.default_rng(hd + S + window)
    q, tq = _pair(rng.standard_normal((1, S, Hq, hd), np.float32), dtype)
    k, tk = _pair(rng.standard_normal((1, S, Hkv, hd), np.float32), dtype)
    v, tv = _pair(rng.standard_normal((1, S, Hkv, hd), np.float32), dtype)
    want = jax_flash(q, k, v, causal=True, window=window)
    got = flash_attention_op(tq, tk, tv, causal=True, window=window)
    assert got.shape == (1, S, Hq, hd) and got.dtype == tq.dtype
    _close(got, want, dtype)


def _paged(seed, Hq, Hkv, hd, lens, ps=8, nb=4):
    rng = np.random.default_rng(seed)
    B = len(lens)
    P = B * nb + 2
    rn = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    arrs = {"q": rn(B, 1, Hq, hd), "kn": rn(B, 1, Hkv, hd),
            "vn": rn(B, 1, Hkv, hd), "kp": rn(P, ps, Hkv, hd),
            "vp": rn(P, ps, Hkv, hd)}
    bt = rng.permutation(P)[:B * nb].reshape(B, nb).astype(np.int32)
    return arrs, bt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("hd,Hq,Hkv", SHAPES)
def test_fused_and_paged_decode_match_pallas(hd, Hq, Hkv, window, dtype):
    """A permuted table, a dead slot, a partial last page, a full table."""
    arrs, bt, lens = _paged(hd + window, Hq, Hkv, hd, [14, 0, 32])
    j = {k: _pair(v, dtype) for k, v in arrs.items()}
    tl, tb = torch.from_numpy(lens), torch.from_numpy(bt)
    want = jax_fused(j["q"][0], j["kn"][0], j["vn"][0], j["kp"][0],
                     j["vp"][0], jnp.asarray(lens), jnp.asarray(bt),
                     window=window)
    got = fused_decode_step_op(j["q"][1], j["kn"][1], j["vn"][1],
                               j["kp"][1], j["vp"][1], tl, tb,
                               window=window)
    assert got.shape == (3, 1, Hq, hd) and bool((got[1] == 0).all())
    _close(got, want, dtype)
    want = jax_decode(j["q"][0], j["kp"][0], j["vp"][0], jnp.asarray(lens),
                      window=window, block_tables=jnp.asarray(bt))
    got = decode_attention_op(j["q"][1], j["kp"][1], j["vp"][1], tl,
                              window=window, block_tables=tb)
    assert bool((got[1] == 0).all())
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos,window", [(100, 0), (300, 0), (300, 64)])
@pytest.mark.parametrize("hd,Hq,Hkv", SHAPES)
def test_ring_decode_matches_pallas(hd, Hq, Hkv, pos, window, dtype):
    """Partly filled, wrapped, and a window over a wrapped ring."""
    rng = np.random.default_rng(hd + pos + window)
    C = 256
    q, tq = _pair(rng.standard_normal((2, 1, Hq, hd), np.float32), dtype)
    k, tk = _pair(rng.standard_normal((2, C, Hkv, hd), np.float32), dtype)
    v, tv = _pair(rng.standard_normal((2, C, Hkv, hd), np.float32), dtype)
    want = jax_decode(q, k, v, pos, window=window)
    got = decode_attention_op(tq, tk, tv, pos, window=window)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    _close(got, want, dtype)


# ---------------------------------------------------------------------------
# the split-walk core's tile arithmetic, mirrored
# ---------------------------------------------------------------------------

TILE_BYTES, NSTAGE, GPC_MAX = 8192, 3, 4


def _pow2_ceil(x):
    p = 1
    while p < x:
        p <<= 1
    return p


def core_shape(es, hd, nt):
    """``dc::Shape<T, HD, NT>`` of decode_core.cuh for an element of
    ``es`` bytes."""
    vec = 16 // es
    hp = _pow2_ceil(hd)
    dpl = max(vec, hp // 32)
    lpt = hp // dpl
    nch = nt // 32 * (32 // lpt)
    tr = TILE_BYTES // (hd * es) // nch * nch
    vpr = hd // vec
    return {"hp": hp, "dpl": dpl, "lpt": lpt, "live": hd // dpl,
            "nch": nch, "tr": tr, "rc": tr // nch, "vpr": vpr,
            "vpt": -(-tr * vpr // nt)}


def test_core_source_matches_the_mirror():
    src = (common.CSRC / "decode_core.cuh").read_text()
    for text in ("constexpr int TILE_BYTES = 8192;",
                 "constexpr int NSTAGE = 3;",
                 "static constexpr int HP = pow2_ceil(HD);",
                 "static constexpr int LIVE = HD / DPL;",
                 "TR = TILE_BYTES / (HD * ES) / NCH * NCH;",
                 "const bool live = li < S::LIVE;"):
        assert text in src


@pytest.mark.parametrize("nt", [128, 256])
@pytest.mark.parametrize("es", [2, 4])
@pytest.mark.parametrize("hd", dec_ops.HEAD_DIMS)
def test_core_shape_whole_rows_and_warp_lanes(hd, es, nt):
    s = core_shape(es, hd, nt)
    assert hd % s["dpl"] == 0 and 32 % s["lpt"] == 0
    assert s["rc"] >= 1 and s["nch"] >= GPC_MAX
    # a tile holds whole rows, a multiple of the channels, in its bytes
    assert s["tr"] % s["nch"] == 0 and s["tr"] * hd * es <= TILE_BYTES
    # the live lanes hold exactly hd dims, each a whole 16-byte vector
    assert s["live"] * s["dpl"] == hd and s["live"] <= s["lpt"]
    assert s["dpl"] % (16 // es) == 0
    # the copies of a tile cover every vector of it
    assert s["vpt"] * nt >= s["tr"] * s["vpr"]
    if hd == s["hp"]:                    # powers of two: as before
        assert s["live"] == s["lpt"]
        assert s["tr"] == TILE_BYTES // (hd * es)
    # the merge: [RP][G][HD] partials + m and l, over the tile ring
    for G in range(1, 17):
        gpc = 1 if G == 1 else GPC_MAX
        if (nt == 128) != (gpc == 1):
            continue
        hg = 1
        while hg * gpc < G:
            hg *= 2
        rp = s["nch"] // hg
        assert rp >= 1
        floats = rp * G * hd + 2 * rp * G + 2 * G
        assert floats * 4 <= NSTAGE * 2 * TILE_BYTES


@pytest.mark.parametrize("hd", [96, 112])
def test_core_shape_at_the_new_head_dims(hd):
    """bf16: a row is 16 lanes of 8 dims (12 or 14 live), 40 or 32 rows
    a tile; fp32: 32 lanes of 4 dims (24 or 28 live), 20 or 16 rows."""
    b = core_shape(2, hd, 128)
    assert (b["lpt"], b["live"]) == (16, hd // 8)
    assert b["tr"] == (40 if hd == 96 else 32)
    f = core_shape(4, hd, 128)
    assert (f["lpt"], f["live"]) == (32, hd // 4)
    assert f["tr"] == (20 if hd == 96 else 16)
    assert core_shape(4, hd, 256)["tr"] == 16
