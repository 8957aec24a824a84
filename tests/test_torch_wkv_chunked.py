"""The RWKV-6 WKV kernel's chunked schedule, as a plain PyTorch model.

``wkv_schedule`` below does, in fp32 tensors, what ``csrc/rwkv6_wkv.cu``
does per CTA: chunks of C = 16 tokens (``CHUNK``), the last zero-
filled past S (logw = 0, r = k = v = 0) and its rows past S dropped;
L as a cumulative log2 decay; the scores split into sub-blocks of 8
tokens, the off-diagonal pairs as products of three factors whose
exponents are all <= 0 and the diagonal pairs in log space; the state
columns in ``nv`` slices, each recomputing the scores. It is used by no
path: it holds the kernel's arithmetic where the CPU can run it.

It is held against the reference's Pallas kernel (interpret mode on the
CPU) and against the sequential ``rwkv6_wkv_ref`` at the reference's
WKV tolerance (atol = rtol = 2e-3: the summation order differs), at
S in {1, 31, 32, 33, 130} and K in {16, 32, 64, 128} (48, 80, 96 and 112
at ragged S); with decays of -50
mixed with ~-1e-3 inside one chunk it stays finite and within the same
tolerance, and a decay of -50 gives exact zeros.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.rwkv6_wkv.rwkv6_wkv import rwkv6_wkv as jax_wkv_kernel
from repro_torch.kernels import common
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref

torch.set_num_threads(2)

LOG2E = 1.4426950408889634
CHUNK = 16                      # tokens a chunk, at every K
SB = 8                          # tokens a sub-block
NT = 256                        # threads a CTA
SMEM_MAX = 227 * 1024           # dynamic shared memory a CTA may take


def wkv_schedule(r, k, v, logw, u, s0, chunk, nv=1):
    """(B,H,S,K) fp32 inputs → (o, s_final), by the kernel's schedule."""
    B, H, S, K = r.shape
    vs = K // nv
    C, nb = chunk, chunk // SB
    idx = torch.arange(C)
    blk = idx // SB
    m_row = (blk * SB - 1).clamp(min=0)      # the row before a block
    e_row = blk * SB + SB - 1                # a block's last row
    off = (blk[:, None] > blk[None, :])      # query block after key block
    diag = (blk[:, None] == blk[None, :]) & (idx[:, None] > idx[None, :])
    o = torch.zeros_like(r)
    s_fin = torch.empty_like(s0)
    for j0 in range(0, K, vs):               # one CTA a slice
        st = s0[..., j0:j0 + vs].clone()
        for t0 in range(0, S, C):
            n = min(C, S - t0)

            def tile(x, lo=0, hi=K):
                return F.pad(x[:, :, t0:t0 + n, lo:hi], (0, 0, 0, C - n))
            rc, kc, wc = tile(r), tile(k), tile(logw)
            vc = tile(v, j0, j0 + vs)
            L = torch.cumsum(wc * LOG2E, dim=2)
            Lp = F.pad(L[:, :, :-1], (0, 0, 1, 0))
            qi = rc * torch.exp2(Lp)
            qh = torch.where((blk > 0)[:, None],
                             rc * torch.exp2(Lp - L[:, :, m_row]), 0.0)
            kh = kc * torch.exp2(L[:, :, e_row] - L)
            kd = kc * torch.exp2(L[:, :, -1:] - L)
            # d[t, s] = e^(L_mI - L_eJ) for query block I after key block J
            dex = L[:, :, m_row][:, :, :, None] - L[:, :, e_row][:, :, None]
            d = torch.exp2(torch.where(off[..., None], dex, -torch.inf))
            a_off = (qh[:, :, :, None] * d * kh[:, :, None]).sum(-1)
            lex = Lp[:, :, :, None] - L[:, :, None]
            pair = torch.exp2(torch.where(diag[..., None], lex, -torch.inf))
            a_diag = (rc[:, :, :, None] * kc[:, :, None] * pair).sum(-1)
            bonus = (rc * u[None, :, None] * kc).sum(-1)
            A = a_off + a_diag + torch.diag_embed(bonus)
            oc = qi @ st + A @ vc
            o[:, :, t0:t0 + n, j0:j0 + vs] = oc[:, :, :n]
            st = torch.exp2(L[:, :, -1])[..., None] * st + \
                kd.transpose(-1, -2) @ vc
        s_fin[..., j0:j0 + vs] = st
    return o, s_fin


def _inputs(B, H, S, K, seed):
    rng = np.random.default_rng(seed)
    rn = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (rn(B, H, S, K), rn(B, H, S, K), rn(B, H, S, K),
            -np.exp(rn(B, H, S, K)), rn(H, K), rn(B, H, K, K))


def _pallas(ins, S):
    # the reference kernel wants S a multiple of its chunk: the largest
    # divisor of S up to 33 (its chunk is a tiling choice, not numerics)
    c = max(d for d in range(1, min(S, 33) + 1) if S % d == 0)
    o, sf = jax_wkv_kernel(*map(jnp.asarray, ins), interpret=True, chunk=c)
    return np.asarray(o), np.asarray(sf)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("K", [16, 32, 64, 128])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 130])
def test_schedule_matches_pallas_and_ref(S, K):
    ins = _inputs(1, 2, S, K, seed=S * 7 + K)
    nv = wkv_ops.wkv_split(1, 2, K, 132)
    o, sf = wkv_schedule(*map(torch.from_numpy, ins), CHUNK, nv)
    o_p, sf_p = _pallas(ins, S)
    _close(o, o_p)
    _close(sf, sf_p)
    o_r, sf_r = rwkv6_wkv_ref(*map(torch.from_numpy, ins))
    _close(o, o_r)
    _close(sf, sf_r)


@pytest.mark.parametrize("S,K", [(45, 48), (70, 80), (77, 96), (130, 112)])
def test_schedule_at_the_other_head_dims(S, K):
    """The K the kernel takes besides the powers of two, at ragged S and
    the V split of a few heads (its scan lanes and slices differ)."""
    ins = _inputs(1, 3, S, K, seed=S + K)
    o, sf = wkv_schedule(*map(torch.from_numpy, ins), CHUNK,
                         wkv_ops.wkv_split(1, 3, K, 132))
    o_r, sf_r = rwkv6_wkv_ref(*map(torch.from_numpy, ins))
    _close(o, o_r)
    _close(sf, sf_r)
    o_p, sf_p = _pallas(ins, S)
    _close(o, o_p)
    _close(sf, sf_p)


@pytest.mark.parametrize("chunk,nv", [(16, 1), (32, 2), (32, 4), (64, 1)])
def test_schedule_chunk_and_v_split_agree(chunk, nv):
    """Chunk size and V slices change the order of sums, not the
    function: every variant within 2e-3 of the sequential reference."""
    ins = tuple(map(torch.from_numpy, _inputs(2, 2, 77, 64, seed=chunk)))
    o, sf = wkv_schedule(*ins, chunk, nv)
    o_r, sf_r = rwkv6_wkv_ref(*ins)
    _close(o, o_r)
    _close(sf, sf_r)


@pytest.mark.parametrize("K", [64, 128])
def test_mixed_decay_chunk(K):
    """Decays of -50 (e^-50 a token: the naive factorisation overflows
    in two tokens) mixed with ~-1e-3, channel by channel and token by
    token, inside every chunk: finite, and within 2e-3 of the sequential
    reference and of the Pallas kernel."""
    r, k, v, _, u, s0 = _inputs(1, 2, 70, K, seed=K)
    rng = np.random.default_rng(K + 1)
    logw = np.where(rng.random(r.shape) < 0.5, -50.0,
                    -1e-3 * (1 + rng.random(r.shape))).astype(np.float32)
    ins = (r, k, v, logw, u, s0)
    o, sf = wkv_schedule(*map(torch.from_numpy, ins), CHUNK,
                         wkv_ops.wkv_split(1, 2, K, 132))
    assert torch.isfinite(o).all() and torch.isfinite(sf).all()
    o_r, sf_r = rwkv6_wkv_ref(*map(torch.from_numpy, ins))
    _close(o, o_r)
    _close(sf, sf_r)
    o_p, sf_p = _pallas(ins, 70)
    _close(o, o_p)
    _close(sf, sf_p)


def test_schedule_extreme_decay_gives_exact_zeros():
    """logw = -50, k = 0, s0 = 1e3: the carried state's contribution is
    exactly 0 from the third token on, and so is s_final."""
    one = torch.ones((1, 1, 64, 32))
    o, sf = wkv_schedule(one, torch.zeros_like(one), one,
                         torch.full_like(one, -50.0), torch.zeros((1, 32)),
                         torch.full((1, 1, 32, 32), 1e3), 32, 4)
    assert torch.isfinite(o).all() and torch.isfinite(sf).all()
    assert bool((o[:, :, 3:] == 0).all()) and bool((sf == 0).all())


def test_wkv_split_from_static_shapes():
    assert wkv_ops.wkv_split(1, 64, 64, 132) == 2      # rwkv6-7b, B=1
    assert wkv_ops.wkv_split(2, 64, 64, 132) == 1
    assert wkv_ops.wkv_split(4, 64, 64, 132) == 1
    assert wkv_ops.wkv_split(1, 2, 64, 132) == 4      # few heads
    for K in wkv_ops.HEAD_DIMS:
        nv = wkv_ops.wkv_split(1, 1, K, 132)
        assert nv in wkv_ops.SPLITS and (K // nv) % 4 == 0


def test_wkv_kernel_source_instantiates_every_head_dim():
    src = (common.CSRC / "rwkv6_wkv.cu").read_text()
    assert wkv_ops.HEAD_DIMS == (16, 32, 48, 64, 80, 96, 112, 128)
    for K in wkv_ops.HEAD_DIMS:
        assert f"RT_WKV_CASE({K})" in src
    assert "constexpr int SB = 8;" in src
    assert f"constexpr int CHUNK = {CHUNK};" in src
    assert "static constexpr int C = CHUNK;" in src


def _scan_lanes(K, C):
    """``scan_lanes`` of the kernel: lanes a channel in the scan."""
    lanes = 1
    while K * lanes * 2 <= NT and C % (lanes * 2) == 0 and lanes * 2 <= 32:
        lanes *= 2
    return lanes


@pytest.mark.parametrize("K", wkv_ops.HEAD_DIMS)
def test_wkv_layout_fits_every_head_dim(K):
    """``Lay<K>`` mirrored: its static_assert holds, a scan warp is whole,
    and the shared memory of every V split fits one CTA."""
    C, lpc = CHUNK, _scan_lanes(K, CHUNK)
    nb, kp, ap, lpr = C // SB, K + 4, C + 4, NT // C
    assert C % SB == 0 and NT % C == 0 and C % lpr == 0
    assert K % 16 == 0 and K <= 128 and (K * lpc) % 32 == 0
    for nv in wkv_ops.SPLITS:
        if K % (4 * nv):
            continue
        vs = K // nv
        floats = (3 * C * kp + 2 * C * (vs + 4) + 4 * C * kp + nb * nb * K
                  + C * ap + K * (vs + 4) + 2 * K)
        assert 4 * floats <= SMEM_MAX, (K, nv, 4 * floats)
