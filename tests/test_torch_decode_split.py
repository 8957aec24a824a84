"""The split walk of the port's decode-attention kernels, on the CPU.

The CUDA kernels (``csrc/decode_core.cuh``) give each (slot, kv head) a
thread block cluster of CTAs; CTA r walks the logical rows
``[r * share, (r + 1) * share)`` and the cluster merges the partials
(m, l, acc) in rank order. What runs here:

- the split plan (``ops.split_plan`` / ``ops.split_share``): every
  logical row of ``nb * ps`` (or C) in exactly one share, at most
  ``CLUSTER_MAX`` CTAs a cluster, computed from static shapes only;
- a plain model of the split and the merge (:func:`split_merge`, written
  here and used by no path) against the reference's Pallas kernels in
  interpret mode, at 1, 2, 3, 8 and 16 splits, with a dead slot, a
  length of 1 (only the new token), a full table, a length ending on a
  split edge, a window that empties whole splits, a ring that wraps
  inside a share and on a split edge, and fewer valid rows than splits;
- the ring op at hd 256 with 10 query heads a kv head (the coverage the
  ring kernel gained) against the Pallas ring kernel.

Tolerances are the reference's: fp32 2e-5 (reassociation only), bf16
3e-2 (one bf16 rounding of the output).
"""
import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import (
    decode_attention as pallas_ring, fused_paged_decode_attention as
    pallas_fused, paged_decode_attention as pallas_paged)
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ops import (
    CLUSTER_MAX, decode_attention_op, split_plan, split_share)

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SPLITS = (1, 2, 3, 8, 16)


def _shares(splits, share, rows):
    return [(r * share, min((r + 1) * share, rows)) for r in range(splits)]


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# the split plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,unit", [(1, 1), (16, 16), (48, 16),
                                       (256, 16), (2560, 16), (4096, 1),
                                       (100, 1), (64, 4)])
@pytest.mark.parametrize("B,Hkv", [(1, 1), (4, 1), (4, 16), (64, 8)])
def test_split_plan_covers_every_row_once(rows, unit, B, Hkv):
    splits, share = split_plan(B, Hkv, rows, 132, unit)
    assert 1 <= splits <= CLUSTER_MAX and share % unit == 0
    covered = np.zeros(rows, np.int64)
    for t0, t1 in _shares(splits, share, rows):
        assert t1 > t0                     # no CTA gets an empty share
        covered[t0:t1] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("rows,unit", [(64, 4), (64, 1), (3, 1), (2560, 16)])
def test_split_share_at_forced_splits_covers_every_row_once(splits, rows,
                                                            unit):
    used, share = split_share(rows, splits, unit)
    assert used <= splits and share % unit == 0
    covered = np.zeros(rows, np.int64)
    for t0, t1 in _shares(used, share, rows):
        assert t1 > t0
        covered[t0:t1] += 1
    assert (covered == 1).all()


def test_split_plan_reads_static_shapes_only():
    """No length or position reaches the plan (they stay on the device);
    at the serving shapes it gives one wave of at most two CTAs an SM:
    4 a (slot, kv head) for qwen's 64 pairs, 16 for recurrentgemma's 4."""
    params = list(inspect.signature(split_plan).parameters)
    assert params == ["B", "Hkv", "rows", "sm_count", "unit"]
    assert split_plan(4, 16, 16 * 16, 132, 16) == (4, 64)     # qwen
    assert split_plan(4, 1, 16 * 16, 132, 16) == (16, 16)     # MQA
    assert split_plan(4, 1, 160 * 16, 132, 16) == (16, 160)   # MQA, long
    assert split_plan(4, 16, 4096, 132) == (4, 1024)          # VMM ring
    assert split_plan(64, 16, 4096, 132) == (1, 4096)         # card full
    for B, Hkv in ((1, 1), (4, 1), (4, 16), (16, 8), (64, 16)):
        splits, _ = split_plan(B, Hkv, 4096, 132)
        assert splits == 1 or B * Hkv * splits <= 2 * 132


def test_decode_kernels_take_every_head_dim_and_group_up_to_16():
    assert ops.HEAD_DIMS == (16, 32, 64, 96, 112, 128, 256)
    assert ops.GROUPS == tuple(range(1, 17))


# ---------------------------------------------------------------------------
# a plain model of the split and the merge
# ---------------------------------------------------------------------------

def split_merge(q, k, v, valid, splits, share):
    """q (B, Hq, hd); k/v (B, N, Hkv, hd) in logical row order; valid
    (B, N) bool → (B, Hq, hd) fp32. CTA r's partial is the max m, the
    sum l of exp(s - m) and acc = Σ exp(s - m)·v over the valid rows of
    its share (m = -1e30, l = 0 for none); the partials merge in rank
    order, and a slot with no valid row gives zeros."""
    B, N, Hkv, hd = k.shape
    G = q.shape[1] // Hkv
    k = torch.where(valid[:, :, None, None], k, 0.0).repeat_interleave(G, 2)
    v = torch.where(valid[:, :, None, None], v, 0.0).repeat_interleave(G, 2)
    s = torch.einsum("bhd,bnhd->bhn", q, k) * hd ** -0.5
    s = torch.where(valid[:, None], s, -torch.inf)
    M = torch.full(q.shape[:2], -1e30)
    parts = []
    for t0, t1 in _shares(splits, share, N):
        sr = s[..., t0:t1]
        m = sr.amax(-1).clamp_min(-1e30) if t1 > t0 else M.clone()
        p = torch.exp(sr - m[..., None])
        parts.append((m, p.sum(-1),
                      torch.einsum("bhn,bnhd->bhd", p, v[:, t0:t1])))
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    A = torch.zeros_like(q)
    for m, l, acc in parts:
        w = torch.exp(m - M)
        L = L + l * w
        A = A + acc * w[..., None]
    return A / L.clamp_min(1e-30)[..., None]


def _cast(x, dtype):
    """numpy fp32 → the working dtype's values, as fp32 numpy."""
    return np.array(jnp.asarray(x, jnp.dtype(dtype)).astype(jnp.float32))


# paged: B=4 slots, ps=4, nb=16 (64 logical rows), Hq/Hkv 4/2, hd 32
PB, PS, NB, PHQ, PHKV, PHD = 4, 4, 16, 4, 2, 32
PP = PB * NB + 3
EDGE = 24                        # a split edge at 3, 8 and 16 splits


@functools.lru_cache(maxsize=None)
def _paged_case(kind, window, dtype, hq=PHQ, hkv=PHKV, hd=PHD):
    """Inputs (numpy, the working dtype's values) and the Pallas output.
    Slots: dead, length 1, a full table, a length on a split edge."""
    rng = np.random.default_rng(1000 * len(kind) + 10 * window + hq + hd)
    lens = np.asarray([0, 1, PS * NB, EDGE], np.int32)
    d = {n: _cast(rng.standard_normal(sh, np.float32), dtype)
         for n, sh in (("q", (PB, hq, 1, hd)), ("k_new", (PB, hkv, 1, hd)),
                       ("v_new", (PB, hkv, 1, hd)),
                       ("k_pages", (PP, PS, hkv, hd)),
                       ("v_pages", (PP, PS, hkv, hd)))}
    bt = rng.permutation(PP)[:PB * NB].reshape(PB, NB).astype(np.int32)
    j = {n: jnp.asarray(x, jnp.dtype(dtype)) for n, x in d.items()}
    if kind == "fused":
        want = pallas_fused(j["q"], j["k_new"], j["v_new"], j["k_pages"],
                            j["v_pages"], jnp.asarray(lens), jnp.asarray(bt),
                            window=window, interpret=True)
    else:
        want = pallas_paged(j["q"], j["k_pages"], j["v_pages"],
                            jnp.asarray(lens), jnp.asarray(bt), window=window,
                            interpret=True)
    return d, lens, bt, np.asarray(want.astype(jnp.float32))[:, :, 0]


def _paged_logical(d, lens, bt, kind, window):
    """The pools in logical row order, with the new token at lens-1."""
    t = {n: torch.from_numpy(x) for n, x in d.items()}
    idx = torch.from_numpy(bt).long()
    N = NB * PS
    k = t["k_pages"][idx].reshape(PB, N, *t["k_pages"].shape[2:])
    v = t["v_pages"][idx].reshape(PB, N, *t["v_pages"].shape[2:])
    tok = torch.arange(N)[None]
    L = torch.from_numpy(lens).long()[:, None]
    if kind == "fused":
        at = (tok == L - 1)[:, :, None, None]
        k = torch.where(at, t["k_new"].transpose(1, 2), k)
        v = torch.where(at, t["v_new"].transpose(1, 2), v)
    valid = tok < L
    if window:
        valid &= tok >= L - window
    return t["q"][:, :, 0], k, v, valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("kind", ["fused", "paged"])
@pytest.mark.parametrize("splits", SPLITS)
def test_paged_split_merge_matches_pallas(splits, kind, window, dtype):
    """Whole-page shares of a 16-page table at 1–16 splits; window 5
    leaves only the last split(s) of the full slot any row; the slot of
    length 1 has fewer rows than splits."""
    d, lens, bt, want = _paged_case(kind, window, dtype)
    used, share = split_share(NB * PS, splits, PS)
    assert used == min(splits, NB)
    if splits in (3, 8, 16):
        assert EDGE % share == 0                       # ends on an edge
    q, k, v, valid = _paged_logical(d, lens, bt, kind, window)
    got = split_merge(q, k, v, valid, used, share)
    assert bool((got[0] == 0).all())                   # dead slot
    _close(got, want, dtype)


@pytest.mark.parametrize("splits", SPLITS)
def test_paged_split_merge_matches_pallas_mqa_hd256(splits):
    """recurrentgemma's attention shape: 10 query heads on one kv head,
    hd 256, a window."""
    d, lens, bt, want = _paged_case("fused", 20, "float32", hq=10, hkv=1,
                                    hd=256)
    used, share = split_share(NB * PS, splits, PS)
    got = split_merge(*_paged_logical(d, lens, bt, "fused", 20), used, share)
    _close(got, want, "float32")


# ring: B=2 slots, C=64, Hq/Hkv 4/2, hd 32; pos is shared by the slots
RB, RC_, RHQ, RHKV, RHD = 2, 64, 4, 2, 32
RING_CASES = {
    "partly filled": (10, 0),
    "fewer rows than splits": (2, 0),
    "wraps inside a share": (100, 0),        # start 37: wraps at row 27
    "wraps on a split edge": (111, 0),       # start 48: wraps at row 16
    "window empties splits": (200, 10),
}


@functools.lru_cache(maxsize=None)
def _ring_case(pos, window, dtype, hq=RHQ, hkv=RHKV, hd=RHD):
    rng = np.random.default_rng(pos + 7 * window + hq)
    q, k, v = (_cast(rng.standard_normal(sh, np.float32), dtype)
               for sh in ((RB, hq, 1, hd), (RB, hkv, RC_, hd),
                          (RB, hkv, RC_, hd)))
    dt = jnp.dtype(dtype)
    want = pallas_ring(jnp.asarray(q, dt), jnp.asarray(k, dt),
                       jnp.asarray(v, dt), jnp.asarray(pos, jnp.int32),
                       window=window, interpret=True, bkv=RC_)
    return q, k, v, np.asarray(want.astype(jnp.float32))[:, :, 0]


def _ring_logical(q, k, v, pos, window):
    """The caches in logical row order: row j is slot (start + j) % C,
    valid for j < n = min(pos + 1, C[, window])."""
    n = min(pos + 1, RC_) if window == 0 else min(pos + 1, RC_, window)
    start = (pos % RC_ - n + 1) % RC_
    slot = (start + torch.arange(RC_)) % RC_
    kt = torch.from_numpy(k).transpose(1, 2)[:, slot]
    vt = torch.from_numpy(v).transpose(1, 2)[:, slot]
    valid = (torch.arange(RC_) < n)[None].expand(RB, RC_)
    return torch.from_numpy(q)[:, :, 0], kt, vt, valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(RING_CASES))
@pytest.mark.parametrize("splits", SPLITS)
def test_ring_split_merge_matches_pallas(splits, case, dtype):
    pos, window = RING_CASES[case]
    q, k, v, want = _ring_case(pos, window, dtype)
    used, share = split_share(RC_, splits)
    if case == "wraps on a split edge" and splits == 8:
        assert (RC_ - (pos + 1) % RC_) % share == 0
    got = split_merge(*_ring_logical(q, k, v, pos, window), used, share)
    _close(got, want, dtype)


# ---------------------------------------------------------------------------
# the ring op at hd 256, 10 query heads a kv head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos,window", [(40, 0), (100, 0), (100, 48)])
def test_ring_decode_hd256_g10_matches_pallas(pos, window, dtype):
    q, k, v, want = _ring_case(pos, window, dtype, hq=10, hkv=1, hd=256)
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    got = decode_attention_op(tq.transpose(1, 2), tk.transpose(1, 2),
                              tv.transpose(1, 2), pos, window=window)
    assert got.shape == (RB, 1, 10, 256)
    _close(got[:, 0].float(), want, dtype)
    used, share = split_share(RC_, 8)
    model = split_merge(*_ring_logical(q, k, v, pos, window), used, share)
    _close(model, want, dtype)
