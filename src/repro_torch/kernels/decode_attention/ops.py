"""Wrappers of the ring-cache decode kernel, the paged decode kernels
(with and without the step's new token) and the sampler, with the call
contracts of ``repro.kernels.decode_attention.ops``
(``decode_attention_op`` for a contiguous cache or, given
``block_tables``, a page pool; ``fused_decode_step_op``;
``sample_tokens_op``).

A CUDA tensor launches ``csrc/decode_attention.cu`` /
``csrc/fused_paged_decode.cu`` / ``csrc/sample_tokens.cu`` on the
current stream; a CPU tensor runs the plain version in ``ref.py``.

The three attention kernels split each (slot, kv head)'s walk over a
thread block cluster of CTAs and merge the partials inside the same
launch; :func:`split_plan` picks the split from static shapes and the
card's SM count only — never from ``lengths`` or ``pos``, which stay on
the device. The sampler splits each row over a cluster the same way
(:func:`sample_plan`)."""

import torch

from repro_torch.kernels import common
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, fused_paged_decode_ref, paged_decode_attention_ref,
    sample_tokens_ref)

RING = "decode_attention"
DECODE = "fused_paged_decode"
PAGED = "paged_decode_attention"
SAMPLE = "sample_tokens"
HEAD_DIMS = (16, 32, 64, 96, 112, 128, 256)   # hd the three kernels take
GROUPS = tuple(range(1, 17))           # and Hq / Hkv
CLUSTER_MAX = 16           # CTAs a cluster (non-portable above 8: Hopper)


def split_share(rows, splits, unit=1):
    """(splits used, share): CTA r of a cluster takes the logical rows
    ``[r * share, (r + 1) * share)`` of ``[0, rows)``; ``share`` is a
    multiple of ``unit`` (a page) and no CTA gets an empty share."""
    units = common.cdiv(rows, unit)
    per = common.cdiv(units, max(1, min(splits, units)))
    return common.cdiv(units, per), per * unit


def split_plan(B, Hkv, rows, sm_count, unit=1):
    """The split walk's plan from static shapes only: the most splits (a
    power of two, at most :data:`CLUSTER_MAX`, at most one a ``unit``)
    that keep the grid to one wave of two CTAs on each of ``sm_count``
    SMs, then :func:`split_share`. More CTAs than fit at once (on an
    H100 only 62 clusters of 8 do) run as a second wave. ``rows`` is
    ``nb * ps`` (paged, ``unit = ps``) or the ring capacity C."""
    units = common.cdiv(rows, unit)
    splits = 1
    while (splits < CLUSTER_MAX and splits < units
           and B * Hkv * (2 * splits) <= 2 * sm_count):   # doubled: fits
        splits *= 2
    return split_share(rows, splits, unit)


#: columns a sampler CTA takes at least: one float4 of each row for each
#: of its 512 threads. It binds only below V = 16 * 2048 = 32768, under
#: every served vocabulary; no other value was timed.
SAMPLE_MIN_SHARE = 2048


def sample_plan(B, V, sm_count):
    """The sampler's plan from static shapes: (CTAs a row, share). Row
    ``b`` is split over a cluster of CTAs, CTA r taking the columns
    ``[r * share, min(V, (r + 1) * share))``; ``share`` is a multiple of
    4 (16-byte interior edges) and no CTA gets an empty slice. The most
    CTAs a row, a power of two up to :data:`CLUSTER_MAX`, that keep the
    grid to one wave of two CTAs on each of ``sm_count`` SMs and give
    every CTA at least :data:`SAMPLE_MIN_SHARE` columns."""
    ctas = 1
    while (ctas < CLUSTER_MAX and B * 2 * ctas <= 2 * sm_count
           and V >= 2 * ctas * SAMPLE_MIN_SHARE):
        ctas *= 2
    return split_share(V, ctas, 4)


def _record(name, q, keys, ins, out):
    """Report a decode call's work (the scores and p·v of every query
    head over all ``keys`` rows it may read, as the plain version and
    the reference's XLA decode compute them) and return ``out``."""
    B, _, Hq, hd = q.shape
    common.record(name, 4 * B * Hq * keys * hd, ins, (out,))
    return out


def _check_kernel_shape(hd, Hq, Hkv):
    common.require(hd in HEAD_DIMS,
                   f"kernel takes hd in {HEAD_DIMS}, got {hd}")
    common.require(Hq // Hkv in GROUPS,
                   f"kernel takes Hq/Hkv in {GROUPS}, got {Hq // Hkv}")


def _check_aligned(**tensors):
    for name, t in tensors.items():
        common.require(t.data_ptr() % 16 == 0,
                       f"{name} must be 16-byte aligned")


def decode_attention_op(q, k_cache, v_cache, pos, *, window=0,
                        block_tables=None):
    """q: (B,1,Hq,hd) → (B,1,Hq,hd).

    Contiguous: k/v (B,C,Hkv,hd) ring caches (position p at slot p % C);
    ``pos``: the new token's position, shared by every slot — a Python
    int, or a 0-d int32 tensor on the caches' device that the kernel
    reads itself (no host sync).

    Paged (``block_tables`` (B, nb) int32 given): k/v (P,ps,Hkv,hd) page
    pools; ``pos`` the (B,) int32 per-slot valid lengths (0 = dead slot
    → zeros), every valid token already in the pool."""
    if block_tables is not None:
        return _paged_decode_op(q, k_cache, v_cache, pos, block_tables,
                                window)
    require = common.require
    B, one, Hq, hd = q.shape
    require(k_cache.dim() == 4 and k_cache.shape == v_cache.shape
            and k_cache.shape[0] == B and k_cache.shape[3] == hd
            and one == 1 and Hq % k_cache.shape[2] == 0,
            f"q{tuple(q.shape)} does not match caches"
            f"{tuple(k_cache.shape)}")
    require(q.dtype == k_cache.dtype == v_cache.dtype, "q/k/v dtypes differ")
    on_dev = isinstance(pos, torch.Tensor)
    if on_dev:
        require(pos.dim() == 0, "pos must be a 0-d tensor or an int")
    ins = (q, k_cache, v_cache, *([pos] if on_dev else []))
    where = common.path(*ins)
    if where == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, pos, window=window)
    common.refuse_grad(RING, q.device, q, k_cache, v_cache)
    if where == "meta":
        return _record(RING, q, k_cache.shape[1], ins, torch.empty_like(q))
    _, C, Hkv, _ = k_cache.shape
    _check_kernel_shape(hd, Hq, Hkv)
    common.check_contiguous(q=q, k_cache=k_cache, v_cache=v_cache)
    _check_aligned(q=q, k_cache=k_cache, v_cache=v_cache)
    if on_dev:
        require(pos.dtype == torch.int32, "pos tensor must be int32")
        pos_ptr, pos_val = pos.data_ptr(), 0
    else:
        require(int(pos) >= 0, f"pos must be >= 0, got {pos}")
        pos_ptr, pos_val = None, int(pos)
    splits, share = split_plan(B, Hkv, C, common.sm_count(q.device))
    out = torch.empty_like(q)
    fn = common.entry(RING, "decode_attention", "pppppiiiiiiiiiifp")
    code = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
              out.data_ptr(), pos_ptr, pos_val, common.dtype_code(q), B, C,
              Hq, Hkv, hd, int(window), splits, share, hd ** -0.5,
              common.stream_of(q))
    common.check(code, "decode_attention")
    common.LAUNCHES[RING] += 1
    return _record(RING, q, C, ins, out)


def _check_paged_kernel(q, Hkv, lengths, block_tables):
    require = common.require
    _check_kernel_shape(q.shape[3], q.shape[2], Hkv)
    require(lengths.dtype == torch.int32
            and block_tables.dtype == torch.int32,
            "lengths and block_tables must be int32")


def _paged_decode_op(q, k_pages, v_pages, lengths, block_tables, window):
    require = common.require
    B, one, Hq, hd = q.shape
    P, ps, Hkv, hd_p = k_pages.shape
    require(one == 1 and hd_p == hd and Hq % Hkv == 0,
            f"q{tuple(q.shape)} does not match pools{tuple(k_pages.shape)}")
    require(v_pages.shape == k_pages.shape, "k/v pools differ in shape")
    require(lengths.shape == (B,) and block_tables.dim() == 2
            and block_tables.shape[0] == B, "bad lengths/block_tables")
    require(q.dtype == k_pages.dtype == v_pages.dtype,
            "q/pool dtypes differ")
    where = common.path(q, k_pages, v_pages, lengths, block_tables)
    if where == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, lengths,
                                          block_tables, window=window)
    common.refuse_grad(PAGED, q.device, q, k_pages, v_pages)
    keys = block_tables.shape[1] * ps
    if where == "meta":
        return _record(PAGED, q, keys, (q, k_pages, v_pages, lengths,
                                        block_tables), torch.empty_like(q))
    _check_paged_kernel(q, Hkv, lengths, block_tables)
    common.check_contiguous(q=q, k_pages=k_pages, v_pages=v_pages,
                            lengths=lengths, block_tables=block_tables)
    _check_aligned(q=q, k_pages=k_pages, v_pages=v_pages)
    nb = block_tables.shape[1]
    splits, share = split_plan(B, Hkv, nb * ps, common.sm_count(q.device), ps)
    out = torch.empty_like(q)
    fn = common.entry(DECODE, "paged_decode_attention", "ppppppiiiiiiiiiifp")
    code = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
              lengths.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
              common.dtype_code(q), B, Hq, Hkv, hd, ps, nb, int(window),
              splits, share, hd ** -0.5, common.stream_of(q))
    common.check(code, "paged_decode_attention")
    common.LAUNCHES[PAGED] += 1
    return _record(PAGED, q, keys, (q, k_pages, v_pages, lengths,
                                    block_tables), out)


def fused_decode_step_op(q, k_new, v_new, k_pages, v_pages, lengths,
                         block_tables, *, window=0):
    """q: (B,1,Hq,hd); k_new/v_new: (B,1,Hkv,hd) this step's projected
    and roped K/V (logical index ``lengths-1``); pages: (P,ps,Hkv,hd)
    pools *without* the new token; lengths (B,) int32 include the new
    token; block_tables (B,nb) int32 → (B,1,Hq,hd)."""
    require = common.require
    B, one, Hq, hd = q.shape
    P, ps, Hkv, hd_p = k_pages.shape
    require(one == 1 and hd_p == hd and Hq % Hkv == 0,
            f"q{tuple(q.shape)} does not match pools{tuple(k_pages.shape)}")
    require(k_new.shape == v_new.shape == (B, 1, Hkv, hd),
            f"k_new/v_new must be {(B, 1, Hkv, hd)}")
    require(v_pages.shape == k_pages.shape, "k/v pools differ in shape")
    require(lengths.shape == (B,) and block_tables.dim() == 2
            and block_tables.shape[0] == B, "bad lengths/block_tables")
    require(q.dtype == k_new.dtype == v_new.dtype == k_pages.dtype
            == v_pages.dtype, "q/k/v/pool dtypes differ")
    ins = (q, k_new, v_new, k_pages, v_pages, lengths, block_tables)
    where = common.path(*ins)
    if where == "cpu":
        return fused_paged_decode_ref(q, k_new, v_new, k_pages, v_pages,
                                      lengths, block_tables, window=window)
    common.refuse_grad(DECODE, q.device, q, k_new, v_new, k_pages, v_pages)
    keys = block_tables.shape[1] * ps
    if where == "meta":
        return _record(DECODE, q, keys, ins, torch.empty_like(q))
    _check_paged_kernel(q, Hkv, lengths, block_tables)
    common.check_contiguous(q=q, k_new=k_new, v_new=v_new, k_pages=k_pages,
                            v_pages=v_pages, lengths=lengths,
                            block_tables=block_tables)
    _check_aligned(q=q, k_new=k_new, v_new=v_new, k_pages=k_pages,
                   v_pages=v_pages)
    nb = block_tables.shape[1]
    splits, share = split_plan(B, Hkv, nb * ps, common.sm_count(q.device), ps)
    out = torch.empty_like(q)
    fn = common.entry(DECODE, "fused_paged_decode_attention",
                      "ppppppppiiiiiiiiiifp")
    code = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
              k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
              block_tables.data_ptr(), out.data_ptr(), common.dtype_code(q),
              B, Hq, Hkv, hd, ps, nb, int(window), splits, share,
              hd ** -0.5, common.stream_of(q))
    common.check(code, "fused_paged_decode_attention")
    common.LAUNCHES[DECODE] += 1
    return _record(DECODE, q, keys, ins, out)


def sample_tokens_op(logits, temps, noise):
    """On-device argmax/Gumbel-max sampling: (B,V) + (B,) + (B,V) → (B,)
    int32, ``argmax(logits + noise * temps)`` per row. Inputs are taken
    in fp32, as the reference kernel takes them.

    The order is ``np.argmax``'s and ``torch.argmax``'s, held by the
    kernel and the plain version alike: scores are ordered totally, a NaN
    above +inf; among equal scores, and among NaNs, the lowest index
    wins; -0.0 and +0.0 are equal; an all -inf row picks 0. Noise is
    used on greedy rows too: T = 0 with an infinite noise value gives a
    NaN score, which wins its row. (The reference's Pallas kernel skips a
    2048-wide block that holds a NaN instead: ROADMAP, faults queue.)"""
    require = common.require
    require(logits.dim() == 2 and noise.shape == logits.shape
            and temps.shape == logits.shape[:1], "bad sampler shapes")
    where = common.path(logits, temps, noise)
    if where == "cpu":
        return sample_tokens_ref(logits, temps, noise)
    common.refuse_grad(SAMPLE, logits.device, logits, temps, noise)
    if where == "meta":
        out = torch.empty(logits.shape[:1], dtype=torch.int32,
                          device=logits.device)
        common.record(SAMPLE, 0, (logits, temps, noise), (out,))
        return out
    logits = logits.float().contiguous()
    noise = noise.float().contiguous()
    temps = temps.float().contiguous()
    B, V = logits.shape
    require(B > 0 and V > 0, "empty sampler rows")
    ctas, share = sample_plan(B, V, common.sm_count(logits.device))
    out = torch.empty((B,), dtype=torch.int32, device=logits.device)
    fn = common.entry(SAMPLE, "sample_tokens", "ppppiiiip")
    code = fn(logits.data_ptr(), noise.data_ptr(), temps.data_ptr(),
              out.data_ptr(), B, V, ctas, share, common.stream_of(logits))
    common.check(code, "sample_tokens")
    common.LAUNCHES[SAMPLE] += 1
    common.record(SAMPLE, 0, (logits, temps, noise), (out,))
    return out
