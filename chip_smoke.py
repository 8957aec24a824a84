#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines and raising on any failure:

1. device — the card's name and power limit (nvidia-smi), torch/CUDA
   versions, the time to build the kernels from ``kernels/csrc`` (one
   nvcc per source, all started together), every kernel's registers and
   spills (ptxas ``-v``; one line a kernel for the sources redesigned for
   Hopper: all but Sobel) and the tensor-core
   instructions in the SASS of matmul and flash (wgmma with TMA or
   cp.async);
2. kernels — every hand-written kernel against its plain PyTorch
   version on the card, each against a stated tolerance: flash and fused
   paged decode at the serving path's shapes (G > 1, a dead slot,
   NaN-poisoned masked rows); the sampler exactly, against its plain
   version and ``np.argmax`` alike, at B = 4 and the three served
   vocabularies, B = 1 and 64, V = 1, 5, 1000 and 152061 (rows not
   16-byte aligned), a cross-block tie, and rows at the edges of its
   split and of the NaN rule (NaN at 0, at a thread's and a CTA's first
   column, two NaNs, all NaN, all -inf, +inf against NaN, -0.0 before
   +0.0, T = 0 with infinite noise); flash at its
   q-tile edges (S = 1, 63, 64, 65) and at B=4 S=4096, and at
   recurrentgemma's hd=256, Hq/Hkv 10/1 with windows, and at the head
   dims of phi3-mini (hd 96, 32/32) and kimi-k2 (hd 112, 64/8), bf16 and
   fp32, S = 1, 65, 130, causal and windowed; ring-cache decode
   at C=4096 (partly filled, wrapped, windowed, fewer valid slots than
   splits, a wrap inside a share and on a split edge, a window emptying
   shares, NaN in invalid slots, ``pos`` on the device) at every head dim
   and at Hq/Hkv up to 16, hd 256 10/1 with window 2048 among them;
   matmul at ragged, padded (N % 8 != 0), K % 64 != 0 and card shapes,
   Sobel and vecadd at ragged and card shapes; the RG-LRU scan bit-equal
   at S = 1, 2, its stage and ring edges, ragged D, D below a tile, 4-byte
   copies, the serving and chunked-prefill calls and B=4
   S=4096; the RWKV-6 WKV (the chunked form: K 16 to 128, ragged tails,
   rwkv6-7b's prefill and chunked-prefill calls, B=4 S=4096) plus an
   extreme decay and a chunk mixing decays of -50 and ~-1e-3; the
   no-new-token paged decode with a dead slot and NaN-poisoned rows; the
   split walk's edges of the fused and paged decode (dead slot, length
   1, full table, a length on a split edge, a window emptying splits)
   at every head dim
   and G = 1, 3, 16, clean and NaN-poisoned; bit-equal reruns of the
   three decode kernels, and one launch and no host sync a call for them,
   the sampler, the scan and the WKV;
3. serve, monolithic — full-width ``qwen1.5-0.5b`` (random weights from
   a fixed seed) through ``ServeEngine``: 8 requests, batch 4, prompts of
   32–130 tokens, 32 new tokens each, capacity 256, 16-token pages;
4. serve, chunked — the same requests with ``chunk_tokens=32``;
   in 3 and 4 every kernel of the path must have launched, every request
   must finish, ``full_prefills == 0`` and pages leased == freed;
5. serve, virtualized — the same requests through a VMM tenant whose
   pool is sized from the card, ``hybrid`` monolithic and ``slo``
   chunked: token ids equal phases 3–4 (or the printed reason),
   ``full_prefills == 0``, leased == freed, no scheduler or CRC failure,
   an op-log record per step;
6. serve, recurrent — full-width ``recurrentgemma-2b`` and ``rwkv6-7b``
   (full depth, bf16, random weights from a fixed seed) with paged
   recurrent state, the same requests in both modes; state pages
   leased == freed too, each model freed before the next;
7. VMM programs — a tenant reprograms the full-width prefill program
   (B=4, S=4096) and the decode program of the same capacity, runs the
   prefill and 32 greedy decode steps through the guest API at pos
   4096…4127 (``decode_attention`` 24 times a step), takes a warm hit,
   and a cross-slice reprogram is refused;
8. reference — the card against the plain PyTorch path on the CPU:
   full-width fp32 prefill logits and reduced-config engine token ids in
   both modes (qwen, and both recurrent families at full width cut to
   one block period, with 3 paged decode steps); the step builders'
   full-width fp32 decode logits and reduced-config decode ids over a
   wrapped ring;
9. apps — the paper's three apps (``launch/apps.py``) native and through
   three bound tenants, at the reference size and at the card's;
10. times — per mode TTFT, throughput and the median engine step; per
   kernel its device time (torch.profiler/CUPTI; the per-call CUDA-event
   time is printed beside it), its plain version's, one PyTorch call
   computing the same function (``library_ms``, a yardstick the port
   never calls; none for the two recurrences; vecadd and ``torch.add``
   timed in turns), the bound, and the achieved TFLOP/s and share of the
   bound, with its launches on the paths; the sampler at the three served
   vocabularies; the scan and the WKV also at one chunked-prefill call
   (S=32); flash also at
   B=4 S=4096 and at hd 256 S=2500 with window 2048; fused decode also
   at a long
   context (nb=160, lengths up to 2560) at hd 64 16/16 and hd 256 10/1
   with window 2048.

On every path, the launch counters are set to 0 just before it runs and
read just after; each kernel of the path must have launched.
``--profile`` adds a torch.profiler pass over the prefill of four
requests and over steady decode steps, in both serving modes of every
served model (device busy share, top device-time entries and their
shares).

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``src/``, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM memory rate (data sheet)
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
TOL = {"bfloat16": 3e-2, "float32": 2e-5}
# bf16 attention over long spans (ring decode, and the hd-256 / paged
# decode checks): outputs average O(0.03), so a fixed 3e-2 would pass a
# wrong kernel; each element must lie within two bf16 ulps of the plain
# output instead (|err| <= 2^-6 |want| + 1e-5)
BF16_ULP_RTOL, BF16_ULP_ATOL = 2.0 ** -6, 1e-5

KERNELS = {
    "flash_attention": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:76"},
    "fused_paged_decode": {
        "source": "src/repro_torch/kernels/csrc/fused_paged_decode.cu",
        "replaces":
            "src/repro/kernels/decode_attention/decode_attention.py:278"},
    "sample_tokens": {
        "source": "src/repro_torch/kernels/csrc/sample_tokens.cu",
        "replaces":
            "src/repro/kernels/decode_attention/decode_attention.py:368"},
    "decode_attention": {
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces":
            "src/repro/kernels/decode_attention/decode_attention.py:97"},
    "matmul": {
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul/matmul.py:41"},
    "vecadd": {
        "source": "src/repro_torch/kernels/csrc/vecadd.cu",
        "replaces": "src/repro/kernels/vecadd/vecadd.py:23"},
    "sobel": {
        "source": "src/repro_torch/kernels/csrc/sobel.cu",
        "replaces": "src/repro/kernels/sobel/sobel.py:43"},
    "paged_decode_attention": {
        "source": "src/repro_torch/kernels/csrc/fused_paged_decode.cu",
        "replaces":
            "src/repro/kernels/decode_attention/decode_attention.py:181"},
    "rglru_scan": {
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/rglru_scan.py:43"},
    "rwkv6_wkv": {
        "source": "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
        "replaces": "src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py:76"},
}
PATH_KERNELS = {"monolithic": ("flash_attention", "fused_paged_decode"),
                "chunked": ("fused_paged_decode", "sample_tokens"),
                "virtualized-monolithic": ("flash_attention",
                                           "fused_paged_decode"),
                "virtualized-chunked": ("fused_paged_decode",
                                        "sample_tokens"),
                "vmm-programs": ("flash_attention", "decode_attention"),
                "apps": ("matmul", "sobel", "vecadd"),
                "virtualized-apps": ("matmul", "sobel", "vecadd"),
                "recurrentgemma-monolithic": ("rglru_scan", "flash_attention",
                                              "fused_paged_decode"),
                "recurrentgemma-chunked": ("rglru_scan", "fused_paged_decode",
                                           "sample_tokens"),
                "rwkv6-monolithic": ("rwkv6_wkv",),
                "rwkv6-chunked": ("rwkv6_wkv", "sample_tokens")}
#: the recurrent families served at full width: arch, path name, and the
#: depth of the card-vs-CPU reference (one block period)
RECURRENT_ARCHS = (("recurrentgemma-2b", "recurrentgemma", 3),
                   ("rwkv6-7b", "rwkv6", 2))


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def device_ms(fn, reps=50, warmup=5):
    """Device time of one call: the CUPTI durations of every kernel and
    copy the call launches (torch.profiler) over ``reps`` calls, per
    call. Per-call CUDA-event timing would add the host's launch latency
    to kernels this short."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # every call launches the same kernels, but a trace may lose some of
    # their events (49 of 50, once 8 of 20) or all of them: each name
    # counts as its mean recorded duration times its launches per call,
    # and a trace with no device event is taken again
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if rows:
            return sum(t / n * -(-n // reps) for t, n, _ in rows) / 1e3
        log("[time] the trace holds no device event; tracing again")
    raise AssertionError("five traces held no device event")


def device_rows(prof):
    """Device-side events of a profile (kernels, copies) as
    (total µs, count, name), largest first."""
    import torch
    rows = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev = getattr(e, "self_device_time_total", None)
            rows.append((e.self_cuda_time_total if dev is None else dev,
                         e.count, e.key))
    return sorted(rows, reverse=True)


def wall_ms(fn, reps=50, warmup=5):
    """Median per-call time between CUDA events: device time plus any
    launch gap the host leaves."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def timed(fn, reps=50, warmup=5):
    """→ (device ms, event ms) of one call."""
    return (device_ms(fn, reps=reps, warmup=warmup),
            wall_ms(fn, reps=reps, warmup=warmup))


def bound(nbytes, flops, peak):
    """The least time for the work: bytes over the memory rate or
    operations over ``peak``, whichever is longer; the row keeps both
    counts so the printed bound can be recomputed."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": int(nbytes), "bound_flops": int(flops)}


# ---------------------------------------------------------------------------
# phase 1: what was built
# ---------------------------------------------------------------------------

#: the tensor-core instructions each redesigned kernel must contain: wgmma
#: (HGMMA) on tiles loaded by TMA (UTMALDG) in matmul, by cp.async
#: (LDGSTS) in flash
TENSOR_CORE_SASS = {"matmul": ("HGMMA", "UTMALDG"),
                    "flash_attention": ("HGMMA", "LDGSTS")}
#: the sources redesigned for Hopper, whose every kernel gets a line
REDESIGNED = ("matmul", "flash_attention", "fused_paged_decode",
              "decode_attention", "vecadd", "rwkv6_wkv", "sample_tokens",
              "rglru_scan")


def report_build(common):
    """Registers and spills (ptxas ``-v``): each kernel of the redesigned
    sources, a summary of every other source; and the tensor-core
    instructions in the SASS of the tensor-core kernels (a redesigned
    kernel without them fails)."""
    for name in common.sources():
        rows = common.resource_report(name)
        if name in REDESIGNED:
            for entry, regs, st, ld in rows:
                log(f"[ptxas] {name}: {entry}: {regs} registers, spill "
                    f"stores {st} B, spill loads {ld} B")
        elif rows:
            regs = [r[1] for r in rows]
            spilled = [r for r in rows if r[2] or r[3]]
            log(f"[ptxas] {name}: {len(rows)} kernels, {min(regs)}-"
                f"{max(regs)} registers, {len(spilled)} with spills (up to "
                f"{max((r[2] for r in rows), default=0)} B stored)")
    for name, ops in TENSOR_CORE_SASS.items():
        counts = common.sass_counts(name, ops)
        log(f"[sass] {name}: " + ", ".join(f"{op} x{n}"
                                           for op, n in counts.items()))
        if not all(counts.values()):
            raise AssertionError(f"{name}: no {ops} in its SASS")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def _expect(name, what, err, tol):
    ok = err <= tol
    log(f"[kernel] {name} {what}: max_abs_err={err:.3g} tol={tol:g} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {what}: error {err} > {tol}")
    return err


def flash_inputs(S, Hq, Hkv, dtype, device, seed, hd=64, B=1):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda h: torch.randn((B, S, h, hd), generator=g,  # noqa: E731
                               device=device).to(dtype)
    return mk(Hq), mk(Hkv), mk(Hkv)


def decode_inputs(lens, Hq, Hkv, dtype, device, seed, ps=16, nb=16, hd=64):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    B = len(lens)
    P = B * nb + 3
    rn = lambda *s: torch.randn(s, generator=g,  # noqa: E731
                                device=device).to(dtype)
    perm = torch.randperm(P, generator=g, device=device)[:B * nb]
    return {"q": rn(B, 1, Hq, hd), "k_new": rn(B, 1, Hkv, hd),
            "v_new": rn(B, 1, Hkv, hd), "k_pages": rn(P, ps, Hkv, hd),
            "v_pages": rn(P, ps, Hkv, hd),
            "lengths": torch.tensor(lens, dtype=torch.int32, device=device),
            "block_tables": perm.reshape(B, nb).to(torch.int32)}


def poison_masked_rows(d, window=0, new_token=True):
    """NaN into every pool row the slots' lengths (and window) mask; with
    ``new_token`` the row at ``lengths-1`` is masked too (the fused
    kernel takes that token from ``k_new``/``v_new``)."""
    import torch
    P, ps = d["k_pages"].shape[:2]
    live = torch.zeros((P, ps), dtype=torch.bool)
    for b, L in enumerate(d["lengths"].tolist()):
        lo = max(0, L - window) if window else 0
        for t in range(lo, max(L - 1 if new_token else L, 0)):
            live[int(d["block_tables"][b, t // ps]), t % ps] = True
    live = live.to(d["k_pages"].device)
    for kk in ("k_pages", "v_pages"):
        d[kk][~live] = float("nan")


def sampler_inputs(B, V, device, seed):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    logits = torch.randn((B, V), generator=g, device=device) * 3.0
    u = torch.rand((B, V), generator=g, device=device).clamp_min(1e-20)
    temps = torch.tensor([0.0, 0.8, 0.0, 1.5] * -(-B // 4),
                         device=device)[:B]
    return logits, temps, -torch.log(-torch.log(u))


#: rows of :func:`sampler_edge_rows`, one batch
EDGE_ROWS = 16


def sampler_edge_rows(V, share, device):
    """(what, logits, temps, noise) rows at the edges of the order and of
    the sampler's split (``share`` columns a CTA; a column past V wraps
    round to the row's start): the maximum on either
    side of a slice edge and a tie across CTAs; NaN at index 0, at a
    thread's and at a CTA's first column, two NaNs, an all-NaN row, an
    all -inf row, +inf against a NaN on either side; -0.0 before +0.0;
    T = 0 with an infinite noise value (a NaN score)."""
    import torch
    nan, inf = float("nan"), float("inf")
    g = torch.Generator(device=device).manual_seed(V)
    base = torch.randn((V,), generator=g, device=device)
    rows = []

    def row(what, set_, fill=None, temp=0.0, noise=None):
        x = base.clone() if fill is None else torch.full_like(base, fill)
        for i, v in set_:
            x[i % V if isinstance(i, int) else i] = v
        rows.append((what, x, temp, torch.zeros_like(base) if noise is None
                     else noise))

    row("max on a CTA's first column", [(share, 9.0)])
    row("max on a CTA's last column", [(share - 1, 9.0)])
    row("tie across CTAs", [(2 * share, 9.0), (3 * share, 9.0)])
    row("max on the last column", [(V - 1, 9.0)])
    row("NaN at 0", [(0, nan)])
    row("NaN at a thread's first column", [(share + 4 * 37, nan)])
    row("NaN at a CTA's first column", [(3 * share, nan)])
    row("two NaNs", [(5 * share + 1001, nan), (9 * share + 7, nan)])
    row("all NaN", [], fill=nan)
    row("all -inf", [], fill=-inf)
    row("+inf before a NaN", [(10, inf), (share + 6, nan)])
    row("NaN before +inf", [(share - 2, nan), (2 * share, inf)])
    row("-0.0 before +0.0 (zero row)", [(slice(0, share + 5), -0.0)],
        fill=0.0)
    row("-0.0 before +0.0 across CTAs", [(share + 3, -0.0),
                                         (2 * share, 0.0)], fill=-inf)
    noise = torch.zeros_like(base)
    noise[(share + 77) % V] = inf
    noise[(4 * share + 1) % V] = -inf
    row("T=0, +inf and -inf in the noise", [], temp=0.0, noise=noise)
    noise = torch.randn((V,), generator=g, device=device)
    row("T=0.7, a NaN logit", [(7 * share + 3, nan)], temp=0.7,
        noise=noise)
    return rows


def check_sampler(device):
    """The sampler against its plain version (``torch.argmax``) and
    ``np.argmax`` of the same scores on the host, exact: random rows at
    B = 4 and the three served vocabularies (qwen 152064 padded,
    recurrentgemma 256000, rwkv6 65536), at B = 1 and B = 64, at V = 1,
    5, 1000 and 152061 (rows not 16-byte aligned); the edge rows of
    :func:`sampler_edge_rows` at V = 152064 and 152061; the cross-block
    tie of the reference's 2048-wide blocks."""
    import numpy as np
    import torch
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.decode_attention.ops import (
        sample_plan, sample_tokens_op)
    from repro_torch.kernels.decode_attention.ref import sample_tokens_ref

    def compare(what, logits, temps, noise):
        got = sample_tokens_op(logits, temps, noise).cpu().numpy()
        want = sample_tokens_ref(logits, temps, noise).cpu().numpy()
        l, n = logits.cpu().numpy(), noise.cpu().numpy()
        with np.errstate(invalid="ignore"):         # 0 * inf is NaN
            host = np.argmax(l + n * temps.cpu().numpy()[:, None], axis=-1)
        bad = [i for i in range(len(got))
               if not got[i] == want[i] == host[i]]
        B, V = logits.shape
        log(f"[kernel] sample_tokens {what} B={B} V={V} plan="
            f"{sample_plan(B, V, sm_count(device))}: "
            + ("exact ok" if not bad else
               f"FAIL rows {bad[:8]}: kernel {got[bad[:8]].tolist()}, "
               f"plain {want[bad[:8]].tolist()}, np.argmax "
               f"{host[bad[:8]].tolist()}"))
        if bad:
            raise AssertionError(f"sample_tokens {what}: rows {bad}")

    for B, V in ((4, 152064), (4, 256000), (4, 65536), (1, 152064),
                 (64, 152064), (4, 1), (4, 5), (4, 1000), (4, 152061)):
        compare("random", *sampler_inputs(B, V, device, seed=B + V))
    for V in (152064, 152061):
        _, share = sample_plan(EDGE_ROWS, V, sm_count(device))
        rows = sampler_edge_rows(V, share, device)
        assert len(rows) == EDGE_ROWS
        compare("edge rows: " + "; ".join(r[0] for r in rows),
                torch.stack([r[1] for r in rows]),
                torch.tensor([r[2] for r in rows], device=device),
                torch.stack([r[3] for r in rows]))
    tie = torch.zeros((2, 152064), device=device)
    tie[0, [100, 3000]] = 5.0                 # across 2048-wide blocks
    tie[1, [2050, 2051]] = 2.0                # inside one block
    z = torch.zeros((2,), device=device)
    got = sample_tokens_op(tie, z, torch.zeros_like(tie)).tolist()
    log(f"[kernel] sample_tokens ties: {got} (want [100, 2050]) "
        f"{'ok' if got == [100, 2050] else 'FAIL'}")
    if got != [100, 2050]:
        raise AssertionError("sample_tokens tie rule broken")


def check_kernels(device, errs):
    import torch
    from repro_torch.kernels.decode_attention.ops import fused_decode_step_op
    from repro_torch.kernels.decode_attention.ref import fused_paged_decode_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    bf16 = torch.bfloat16
    for S, Hq, Hkv, window, dt in ((40, 16, 16, 0, bf16),
                                   (130, 16, 16, 0, bf16),
                                   (130, 16, 8, 0, bf16),
                                   (130, 8, 1, 0, bf16),
                                   (130, 16, 16, 48, bf16),
                                   (130, 16, 8, 0, torch.float32)):
        q, k, v = flash_inputs(S, Hq, Hkv, dt, device, seed=S + Hkv)
        got = flash_attention_op(q, k, v, causal=True, window=window)
        want = flash_attention_ref(q, k, v, causal=True, window=window)
        dn = str(dt).replace("torch.", "")
        err = _expect("flash_attention",
                      f"B=1 S={S} Hq={Hq} Hkv={Hkv} hd=64 window={window} "
                      f"{dn}", _max_err(got, want), TOL[dn])
        if dt == bf16:
            errs["flash_attention"] = max(errs.get("flash_attention", 0), err)
    # the tensor-core instance's q-tile edges (64 rows a CTA) and the VMM
    # prefill program's shape, each element within two bf16 ulps
    for B, S in ((1, 1), (1, 63), (1, 64), (1, 65), (4, 4096)):
        q, k, v = flash_inputs(S, 16, 16, bf16, device, seed=S, B=B)
        err = _expect_close("flash_attention",
                            f"B={B} S={S} Hq=Hkv=16 hd=64 causal bfloat16",
                            flash_attention_op(q, k, v),
                            flash_attention_ref(q, k, v), BF16_ULP_ATOL,
                            BF16_ULP_RTOL)
        errs["flash_attention"] = max(errs["flash_attention"], err)
        del q, k, v
    check_flash_head_dims(device, errs)

    lens = [37, 0, 129, 256]                  # slot 1 dead; 256 = full table
    for Hq, Hkv, window, dt, nan in ((16, 16, 0, bf16, False),
                                     (16, 8, 0, bf16, False),
                                     (8, 1, 0, bf16, False),
                                     (16, 16, 40, bf16, True),
                                     (16, 16, 0, bf16, True),
                                     (16, 8, 0, torch.float32, False)):
        d = decode_inputs(lens, Hq, Hkv, dt, device, seed=Hq + Hkv + window)
        if nan:
            poison_masked_rows(d, window)
        got = fused_decode_step_op(**d, window=window)
        want = fused_paged_decode_ref(**d, window=window)
        dn = str(dt).replace("torch.", "")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("fused_paged_decode: non-finite output")
        if bool((got[1] != 0).any()):
            raise AssertionError("fused_paged_decode: dead slot not zero")
        err = _expect("fused_paged_decode",
                      f"B=4 Hq={Hq} Hkv={Hkv} hd=64 ps=16 nb=16 lens={lens} "
                      f"window={window} nan_masked={nan} {dn}",
                      _max_err(got, want), TOL[dn])
        if dt == bf16:
            errs["fused_paged_decode"] = max(
                errs.get("fused_paged_decode", 0), err)

    check_sampler(device)
    errs["sample_tokens"] = 0.0
    check_ring_decode(device, errs)
    check_app_kernels(device, errs)
    check_recurrent_kernels(device, errs)
    check_split_edges(device, errs)
    check_one_launch(device)


#: the head dims of the repo's configurations beyond the served ones:
#: phi3-mini's hd 96 (32/32 heads) and kimi-k2's hd 112 (64/8)
EXTRA_HEAD_DIMS = ((96, 32, 32), (112, 64, 8))


def check_flash_head_dims(device, errs):
    """Flash at ``EXTRA_HEAD_DIMS`` (hd padded with zero columns to whole
    64-column tiles in the bf16 instance): S = 1, 65 and 130, causal and
    with window 48; bf16 within two ulps of the plain version, fp32 at
    2e-5."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    for hd, Hq, Hkv in EXTRA_HEAD_DIMS:
        for S, window, dt in itertools.product(
                (1, 65, 130), (0, 48), (torch.bfloat16, torch.float32)):
            q, k, v = flash_inputs(S, Hq, Hkv, dt, device,
                                   seed=S + hd + window, hd=hd)
            got = flash_attention_op(q, k, v, window=window)
            want = flash_attention_ref(q, k, v, window=window)
            dn = str(dt).replace("torch.", "")
            what = (f"B=1 S={S} Hq={Hq} Hkv={Hkv} hd={hd} window={window} "
                    f"{dn}")
            if dt == torch.float32:
                _expect("flash_attention", what, _max_err(got, want),
                        TOL[dn])
            else:
                err = _expect_close("flash_attention", what, got, want,
                                    BF16_ULP_ATOL, BF16_ULP_RTOL)
                errs["flash_attention"] = max(errs["flash_attention"], err)


#: the split walk's edges at nb=16, ps=16 (4 CTAs a (slot, kv head) of
#: 64 tokens at 16/16, 16 CTAs of one page at 12/4 and 16/1): a dead
#: slot, length 1 (the new token only, fewer rows than splits), a full
#: table, lengths ending on a split edge (64; 32 at one page a CTA); with
#: window 40 the full slot's first splits hold no row
SPLIT_EDGE_LENS = ([0, 1, 256, 64], [5, 32, 33, 200])


def _check_decode_case(name, what, got, want, dead):
    """fp32 at 2e-5, bf16 within two ulps, finite, dead slots zero."""
    import torch
    if any(bool((got[b] != 0).any()) for b in dead):
        raise AssertionError(f"{name} {what}: dead slot not zero")
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name} {what}: non-finite output")
    if got.dtype == torch.float32:
        err = _max_err(got, want)
        if err > TOL["float32"]:
            raise AssertionError(f"{name} {what}: error {err} > 2e-5")
        return err
    from repro_torch.launch.apps import max_excess
    err, excess = max_excess(got, want, BF16_ULP_ATOL, BF16_ULP_RTOL)
    if excess > 0:
        raise AssertionError(f"{name} {what}: outside two bf16 ulps "
                             f"(max abs err {err})")
    return err


def _paged_decode_call(d, window):
    """(the kernel's call, the plain output) of the fused decode when
    ``d`` holds the step's new K/V, else of the no-new-token one."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_op, fused_decode_step_op)
    from repro_torch.kernels.decode_attention.ref import (
        fused_paged_decode_ref, paged_decode_attention_ref)
    if "k_new" in d:
        return (lambda: fused_decode_step_op(**d, window=window),
                fused_paged_decode_ref(**d, window=window))
    return (lambda: decode_attention_op(
        d["q"], d["k_pages"], d["v_pages"], d["lengths"], window=window,
        block_tables=d["block_tables"]),
        paged_decode_attention_ref(**d, window=window))


def check_split_edges(device, errs):
    """The fused and the no-new-token paged decode at every head dim and
    at G = 1, 3 and 16 (one query head a channel, several, the most the
    kernels take), at the split walk's edges (``SPLIT_EDGE_LENS``, window
    0 and 40), each on clean pools and with NaN in every masked pool row;
    bf16 within two ulps of the plain version, fp32 at 2e-5; a second
    launch on the same inputs must give the same bits."""
    import itertools

    import torch
    log(f"[kernel] split edges: lens {SPLIT_EDGE_LENS}, window 0 and 40, "
        "nb=16 ps=16, clean and NaN in every masked row; bf16 within two "
        "ulps, fp32 at 2e-5")
    for new, name in ((True, "fused_paged_decode"),
                      (False, "paged_decode_attention")):
        for hd, (Hq, Hkv), dt in itertools.product(
                (16, 32, 64, 96, 112, 128, 256),
                ((16, 16), (12, 4), (16, 1)),
                (torch.bfloat16, torch.float32)):
            worst, runs = 0.0, 0
            for lens, window in itertools.product(SPLIT_EDGE_LENS, (0, 40)):
                d = decode_inputs(lens, Hq, Hkv, dt, device,
                                  seed=hd + Hq + window + lens[0], hd=hd)
                if not new:
                    for kk in ("k_new", "v_new"):
                        d.pop(kk)
                for nan in (False, True):
                    if nan:
                        poison_masked_rows(d, window, new)
                    run, want = _paged_decode_call(d, window)
                    got = run()
                    what = (f"hd={hd} Hq={Hq} Hkv={Hkv} lens={lens} "
                            f"window={window} nan_masked={nan} {dt}")
                    if not torch.equal(got, run()):
                        raise AssertionError(f"{name} {what}: two launches "
                                             "differ")
                    err = _check_decode_case(
                        name, what, got, want,
                        [b for b, L in enumerate(lens) if not L])
                    worst, runs = max(worst, err), runs + 1
            dn = str(dt).replace("torch.", "")
            log(f"[kernel] {name} split edges hd={hd} Hq={Hq} Hkv={Hkv} "
                f"{dn}: {runs} cases ok, max_abs_err={worst:.3g}, "
                "bit-equal reruns")
            if dt == torch.bfloat16:
                errs[name] = max(errs.get(name, 0), worst)


def check_one_launch(device):
    """Each call of the three decode-attention ops, the sampler, the
    RG-LRU scan and the WKV is one launch of its kernel (the wrapper's
    counter and the profiler's kernel count) and makes no host sync
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import common
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_op, fused_decode_step_op, sample_tokens_op)
    from repro_torch.kernels.rglru_scan.ops import rglru_scan_op
    from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv_op
    d = decode_inputs([64, 161, 96, 143], 16, 16, torch.bfloat16, device,
                      seed=4)
    q, k, v = ring_inputs(4, 4096, 16, 16, torch.bfloat16, device, seed=8)
    pos = torch.tensor(5000, dtype=torch.int32, device=device)
    wkv = wkv_inputs(1, 64, 130, 64, device, seed=9)
    sampler = sampler_inputs(4, 152064, device, seed=10)
    scan = rglru_inputs(1, 130, 2560, device, seed=11)
    calls = {
        "sample_tokens": lambda: sample_tokens_op(*sampler),
        "rglru_scan": lambda: rglru_scan_op(*scan),
        "fused_paged_decode": lambda: fused_decode_step_op(**d),
        "paged_decode_attention": lambda: decode_attention_op(
            d["q"], d["k_pages"], d["v_pages"], d["lengths"],
            block_tables=d["block_tables"]),
        "decode_attention": lambda: decode_attention_op(q, k, v, pos),
        "rwkv6_wkv": lambda: rwkv6_wkv_op(*wkv)}
    reps = 20
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        common.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        counted = dict(common.LAUNCHES)
        torch.cuda.synchronize()
        for _ in range(5):                 # a trace may hold no event
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            rows = device_rows(prof)
            if rows:
                break
        events = sum(n for _, n, _ in rows)
        ok = (counted == {name: 1} and len(rows) == 1
              and 1 <= events <= reps)
        log(f"[kernel] {name}: one call = launch counters {counted}, no "
            f"host sync; {reps} calls traced = {events} device events of "
            f"{len(rows)} kernel(s) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: a call is not one launch")
    common.reset_launches()


def ring_inputs(B, C, Hq, Hkv, dtype, device, seed, hd=64):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g,  # noqa: E731
                                device=device).to(dtype)
    return rn(B, 1, Hq, hd), rn(B, C, Hkv, hd), rn(B, C, Hkv, hd)


#: ring cases at C=4096 (4, 8 or 16 CTAs a (slot, kv head) by shape:
#: shares of 1024, 512 or 256 logical rows): (pos, window, pos on the
#: device). The first three are the original checks (partly filled,
#: wrapped, a window over a wrapped ring); then fewer valid slots than
#: splits (pos 2), a valid run that wraps inside a share (start 105) and
#: on a split edge (start 3072: row 1024), a window that empties all but
#: the first share or two, and a full ring
RING_CASES = ((100, 0, False), (4200, 0, True), (4200, 64, False),
              (2, 0, True), (7167, 0, False), (5000, 600, True),
              (5000, 0, False))
#: (Hq, Hkv, hd, window override): the original shapes, recurrentgemma's
#: hd 256 MQA with window 2048, and the rest of the kernel's coverage
RING_SHAPES = ((16, 16, 64, None), (16, 8, 64, None), (8, 1, 64, None),
               (10, 1, 256, 2048), (16, 1, 128, None), (12, 4, 32, None),
               (16, 16, 16, None), (32, 32, 96, None), (64, 8, 112, 600))


def check_ring_decode(device, errs):
    """Ring-cache decode at C=4096 (``RING_CASES`` at every shape of
    ``RING_SHAPES``), each on clean caches and with NaN in every invalid
    slot, ``pos`` as an int and as a device int32 (read by the kernel, no
    host sync); bf16 within two ulps of the plain version, fp32 at 2e-5;
    a second launch on the same inputs must give the same bits."""
    import torch
    from repro_torch.kernels.decode_attention.ops import decode_attention_op
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, ring_valid)
    B, C = 4, 4096
    for Hq, Hkv, hd, wfix in RING_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            worst, runs = 0.0, 0
            cases = RING_CASES + (((1500, wfix, True), (5000, wfix, False))
                                  if wfix else ())
            for pos, window, on_dev in cases:
                q, k, v = ring_inputs(B, C, Hq, Hkv, dt, device,
                                      seed=Hq + Hkv + pos + window, hd=hd)
                p = (torch.tensor(pos, dtype=torch.int32, device=device)
                     if on_dev else pos)
                want = decode_attention_ref(q, k, v, pos, window=window)
                for nan in (False, True):
                    if nan:
                        bad = ~ring_valid(C, pos, window, device)
                        k[:, bad] = float("nan")
                        v[:, bad] = float("nan")
                    got = decode_attention_op(q, k, v, p, window=window)
                    what = (f"B={B} C={C} Hq={Hq} Hkv={Hkv} hd={hd} "
                            f"pos={pos}{' (device)' if on_dev else ''} "
                            f"window={window} nan_invalid={nan} {dt}")
                    if not torch.equal(got, decode_attention_op(
                            q, k, v, p, window=window)):
                        raise AssertionError(f"decode_attention {what}: "
                                             "two launches differ")
                    err = _check_decode_case("decode_attention", what, got,
                                             want, [])
                    worst, runs = max(worst, err), runs + 1
            dn = str(dt).replace("torch.", "")
            log(f"[kernel] decode_attention B={B} C={C} Hq={Hq} Hkv={Hkv} "
                f"hd={hd} {dn}: {runs} cases ok (pos, window "
                f"{[c[:2] for c in cases]}; clean and NaN in invalid "
                f"slots), max_abs_err={worst:.3g}, bit-equal reruns")
            if dt == torch.bfloat16:
                errs["decode_attention"] = max(
                    errs.get("decode_attention", 0), worst)


def _expect_close(name, what, got, want, atol, rtol):
    """The reference tests' ``assert_allclose(atol, rtol)`` rule, each
    element, and a finite output; returns the max absolute error."""
    import torch
    from repro_torch.launch.apps import max_excess
    err, excess = max_excess(got, want, atol, rtol)
    ok = excess <= 0 and bool(torch.isfinite(got.float()).all())
    log(f"[kernel] {name} {what}: max_abs_err={err:.3g} atol={atol:.3g} "
        f"rtol={rtol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {what}: outside atol {atol} rtol "
                             f"{rtol}")
    return err


def check_app_kernels(device, errs):
    """The paper's three apps: matmul at ragged and card shapes (fp32 at
    1e-5·√k abs / 1e-5 rel, bf16 at 2e-1·√k / 2e-1, the reference test's
    rule), Sobel at 1e-4, vecadd exactly (also from a misaligned start,
    which takes the scalar path)."""
    import torch
    from repro_torch.kernels.matmul.ops import matmul_op
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.sobel.ops import sobel_op
    from repro_torch.kernels.sobel.ref import sobel_ref
    from repro_torch.kernels.vecadd.ops import vecadd_op
    from repro_torch.kernels.vecadd.ref import vecadd_ref
    g = torch.Generator(device=device).manual_seed(21)
    rn = lambda *s: torch.randn(s, generator=g, device=device)  # noqa: E731
    # (129, 4104, 257) pads N for TMA; K = 1000 is not a multiple of the
    # 64-wide K step, M and N not of the 128 x 256 tile
    for m, k, n, dts in ((33, 17, 9, None), (100, 300, 50, None),
                         (256, 256, 256, None), (1000, 1000, 1000, None),
                         (129, 4104, 257, (torch.bfloat16,)),
                         (4096, 4096, 4096, None)):
        for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-1)):
            if dts is not None and dt not in dts:
                continue
            a, b = rn(m, k).to(dt), rn(k, n).to(dt)
            err = _expect_close("matmul", f"({m},{k})@({k},{n}) "
                                f"{str(dt)[6:]}", matmul_op(a, b),
                                matmul_ref(a, b), tol * k ** 0.5, tol)
            errs["matmul"] = max(errs.get("matmul", 0), err)
    for h, w in ((100, 180), (256, 256), (4096, 4096)):
        x = rn(h, w)
        err = _expect_close("sobel", f"({h},{w}) float32", sobel_op(x),
                            sobel_ref(x), 1e-4, 1e-4)
        errs["sobel"] = max(errs.get("sobel", 0), err)
    for n in (128, 50000, 1 << 26):
        for dt in (torch.float32, torch.bfloat16):
            x, y = rn(n + 1).to(dt), rn(n + 1).to(dt)
            for off in ((0, 1) if n == 50000 else (0,)):
                xs, ys = x[off:off + n], y[off:off + n]
                got, want = vecadd_op(xs, ys), vecadd_ref(xs, ys)
                mism = int((got != want).sum())
                log(f"[kernel] vecadd n={n} offset={off} {str(dt)[6:]}: "
                    f"{mism} mismatches (exact match required) "
                    f"{'ok' if mism == 0 else 'FAIL'}")
                if mism:
                    raise AssertionError("vecadd differs from x + y")
    errs["vecadd"] = 0.0


def rglru_inputs(B, S, D, device, seed):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.rand((B, S, D), generator=g, device=device) * 0.499 + 0.5
    b = torch.randn((B, S, D), generator=g, device=device)
    return a, b, torch.randn((B, D), generator=g, device=device)


def wkv_inputs(B, H, S, K, device, seed):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=device)  # noqa: E731
    return (rn(B, H, S, K), rn(B, H, S, K), rn(B, H, S, K),
            -torch.exp(rn(B, H, S, K)), rn(H, K), rn(B, H, K, K))


def cu_constant(kernel, name):
    """The value of ``constexpr int <name> = <value>;`` in
    ``csrc/<kernel>.cu``: a geometry the kernel alone owns."""
    import re
    from repro_torch.kernels.common import CSRC
    text = (CSRC / f"{kernel}.cu").read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    if len(found) != 1:
        raise AssertionError(f"{kernel}.cu: no single constant {name}")
    return int(found[0])


def check_scan(device):
    """The RG-LRU scan bit-equal to its plain version (the serial order is
    kept): S = 1 and 2; the prefill (1, 130, 2560), the chunked-prefill
    call (1, 32, 2560) and B=4 S=4096; a ragged D (300 = 18 tiles of 16
    and a part, at B = 2 and 16), 20 (a tile and a part), D below one
    tile (12, and 7: 4-byte copies), D % 4 != 0 (301) and a misaligned
    base (4-byte copies); S on the stage edges (steps - 1, steps, steps
    + 1) and on the ring's wrap (steps x ring - 1, steps x ring, steps x
    ring + 1), with the tile, steps and ring read from the kernel's
    source."""
    import torch
    from repro_torch.kernels.rglru_scan.ops import rglru_scan_op
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    tile, T, stages = (cu_constant("rglru_scan", n)
                       for n in ("TILE", "STEPS", "STAGES"))
    ring = T * stages
    shapes = [(1, 1, 2560), (2, 2, 2560), (1, 130, 2560), (1, 32, 2560),
              (4, 4096, 2560), (2, 100, 300), (16, 45, 300), (2, 70, 20),
              (2, 70, 12), (3, 45, 7), (2, 70, 301), (16, 45, 301)]
    shapes += [(B, S, 300) for B in (2, 16) for S in (T - 1, T, T + 1,
                                                      ring - 1, ring,
                                                      ring + 1)]
    cases = [(f"B={B} S={S} D={D}", rglru_inputs(B, S, D, device,
                                                   seed=S + D))
             for B, S, D in shapes]
    a, b, h0 = rglru_inputs(1, 130, 2560, device, seed=9)
    buf = torch.empty(2 * a.numel() + 1, device=device)
    am, bm = buf[1:1 + a.numel()].view_as(a), buf[1 + a.numel():].view_as(b)
    am.copy_(a)
    bm.copy_(b)
    cases.append(("B=1 S=130 D=2560, a and b 4 bytes off 16", (am, bm, h0)))
    for what, (a, b, h0) in cases:
        got, want = rglru_scan_op(a, b, h0), rglru_scan_ref(a, b, h0)
        same = torch.equal(got, want)
        log(f"[kernel] rglru_scan {what} float32, tile {tile} steps {T} "
            f"ring {stages}: {'bit-equal ok' if same else 'FAIL'} "
            f"(max_abs_err={_max_err(got, want):.3g})")
        if not same:
            raise AssertionError(f"rglru_scan {what}: not bit-equal")


#: (B, H, S, K) of the WKV checks: ragged tails at every K the kernel
#: takes besides 64, rwkv6-7b's prefill (S = 130) and chunked-prefill
#: call (S = 32), B=4
WKV_SHAPES = ((1, 3, 45, 16), (2, 2, 70, 32), (1, 3, 45, 48),
              (1, 2, 70, 80), (1, 3, 77, 96), (1, 4, 130, 112),
              (1, 4, 130, 128), (1, 64, 32, 64), (1, 64, 130, 64),
              (4, 64, 4096, 64))


def check_recurrent_kernels(device, errs):
    """The recurrent families' kernels and the attention kernels at their
    shapes: the RG-LRU scan (fp32, tol 2e-5) at a ragged shape, the
    serving shape and B=4 S=4096; the RWKV-6 WKV (fp32, atol = rtol =
    2e-3: the summation order differs) likewise, plus an extreme decay
    whose carried state must vanish exactly; the no-new-token paged
    decode with a dead slot and NaN-poisoned rows; flash and fused
    decode at hd=256, Hq/Hkv 10/1 with windows. Every bf16 output here
    lies within two bf16 ulps of its plain version (``BF16_ULP_*``)."""
    import torch
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_op, fused_decode_step_op)
    from repro_torch.kernels.decode_attention.ref import (
        fused_paged_decode_ref, paged_decode_attention_ref)
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv_op
    from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref

    check_scan(device)
    errs["rglru_scan"] = 0.0

    # the chunked kernel: ragged tails, every K from 16 to 128, the serving
    # shapes (monolithic 130, one chunked-prefill call of 32) and B=4
    for B, H, S, K in WKV_SHAPES:
        ins = wkv_inputs(B, H, S, K, device, seed=S + K)
        o, sf = rwkv6_wkv_op(*ins)
        o_ref, sf_ref = rwkv6_wkv_ref(*ins)
        what = f"B={B} H={H} S={S} K={K} float32"
        err = max(_expect_close("rwkv6_wkv", what + " o", o, o_ref, 2e-3,
                                2e-3),
                  _expect_close("rwkv6_wkv", what + " s_final", sf, sf_ref,
                                2e-3, 2e-3))
        errs["rwkv6_wkv"] = max(errs.get("rwkv6_wkv", 0), err)
    # extreme decay: exp(-50) per step underflows the carried state to 0
    one = torch.ones((1, 1, 64, 32), device=device)
    o, sf = rwkv6_wkv_op(one, torch.zeros_like(one), one,
                         torch.full_like(one, -50.0),
                         torch.zeros((1, 32), device=device),
                         torch.full((1, 1, 32, 32), 1e3, device=device))
    gone = bool((o[:, :, 3:] == 0).all()) and bool((sf == 0).all())
    finite = bool(torch.isfinite(o).all()) and bool(torch.isfinite(sf).all())
    log(f"[kernel] rwkv6_wkv logw=-50, s0=1e3, k=0: finite={finite}, "
        f"state contributes exactly 0 from step 3 on: {gone} "
        f"{'ok' if finite and gone else 'FAIL'}")
    if not (finite and gone):
        raise AssertionError("rwkv6_wkv: extreme decay not safe")
    # one chunk mixing decays of -50 (a factor e^-50 a token) with ~-1e-3
    # channel by channel and token by token
    for K in (64, 128):
        r, k, v, _, u, s0 = wkv_inputs(2, 3, 77, K, device, seed=K)
        fast = torch.rand(r.shape, generator=torch.Generator(
            device=device).manual_seed(K), device=device) < 0.5
        logw = torch.where(fast, torch.full_like(r, -50.0),
                           torch.full_like(r, -1e-3))
        o, sf = rwkv6_wkv_op(r, k, v, logw, u, s0)
        o_ref, sf_ref = rwkv6_wkv_ref(r, k, v, logw, u, s0)
        what = f"B=2 H=3 S=77 K={K} logw mixed -50 / -1e-3 float32"
        err = max(_expect_close("rwkv6_wkv", what + " o", o, o_ref, 2e-3,
                                2e-3),
                  _expect_close("rwkv6_wkv", what + " s_final", sf, sf_ref,
                                2e-3, 2e-3))
        errs["rwkv6_wkv"] = max(errs["rwkv6_wkv"], err)

    lens = [37, 0, 129, 256]                  # slot 1 dead; 256 = full table
    for Hq, Hkv, hd, window, dt in ((16, 16, 64, 0, torch.bfloat16),
                                    (16, 8, 64, 40, torch.bfloat16),
                                    (10, 1, 256, 100, torch.bfloat16),
                                    (16, 8, 64, 0, torch.float32)):
        d = decode_inputs(lens, Hq, Hkv, dt, device, seed=Hq + hd + window,
                          hd=hd)
        for kk in ("k_new", "v_new"):
            d.pop(kk)
        poison_masked_rows(d, window, new_token=False)
        got = decode_attention_op(d["q"], d["k_pages"], d["v_pages"],
                                  d["lengths"], window=window,
                                  block_tables=d["block_tables"])
        want = paged_decode_attention_ref(**d, window=window)
        if not bool(torch.isfinite(got).all()) or bool((got[1] != 0).any()):
            raise AssertionError("paged_decode_attention: non-finite output "
                                 "or dead slot not zero")
        dn = str(dt).replace("torch.", "")
        what = (f"B=4 Hq={Hq} Hkv={Hkv} hd={hd} ps=16 nb=16 lens={lens} "
                f"window={window} nan_masked=True {dn}")
        if dt != torch.bfloat16:
            _expect("paged_decode_attention", what, _max_err(got, want),
                    TOL[dn])
        else:
            err = _expect_close("paged_decode_attention", what, got, want,
                                BF16_ULP_ATOL, BF16_ULP_RTOL)
            errs["paged_decode_attention"] = max(
                errs.get("paged_decode_attention", 0), err)

    # recurrentgemma's attention: hd=256, MQA 10/1, window 2048
    for S, window in ((130, 2048), (130, 48), (2500, 2048)):
        q, k, v = flash_inputs(S, 10, 1, torch.bfloat16, device, seed=S,
                               hd=256)
        err = _expect_close("flash_attention",
                            f"B=1 S={S} Hq=10 Hkv=1 hd=256 window={window} "
                            "bfloat16", flash_attention_op(q, k, v,
                                                           window=window),
                            flash_attention_ref(q, k, v, window=window),
                            BF16_ULP_ATOL, BF16_ULP_RTOL)
        errs["flash_attention"] = max(errs["flash_attention"], err)
    for lens, nb, window in (([37, 0, 129, 256], 16, 2048),
                             ([2500, 0, 2100, 700], 160, 2048)):
        d = decode_inputs(lens, 10, 1, torch.bfloat16, device, seed=nb,
                          nb=nb, hd=256)
        poison_masked_rows(d, window)
        got = fused_decode_step_op(**d, window=window)
        want = fused_paged_decode_ref(**d, window=window)
        if not bool(torch.isfinite(got).all()) or bool((got[1] != 0).any()):
            raise AssertionError("fused_paged_decode: non-finite output or "
                                 "dead slot not zero")
        err = _expect_close("fused_paged_decode",
                            f"B=4 Hq=10 Hkv=1 hd=256 ps=16 nb={nb} "
                            f"lens={lens} window={window} nan_masked=True "
                            "bfloat16", got, want, BF16_ULP_ATOL,
                            BF16_ULP_RTOL)
        errs["fused_paged_decode"] = max(errs["fused_paged_decode"], err)


# ---------------------------------------------------------------------------
# phases 3-4: serve at full width
# ---------------------------------------------------------------------------

def make_requests(vocab, n=8, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = [32, 130, 47, 96, 64, 129, 33, 80][:n]
    return [(rng.integers(0, vocab, (L,)), 32, (0.0, 0.8)[i % 2])
            for i, L in enumerate(lens)]


def serve(cfg, model, params, requests, chunk_tokens, batch=4,
          capacity=256, page_size=16, obs=None, engine_kw=None):
    from repro_torch.serving import ServeEngine
    eng = ServeEngine(cfg, model, batch, capacity, page_size=page_size,
                      chunk_tokens=chunk_tokens, obs=obs, obs_tenant="smoke",
                      **(engine_kw or {}))
    rids = [eng.submit(p, max_new_tokens=n, temperature=t)
            for p, n, t in requests]
    steps = []       # host clock; every step ends in a device→host copy
    t0 = time.perf_counter()
    while eng.has_work():
        t = time.perf_counter()
        eng.step(params)
        steps.append(time.perf_counter() - t)
    wall = time.perf_counter() - t0
    return eng, [eng.completed[r].out_tokens for r in rids], wall, steps


def serve_phase(mode, cfg, model, params, requests, launches, path=None,
                engine_kw=None):
    """Serve ``requests`` natively in ``mode`` after a two-request
    warm-up; the launches of the timed run are held to ``path``'s
    kernels (default: the mode's)."""
    from repro_torch.kernels import common
    from repro_torch.obs import ObsHub
    path = path or mode
    chunk = 32 if mode == "chunked" else 0
    serve(cfg, model, params, requests[:2], chunk,
          engine_kw=engine_kw)                             # warm-up run
    obs = ObsHub(enabled=True)
    common.reset_launches()
    eng, outs, wall, steps = serve(cfg, model, params, requests, chunk,
                                   obs=obs, engine_kw=engine_kw)
    counts = dict(common.LAUNCHES)
    s = eng.stats
    log(f"[serve:{path}] {s.completed} requests, {s.generated_tokens} "
        f"tokens in {wall:.3f}s; {s.steps} steps, {s.prefills} prefills "
        f"(full_prefills={s.full_prefills}, chunks={s.prefill_chunks}), "
        f"{s.page_faults} page faults, pages leased={s.pages_leased} "
        f"freed={s.pages_freed}, state pages leased="
        f"{s.state_pages_leased} freed={s.state_pages_freed}; "
        f"launches={counts}")
    if s.completed != len(requests) or any(
            len(o) != n for o, (_, n, _) in zip(outs, requests)):
        raise AssertionError(f"{path}: not every request finished")
    if s.full_prefills != 0 or s.pages_leased != s.pages_freed \
            or s.state_pages_leased != s.state_pages_freed:
        raise AssertionError(f"{path}: paging invariants broken")
    if any(not 0 <= t < cfg.vocab for o in outs for t in o):
        raise AssertionError(f"{path}: token id out of range")
    count_path(path, counts, launches)
    ten = obs.tracer.snapshot()["tenants"]["smoke"]
    return {"ttft_p50_ms": 1e3 * ten["ttft_s"]["p50"],
            "ttft_p95_ms": 1e3 * ten["ttft_s"]["p95"],
            "queue_p50_ms": 1e3 * ten["queue_wait_s"]["p50"],
            "tok_s": s.generated_tokens / wall,
            "step_p50_ms": 1e3 * statistics.median(steps),
            "outs": outs}


def cpu_tree(tree):
    """A copy on the CPU of a tree (dicts, lists) of tensors."""
    if isinstance(tree, dict):
        return {k: cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cpu_tree(v) for v in tree]
    return tree.cpu()


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def count_path(path, counts, launches):
    """Every kernel of ``path`` must have launched in its run; add its
    counts to the totals of the kernels JSON line."""
    for k in PATH_KERNELS[path]:
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"{path}: kernel {k} never launched")
        launches[k] = launches.get(k, 0) + counts[k]


def virtualized_phase(mode, policy, cfg, model, params, requests, native,
                      launches):
    """The native phase's requests through a VMM tenant (one 1×1 slice of
    the card, pool sized from the card): every step via
    ``tenant.device.run``, KV pages from the tenant's MMU pool, the
    pool-pressure admission gate. Token ids must equal the native run's
    unless the engine says why (deferred admissions)."""
    import torch
    from repro_torch.kernels import common
    from repro_torch.launch.serve import virtual_server, virtualized_engine_kw
    device = model.device
    vmm, tenant = virtual_server(device, policy)
    try:
        chunk = 32 if mode == "chunked" else 0
        common.reset_launches()
        eng, outs, wall, steps = serve(
            cfg, model, params, requests, chunk,
            engine_kw=virtualized_engine_kw(tenant))
        counts = dict(common.LAUNCHES)
        st = vmm.stats()
    finally:
        vmm.shutdown()
    s = eng.stats
    sched = st["scheduler"]["tenants"]["server"]
    path = f"virtualized-{mode}"
    log(f"[{path}] policy={policy}: {s.completed} requests, "
        f"{s.generated_tokens} tokens in {wall:.3f}s; {s.steps} steps, "
        f"full_prefills={s.full_prefills}, pages leased={s.pages_leased} "
        f"freed={s.pages_freed}, deferred={s.deferred}; pool "
        f"{st['memory']['server']['segments_total']} segments; scheduler "
        f"submitted={sched['submitted']} failed={sched['failed']}; "
        f"crc_failures={st['crc_failures']}, oplog_records="
        f"{st['oplog_records']}; launches={counts}")
    if s.full_prefills != 0 or s.pages_leased != s.pages_freed:
        raise AssertionError(f"{path}: paging invariants broken")
    if sched["failed"] != 0 or st["crc_failures"] != 0:
        raise AssertionError(f"{path}: scheduler failures or CRC failures")
    if st["oplog_records"] < s.steps:
        raise AssertionError(f"{path}: op log missed steps")
    if s.completed != len(requests):
        raise AssertionError(f"{path}: not every request finished")
    same = outs == native
    log(f"[{path}] token ids vs native {mode}: "
        f"{'identical' if same else 'DIFFER'}"
        + ("" if same else f" (deferred={s.deferred})"))
    if not same and s.deferred == 0:
        raise AssertionError(f"{path}: tokens differ from native with no "
                             "deferred admission to explain it")
    count_path(path, counts, launches)
    del eng
    torch.cuda.empty_cache()
    return {"tok_s": s.generated_tokens / wall,
            "step_p50_ms": 1e3 * statistics.median(steps)}


def program_params(abstract, cfg, device, seed):
    """Random weights (``Model.init`` from ``seed``) in the shapes and
    dtypes of a program's abstract parameters."""
    import torch
    from repro_torch.models import Model
    gen = torch.Generator(device=device).manual_seed(seed)

    def cast(p, a):
        if isinstance(a, dict):
            return {k: cast(p[k], a[k]) for k in a}
        if isinstance(a, list):
            return [cast(x, y) for x, y in zip(p, a)]
        if p.shape != a.shape:
            raise AssertionError(f"weights {tuple(p.shape)} vs program "
                                 f"{tuple(a.shape)}")
        return p.to(a.dtype)
    return cast(Model(cfg, device).init(gen), abstract)


def vmm_programs_phase(device, launches, S=4096, B=4, n_decode=32):
    """The VMM's own programs at full width through the guest API: a
    prefill program with ring caches of capacity S, then a decode program
    of the same capacity stepping at pos S … S+n_decode-1 (a full ring
    that wraps). Also: a warm reprogram, and the cross-slice reprogram
    attack refused on the card."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import VMM, LegalityError, ProgramRequest
    from repro_torch.kernels import common
    from repro_torch.launch.serve import virtual_server
    cfg = get_config("qwen1.5-0.5b")
    vmm, tenant = virtual_server(device, "hybrid")
    try:
        dev = tenant.device
        t0 = time.perf_counter()
        prog = dev.reprogram(ProgramRequest("qwen1.5-0.5b", "prefill", S, B,
                                            reduced=False))
        t_pf = time.perf_counter() - t0
        params = program_params(prog.bitfile.abstract_args[0], cfg, device,
                                5)
        gen = torch.Generator(device=device).manual_seed(6)
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                               device=device, dtype=torch.int32)
        common.reset_launches()
        logits, caches = dev.run(params, {"tokens": tokens})
        sync(device)
        counts = dict(common.LAUNCHES)
        t0 = time.perf_counter()
        req_d = ProgramRequest("qwen1.5-0.5b", "decode", S, B, reduced=False)
        dev.reprogram(req_d)
        t_dc = time.perf_counter() - t0
        want = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)
        if tuple(caches["k"].shape) != want:
            raise AssertionError(f"prefill caches {tuple(caches['k'].shape)}")
        tok = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)[:, None]
        common.reset_launches()
        t0 = time.perf_counter()
        for i in range(n_decode):
            pos = torch.tensor(S + i, dtype=torch.int32, device=device)
            logits, caches = dev.run(params, caches, tok, pos)
            tok = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)[:, None]
        sync(device)
        t_steps = time.perf_counter() - t0
        dcounts = dict(common.LAUNCHES)
        for k, v in dcounts.items():
            counts[k] = counts.get(k, 0) + v
        if not bool(torch.isfinite(logits.float()).all()) or \
                logits.shape != (B, cfg.padded_vocab):
            raise AssertionError("decode program logits malformed")
        per_step = dcounts.get("decode_attention", 0) / n_decode
        log(f"[vmm-programs] prefill program B={B} S={S} (reprogram "
            f"{t_pf:.2f}s), decode program C={S} (reprogram {t_dc:.2f}s): "
            f"{n_decode} greedy steps at pos {S}..{S + n_decode - 1} in "
            f"{t_steps:.3f}s ({1e3 * t_steps / n_decode:.1f} ms/step); "
            f"decode_attention launches per step {per_step:g} (want 24); "
            f"launches={counts}")
        if per_step != 24:
            raise AssertionError("decode_attention must launch once per "
                                 "layer per step")
        dev.reprogram(req_d)
        st = vmm.stats()
        log(f"[vmm-programs] warm reprogram: compile_hits="
            f"{st['compile_hits']} misses={st['compile_misses']} "
            f"reconfigs={st['reconfigs']} crc_checks={st['crc_checks']}")
        if st["compile_hits"] != 1:
            raise AssertionError("second reprogram was not a warm hit")
        count_path("vmm-programs", counts, launches)
    finally:
        vmm.shutdown()
    del params, caches, logits
    torch.cuda.empty_cache()

    # the paper's attack: VM0's bitfile flashed into VM1's slice
    grid = np.empty((1, 2), dtype=object)
    grid[0, :] = [device, device]
    vmm = VMM(grid, policy="hybrid",
              hbm_per_chip=None if device.type == "cuda" else 1 << 30)
    try:
        a = vmm.create_vm("vm0", (1, 1))
        b = vmm.create_vm("vm1", (1, 1))
        bf = vmm.compiler.compile(ProgramRequest("qwen1.5-0.5b", "decode",
                                                 64, 1), a.vslice)
        try:
            b.device.reprogram(bf)
        except LegalityError as exc:
            log(f"[vmm-programs] cross-slice reprogram refused: {exc}; "
                f"violations={vmm.auditor.summary()}")
        else:
            raise AssertionError("cross-slice reprogram was accepted")
    finally:
        vmm.shutdown()


def program_reference_phase(device):
    """The step builders on the card against the CPU plain path: the
    full-width fp32-compute first decode step's logits (B=1, 32-token
    prompt), and reduced-config greedy decode token ids over a ring that
    wraps."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.parallel.steps import build_decode, build_prefill
    cpu = torch.device("cpu")

    def both(cfg, C, B, params_seed):
        out = {}
        for d in (device, cpu):
            pf, pa = build_prefill(cfg, d, ShapeCell("c", C, B, "prefill"))
            dc, _ = build_decode(cfg, d, ShapeCell("c", C, B, "decode"))
            out[d.type] = (pf, dc)
        params = program_params(pa[0], cfg, device, params_seed)
        return out, params, cpu_tree(params)

    # full width, fp32 compute: first decode step's logits
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"),
                              compute_dtype="float32")
    progs, p_dev, p_cpu = both(cfg, 64, 1, 9)
    toks = make_requests(cfg.vocab, 1, seed=4)[0][0][:32]
    tok = torch.from_numpy(toks[None]).to(torch.int32)
    res = {}
    for d, p in ((device, p_dev), (cpu, p_cpu)):
        pf, dc = progs[d.type]
        lg, caches = pf(p, {"tokens": tok.to(d)})
        nxt = torch.tensor([[int(lg[0, :cfg.vocab].argmax())]],
                           dtype=torch.int32, device=d)
        res[d.type] = (nxt, dc, caches)
    nxt = res[device.type][0]              # the card's token feeds both
    got = res[device.type][1](p_dev, res[device.type][2], nxt, 32)[0]
    want = res["cpu"][1](p_cpu, res["cpu"][2], nxt.cpu(), 32)[0]
    got, want = got[:, :cfg.vocab].float().cpu(), want[:, :cfg.vocab]
    err = _max_err(got, want)
    log(f"[program-reference] full-width fp32 decode-program logits (B=1, "
        f"32-token prompt, C=64) card vs CPU: max_abs_err={err:.3g} (max "
        f"|logit| {float(want.abs().max()):.3g}, tol 1e-3) "
        f"{'ok' if err <= 1e-3 else 'FAIL'}")
    if err > 1e-3 or not bool(torch.isfinite(got).all()):
        raise AssertionError("card and CPU decode-program logits disagree")
    del p_dev, res, progs
    torch.cuda.empty_cache()

    # reduced config, fp32: greedy ids over a ring of 16 slots that wraps
    rcfg = dataclasses.replace(get_config("qwen1.5-0.5b", reduced=True),
                               compute_dtype="float32")
    progs, p_dev, p_cpu = both(rcfg, 16, 2, 13)
    prompt = torch.from_numpy(np.stack(
        [r[0][:12] for r in make_requests(rcfg.vocab, 2, seed=6)])).to(
        torch.int32)
    ids = {}
    for d, p in ((device, p_dev), (cpu, p_cpu)):
        pf, dc = progs[d.type]
        lg, caches = pf(p, {"tokens": prompt.to(d)})
        tok = lg[:, :rcfg.vocab].argmax(-1).to(torch.int32)[:, None]
        seq = []
        for pos in range(12, 12 + 24):
            lg, caches = dc(p, caches, tok, pos)
            tok = lg[:, :rcfg.vocab].argmax(-1).to(torch.int32)[:, None]
            seq.append(tok[:, 0].tolist())
        ids[d.type] = seq
    same = ids[device.type] == ids["cpu"]
    log(f"[program-reference] reduced decode program, C=16, 24 greedy steps "
        f"at pos 12..35 (wraps), token ids card vs CPU: "
        f"{'identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"decode ids differ: {ids}")


def apps_phase(device, launches):
    """The paper's three apps, native and through three bound tenants, at
    the reference benchmark's size and at the card's. ``apps.run`` counts
    each arm's launches apart, so the native calls and the guest calls
    through the tenants are each held to have launched every kernel."""
    from repro_torch.kernels import common
    from repro_torch.launch import apps
    out = {}
    arms = {"native": {}, "virtualized": {}}
    for size in ("fig6a", "card"):
        common.reset_launches()
        out[size] = apps.run(device, size, log=log)
        for arm, counts in out[size]["launches"].items():
            for k, n in counts.items():
                arms[arm][k] = arms[arm].get(k, 0) + n
    log(f"[apps] launches native={arms['native']} "
        f"virtualized={arms['virtualized']}")
    count_path("apps", arms["native"], launches)
    count_path("virtualized-apps", arms["virtualized"], launches)
    return out


def log_profile(name, what, prof, wall_us, top=12):
    """Device busy time and idle share of a profiled window, and its top
    device-time entries with their share of the busy time."""
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    log(f"[profile:{name}] {what}: wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.3f}")
    for dev, count, key in rows[:top]:
        log(f"[profile:{name}]   {dev / 1e3:9.3f} ms  x{count:<5d} "
            f"{100 * dev / busy:5.1f}%  {key[:80]}")


def profile_phase(mode, cfg, model, params, requests, n_steps=8,
                  name=None, engine_kw=None):
    """torch.profiler over the admission and prefill of four requests,
    then over ``n_steps`` steady decode steps (every slot decoding, no
    admission in the window): device busy share and the top device-time
    entries of each window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import ServeEngine
    name = name or mode
    eng = ServeEngine(cfg, model, 4, 256, page_size=16,
                      chunk_tokens=32 if mode == "chunked" else 0,
                      **(engine_kw or {}))
    for p, _, t in requests[:4]:
        eng.submit(p, max_new_tokens=n_steps + 16, temperature=t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = 0
        while (eng.positions < 0).any() or eng.waiting:
            eng.step(params)              # admit and prefill all four
            steps += 1
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    log_profile(name, f"admission and prefill of 4 requests ({steps} "
                "steps)", prof, wall_us)
    eng.step(params)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step(params)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    log_profile(name, f"{n_steps} decode steps, B=4 "
                f"({wall_us / 1e3 / n_steps:.3f} ms/step)", prof, wall_us)


# ---------------------------------------------------------------------------
# phase 5: the card against the plain path on the CPU
# ---------------------------------------------------------------------------

def reference_phase(device):
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    # full width, fp32 compute: prefill logits card vs CPU
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"),
                              compute_dtype="float32")
    m_dev, m_cpu = Model(cfg, device), Model(cfg, "cpu")
    params = m_dev.init(torch.Generator(device=device).manual_seed(7))
    toks = make_requests(cfg.vocab, 1, seed=3)[0][0][:40]
    tok = torch.from_numpy(toks[None]).long()
    got, _ = m_dev.prefill(params, {"tokens": tok.to(device)})
    want, _ = m_cpu.prefill(cpu_tree(params), {"tokens": tok})
    got = got[:, :cfg.vocab].cpu()
    want = want[:, :cfg.vocab]
    if not bool(torch.isfinite(got).all()) or got.shape != (1, cfg.vocab):
        raise AssertionError("full-width prefill logits malformed")
    err = _max_err(got, want)
    scale = float(want.abs().max())
    log(f"[reference] full-width fp32 prefill S=40 logits card vs CPU: "
        f"max_abs_err={err:.3g} (max |logit| {scale:.3g}, tol 1e-3) "
        f"{'ok' if err <= 1e-3 else 'FAIL'}")
    if err > 1e-3:
        raise AssertionError("card and CPU prefill logits disagree")
    del params, m_dev

    # reduced config, fp32: engine token ids card vs CPU, both modes
    rcfg = dataclasses.replace(get_config("qwen1.5-0.5b", reduced=True),
                               compute_dtype="float32")
    r_dev, r_cpu = Model(rcfg, device), Model(rcfg, "cpu")
    rp = r_dev.init(torch.Generator(device=device).manual_seed(11))
    reqs = [(p[:n], 8, 0.0) for (p, _, _), n in
            zip(make_requests(rcfg.vocab, 5, seed=5), (5, 17, 9, 30, 12))]
    for chunk in (0, 8):
        a = serve(rcfg, r_dev, rp, reqs, chunk, batch=3, capacity=64,
                  page_size=8)[1]
        b = serve(rcfg, r_cpu, cpu_tree(rp), reqs, chunk, batch=3,
                  capacity=64, page_size=8)[1]
        log(f"[reference] reduced engine chunk={chunk} token ids card vs "
            f"CPU: {'identical' if a == b else 'DIFFER'}")
        if a != b:
            raise AssertionError(f"engine tokens differ: {a} vs {b}")


def recurrent_reference_phase(device):
    """The recurrent families on the card against the CPU plain path: at
    full width with the depth cut to one block period (recurrentgemma 3
    layers, rwkv6 2), fp32 compute, the prefill logits of a 40-token
    prompt and 3 paged decode steps (the card's greedy token feeds both);
    then reduced-config engine token ids in both modes with paged
    recurrent state."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cpu = torch.device("cpu")
    for arch, _, depth in RECURRENT_ARCHS:
        cfg = dataclasses.replace(get_config(arch), n_layers=depth,
                                  compute_dtype="float32")
        m_dev, m_cpu = Model(cfg, device), Model(cfg, cpu)
        params = m_dev.init(torch.Generator(device=device).manual_seed(17))
        p_cpu = cpu_tree(params)
        tok = torch.from_numpy(make_requests(cfg.vocab, 2, seed=8)[1][0][:40]
                               [None]).long()         # 40 of 130 tokens
        ps, nb = 16, 4
        bt = torch.arange(nb, dtype=torch.int32)[None]

        def prefill(m, p, d):
            lg, caches = m.prefill(p, {"tokens": tok.to(d)})
            return lg, m.write_prefill_paged(m.init_paged_state(1, nb, ps),
                                             caches, 0, bt[0].to(d), 40, ps)
        lg_dev, st_dev = prefill(m_dev, params, device)
        lg_cpu, st_cpu = prefill(m_cpu, p_cpu, cpu)
        errs, scale = [], 0.0
        for step in range(4):
            got = lg_dev[:, :cfg.vocab].float().cpu()
            want = lg_cpu[:, :cfg.vocab]
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{arch}: non-finite logits")
            errs.append(_max_err(got, want))
            scale = max(scale, float(want.abs().max()))
            if step == 3:
                break
            nxt = got.argmax(-1)[:, None].to(torch.int32)
            pos = torch.tensor([40 + step], dtype=torch.int32)
            lg_dev, st_dev = m_dev.decode_paged(params, st_dev,
                                                nxt.to(device),
                                                pos.to(device),
                                                bt.to(device))
            lg_cpu, st_cpu = m_cpu.decode_paged(p_cpu, st_cpu, nxt, pos, bt)
        err = max(errs)
        log(f"[reference] {arch} full width, {depth} layers, fp32: prefill "
            f"S=40 + 3 paged decode steps, logits card vs CPU: "
            f"max_abs_err={err:.3g} per step {[f'{e:.3g}' for e in errs]} "
            f"(max |logit| {scale:.3g}, tol 1e-3) "
            f"{'ok' if err <= 1e-3 else 'FAIL'}")
        if err > 1e-3:
            raise AssertionError(f"{arch}: card and CPU logits disagree")
        del params, m_dev, st_dev, lg_dev
        torch.cuda.empty_cache()

        rcfg = dataclasses.replace(get_config(arch, reduced=True),
                                   compute_dtype="float32")
        r_dev, r_cpu = Model(rcfg, device), Model(rcfg, "cpu")
        rp = r_dev.init(torch.Generator(device=device).manual_seed(11))
        reqs = [(p[:n], 8, 0.0) for (p, _, _), n in
                zip(make_requests(rcfg.vocab, 5, seed=5), (5, 17, 9, 30, 12))]
        kw = {"state_paging": True}
        for chunk in (0, 8):
            a = serve(rcfg, r_dev, rp, reqs, chunk, batch=3, capacity=64,
                      page_size=8, engine_kw=kw)[1]
            b = serve(rcfg, r_cpu, cpu_tree(rp), reqs, chunk, batch=3,
                      capacity=64, page_size=8, engine_kw=kw)[1]
            log(f"[reference] {arch} reduced engine chunk={chunk} "
                f"state_paging token ids card vs CPU: "
                f"{'identical' if a == b else 'DIFFER'}")
            if a != b:
                raise AssertionError(f"{arch} engine tokens differ: {a} vs "
                                     f"{b}")


def recurrent_serve_phases(device, launches):
    """recurrentgemma-2b and rwkv6-7b at full width and depth (random
    weights from a fixed seed, bf16 compute) through ``ServeEngine`` with
    paged recurrent state, monolithic and chunked; each model is freed
    before the next (rwkv6-7b holds ~30 GB of fp32 weights while its
    bf16 copy is made)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    modes = {}
    for arch, short, _ in RECURRENT_ARCHS:
        cfg = get_config(arch)
        model = Model(cfg, device)
        t0 = time.perf_counter()
        params = model.compute_params(
            model.init(torch.Generator(device=device).manual_seed(0)))
        sync(device)
        log(f"[serve:{short}] {arch}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, vocab {cfg.vocab}; weights made in "
            f"{time.perf_counter() - t0:.1f}s, "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the card; "
            f"state row {model.state_row_bytes()} B per slot, KV page "
            f"{model.kv_page_bytes(16)} B")
        requests = make_requests(cfg.vocab)
        for mode in ("monolithic", "chunked"):
            path = f"{short}-{mode}"
            modes[path] = serve_phase(mode, cfg, model, params, requests,
                                      launches, path=path,
                                      engine_kw={"state_paging": True})
            modes[path].pop("outs")
        del params, model
        torch.cuda.empty_cache()
    return modes


# ---------------------------------------------------------------------------
# phase 6: kernel times at the serving path's shapes
# ---------------------------------------------------------------------------

def time_kernels(device, launches):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (
        fused_decode_step_op, sample_tokens_op)
    from repro_torch.kernels.decode_attention.ref import (
        fused_paged_decode_ref, sample_tokens_ref)
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    out = {}
    bf16 = torch.bfloat16
    # flash: the longest prompt of the run, B=1, 16 heads, hd=64, causal
    S, H, hd = 130, 16, 64
    q, k, v = flash_inputs(S, H, H, bf16, device, seed=3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = S * (S + 1) // 2
    bnd = bound(4 * S * H * hd * 2, H * pairs * 4 * hd, BF16_FLOPS)
    out["flash_attention"] = {
        "shape": f"B=1 S={S} Hq=Hkv={H} hd={hd} bf16 causal",
        "ms": timed(lambda: flash_attention_op(q, k, v)),
        "plain_ms": timed(lambda: flash_attention_ref(q, k, v)),
        "library_ms": timed(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        **bnd}
    # the VMM's full-width prefill program: B=4, S=4096, causal (the plain
    # version materialises 4 GB of scores: two calls)
    B, S = 4, 4096
    q, k, v = flash_inputs(S, H, H, bf16, device, seed=3, B=B)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = S * (S + 1) // 2
    bnd = bound(4 * B * S * H * hd * 2, B * H * pairs * 4 * hd, BF16_FLOPS)
    out["flash_attention@B4S4096"] = {
        "shape": f"B={B} S={S} Hq=Hkv={H} hd={hd} bf16 causal",
        "ms": timed(lambda: flash_attention_op(q, k, v), 10, 2),
        "plain_ms": timed(lambda: flash_attention_ref(q, k, v), 2, 1),
        "library_ms": timed(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 10, 2),
        **bnd}
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    # fused decode: B=4, 16 heads, ps=16, nb=16, lengths of a mid-run step
    lens = [64, 161, 96, 143]
    d = decode_inputs(lens, H, H, bf16, device, seed=4)
    B, ps, nb = len(lens), 16, 16
    S_tab = nb * ps
    live_rows = sum(L - 1 for L in lens)          # pool rows read
    pages = sum(-(-L // ps) for L in lens)
    nbytes = (2 * live_rows * H * hd * 2          # K and V pool rows
              + 4 * B * H * hd * 2                # q, k_new, v_new, out
              + 4 * B + 4 * pages)                # lengths, table entries
    bnd = bound(nbytes, sum(lens) * H * 4 * hd, BF16_FLOPS)
    valid = (torch.arange(S_tab, device=device)[None]
             < d["lengths"][:, None])[:, None, None, :]
    bt = d["block_tables"].long()

    def gather_sdpa():
        kk = d["k_pages"][bt].reshape(B, S_tab, H, hd).transpose(1, 2)
        vv = d["v_pages"][bt].reshape(B, S_tab, H, hd).transpose(1, 2)
        return F.scaled_dot_product_attention(d["q"].transpose(1, 2), kk,
                                              vv, attn_mask=valid)

    out["fused_paged_decode"] = {
        "shape": f"B={B} Hq=Hkv={H} hd={hd} ps={ps} nb={nb} lens={lens} "
                 "bf16",
        "ms": timed(lambda: fused_decode_step_op(**d)),
        "plain_ms": timed(lambda: fused_paged_decode_ref(**d)),
        "library_ms": timed(gather_sdpa),
        **bnd}

    # sampler: B=4 rows of each served vocabulary (qwen's padded, then
    # recurrentgemma's and rwkv6's), fp32
    for name, V in (("sample_tokens", 152064),
                    ("sample_tokens@V256000", 256000),
                    ("sample_tokens@V65536", 65536)):
        logits, temps, noise = sampler_inputs(4, V, device, seed=5)
        bnd = bound(2 * 4 * V * 4 + 4 * 4 + 4 * 4, 2 * 4 * V, FP32_FLOPS)
        out[name] = {
            "shape": f"B=4 V={V} fp32",
            "ms": timed(lambda: sample_tokens_op(logits, temps, noise)),
            "plain_ms": timed(lambda: sample_tokens_ref(logits, temps,
                                                            noise)),
            "library_ms": timed(lambda: torch.argmax(
                logits + noise * temps[:, None], dim=-1)),
            **bnd}
    out.update(time_new_kernels(device))
    out.update(time_recurrent_kernels(device))
    for name, r in out.items():
        lib = r["library_ms"]
        ms = r["ms"][0]
        kernel = max((k for k in KERNELS if name.startswith(k)), key=len)
        log(f"[time] {name} {r['shape']}: {launches.get(kernel, 0)} "
            f"launches of {kernel} on the paths; "
            "device ms (event ms per call) — "
            f"kernel {ms:.4f} ({r['ms'][1]:.4f}), plain "
            f"{r['plain_ms'][0]:.4f} ({r['plain_ms'][1]:.4f}), library "
            + (f"{lib[0]:.4f} ({lib[1]:.4f})" if lib else "none")
            + f"; bound {r['bound_ms']:.6f} ms ({r['bound_by']}: "
            f"{r['bound_bytes']:,} B, {r['bound_flops']:,} FLOP); kernel "
            f"{r['bound_flops'] / ms / 1e9:.2f} TFLOP/s, "
            f"{r['bound_bytes'] / ms / 1e6:.1f} GB/s, "
            f"{100 * r['bound_ms'] / ms:.1f}% of the bound")
        for key in ("ms", "plain_ms", "library_ms"):
            if r[key] is not None:
                r[key] = r[key][0]                 # the JSON line: device
    return out


def time_new_kernels(device):
    """Times of the ring decode kernel (B=4, C=4096, full ring) and the
    three app kernels at the ``card`` shapes, with their bounds from
    these inputs. matmul's JSON row is fp32; bf16 is printed beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention_op
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, ring_valid)
    from repro_torch.kernels.matmul.ops import matmul_op
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.sobel.ops import sobel_op
    from repro_torch.kernels.sobel.ref import sobel_ref
    from repro_torch.kernels.vecadd.ops import vecadd_op
    from repro_torch.kernels.vecadd.ref import vecadd_ref
    out = {}
    g = torch.Generator(device=device).manual_seed(8)
    rn = lambda *s: torch.randn(s, generator=g, device=device)  # noqa: E731

    # ring decode: every slot valid (pos >= C), bf16
    B, C, H, hd, pos = 4, 4096, 16, 64, 5000
    q, k, v = ring_inputs(B, C, H, H, torch.bfloat16, device, seed=8)
    n_valid = int(ring_valid(C, pos, 0, device).sum())
    nbytes = 2 * B * n_valid * H * hd * 2 + 2 * B * H * hd * 2
    bnd = bound(nbytes, B * n_valid * H * 4 * hd, BF16_FLOPS)
    mask = ring_valid(C, pos, 0, device)[None, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    out["decode_attention"] = {
        "shape": f"B={B} C={C} Hq=Hkv={H} hd={hd} pos={pos} (full ring) "
                 "bf16",
        "ms": timed(lambda: decode_attention_op(q, k, v, pos)),
        "plain_ms": timed(lambda: decode_attention_ref(q, k, v, pos)),
        "library_ms": timed(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)),
        **bnd}

    # matmul 4096^3: fp32 (the JSON row) and bf16
    M = K = N = 4096
    for dt, peak in ((torch.bfloat16, BF16_FLOPS), (torch.float32,
                                                    FP32_FLOPS)):
        a, bb = rn(M, K).to(dt), rn(K, N).to(dt)
        esz = a.element_size()
        bnd = bound((M * K + K * N + M * N) * esz, 2 * M * N * K, peak)
        name = "matmul" if dt == torch.float32 else "matmul_bf16"
        out[name] = {
            "shape": f"{M}x{K}x{N} {str(dt)[6:]}",
            "ms": timed(lambda: matmul_op(a, bb)),
            "plain_ms": timed(lambda: matmul_ref(a, bb)),
            "library_ms": timed(lambda: torch.matmul(a, bb)),
            **bnd}

    # sobel 4096^2 fp32
    H2 = W2 = 4096
    img = rn(H2, W2)
    filt = torch.tensor([[[-1., 0., 1.], [-2., 0., 2.], [-1., 0., 1.]],
                         [[-1., -2., -1.], [0., 0., 0.], [1., 2., 1.]]],
                        device=device)[:, None]

    def conv_hypot():
        gxy = F.conv2d(img[None, None], filt, padding=1)[0]
        return torch.hypot(gxy[0], gxy[1])
    bnd = bound(2 * H2 * W2 * 4, 17 * H2 * W2, FP32_FLOPS)
    out["sobel"] = {
        "shape": f"{H2}x{W2} float32",
        "ms": timed(lambda: sobel_op(img)),
        "plain_ms": timed(lambda: sobel_ref(img)),
        "library_ms": timed(conv_hypot),
        **bnd}

    # vecadd 2^26 fp32, timed in turns with torch.add (kernel, add, add,
    # kernel, twice): the row keeps the median of each side's four
    n = 1 << 26
    x, y = rn(n), rn(n)
    bnd = bound(3 * n * 4, n, FP32_FLOPS)
    calls = {"kernel": lambda: vecadd_op(x, y),
             "add": lambda: torch.add(x, y)}
    order = ("kernel", "add", "add", "kernel") * 2
    turns = [(w, timed(calls[w])) for w in order]
    log("[time] vecadd vs torch.add in turns, device ms (event ms): "
        + ", ".join(f"{w} {t[0]:.4f} ({t[1]:.4f})" for w, t in turns))
    med = lambda w: tuple(statistics.median(t[i] for v, t in turns  # noqa
                                            if v == w) for i in (0, 1))
    out["vecadd"] = {
        "shape": f"n={n} float32",
        "ms": med("kernel"),
        "plain_ms": timed(lambda: vecadd_ref(x, y)),
        "library_ms": med("add"),
        **bnd}
    return out


def time_recurrent_kernels(device):
    """Times of the recurrent kernels at the serving shapes (the JSON
    rows) and at B=4, S=4096 (printed; their plain versions loop over
    4096 tokens, so two calls are timed), the no-new-token paged decode
    at the fused row's shapes, and flash / fused decode at
    recurrentgemma's hd=256, Hq/Hkv 10/1, window 2048, and at hd 96 and
    112 beside hd 128 (printed)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_op, fused_decode_step_op)
    from repro_torch.kernels.decode_attention.ref import (
        fused_paged_decode_ref, paged_decode_attention_ref)
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rglru_scan.ops import rglru_scan_op
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv_op
    from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref
    out = {}
    for name, (B, S, D) in (("rglru_scan", (1, 130, 2560)),
                            ("rglru_scan@S32", (1, 32, 2560)),
                            ("rglru_scan@B4S4096", (4, 4096, 2560))):
        a, b, h0 = rglru_inputs(B, S, D, device, seed=1)
        n = B * S * D
        bnd = bound((2 * n + B * D) * 4 + n * 4, 2 * n, FP32_FLOPS)
        big = S > 1000
        out[name] = {
            "shape": f"B={B} S={S} D={D} fp32",
            "ms": timed(lambda: rglru_scan_op(a, b, h0)),
            "plain_ms": timed(lambda: rglru_scan_ref(a, b, h0),
                              *((2, 1) if big else ())),
            "library_ms": None, **bnd}
    for name, (B, H, S, K) in (("rwkv6_wkv", (1, 64, 130, 64)),
                               ("rwkv6_wkv@S32", (1, 64, 32, 64)),
                               ("rwkv6_wkv@B4S4096", (4, 64, 4096, 64))):
        ins = wkv_inputs(B, H, S, K, device, seed=2)
        n, st = B * H * S * K, B * H * K * K
        bnd = bound((4 * n + H * K + st) * 4 + (n + st) * 4,
                    4 * B * H * S * K * K, FP32_FLOPS)
        big = S > 1000
        out[name] = {
            "shape": f"B={B} H={H} S={S} K={K} fp32",
            "ms": timed(lambda: rwkv6_wkv_op(*ins)),
            "plain_ms": timed(lambda: rwkv6_wkv_ref(*ins),
                              *((2, 1) if big else ())),
            "library_ms": None, **bnd}

    def gather_sdpa(d, with_new, window=0):
        Bq, _, Hq, hd = d["q"].shape
        Hkv = d["k_pages"].shape[2]
        S_tab = d["block_tables"].shape[1] * d["k_pages"].shape[1]
        bt = d["block_tables"].long()
        kk = d["k_pages"][bt].reshape(Bq, S_tab, Hkv, hd)
        vv = d["v_pages"][bt].reshape(Bq, S_tab, Hkv, hd)
        tok = torch.arange(S_tab, device=device)[None]
        if with_new:
            at = (tok == d["lengths"][:, None] - 1)[:, :, None, None]
            kk = torch.where(at, d["k_new"], kk)
            vv = torch.where(at, d["v_new"], vv)
        valid = tok < d["lengths"][:, None]
        if window:
            valid &= tok >= d["lengths"][:, None] - window
        valid = valid[:, None, None, :]
        G = Hq // Hkv
        kk = kk.transpose(1, 2).repeat_interleave(G, dim=1)
        vv = vv.transpose(1, 2).repeat_interleave(G, dim=1)
        return F.scaled_dot_product_attention(d["q"].transpose(1, 2), kk, vv,
                                              attn_mask=valid)

    def decode_bound(d, with_new, window=0):
        """Bytes: the live pool rows (inside the window; the new token's
        from k/v_new), q, out, lengths and the live table entries."""
        Bq, _, Hq, hd = d["q"].shape
        Hkv, ps = d["k_pages"].shape[2], d["k_pages"].shape[1]
        lens = d["lengths"].tolist()
        lo = [max(0, L - window) if window else 0 for L in lens]
        rows = sum(L - a - (1 if with_new else 0) for L, a in zip(lens, lo))
        pages = sum(-(-L // ps) - a // ps for L, a in zip(lens, lo))
        nbytes = (2 * rows * Hkv * hd * 2                   # pool K, V rows
                  + 2 * Bq * Hq * hd * 2                    # q, out
                  + (2 * Bq * Hkv * hd * 2 if with_new else 0)  # k/v_new
                  + 4 * Bq + 4 * pages)                     # lengths, table
        live = sum(L - a for L, a in zip(lens, lo))
        return bound(nbytes, live * Hq * 4 * hd, BF16_FLOPS)

    lens = [64, 161, 96, 143]
    d = decode_inputs(lens, 16, 16, torch.bfloat16, device, seed=4)
    for kk in ("k_new", "v_new"):
        d.pop(kk)
    bnd = decode_bound(d, False)
    out["paged_decode_attention"] = {
        "shape": f"B=4 Hq=Hkv=16 hd=64 ps=16 nb=16 lens={lens} bf16",
        "ms": timed(lambda: decode_attention_op(
            d["q"], d["k_pages"], d["v_pages"], d["lengths"],
            block_tables=d["block_tables"])),
        "plain_ms": timed(lambda: paged_decode_attention_ref(**d)),
        "library_ms": timed(lambda: gather_sdpa(d, False)),
        **bnd}

    S, Hq, hd = 130, 10, 256
    q, k, v = flash_inputs(S, Hq, 1, torch.bfloat16, device, seed=3, hd=hd)
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).expand(1, Hq, S, hd)
    vt = v.transpose(1, 2).expand(1, Hq, S, hd)
    pairs = S * (S + 1) // 2
    bnd = bound((2 * S * Hq * hd + 2 * S * hd) * 2, Hq * pairs * 4 * hd,
                BF16_FLOPS)
    out["flash_attention_hd256"] = {
        "shape": f"B=1 S={S} Hq={Hq} Hkv=1 hd={hd} window=2048 bf16",
        "ms": timed(lambda: flash_attention_op(q, k, v, window=2048)),
        "plain_ms": timed(lambda: flash_attention_ref(q, k, v, window=2048)),
        "library_ms": timed(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        **bnd}
    # recurrentgemma's long prompt: S=2500, window 2048 (SDPA takes the
    # window as a boolean mask)
    S = 2500
    q, k, v = flash_inputs(S, Hq, 1, torch.bfloat16, device, seed=3, hd=hd)
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).expand(1, Hq, S, hd)
    vt = v.transpose(1, 2).expand(1, Hq, S, hd)
    pos = torch.arange(S, device=device)
    diff = pos[:, None] - pos[None, :]
    win = (diff >= 0) & (diff < 2048)
    pairs = int(win.sum())
    bnd = bound((2 * S * Hq * hd + 2 * S * hd) * 2, Hq * pairs * 4 * hd,
                BF16_FLOPS)
    out["flash_attention_hd256@S2500"] = {
        "shape": f"B=1 S={S} Hq={Hq} Hkv=1 hd={hd} window=2048 bf16",
        "ms": timed(lambda: flash_attention_op(q, k, v, window=2048), 20, 2),
        "plain_ms": timed(lambda: flash_attention_ref(q, k, v, window=2048),
                          5, 1),
        "library_ms": timed(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=win), 20, 2),
        **bnd}
    del q, k, v, qt, kt, vt

    d = decode_inputs(lens, Hq, 1, torch.bfloat16, device, seed=5, hd=hd)
    bnd = decode_bound(d, True, 2048)
    out["fused_paged_decode_hd256"] = {
        "shape": f"B=4 Hq={Hq} Hkv=1 hd={hd} ps=16 nb=16 lens={lens} "
                 "window=2048 bf16",
        "ms": timed(lambda: fused_decode_step_op(**d, window=2048)),
        "plain_ms": timed(lambda: fused_paged_decode_ref(**d, window=2048)),
        "library_ms": timed(lambda: gather_sdpa(d, True, 2048)),
        **bnd}
    # the head dims of phi3-mini (hd 96) and kimi-k2 (hd 112) beside hd
    # 128 at the same heads: flash at B=1 S=130, fused decode at the
    # mid-run lengths (printed)
    for hd, Hq, Hkv in ((96, 32, 32), (128, 32, 32), (112, 64, 8),
                        (128, 64, 8)):
        q, k, v = flash_inputs(130, Hq, Hkv, torch.bfloat16, device,
                               seed=hd, hd=hd)
        qt = q.transpose(1, 2)
        kt = k.transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1)
        vt = v.transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1)
        pairs = 130 * 131 // 2
        out[f"flash_attention_hd{hd}_{Hq}/{Hkv}"] = {
            "shape": f"B=1 S=130 Hq={Hq} Hkv={Hkv} hd={hd} bf16 causal",
            "ms": timed(lambda: flash_attention_op(q, k, v)),
            "plain_ms": timed(lambda: flash_attention_ref(q, k, v)),
            "library_ms": timed(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)),
            **bound((2 * 130 * Hq * hd + 2 * 130 * Hkv * hd) * 2,
                    Hq * pairs * 4 * hd, BF16_FLOPS)}
        d = decode_inputs(lens, Hq, Hkv, torch.bfloat16, device, seed=hd,
                          hd=hd)
        out[f"fused_paged_decode_hd{hd}_{Hq}/{Hkv}"] = {
            "shape": f"B=4 Hq={Hq} Hkv={Hkv} hd={hd} ps=16 nb=16 "
                     f"lens={lens} bf16",
            "ms": timed(lambda: fused_decode_step_op(**d)),
            "plain_ms": timed(lambda: fused_paged_decode_ref(**d)),
            "library_ms": timed(lambda: gather_sdpa(d, True)),
            **decode_bound(d, True)}
        del q, k, v, qt, kt, vt, d
    # a long context, where bytes and not latency should set the pace
    lens = [640, 2560, 1601, 2143]
    for name, Hq, Hkv, hd, window in (
            ("fused_paged_decode@long", 16, 16, 64, 0),
            ("fused_paged_decode_hd256@long", 10, 1, 256, 2048)):
        d = decode_inputs(lens, Hq, Hkv, torch.bfloat16, device, seed=6,
                          nb=160, hd=hd)
        out[name] = {
            "shape": f"B=4 Hq={Hq} Hkv={Hkv} hd={hd} ps=16 nb=160 "
                     f"lens={lens} window={window} bf16",
            "ms": timed(lambda: fused_decode_step_op(**d, window=window)),
            "plain_ms": timed(lambda: fused_paged_decode_ref(
                **d, window=window), 10, 2),
            "library_ms": timed(lambda: gather_sdpa(d, True, window)),
            **decode_bound(d, True, window)}
        del d
    return out


# ---------------------------------------------------------------------------

def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import common
        from repro_torch.models import Model
    except ImportError as exc:
        print(f"chip_smoke: the repository's src/ is missing ({exc})",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def phase_done(name):
        log(f"[phase] {name} done at {time.perf_counter() - t_start:.1f}s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[device] {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    common.build_all()
    log(f"[build] {len(common.sources())} kernel sources built in "
        f"{time.perf_counter() - t0:.1f}s")
    report_build(common)

    errs = {}
    check_kernels(device, errs)
    phase_done("kernels")

    cfg = get_config("qwen1.5-0.5b")
    model = Model(cfg, device)
    params = model.compute_params(
        model.init(torch.Generator(device=device).manual_seed(0)))
    requests = make_requests(cfg.vocab)
    launches, modes, native = {}, {}, {}
    for mode in ("monolithic", "chunked"):
        modes[mode] = serve_phase(mode, cfg, model, params, requests,
                                  launches)
        native[mode] = outs = modes[mode].pop("outs")
        flat = [t for o in outs for t in o]
        if not all(0 <= t < cfg.vocab for t in flat):
            raise AssertionError(f"{mode}: token id out of range")
    virt = {}
    for mode, policy in (("monolithic", "hybrid"), ("chunked", "slo")):
        virt[mode] = virtualized_phase(mode, policy, cfg, model, params,
                                       requests, native[mode], launches)
    del params, model
    torch.cuda.empty_cache()
    phase_done("serve qwen")
    modes.update(recurrent_serve_phases(device, launches))
    phase_done("serve recurrent")

    vmm_programs_phase(device, launches)
    reference_phase(device)
    recurrent_reference_phase(device)
    program_reference_phase(device)
    phase_done("VMM programs and references")
    apps_phase(device, launches)
    phase_done("apps")

    if "--profile" in sys.argv[1:]:
        model = Model(cfg, device)
        params = model.compute_params(
            model.init(torch.Generator(device=device).manual_seed(0)))
        for mode in ("monolithic", "chunked"):
            profile_phase(mode, cfg, model, params, requests)
        del params, model
        torch.cuda.empty_cache()
        for arch, short, _ in RECURRENT_ARCHS:
            rcfg = get_config(arch)
            model = Model(rcfg, device)
            params = model.compute_params(
                model.init(torch.Generator(device=device).manual_seed(0)))
            for mode in ("monolithic", "chunked"):
                profile_phase(mode, rcfg, model, params,
                              make_requests(rcfg.vocab),
                              name=f"{short}-{mode}",
                              engine_kw={"state_paging": True})
            del params, model
            torch.cuda.empty_cache()

    times = time_kernels(device, launches)
    phase_done("times")
    for mode, r in modes.items():
        log(f"[time:{mode}] ttft p50 {r['ttft_p50_ms']:.2f} ms, p95 "
            f"{r['ttft_p95_ms']:.2f} ms (queue wait p50 "
            f"{r['queue_p50_ms']:.2f} ms); {r['tok_s']:.1f} tok/s over the "
            f"run; engine step p50 {r['step_p50_ms']:.3f} ms = "
            f"{4e3 / r['step_p50_ms']:.1f} decode tok/s at 4 slots")
    for mode, r in virt.items():
        log(f"[time:virtualized-{mode}] {r['tok_s']:.1f} tok/s over the run; "
            f"engine step p50 {r['step_p50_ms']:.3f} ms (native "
            f"{modes[mode]['step_p50_ms']:.3f} ms, ratio "
            f"{r['step_p50_ms'] / modes[mode]['step_p50_ms']:.3f})")

    rows = [{"name": name, "route": "cuda", **KERNELS[name],
             "launches": launches.get(name, 0),
             "max_abs_err": errs[name], "ms": times[name]["ms"],
             "plain_ms": times[name]["plain_ms"],
             "bound_ms": times[name]["bound_ms"],
             "bound_by": times[name]["bound_by"],
             "library_ms": times[name]["library_ms"]}
            for name in KERNELS]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
