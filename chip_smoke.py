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
   q-tile edges (S = 1, 63, 64, 65), at B=4 S=4096 and at the train
   phase's B=4 S=2048, and at
   recurrentgemma's hd=256, Hq/Hkv 10/1 with windows, and at the head
   dims of phi3-mini (hd 96, 32/32) and kimi-k2 (hd 112, 64/8), bf16 and
   fp32, S = 1, 65, 130, causal and windowed; flash and fused paged
   decode at the families phase's hd-128 shapes (starcoder2's 48/4,
   mixtral's 32/8 with window 4096 at S = 4200, internlm2's 16/8; a dead
   slot, NaN-poisoned masked rows); ring-cache decode
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
   leased == freed too; then chunked through a VMM tenant (``slo``):
   the native ids, and the virtualization ratio of the step p50. Every
   family's weights are made once (rwkv6-7b first, on an empty card) and
   shared by phases 3–7 and 9;
7. VMM programs — a tenant reprograms the full-width prefill program
   (B=4, S=4096) and the decode program of the same capacity, runs the
   prefill and 32 greedy decode steps through the guest API at pos
   4096…4127 (``decode_attention`` 24 times a step), takes a warm hit,
   and a cross-slice reprogram is refused; then the same for
   ``recurrentgemma-2b`` (swa rings of 2048, recurrent rows;
   ``decode_attention`` 8 times a step) and ``rwkv6-7b``: the ids equal
   native ``prefill``/``decode`` in the same call, the recurrence
   kernel's device time at B=4 is read from a trace of the prefill, and
   the prefill program at a cut depth agrees with the CPU plain path;
8. reference — the card against the plain PyTorch path on the CPU:
   full-width fp32 prefill logits and reduced-config engine token ids in
   both modes (qwen, and both recurrent families at full width cut to
   one block period, with 3 paged decode steps); the step builders'
   full-width fp32 decode logits and reduced-config decode ids over a
   wrapped ring;
9. KV hierarchy — full-width ``qwen1.5-0.5b``: prefix sharing (at
   least 3 warm admissions over a 64-token prefix, CoW forks, the ids of
   the run without sharing) and the host swap tier on half of the KV
   working set (pages swapped out and refaulted, full budgets, the
   unpressured ids, leased == freed, refcounts consistent, swap-out and
   refault times); ``recurrentgemma-2b``'s state rows parked and
   refaulted under the same pressure with the unpressured ids;
10. mux — the eight decoder-only families at full width, qwen and
   recurrentgemma at full depth, the other six cut to 2 layers (mixtral
   2 of its 8 experts, kimi 8 of 384), as bitstreams in one
   ``ModelRegistry`` on a VMM's loader, one ``MuxEngine``: the ids of
   solo engines, before and after churn of qwen, recurrentgemma and
   rwkv6 under ``max_resident=1`` (swaps both ways, CRC over every
   weight byte at register and swap-in, no failure); a flipped byte in a
   host copy is refused and counted once; swap-in and swap-out times;
   internvl2 and whisper stay outside the mux, as in the reference;
11. families — the repo's other seven families through ``ServeEngine``
   (random weights from seed 0, made in bf16; batch 4, 16-token pages,
   the same 8 requests): internlm2-1.8b, phi3-mini-3.8b, starcoder2-15b
   at full depth, mixtral-8x7b cut to 16 of 32 layers, kimi-k2 to its
   dense first layer and one MoE layer (384 experts, top-8), internvl2-2b
   (256 stub image rows, capacity 512) and whisper-medium (1500 stub
   frames), monolithic and, but for the last two, chunked, then
   monolithic through a VMM tenant (``hybrid``; ids equal native): the
   serve gates and each path's kernels; then each family's card-vs-CPU
   reference at full width in fp32, cut to one layer (kimi its two, with
   16 experts; whisper one encoder and one decoder layer): prefill logits
   and 3 paged decode steps within 1e-3, and for the MoE families every
   (token, k) expert pick (a pick may differ only at a near tie, < 1e-5,
   and is reported); TTFT, tok/s, the step p50 and the virtualized /
   native step ratio beside the card's name and power limit;
12. train — flash under autograd (the kernel forward inside its
   ``autograd.Function``, the plain backward) against autograd through
   the plain version at qwen's 16/16 hd 64 (B=2 S=512), hd 128 48/4 and
   hd 256 10/1 with window 2048 at S=2500, bf16 and fp32: the forward
   within two ulps / 2e-5; dq dk dv within 3e-2 / 2e-5, a check of the
   ``Function``'s wiring (saved inputs, window, one forward launch), not
   of a kernel, since its backward is the plain version's own; the RG-LRU
   scan's and the WKV's ``Function`` (the scan's backward one more launch
   of the scan over the time-reversed inputs, the WKV's the chunked form
   recomputed in torch ops) against autograd through their plain versions
   at (1, 130, 2560), (4, 2048, 2560) and (1, 64, 130, 64), (4, 64, 2048,
   64): forward bit-equal / within 2e-3, every input gradient (dh0, du,
   ds0 included) within 1e-5 / 1e-4 by relative norm, 2 / 1 launches a
   call; qwen at full width cut to 2 layers, fp32, B=2 S=256: one train
   step on the card and on the CPU (plain, 2 micro-steps, 2 micro-steps
   with bf16 accumulation), loss and grad_norm within 1e-4 relative,
   every parameter leaf with a finite nonzero gradient on the card, and
   the same plain step for both recurrent families; then every family of
   ``TRAIN_FAMILIES`` at full width from ``pipeline_for(seed=0)`` with
   the train driver's AdamW: ``qwen1.5-0.5b`` at full depth, 12 steps of
   B=4 S=2048, the nine others 4 steps each with depth, kimi's experts, B
   and S cut as one card's memory forces (the reckoning printed beside
   the peak). Each: every leaf a finite nonzero gradient, finite losses,
   step 0's batch easier right after step 0 and after the last step,
   each step's launches of flash, the scan and the WKV as the block
   pattern gives them (qwen: 48 flash launches); step p50, tokens/s and
   peak memory. qwen's last step's loss below its first, one profiled
   step (busy share, the share of flash's recomputed backward), the
   step-5 checkpoint (``CheckpointManager``, async) restored into fresh
   trees and run to step 10; qwen and both recurrent families through a
   VMM tenant's ``train`` program (``hybrid``); resumed and virtualized
   losses within 1e-5 relative of the native ones (reported bitwise
   too), with the virtualized / native step ratio; one profiled rwkv6
   step (the WKV backward's share);
13. apps — the paper's three apps (``launch/apps.py``) native and through
   three bound tenants, at the reference size and at the card's;
14. times — per mode TTFT, throughput and the median engine step; per
   kernel (timed right after phase 2, printed at the end) its device
   time (torch.profiler/CUPTI; the per-call CUDA-event time is printed
   beside it), its plain version's, one PyTorch call
   computing the same function (``library_ms``, a yardstick the port
   never calls; none for the two recurrences; vecadd and ``torch.add``
   timed in turns), the bound, and the achieved TFLOP/s and share of the
   bound, with its launches on the paths; the sampler at the three served
   vocabularies; the scan and the WKV also at one chunked-prefill call
   (S=32) and at the families' train shape (B=1, S=2048); flash also at
   B=4 S=4096, at the train phase's B=4 S=2048 and at hd 256 S=2500 with
   window 2048; fused decode also
   at a long
   context (nb=160, lengths up to 2560) at hd 64 16/16 and hd 256 10/1
   with window 2048;
15. elastic-mux (after the apps) — ``examples/torch_multi_tenant_serving.py``
   at full width under ``wfq`` and ``slo``: alice's qwen1.5-0.5b and
   bob's internlm2-1.8b decode programs on (1, 4) slices of a 2×4 view
   of the card (each pool 4/8 of its free memory), 6 tokens each through
   ``run``/``run_async``, logits bitwise equal to the same program run
   natively; the cross-slice attack refused and audited; one warm hit;
   every submitted op completed; slo attainment;
16. elastic-failover — ``examples/torch_elastic_failover.py``:
   internlm2-1.8b at full width cut to 2 of 24 layers, B=4 S=256, 6
   steps through a tenant's train program, checkpoint (~6 GB), slice
   failure, migration, 6 steps, the grow to (2, 4) (pool 4/8 → 8/8), 6
   steps; steps 6-17 bitwise equal to an uninterrupted run; checkpoint,
   restore and migrate seconds;
17. autoscaler — a real queue_buildup IRQ grows a full-width qwen decode
   tenant (1, 1) → (1, 2) on a 2×4 view (slo, watermark 4); a calm
   shrink; three fillers fragment the grid and the next grow
   defragments to (1, 4); every decode step bitwise equal to native at
   the same positions; the IRQ → grow latency;
18. long-context — qwen1.5-0.5b at full depth, a 16368-token prompt in
   512-token chunks over page rows of 16384 (the chunked online
   softmax), recurrentgemma-2b with a 4096-token prompt (its swa layers
   banded), 16 decode steps each; one layer's long path against the
   dense formula (fp32 1e-5, bf16 2e-2), every chunk call on its route,
   the peak memory of one chunk call (long path against dense) and of
   the prefill, the prefill's host seconds;
19. sharded — the mesh step builders (``parallel/steps.py`` given a
   ``DeviceMesh``) on a one-rank NCCL group (a ``file://`` store under a
   temp dir) and a (1, 1) mesh on the card: qwen1.5-0.5b at full width
   and depth (prefill B=4 S=2048 into rings of 4096, 16 decode steps, 4
   train steps of B=4 S=2048) and recurrentgemma-2b (12 layers) and
   rwkv6-7b (8), prefill and decode, internvl2-2b and whisper-medium at
   full depth (prefill, decode, 2 train steps: the VLM projector and the
   encoder on the mesh) and qwen's train with ``micro_steps=2``, each
   against the device builders on the same inputs: logits, caches,
   losses, grad norms and trained parameters bit for bit (else the
   first differing leaf named and every leaf held to 3e-2); flash,
   decode_attention, rglru_scan and rwkv6_wkv launched on the mesh runs;
   both builders' step times. With two cards or more, one NCCL rank a
   card on a (1, n) mesh runs recurrentgemma-2b (3 layers: split-KV
   decode, and without it the ring gathered) and mixtral-8x7b (1 layer,
   ``moe_impl="ep"``: token routing) in fp32 against the one-card
   builders within 1e-3; with one card a line says so;
20. dryrun — ``python -m repro_torch.launch.dryrun`` on qwen's train_4k
   and decode_32k cells over both production meshes (CPU subprocess,
   fake groups, meta tensors): every artifact ok; qwen's train step at
   full width and depth (B=4 S=2048) counted by ``launch.op_analysis``
   on the card and on meta: dot FLOPs and kernel records equal; the
   roofline's lower bound beside the measured step p50; the card's
   ``total_memory``.

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
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
                "rwkv6-chunked": ("rwkv6_wkv", "sample_tokens"),
                "recurrentgemma-virtualized-chunked": (
                    "rglru_scan", "fused_paged_decode", "sample_tokens"),
                "rwkv6-virtualized-chunked": ("rwkv6_wkv", "sample_tokens"),
                "recurrentgemma-vmm-programs": (
                    "flash_attention", "rglru_scan", "decode_attention"),
                "rwkv6-vmm-programs": ("rwkv6_wkv",),
                "kv-hierarchy-share": ("fused_paged_decode",
                                       "sample_tokens"),
                "kv-hierarchy-swap": ("fused_paged_decode", "sample_tokens"),
                "kv-hierarchy-state-swap": ("rglru_scan",
                                            "fused_paged_decode",
                                            "sample_tokens"),
                "mux": ("rglru_scan", "rwkv6_wkv", "fused_paged_decode",
                        "sample_tokens"),
                "elastic-mux": ("decode_attention",),
                "elastic-failover": ("flash_attention",),
                "autoscaler": ("decode_attention",),
                "long-context-qwen": ("fused_paged_decode", "sample_tokens"),
                "long-context-recurrentgemma": ("rglru_scan",
                                                "fused_paged_decode",
                                                "sample_tokens")}
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
        # device activity only: the host ops' events are not read, and
        # they would multiply the events the trace has to sort
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if rows:
            return sum(t / n * -(-n // reps) for t, n, _ in rows) / 1e3
        log("[time] the trace holds no device event; tracing again")
    # traces can stay empty for several in a row (after the long serving
    # phases): then the time is taken between two CUDA events around the
    # ``reps`` calls back to back, which adds any launch gap to the
    # device time of a short kernel
    ms = batch_event_ms(fn, reps)
    log(f"[time] five traces held no device event; timed {reps} calls "
        f"back to back between CUDA events: {ms:.4f} ms a call")
    return ms


def batch_event_ms(fn, reps):
    """Time of one call, between two CUDA events around ``reps`` calls
    launched back to back."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_rows(prof, averages=None):
    """Device-side events of a profile (kernels, copies) as
    (total µs, count, name), largest first; ``averages`` the profile's
    ``key_averages()`` when the caller has them (each call aggregates
    every event of the trace again)."""
    import torch
    rows = []
    for e in averages if averages is not None else prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev = getattr(e, "self_device_time_total", None)
            rows.append((e.self_cuda_time_total if dev is None else dev,
                         e.count, e.key))
    return sorted(rows, reverse=True)


def fmt_ms(ms):
    """A measured time in ms, or "not recorded" when a trace kept none."""
    return "not recorded" if ms is None else f"{ms:.4f}"


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
    B = 4 and every vocabulary the sampler serves (chunked mode: qwen
    152064 padded, recurrentgemma 256000, rwkv6 65536, internlm2 92672
    padded, phi3-mini 32256 padded, starcoder2 49152, mixtral 32000,
    kimi-k2 163840), at B = 1 and B = 64, at V = 1,
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

    for B, V in ((4, 152064), (4, 256000), (4, 65536), (4, 92672),
                 (4, 32256), (4, 49152), (4, 32000), (4, 163840), (1, 152064),
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
    # the tensor-core instance's q-tile edges (64 rows a CTA), the VMM
    # prefill program's shape and the train phase's (B=4 S=2048, every
    # layer's forward there), each element within two bf16 ulps
    for B, S in ((1, 1), (1, 63), (1, 64), (1, 65), (4, 4096),
                 (TRAIN_B, TRAIN_S)):
        q, k, v = flash_inputs(S, 16, 16, bf16, device, seed=S, B=B)
        err = _expect_close("flash_attention",
                            f"B={B} S={S} Hq=Hkv=16 hd=64 causal bfloat16",
                            flash_attention_op(q, k, v),
                            flash_attention_ref(q, k, v), BF16_ULP_ATOL,
                            BF16_ULP_RTOL)
        errs["flash_attention"] = max(errs["flash_attention"], err)
        del q, k, v
    check_flash_head_dims(device, errs)
    check_family_shapes(device, errs)

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


#: the attention shapes of the families phase, all at hd 128: starcoder2's
#: 48/4 (G 12), mixtral's 32/8 with its window of 4096, internlm2's 16/8
FAMILY_SHAPES = ((48, 4, 0), (32, 8, 4096), (16, 8, 0))


def check_family_shapes(device, errs):
    """Flash and the fused paged decode at ``FAMILY_SHAPES``, bf16 and
    fp32: flash at S = 130 (S = 4200 with the window, so that it masks),
    the decode over four slots with a dead one and lengths past the
    window, clean and with NaN in every masked pool row; bf16 within two
    ulps of the plain version, fp32 at 2e-5."""
    import torch
    from repro_torch.kernels.decode_attention.ops import fused_decode_step_op
    from repro_torch.kernels.decode_attention.ref import fused_paged_decode_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    for (Hq, Hkv, window), dt in itertools.product(
            FAMILY_SHAPES, (torch.bfloat16, torch.float32)):
        dn = str(dt).replace("torch.", "")
        S = 4200 if window else 130
        q, k, v = flash_inputs(S, Hq, Hkv, dt, device, seed=Hq + S, hd=128)
        got = flash_attention_op(q, k, v, window=window)
        want = flash_attention_ref(q, k, v, window=window)
        what = f"B=1 S={S} Hq={Hq} Hkv={Hkv} hd=128 window={window} {dn}"
        if dt == torch.float32:
            _expect("flash_attention", what, _max_err(got, want), TOL[dn])
        else:
            err = _expect_close("flash_attention", what, got, want,
                                BF16_ULP_ATOL, BF16_ULP_RTOL)
            errs["flash_attention"] = max(errs["flash_attention"], err)
        del q, k, v, got, want
        lens_sets = [[37, 0, 4200, 4097] if window else [37, 0, 129, 256]]
        if (Hq, Hkv) == (16, 8):
            # internvl2's slots: 256 image rows + prompt + output, a table
            # of 32 pages (capacity 512)
            lens_sets.append([37, 0, 418, 512])
        for lens in lens_sets:
            nb = -(-max(lens) // 16)
            d = decode_inputs(lens, Hq, Hkv, dt, device, seed=Hq + Hkv,
                              nb=nb, hd=128)
            for nan in (False, True):
                if nan:
                    poison_masked_rows(d, window)
                got = fused_decode_step_op(**d, window=window)
                want = fused_paged_decode_ref(**d, window=window)
                what = (f"B=4 Hq={Hq} Hkv={Hkv} hd=128 lens={lens} nb={nb} "
                        f"window={window} nan_masked={nan} {dn}")
                err = _check_decode_case("fused_paged_decode", what, got,
                                         want, [1])
                log(f"[kernel] fused_paged_decode {what}: "
                    f"max_abs_err={err:.3g} ok")
                if dt == torch.bfloat16:
                    errs["fused_paged_decode"] = max(
                        errs.get("fused_paged_decode", 0), err)


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
        for _ in range(10):                # a trace may hold no event
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
                engine_kw=None, capacity=256):
    """Serve ``requests`` natively in ``mode`` after a two-request
    warm-up; the launches of the timed run are held to ``path``'s
    kernels (default: the mode's)."""
    from repro_torch.kernels import common
    from repro_torch.obs import ObsHub
    path = path or mode
    chunk = 32 if mode == "chunked" else 0
    serve(cfg, model, params, requests[:2], chunk, capacity=capacity,
          engine_kw=engine_kw)                             # warm-up run
    obs = ObsHub(enabled=True)
    common.reset_launches()
    eng, outs, wall, steps = serve(cfg, model, params, requests, chunk,
                                   capacity=capacity, obs=obs,
                                   engine_kw=engine_kw)
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
                      launches, path=None, engine_kw=None, strict=False,
                      capacity=256):
    """The native phase's requests through a VMM tenant (one 1×1 slice of
    the card, pool sized from the card): every step via
    ``tenant.device.run``, KV pages from the tenant's MMU pool, the
    pool-pressure admission gate. Token ids must equal the native run's
    unless the engine says why (deferred admissions); with ``strict``
    they must equal them."""
    import torch
    from repro_torch.kernels import common
    from repro_torch.launch.serve import virtual_server, virtualized_engine_kw
    device = model.device
    vmm, tenant = virtual_server(device, policy)
    try:
        chunk = 32 if mode == "chunked" else 0
        common.reset_launches()
        eng, outs, wall, steps = serve(
            cfg, model, params, requests, chunk, capacity=capacity,
            engine_kw={**(engine_kw or {}), **virtualized_engine_kw(tenant)})
        counts = dict(common.LAUNCHES)
        st = vmm.stats()
    finally:
        vmm.shutdown()
    s = eng.stats
    sched = st["scheduler"]["tenants"]["server"]
    path = path or f"virtualized-{mode}"
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
    if not same and (strict or s.deferred == 0):
        raise AssertionError(f"{path}: tokens differ from native"
                             + ("" if strict else " with no deferred "
                                "admission to explain it"))
    if s.state_pages_leased != s.state_pages_freed:
        raise AssertionError(f"{path}: state pages leased != freed")
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
    return as_program_params(abstract, Model(cfg, device).init(gen))


def as_program_params(abstract, params):
    """``params`` in the dtypes of a program's abstract parameters (a
    leaf of the right dtype is taken as it is, so served bf16 weights are
    not copied; their fp32 recurrent gates get bf16 copies)."""
    if isinstance(abstract, dict):
        return {k: as_program_params(abstract[k], params[k])
                for k in abstract}
    if isinstance(abstract, list):
        return [as_program_params(a, p) for a, p in zip(abstract, params)]
    if params.shape != abstract.shape:
        raise AssertionError(f"weights {tuple(params.shape)} vs program "
                             f"{tuple(abstract.shape)}")
    return params.to(abstract.dtype)


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


# ---------------------------------------------------------------------------
# elastic virtualization on one card, and the long-context attention paths
# ---------------------------------------------------------------------------

#: a one-card view that the elastic phases slice: 2×4 entries, each 1/8
#: of the card's free memory
VIEW = (2, 4)
#: a pool's share of the card against k/8 of it (segment rounding)
SHARE_TOL = 1e-3


def example(name):
    """One of ``examples/<name>.py``, imported from the checkout."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _share(name, what, share, k):
    if abs(share - k / 8) > SHARE_TOL:
        raise AssertionError(f"{name}: {what} holds {share:.5f} of the "
                             f"card's memory, not {k}/8")


def elastic_mux_phase(device, launches, smi):
    """``examples/torch_multi_tenant_serving.py`` at full width under
    ``wfq`` and ``slo``: alice (qwen1.5-0.5b) and bob (internlm2-1.8b)
    decode programs on (1, 4) slices of a 2×4 view of the card, 6 tokens
    each through ``run``/``run_async``. Gates: each tenant's logits equal
    the same program run natively bit for bit; the cross-slice attack
    raises LegalityError and is audited; one warm hit; the scheduler
    completes every submitted op; each pool holds 4/8 of the card's free
    memory; under ``slo`` attainment is reported; the ring decode kernel
    launches on every decode step of every layer. → alice's logits
    under ``wfq`` (CPU)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    ex = example("torch_multi_tenant_serving")
    t0 = time.perf_counter()
    alice = None
    for policy in ("wfq", "slo"):
        torch.cuda.empty_cache()
        common.reset_launches()
        out = ex.main(["--device", "cuda", "--full", "--policy", policy])
        counts = dict(common.LAUNCHES)
        if policy == "wfq":
            alice = out["tenants"]["alice"]["logits"]
        path = "elastic-mux"
        for name, t in out["tenants"].items():
            sched = out["sched"][name]
            log(f"[{path}] {smi}: {policy} {name} ({t['arch']}): pool "
                f"{t['pool_bytes']} bytes = {t['share']:.5f} of the card's "
                f"free memory; logits equal native bitwise: "
                f"{t['native_equal']}; completed {sched['completed']} of "
                f"{t['ops']} ops, failed {sched['failed']}"
                + (f"; slo attainment {sched['slo_attainment']:.3f}, p95 "
                   f"wait {sched['p95_wait_ms']:.2f} ms"
                   if "slo_attainment" in sched else ""))
            if not (t["native_equal"] and t["finite"]):
                raise AssertionError(f"{path} {policy} {name}: logits differ "
                                     "from the native program's")
            if sched["completed"] != t["ops"] or sched["failed"]:
                raise AssertionError(f"{path} {policy} {name}: scheduler "
                                     f"completed {sched['completed']}")
            if policy == "slo" and "slo_attainment" not in sched:
                raise AssertionError(f"{path}: no slo attainment")
            _share(f"{path} {name}", "the pool", t["share"], 4)
        log(f"[{path}] {policy}: attack denied {out['attack_denied']}, "
            f"violations {out['violations']}; compile hits {out['hits']} "
            f"misses {out['misses']}; launches={counts}")
        if not out["attack_denied"] or \
                out["violations"].get("cross_slice_reprogram") != 1:
            raise AssertionError(f"{path}: the cross-slice attack was not "
                                 "denied and audited")
        if out["hits"] != 1:
            raise AssertionError(f"{path}: compile hits {out['hits']}")
        layers = sum(get_config(t["arch"]).n_layers
                     for t in out["tenants"].values())
        # each tenant's 6 steps and the native run's 6
        if counts.get("decode_attention", 0) != 2 * ex.TOKENS * layers:
            raise AssertionError(f"{path}: decode_attention launched "
                                 f"{counts.get('decode_attention', 0)} "
                                 f"times, want {2 * ex.TOKENS * layers}")
        count_path(path, counts, launches)
    log(f"[{path}] took {time.perf_counter() - t0:.1f}s")
    return alice


#: the failover's cut: internlm2-1.8b at full width, 2 of 24 layers,
#: B=4 S=256 (~0.5 B parameters: ~6 GB of fp32 parameters and AdamW's
#: m and v a checkpoint)
FAILOVER_ARGS = ("--full", "--depth", "2", "--batch", "4", "--seq", "256")


def elastic_failover_phase(device, launches, smi):
    """``examples/torch_elastic_failover.py`` on the card, cut as
    ``FAILOVER_ARGS`` says: 6 steps through a tenant's train program on a
    (1, 4) slice of a 2×4 view, checkpoint, slice failure, migration to
    a fresh (1, 4) slice, 6 steps, the grow to (2, 4), 6 steps. Gates:
    18 finite losses; steps 6-11 and 12-17 equal, bitwise, the same
    steps of an uninterrupted native run; the pool goes from 4/8 to 8/8
    of the card's free memory; flash launches on every step."""
    import torch
    from repro_torch.kernels import common
    ex = example("torch_elastic_failover")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    common.reset_launches()
    out = ex.main(["--device", "cuda", *FAILOVER_ARGS])
    counts = dict(common.LAUNCHES)
    path = "elastic-failover"
    losses, ref = out["losses"], out["uninterrupted"]
    n = 3 * ex.PHASE_STEPS
    cfg = ex.train_config(True, int(FAILOVER_ARGS[2]))
    want = 2 * n * train_launches(cfg)["flash_attention"]
    log(f"[{path}] {smi}: {ex.ARCH} {cfg.n_layers} layers at full width, "
        f"{FAILOVER_ARGS}: losses {[round(x, 4) for x in losses]}; events "
        f"{out['events']}; checkpoint {out['checkpoint_bytes']} bytes in "
        f"{out['checkpoint_s']:.2f}s; migrate {out['migrate_s']:.2f}s "
        f"(restore {out['restore_s']:.2f}s); grow {out['resize_s']:.2f}s; "
        f"pool {out['pool_before']} -> {out['pool_after']} bytes "
        f"({out['share_before']:.5f} -> {out['share_after']:.5f} of the "
        f"card's free memory); slice {out['slice']}; launches={counts}")
    if len(losses) != n or not all(x == x and abs(x) != float("inf")
                                   for x in losses):
        raise AssertionError(f"{path}: losses {losses}")
    for first, what in ((6, "after the migration"), (12, "after the grow")):
        same = losses[first:first + 6] == ref[first:first + 6]
        log(f"[{path}] steps {first}..{first + 5} {what} equal the "
            f"uninterrupted run bitwise: {same}")
        if not same:
            raise AssertionError(f"{path}: steps {what} differ from the "
                                 f"uninterrupted run: {losses} vs {ref}")
    _share(path, "the (1, 4) pool", out["share_before"], 4)
    _share(path, "the (2, 4) pool", out["share_after"], 8)
    if "slice_failed" not in out["events"]:
        raise AssertionError(f"{path}: no slice_failed IRQ")
    if counts.get("flash_attention", 0) != want:
        raise AssertionError(f"{path}: flash launched "
                             f"{counts.get('flash_attention', 0)}, want "
                             f"{want}")
    count_path(path, counts, launches)
    torch.cuda.empty_cache()
    log(f"[{path}] took {time.perf_counter() - t0:.1f}s")
    return out


def autoscaler_phase(device, launches, smi, B=4, C=256):
    """A real queue_buildup IRQ grows a serving tenant: qwen1.5-0.5b's
    decode program at full width on a (1, 1) slice of a 2×4 view of the
    card, ``slo`` with a high watermark of 4, its ring caches the
    tenant's state. Floods of ``run_async`` decode steps (teacher-forced
    tokens) behind a held op raise the IRQs; ``poll`` grows the slice to
    (1, 2) (pool 1/8 → 2/8, program re-bound, caches checkpointed and
    restored); a calm period shrinks it back; a grow to (1, 2) again in
    row 1; three (1, 1) fillers fragment row 0 so that neither (1, 4)
    nor (2, 2) fits; the next flood's grow defragments and takes (1, 4).
    Gates: every step's logits equal a native decode at the same
    positions bitwise; the shapes, shares and re-binding above;
    ``VMM.stats()["autoscaler"]`` holds grow, shrink, grow, grow
    (defragmented)."""
    import threading
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core import VMM, Autoscaler, ProgramRequest
    from repro_torch.core.scheduler import IRQ_DEGRADED
    from repro_torch.kernels import common
    from repro_torch.models import Model
    from repro_torch.parallel import build_decode
    arch, path = "qwen1.5-0.5b", "autoscaler"
    cfg = get_config(arch)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(11)
    tokens = torch.randint(0, cfg.vocab, (64, B, 1), generator=gen,
                           device=device, dtype=torch.int32)
    model = Model(cfg, device)
    grid = np.empty(VIEW, dtype=object)
    grid[:] = device
    common.reset_launches()
    vmm = VMM(grid, policy="slo", hbm_per_chip=None if device.type == "cuda"
              else 1 << 30,
              scheduler_opts={"queue_high_watermark": 4,
                              "queue_buildup_s": 0.02,
                              "queue_irq_cooldown_s": 0.01})
    got, timing = [], {}
    try:
        t = vmm.create_vm("server", (1, 1))
        prog = t.device.reprogram(ProgramRequest(arch, "decode", C, B,
                                                 reduced=False))
        params = as_program_params(
            prog.bitfile.abstract_args[0], model.init_compute_params(
                torch.Generator(device=device).manual_seed(10)))
        template = {"caches": Model(cfg, device="meta").init_cache(B, C)}
        t.state = {"caches": model.init_cache(B, C)}
        irqs = []
        t.cq.set_irq(IRQ_DEGRADED, lambda ev: irqs.append(
            (time.perf_counter(), ev.kind)))
        scaler = Autoscaler(vmm, sustain=2, window_s=30.0, cooldown_s=0.0,
                            calm_s=0.5)
        scaler.watch(t, state_template=template)

        def step(pos):
            return t.device.run(params, t.state["caches"], tokens[pos],
                                torch.tensor(pos, dtype=torch.int32,
                                             device=device))[0]

        def flood(n=11):
            """A held op, then n decode steps queued behind it past the
            watermark for longer than the buildup time."""
            gate = threading.Event()
            held = vmm.plane.submit(t, "run", gate.wait, {})
            time.sleep(0.02)
            caches = t.state["caches"]
            futs = []
            for i in range(n):
                pos = len(got) + i
                futs.append(t.device.run_async(
                    params, caches, tokens[pos],
                    torch.tensor(pos, dtype=torch.int32, device=device)))
                if i >= 7:
                    time.sleep(0.03)
            gate.set()
            held.result(timeout=60)
            got.extend(f.result(timeout=600)[0] for f in futs)

        def poll(want, what, k):
            sync(device)
            whole = vmm.card_bytes(device)
            t1 = time.perf_counter()
            acts = scaler.poll()
            t2 = time.perf_counter()
            names = [a["action"] for a in acts]
            share = t.pool.n_segments * t.pool.segment_bytes / whole
            last_irq = max((ti for ti, kind in irqs
                            if kind == "queue_buildup"), default=None)
            log(f"[{path}] {what}: actions {acts}; slice "
                f"{t.vslice.spec.shape} at {t.vslice.spec.origin}, pool "
                f"{share:.5f} of the card's free memory; poll {t2 - t1:.3f}s"
                + (f", last queue_buildup IRQ -> {want} done "
                   f"{t2 - last_irq:.3f}s" if want == "grow" and last_irq
                   else ""))
            if names != [want]:
                raise AssertionError(f"{path}: {what}: {names}")
            if t.vslice.spec.shape != (1, k):
                raise AssertionError(f"{path}: {what}: slice "
                                     f"{t.vslice.spec.shape}")
            if t.program.bitfile.slice_fingerprint != t.vslice.fingerprint:
                raise AssertionError(f"{path}: program not re-bound")
            _share(path, what, share, k)
            timing.setdefault(want, []).append(t2 - t1)
            irqs.clear()
            return acts[0]

        flood()
        poll("grow", "flood 1 -> grow to (1, 2)", 2)
        got.extend(step(len(got)) for _ in range(2))
        time.sleep(0.6)
        poll("shrink", "calm -> shrink to (1, 1)", 1)
        got.extend(step(len(got)) for _ in range(2))
        # row 0 held at (0,1), (0,2), (0,3): the next (1, 2) goes to row 1
        p1 = vmm.create_vm("p1", (1, 1))
        vmm.create_vm("f2", (1, 1))
        p2 = vmm.create_vm("p2", (1, 1))
        flood()
        poll("grow", "flood 2 -> grow to (1, 2) in row 1", 2)
        vmm.create_vm("f1", (1, 1))
        p4 = vmm.create_vm("p4", (1, 1))
        vmm.create_vm("f3", (1, 1))
        for p in (p1, p2, p4):
            vmm.destroy_vm(p.name)
        log(f"[{path}] fragmented: {vmm.floorplanner.snapshot()}, "
            f"fragmentation {vmm.floorplanner.fragmentation():.3f}")
        flood()
        act = poll("grow", "flood 3 -> defragment, grow to (1, 4)", 4)
        if not act.get("defragmented"):
            raise AssertionError(f"{path}: the last grow did not defragment")
        got.extend(step(len(got)) for _ in range(2))
        sync(device)
        counts = dict(common.LAUNCHES)
        st = vmm.stats()["autoscaler"]
    finally:
        vmm.shutdown()
    actions = [(a["action"], a.get("defragmented", False))
               for a in st["actions"]]
    log(f"[{path}] VMM.stats()['autoscaler'] actions {actions}; watched "
        f"{st['watched']}")
    if actions != [("grow", False), ("shrink", False), ("grow", False),
                   ("grow", True)]:
        raise AssertionError(f"{path}: actions {actions}")
    # the same positions natively, teacher-forced, on a fresh ring
    step_fn, _ = build_decode(cfg, device, ShapeCell("n", C, B, "decode"))
    caches = model.init_cache(B, C)
    same = True
    for pos, logits in enumerate(got):
        want, caches = step_fn(params, caches, tokens[pos],
                               torch.tensor(pos, dtype=torch.int32,
                                            device=device))
        same = same and torch.equal(logits, want)
    log(f"[{path}] {smi}: {len(got)} decode steps through the tenant "
        f"(grown, shrunk, grown, grown after a defragment) equal a native "
        f"decode at the same positions bitwise: {same}; grow poll s "
        f"{[round(x, 3) for x in timing['grow']]}, shrink "
        f"{[round(x, 3) for x in timing['shrink']]}; launches={counts}")
    if not same:
        raise AssertionError(f"{path}: logits differ from native decode")
    if counts.get("decode_attention", 0) != len(got) * cfg.n_layers:
        raise AssertionError(f"{path}: decode_attention launches "
                             f"{counts.get('decode_attention', 0)}")
    count_path(path, counts, launches)
    del params, caches, got
    torch.cuda.empty_cache()
    log(f"[{path}] took {time.perf_counter() - t0:.1f}s")


#: the long-context cases: (arch, path, prompt tokens, capacity); the
#: prompt leaves room for 16 new tokens in the capacity, whose page row
#: is the Sk of every chunk call
LONG_CONTEXT = (("qwen1.5-0.5b", "long-context-qwen", 16368, 16384,
                 "chunked"),
                ("recurrentgemma-2b", "long-context-recurrentgemma", 4096,
                 4112, "banded"))
LONG_NEW, LONG_CHUNK = 16, 512
#: the long paths against the dense formula at one layer
LONG_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def long_attention_check(device, name, Sq, Sk, Hq, Hkv, hd, window, q0):
    """One chunk call's attention_core (the long path its row takes)
    against the dense formula on the same inputs, fp32 and bf16; in
    bf16 the peak memory of the call, long path against dense."""
    import torch
    from repro_torch.models import attention as attn
    gen = torch.Generator(device=device).manual_seed(Sk + q0)
    q = torch.randn((1, Sq, Hq, hd), generator=gen, device=device)
    k = torch.randn((1, Sk, Hkv, hd), generator=gen, device=device)
    v = torch.randn((1, Sk, Hkv, hd), generator=gen, device=device)
    qp = torch.arange(q0, q0 + Sq, device=device)
    kp = torch.arange(Sk, device=device)
    route = "banded" if 0 < window < Sk else "chunked"

    def dense(q, k, v):
        rep = Hq // Hkv
        return attn._direct(
            attn._grouped(q, Hq), k.repeat_interleave(rep, dim=2),
            v.repeat_interleave(rep, dim=2),
            attn._mask_bias(qp, kp, True, window),
            1.0 / hd ** 0.5).reshape(q.shape).to(q.dtype)

    def peak(fn):
        sync(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        fn()
        sync(device)
        return torch.cuda.max_memory_allocated(device) - base

    out = {}
    for dt in ("float32", "bfloat16"):
        a, b, c = (x.to(getattr(torch, dt)) for x in (q, k, v))
        attn.ROUTES.clear()
        got = attn.attention_core(a, b, c, q_pos=qp, k_pos=kp,
                                  window=window)
        if dict(attn.ROUTES) != {route: 1}:
            raise AssertionError(f"{name}: route {dict(attn.ROUTES)}")
        err = _max_err(got, dense(a, b, c))
        log(f"[{name}] one layer {route} vs dense, {dt} Sq={Sq} Sk={Sk} "
            f"{Hq}/{Hkv} hd {hd} window {window} q from {q0}: max abs err "
            f"{err:.3g} (tol {LONG_TOL[dt]:g})")
        if not err <= LONG_TOL[dt]:
            raise AssertionError(f"{name}: {route} path disagrees with the "
                                 "dense formula")
        if dt == "bfloat16":
            out["long_bytes"] = peak(lambda: attn.attention_core(
                a, b, c, q_pos=qp, k_pos=kp, window=window))
            out["dense_bytes"] = peak(lambda: dense(a, b, c))
    del q, k, v, a, b, c, got
    return out


def long_context_phase(device, launches, smi):
    """ROADMAP item 6 on the main path: a long prompt through
    ``ServeEngine`` in 512-token chunks (the attention over each chunk's
    page row runs the chunked online softmax for qwen1.5-0.5b at full
    depth, the banded path for recurrentgemma-2b's swa layers), then 16
    decode steps (fused paged decode and the sampler; the RG-LRU scan
    in recurrentgemma's chunks). Gates: one layer's long path within
    LONG_TOL of the dense formula; ids in range, pages leased == freed,
    no full prefill, every chunk call of every attention layer on the
    route named. Prints the peak memory of one chunk call, long path
    against dense, and of the whole prefill, and the prefill's host
    seconds."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.models import Model
    from repro_torch.models import attention as attn
    from repro_torch.serving import ServeEngine
    t0 = time.perf_counter()
    for arch, path, plen, cap, route in LONG_CONTEXT:
        cfg = get_config(arch)
        window = cfg.window if route == "banded" else 0
        n_attn = sum(cfg.layer_mixer(i) in ("attn", "swa")
                     for i in range(cfg.n_layers))
        mem = long_attention_check(
            device, path, LONG_CHUNK, cap, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, window, plen - LONG_CHUNK)
        log(f"[{path}] {smi}: one chunk call's attention at Sk={cap}, bf16: "
            f"peak {mem['long_bytes'] / 2**20:.1f} MiB {route} against "
            f"{mem['dense_bytes'] / 2**20:.1f} MiB dense")
        model = Model(cfg, device)
        params = model.init_compute_params(
            torch.Generator(device=device).manual_seed(0))
        prompt = np.random.default_rng(3).integers(0, cfg.vocab, (plen,))
        eng = ServeEngine(cfg, model, 1, cap, page_size=16,
                          chunk_tokens=LONG_CHUNK,
                          state_paging=model.state_row_bytes() > 0)
        torch.cuda.empty_cache()
        sync(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        attn.ROUTES.clear()
        common.reset_launches()
        rid = eng.submit(prompt, max_new_tokens=LONG_NEW, temperature=0.0)
        t1 = time.perf_counter()
        while eng.stats.prefills == 0:
            eng.step(params)
        sync(device)
        prefill_s = time.perf_counter() - t1
        prefill_peak = torch.cuda.max_memory_allocated(device) - base
        t1 = time.perf_counter()
        while eng.has_work():
            eng.step(params)
        decode_s = time.perf_counter() - t1
        counts, routes = dict(common.LAUNCHES), dict(attn.ROUTES)
        s = eng.stats
        out = eng.completed[rid].out_tokens
        chunks = -(-plen // LONG_CHUNK)
        log(f"[{path}] {smi}: {arch} at full depth, bf16, a {plen}-token "
            f"prompt in {s.prefill_chunks} chunks of {LONG_CHUNK} over page "
            f"rows of {cap} (prefill {prefill_s:.2f}s host clock, peak "
            f"{prefill_peak / 2**30:.3f} GiB above the weights and the "
            f"engine's KV and state arrays), "
            f"{len(out)} new tokens in {decode_s:.2f}s; routes {routes} "
            f"(want {route} {n_attn * chunks}); full_prefills="
            f"{s.full_prefills}, pages leased={s.pages_leased} freed="
            f"{s.pages_freed}, state pages leased={s.state_pages_leased} "
            f"freed={s.state_pages_freed}; ids {out}; launches={counts}")
        if routes != {route: n_attn * chunks}:
            raise AssertionError(f"{path}: routes {routes}")
        if len(out) != LONG_NEW or not all(0 <= x < cfg.vocab for x in out):
            raise AssertionError(f"{path}: ids {out}")
        if s.full_prefills or s.pages_leased != s.pages_freed or \
                s.state_pages_leased != s.state_pages_freed:
            raise AssertionError(f"{path}: paging invariants broken")
        count_path(path, counts, launches)
        del params, model, eng
        torch.cuda.empty_cache()
    log(f"[long-context] took {time.perf_counter() - t0:.1f}s")


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


def build_weights(device):
    """Every served family's weights once (random from seed 0, product
    weights in bf16), reused by the serve, VMM-program and KV-hierarchy
    phases: rwkv6-7b first, on an empty card, since its fp32 init
    (~30 GB) lives until its bf16 copy exists."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    out = {}
    for arch in ("rwkv6-7b", "recurrentgemma-2b", "qwen1.5-0.5b"):
        cfg = get_config(arch)
        model = Model(cfg, device)
        t0 = time.perf_counter()
        params = model.init_compute_params(
            torch.Generator(device=device).manual_seed(0))
        sync(device)
        torch.cuda.empty_cache()
        log(f"[weights] {arch}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, vocab {cfg.vocab}; made in "
            f"{time.perf_counter() - t0:.1f}s, "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the card "
            f"so far; state row {model.state_row_bytes()} B per slot, KV "
            f"page {model.kv_page_bytes(16)} B")
        out[arch] = (cfg, model, params)
    return out


def recurrent_serve_phases(device, launches, weights):
    """recurrentgemma-2b and rwkv6-7b at full width and depth (bf16
    compute) through ``ServeEngine`` with paged recurrent state,
    monolithic and chunked, then chunked through a VMM tenant (policy
    ``slo``): its ids must equal the native chunked run's. → (the native
    modes' figures, the virtualized ones')."""
    modes, virt = {}, {}
    for arch, short, _ in RECURRENT_ARCHS:
        cfg, model, params = weights[arch]
        requests = make_requests(cfg.vocab)
        kw = {"state_paging": True}
        for mode in ("monolithic", "chunked"):
            path = f"{short}-{mode}"
            modes[path] = serve_phase(mode, cfg, model, params, requests,
                                      launches, path=path, engine_kw=kw)
            native = modes[path].pop("outs")
        virt[short] = virtualized_phase(
            "chunked", "slo", cfg, model, params, requests, native,
            launches, path=f"{short}-virtualized-chunked", engine_kw=kw,
            strict=True)
        ratio = virt[short]["step_p50_ms"] / modes[path]["step_p50_ms"]
        log(f"[{short}-virtualized-chunked] virtualization ratio of engine "
            f"step p50: {virt[short]['step_p50_ms']:.3f} / "
            f"{modes[path]['step_p50_ms']:.3f} ms = {ratio:.3f}")
    return modes, virt


# ---------------------------------------------------------------------------
# the recurrent families' VMM programs, the KV page hierarchy, the mux
# ---------------------------------------------------------------------------

#: the kernel a prefill program runs for each recurrent family's
#: recurrence (its CUDA kernel name), timed on the served path at B=4
RECURRENCE_KERNELS = {"recurrentgemma": ("rglru_scan", "rglru_scan_kernel"),
                      "rwkv6": ("rwkv6_wkv", "wkv_chunk_kernel")}


#: the bytes a prefill program's outputs may hold beyond the reckoning of
#: their own size (the allocator's rounding)
STATE_SLACK = 0.10


def state_bytes(cfg, B, C):
    """The reckoning of what a prefill program at batch ``B`` into rings
    of ``C`` slots returns, from the config: the caches the decode
    program takes (``init_cache``'s shapes and dtypes on meta: rings and
    recurrent rows)."""
    from repro_torch.checkpointing.checkpoint import flatten_with_path
    from repro_torch.models import Model
    caches = Model(cfg, device="meta").init_cache(B, C)
    return sum(t.numel() * t.element_size()
               for _, t in flatten_with_path(caches))


def check_state_bytes(path, cfg, logits, held, B, S):
    """The device bytes a prefill program's outputs hold once its
    activations are gone (``held``: ``memory_allocated`` after the run
    less before it) against the reckoning of the caches' own size plus
    the logits; fails beyond ``STATE_SLACK``. A state row that is a view
    of its layer's (B, S, d) activation keeps that whole activation."""
    want = state_bytes(cfg, B, S) + logits.numel() * logits.element_size()
    ratio = held / want
    ok = ratio <= 1 + STATE_SLACK
    log(f"[{path}] state memory after the prefill program (B={B} S={S}): "
        f"{held / 2**20:.1f} MiB held by its outputs, reckoned "
        f"{want / 2**20:.1f} MiB (caches' own size + logits): ratio "
        f"{ratio:.4f} (limit {1 + STATE_SLACK:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{path}: the caches hold {held} B, beyond "
                             f"their own {want} B")


def recurrent_programs_phase(device, launches, weights, arch, short, depth,
                             S=4096, B=4, n_decode=32, n_cut_decode=6):
    """A recurrent family's VMM programs at full width and depth through
    the guest API: the prefill program at B, S into rings of capacity S
    (a swa ring holds min(window, S)) and recurrent rows, then the decode
    program for ``n_decode`` greedy steps at pos S… (the rings wrap). The
    ids must equal native ``Model.prefill``/``decode`` on the same
    weights in this call; the recurrence kernel's device time at B is
    read from a trace of the program's prefill, and the device bytes its
    outputs hold are held to the reckoning of their own size
    (:func:`check_state_bytes`). Then the programs at a
    cut depth (``depth`` layers, fp32 compute, B=1): the prefill at S=130
    and ``n_cut_decode`` decode steps past the rings' end, their logits
    on the card against the CPU plain path (tol 1e-3)."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core import ProgramRequest
    from repro_torch.kernels import common
    from repro_torch.launch.serve import virtual_server
    from repro_torch.parallel.steps import build_decode, build_prefill
    cfg, model, served = weights[arch]
    n_attn = sum(s.is_attn for s in model.specs)
    path = f"{short}-vmm-programs"
    vmm, tenant = virtual_server(device, "hybrid")
    try:
        dev = tenant.device
        t0 = time.perf_counter()
        prog = dev.reprogram(ProgramRequest(arch, "prefill", S, B,
                                            reduced=False))
        t_pf = time.perf_counter() - t0
        params = as_program_params(prog.bitfile.abstract_args[0], served)
        gen = torch.Generator(device=device).manual_seed(6)
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                               device=device, dtype=torch.int32)
        dev.run(params, {"tokens": tokens[:, :64]})          # warm-up
        sync(device)
        common.reset_launches()
        before = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            logits, caches = dev.run(params, {"tokens": tokens})
            sync(device)
        t_prefill = time.perf_counter() - t0
        check_state_bytes(path, cfg, logits, torch.cuda.memory_allocated(
            device) - before, B, S)
        counts = dict(common.LAUNCHES)
        kname, cuda_name = RECURRENCE_KERNELS[short]
        # a trace may lose events: the mean is over the recorded ones
        # (None when the trace kept none)
        rec = [(t, n) for t, n, key in device_rows(prof) if cuda_name in key]
        rec_events = sum(n for _, n in rec)
        rec_ms = sum(t for t, _ in rec) / 1e3 / rec_events \
            if rec_events else None
        C = min(cfg.window, S) if "swa" in cfg.block_pattern else S
        if n_attn and tuple(caches["k"].shape) != (
                n_attn, B, C, cfg.n_kv_heads, cfg.d_head):
            raise AssertionError(f"{path}: rings {tuple(caches['k'].shape)}")
        if len(caches["rows"]) != cfg.n_layers:
            raise AssertionError(f"{path}: no recurrent rows")
        t0 = time.perf_counter()
        dev.reprogram(ProgramRequest(arch, "decode", S, B, reduced=False))
        t_dc = time.perf_counter() - t0

        def greedy(run, lg, c):
            ids = []
            for i in range(n_decode):
                tok = lg[:, :cfg.vocab].argmax(-1).to(torch.int32)[:, None]
                ids.append(tok[:, 0].tolist())
                pos = torch.tensor(S + i, dtype=torch.int32, device=device)
                lg, c = run(params, c, tok, pos)
            return ids, lg

        common.reset_launches()
        t0 = time.perf_counter()
        ids, last = greedy(dev.run, logits, caches)
        sync(device)
        t_steps = time.perf_counter() - t0
        dcounts = dict(common.LAUNCHES)
        for k, v in dcounts.items():
            counts[k] = counts.get(k, 0) + v
        if not bool(torch.isfinite(last.float()).all()):
            raise AssertionError(f"{path}: non-finite decode logits")
        per_step = dcounts.get("decode_attention", 0) / n_decode
        del caches
        lg, c = model.prefill(params, {"tokens": tokens}, capacity=S)
        native, _ = greedy(model.decode, lg, c)
        del c
        same = ids == native
        log(f"[{path}] {arch}: prefill program B={B} S={S} (reprogram "
            f"{t_pf:.2f}s) {1e3 * t_prefill:.1f} ms, {kname} "
            f"{counts.get(kname, 0)} launches, {rec_events} recorded in the "
            f"trace, at {fmt_ms(rec_ms)} device ms each (B={B}, the "
            f"recorded events' mean); decode program C={C} "
            f"(reprogram {t_dc:.2f}s): {n_decode} greedy steps at pos "
            f"{S}..{S + n_decode - 1} in {t_steps:.3f}s "
            f"({1e3 * t_steps / n_decode:.1f} ms/step); decode_attention "
            f"per step {per_step:g} (want {n_attn}); ids vs native "
            f"prefill/decode: {'identical' if same else 'DIFFER'}; "
            f"launches={counts}")
        if per_step != n_attn:
            raise AssertionError(f"{path}: decode_attention must launch "
                                 "once per attention layer per step")
        if not same:
            raise AssertionError(f"{path}: program ids differ from native")
        count_path(path, counts, launches)
    finally:
        vmm.shutdown()
    del params, logits
    torch.cuda.empty_cache()

    # cut depth, fp32: the prefill program fills rings of 130 slots (a
    # swa ring too: 130 < window), then the decode program steps past
    # them, so every ring wraps; the card's greedy token feeds both sides
    cut = dataclasses.replace(cfg, n_layers=depth, compute_dtype="float32")
    cpu = torch.device("cpu")
    progs = {}
    for d in (device, cpu):
        pf, abstract = build_prefill(cut, d, ShapeCell("c", 130, 1,
                                                       "prefill"))
        dc, _ = build_decode(cut, d, ShapeCell("c", 130, 1, "decode"))
        progs[d.type] = (pf, dc)
    p_dev = program_params(abstract[0], cut, device, 19)
    p_cpu = cpu_tree(p_dev)
    tok = torch.from_numpy(make_requests(cfg.vocab, 2, seed=8)[1][0][None]
                           ).to(torch.int32)
    lg_dev, c_dev = progs[device.type][0](p_dev, {"tokens": tok.to(device)})
    lg_cpu, c_cpu = progs["cpu"][0](p_cpu, {"tokens": tok})
    errs, scale = [], 0.0
    for step in range(n_cut_decode + 1):
        got = lg_dev[:, :cfg.vocab].float().cpu()
        want = lg_cpu[:, :cfg.vocab]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{path}: non-finite cut-depth logits")
        errs.append(_max_err(got, want))
        scale = max(scale, float(want.abs().max()))
        if step == n_cut_decode:
            break
        nxt = got.argmax(-1)[:, None].to(torch.int32)
        lg_dev, c_dev = progs[device.type][1](
            p_dev, c_dev, nxt.to(device),
            torch.tensor(130 + step, dtype=torch.int32, device=device))
        lg_cpu, c_cpu = progs["cpu"][1](
            p_cpu, c_cpu, nxt, torch.tensor(130 + step, dtype=torch.int32))
    err = max(errs)
    log(f"[{path}] programs at {depth} layers, fp32, B=1: prefill S=130 "
        f"then {n_cut_decode} decode steps at pos 130..{129 + n_cut_decode} "
        f"({'the rings wrap' if n_attn else 'recurrent rows only'}), "
        f"logits card vs CPU: max_abs_err={err:.3g} per "
        f"step {[f'{e:.3g}' for e in errs]} (max |logit| {scale:.3g}, tol "
        f"1e-3) {'ok' if err <= 1e-3 else 'FAIL'}")
    if err > 1e-3:
        raise AssertionError(f"{path}: card and CPU program logits "
                             "disagree")
    del p_dev, c_dev
    torch.cuda.empty_cache()
    return {"rec_ms_b4": rec_ms, "kernel": kname}


def _hist(obs, name):
    """Summary of histogram ``name`` (all labels merged: count, sum,
    p50 of the first label set)."""
    h = obs.registry.snapshot()["histograms"].get(name, {})
    if not h:
        return {"count": 0, "sum": 0.0, "p50": 0.0}
    first = next(iter(h.values()))
    return {"count": sum(v["count"] for v in h.values()),
            "sum": sum(v["sum"] for v in h.values()), "p50": first["p50"]}


def kv_hierarchy_phase(device, launches, weights):
    """The KV page hierarchy at full width and depth. qwen1.5-0.5b
    (24 layers, 16-token pages), batch 4, capacity 256, chunk_tokens 32,
    greedy: (1) sharing — 8 requests, 4 of them a common 64-token prefix
    (4 pages) with distinct tails of 16–66 tokens, the first of them
    admitted with the first batch and the other three later: at least 3
    warm admissions covering 192 tokens, CoW forks counted, the ids of the
    same run without sharing; (2) swap — a pool of 32 of the 64 pages of
    the KV working set, 96 new tokens a request: pages swapped out and
    refaulted, every request its full budget, the unpressured ids, pages
    leased == freed, refcounts consistent; (3) state swap — recurrentgemma
    with paged state rows on half of its KV and state working set: state
    pages parked, the unpressured ids."""
    import numpy as np
    from repro_torch.core.mmu import SegmentPool
    from repro_torch.kernels import common
    from repro_torch.obs import ObsHub

    def run(cfg, model, params, requests, path=None, obs=None, **kw):
        common.reset_launches()
        eng, outs, wall, _ = serve(cfg, model, params, requests, 32,
                                   obs=obs, engine_kw=kw)
        if path is not None:
            count_path(path, dict(common.LAUNCHES), launches)
            log(f"[kv-hierarchy] {path}: launches={dict(common.LAUNCHES)}")
        s = eng.stats
        if s.completed != len(requests) or any(
                len(o) != n for o, (_, n, _) in zip(outs, requests)):
            raise AssertionError(f"{path}: a request lost tokens")
        if s.pages_leased != s.pages_freed or \
                s.state_pages_leased != s.state_pages_freed or \
                not eng.kv.pool.refcounts_consistent():
            raise AssertionError(f"{path}: paging invariants broken")
        return eng, outs, wall

    cfg, model, params = weights["qwen1.5-0.5b"]
    pb = model.kv_page_bytes(16)
    rng = np.random.default_rng(21)
    prefix = rng.integers(0, cfg.vocab, 64)
    shared = [np.concatenate([prefix, rng.integers(0, cfg.vocab, t)])
              for t in (16, 66, 37, 50)]
    others = [rng.integers(0, cfg.vocab, n) for n in (48, 97, 33, 120)]
    order = [shared[0], *others[:3], *shared[1:], others[3]]
    requests = [(p, 32, 0.0) for p in order]
    _, cold, _ = run(cfg, model, params, requests)
    obs = ObsHub(enabled=True)
    eng, warm, wall = run(cfg, model, params, requests,
                          "kv-hierarchy-share", obs, share_prefix=True)
    s = eng.stats
    log(f"[kv-hierarchy] share: qwen1.5-0.5b, page {pb} B: "
        f"{s.shared_prefix_hits} warm admissions, {s.shared_prefix_tokens} "
        f"shared tokens, {s.cow_forks} CoW forks, {s.prefill_chunks} "
        f"chunks, {wall:.3f}s; ids vs share_prefix=False: "
        f"{'identical' if warm == cold else 'DIFFER'}")
    if s.shared_prefix_hits < 3 or s.shared_prefix_tokens < 192 \
            or s.cow_forks <= 0 or warm != cold \
            or not eng.kv.no_double_mapping():
        raise AssertionError("kv-hierarchy: sharing gates failed")
    eng.kv.prefix.evict_all()
    if eng.kv.memory_stats()["segments_in_use"] != 0:
        raise AssertionError("kv-hierarchy: shared frames leaked")
    del eng

    swap_reqs = [(p, 96, 0.0) for p, _, _ in make_requests(cfg.vocab)]
    _, ref, _ = run(cfg, model, params, swap_reqs)
    obs = ObsHub(enabled=True)
    pool = SegmentPool(total_bytes=32 * pb, backend="bitmap",
                       segment_bytes=pb)
    eng, got, wall = run(cfg, model, params, swap_reqs, "kv-hierarchy-swap",
                         obs, swap=True, pool=pool)
    s = eng.stats
    out_h, ref_h = _hist(obs, "kv_swap_out_s"), _hist(obs, "kv_refault_s")
    moved = s.swap_outs
    log(f"[kv-hierarchy] swap: pool 32 of 64 pages ({32 * pb} B): "
        f"{s.swap_outs} pages swapped out in {out_h['count']} parks, "
        f"{s.swap_ins} refaulted, {s.deferred} deferred, {wall:.3f}s; "
        f"kv_swap_out_s p50 {1e3 * out_h['p50']:.3f} ms a park "
        f"({1e3 * out_h['sum'] / max(moved, 1):.3f} ms a page, "
        f"{pb * moved / max(out_h['sum'], 1e-9) / 1e9:.2f} GB/s), "
        f"kv_refault_s p50 {1e3 * ref_h['p50']:.3f} ms a page "
        f"({pb * s.swap_ins / max(ref_h['sum'], 1e-9) / 1e9:.2f} GB/s), "
        f"{pb} B a page; ids vs unpressured: "
        f"{'identical' if got == ref else 'DIFFER'}")
    if s.swap_outs <= 0 or s.swap_ins <= 0 or got != ref:
        raise AssertionError("kv-hierarchy: swap gates failed")
    del eng, pool

    cfg, model, params = weights["recurrentgemma-2b"]
    pb = model.kv_page_bytes(16)
    state_pages = -(-model.state_row_bytes() // pb)
    n_pages = (4 * (256 // 16) + 4 * state_pages) // 2
    swap_reqs = [(p, 96, 0.0) for p, _, _ in make_requests(cfg.vocab)]
    _, ref, _ = run(cfg, model, params, swap_reqs, state_paging=True)
    obs = ObsHub(enabled=True)
    pool = SegmentPool(total_bytes=n_pages * pb, backend="bitmap",
                       segment_bytes=pb)
    eng, got, wall = run(cfg, model, params, swap_reqs,
                         "kv-hierarchy-state-swap", obs, swap=True,
                         pool=pool, state_paging=True)
    s = eng.stats
    st_h = _hist(obs, "state_swap_out_s")
    sr_h = _hist(obs, "state_refault_s")
    row = model.state_row_bytes()
    log(f"[kv-hierarchy] state swap: recurrentgemma-2b, pool {n_pages} "
        f"pages of {pb} B (half of 64 KV + {4 * state_pages} state pages): "
        f"{s.state_swap_outs} state pages parked / {s.state_swap_ins} "
        f"refaulted, {s.swap_outs} / {s.swap_ins} KV pages, {wall:.3f}s; "
        f"state_swap_out_s p50 {1e3 * st_h['p50']:.3f} ms a row of {row} B "
        f"({row * st_h['count'] / max(st_h['sum'], 1e-9) / 1e9:.2f} GB/s), "
        f"state_refault_s p50 {1e3 * sr_h['p50']:.3f} ms "
        f"({row * sr_h['count'] / max(sr_h['sum'], 1e-9) / 1e9:.2f} GB/s); "
        f"ids vs unpressured: {'identical' if got == ref else 'DIFFER'}")
    if s.state_swap_outs <= 0 or got != ref:
        raise AssertionError("kv-hierarchy: state swap gates failed")


#: the mux's families: all eight decoder-only families at full width,
#: (arch, layers kept (None: all), experts kept (None: all)). The CRC
#: hashes every weight byte on the host at ~0.25 GB/s, so depth is time:
#: qwen and recurrentgemma stay at full depth (their swap-ins move 1.24
#: and 6.72 GB), rwkv6 (15.2 GB at full depth, ~110 s of hashing at
#: register and swap-in) and the other five are cut to
#: 2 layers, mixtral keeping 2 of its 8 experts (top-2) and kimi its
#: dense first layer and one MoE layer with 8 of 384 experts (top-8):
#: the script stays inside its 1200 s
MUX_FAMILIES = (("qwen1.5-0.5b", None, None),
                ("recurrentgemma-2b", None, None), ("rwkv6-7b", 2, None),
                ("internlm2-1.8b", 2, None), ("phi3-mini-3.8b", 2, None),
                ("starcoder2-15b", 2, None), ("mixtral-8x7b", 2, 2),
                ("kimi-k2-1t-a32b", 2, 8))
#: the families served again one at a time under max_resident=1
MUX_CHURN = ("qwen1.5-0.5b", "recurrentgemma-2b", "rwkv6-7b")


def mux_phase(device, launches):
    """The eight families of ``MUX_FAMILIES`` at full width, cut as it
    says (random bf16 weights from seed 0), as bitstreams
    in one ``ModelRegistry`` that shares a VMM's ``ProgramLoader``,
    served by one ``MuxEngine`` (batch 2 a family, capacity 256,
    chunk_tokens 32, greedy, two prompts a family, interleaved): the ids
    of solo ``ServeEngine`` runs on the same weights; then churn under
    ``max_resident=1`` (one request of each of ``MUX_CHURN`` in turn:
    the budget evicts every other family, and each of the three is
    swapped back in for its turn): at least 2 swap-ins and 2 swap-outs,
    no CRC failure, the solo ids; then a flipped byte in a swapped-out
    host copy raises ``LegalityError`` and counts one CRC failure. The
    registry takes over the weights, so a swap-out frees the card.
    internvl2-2b and whisper-medium stay outside the mux, as in the
    reference (its ``serve --models`` is chunked only and passes no
    frontend inputs)."""
    import torch
    from repro_torch.core import LegalityError
    from repro_torch.kernels import common
    from repro_torch.launch.serve import virtual_server
    from repro_torch.obs import ObsHub
    from repro_torch.serving import ModelRegistry, MuxEngine
    from repro_torch.models import Model
    names = [name for name, _, _ in MUX_FAMILIES]
    prompts, solo, weights = {}, {}, {}
    for i, (name, depth, n_experts) in enumerate(MUX_FAMILIES):
        cfg = family_cfg(name, depth, n_experts=n_experts)
        model = Model(cfg, device)
        params = model.init_compute_params(
            torch.Generator(device=device).manual_seed(0))
        weights[name] = (cfg, model, params)
        prompts[name] = [(p, 32, 0.0) for p, _, _ in
                         make_requests(cfg.vocab, 2, seed=30 + i)]
        solo[name] = serve(cfg, model, params, prompts[name], 32, batch=2,
                           engine_kw={"state_paging": True})[1]
    log(f"[mux] {len(names)} families at full width: "
        + ", ".join(f"{n} {weights[n][0].n_layers} layers" for n in names)
        + " (mixtral 2 of 8 experts, kimi 8 of 384); internvl2-2b and "
        "whisper-medium outside the mux, as in the reference")
    obs = ObsHub(enabled=True)
    vmm, _ = virtual_server(device, "hybrid")
    try:
        reg = ModelRegistry(loader=vmm.loader, obs=obs)

        def register(name):
            cfg, model, params = weights.pop(name)
            t0 = time.perf_counter()
            e = reg.register(name, cfg=cfg, model=model, params=params,
                             device=device)
            return e, time.perf_counter() - t0

        # the registry is thread-safe and each registration hashes its
        # weights on a host core of its own: four at a time
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            done = dict(zip(names, pool.map(register, names)))
        for name, (e, s) in done.items():
            log(f"[mux] registered {name}: {e.param_bytes} B of weights, "
                f"crc {e.bitfile.crc}, register (CRC over every weight "
                f"byte, four registrations at a time) {s:.2f}s")
        log(f"[mux] {len(names)} registrations in "
            f"{time.perf_counter() - t0:.2f}s")
        del done
        mux = MuxEngine(reg, names, batch_per_model=2, capacity=256,
                        page_size=16, chunk_tokens=32, obs=obs)
        for name in names:
            mux.bind(f"tenant-{name}", name)
        for i in range(2):
            for name in names:
                p, n, t = prompts[name][i]
                mux.submit(p, tenant=f"tenant-{name}", max_new_tokens=n,
                           temperature=t)
        common.reset_launches()
        t0 = time.perf_counter()
        finished = mux.run_round()
        wall = time.perf_counter() - t0
        count_path("mux", dict(common.LAUNCHES), launches)
        log(f"[mux] launches={dict(common.LAUNCHES)}")

        def ordered(done):
            return [r.out_tokens for r in sorted(done, key=lambda r: r.rid)]

        first = {n: ordered(finished[n]) for n in names}
        log(f"[mux] {len(names)} families, {2 * len(names)} requests "
            f"interleaved in {wall:.3f}s: ids "
            f"vs solo runs: "
            + ", ".join(f"{n} {'identical' if first[n] == solo[n] else 'DIFFER'}"
                        for n in names))
        if first != solo:
            raise AssertionError("mux: ids differ from the solo runs")
        reg.max_resident = 1

        def serve_one(name):
            p, n, t = prompts[name][0]
            mux.submit(p, tenant=f"tenant-{name}", max_new_tokens=n,
                       temperature=t)
            if ordered(mux.run_round()[name])[0] != solo[name][0]:
                raise AssertionError(f"mux: {name} ids differ after churn")

        for name in MUX_CHURN:
            serve_one(name)
        st = reg.stats()
        swaps_in = sum(m["swap_ins"] for m in st["models"].values())
        swaps_out = sum(m["swap_outs"] for m in st["models"].values())
        log(f"[mux] churn under max_resident=1: ids identical to solo; "
            f"swap_ins={swaps_in} swap_outs={swaps_out} crc_checks="
            f"{st['crc_checks']} crc_failures={st['crc_failures']}")
        if swaps_in < 2 or swaps_out < 2 or st["crc_failures"] != 0:
            raise AssertionError("mux: churn gates failed")
        victim = min((n for n in MUX_CHURN if not reg.residency()[n]),
                     key=lambda n: reg[n].param_bytes)
        byte = reg[victim].host_params["tok_embed"].view(torch.uint8).view(-1)
        byte[0] ^= 1                                   # one flipped bit
        try:
            reg.params(victim)
        except LegalityError as exc:
            log(f"[mux] flipped byte in {victim}'s host copy refused: {exc}")
        else:
            raise AssertionError("mux: corrupted host copy was loaded")
        fails = reg.stats()["crc_failures"]
        log(f"[mux] crc_failures={fails} (registry), "
            f"{vmm.stats()['crc_failures']} (VMM stats, shared loader)")
        if fails != 1 or vmm.stats()["crc_failures"] != 1:
            raise AssertionError("mux: the CRC failure was not counted once")
        byte[0] ^= 1                       # restored: it loads and serves
        serve_one(victim)
        st = reg.stats()
        hist = obs.registry.snapshot()["histograms"]
        for name in MUX_CHURN:
            m = st["models"][name]
            si = hist.get("model_swap_in_s", {})
            so = hist.get("model_swap_out_s", {})
            key = next((k for k in si if name in k), None)
            okey = next((k for k in so if name in k), None)
            s_in = si[key]["p50"] if key else float("nan")
            s_out = so[okey]["p50"] if okey else float("nan")
            log(f"[mux] {name}: {m['param_bytes']} B; swap in/out "
                f"{m['swap_ins']}/{m['swap_outs']}; model_swap_in_s p50 "
                f"{s_in:.3f}s ({m['param_bytes'] / s_in / 1e9:.2f} GB/s, "
                f"CRC of every byte included), model_swap_out_s p50 "
                f"{s_out:.3f}s ({m['param_bytes'] / s_out / 1e9:.2f} GB/s)")
        if st["crc_failures"] != 1:
            raise AssertionError("mux: the restored copy failed its CRC")
        for g in mux.stats()["groups"].values():
            e = g["engine"]
            if e["pages_leased"] != e["pages_freed"] or \
                    e["state_pages_leased"] != e["state_pages_freed"]:
                raise AssertionError("mux: pages leased != freed")
    finally:
        vmm.shutdown()
    del reg, mux
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the other seven families: dense, MoE, VLM, enc-dec
# ---------------------------------------------------------------------------

#: the families phase: arch, its path name, the depth served on the card
#: (None: full; mixtral 16 of 32 layers, ~47 GB in bf16, and kimi its
#: dense first layer and one MoE layer at full width, ~40 GB), the KV
#: capacity (internvl2: 256 image rows + prompt + output), the depth of
#: the card-vs-CPU reference and the experts it keeps (kimi's 384 fp32
#: experts do not fit the host twice; None keeps the config's)
FAMILIES = (("internlm2-1.8b", "internlm2", None, 256, 1, None),
            ("phi3-mini-3.8b", "phi3", None, 256, 1, None),
            ("starcoder2-15b", "starcoder2", None, 256, 1, None),
            ("mixtral-8x7b", "mixtral", 16, 256, 1, None),
            ("kimi-k2-1t-a32b", "kimi", 2, 256, 2, 16),
            ("internvl2-2b", "internvl2", None, 512, 1, None),
            ("whisper-medium", "whisper", None, 256, 1, None))
for _arch, _short, *_ in FAMILIES:
    PATH_KERNELS[f"{_short}-monolithic"] = ("flash_attention",
                                            "fused_paged_decode")
    PATH_KERNELS[f"{_short}-chunked"] = ("fused_paged_decode",
                                         "sample_tokens")
    PATH_KERNELS[f"{_short}-virtualized"] = ("flash_attention",
                                             "fused_paged_decode")


def family_cfg(arch, depth=None, **kw):
    """The full-width config of ``arch``, cut to ``depth`` layers (the
    encoder too, for whisper, when ``enc_depth`` is given)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    enc_depth = kw.pop("enc_depth", None)
    n_experts = kw.pop("n_experts", None)
    if depth:
        kw["n_layers"] = depth
    if enc_depth and cfg.is_encdec:
        kw["encoder"] = dataclasses.replace(cfg.encoder, n_layers=enc_depth)
    if n_experts:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=n_experts)
    return dataclasses.replace(cfg, **kw)


def record_routes():
    """Wrap the MoE router so that every call's (probs, picks) is kept
    on the host, by the device of its input; → (records, undo)."""
    from repro_torch.models import moe
    records = {"cuda": [], "cpu": []}
    route = moe.route

    def recorded(cfg, p, xf):
        out = route(cfg, p, xf)
        records[xf.device.type].append((out[0].cpu(), out[2].cpu()))
        return out
    moe.route = recorded

    def undo():
        moe.route = route
    return records, undo


def compare_picks(arch, records):
    """The card's (token, k) expert picks against the CPU's: a pick that
    differs where the k-th and (k+1)-th CPU probabilities lie within
    1e-5 is reported; any other difference fails."""
    import torch
    cuda, cpu = records["cuda"], records["cpu"]
    if len(cuda) != len(cpu) or not cpu:
        raise AssertionError(f"{arch}: {len(cuda)} router calls on the "
                             f"card, {len(cpu)} on the CPU")
    picks = near = 0
    for (_, ig), (pc, ic) in zip(cuda, cpu):
        picks += ic.numel()
        bad = (ig != ic).any(-1).nonzero(as_tuple=True)[0]
        for t in bad.tolist():
            ps = torch.sort(pc[t], descending=True).values
            K = ic.shape[1]
            gap = float(ps[K - 1] - ps[K])
            if gap >= 1e-5:
                raise AssertionError(
                    f"{arch}: token {t}'s picks differ, card "
                    f"{ig[t].tolist()} CPU {ic[t].tolist()}, k-th and "
                    f"(k+1)-th probabilities {gap:.3g} apart")
            near += 1
    log(f"[families] {arch}: {len(cpu)} router calls, {picks} (token, k) "
        f"picks card vs CPU: {picks - near} equal, {near} differ at a near "
        f"tie (< 1e-5)")


def family_reference(device, arch, depth, n_experts):
    """Card against the CPU plain path for one family, fp32 at full
    width, cut to ``depth`` layers (one encoder layer for whisper), the
    experts cut to ``n_experts`` when given (on both sides): the prefill
    logits of a 40-token prompt (after the VLM's image rows, over the
    enc-dec's frames) and 3 paged decode steps (the card's greedy token
    feeds both), tolerance 1e-3 as in the recurrent reference; for the
    MoE families the expert picks of every router call too."""
    import torch
    from repro_torch.launch.serve import frontend_inputs
    from repro_torch.models import Model
    cpu = torch.device("cpu")
    cfg = family_cfg(arch, depth, compute_dtype="float32", enc_depth=1,
                     n_experts=n_experts)
    m_dev, m_cpu = Model(cfg, device), Model(cfg, cpu)
    params = m_dev.init(torch.Generator(device=device).manual_seed(17))
    p_cpu = cpu_tree(params)
    tok = torch.from_numpy(make_requests(cfg.vocab, 2, seed=8)[1][0][:40]
                           [None]).long()
    extra = {k: torch.from_numpy(v) for k, v in
             frontend_inputs(cfg, 1).items()}
    L = m_dev.n_prefix + 40
    ps = 16
    nb = -(-(L + 4) // ps)
    bt = torch.arange(nb, dtype=torch.int32)[None]
    records, undo = record_routes() if cfg.ffn_kind == "moe" \
        else (None, lambda: None)
    try:
        def prefill(m, p, d):
            batch = {"tokens": tok.to(d),
                     **{k: v.to(d) for k, v in extra.items()}}
            lg, caches = m.prefill(p, batch)
            return lg, m.write_prefill_paged(m.init_paged_state(1, nb, ps),
                                             caches, 0, bt[0].to(d), L, ps)
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
            pos = torch.tensor([L + step], dtype=torch.int32)
            lg_dev, st_dev = m_dev.decode_paged(params, st_dev,
                                                nxt.to(device),
                                                pos.to(device),
                                                bt.to(device))
            lg_cpu, st_cpu = m_cpu.decode_paged(p_cpu, st_cpu, nxt, pos, bt)
    finally:
        undo()
    err = max(errs)
    cut = f"{cfg.n_layers} layer(s)" + (
        f", {cfg.encoder.n_layers} encoder layer" if cfg.is_encdec else "") \
        + (f", {cfg.moe.n_experts} experts" if n_experts else "")
    log(f"[families] {arch} reference: full width cut to {cut}, fp32: "
        f"prefill S={L} + 3 paged decode steps, logits card vs CPU: "
        f"max_abs_err={err:.3g} per step {[f'{e:.3g}' for e in errs]} (max "
        f"|logit| {scale:.3g}, tol 1e-3) {'ok' if err <= 1e-3 else 'FAIL'}")
    if err > 1e-3:
        raise AssertionError(f"{arch}: card and CPU logits disagree")
    if records is not None:
        compare_picks(arch, records)
    del params, m_dev, st_dev, lg_dev
    torch.cuda.empty_cache()


def families_phase(device, launches, smi):
    """The repo's other seven families through ``ServeEngine`` on the
    card (random weights from seed 0, made in bf16; bf16 compute; batch
    4, 16-token pages, the phases' 8 requests): monolithic, and chunked
    (``chunk_tokens=32``) for all but the VLM and the enc-dec, which
    prefill monolithically; then monolithic through a VMM tenant
    (``hybrid``, every step through the guest API, pages from the
    tenant's pool). Per family and mode: every request finishes,
    ``full_prefills == 0``, pages (and state pages) leased == freed,
    every id below the vocabulary, each kernel of the path launched, the
    virtualized ids equal the native monolithic ones; then the family's
    card-vs-CPU reference. Each family's weights are
    made and freed in turn; the times print beside the card's name and
    power limit (``smi``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import frontend_inputs
    from repro_torch.models import Model
    t0 = time.perf_counter()
    for arch, short, depth, capacity, ref_depth, ref_experts in FAMILIES:
        cfg = family_cfg(arch, depth)
        model = Model(cfg, device)
        t = time.perf_counter()
        params = model.init_compute_params(
            torch.Generator(device=device).manual_seed(0))
        sync(device)
        torch.cuda.empty_cache()
        full = get_config(arch).n_layers
        log(f"[families] {arch}: {cfg.n_layers} of {full} layers"
            + (" (depth cut)" if cfg.n_layers != full else "")
            + (f", encoder {cfg.encoder.n_layers} layers, "
               f"{cfg.encoder.seq_len} stub frames" if cfg.is_encdec else "")
            + (f", {cfg.frontend.n_tokens} stub image rows"
               if cfg.family == "vlm" else "")
            + (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k}"
               if cfg.ffn_kind == "moe" else "")
            + f", d_model {cfg.d_model}, heads {cfg.n_heads}/"
            f"{cfg.n_kv_heads} hd {cfg.d_head}, vocab {cfg.vocab}; made in "
            f"{time.perf_counter() - t:.1f}s, "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the card; "
            f"capacity {capacity}, state row {model.state_row_bytes()} B")
        requests = make_requests(cfg.vocab)
        kw = {"state_paging": True,
              "extra_batch": frontend_inputs(cfg, 4)}
        modes = ("monolithic",) if kw["extra_batch"] else ("monolithic",
                                                           "chunked")
        for mode in modes:
            path = f"{short}-{mode}"
            r = serve_phase(mode, cfg, model, params, requests, launches,
                            path=path, engine_kw=kw, capacity=capacity)
            log(f"[time:{path}] {smi}: ttft p50 {r['ttft_p50_ms']:.2f} ms, "
                f"{r['tok_s']:.1f} tok/s over the run, engine step p50 "
                f"{r['step_p50_ms']:.3f} ms")
            if mode == "monolithic":
                native = r
        # the same requests through a VMM tenant (``serve --virtualized``,
        # hybrid): every step via the guest API, pages from its pool
        v = virtualized_phase("monolithic", "hybrid", cfg, model, params,
                              requests, native["outs"], launches,
                              path=f"{short}-virtualized", engine_kw=kw,
                              strict=True, capacity=capacity)
        log(f"[time:{short}-virtualized] {smi}: {v['tok_s']:.1f} tok/s over "
            f"the run, engine step p50 {v['step_p50_ms']:.3f} ms (native "
            f"{native['step_p50_ms']:.3f} ms, ratio "
            f"{v['step_p50_ms'] / native['step_p50_ms']:.3f})")
        del params, model
        torch.cuda.empty_cache()
        family_reference(device, arch, ref_depth, ref_experts)
    log(f"[families] phase took {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# train: the port's training path (flash's gradient, card against CPU,
# full width and depth, through a VMM tenant, resume)
# ---------------------------------------------------------------------------

#: flash's gradient on the card, (B, S, Hq, Hkv, hd, window): qwen's heads
#: at the train phase's width, starcoder2's hd-128 GQA 48/4 and
#: recurrentgemma's hd 256 10/1 with its window of 2048 at S = 2500
FLASH_GRAD_SHAPES = ((2, 512, 16, 16, 64, 0), (1, 512, 48, 4, 128, 0),
                     (1, 2500, 10, 1, 256, 2048))
GRAD_TOL = {"bfloat16": 3e-2, "float32": 2e-5}
TRAIN_ARCH = "qwen1.5-0.5b"
#: the full-depth run: B x S tokens a step, steps from pipeline_for(seed=0);
#: a checkpoint at RESUME_AT, restored and run again to RESUME_TO
TRAIN_B, TRAIN_S, TRAIN_STEPS, RESUME_AT, RESUME_TO = 4, 2048, 12, 5, 10
#: card against CPU: full width cut to 2 layers, fp32, B=2 S=256; loss and
#: grad_norm within 1e-4 relative; resumed and virtualized losses within
#: 1e-5 relative of the uninterrupted native run
TRAIN_REF_DEPTH, TRAIN_REF_B, TRAIN_REF_S, TRAIN_REF_RTOL = 2, 2, 256, 1e-4
RESUME_RTOL = 1e-5


def check_flash_grad(device, shapes=FLASH_GRAD_SHAPES):
    """The flash ``autograd.Function`` (kernel forward, recomputed plain
    backward) against autograd through the plain version, on the same
    inputs and upstream gradient: the forward (bf16 within two ulps, fp32
    at 2e-5) is a check of the kernel; dq, dk, dv (3e-2 bf16, 2e-5 fp32,
    each present and finite) are a check of the ``Function``'s wiring
    only — the saved q, k, v, the causal flag and window reaching the
    recompute, one launch a forward — since the backward is autograd of
    the same plain formula on the same inputs."""
    import torch
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    for (B, S, Hq, Hkv, hd, window), dt in itertools.product(
            shapes, (torch.bfloat16, torch.float32)):
        dn = str(dt).replace("torch.", "")
        q, k, v = flash_inputs(S, Hq, Hkv, dt, device, seed=S + hd, hd=hd,
                               B=B)
        g = torch.Generator(device=device).manual_seed(S + 1)
        up = torch.randn(q.shape, generator=g, device=device).to(dt)
        what = f"B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd} window={window} {dn}"
        res = {}
        for name, fn in (("op", flash_attention_op),
                         ("plain", flash_attention_ref)):
            qkv = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            before = common.LAUNCHES["flash_attention"]
            out = fn(*qkv, causal=True, window=window)
            out.backward(up)
            res[name] = (out.detach(), [t.grad for t in qkv],
                         common.LAUNCHES["flash_attention"] - before)
        (out, grads, n), (want, wgrads, _) = res["op"], res["plain"]
        if device.type == "cuda" and n != 1:
            raise AssertionError(f"flash grad {what}: {n} kernel launches "
                                 "in the forward, expected 1")
        if dt == torch.float32:
            _expect("flash_attention", f"forward under grad {what}",
                    _max_err(out, want), TOL[dn])
        else:
            _expect_close("flash_attention", f"forward under grad {what}",
                          out, want, BF16_ULP_ATOL, BF16_ULP_RTOL)
        for gname, got, ref in zip(("dq", "dk", "dv"), grads, wgrads):
            if got is None or not bool(torch.isfinite(got.float()).all()):
                raise AssertionError(f"flash grad {what}: {gname} missing "
                                     "or not finite")
            _expect("flash_attention", f"{gname} {what}",
                    _max_err(got, ref), GRAD_TOL[dn])
        del q, k, v, up, res, out, grads, want, wgrads


#: the recurrences' gradient on the card, at the served shapes already
#: timed: the scan (B, S, D), the WKV (B, H, S, K)
SCAN_GRAD_SHAPES = ((1, 130, 2560), (4, 2048, 2560))
WKV_GRAD_SHAPES = ((1, 64, 130, 64), (4, 64, 2048, 64))
#: each input gradient against autograd through the plain version, by
#: relative norm ||g - w|| <= tol ||w||: the scan's backward is the same
#: serial recurrence (the reversed scan); the WKV's differentiates the
#: chunked form where the plain version is the serial token loop
SCAN_GRAD_RTOL, WKV_GRAD_RTOL = 1e-5, 1e-4


def _grad_agree(name, what, got, want, rtol):
    """Each of ``got`` (the Function's input gradients) against ``want``
    (autograd through the plain version) by relative norm."""
    import torch
    for gname, g, w in zip(got[0], got[1], want):
        if g is None or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name} grad {what}: {gname} missing or "
                                 "not finite")
        rel = float((g.double() - w.double()).norm()
                    / w.double().norm().clamp_min(1e-30))
        ok = rel <= rtol
        log(f"[kernel] {name} {gname} {what}: rel_err={rel:.3g} "
            f"max_abs_err={_max_err(g, w):.3g} (max |want| "
            f"{float(w.abs().max()):.3g}) tol {rtol:g} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {gname} {what}: rel error {rel}")


def check_recurrent_grad(device):
    """The RG-LRU scan's and the RWKV-6 WKV's ``autograd.Function`` on the
    card against autograd through their plain versions, on the same
    inputs (h0, s0 and u nonzero) and random upstream gradients on every
    output: the scan's forward bit-equal, the WKV's within 2e-3 as in
    phase 2; every input gradient (dh0, du and ds0 included) within
    ``*_GRAD_RTOL``; the scan launches its kernel once in the forward and
    once in the backward (the reversed scan), the WKV once (its backward
    is torch ops)."""
    import torch
    from repro_torch.kernels import common
    from repro_torch.kernels.rglru_scan.ops import rglru_scan_op
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv_op
    from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref
    cases = [("rglru_scan", ("da", "db", "dh0"), rglru_scan_op,
              rglru_scan_ref, rglru_inputs(*shape, device, seed=7),
              f"B={shape[0]} S={shape[1]} D={shape[2]}", 2, SCAN_GRAD_RTOL)
             for shape in SCAN_GRAD_SHAPES]
    cases += [("rwkv6_wkv", ("dr", "dk", "dv", "dlogw", "du", "ds0"),
               rwkv6_wkv_op, rwkv6_wkv_ref,
               wkv_inputs(*shape, device, seed=8),
               f"B={shape[0]} H={shape[1]} S={shape[2]} K={shape[3]}", 1,
               WKV_GRAD_RTOL) for shape in WKV_GRAD_SHAPES]
    for name, gnames, op, ref, ins, what, n_launch, rtol in cases:
        g = torch.Generator(device=device).manual_seed(9)
        res = {}
        for side, fn in (("op", op), ("plain", ref)):
            leaves = [t.detach().clone().requires_grad_() for t in ins]
            before = common.LAUNCHES[name]
            out = fn(*leaves)
            outs = out if isinstance(out, tuple) else (out,)
            if side == "op":
                ups = [torch.randn(o.shape, generator=g, device=device)
                       for o in outs]
            torch.autograd.backward(outs, ups)
            res[side] = ([o.detach() for o in outs], [t.grad for t in leaves],
                         common.LAUNCHES[name] - before)
            del out, outs, leaves
        (outs, grads, n), (want, wgrads, _) = res["op"], res["plain"]
        if n != n_launch:
            raise AssertionError(f"{name} grad {what}: {n} kernel launches "
                                 f"a forward and backward, expected "
                                 f"{n_launch}")
        if name == "rglru_scan":
            if not torch.equal(outs[0], want[0]):
                raise AssertionError(f"{name} forward under grad {what}: "
                                     "not bit-equal")
            log(f"[kernel] {name} forward under grad {what}: bit-equal to "
                f"the plain version; {n} launches (forward and the "
                "reversed scan)")
        else:
            for o, w, part in zip(outs, want, ("o", "s_final")):
                _expect_close(name, f"forward under grad {what} {part}", o,
                              w, 2e-3, 2e-3)
        _grad_agree(name, what, (gnames, grads), wgrads, rtol)
        del res, outs, grads, want, wgrads, ins
        torch.cuda.empty_cache()
    profile_wkv_backward(device)


def profile_wkv_backward(device, shape=(1, 64, 2048, 64)):
    """One WKV backward at rwkv6's train shape (a layer of
    ``TRAIN_FAMILIES``' rwkv6 cell) under torch.profiler: its device
    kernels (the chunked form recomputed and differentiated in torch ops,
    a loop over the chunks for the carried state) and their device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv_op
    ins = [t.requires_grad_() for t in wkv_inputs(*shape, device, seed=8)]
    for _ in range(2):                       # the first one warms up
        outs = rwkv6_wkv_op(*ins)
        ups = [torch.ones_like(o) for o in outs]
        sync(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            torch.autograd.backward(outs, ups)
            sync(device)
            wall = 1e3 * (time.perf_counter() - t)
    rows = device_rows(prof)
    log(f"[kernel] rwkv6_wkv backward at B={shape[0]} H={shape[1]} "
        f"S={shape[2]} K={shape[3]} (one layer of the rwkv6 train cell): "
        f"{sum(r[1] for r in rows)} device kernels, "
        f"{sum(r[0] for r in rows) / 1e3:.2f} ms of device time, "
        f"{wall:.1f} ms on the host clock")
    del ins, outs, ups


#: the step variants held card against CPU: (micro_steps, grad_compress)
TRAIN_REF_VARIANTS = ((1, False), (2, False), (2, True))


def train_reference_phase(device, cfg=None, B=TRAIN_REF_B, S=TRAIN_REF_S,
                          variants=TRAIN_REF_VARIANTS):
    """``cfg`` (default: qwen at full width cut to 2 layers, fp32
    compute): one train step on the card and the same on the CPU from
    the same params, optimizer state and batch, for each of ``variants``
    (plain, with ``micro_steps=2`` and with ``micro_steps=2,
    grad_compress=True``): loss and grad_norm within 1e-4 relative; every
    parameter leaf gets a finite, nonzero gradient on the card."""
    import torch
    from repro_torch import optim
    from repro_torch.bridge import batch_from_numpy
    from repro_torch.checkpointing.checkpoint import (flatten_with_path,
                                                      tree_map)
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import pipeline_for
    from repro_torch.launch.train import opt_config
    from repro_torch.models import Model
    cpu = torch.device("cpu")
    cfg = cfg or family_cfg(TRAIN_ARCH, TRAIN_REF_DEPTH,
                            compute_dtype="float32")
    # made on the card (a CPU generator takes seconds a billion draws)
    params = {device: Model(cfg, device).init(
        torch.Generator(device=device).manual_seed(0))}
    params[cpu] = tree_map(lambda t: t.to(cpu), params[device])
    batch = pipeline_for(cfg, ShapeCell("train-ref", S, B, "train"),
                         seed=0).batch(0)
    t0 = time.perf_counter()
    _, _, grads = optim.loss_and_grads(Model(cfg, device), params[device],
                                       batch_from_numpy(batch, device))
    flat = flatten_with_path(grads)
    bad = [p for p, g in flat if g is None
           or not bool(torch.isfinite(g).all()) or not bool((g != 0).any())]
    log(f"[train-ref] {cfg.name} at d_model {cfg.d_model}, {cfg.n_layers} "
        f"layers {cfg.block_pattern}, {cfg.compute_dtype}, B={B} S={S}: "
        f"{len(flat)} parameter leaves, {len(flat) - len(bad)} with a "
        f"finite nonzero gradient on {device.type}")
    if bad:
        raise AssertionError(f"train-ref: leaves without a finite nonzero "
                             f"gradient: {bad}")
    del grads, flat
    for ms, gc in variants:
        opt = opt_config(cfg, TRAIN_STEPS, ms, gc)
        res = {}
        for dev in (device, cpu):
            step = optim.make_train_step(Model(cfg, dev), opt)
            _, _, m = step(params[dev], optim.init(opt, params[dev]),
                           batch_from_numpy(batch, dev))
            res[dev.type] = (float(m["loss"]), float(m["grad_norm"]))
        (l_dev, n_dev), (l_cpu, n_cpu) = res[device.type], res["cpu"]
        rel = max(abs(l_dev - l_cpu) / abs(l_cpu),
                  abs(n_dev - n_cpu) / abs(n_cpu))
        ok = rel <= TRAIN_REF_RTOL
        log(f"[train-ref] {cfg.name} micro_steps={ms} grad_compress={gc}: "
            f"loss "
            f"{l_dev!r} ({device.type}) vs {l_cpu!r} (cpu), grad_norm "
            f"{n_dev!r} vs {n_cpu!r}: rel {rel:.3g} tol {TRAIN_REF_RTOL:g} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("train-ref: card and CPU disagree")
    log(f"[train-ref] took {time.perf_counter() - t0:.1f}s")


def run_steps(run, trees, batches, first, device, mgr=None):
    """Train steps ``first..`` over ``batches`` (numpy) from ``trees``
    ([params, opt_state], emptied here: a step consumes its inputs, and
    a functional step's old trees would stay alive through the caller's
    references) → (params, state, losses, host ms a step, each
    step's kernel launches, grad norms); ``mgr`` saves after step
    RESUME_AT (its host copy is not in the step's time)."""
    from repro_torch.bridge import batch_from_numpy
    from repro_torch.kernels import common
    params, state = trees
    trees.clear()
    losses, ms, counts, norms = [], [], [], []
    for step in range(first, len(batches)):
        batch = batch_from_numpy(batches[step], device)
        sync(device)
        before = dict(common.LAUNCHES)
        t = time.perf_counter()
        params, state, m = run(params, state, batch)
        losses.append(float(m["loss"]))             # waits for the step
        ms.append(1e3 * (time.perf_counter() - t))
        norms.append(float(m["grad_norm"]))
        counts.append({k: n - before.get(k, 0)
                       for k, n in common.LAUNCHES.items()
                       if n - before.get(k, 0)})
        if mgr is not None and step == RESUME_AT:
            mgr.save(step, {"params": params, "opt": state})
    return params, state, losses, ms, counts, norms


def profile_train_step(run, params, state, batch, smi, node="_Flash",
                       what="flash", label="train-profile"):
    """One train step under torch.profiler: the device's busy share of
    the step, and the shares of its device time in the backward of the
    autograd node ``node`` (flash: the plain attention recomputed and
    differentiated; the WKV: its chunked form recomputed and
    differentiated) and in the ``what`` kernel. → the node's share of the
    device time and the kernel launches (device events) of the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync(batch["tokens"].device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = run(params, state, batch)
        float(out[2]["loss"])
        wall = 1e3 * (time.perf_counter() - t)
    averages = prof.key_averages()
    rows = device_rows(prof, averages)
    busy = sum(r[0] for r in rows) / 1e3
    bwd = 0.0
    for e in averages:
        if f"{node}Backward" in e.key:
            dev = getattr(e, "device_time_total", None)
            bwd = max(bwd, (e.cuda_time_total if dev is None else dev) / 1e3)
    fwd = sum(r[0] for r in rows if what in r[2].lower()) / 1e3
    events = sum(r[1] for r in rows)
    log(f"[{label}] {smi}: one step {wall:.1f} ms on the host clock, "
        f"{busy:.1f} ms of device time (busy {100 * busy / wall:.1f}%, "
        f"idle {100 * (1 - busy / wall):.1f}%), {events} device events; "
        f"{node}'s backward (recomputed and differentiated) {bwd:.1f} ms = "
        f"{100 * bwd / max(busy, 1e-9):.1f}% of the device time; the "
        f"{what} kernel (forward and remat recompute) {fwd:.1f} ms = "
        f"{100 * fwd / max(busy, 1e-9):.1f}%")
    for t_us, n, name in rows[:8]:
        log(f"[{label}]   {t_us / 1e3:9.2f} ms {n:5d}x {name[:90]}")
    del out
    return bwd / max(busy, 1e-9), events


def _agree(name, what, got, want):
    """Losses ``got`` against the native run's ``want``: within
    RESUME_RTOL relative each (the CUDA backward's sums may be reordered
    between runs), and reported as bitwise equal or not."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    same = list(got) == list(want)
    ok = len(got) == len(want) and rel <= RESUME_RTOL
    log(f"[{name}] {what}: {len(got)} losses, max rel diff {rel:.3g} (tol "
        f"{RESUME_RTOL:g}), bitwise equal: {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: losses disagree with the native run")


#: the families trained on the card: (arch, path name, layers kept (None:
#: all), experts kept (None: all), B, S, steps). Full width; depth and
#: experts cut only as far as one card's 80 GB forces. The cuts were made
#: for a step that returned new trees while its caller held the old
#: ones: 3p + 4s bytes a parameter at the update (p, s: the bytes of the
#: parameter and the state dtype; 28 in fp32, 14 for kimi's bf16), kept
#: at or below ~65 GB (mixtral: 2 layers would have been 88). The step
#: ``build_train`` makes now consumes its inputs (the update in place, as
#: the reference donates them): 2p + 2s (parameters, their gradients, m
#: and v; 16 in fp32), the update's fp32 temporaries kept to a block of
#: rows (``optim.adamw.UPDATE_BLOCK``); ``train_bytes`` prints both
#: reckonings beside the measured peak. B·S = 2048 tokens (whisper: 4 ×
#: 512 over 4 × 1500 frames) keeps the logits' share (V up to 256000) to
#: a few GB. qwen keeps its full depth and 12 steps of B=4.
TRAIN_FAMILIES = (
    (TRAIN_ARCH, "train", None, None, TRAIN_B, TRAIN_S, TRAIN_STEPS),
    ("recurrentgemma-2b", "train-recurrentgemma", 12, None, 1, 2048, 4),
    ("rwkv6-7b", "train-rwkv6", 8, None, 1, 2048, 4),
    ("internlm2-1.8b", "train-internlm2", None, None, 1, 2048, 4),
    ("phi3-mini-3.8b", "train-phi3", 18, None, 1, 2048, 4),
    ("starcoder2-15b", "train-starcoder2", 4, None, 1, 2048, 4),
    ("mixtral-8x7b", "train-mixtral", 1, None, 1, 2048, 4),
    ("kimi-k2-1t-a32b", "train-kimi", 2, 16, 1, 2048, 4),
    ("internvl2-2b", "train-internvl2", None, None, 1, 2048, 4),
    ("whisper-medium", "train-whisper", None, None, 4, 512, 4))
#: what a family's run adds to the gates every family passes: the same
#: steps through a VMM tenant's train program (hybrid); one profiled step
#: (the autograd node whose backward, and the kernel whose forward, it
#: reports); the step-5 checkpoint restored and run to step 10; the last
#: step's loss below the first (qwen's 12 steps of 8192 tokens only: a
#: new batch's loss moves by more than 4 steps of 2048 tokens move it,
#: ``tools/train_probe.py``)
TRAIN_EXTRAS = {
    "train": {"virtualized": True, "profile": ("_Flash", "flash"),
              "resume": True, "falls": True},
    "train-recurrentgemma": {"virtualized": True},
    "train-rwkv6": {"virtualized": True, "profile": ("_Wkv", "wkv_chunk")}}
#: the card-vs-CPU train step of the recurrent families: full width, 2
#: layers, fp32, B=2 S=256, the plain step
RECURRENT_TRAIN_REF_DEPTH = 2
for _arch, _path, *_ in TRAIN_FAMILIES:
    _kernels = {"recurrentgemma-2b": ("flash_attention", "rglru_scan"),
                "rwkv6-7b": ("rwkv6_wkv",)}.get(_arch, ("flash_attention",))
    PATH_KERNELS[_path] = PATH_KERNELS[f"virtualized-{_path}"] = _kernels


def train_bytes(cfg):
    """(parameters, the bytes a train step holds at the update without
    activations in the donated form — 2p + 2s a parameter: parameters,
    gradients, m and v, updated in place — and in the functional form,
    3p + 4s: new parameters, m and v beside the old; see
    ``TRAIN_FAMILIES``)."""
    import torch
    n = cfg.param_counts()["total"]
    p = torch.finfo(getattr(torch, cfg.param_dtype)).bits // 8
    s = torch.finfo(getattr(torch, cfg.opt_dtype)).bits // 8
    return n, n * (2 * p + 2 * s), n * (3 * p + 4 * s)


def train_launches(cfg):
    """Kernel launches a train step makes, from the block pattern: each
    layer's kernel in the forward and again in its remat recompute, and
    the RG-LRU scan once more in its backward (the reversed scan)."""
    from repro_torch.parallel.steps import STEP_KERNELS
    passes = 1 if cfg.sharding.remat == "none" else 2
    out = {}
    for i in range(cfg.n_layers):
        name = STEP_KERNELS["train"][cfg.layer_mixer(i)]
        out[name] = out.get(name, 0) + passes + (name == "rglru_scan")
    return out


def family_train(device, launches, smi, arch, path, depth, n_experts, B, S,
                 steps):
    """``arch`` at full width (``depth`` layers, ``n_experts`` experts
    when given), its own remat and dtypes, trains ``steps`` steps of
    B x S tokens from ``pipeline_for(cfg, cell, seed=0)`` with the train
    driver's AdamW (warmup 5, cosine). Every family's gates: every
    parameter leaf a finite nonzero gradient on the first batch; the
    losses finite; step 0's batch, evaluated again right after step 0
    (the gradient descends) and after the last step (the run keeps what
    it learned), below its loss at step 0; each step launches
    ``train_launches(cfg)``. Step p50, tokens/s and peak memory print
    beside the reckoning. ``TRAIN_EXTRAS[path]`` adds the rest: a VMM
    tenant's ``train`` program (``hybrid``; the compile service builds
    the cut config) with losses within 1e-5 relative of the native ones,
    a profiled step, the checkpoint resume, the falling step losses."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch import optim
    from repro_torch.bridge import batch_from_numpy
    from repro_torch.checkpointing import CheckpointManager
    from repro_torch.checkpointing.checkpoint import flatten_with_path
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core import ProgramRequest
    from repro_torch.core.reconfig import CompileService
    from repro_torch.data import pipeline_for
    from repro_torch.launch.serve import virtual_server
    from repro_torch.launch.train import opt_config
    from repro_torch.models import Model
    from repro_torch.parallel import (abstract_params, build_step_for_cell,
                                      build_train)
    t0 = time.perf_counter()
    extras = TRAIN_EXTRAS.get(path, {})
    cfg = family_cfg(arch, depth, n_experts=n_experts)
    full = get_config(arch)
    model = Model(cfg, device)
    opt = opt_config(cfg, steps)
    cell = ShapeCell("train", S, B, "train")
    pipe = pipeline_for(cfg, cell, seed=0)
    batches = [pipe.batch(i) for i in range(steps)]
    n_params, held, functional = train_bytes(cfg)
    cut = (f"{cfg.n_layers} of {full.n_layers} layers"
           + (f", {cfg.moe.n_experts} of {full.moe.n_experts} experts "
              f"top-{cfg.moe.top_k}" if n_experts else ""))

    def fresh():
        params = model.init(torch.Generator(device=device).manual_seed(0))
        return params, optim.init(opt, params)

    def first_batch_loss(params):
        with torch.no_grad():
            return float(model.loss(params, batch_from_numpy(batches[0],
                                                             device))[0])

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    trees = list(fresh())
    _, _, grads = optim.loss_and_grads(model, trees[0],
                                       batch_from_numpy(batches[0], device))
    flat = flatten_with_path(grads)
    bad = [p for p, g in flat if not bool(torch.isfinite(g).all())
           or not bool((g != 0).any())]
    del grads, flat
    if bad:
        raise AssertionError(f"{path} {arch}: leaves without a finite "
                             f"nonzero gradient: {bad}")
    run, _ = build_train(cfg, device, cell, opt)
    ckpt = mgr = None
    if extras.get("resume"):
        ckpt = tempfile.mkdtemp(prefix="train_ckpt_")
        mgr = CheckpointManager(ckpt, keep_n=1)
    # step 0 alone, then its batch again, then the other steps
    params, state, losses, ms, per_step, norms = run_steps(
        run, trees, batches[:1], 0, device, mgr)
    after0 = first_batch_loss(params)
    trees = [params, state]
    del params, state
    params, state, *more = run_steps(run, trees, batches, 1, device, mgr)
    for acc, new in zip((losses, ms, per_step, norms), more):
        acc.extend(new)
    after = first_batch_loss(params)
    counts = {}
    for c in per_step:
        for k, n in c.items():
            counts[k] = counts.get(k, 0) + n
    peak = torch.cuda.max_memory_allocated(device) / 1e9 if on_card \
        else float("nan")
    p50 = statistics.median(ms)
    want = train_launches(cfg)
    got = [{k: c.get(k, 0) for k in want} for c in per_step]
    log(f"[{path}] {arch} at full width (d_model {cfg.d_model}), {cut}, "
        f"remat {cfg.sharding.remat!r}, params {cfg.param_dtype}, compute "
        f"{cfg.compute_dtype}; B={B} S={S}, {steps} steps: "
        f"{n_params / 1e9:.3f} B parameters, reckoned {held / 1e9:.1f} GB "
        f"held at the update without activations, donated (the "
        f"functional form's 3p + 4s: {functional / 1e9:.1f} GB); every "
        f"leaf a finite "
        f"nonzero gradient; losses {[round(x, 4) for x in losses]}, grad "
        f"norms {[round(x, 3) for x in norms]}; launches a step {got[0]} "
        f"(expected {want}); launches over the steps {counts}")
    log(f"[time:{path}] {smi}: step p50 {p50:.1f} ms, "
        f"{B * S / p50 * 1e3:.0f} tokens/s, peak memory {peak:.2f} GB "
        f"beside the donated form's {held / 1e9:.2f} GB without "
        f"activations (functional {functional / 1e9:.2f} GB); each "
        f"step's ms {[round(t, 1) for t in ms]}"
        + (f" (the async save after step {RESUME_AT} writes on a host "
           "thread meanwhile)" if mgr else ""))
    log(f"[{path}] step 0's batch: loss {losses[0]:.4f} at step 0, "
        f"{after0:.4f} right after it, {after:.4f} after step {steps - 1}; "
        f"the last step's loss {losses[-1]:.4f}")
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise AssertionError(f"{path} {arch}: a loss is not finite")
    if not after0 < losses[0]:
        raise AssertionError(f"{path} {arch}: step 0 did not lower its "
                             f"batch's loss ({losses[0]} -> {after0})")
    if not after < losses[0]:
        raise AssertionError(f"{path} {arch}: step 0's batch was not easier "
                             f"after the run ({losses[0]} -> {after})")
    if extras.get("falls") and not losses[-1] < losses[0]:
        raise AssertionError(f"{path} {arch}: loss did not fall "
                             f"({losses[0]} -> {losses[-1]})")
    if on_card and any(g != want for g in got):
        raise AssertionError(f"{path} {arch}: launches a step {got}, "
                             f"expected {want}")
    count_path(path, counts, launches)
    out = {"arch": arch, "cut": cut, "B": B, "S": S, "step_p50_ms": p50,
           "tokens_s": B * S / p50 * 1e3, "peak_gb": peak,
           "reckoned_gb": held / 1e9, "functional_gb": functional / 1e9}
    if "profile" in extras:
        node, what = extras["profile"]
        out["bwd_share"], out["events"] = profile_train_step(
            run, params, state, batch_from_numpy(pipe.batch(steps), device),
            smi, node=node, what=what, label=f"{path}-profile")
    del params, state
    if on_card:
        torch.cuda.empty_cache()
    if mgr is not None:
        # the step-5 checkpoint into fresh trees, steps 6..10 again
        t = time.perf_counter()
        template = {"params": abstract_params(model)}
        template["opt"] = optim.init(opt, template["params"])
        mgr.wait()
        saved, tree, _ = mgr.restore_latest(template, device=device)
        mgr.close()
        shutil.rmtree(ckpt, ignore_errors=True)
        load_s = time.perf_counter() - t
        _, _, resumed, *_ = run_steps(run, [tree.pop("params"),
                                            tree.pop("opt")],
                                      batches[:RESUME_TO + 1], saved + 1,
                                      device)
        _agree(f"{path}-resume", f"steps {saved + 1}..{RESUME_TO} after "
               f"restoring the step-{saved} checkpoint ({load_s:.1f}s to "
               "restore)", resumed, losses[saved + 1:RESUME_TO + 1])
    if extras.get("virtualized"):
        vmm, tenant = virtual_server(device, "hybrid")
        try:
            if (depth, n_experts) != (None, None):
                vmm.compiler = CompileService(
                    lambda _cfg, dev, c, **kw: build_step_for_cell(
                        cfg, dev, c, **kw))
            tenant.device.reprogram(ProgramRequest(
                arch=arch, kind="train", seq_len=S, global_batch=B,
                reduced=False,
                opt_flags=tuple(dataclasses.asdict(opt).items())))
            _, _, vlosses, vms, vper, _ = run_steps(
                tenant.device.run, list(fresh()), batches, 0, device)
            st = vmm.stats()
        finally:
            vmm.shutdown()
        if st["scheduler"]["tenants"]["server"]["failed"]:
            raise AssertionError(f"virtualized-{path} {arch}: a failed run")
        vcounts = {}
        for c in vper:
            for k, n in c.items():
                vcounts[k] = vcounts.get(k, 0) + n
        count_path(f"virtualized-{path}", vcounts, launches)
        _agree(f"virtualized-{path}", "through the tenant's train program "
               "(hybrid)", vlosses, losses)
        out["virt_step_p50_ms"] = statistics.median(vms)
        log(f"[time:virtualized-{path}] {smi}: step p50 "
            f"{out['virt_step_p50_ms']:.1f} ms (native {p50:.1f} ms, ratio "
            f"{out['virt_step_p50_ms'] / p50:.4f}); each step's ms "
            f"{[round(t, 1) for t in vms]}; launches={vcounts}")
        if on_card:
            torch.cuda.empty_cache()
    log(f"[{path}] took {time.perf_counter() - t0:.1f}s")
    return out


def train_phases(device, launches, smi):
    """Phase 12: flash's and the recurrences' gradients, the card against
    the CPU (qwen, and both recurrent families), then every family of
    ``TRAIN_FAMILIES`` (:func:`family_train`)."""
    t0 = time.perf_counter()
    check_flash_grad(device)
    check_recurrent_grad(device)
    train_reference_phase(device)
    for arch, _, _ in RECURRENT_ARCHS:
        train_reference_phase(
            device, family_cfg(arch, RECURRENT_TRAIN_REF_DEPTH,
                               compute_dtype="float32"),
            variants=TRAIN_REF_VARIANTS[:1])
    out = [family_train(device, launches, smi, *row)
           for row in TRAIN_FAMILIES]
    log(f"[train] phase took {time.perf_counter() - t0:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 6: kernel times at the serving path's shapes
# ---------------------------------------------------------------------------

def time_kernels(device):
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
    # the train phase's shape: B=4, S=2048, qwen's 16/16 heads, causal
    B, S = TRAIN_B, TRAIN_S
    q, k, v = flash_inputs(S, H, H, bf16, device, seed=6, B=B)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = S * (S + 1) // 2
    bnd = bound(4 * B * S * H * hd * 2, B * H * pairs * 4 * hd, BF16_FLOPS)
    out["flash_attention@B4S2048"] = {
        "shape": f"B={B} S={S} Hq=Hkv={H} hd={hd} bf16 causal (train)",
        "ms": timed(lambda: flash_attention_op(q, k, v), 20, 2),
        "plain_ms": timed(lambda: flash_attention_ref(q, k, v), 4, 1),
        "library_ms": timed(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 20, 2),
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
    return out


def log_times(out, launches):
    """Print every timed kernel beside its launches on the paths, its
    bound and its share of it; each row keeps its device ms for the
    kernels JSON line."""
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
    rows), at B=4, S=4096 and at the families' train shape, B=1 S=2048
    (printed; their plain versions loop over the tokens, a few device
    kernels a token, so one call is timed at S >= 2048 and five below:
    a trace of more calls holds hundreds of thousands of events and
    takes minutes of host time to read), the no-new-token paged decode
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
                            ("rglru_scan@B4S4096", (4, 4096, 2560)),
                            ("rglru_scan@train", (1, 2048, 2560))):
        a, b, h0 = rglru_inputs(B, S, D, device, seed=1)
        n = B * S * D
        bnd = bound((2 * n + B * D) * 4 + n * 4, 2 * n, FP32_FLOPS)
        big = S > 1000
        out[name] = {
            "shape": f"B={B} S={S} D={D} fp32",
            "ms": timed(lambda: rglru_scan_op(a, b, h0)),
            "plain_ms": timed(lambda: rglru_scan_ref(a, b, h0),
                              *((1, 1) if big else (5, 1))),
            "library_ms": None, **bnd}
    for name, (B, H, S, K) in (("rwkv6_wkv", (1, 64, 130, 64)),
                               ("rwkv6_wkv@S32", (1, 64, 32, 64)),
                               ("rwkv6_wkv@B4S4096", (4, 64, 4096, 64)),
                               ("rwkv6_wkv@train", (1, 64, 2048, 64))):
        ins = wkv_inputs(B, H, S, K, device, seed=2)
        n, st = B * H * S * K, B * H * K * K
        bnd = bound((4 * n + H * K + st) * 4 + (n + st) * 4,
                    4 * B * H * S * K * K, FP32_FLOPS)
        big = S > 1000
        out[name] = {
            "shape": f"B={B} H={H} S={S} K={K} fp32",
            "ms": timed(lambda: rwkv6_wkv_op(*ins)),
            "plain_ms": timed(lambda: rwkv6_wkv_ref(*ins),
                              *((1, 1) if big else (5, 1))),
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

# ---------------------------------------------------------------------------
# [sharded]: the mesh step builders on the card
# ---------------------------------------------------------------------------

#: arch, depth (None: full), the step kinds run through both builders
#: (the frontends' at the depth ``TRAIN_FAMILIES`` cuts them to: full)
SHARDED_ARCHS = (("qwen1.5-0.5b", None, ("prefill", "decode", "train")),
                 ("recurrentgemma-2b", 12, ("prefill", "decode")),
                 ("rwkv6-7b", 8, ("prefill", "decode")),
                 ("internvl2-2b", None, ("prefill", "decode", "train")),
                 ("whisper-medium", None, ("prefill", "decode", "train")))
#: prefill B x S into rings of SHARDED_CAP, then SHARDED_DECODE decode
#: steps; SHARDED_TRAIN train steps of B x S (qwen)
SHARDED_B, SHARDED_S, SHARDED_CAP = 4, 2048, 4096
SHARDED_DECODE, SHARDED_TRAIN = 16, 4
#: the frontends' train steps: (B, S, steps) as ``TRAIN_FAMILIES`` sizes
#: them, 2 steps; then qwen with ``micro_steps=2`` (2 steps of B x S)
SHARDED_FRONTEND_TRAIN = {"internvl2-2b": (1, 2048, 2),
                          "whisper-medium": (4, 512, 2)}
SHARDED_MICRO = 2
PATH_KERNELS["sharded"] = ("flash_attention", "decode_attention",
                           "rglru_scan", "rwkv6_wkv")
#: the multi-card cases (when the machine shows two cards or more):
#: full width, fp32, cut depth; held to the one-card run within 1e-3. A
#: MoE case runs with room for every token at every expert
#: (``capacity_factor = E / top_k``): the token-routing regime sizes
#: capacity over each model rank's slice of the tokens, as the
#: reference's does, and the one-card gather over all of them, so their
#: drops differ by design; without drops both compute the same sums.
#: (``tests/test_torch_moe_ep.py`` holds the drops to the reference's.)
MULTI_CARD = (("recurrentgemma-2b", 3, {}),
              ("recurrentgemma-2b", 3, {"decode_splitk": False}),
              ("mixtral-8x7b", 1, {"moe_impl": "ep"}))
MULTI_B, MULTI_S, MULTI_CAP, MULTI_DECODE, MULTI_TOL = 4, 256, 512, 4, 1e-3


def _local(tree):
    from repro_torch.parallel import partition as part
    return part.to_local(tree)


def _same(name, what, got, want):
    """``got`` and ``want`` (tensors or trees) bit for bit; else name the
    first leaf that differs and hold every leaf to the bf16 tolerance."""
    import torch
    from repro_torch.checkpointing.checkpoint import flatten_with_path
    pairs = list(zip(flatten_with_path(got), flatten_with_path(want))) \
        if not isinstance(got, torch.Tensor) else [(((), got), ((), want))]
    diff = [(p, float((g.float() - w.float()).abs().max()))
            for (p, g), (_, w) in pairs if not torch.equal(g, w)]
    if not diff:
        log(f"[sharded] {name} {what}: equal bit for bit "
            f"({len(pairs)} leaves)")
        return
    worst = max(e for _, e in diff)
    log(f"[sharded] {name} {what}: {len(diff)} of {len(pairs)} leaves not "
        f"bit-equal, first at {diff[0][0]} (max |d| {worst:.3g}, bf16 "
        f"tolerance {TOL['bfloat16']})")
    if not worst <= TOL["bfloat16"]:
        raise AssertionError(f"sharded {name} {what}: max |d| {worst}")


def _timed_call(device, fn, *args):
    sync(device)
    t = time.perf_counter()
    out = fn(*args)
    sync(device)
    return out, 1e3 * (time.perf_counter() - t)


def frontend_inputs(cfg, B, device, gen):
    """The stub frontend's inputs of a batch of ``B`` (the VLM's patches,
    whisper's frames; none for the other families)."""
    import torch
    fe = cfg.frontend
    if fe is None:
        return {}
    key = "patches" if cfg.family == "vlm" else "frames"
    return {key: torch.randn((B, fe.n_tokens, fe.d_in), generator=gen,
                             device=device)}


def _serve_steps(cfg, target, device, params, toks, dec_toks,
                 cap=SHARDED_CAP, extra=None):
    """Prefill into rings of ``cap`` slots, then decode, through the
    builders for ``target`` (a device or a mesh) → (logits, caches,
    decode logits, prefill ms, decode ms a step); the prefill runs twice
    and the second is timed. ``extra``: the frontend's inputs."""
    import torch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.models import Model
    from repro_torch.parallel import partition as part
    from repro_torch.parallel import steps
    B = toks.shape[0]
    pf, _ = steps.build_prefill(cfg, target, ShapeCell("p", cap, B,
                                                         "prefill"))
    dec, _ = steps.build_decode(cfg, target, ShapeCell("d", cap, B,
                                                       "decode"))
    mesh = target if hasattr(target, "mesh_dim_names") else None
    batch = {"tokens": toks, **(extra or {})}
    if mesh is not None:
        params = part.distribute(params, pf.specs[0], mesh)
        batch = part.distribute(batch, pf.specs[1], mesh)
    pf(params, batch)
    (logits, caches), pf_ms = _timed_call(device, pf, params, batch)
    out, ms = [], []
    start = toks.shape[1] + Model(cfg, device="meta").n_prefix
    for i, tok in enumerate(dec_toks):
        if mesh is not None:
            tok = part.distribute({"t": tok}, {"t": dec.specs[2]}, mesh)["t"]
        pos = torch.tensor(start + i, dtype=torch.int32, device=device)
        (lg, caches), t = _timed_call(device, dec, params, caches, tok, pos)
        out.append(lg)
        ms.append(t)
    return logits, caches, out, pf_ms, statistics.median(ms[1:])


def _train_steps(cfg, target, device, batches, micro_steps=1):
    """A step a batch from ``init``'s parameters (seed 0) → (params,
    losses, grad norms, step p50 ms)."""
    import torch
    from repro_torch import optim
    from repro_torch.configs.base import ShapeCell
    from repro_torch.models import Model
    from repro_torch.parallel import partition as part
    from repro_torch.parallel import steps
    B, S = batches[0]["tokens"].shape
    opt = optim.OptConfig(state_dtype=cfg.opt_dtype, micro_steps=micro_steps)
    run, _ = steps.build_train(cfg, target, ShapeCell("t", S, B, "train"),
                               opt)
    params = Model(cfg, device).init(
        torch.Generator(device=device).manual_seed(0))
    state = optim.init(opt, params)
    mesh = target if hasattr(target, "mesh_dim_names") else None
    if mesh is not None:
        params = part.distribute(params, run.specs[0], mesh)
        state = part.distribute(state, run.specs[1], mesh)
    losses, norms, ms = [], [], []
    for b in batches:
        if mesh is not None:
            b = part.distribute(b, run.specs[2], mesh)
        (params, state, m), t = _timed_call(device, run, params, state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        ms.append(t)
    del state
    return params, losses, norms, statistics.median(ms[1:])


def sharded_arch(device, mesh, smi, arch, depth, kinds, counts):
    """``arch`` at full width (``depth`` layers) through the device
    builders, then through the mesh builders on ``mesh``; the mesh run's
    launches are added to ``counts``."""
    import torch
    from repro_torch.kernels import common
    from repro_torch.models import Model
    cfg = family_cfg(arch, depth)
    name = f"{arch} ({cfg.n_layers} layers)"
    gen = torch.Generator(device=device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (SHARDED_B, SHARDED_S),
                         generator=gen, device=device, dtype=torch.int32)
    dec_toks = [torch.randint(0, cfg.vocab, (SHARDED_B, 1), generator=gen,
                              device=device, dtype=torch.int32)
                for _ in range(SHARDED_DECODE)]
    extra = frontend_inputs(cfg, SHARDED_B, device, gen)
    params = Model(cfg, device).init_compute_params(
        torch.Generator(device=device).manual_seed(0))
    one = _serve_steps(cfg, device, device, params, toks, dec_toks,
                       extra=extra)
    common.reset_launches()
    got = _serve_steps(cfg, mesh, device, params, toks, dec_toks,
                       extra=extra)
    for k, n in common.LAUNCHES.items():
        counts[k] = counts.get(k, 0) + n
    del params
    _same(name, "prefill logits", _local(got[0]), one[0])
    _same(name, "ring caches after the decode steps", _local(got[1]), one[1])
    _same(name, f"{SHARDED_DECODE} decode steps' logits",
          [_local(x) for x in got[2]], one[2])
    log(f"[sharded] {smi}: {name} B={SHARDED_B} S={SHARDED_S} into rings "
        f"of {SHARDED_CAP}: prefill {got[3]:.2f} ms on the (1, 1) mesh vs "
        f"{one[3]:.2f} ms through the device builder; decode step p50 "
        f"{got[4]:.3f} ms vs {one[4]:.3f} ms")
    del one, got
    torch.cuda.empty_cache()
    if "train" not in kinds:
        return
    B, S, n_steps = SHARDED_FRONTEND_TRAIN.get(
        arch, (SHARDED_B, SHARDED_S, SHARDED_TRAIN))
    L = S + Model(cfg, device="meta").n_prefix

    def ints(*shape):
        return torch.randint(0, cfg.vocab, shape, generator=gen,
                             device=device, dtype=torch.int32)
    batches = [{"tokens": ints(B, S), "labels": ints(B, L),
                "mask": torch.ones((B, L), device=device),
                **frontend_inputs(cfg, B, device, gen)}
               for _ in range(n_steps)]
    runs = [(f"train B={B} S={S}", batches, 1)]
    if arch == TRAIN_ARCH:
        runs.append((f"train B={B} S={S} micro_steps={SHARDED_MICRO}",
                     batches[:2], SHARDED_MICRO))
    for what, bts, micro in runs:
        one = _train_steps(cfg, device, device, bts, micro)
        common.reset_launches()
        got = _train_steps(cfg, mesh, device, bts, micro)
        for k, n in common.LAUNCHES.items():
            counts[k] = counts.get(k, 0) + n
        _same(name, f"{what} losses", torch.tensor(got[1]),
              torch.tensor(one[1]))
        _same(name, f"{what} grad norms", torch.tensor(got[2]),
              torch.tensor(one[2]))
        _same(name, f"{what}: parameters after {len(bts)} steps",
              _local(got[0]), one[0])
        log(f"[sharded] {smi}: {name} {what}: step p50 {got[3]:.1f} ms on "
            f"the (1, 1) mesh vs {one[3]:.1f} ms through the device "
            f"builder; losses {[round(x, 4) for x in got[1]]}")
        del one, got
        torch.cuda.empty_cache()


def multi_card_rank(rank, world, store, out):
    """One rank of the multi-card cases on a (1, world) mesh: each case's
    prefill and decode steps through the mesh builders; rank 0 runs the
    one-card builders beside them. Then, on an even world, the
    multi-card VSlices (:func:`multi_card_vslices`). Rank 0 writes the
    comparisons to ``out`` (JSON)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import Model
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method="file://" + store,
                            rank=rank, world_size=world)
    try:
        mesh = make_local_mesh((1, world), device_type="cuda")
        device = torch.device("cuda", rank)
        res = []
        for arch, depth, sharding in MULTI_CARD:
            cfg = family_cfg(arch, depth, compute_dtype="float32")
            if sharding:
                cfg = dataclasses.replace(cfg, sharding=dataclasses.replace(
                    cfg.sharding, **sharding))
            if cfg.moe is not None:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe,
                    capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
            gen = torch.Generator(device=device).manual_seed(1)
            toks = torch.randint(0, cfg.vocab, (MULTI_B, MULTI_S),
                                 generator=gen, device=device,
                                 dtype=torch.int32)
            dec_toks = [torch.randint(0, cfg.vocab, (MULTI_B, 1),
                                      generator=gen, device=device,
                                      dtype=torch.int32)
                        for _ in range(MULTI_DECODE)]
            params = Model(cfg, device).init(
                torch.Generator(device=device).manual_seed(0))
            got = _serve_steps(cfg, mesh, device, params, toks, dec_toks,
                               MULTI_CAP)
            full = [got[0].full_tensor()] + [x.full_tensor() for x in got[2]]
            if rank == 0:
                one = _serve_steps(cfg, device, device, params, toks,
                                   dec_toks, MULTI_CAP)
                want = [one[0]] + one[2]
                err = max(float((a - b).abs().max())
                          for a, b in zip(full, want))
                res.append({"arch": arch, "layers": cfg.n_layers,
                            "sharding": sharding, "max_abs_err": err,
                            "mesh_ms": [got[3], got[4]],
                            "one_ms": [one[3], one[4]]})
            del params, got, full
        torch.cuda.empty_cache()
        vres = multi_card_vslices(world, device) if world % 2 == 0 else None
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"sharded": res, "vslices": vres}, f)
    finally:
        dist.destroy_process_group()


def sharded_phase(device, launches, smi):
    """The mesh step builders on the card: a one-rank NCCL group (a
    ``file://`` store, no network) and a (1, 1) mesh; qwen1.5-0.5b at
    full width and depth (prefill B=4 S=2048, 16 decode steps, 4 train
    steps) and recurrentgemma-2b and rwkv6-7b at full width cut as
    ``TRAIN_FAMILIES`` cuts them (prefill, decode), each against the
    device builders: equal bit for bit, or the leaf named and held to
    3e-2; internvl2-2b and whisper-medium at full width and depth
    (prefill, decode, 2 train steps at ``SHARDED_FRONTEND_TRAIN``'s
    shapes) and qwen's train with ``micro_steps=2`` the same way; flash,
    decode_attention, rglru_scan and rwkv6_wkv launched on the mesh
    runs. With two cards or more, one NCCL rank a card on a
    (1, n) mesh runs ``MULTI_CARD`` against the one-card builders."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="sharded_")
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        tmp, "store"), rank=0, world_size=1)
    counts = {}
    try:
        mesh = make_local_mesh((1, 1))
        for arch, depth, kinds in SHARDED_ARCHS:
            sharded_arch(device, mesh, smi, arch, depth, kinds, counts)
    finally:
        dist.destroy_process_group()
    log(f"[sharded] launches on the mesh runs: {counts}")
    count_path("sharded", counts, launches)
    n = torch.cuda.device_count()
    if n < 2:
        log(f"[sharded] multi-rank cases (MULTI_CARD and the multi-card "
            f"VSlices) not run: this machine shows {n} card (they need one "
            "rank a card); their collectives are held to the reference on "
            "CPU ranks by tests/test_torch_sharded_steps*.py, "
            "tests/test_torch_moe_ep.py and tests/test_torch_vslice_*.py")
    else:
        import torch.multiprocessing as mp
        out = os.path.join(tmp, "multi.json")
        mp.start_processes(multi_card_rank, nprocs=n, join=True,
                           start_method="spawn",
                           args=(n, os.path.join(tmp, "store_multi"), out))
        with open(out) as f:
            multi = json.load(f)
        for r in multi["vslices"] or []:
            log(f"[vslices] {smi}: (2, {n // 2}) pod of {n} NCCL ranks, "
                f"{r['tenant']} on {r['where']}: {VSLICE_DECODE} decode "
                f"steps within {r['max_abs_err']:.3g} of one card (fp32, "
                f"{VSLICE_DEPTH} layers at full width); compile hits, "
                f"misses {r['hits_misses']}")
            if not r["max_abs_err"] <= MULTI_TOL:
                raise AssertionError(f"vslices multi-card {r['tenant']} "
                                     f"{r['where']}: {r['max_abs_err']}")
        if multi["vslices"] is None:
            log(f"[vslices] multi-card VSlices not run: {n} cards make no "
                "(2, n/2) pod")
        for r in multi["sharded"]:
            log(f"[sharded] {smi}: (1, {n}) mesh, {r['arch']} "
                f"({r['layers']} layers, fp32, {r['sharding'] or 'rules'}"
                f"): prefill and {MULTI_DECODE} decode logits within "
                f"{r['max_abs_err']:.3g} of the one-card run; prefill "
                f"/ decode ms {r['mesh_ms']} vs {r['one_ms']}")
            if not r["max_abs_err"] <= MULTI_TOL:
                raise AssertionError(f"sharded multi-card {r['arch']}: "
                                     f"{r['max_abs_err']}")
    log(f"[sharded] took {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# [dryrun]: the production-mesh dry run, and its counter on the card
# ---------------------------------------------------------------------------

#: the dry run's cells run here (CPU subprocess, both production meshes)
DRYRUN_ARGS = ("--arch", "qwen1.5-0.5b", "--shape", "train_4k,decode_32k",
               "--mesh", "both")
DRYRUN_STEPS = 3


def dryrun_phase(device, smi):
    """``python -m repro_torch.launch.dryrun`` on qwen's train_4k and
    decode_32k cells over both production meshes (fake groups of 256 and
    512 ranks on the CPU, meta tensors): every artifact ``ok``. Then
    qwen1.5-0.5b's train step at full width and depth, at ``[train]``'s
    shape (B=4 S=2048), counted twice by ``launch.op_analysis``: run on
    the card and run on meta tensors; their dot FLOPs and kernel records
    must be equal. The roofline's lower bound of that step (the counts
    over the data-sheet peaks in ``launch.dryrun``) is printed beside
    the step's measured p50 on the card."""
    import tempfile
    import torch
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.op_analysis import count_step
    from repro_torch.models import Model
    from repro_torch.parallel import build_train
    t0 = time.perf_counter()
    total = torch.cuda.get_device_properties(device).total_memory
    log(f"[dryrun] {smi}: total_memory {total} bytes (the dry run's "
        f"HBM_BYTES {dryrun.HBM_BYTES})")
    out = tempfile.mkdtemp(prefix="dryrun_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        *DRYRUN_ARGS, "--out", out], capture_output=True,
                       text=True, env=env, timeout=600)
    for line in p.stdout.splitlines():
        if "terms:" in line or "===" in line:
            log(f"[dryrun] {line.strip()}")
    if p.returncode != 0:
        raise AssertionError(f"dryrun exited {p.returncode}:\n"
                             f"{p.stdout[-2000:]}\n{p.stderr[-2000:]}")
    arts = [n for n in os.listdir(out) if n.endswith(".json")]
    for n in arts:
        with open(os.path.join(out, n)) as f:
            if not json.load(f)["ok"]:
                raise AssertionError(f"dryrun: {n} is not ok")
    log(f"[dryrun] {len(arts)} artifacts ok in "
        f"{time.perf_counter() - t0:.1f}s")
    shutil.rmtree(out, ignore_errors=True)

    cfg = get_config(TRAIN_ARCH)
    cell = ShapeCell("train", TRAIN_S, TRAIN_B, "train")
    step, _ = build_train(cfg, device, cell)
    gen = torch.Generator(device=device).manual_seed(0)
    params = Model(cfg, device).init(gen)
    state = optim.init(optim.OptConfig(state_dtype=cfg.opt_dtype), params)

    def ints():
        return torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_S), generator=gen,
                             device=device, dtype=torch.int32)
    batch = {"tokens": ints(), "labels": ints(),
             "mask": torch.ones((TRAIN_B, TRAIN_S), device=device)}
    ms = []
    for _ in range(DRYRUN_STEPS):
        (params, state, _), t = _timed_call(device, step, params, state,
                                            batch)
        ms.append(t)
    card = count_step(step, (params, state, batch))
    del params, state
    torch.cuda.empty_cache()
    meta_step, meta_args = build_train(cfg, torch.device("meta"), cell)
    meta = count_step(meta_step, meta_args)
    log(f"[dryrun] {TRAIN_ARCH} train B={TRAIN_B} S={TRAIN_S}: dot FLOPs "
        f"{card.dot_flops} on the card, {meta.dot_flops} on meta; kernel "
        f"records {card.kernels} / {meta.kernels}; HBM bytes (unfused) "
        f"{card.mem_bytes} / {meta.mem_bytes}")
    if card.dot_flops != meta.dot_flops or card.kernels != meta.kernels:
        raise AssertionError("dryrun: the card's and meta's counts of the "
                             "train step differ")
    compute_s = card.dot_flops / dryrun.PEAK_FLOPS
    memory_s = card.mem_bytes / dryrun.HBM_BW
    p50 = statistics.median(ms[1:])
    log(f"[dryrun] {smi}: {TRAIN_ARCH} train step B={TRAIN_B} S={TRAIN_S}: "
        f"roofline lower bound {1e3 * max(compute_s, memory_s):.1f} ms "
        f"(compute {1e3 * compute_s:.1f} ms at 989 TFLOP/s, unfused HBM "
        f"bytes {1e3 * memory_s:.1f} ms at 3.35 TB/s; data-sheet peaks) "
        f"beside the measured step p50 {p50:.1f} ms (steps {ms})")
    log(f"[dryrun] took {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# [vslices]: VSlices carved from a pod mesh
# ---------------------------------------------------------------------------

#: the mesh train driver's crash and resume: reduced qwen1.5-0.5b at the
#: size of its CPU tests (the full-width checkpoint round trip is the
#: failover sequence's)
DRIVER_ARGS = ("--steps", "10", "--batch", "4", "--seq", "32",
               "--ckpt-every", "5")
#: the decode tenant's configs (full width)
VSLICE_MUX_ARGS = ("--full",)
DRIVER_FAIL_AT = 6
PATH_KERNELS["vslices"] = ("flash_attention", "decode_attention")
#: the multi-card VSlices (two cards or more): alice and bob's decode
#: programs at full width, cut to VSLICE_DEPTH layers, fp32, on the two
#: rows of a (2, n/2) pod; held to one card within MULTI_TOL
VSLICE_TENANTS = (("alice", "qwen1.5-0.5b", 1), ("bob", "internlm2-1.8b", 2))
VSLICE_DEPTH, VSLICE_B, VSLICE_CAP, VSLICE_DECODE = 2, 4, 64, 4


def multi_card_vslices(world, device, full=True):
    """The two-tenant space multiplexing on a (2, world / 2) pod mesh of
    NCCL ranks (every rank calls this; ``full=False`` and a CPU device
    rehearse it on gloo ranks at the reduced configs): alice and bob on a
    row each run their decode programs (``VSLICE_*``, fp32); bob leaves,
    alice migrates to a fresh row and grows to the whole pod, her
    weights restored from the checkpoint over the grown slice's mesh,
    and decodes again. → on rank 0, each run's max |d| against the
    one-card decode program on the same weights; elsewhere None."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.core import VMM, ProgramRequest
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core.reconfig import CompileService
    from repro_torch.core.vmm import world_barrier
    from repro_torch.launch.mesh import (make_local_mesh, pod_rows,
                                         shared_tempdir)
    from repro_torch.models import Model
    from repro_torch.parallel import abstract_params, build_decode
    from repro_torch.parallel import build_step_for_cell
    from repro_torch.parallel import partition as part
    mt = example("torch_multi_tenant_serving")
    rank = dist.get_rank()
    pod_shape, row = pod_rows(world)

    def decode(t, params, cfg, toks):
        """The tenant's decode program over its slice's mesh from a zero
        ring, teacher-forced on ``toks``: each step's whole logits."""
        caches = t_spec = None
        if t.vslice.member:
            _, c_specs, t_spec, _ = t.program.bitfile.compiled.specs
            caches = part.distribute(Model(cfg, device).init_cache(
                VSLICE_B, VSLICE_CAP), c_specs, t.vslice.mesh)
        return [None if x is None else x.cpu() for x in mt.decode_on_mesh(
            params, caches, cfg.vocab, t.vslice.mesh, t_spec, t.device.run,
            tokens=toks)]

    pod = make_local_mesh(pod_shape, device_type=device.type)

    def cut(cfg):
        return dataclasses.replace(cfg, n_layers=VSLICE_DEPTH,
                                   compute_dtype="float32")
    ckpt = shared_tempdir("vslices_ckpt_")
    vmm = VMM(pod, policy="hybrid", ckpt_root=ckpt,
              hbm_per_chip=None if device.type == "cuda" else 1 << 30)
    vmm.compiler = CompileService(lambda cfg, target, cell, **kw:
                                  build_step_for_cell(cut(cfg), target, cell,
                                                      **kw))
    cell = ShapeCell("vs", VSLICE_CAP, VSLICE_B, "decode")
    runs, weights = [], {}
    try:
        tenants = [vmm.create_vm(name, row) for name, _, _ in VSLICE_TENANTS]
        for t, (name, arch, seed) in zip(tenants, VSLICE_TENANTS):
            cfg = cut(get_config(arch, reduced=not full))
            gen = torch.Generator(device=device).manual_seed(seed)
            weights[name] = Model(cfg, device).init(gen)
            toks = [torch.randint(0, cfg.vocab, (VSLICE_B, 1), generator=gen,
                                  device=device, dtype=torch.int32)
                    for _ in range(VSLICE_DECODE)]
            t.device.reprogram(ProgramRequest(arch, "decode", VSLICE_CAP,
                                              VSLICE_B, reduced=not full))
            params = part.distribute(
                weights[name], t.program.bitfile.compiled.specs[0],
                t.vslice.mesh) if t.vslice.member else None
            runs.append((name, cfg, toks, f"{t.vslice.spec.shape} ranks "
                         f"{t.vslice.ranks}", decode(t, params, cfg, toks)))
            t.state = {"params": params}
        alice = tenants[0]
        name, cfg, toks = runs[0][:3]
        aparams = abstract_params(Model(cfg, device="meta"))

        def placed(vs):
            return {"params": part.shardings(
                part.param_specs(cfg, aparams, vs.mesh), vs.mesh)}
        vmm.destroy_vm("bob")
        vmm.migrate_tenant(alice, new_shape=row,
                           state_template={"params": aparams},
                           shardings_fn=placed)
        vmm.migrate_tenant(alice, new_shape=pod_shape,
                           state_template={"params": aparams},
                           shardings_fn=placed)
        runs.append((name, cfg, toks, f"grown to {alice.vslice.spec.shape} "
                     f"ranks {alice.vslice.ranks}",
                     decode(alice, alice.state["params"], cfg, toks)))
        hits, misses = vmm.compiler.hits, vmm.compiler.misses
    finally:
        vmm.shutdown()
        world_barrier(pod)
    got = [r[4] for r in runs]
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, got)
    if rank != 0:
        return None
    out = []
    for i, (name, cfg, toks, where, _) in enumerate(runs):
        mine = next(g[i] for g in gathered if g[i][0] is not None)
        step, _ = build_decode(cfg, device, cell)
        caches = Model(cfg, device).init_cache(VSLICE_B, VSLICE_CAP)
        err = 0.0
        for j, tok in enumerate(toks):
            logits, caches = step(weights[name], caches, tok, torch.tensor(
                j, dtype=torch.int32, device=device))
            err = max(err, float((mine[j] - logits.cpu()).abs().max()))
        out.append({"tenant": name, "where": where, "max_abs_err": err,
                    "hits_misses": (hits, misses)})
    return out


def vslices_phase(device, launches, smi, failover, mux_alice):
    """VSlices carved from a pod ``DeviceMesh`` on the card: a one-rank
    NCCL world over a ``file://`` store (no network) and a VMM over a
    (1, 1) pod mesh whose grid entry is rank 0's card. The failover
    example's sequence (``train_on_pod``) at ``[elastic-failover]``'s cut:
    6 train steps through the tenant's mesh program, a checkpoint,
    ``mark_slice_failed``, ``migrate_tenant(..., shardings_fn=)`` back
    onto the one rectangle, 6 steps, and the same 12 steps natively on
    the mesh; qwen1.5-0.5b's decode program through a tenant at full
    width (``serve_on_pod``); the mesh train driver's ``--fail-at 6`` and
    ``--resume`` at reduced size. Gates: the 12 losses equal, bit for
    bit, ``[elastic-failover]``'s (``failover``: the device-grid VMM's
    run in this call), and the uninterrupted mesh run's; the restored
    leaves equal the checkpointed ones, and their bit sums the device
    grid's restored leaves' (when the losses were bit for bit); alice's
    logits equal ``[elastic-mux]``'s wfq run's
    (else the step named and held to 3e-2); the driver exits 17 and its
    resumed losses equal the uninterrupted run's; flash and
    decode_attention launched as many times as the path reckons."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_local_mesh
    path = "vslices"
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="vslices_")
    torch.cuda.empty_cache()
    dev = ["--device", device.type]
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method="file://" + os.path.join(tmp, "store"), rank=0,
        world_size=1)
    common.reset_launches()
    try:
        pod = make_local_mesh((1, 1), device_type=device.type)
        ef = example("torch_elastic_failover")
        t = time.perf_counter()
        fargs = ef.parse_args([*dev, *FAILOVER_ARGS])
        out = ef.train_on_pod(pod, fargs)
        fo_s = time.perf_counter() - t
        n = 2 * ef.PHASE_STEPS
        losses = out["losses"]
        log(f"[{path}] {smi}: failover on a (1, 1) pod mesh, {ef.ARCH} "
            f"{FAILOVER_ARGS}: slices {out['slices']}; losses "
            f"{[round(x, 4) for x in losses]}; checkpoint "
            f"{out['checkpoint_s']:.2f}s, migrate {out['migrate_s']:.2f}s; "
            f"compile hits {out['hits']} misses {out['misses']}; "
            f"{fo_s:.1f}s")
        for what, want in (("[elastic-failover]'s device-grid VMM",
                            failover["losses"][:n]),
                           ("the uninterrupted mesh run",
                            out["uninterrupted"])):
            diff = [i for i, (a, b) in enumerate(zip(losses, want)) if a != b]
            log(f"[{path}] {n} losses equal {what}'s bit for bit: "
                f"{not diff and len(losses) == n}")
            if len(losses) != n or any(
                    abs(losses[i] - want[i]) > TOL["bfloat16"] for i in diff):
                raise AssertionError(f"{path}: losses {losses} vs {want}")
            if diff:
                log(f"[{path}] steps {diff} differ from {what}'s, within "
                    f"{TOL['bfloat16']}")
        if not out.get("restored_equal"):
            raise AssertionError(f"{path}: the restored state differs from "
                                 "the checkpointed one")
        grid = failover["restored_sums"]
        differ = [k for k, v in out["restored_sums"].items() if grid[k] != v]
        log(f"[{path}] restored leaves equal the checkpointed ones bit for "
            f"bit; their bit sums equal the device-grid VMM's restored "
            f"leaves' for {len(grid) - len(differ)} of {len(grid)} leaves"
            + (f" (not: {differ})" if differ else ""))
        if differ and losses == failover["losses"][:n]:
            raise AssertionError(f"{path}: restored leaves {differ} differ "
                                 "from the device grid's after equal steps")
        del out
        torch.cuda.empty_cache()
        mt = example("torch_multi_tenant_serving")
        t = time.perf_counter()
        res = mt.serve_on_pod(pod, mt.parse_args([*dev, *VSLICE_MUX_ARGS]))
        got = res["tenants"]["alice"]["logits"]
        diff = [i for i, (a, b) in enumerate(zip(got, mux_alice))
                if not torch.equal(a, b)]
        worst = max([float((got[i].float() - mux_alice[i].float()).abs()
                           .max()) for i in diff], default=0.0)
        verdict = "equal" if not diff else \
            f"not equal at steps {diff} (max |d| {worst:.3g}) to"
        log(f"[{path}] {smi}: qwen1.5-0.5b decode program through a tenant "
            f"on a (1, 1) pod mesh, full width: {len(got)} steps' logits "
            f"{verdict} [elastic-mux]'s device-grid tenant's bit for bit; "
            f"native on "
            f"the mesh: {res['tenants']['alice']['native_equal']}; "
            f"{time.perf_counter() - t:.1f}s")
        if len(got) != len(mux_alice) or worst > TOL["bfloat16"] or \
                not res["tenants"]["alice"]["native_equal"]:
            raise AssertionError(f"{path}: alice's logits")
        del res, got
        t = time.perf_counter()
        ck = os.path.join(tmp, "driver")
        whole = train.main([*dev, *DRIVER_ARGS, "--ckpt-dir", ck + "_whole"])
        try:
            train.main([*dev, *DRIVER_ARGS, "--ckpt-dir", ck, "--fail-at",
                        str(DRIVER_FAIL_AT)])
            code = 0
        except SystemExit as e:
            code = e.code
        resumed = train.main([*dev, *DRIVER_ARGS, "--ckpt-dir", ck,
                              "--resume"])
        same = resumed == {k: whole[k] for k in resumed}
        log(f"[{path}] {smi}: the mesh train driver on a one-rank world: "
            f"--fail-at {DRIVER_FAIL_AT} exited {code}; --resume ran steps "
            f"{sorted(resumed)}, {'equal to' if same else 'DIFFERENT from'} "
            f"the uninterrupted run's losses bit for bit; "
            f"{time.perf_counter() - t:.1f}s")
        if code != train.FAIL_EXIT or not same or \
                sorted(resumed) != list(range(DRIVER_FAIL_AT, 10)):
            raise AssertionError(f"{path}: driver {code} {resumed} {whole}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    counts = dict(common.LAUNCHES)
    want = {"flash_attention":
            2 * n * train_launches(ef.train_config(
                fargs.full, fargs.depth))["flash_attention"]
            + 20 * train_launches(get_config("qwen1.5-0.5b", reduced=True))[
                "flash_attention"],
            "decode_attention":
            2 * mt.TOKENS * get_config("qwen1.5-0.5b").n_layers}
    log(f"[{path}] launches {counts} (reckoned {want})")
    for k, v in want.items():
        if counts.get(k, 0) != v:
            raise AssertionError(f"{path}: {k} launched {counts.get(k, 0)} "
                                 f"times, want {v}")
    count_path(path, counts, launches)
    torch.cuda.empty_cache()
    log(f"[{path}] took {time.perf_counter() - t0:.1f}s")


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
    # timed before the serving phases: a trace taken after them often
    # holds no device event and is taken again
    times = time_kernels(device)
    phase_done("times")

    weights = build_weights(device)
    phase_done("weights")
    cfg, model, params = weights["qwen1.5-0.5b"]
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
    phase_done("serve qwen")
    rmodes, rvirt = recurrent_serve_phases(device, launches, weights)
    modes.update(rmodes)
    phase_done("serve recurrent")

    vmm_programs_phase(device, launches)
    served_b4 = {}
    for arch, short, depth in RECURRENT_ARCHS:
        served_b4[short] = recurrent_programs_phase(
            device, launches, weights, arch, short, depth)
    reference_phase(device)
    recurrent_reference_phase(device)
    program_reference_phase(device)
    phase_done("VMM programs and references")
    kv_hierarchy_phase(device, launches, weights)
    phase_done("kv-hierarchy")
    weights.clear()
    torch.cuda.empty_cache()
    mux_phase(device, launches)
    torch.cuda.empty_cache()
    phase_done("mux")
    families_phase(device, launches, smi)
    phase_done("families")
    train = train_phases(device, launches, smi)
    phase_done("train")
    apps_phase(device, launches)
    phase_done("apps")
    mux = elastic_mux_phase(device, launches, smi)
    phase_done("elastic-mux")
    failover = elastic_failover_phase(device, launches, smi)
    phase_done("elastic-failover")
    autoscaler_phase(device, launches, smi)
    phase_done("autoscaler")
    long_context_phase(device, launches, smi)
    phase_done("long-context")
    sharded_phase(device, launches, smi)
    phase_done("sharded")
    dryrun_phase(device, smi)
    phase_done("dryrun")
    vslices_phase(device, launches, smi, failover, mux)
    del failover, mux
    phase_done("vslices")

    if "--profile" in sys.argv[1:]:
        model = Model(cfg, device)
        params = model.init_compute_params(
            torch.Generator(device=device).manual_seed(0))
        for mode in ("monolithic", "chunked"):
            profile_phase(mode, cfg, model, params, requests)
        del params, model
        torch.cuda.empty_cache()
        for arch, short, _ in RECURRENT_ARCHS:
            rcfg = get_config(arch)
            model = Model(rcfg, device)
            params = model.init_compute_params(
                torch.Generator(device=device).manual_seed(0))
            for mode in ("monolithic", "chunked"):
                profile_phase(mode, rcfg, model, params,
                              make_requests(rcfg.vocab),
                              name=f"{short}-{mode}",
                              engine_kw={"state_paging": True})
            del params, model
            torch.cuda.empty_cache()

    log_times(times, launches)
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
    for short, r in rvirt.items():
        nat = modes[f"{short}-chunked"]["step_p50_ms"]
        log(f"[time:{short}-virtualized-chunked] {r['tok_s']:.1f} tok/s "
            f"over the run; engine step p50 {r['step_p50_ms']:.3f} ms "
            f"(native {nat:.3f} ms, ratio {r['step_p50_ms'] / nat:.3f})")
    for r in train:
        log(f"[time:train] {smi}: {r['arch']} ({r['cut']}, B={r['B']} "
            f"S={r['S']}): step p50 {r['step_p50_ms']:.1f} ms, "
            f"{r['tokens_s']:.0f} tokens/s, peak {r['peak_gb']:.2f} GB "
            f"(reckoned without activations: donated "
            f"{r['reckoned_gb']:.2f} GB, functional "
            f"{r['functional_gb']:.2f} GB)"
            + (f"; through the VMM {r['virt_step_p50_ms']:.1f} ms (ratio "
               f"{r['virt_step_p50_ms'] / r['step_p50_ms']:.4f})"
               if "virt_step_p50_ms" in r else "")
            + (f"; the profiled node's backward {100 * r['bwd_share']:.1f}% "
               f"of the step's device time" if "bwd_share" in r else ""))
    for short, r in served_b4.items():
        micro = times[f"{r['kernel']}@B4S4096"]["ms"] \
            if f"{r['kernel']}@B4S4096" in times else None
        log(f"[time:{short}-vmm-programs] {r['kernel']} at B=4 S=4096 on "
            f"the prefill program's path: {fmt_ms(r['rec_ms_b4'])} device ms "
            f"a call (micro-timing: "
            + (f"{micro:.4f} ms)" if micro is not None else "none)"))

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
