#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines and raising on any failure:

1. device — the card's name and power limit (nvidia-smi), torch/CUDA
   versions, and the time to build the kernels from ``kernels/csrc``
   (one nvcc per source, all started together);
2. kernels — every hand-written kernel against its plain PyTorch
   version on the card, in bf16 at the serving path's shapes, at G > 1
   shapes, with a dead slot, NaN-poisoned masked pool rows and a
   cross-block sampler tie, each against a stated tolerance;
3. serve, monolithic — full-width ``qwen1.5-0.5b`` (random weights from
   a fixed seed) through ``ServeEngine``: 8 requests, batch 4, prompts of
   32–130 tokens, 32 new tokens each, capacity 256, 16-token pages;
4. serve, chunked — the same requests with ``chunk_tokens=32``;
   in 3 and 4 every kernel of the path must have launched, every request
   must finish, ``full_prefills == 0`` and pages leased == freed;
5. reference — the card against the plain PyTorch path on the CPU:
   full-width fp32 prefill logits, and reduced-config engine token ids
   in both modes;
6. times — per mode TTFT, throughput and the median engine step; per
   kernel its device time (torch.profiler/CUPTI; the per-call CUDA-event
   time is printed beside it), its plain version's, one PyTorch call
   computing the same function (``library_ms``, a yardstick the port
   never calls) and the bound.

``--profile`` adds a torch.profiler pass over steady decode steps of
both modes (device busy share, top device-time entries).

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``src/``, the script exits non-zero and prints no result.
"""
from __future__ import annotations

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
}
PATH_KERNELS = {"monolithic": ("flash_attention", "fused_paged_decode"),
                "chunked": ("fused_paged_decode", "sample_tokens")}


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def device_ms(fn, reps=50, warmup=5):
    """Device time of one call: the CUPTI durations of every kernel and
    copy the call launches (torch.profiler), summed over ``reps`` calls
    and divided by ``reps``. Per-call CUDA-event timing would add the
    host's launch latency to kernels this short."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(r[0] for r in device_rows(prof)) / reps / 1e3


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


def timed(fn):
    """→ (device ms, event ms) of one call."""
    return device_ms(fn), wall_ms(fn)


def bound(nbytes, flops, peak):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


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


def flash_inputs(S, Hq, Hkv, dtype, device, seed, hd=64):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda h: torch.randn((1, S, h, hd), generator=g,  # noqa: E731
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


def poison_masked_rows(d, window=0):
    """NaN into every pool row the slots' lengths (and window) mask."""
    import torch
    P, ps = d["k_pages"].shape[:2]
    live = torch.zeros((P, ps), dtype=torch.bool)
    for b, L in enumerate(d["lengths"].tolist()):
        lo = max(0, L - window) if window else 0
        for t in range(lo, max(L - 1, 0)):
            live[int(d["block_tables"][b, t // ps]), t % ps] = True
    live = live.to(d["k_pages"].device)
    for kk in ("k_pages", "v_pages"):
        d[kk][~live] = float("nan")


def sampler_inputs(B, V, device, seed):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    logits = torch.randn((B, V), generator=g, device=device) * 3.0
    u = torch.rand((B, V), generator=g, device=device).clamp_min(1e-20)
    temps = torch.tensor([0.0, 0.8, 0.0, 1.5][:B], device=device)
    return logits, temps, -torch.log(-torch.log(u))


def check_kernels(device, errs):
    import torch
    from repro_torch.kernels.decode_attention.ops import (
        fused_decode_step_op, sample_tokens_op)
    from repro_torch.kernels.decode_attention.ref import (
        fused_paged_decode_ref, sample_tokens_ref)
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

    V = 152064
    logits, temps, noise = sampler_inputs(4, V, device, seed=1)
    got = sample_tokens_op(logits, temps, noise)
    want = sample_tokens_ref(logits, temps, noise)
    mism = int((got != want).sum())
    log(f"[kernel] sample_tokens B=4 V={V} temps={temps.tolist()}: "
        f"{mism} mismatches (exact match required) "
        f"{'ok' if mism == 0 else 'FAIL'}")
    if mism:
        raise AssertionError("sample_tokens disagrees with argmax")
    tie = torch.zeros((2, V), device=device)
    tie[0, [100, 3000]] = 5.0                 # across 2048-wide blocks
    tie[1, [2050, 2051]] = 2.0                # inside one block
    z = torch.zeros((2,), device=device)
    got = sample_tokens_op(tie, z, torch.zeros_like(tie)).tolist()
    log(f"[kernel] sample_tokens ties: {got} (want [100, 2050]) "
        f"{'ok' if got == [100, 2050] else 'FAIL'}")
    if got != [100, 2050]:
        raise AssertionError("sample_tokens tie rule broken")
    errs["sample_tokens"] = 0.0


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
          capacity=256, page_size=16, obs=None):
    from repro_torch.serving import ServeEngine
    eng = ServeEngine(cfg, model, batch, capacity, page_size=page_size,
                      chunk_tokens=chunk_tokens, obs=obs, obs_tenant="smoke")
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


def serve_phase(mode, cfg, model, params, requests, launches):
    from repro_torch.kernels import common
    from repro_torch.obs import ObsHub
    chunk = 32 if mode == "chunked" else 0
    serve(cfg, model, params, requests[:2], chunk)          # warm-up run
    obs = ObsHub(enabled=True)
    common.reset_launches()
    eng, outs, wall, steps = serve(cfg, model, params, requests, chunk,
                                   obs=obs)
    counts = dict(common.LAUNCHES)
    s = eng.stats
    log(f"[serve:{mode}] {s.completed} requests, {s.generated_tokens} "
        f"tokens in {wall:.3f}s; {s.steps} steps, {s.prefills} prefills "
        f"(full_prefills={s.full_prefills}, chunks={s.prefill_chunks}), "
        f"{s.page_faults} page faults, pages leased={s.pages_leased} "
        f"freed={s.pages_freed}; launches={counts}")
    if s.completed != len(requests) or any(
            len(o) != n for o, (_, n, _) in zip(outs, requests)):
        raise AssertionError(f"{mode}: not every request finished")
    if s.full_prefills != 0 or s.pages_leased != s.pages_freed:
        raise AssertionError(f"{mode}: paging invariants broken")
    for k in PATH_KERNELS[mode]:
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"{mode}: kernel {k} never launched")
        launches[k] = launches.get(k, 0) + counts[k]
    ten = obs.tracer.snapshot()["tenants"]["smoke"]
    return {"ttft_p50_ms": 1e3 * ten["ttft_s"]["p50"],
            "ttft_p95_ms": 1e3 * ten["ttft_s"]["p95"],
            "queue_p50_ms": 1e3 * ten["queue_wait_s"]["p50"],
            "tok_s": s.generated_tokens / wall,
            "step_p50_ms": 1e3 * statistics.median(steps),
            "outs": outs}


def profile_phase(mode, cfg, model, params, requests, n_steps=8):
    """torch.profiler over ``n_steps`` steady decode steps (every slot
    decoding, no admission in the window): device busy share and the
    top device-time entries."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import ServeEngine
    eng = ServeEngine(cfg, model, 4, 256, page_size=16,
                      chunk_tokens=32 if mode == "chunked" else 0)
    for p, _, t in requests[:4]:
        eng.submit(p, max_new_tokens=n_steps + 16, temperature=t)
    while (eng.positions < 0).any() or eng.waiting:
        eng.step(params)                  # admit and prefill all four
    eng.step(params)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step(params)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    log(f"[profile:{mode}] {n_steps} decode steps, B=4: wall "
        f"{wall_us / 1e3:.3f} ms ({wall_us / 1e3 / n_steps:.3f} ms/step), "
        f"device busy {busy / 1e3:.3f} ms, idle share "
        f"{1 - busy / wall_us:.3f}")
    for dev, count, key in rows[:12]:
        log(f"[profile:{mode}]   {dev / 1e3:9.3f} ms  x{count:<5d} "
            f"{key[:90]}")


# ---------------------------------------------------------------------------
# phase 5: the card against the plain path on the CPU
# ---------------------------------------------------------------------------

def reference_phase(device):
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    def cpu_copy(tree):
        if isinstance(tree, dict):
            return {k: cpu_copy(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cpu_copy(v) for v in tree]
        return tree.cpu()

    # full width, fp32 compute: prefill logits card vs CPU
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"),
                              compute_dtype="float32")
    m_dev, m_cpu = Model(cfg, device), Model(cfg, "cpu")
    params = m_dev.init(torch.Generator(device=device).manual_seed(7))
    toks = make_requests(cfg.vocab, 1, seed=3)[0][0][:40]
    tok = torch.from_numpy(toks[None]).long()
    got, _ = m_dev.prefill(params, {"tokens": tok.to(device)})
    want, _ = m_cpu.prefill(cpu_copy(params), {"tokens": tok})
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
        b = serve(rcfg, r_cpu, cpu_copy(rp), reqs, chunk, batch=3,
                  capacity=64, page_size=8)[1]
        log(f"[reference] reduced engine chunk={chunk} token ids card vs "
            f"CPU: {'identical' if a == b else 'DIFFER'}")
        if a != b:
            raise AssertionError(f"engine tokens differ: {a} vs {b}")


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
    b, by = bound(4 * S * H * hd * 2, H * pairs * 4 * hd, BF16_FLOPS)
    out["flash_attention"] = {
        "shape": f"B=1 S={S} Hq=Hkv={H} hd={hd} bf16 causal",
        "ms": timed(lambda: flash_attention_op(q, k, v)),
        "plain_ms": timed(lambda: flash_attention_ref(q, k, v)),
        "library_ms": timed(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        "bound_ms": b, "bound_by": by}

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
    b, by = bound(nbytes, sum(lens) * H * 4 * hd, BF16_FLOPS)
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
        "bound_ms": b, "bound_by": by}

    # sampler: B=4 rows of the padded vocabulary, fp32
    V = 152064
    logits, temps, noise = sampler_inputs(4, V, device, seed=5)
    b, by = bound(2 * 4 * V * 4 + 4 * 4 + 4 * 4, 2 * 4 * V, FP32_FLOPS)
    out["sample_tokens"] = {
        "shape": f"B=4 V={V} fp32",
        "ms": timed(lambda: sample_tokens_op(logits, temps, noise)),
        "plain_ms": timed(lambda: sample_tokens_ref(logits, temps,
                                                        noise)),
        "library_ms": timed(lambda: torch.argmax(
            logits + noise * temps[:, None], dim=-1)),
        "bound_ms": b, "bound_by": by}
    for name, r in out.items():
        log(f"[time] {name} {r['shape']}: device ms (event ms per call) — "
            f"kernel {r['ms'][0]:.4f} ({r['ms'][1]:.4f}), plain "
            f"{r['plain_ms'][0]:.4f} ({r['plain_ms'][1]:.4f}), library "
            f"{r['library_ms'][0]:.4f} ({r['library_ms'][1]:.4f}); bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']})")
        for key in ("ms", "plain_ms", "library_ms"):
            r[key] = r[key][0]                     # the JSON line: device
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

    errs = {}
    check_kernels(device, errs)

    cfg = get_config("qwen1.5-0.5b")
    model = Model(cfg, device)
    params = model.compute_params(
        model.init(torch.Generator(device=device).manual_seed(0)))
    requests = make_requests(cfg.vocab)
    launches, modes = {}, {}
    for mode in ("monolithic", "chunked"):
        modes[mode] = serve_phase(mode, cfg, model, params, requests,
                                  launches)
        outs = modes[mode].pop("outs")
        flat = [t for o in outs for t in o]
        if not all(0 <= t < cfg.vocab for t in flat):
            raise AssertionError(f"{mode}: token id out of range")
    del params, model
    torch.cuda.empty_cache()

    reference_phase(device)

    if "--profile" in sys.argv[1:]:
        model = Model(cfg, device)
        params = model.compute_params(
            model.init(torch.Generator(device=device).manual_seed(0)))
        for mode in ("monolithic", "chunked"):
            profile_phase(mode, cfg, model, params, requests)
        del params, model
        torch.cuda.empty_cache()

    times = time_kernels(device)
    for mode, r in modes.items():
        log(f"[time:{mode}] ttft p50 {r['ttft_p50_ms']:.2f} ms, p95 "
            f"{r['ttft_p95_ms']:.2f} ms (queue wait p50 "
            f"{r['queue_p50_ms']:.2f} ms); {r['tok_s']:.1f} tok/s over the "
            f"run; engine step p50 {r['step_p50_ms']:.3f} ms = "
            f"{4e3 / r['step_p50_ms']:.1f} decode tok/s at 4 slots")

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
