#!/usr/bin/env python3
"""A/B variants of the RWKV-6 WKV and vecadd kernels on one NVIDIA GPU.

    python3 tools/wkv_variants.py [--ablate]

Builds text-substituted copies of ``csrc/rwkv6_wkv.cu`` and
``csrc/vecadd.cu`` into ``build/wkv_variants/<variant>/``, beside the
sequential WKV that the chunked kernel replaced
(``tools/wkv_sequential.cu``), one nvcc each, all started together.
Checks every variant against the plain versions (the WKV at atol = rtol
= 2e-3, also with decays of -50 mixed with ~-1e-3; vecadd exactly, fp32
and bf16), then times them in turns (each twice, in forward and reverse
order, printed as the faster and the slower turn, so a drift of the
card shows as a spread): the WKV at the shapes the serving path
launches and at B=4, S=4096, for every V split (CTAs a head); vecadd at
2^26 fp32 beside ``torch.add``. Variants:

- WKV ``c16``: the kernel as it is (chunks of 16 tokens, SIMT fp32);
  ``c32``: chunks of 32 tokens where K <= 64; ``tf32``: the output (4)
  and state (5) products on the tensor cores, ``mma.sync`` m16n8k8 in
  3xTF32 (hi * hi + hi * lo + lo * hi: one TF32 rounding would cost the
  2e-3 tolerance about three digits), a warp per 16 x 8 tile, fragments
  loaded from shared memory (V slices of a multiple of 8 columns only);
  ``seq``: the sequential form (one CTA of K threads a (batch, head));
- vecadd ``one-pass``: the kernel as it is (one 16-byte vector an
  operand a thread, a grid over all of n); ``capped``: the grid capped
  at 16 blocks an SM, striding.

``--ablate`` adds timing-only copies of ``c16`` (their outputs are
wrong and not checked) with one phase's work removed and its barriers
kept: ``-no1`` the scan, ``-no2`` the decay-scaled operands, ``-no3a`` /
``-no3b`` the scores off / on the diagonal blocks, ``-no4`` the output,
``-no5`` the state update, ``-bare`` all six (loads, barriers and the
loop alone): what each phase costs is the time it takes away.

Timings are only compared inside one run: two runs may land on cards
with other power limits.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

OUT = os.path.join(ROOT, "build", "wkv_variants")
SEQUENTIAL = os.path.join(ROOT, "tools", "wkv_sequential.cu")

#: the tensor-core helpers, put before the WKV kernel
TF32_HELPERS = r"""
// x = hi + lo, both TF32 (the low 13 bits of the mantissa zero)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32; a: rows g, g + 8 by columns q, q + 4 of a 16 x 8
// tile (the m16n8k8 A fragment), b: rows q, q + 4 of column g (B)
__device__ __forceinline__ void mma3(float (&d)[4], const float (&a)[4],
                                     const float (&b)[2]) {
  unsigned ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int x = 0; x < 4; ++x) split_tf32(a[x], ah[x], al[x]);
  split_tf32(b[0], bh[0], bl[0]);
  split_tf32(b[1], bh[1], bl[1]);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

"""
#: (4) and (5) on the tensor cores, in place of the SIMT loops
TF32_PHASES = r"""    // (4) o = (r e^Lp) S + A v: warp w takes
    // the 16 x 8 output tiles w, w + 8, ... (C = 16 rows: one tile row)
    const int warp = tid / 32, g = (tid % 32) / 4, q = tid % 4;
    for (int n0 = warp * 8; n0 < vs; n0 += NT / 4) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < K; k0 += 8) {
        const float a[4] = {qi[g * KP + k0 + q], qi[(g + 8) * KP + k0 + q],
                            qi[g * KP + k0 + q + 4],
                            qi[(g + 8) * KP + k0 + q + 4]};
        const float b[2] = {st[(k0 + q) * vp + n0 + g],
                            st[(k0 + q + 4) * vp + n0 + g]};
        mma3(d, a, b);
      }
#pragma unroll
      for (int k0 = 0; k0 < C; k0 += 8) {
        const float a[4] = {A[g * AP + k0 + q], A[(g + 8) * AP + k0 + q],
                            A[g * AP + k0 + q + 4],
                            A[(g + 8) * AP + k0 + q + 4]};
        const float b[2] = {vsh[(k0 + q) * vp + n0 + g],
                            vsh[(k0 + q + 4) * vp + n0 + g]};
        mma3(d, a, b);
      }
      float* orow = ob + (size_t)t0 * K + n0 + 2 * q;
      if (g < n)
        *reinterpret_cast<float2*>(orow + (size_t)g * K) =
            make_float2(d[0], d[1]);
      if (g + 8 < n)
        *reinterpret_cast<float2*>(orow + (size_t)(g + 8) * K) =
            make_float2(d[2], d[3]);
    }
    __syncthreads();                      // every read of S is done

    // (5) S = e^L_last S + (k e^(L_last - L))^T v, 16 x 8 state tiles
    // spread over the warps
    for (int tile = warp; tile < (K / 16) * (vs / 8); tile += NT / 32) {
      const int m0 = (tile / (vs / 8)) * 16, n0 = (tile % (vs / 8)) * 8;
      float* sa = st + (m0 + g) * vp + n0 + 2 * q;
      float* sb = st + (m0 + g + 8) * vp + n0 + 2 * q;
      const float da = ex2(ll[m0 + g]), db = ex2(ll[m0 + g + 8]);
      float d[4] = {da * sa[0], da * sa[1], db * sb[0], db * sb[1]};
#pragma unroll
      for (int k0 = 0; k0 < C; k0 += 8) {
        const float a[4] = {kd[(k0 + q) * KP + m0 + g],
                            kd[(k0 + q) * KP + m0 + g + 8],
                            kd[(k0 + q + 4) * KP + m0 + g],
                            kd[(k0 + q + 4) * KP + m0 + g + 8]};
        const float b[2] = {vsh[(k0 + q) * vp + n0 + g],
                            vsh[(k0 + q + 4) * vp + n0 + g]};
        mma3(d, a, b);
      }
      sa[0] = d[0];
      sa[1] = d[1];
      sb[0] = d[2];
      sb[1] = d[3];
    }
"""
#: where (4) starts and the chunk loop ends, and the kernel's first line
P4 = "    // (4) o = (r e^Lp) S + A v"
LOOP_END = ("  }\n  __syncthreads();                        "
            "// the last chunk's state")
KERNEL = "// two CTAs an SM"


def _tf32(text):
    """The (old, new) pairs that put (4) and (5) on the tensor cores."""
    a, b = text.index(P4), text.index(LOOP_END)
    return [(text[a:b], TF32_PHASES), (KERNEL, TF32_HELPERS + KERNEL)]


#: kernel → variant → (old, new) text substitutions, or a function of the
#: source giving them
VARIANTS = {
    "rwkv6_wkv": {
        "c16": [],
        "c32": [("  static constexpr int C = CHUNK;",
                 "  static constexpr int C = K > 64 ? 16 : 32;")],
        "tf32": _tf32,
    },
    "vecadd": {
        "one-pass": [],
        "capped": [("  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;",
                    "  if (blocks > 132 * 16) blocks = 132 * 16;")],
    },
}
#: timing-only ablations of c16: the loop header of a phase → no trips
PHASES = {
    "1": ("if (tid < K * LPC) {", "if (false) {"),
    "2": ("for (int x = tid; x < C * K; x += NT) {",
          "for (int x = tid; x < 0; x += NT) {"),
    "3a": ("for (int p = tid; p < C * LPR; p += NT) {",
           "for (int p = tid; p < 0; p += NT) {"),
    "3b": ("for (int p0 = 0; p0 < TASKS; p0 += NT) {",
           "for (int p0 = 0; p0 < 0; p0 += NT) {"),
    "4": ("for (int x = tid; x < (C / 2) * nj; x += NT) {",
          "for (int x = tid; x < 0; x += NT) {"),
    "5": ("for (int x = tid; x < (K / 4) * nj; x += NT) {",
          "for (int x = tid; x < 0; x += NT) {"),
}
ABLATE = {**{f"c16-no{k}": [v] for k, v in PHASES.items()},
          "c16-bare": list(PHASES.values())}
#: (B, H, S, K): rwkv6-7b's chunked-prefill call and monolithic prefill,
#: and the long batch
WKV_SHAPES = ((1, 64, 32, 64), (1, 64, 130, 64), (4, 64, 4096, 64))


def _substitute(name, text, subs):
    if callable(subs):
        subs = subs(text)
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old[:60]!r} not found once")
        text = text.replace(old, new)
    return text


def build(common, ablate=False):
    """→ {(kernel, variant): CDLL}; a variant that fails to build is
    reported and left out."""
    jobs = {}
    variants = {kernel: dict(v) for kernel, v in VARIANTS.items()}
    if ablate:
        variants["rwkv6_wkv"].update(ABLATE)
    for kernel, named in variants.items():
        text = (common.CSRC / f"{kernel}.cu").read_text()
        for name, subs in named.items():
            os.makedirs(os.path.join(OUT, name), exist_ok=True)
            src = os.path.join(OUT, name, f"{kernel}.cu")
            with open(src, "w") as f:
                f.write(_substitute(name, text, subs))
            jobs[(kernel, name)] = src
    jobs[("rwkv6_wkv", "seq")] = SEQUENTIAL
    procs = {}
    for (kernel, name), src in jobs.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        procs[(kernel, name)] = subprocess.Popen(
            [common._nvcc(), *common.NVCC_FLAGS, f"-I{common.CSRC}",
             "-Xptxas", "-v", "-o", os.path.join(d, f"{kernel}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (kernel, name), p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            cs.log(f"[{kernel}/{name}] build failed:\n{log[-3000:]}")
            continue
        for entry, regs, st, ld in common.ptxas_usage(log):
            cs.log(f"[ptxas] {kernel}/{name}: {entry}: {regs} registers, "
                   f"spill stores {st} B, spill loads {ld} B")
        libs[(kernel, name)] = ctypes.CDLL(os.path.join(OUT, name,
                                                        f"{kernel}.so"))
    return libs


def _splits(name, K):
    """The V splits a variant runs at K: (None,) for the sequential
    kernel; the tensor-core one wants slices of a multiple of 8."""
    if name == "seq":
        return (None,)
    step = 8 if name == "tf32" else 4
    return tuple(nv for nv in (1, 2, 4) if K % (step * nv) == 0)


def _entry(lib, fn, argtypes):
    f = getattr(lib, fn)
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong}
    f.argtypes = [kinds[a] for a in argtypes]
    f.restype = ctypes.c_int
    return f


def wkv_call(lib, ins, nv):
    """The WKV of ``lib`` on ``ins``; ``nv`` None for the sequential
    kernel (whose entry has no split)."""
    import torch
    r, k, v, w, u, s0 = ins
    B, H, S, K = r.shape
    o, sf = torch.empty_like(r), torch.empty_like(s0)
    fn = _entry(lib, "rwkv6_wkv",
                "ppppppppiiii" + ("p" if nv is None else "ip"))

    def run():
        tail = (() if nv is None else (nv,)) + (
            torch.cuda.current_stream().cuda_stream,)
        code = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                  u.data_ptr(), s0.data_ptr(), o.data_ptr(), sf.data_ptr(),
                  B, H, S, K, *tail)
        if code:
            raise RuntimeError(f"rwkv6_wkv: CUDA error {code}")
        return o, sf
    return run


def vecadd_call(lib, x, y):
    import torch
    out = torch.empty_like(x)
    fn = _entry(lib, "vecadd", "ppplip")
    code_of = {torch.float32: 0, torch.bfloat16: 1}

    def run():
        code = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
                  code_of[x.dtype], torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"vecadd: CUDA error {code}")
        return out
    return run


def in_turns(runs, reps, warmup):
    """{key: [ms forward, ms reverse]}: device ms of each call, timed in
    turns, forward then reverse."""
    times = {key: [] for key in runs}
    for key in list(runs) + list(reversed(list(runs))):
        times[key].append(cs.device_ms(runs[key], reps=reps, warmup=warmup))
    return times


def check_wkv(libs, device):
    """Every WKV variant and split against the plain version; → number of
    failures."""
    import torch
    from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref
    from repro_torch.launch.apps import max_excess
    bad = 0
    for B, H, S, K, mixed in ((2, 2, 70, 32, False), (1, 3, 45, 16, False),
                              (1, 3, 45, 48, False), (1, 2, 70, 80, False),
                              (1, 4, 130, 112, False), (1, 4, 130, 128, False),
                              (1, 64, 130, 64, False), (2, 3, 77, 64, True)):
        ins = list(cs.wkv_inputs(B, H, S, K, device, seed=S + K))
        if mixed:
            fast = torch.rand(ins[0].shape, device=device) < 0.5
            ins[3] = torch.where(fast, torch.full_like(ins[0], -50.0),
                                 torch.full_like(ins[0], -1e-3))
        want = rwkv6_wkv_ref(*ins)
        for (kernel, name), lib in libs.items():
            if (kernel != "rwkv6_wkv" or name in ABLATE
                    or (name == "seq" and K not in (32, 64))):
                continue
            for nv in _splits(name, K):
                got = wkv_call(lib, ins, nv)()
                err = max(max_excess(g, w, 2e-3, 2e-3)[1]
                          for g, w in zip(got, want))
                ok = err <= 0 and all(bool(torch.isfinite(g).all())
                                      for g in got)
                if not ok:
                    bad += 1
                cs.log(f"[check] rwkv6_wkv/{name} nv={nv} B={B} H={H} S={S} "
                       f"K={K}{' mixed decay' if mixed else ''}: "
                       f"{'ok' if ok else 'FAIL'}")
    return bad


def main():
    import torch
    if not torch.cuda.is_available():
        print("wkv_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import common
    device = torch.device("cuda")
    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip())
    t0 = time.perf_counter()
    libs = build(common, ablate="--ablate" in sys.argv[1:])
    cs.log(f"[build] {len(libs)} libraries in "
           f"{time.perf_counter() - t0:.1f}s")
    bad = check_wkv(libs, device)

    g = torch.Generator(device=device).manual_seed(8)
    for n, dt in ((50001, torch.float32), (50001, torch.bfloat16),
                  (1 << 26, torch.bfloat16)):
        x = torch.randn(n + 1, generator=g, device=device).to(dt)
        y = torch.randn(n + 1, generator=g, device=device).to(dt)
        for off in (0, 1):
            xs, ys = x[off:off + n], y[off:off + n]
            for (kernel, name), lib in libs.items():
                if kernel == "vecadd" and not torch.equal(
                        vecadd_call(lib, xs, ys)(), xs + ys):
                    cs.log(f"[check] vecadd/{name} n={n} offset={off} "
                           f"{dt}: FAIL")
                    bad += 1
    cs.log(f"[check] vecadd variants: exact at n=50001 and 2^26 (bf16), "
           f"offsets 0 and 1: {'ok' if not bad else 'see FAIL lines'}")

    for B, H, S, K in WKV_SHAPES:
        ins = cs.wkv_inputs(B, H, S, K, device, seed=2)
        runs = {}
        for (kernel, name), lib in libs.items():
            if kernel != "rwkv6_wkv":
                continue
            for nv in _splits(name, K):
                runs[f"{name}" + (f" nv={nv}" if nv else "")] = wkv_call(
                    lib, ins, nv)
        big = S > 1000
        times = in_turns(runs, 10 if big else 100, 2 if big else 10)
        cs.log(f"[variants] rwkv6_wkv B={B} H={H} S={S} K={K} (device ms, "
               "two turns): " + "; ".join(
                   f"{key} {min(t):.4f}/{max(t):.4f}"
                   for key, t in times.items()))
        del ins

    n = 1 << 26
    x = torch.randn(n, generator=g, device=device)
    y = torch.randn(n, generator=g, device=device)
    runs = {name: vecadd_call(lib, x, y) for (kernel, name), lib in
            libs.items() if kernel == "vecadd"}
    runs["torch.add"] = lambda: torch.add(x, y)
    times = in_turns(runs, 50, 5)
    cs.log(f"[variants] vecadd n={n} float32 (device ms, two turns; bound "
           f"{3 * n * 4 / cs.HBM_BYTES_PER_S * 1e3:.4f}): " + "; ".join(
               f"{key} {min(t):.4f}/{max(t):.4f}"
               for key, t in times.items()))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
