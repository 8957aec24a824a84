#!/usr/bin/env python3
"""A/B variants of the sampler and the RG-LRU scan kernels on one NVIDIA
GPU.

    python3 tools/scan_sample_variants.py [--parent DIR] [--ablate]

Builds text-substituted copies of ``csrc/sample_tokens.cu`` and
``csrc/rglru_scan.cu`` into ``build/scan_sample_variants/<variant>/``, one nvcc each, all
started together. Checks every variant (the sampler exactly against its
plain version on random rows and on chip_smoke's edge rows, NaN rows
included; the scan bit-equal to its plain version at S = 1, the serving
shapes, B=4 S=4096, ragged and 4-byte-copy D and the variant's own stage
and ring edges), then times them in turns (each twice, in forward and
reverse order, printed as the faster and the slower turn). Variants:

- sampler ``u4``: the kernel as it is (512 threads, 4 vectors of each row
  in flight a thread); ``u8``: 8 in flight; ``u4-256``: 256 threads.
  Each at the wrapper's plan (up to 16 CTAs a row, ``c16``) and at 8
  CTAs a row (``c8``); beside them ``torch.argmax(l + n * T)``;
- scan ``t<tile>-s<steps>-r<stages>``: channels a CTA, steps a stage and
  stages in the ring; ``t16-s32-r3`` is the kernel as it is.

``--parent DIR`` also builds and times ``sample_tokens.cu`` and
``rglru_scan.cu`` from ``DIR/src/repro_torch/kernels/csrc`` (a checkout
from before the sampler took a launch plan: its C entry takes none),
checked like the variants (that sampler fails the NaN rows).
``--ablate`` adds timing-only copies, whose outputs are wrong and are
not checked: the scan without its copies (``-noload``),
its per-step stores (``-nostore``) or its serial chain (``-nochain``);
the sampler without its loads (``-noload``) or its cluster merge
(``-nomerge``): what each part costs is the time it takes away.

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

OUT = os.path.join(ROOT, "build", "scan_sample_variants")


def _no_merge(text):
    """The cluster merge out: each CTA writes its own key's index (a race
    between the CTAs of a row; timing only)."""
    a = text.index("  // the CTA's key -> slot")
    b = text.index("  for (uint32_t r = 0; r < ns; ++r)")
    b = text.index("\n", b) + 1
    return [(text[a:b], "")]


#: kernel → variant → (old, new) text substitutions, or a function of the
#: source giving them
VARIANTS = {
    "sample_tokens": {
        "u4": [],
        "u8": [("constexpr int U = 4;", "constexpr int U = 8;")],
        "u4-256": [("constexpr int NT = 512;", "constexpr int NT = 256;")],
    },
    "rglru_scan": {},
}
#: the scan's (tile, steps, stages) variants; the first is the kernel
SCAN_SHAPES = ((16, 32, 3), (32, 32, 3), (16, 32, 4), (16, 32, 6),
               (32, 32, 6), (16, 64, 3), (32, 64, 3))
for _t, _s, _r in SCAN_SHAPES:
    VARIANTS["rglru_scan"][f"t{_t}-s{_s}-r{_r}"] = [
        ("constexpr int TILE = 16;", f"constexpr int TILE = {_t};"),
        ("constexpr int STEPS = 32;", f"constexpr int STEPS = {_s};"),
        ("constexpr int STAGES = 3;", f"constexpr int STAGES = {_r};")]
#: timing-only ablations (their outputs are wrong and not checked). The
#: scan: no copies (the chain runs on whatever the ring
#: holds), no per-step stores (h stored once at the end), no chain (h =
#: a + b, no dependence between steps). The sampler: no loads (no
#: column is read), no cluster merge.
STORE = "          o[(size_t)(t0 + i) * D] = h;\n"
SCAN_ABLATE = {
    "noload": [("      cp_async<VEC>(stage + row * TILE + col, a + off);\n"
                "      cp_async<VEC>(stage + STEPS * TILE + row * TILE + col,"
                " b + off);\n", "")],
    "nostore": [(STORE, "", 2),
                ("    __syncwarp();                          // stage k read",
                 "    if (live && k == nch - 1) o[0] = h;\n"
                 "    __syncwarp();                          // stage k read")],
    "nochain": [("h = __fadd_rn(__fmul_rn(av[i], h), bv[i]);",
                 "h = av[i] + bv[i];"),
                ("h = __fadd_rn(__fmul_rn(sa[i * TILE], h), sb[i * TILE]);",
                 "h = sa[i * TILE] + sb[i * TILE];")],
}
SAMPLE_ABLATE = {
    "noload": [("c < v0; c += NT)", "c < c0; c += NT)"),
               ("j0 < n4; j0 += U * NT)", "j0 < 0; j0 += U * NT)"),
               ("c < c1; c += NT)", "c < v1; c += NT)")],
    "nomerge": _no_merge,
}
#: CTAs a row of the sampler: the wrapper's plan (up to 16), and 8
CLUSTER_CAPS = (16, 8)
#: (B, V) timed: the three served vocabularies at 4 slots
SAMPLE_SHAPES = ((4, 152064), (4, 256000), (4, 65536))
#: (B, S, D) timed: prefill, one chunked-prefill call, the long batch
SCAN_TIMED = ((1, 130, 2560), (1, 32, 2560), (4, 4096, 2560))


def _substitute(name, text, subs):
    """Apply (old, new) or (old, new, times) substitutions, or those a
    function of the text gives; ``old`` must occur exactly once (or
    ``times`` times)."""
    if callable(subs):
        subs = subs(text)
    for old, new, *times in subs:
        if text.count(old) != (times[0] if times else 1):
            raise RuntimeError(f"{name}: {old[:60]!r} not found "
                               f"{times[0] if times else 1} time(s)")
        text = text.replace(old, new)
    return text


def build(common, parent=None, ablate=False):
    """→ {(kernel, variant): CDLL}; a variant that fails to build is
    reported and left out. ``parent``: a checkout whose two sources are
    built as variant ``parent``; ``ablate`` adds :data:`SCAN_ABLATE`."""
    jobs = {}
    variants = {kernel: dict(v) for kernel, v in VARIANTS.items()}
    if ablate:
        for name, subs in SCAN_ABLATE.items():
            variants["rglru_scan"][f"t16-s32-r3-{name}"] = subs
        for name, subs in SAMPLE_ABLATE.items():
            variants["sample_tokens"][f"u4-{name}"] = subs
    for kernel, named in variants.items():
        text = (common.CSRC / f"{kernel}.cu").read_text()
        for name, subs in named.items():
            os.makedirs(os.path.join(OUT, name), exist_ok=True)
            src = os.path.join(OUT, name, f"{kernel}.cu")
            with open(src, "w") as f:
                f.write(_substitute(name, text, subs))
            jobs[(kernel, name)] = (src, str(common.CSRC))
    if parent:
        csrc = os.path.join(parent, "src", "repro_torch", "kernels", "csrc")
        for kernel in VARIANTS:
            jobs[(kernel, "parent")] = (os.path.join(csrc, f"{kernel}.cu"),
                                        csrc)
    procs = {}
    for (kernel, name), (src, inc) in jobs.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        procs[(kernel, name)] = subprocess.Popen(
            [common._nvcc(), *common.NVCC_FLAGS, f"-I{inc}", "-Xptxas", "-v",
             "-o", os.path.join(d, f"{kernel}.so"), src],
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


def _timing_only(name):
    """An ablation: its output is wrong and is not checked."""
    return name.rsplit("-", 1)[-1] in {**SCAN_ABLATE, **SAMPLE_ABLATE}


def _entry(lib, fn, argtypes):
    f = getattr(lib, fn)
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
    f.argtypes = [kinds[a] for a in argtypes]
    f.restype = ctypes.c_int
    return f


def _stream():
    import torch
    return torch.cuda.current_stream().cuda_stream


def sample_call(lib, name, logits, temps, noise, plan):
    """The sampler of ``lib`` on these rows at ``plan`` (ctas, share);
    the parent's entry takes no plan."""
    import torch
    B, V = logits.shape
    out = torch.empty((B,), dtype=torch.int32, device=logits.device)
    parent = name == "parent"
    fn = _entry(lib, "sample_tokens", "ppppiip" if parent else "ppppiiiip")
    args = (logits.data_ptr(), noise.data_ptr(), temps.data_ptr(),
            out.data_ptr(), B, V)

    def run():
        code = fn(*args, *(() if parent else plan), _stream())
        if code:
            raise RuntimeError(f"sample_tokens/{name}: CUDA error {code}")
        return out
    return run


def scan_call(lib, name, a, b, h0):
    """The scan of ``lib`` (every build has the same C entry)."""
    import torch
    B, S, D = a.shape
    out = torch.empty_like(a)
    fn = _entry(lib, "rglru_scan", "ppppiiip")

    def run():
        code = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(),
                  B, S, D, _stream())
        if code:
            raise RuntimeError(f"rglru_scan/{name}: CUDA error {code}")
        return out
    return run


def _scan_shape(name):
    t, s, r = (int(x[1:]) for x in name.split("-")[:3])
    return t, s, r


def _sample_plan(B, V, sm, cap):
    """The wrapper's plan, or ``cap`` CTAs a row below 16."""
    from repro_torch.kernels.decode_attention.ops import (
        sample_plan, split_share)
    return sample_plan(B, V, sm) if cap == 16 else split_share(V, cap, 4)


def sample_runs(libs, sm):
    """{label: fn(logits, temps, noise) → the run}: every sampler build
    at every plan it takes."""
    runs = {}
    for (kernel, name), lib in libs.items():
        if kernel != "sample_tokens":
            continue
        for cap in ((None,) if name == "parent" else CLUSTER_CAPS):
            def make(lg, tp, nz, lib=lib, name=name, cap=cap):
                plan = None if cap is None else _sample_plan(
                    *lg.shape, sm, cap)
                return sample_call(lib, name, lg, tp, nz, plan)
            runs[name if cap is None else f"{name} c{cap}"] = make
    return runs


def check(libs, device, sm):
    """Every variant against the plain versions; → number of failures."""
    import torch
    from repro_torch.kernels.decode_attention.ref import sample_tokens_ref
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    bad = 0
    batches = [("random", cs.sampler_inputs(B, V, device, seed=B + V))
               for B, V in ((4, 152064), (4, 256000), (4, 65536),
                            (64, 152064), (4, 1000), (4, 152061))]
    for label, make in sample_runs(libs, sm).items():
        if _timing_only(label.split()[0]):
            continue
        cap = int(label.split(" c")[1]) if " c" in label else 16
        rows_of = []
        for V in (152064, 152061):
            share = _sample_plan(cs.EDGE_ROWS, V, sm, cap)[1]
            rows = cs.sampler_edge_rows(V, share, device)
            rows_of.append(("edge rows", (
                torch.stack([r[1] for r in rows]),
                torch.tensor([r[2] for r in rows], device=device),
                torch.stack([r[3] for r in rows]))))
        fails = []
        for what, (lg, tp, nz) in batches + rows_of:
            got = make(lg, tp, nz)()
            if not torch.equal(got, sample_tokens_ref(lg, tp, nz)):
                fails.append(f"{what} B={lg.shape[0]} V={lg.shape[1]}")
        bad += len(fails) if label != "parent" else 0
        cs.log(f"[check] sample_tokens/{label}: "
               + (f"FAIL {fails}" if fails else "exact ok on every batch"))
    for (kernel, name), lib in libs.items():
        if kernel != "rglru_scan" or _timing_only(name):
            continue
        _, s, r = (16, 32, 3) if name == "parent" else _scan_shape(name)
        shapes = [(1, 1, 2560), (1, 130, 2560), (4, 4096, 2560),
                  (2, 100, 300), (3, 45, 7)]
        shapes += [(2, S, 300) for S in (s - 1, s, s + 1, s * r - 1, s * r,
                                         s * r + 1)]
        fails = []
        for B, S, D in shapes:
            ins = cs.rglru_inputs(B, S, D, device, seed=S + D)
            if not torch.equal(scan_call(lib, name, *ins)(),
                               rglru_scan_ref(*ins)):
                fails.append((B, S, D))
        bad += len(fails) if name != "parent" else 0
        cs.log(f"[check] rglru_scan/{name}: "
               + (f"FAIL {fails}" if fails else "bit-equal at every shape"))
    return bad


def in_turns(runs, reps, warmup):
    """{key: [ms forward, ms reverse]}: device ms of each call, timed in
    turns, forward then reverse."""
    times = {key: [] for key in runs}
    for key in list(runs) + list(reversed(list(runs))):
        times[key].append(cs.device_ms(runs[key], reps=reps, warmup=warmup))
    return times


def main():
    import torch
    if not torch.cuda.is_available():
        print("scan_sample_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import common
    device = torch.device("cuda")
    sm = torch.cuda.get_device_properties(device).multi_processor_count
    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip())
    args = sys.argv[1:]
    parent = args[args.index("--parent") + 1] if "--parent" in args else None
    t0 = time.perf_counter()
    libs = build(common, parent, ablate="--ablate" in args)
    cs.log(f"[build] {len(libs)} libraries in "
           f"{time.perf_counter() - t0:.1f}s")
    bad = check(libs, device, sm)

    makers = sample_runs(libs, sm)
    for B, V in SAMPLE_SHAPES:
        lg, tp, nz = cs.sampler_inputs(B, V, device, seed=5)
        runs = {label: make(lg, tp, nz) for label, make in makers.items()}
        runs["torch.argmax"] = lambda: torch.argmax(lg + nz * tp[:, None],
                                                    dim=-1)
        times = in_turns(runs, 100, 10)
        bnd = (2 * B * V + 2 * B) * 4 / cs.HBM_BYTES_PER_S * 1e3
        cs.log(f"[variants] sample_tokens B={B} V={V} (device ms, two "
               f"turns; bound {bnd:.5f}): " + "; ".join(
                   f"{key} {min(t):.4f}/{max(t):.4f}"
                   for key, t in times.items()))
    for B, S, D in SCAN_TIMED:
        ins = cs.rglru_inputs(B, S, D, device, seed=1)
        runs = {name: scan_call(lib, name, *ins)
                for (kernel, name), lib in libs.items()
                if kernel == "rglru_scan"}
        big = S > 1000
        times = in_turns(runs, 20 if big else 100, 2 if big else 10)
        bnd = (3 * B * S * D + B * D) * 4 / cs.HBM_BYTES_PER_S * 1e3
        cs.log(f"[variants] rglru_scan B={B} S={S} D={D} (device ms, two "
               f"turns; bound {bnd:.5f}): " + "; ".join(
                   f"{key} {min(t):.4f}/{max(t):.4f}"
                   for key, t in times.items()))
        del ins
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
