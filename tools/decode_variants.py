#!/usr/bin/env python3
"""A/B variants of the split decode-attention kernels on one NVIDIA GPU.

    python3 tools/decode_variants.py

Builds text-substituted copies of ``csrc/decode_core.cuh`` with the two
decode sources (``decode_attention.cu``, ``fused_paged_decode.cu``) into
``build/decode_variants/<variant>/``, one nvcc each, all started
together; checks every variant and split count against the plain
versions (two bf16 ulps); then times them in turns (each twice, in
forward and reverse order, so a drift of the card shows as a spread)
beside the one-call yardsticks, at the shapes ``chip_smoke.py`` times.
Also prints how many thread block clusters of each size the card holds
at once (``cudaOccupancyMaxActiveClusters``). Variants:

- ``base``: the sources as they are (128 threads a CTA for one query head
  a kv head, 256 for a group; 3 stages of 8 KB K + 8 KB V tiles);
- ``nt128`` / ``nt256``: 128 or 256 threads for every instance;
- ``s4``: 4 stages of tiles in flight instead of 3.

Timings are only compared inside one run: two runs may land on cards
with other power limits.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

OUT = os.path.join(ROOT, "build", "decode_variants")
VARIANTS = {
    "base": [],
    "nt128": [("return gpc == 1 ? 128 : 256;", "return 128;")],
    "nt256": [("return gpc == 1 ? 128 : 256;", "return 256;")],
    "s4": [("constexpr int NSTAGE = 3;", "constexpr int NSTAGE = 4;")],
}
SOURCES = ("decode_attention", "fused_paged_decode")
#: appended to decode_attention.cu: how many clusters of `splits` CTAs of
#: the bf16 hd-64 ring kernel fit on the card at once
OCCUPANCY = """
extern "C" int max_active_clusters(int splits, int smem) {
  auto k = ring_decode_kernel<__nv_bfloat16, 64, 1>;
  if (splits > 8)
    cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed,
                         1);
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, 16, 4);
  cfg.blockDim = dim3(dc::block_threads(1));
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&n, k, &cfg);
  return e != cudaSuccess ? -(int)e : n;
}
"""


def build(common):
    """→ {(variant, source): CDLL}; a variant that fails to build is
    reported and left out."""
    core = (common.CSRC / "decode_core.cuh").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        shutil.copy(common.CSRC / "common.cuh", d)
        text = core
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not found")
            text = text.replace(old, new)
        with open(os.path.join(d, "decode_core.cuh"), "w") as f:
            f.write(text)
        for src in SOURCES:
            body = (common.CSRC / f"{src}.cu").read_text()
            if src == "decode_attention":
                body += OCCUPANCY
            path = os.path.join(d, f"{src}.cu")
            with open(path, "w") as f:
                f.write(body)
            procs[(name, src)] = subprocess.Popen(
                [common._nvcc(), *common.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 path[:-3] + ".so", path], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (name, src), p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            cs.log(f"[{name}/{src}] build failed:\n{log[-3000:]}")
            continue
        rows = common.ptxas_usage(log)
        cs.log(f"[{name}/{src}] {min(r[1] for r in rows)}-"
               f"{max(r[1] for r in rows)} registers, "
               f"{sum(1 for r in rows if r[2])} kernels spilling")
        libs[(name, src)] = ctypes.CDLL(os.path.join(OUT, name,
                                                     f"{src}.so"))
    return libs


def _entry(lib, fn, argtypes):
    f = getattr(lib, fn)
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    f.argtypes = [kinds[a] for a in argtypes]
    f.restype = ctypes.c_int
    return f


def ring_call(lib, q, k, v, pos, splits, share):
    """The ring kernel of ``lib`` at a given split, bf16, no window."""
    import torch
    B, _, Hq, hd = q.shape
    C, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = _entry(lib, "decode_attention", "pppppiiiiiiiiiifp")

    def run():
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  None, pos, 1, B, C, Hq, Hkv, hd, 0, splits, share,
                  hd ** -0.5, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"decode_attention: CUDA error {code}")
        return out
    return run


def fused_call(lib, d, splits, share, window):
    """The fused paged kernel of ``lib`` at a given split, bf16."""
    import torch
    B, _, Hq, hd = d["q"].shape
    ps, Hkv = d["k_pages"].shape[1], d["k_pages"].shape[2]
    nb = d["block_tables"].shape[1]
    out = torch.empty_like(d["q"])
    fn = _entry(lib, "fused_paged_decode_attention", "ppppppppiiiiiiiiiifp")

    def run():
        code = fn(d["q"].data_ptr(), d["k_new"].data_ptr(),
                  d["v_new"].data_ptr(), d["k_pages"].data_ptr(),
                  d["v_pages"].data_ptr(), d["lengths"].data_ptr(),
                  d["block_tables"].data_ptr(), out.data_ptr(), 1, B, Hq,
                  Hkv, hd, ps, nb, window, splits, share, hd ** -0.5,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"fused_paged_decode: CUDA error {code}")
        return out
    return run


def cases(libs, device):
    """(name, plain output, {variant and split: call}, yardstick)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import split_share
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, fused_paged_decode_ref, ring_valid)
    bf16 = torch.bfloat16
    out = []
    # the ring at the VMM decode program's shape, and a contiguous layout
    # of the same bytes (one kv head, 64 slots)
    for B, H in ((4, 16), (64, 1)):
        q, k, v = cs.ring_inputs(B, 4096, H, H, bf16, device, seed=8)
        mask = ring_valid(4096, 5000, 0, device)[None, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        runs = {f"{name} S={s}": ring_call(lib, q, k, v, 5000, s, 4096 // s)
                for (name, src), lib in libs.items()
                if src == "decode_attention" for s in (2, 4, 8, 16)}
        out.append((f"ring B={B} Hq=Hkv={H} hd=64 C=4096 full",
                    decode_attention_ref(q, k, v, 5000), runs,
                    lambda qt=qt, kt=kt, vt=vt, mask=mask:
                    F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=mask)))
    for name, lens, nb, Hq, Hkv, hd, w in (
            ("fused hd64 16/16 mid-run", [64, 161, 96, 143], 16, 16, 16,
             64, 0),
            ("fused hd256 10/1 w2048 mid-run", [64, 161, 96, 143], 16, 10,
             1, 256, 2048),
            ("fused hd64 16/16 long", [640, 2560, 1601, 2143], 160, 16, 16,
             64, 0),
            ("fused hd256 10/1 w2048 long", [640, 2560, 1601, 2143], 160,
             10, 1, 256, 2048)):
        d = cs.decode_inputs(lens, Hq, Hkv, bf16, device, seed=6, nb=nb,
                             hd=hd)
        runs = {}
        for (vname, src), lib in libs.items():
            if src != "fused_paged_decode":
                continue
            for s in (2, 4, 8, 16):
                used, share = split_share(nb * 16, s, 16)
                runs[f"{vname} S={used}"] = fused_call(lib, d, used, share,
                                                       w)
        out.append((name, fused_paged_decode_ref(**d, window=w), runs,
                    None))
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("decode_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import common
    from repro_torch.launch.apps import max_excess
    device = torch.device("cuda")
    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip())
    t0 = time.perf_counter()
    libs = build(common)
    cs.log(f"[build] {len(libs)} libraries in "
           f"{time.perf_counter() - t0:.1f}s")
    occ = libs[("base", "decode_attention")].max_active_clusters
    occ.restype = ctypes.c_int
    for splits in (2, 4, 8, 16):
        cs.log(f"[occupancy] ring bf16 hd 64, 128 threads, 48 KB: "
               f"{occ(splits, 49152)} clusters of {splits} CTAs at once")
    bad = 0
    for name, want, runs, lib_fn in cases(libs, device):
        for key, fn in runs.items():
            got = fn()
            err, excess = max_excess(got, want, cs.BF16_ULP_ATOL,
                                     cs.BF16_ULP_RTOL)
            if excess > 0 or not bool(torch.isfinite(got).all()):
                cs.log(f"[check] {name} {key}: FAIL (max abs err {err})")
                bad += 1
        times = {key: [] for key in runs}
        for key in list(runs) + list(reversed(list(runs))):
            times[key].append(cs.device_ms(runs[key], reps=100, warmup=10))
        lib_ms = cs.device_ms(lib_fn, reps=100, warmup=10) if lib_fn else None
        cs.log(f"[variants] {name} (device ms, two turns): " + "; ".join(
            f"{key} {min(t):.4f}/{max(t):.4f}" for key, t in times.items())
            + (f"; yardstick {lib_ms:.4f}" if lib_ms else ""))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
