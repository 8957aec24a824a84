"""The paper's three apps (Fig. 6a) on the PyTorch port: matrix
multiplication, Sobel filter and vector addition, native and virtualized.

    PYTHONPATH=src python -m repro_torch.launch.apps [--size fig6a|card]
    ... --device cpu        # plain PyTorch versions of the kernels

*Native* calls each app's op directly on data resident on the device.
*Virtualized* admits **three tenants on one VMM**, each bound at
admission (``model=``) to its app and holding its own (1,1) vSlice of a
1×3 view of the one device — the paper's PRRs sharing one FPGA. Per
workload it times the full guest cycle (``write`` the inputs → ``run``
the app into an output buffer → ``read`` it back), the run-only steady
state on resident data, and a mixed arm that round-robins the three
bound tenants. It prints the VMM's per-op latencies and transfer
counters (fig6b's inputs) and the criteria report, and checks every
output against the app's plain version (run on the CPU).

Sizes: ``fig6a`` is the reference benchmark's (256² matmul and Sobel,
2¹⁸ vecadd, fp32); ``card`` is matmul 4096³ in fp32 and in bf16, Sobel
4096² and vecadd 2²⁶, fp32. Inputs are drawn from a fixed seed. bf16
inputs cross the guest boundary as their int16 bit patterns (numpy has
no bf16). The VMM runs the paper's ``hybrid`` policy.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import numpy as np
import torch

SIZES = {
    "fig6a": {"matmul": [(256, 256, 256, "float32")],
              "sobel": [(256, 256)], "vecadd": [1 << 18]},
    "card": {"matmul": [(4096, 4096, 4096, "float32"),
                        (4096, 4096, 4096, "bfloat16")],
             "sobel": [(4096, 4096)], "vecadd": [1 << 26]},
}


@dataclass
class Workload:
    """One app call: host inputs (guest data), its op and plain version,
    the compute dtype and the tolerance (atol, rtol) against the plain
    version."""
    app: str
    label: str
    host: List[np.ndarray]
    dtype: torch.dtype
    op: Callable
    ref: Callable
    tol: tuple
    results: Dict[str, float] = field(default_factory=dict)
    program: Callable = None            # the tenant's program for it
    handles: tuple = ()                 # (input, output) guest buffers

    @property
    def nbytes_in(self) -> int:
        return sum(a.nbytes for a in self.host)


def make_workloads(size: str) -> List[Workload]:
    """The workloads of ``size``, inputs drawn from a fixed seed."""
    from repro_torch.kernels.matmul.ops import matmul_op
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.sobel.ops import sobel_op
    from repro_torch.kernels.sobel.ref import sobel_ref
    from repro_torch.kernels.vecadd.ops import vecadd_op
    from repro_torch.kernels.vecadd.ref import vecadd_ref
    rng = np.random.default_rng(0)
    sz = SIZES[size]
    out = []
    for m, k, n, dn in sz["matmul"]:
        a = rng.standard_normal((m, k), np.float32)
        b = rng.standard_normal((k, n), np.float32)
        tol = 1e-5 if dn == "float32" else 2e-1
        out.append(Workload("matmul", f"matmul {m}x{k}x{n} {dn}",
                            [_guest(a, dn), _guest(b, dn)],
                            getattr(torch, dn), matmul_op, matmul_ref,
                            (tol * k ** 0.5, tol)))
    for h, w in sz["sobel"]:
        img = rng.standard_normal((h, w), np.float32)
        out.append(Workload("sobel", f"sobel {h}x{w} float32", [img],
                            torch.float32, sobel_op, sobel_ref,
                            (1e-4, 1e-4)))
    for n in sz["vecadd"]:
        x = rng.standard_normal(n, np.float32)
        y = rng.standard_normal(n, np.float32)
        out.append(Workload("vecadd", f"vecadd {n} float32", [x, y],
                            torch.float32, vecadd_op, vecadd_ref, (0.0, 0.0)))
    return out


def _guest(a: np.ndarray, dtype_name: str) -> np.ndarray:
    """Host form of an input: fp32 as is; bf16 as its int16 bits."""
    if dtype_name == "float32":
        return a
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t.view(torch.int16).numpy()


def _to_compute(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.view(dtype) if dtype == torch.bfloat16 else t


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timeit(fn, device, warmup=2, iters=5) -> float:
    """Mean µs of one call on the host clock, each call synchronised."""
    for _ in range(warmup):
        fn()
        _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        _sync(device)
    return (time.perf_counter() - t0) / iters * 1e6


def max_excess(got, want, atol, rtol) -> tuple:
    """(max |got - want|, max(|got - want| - rtol·|want|) - atol)."""
    d = (got.float() - want.float()).abs()
    return (float(d.max()),
            float((d - rtol * want.float().abs()).max()) - atol)


def _unpack(buf: torch.Tensor, w: Workload):
    """Device views of a workload's inputs inside one guest buffer."""
    out, off = [], 0
    for a in w.host:
        out.append(_to_compute(buf[off:off + a.size].view(a.shape), w.dtype))
        off += a.size
    return out


def _launches_since(before) -> dict:
    """Kernel launches counted since the snapshot ``before``."""
    from repro_torch.kernels import common
    return {k: n - before.get(k, 0) for k, n in common.LAUNCHES.items()
            if n > before.get(k, 0)}


def run(device, size="fig6a", warmup=2, iters=5, log=print) -> dict:
    """Native and virtualized runs of every workload of ``size`` on
    ``device``. → {"workloads": [...], "mixed_us", "solo_sum_us",
    "stats": vmm.stats(), "criteria": CriteriaReport, "launches":
    {"native": {kernel: n}, "virtualized": {kernel: n}}}, the kernel
    launches of each arm. Raises when an output disagrees with its plain
    version."""
    from repro_torch.core import VMM, report
    from repro_torch.kernels import common
    device = torch.device(device)
    works = make_workloads(size)
    launches = {}
    before = dict(common.LAUNCHES)

    # ---- native: direct op calls on resident data --------------------
    wants = []                        # the plain versions' outputs
    for w in works:
        host = [_to_compute(torch.from_numpy(a), w.dtype) for a in w.host]
        args = [a.to(device) for a in host]
        got = w.op(*args).cpu()
        want = w.ref(*host)           # the plain version, on the CPU
        err, excess = max_excess(got, want, *w.tol)
        if excess > 0 or not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"native {w.label}: error {err} outside "
                                 f"tolerance {w.tol}")
        w.results["native_err"] = err
        w.results["native_us"] = _timeit(lambda w=w, a=args: w.op(*a),
                                         device, warmup, iters)
        wants.append(want)

    launches["native"] = _launches_since(before)

    # ---- virtualized: three bound tenants on one VMM ------------------
    before = dict(common.LAUNCHES)
    grid = np.empty((1, 3), dtype=object)
    grid[0, :] = [device] * 3
    hbm = None if device.type == "cuda" else 1 << 30
    vmm = VMM(grid, policy="hybrid", hbm_per_chip=hbm, segment_bytes=1 << 20)
    try:
        tenants = {}
        for app in ("matmul", "sobel", "vecadd"):
            t = vmm.create_vm(app, (1, 1), model=app)
            t.device.open()
            t.device.get_info()
            tenants[app] = t
        bindings = {n: s["model"] for n, s in
                    vmm.stats()["scheduler"]["tenants"].items()}
        if bindings != {a: a for a in tenants}:
            raise AssertionError(f"tenant bindings {bindings}")

        for w, want in zip(works, wants):
            t = tenants[w.app]
            dev = t.device
            h_in = dev.alloc(w.nbytes_in, (len(w.host),),
                             str(w.host[0].dtype))
            out_shape = tuple(want.shape)
            out_bytes = int(np.prod(out_shape)) * w.host[0].itemsize
            h_out = dev.alloc(out_bytes, out_shape, str(w.host[0].dtype))
            packed = np.concatenate([a.reshape(-1) for a in w.host])

            def program(hi, ho, t=t, w=w):
                out = w.op(*_unpack(t.buffers[hi].device_array, w))
                # the output buffer holds the guest's element type
                t.buffers[ho].device_array = (
                    out.view(torch.int16) if w.dtype == torch.bfloat16
                    else out)
                return ho

            def cycle(dev=dev, t=t, hi=h_in, ho=h_out, packed=packed,
                      program=program):
                # the paper's app loop: write → run → read
                t.program = program
                dev.write(hi, packed)
                dev.run(hi, ho)
                return dev.read(ho)

            host_out = cycle()
            got = _to_compute(torch.from_numpy(host_out), w.dtype)
            err, excess = max_excess(got, want, *w.tol)
            if excess > 0:
                raise AssertionError(f"virtualized {w.label}: error {err} "
                                     f"outside tolerance {w.tol}")
            w.results["virt_err"] = err
            w.results["virt_us"] = _timeit(cycle, device, warmup, iters)
            w.results["run_only_us"] = _timeit(
                lambda dev=dev, hi=h_in, ho=h_out, t=t, program=program: (
                    setattr(t, "program", program), dev.run(hi, ho)),
                device, warmup, iters)
            w.program = program
            w.handles = (h_in, h_out)

        # mixed arm: the first workload of each bound tenant, round-robin
        firsts = {}
        for w in works:
            firsts.setdefault(w.app, w)

        def mixed_sweep():
            for app, w in firsts.items():
                t = tenants[app]
                t.program = w.program
                t.device.run(*w.handles)

        mixed_us = _timeit(mixed_sweep, device, warmup, iters)
        solo_sum = sum(w.results["run_only_us"] for w in firsts.values())
        for t in tenants.values():
            t.device.close()
        ratios = [w.results["run_only_us"] / w.results["native_us"]
                  for w in works]
        crit = report(vmm, perf_ratio=float(np.mean(ratios)),
                      same_artifact=True)
        stats = vmm.stats()
    finally:
        vmm.shutdown()
    launches["virtualized"] = _launches_since(before)

    for w in works:
        r = w.results
        log(f"[apps] {w.label}: native {r['native_us']:.1f} us; guest "
            f"cycle {r['virt_us']:.1f} us (x{r['virt_us'] / r['native_us']:.3f}"
            f"); run-only {r['run_only_us']:.1f} us "
            f"(x{r['run_only_us'] / r['native_us']:.3f}); max err native "
            f"{r['native_err']:.3g} virtualized {r['virt_err']:.3g} "
            f"(atol {w.tol[0]:.3g}, rtol {w.tol[1]:g})")
    log(f"[apps] mixed sweep of {len(firsts)} bound tenants: "
        f"{mixed_us:.1f} us (x{mixed_us / max(solo_sum, 1e-9):.3f} of the "
        f"run-only sum {solo_sum:.1f} us)")
    log(f"[apps] vmm ops: {stats['ops']}")
    log(f"[apps] vmm transfer: {stats['transfer']}")
    log("[apps] criteria report:\n" + crit.to_markdown())
    return {"workloads": works, "mixed_us": mixed_us,
            "solo_sum_us": solo_sum, "stats": stats, "criteria": crit,
            "launches": launches}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.apps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--size", default="fig6a", choices=sorted(SIZES))
    args = ap.parse_args(argv)

    from repro_torch.models import resolve_device
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run(device, args.size)


if __name__ == "__main__":
    main()
