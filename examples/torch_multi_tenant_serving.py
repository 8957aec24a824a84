"""Multi-tenant serving on the PyTorch port — the paper's Figure-2 cloud
scenario on one device.

A 2×4 view of one device is floorplanned into two (1, 4) slices: each
tenant's pool holds 4/8 of the device's memory (on a card, 4/8 of its
free memory; on the CPU, four times ``hbm_per_chip``). Two tenants
serve different architectures through their own ``GuestDevice``:
alice runs qwen1.5-0.5b's decode program and bob internlm2-1.8b's
(``seq_len=64, global_batch=4``, weights from a seeded generator), the
data plane mediated by weighted fair queueing (alice weight 3, bob 1)
or, with ``--policy slo``, by deadlines (alice PRIORITY_HIGH with a
50 ms wait budget), the decode loops driven through ``run_async``
futures. Each tenant's logits are held to the same program run natively
on the same weights (fidelity). Includes the paper's cross-slice
reprogram attack (denied and audited), a warm-reconfiguration hit, the
per-tenant scheduler stats and the criteria report.

Runs on the card unless ``--device cpu`` is given; reduced configs
unless ``--full``:

    PYTHONPATH=src python examples/torch_multi_tenant_serving.py \\
        [--device cpu] [--policy slo] [--full] [--metrics]
"""
import argparse
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.core import (PRIORITY_HIGH, VMM, LegalityError,
                              ProgramRequest, report)
from repro_torch.models import Model, resolve_device
from repro_torch.obs import ObsHub
from repro_torch.parallel import build_decode

TENANTS = (("alice", "qwen1.5-0.5b", 1), ("bob", "internlm2-1.8b", 2))
SEQ_LEN, BATCH, TOKENS = 64, 4, 6
CPU_HBM = 1 << 30                   # one grid entry's memory on the CPU


def program_params(abstract, params):
    """``params`` in the shapes and dtypes of a program's abstract
    parameters (a leaf already of that dtype is taken as it is)."""
    if isinstance(abstract, dict):
        return {k: program_params(abstract[k], params[k]) for k in abstract}
    if isinstance(abstract, list):
        return [program_params(a, p) for a, p in zip(abstract, params)]
    if tuple(params.shape) != tuple(abstract.shape):
        raise ValueError(f"weights {tuple(params.shape)} vs program "
                         f"{tuple(abstract.shape)}")
    return params.to(abstract.dtype)


def decode(params, caches, vocab, device, run, run_async=None):
    """TOKENS greedy decode steps from a token of ones at position 0:
    the first through ``run``, the rest through ``run_async`` futures
    (through ``run`` without it). Returns each step's logits."""
    token = torch.ones((BATCH, 1), dtype=torch.int32, device=device)
    pos = torch.tensor(0, dtype=torch.int32, device=device)
    logits, caches = run(params, caches, token, pos)
    out = [logits]
    for p in range(1, TOKENS):
        nxt = logits[:, :vocab].argmax(-1).to(torch.int32)[:, None]
        pos = torch.tensor(p, dtype=torch.int32, device=device)
        if run_async is None:
            logits, caches = run(params, caches, nxt, pos)
        else:
            logits, caches = run_async(params, caches, nxt, pos).result(
                timeout=600)
        out.append(logits)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--policy", default="wfq", choices=["wfq", "slo"])
    ap.add_argument("--full", action="store_true",
                    help="the published configs (default: reduced)")
    ap.add_argument("--metrics", action="store_true",
                    help="enable the telemetry plane and print the "
                         "Prometheus exposition at exit")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    grid = np.empty((2, 4), dtype=object)
    grid[:] = device
    ckpt = tempfile.mkdtemp(prefix="mt_ckpt_")
    vmm = VMM(grid, policy=args.policy, ckpt_root=ckpt,
              hbm_per_chip=None if device.type == "cuda" else CPU_HBM,
              obs=ObsHub(enabled=args.metrics))
    result = {"policy": args.policy, "tenants": {}}
    try:
        whole = vmm.card_bytes(device)
        if args.policy == "slo":
            # deadline classes instead of weights: alice is
            # latency-sensitive, bob sends batch traffic
            alice = vmm.create_vm("alice", (1, 4),
                                  sched_priority=PRIORITY_HIGH,
                                  sched_slo_wait_s=0.05)
            bob = vmm.create_vm("bob", (1, 4))
        else:
            alice = vmm.create_vm("alice", (1, 4), sched_weight=3.0)
            bob = vmm.create_vm("bob", (1, 4), sched_weight=1.0)
        print("floorplan:", vmm.floorplanner.snapshot())

        for tenant, (_, arch, seed) in zip((alice, bob), TENANTS):
            cfg = get_config(arch, reduced=not args.full)
            tenant.device.open()
            req = ProgramRequest(arch=arch, kind="decode", seq_len=SEQ_LEN,
                                 global_batch=BATCH, reduced=not args.full)
            prog = tenant.device.reprogram(req)
            model = Model(cfg, device)
            params = program_params(
                prog.bitfile.abstract_args[0],
                model.init_compute_params(
                    torch.Generator(device=device).manual_seed(seed)))
            got = decode(params, model.init_cache(BATCH, SEQ_LEN), cfg.vocab,
                         device, tenant.device.run, tenant.device.run_async)
            # fidelity: the same step program, natively, on the same
            # weights and a fresh cache
            step, _ = build_decode(cfg, device, ShapeCell(
                "native", SEQ_LEN, BATCH, "decode"))
            want = decode(params, model.init_cache(BATCH, SEQ_LEN),
                          cfg.vocab, device, step)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            pool = tenant.pool.n_segments * tenant.pool.segment_bytes
            share = pool / whole
            finite = bool(torch.isfinite(got[-1].float()).all())
            print(f"[{tenant.name}] served {TOKENS} tokens of {arch} on "
                  f"slice {tenant.vslice.spec.shape} at "
                  f"{tenant.vslice.spec.origin} ({tenant.vslice.n_devices} "
                  f"grid entries, {len(tenant.vslice.cards)} card(s), pool "
                  f"{pool} bytes = {share:.4f} of the device's memory); "
                  f"logits {tuple(got[-1].shape)}, "
                  f"{'equal to' if same else 'DIFFERENT from'} the native "
                  f"run bit for bit")
            result["tenants"][tenant.name] = {
                "arch": arch, "logits": [x.cpu() for x in got],
                "native_equal": same, "finite": finite, "pool_bytes": pool,
                "share": share, "ops": TOKENS}
            del params, got, want

        # --- the paper's isolation attack: alice flashes bob's slice ----
        try:
            bob.device.reprogram(alice.program.bitfile)  # alice's binding
            result["attack_denied"] = False
        except LegalityError as e:
            result["attack_denied"] = True
            print(f"[isolation] cross-slice reprogram denied: {e}")
        result["violations"] = vmm.auditor.summary()

        # --- warm reconfiguration (same topology class) -----------------
        alice.device.reprogram(ProgramRequest(
            arch=TENANTS[0][1], kind="decode", seq_len=SEQ_LEN,
            global_batch=BATCH, reduced=not args.full))
        result["hits"], result["misses"] = (vmm.compiler.hits,
                                            vmm.compiler.misses)
        print(f"compile cache: hits={vmm.compiler.hits} "
              f"misses={vmm.compiler.misses}")
        sched = vmm.stats()["scheduler"]
        result["sched"] = sched["tenants"]
        for name, s in sched["tenants"].items():
            line = (f"[sched:{sched['policy']}] {name}: weight={s['weight']} "
                    f"completed={s['completed']} "
                    f"avg_wait={s['avg_wait_ms']:.2f}ms "
                    f"avg_service={s['avg_service_ms']:.2f}ms")
            if "slo_attainment" in s:
                line += (f" slo_budget={s['slo_wait_ms']:.0f}ms "
                         f"attainment={s['slo_attainment']:.0%} "
                         f"p95_wait={s['p95_wait_ms']:.2f}ms")
            print(line)
        result["report"] = report(vmm).to_markdown()
        print(result["report"])
        if args.metrics:
            print("[obs] prometheus exposition:")
            print(vmm.obs.prometheus())
    finally:
        vmm.shutdown()
        shutil.rmtree(ckpt, ignore_errors=True)
    return result


if __name__ == "__main__":
    main()
