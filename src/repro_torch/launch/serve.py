"""Serving entry point of the PyTorch port: continuous batching over the paged
KV cache, on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --full \\
        --requests 8 --max-new 16
    ... --chunk-tokens 32   # chunked prefill + fused decode/sampling
    ... --arch recurrentgemma-2b | rwkv6-7b
                            # the recurrent families; their per-slot
                            # state rows lease pages from the MMU too
    ... --device cpu        # plain PyTorch versions of the kernels
    ... --virtualized --policy {fev,bev,hybrid,wfq,slo} [--slo-ms 50]
                            # every step through a VMM tenant's data plane

Requests are submitted with varying prompt lengths and token budgets;
the engine admits them into batch slots as earlier requests finish —
each newcomer prefills alone into pages leased from the MMU, so slot
recycling and page faults are visible in the completion log. Weights
are random, drawn from ``--seed``. Under ``--virtualized`` the KV pages
lease segments from the tenant's MMU pool (sized from the card's free
memory once the weights are on it, or 1 GiB on the CPU), newcomers defer
under pool pressure, every prefill and
decode step runs through ``tenant.device.run``, and the VMM's stats print
at the end.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="chunked prefill budget per engine step (0 = "
                         "monolithic admission); also switches decode to "
                         "the fused attention+sampling step")
    ap.add_argument("--full", action="store_true",
                    help="full-width config (default: the reduced one)")
    ap.add_argument("--metrics", action="store_true",
                    help="enable the telemetry plane; prints TTFT and the "
                         "Prometheus exposition at exit")
    ap.add_argument("--virtualized", action="store_true",
                    help="route every step through a VMM tenant")
    ap.add_argument("--policy", default="hybrid",
                    choices=["fev", "bev", "hybrid", "wfq", "slo"])
    ap.add_argument("--slo-ms", type=float, default=50.0,
                    help="per-op wait budget for --policy slo")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models import Model, resolve_device
    from repro_torch.obs import ObsHub
    from repro_torch.serving import ServeEngine

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    obs = ObsHub(enabled=args.metrics)
    cfg = get_config(args.arch, reduced=not args.full)
    model = Model(cfg, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.compute_params(model.init(gen))
    vmm = None
    kw = dict(page_size=args.page_size, obs=obs, obs_tenant="server",
              chunk_tokens=args.chunk_tokens, state_paging=True)
    if args.virtualized:
        vmm, tenant = virtual_server(device, args.policy, args.slo_ms, obs)
        kw.update(virtualized_engine_kw(tenant))
    engine = ServeEngine(cfg, model, args.batch, args.capacity, **kw)

    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        plen = args.prompt_len + int(rng.integers(0, 8))
        prompt = rng.integers(0, cfg.vocab, size=(plen,))
        # skew token budgets so slots free at different steps and the
        # engine's mid-decode admission actually kicks in
        budget = max(1, args.max_new - 4 * (i % 3))
        engine.submit(prompt, max_new_tokens=budget,
                      temperature=0.0 if i % 2 == 0 else 0.8)

    t0 = time.perf_counter()
    done = 0
    new_tokens = 0
    while engine.has_work():
        for r in engine.step(params):
            done += 1
            new_tokens += len(r.out_tokens)
            print(f"[serve] req {r.rid}: prompt {len(r.prompt)} tok → "
                  f"{len(r.out_tokens)} new: {r.out_tokens[:8]}…")
    dt = time.perf_counter() - t0
    s = engine.stats
    print(f"[serve] device {device}: {done} requests, {new_tokens} tokens "
          f"in {dt:.2f}s ({new_tokens / max(dt, 1e-9):.1f} tok/s)")
    print(f"[serve] engine: {s.steps} steps, {s.prefills} newcomer "
          f"prefills (full={s.full_prefills}, "
          f"chunks={s.prefill_chunks}), {s.page_faults} page "
          f"faults, {s.pages_leased} pages leased / {s.pages_freed} freed, "
          f"{s.state_pages_leased} state pages leased / "
          f"{s.state_pages_freed} freed, {s.deferred} deferred")
    print(f"[serve] kv memory: {engine.kv.memory_stats()}")
    if args.metrics:
        for name, ts in obs.tracer.snapshot()["tenants"].items():
            ttft = ts["ttft_s"]
            if ttft:
                print(f"[obs] {name}: {ts['finished']} finished, "
                      f"{ts['tokens']} tokens; "
                      f"ttft p50={1e3 * ttft['p50']:.1f}ms "
                      f"p95={1e3 * ttft['p95']:.1f}ms")
        print("[obs] prometheus exposition:")
        print(obs.prometheus())
    if vmm is not None:
        print("[serve] vmm stats:", vmm.stats())
        vmm.shutdown()
    return engine


def virtual_server(device, policy="hybrid", slo_ms=50.0, obs=None):
    """A one-slice VMM over ``device`` and its admitted, opened tenant
    ``server``. The pool is sized from the card's free memory (what the
    weights and caches already hold is not counted twice); a CPU device
    gets 1 GiB (16 MiB segments)."""
    from repro_torch.core import VMM
    grid = np.empty((1, 1), dtype=object)
    grid[0, 0] = torch.device(device)
    hbm = None if torch.device(device).type == "cuda" else 1 << 30
    vmm = VMM(grid, policy=policy, hbm_per_chip=hbm, obs=obs)
    vm_kw = {"sched_slo_wait_s": slo_ms / 1e3} if policy == "slo" else {}
    tenant = vmm.create_vm("server", (1, 1), **vm_kw)
    tenant.device.open()
    return vmm, tenant


def virtualized_engine_kw(tenant):
    """``ServeEngine`` keywords that route every prefill and decode step
    through ``tenant.device.run`` (the VMM data plane), lease KV pages
    from the tenant's MMU pool and defer newcomers under pool pressure."""
    from repro_torch.serving import pool_pressure_gate

    def mediate(fn):
        def run(*a):
            tenant.program = fn
            return tenant.device.run(*a)
        return run
    return {"pool": tenant.pool, "prefill_wrap": mediate,
            "decode_wrap": mediate,
            "admission_gate": pool_pressure_gate(tenant.pool)}


if __name__ == "__main__":
    main()
