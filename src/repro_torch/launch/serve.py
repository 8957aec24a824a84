"""Serving entry point of the PyTorch port: continuous batching over the paged
KV cache, on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --full \\
        --requests 8 --max-new 16
    ... --chunk-tokens 32   # chunked prefill + fused decode/sampling
    ... --arch recurrentgemma-2b | rwkv6-7b
                            # the recurrent families; their per-slot
                            # state rows lease pages from the MMU too
    ... --arch internlm2-1.8b | phi3-mini-3.8b | starcoder2-15b
                            # the other dense families (GELU FFN)
    ... --arch mixtral-8x7b | kimi-k2-1t-a32b
                            # the MoE families (gather dispatch)
    ... --arch internvl2-2b | whisper-medium
                            # the VLM (stub patches before the prompt)
                            # and the enc-dec (stub frames, cross K/V in
                            # the state rows): monolithic only
    ... --device cpu        # plain PyTorch versions of the kernels
    ... --virtualized --policy {fev,bev,hybrid,wfq,slo} [--slo-ms 50]
                            # every step through a VMM tenant's data plane
    ... --chunk-tokens 8 --share-prefix [--swap]
                            # the KV page hierarchy: prefix sharing with
                            # copy-on-write (attention-only families),
                            # the host swap tier
    ... --models qwen1.5-0.5b,rwkv6-7b,recurrentgemma-2b --max-resident 1
                            # the model mux: several families on one
                            # pool, idle weights hot-swapped to the host

Requests are submitted with varying prompt lengths and token budgets;
the engine admits them into batch slots as earlier requests finish —
each newcomer prefills alone into pages leased from the MMU, so slot
recycling and page faults are visible in the completion log. Weights
are random, drawn from ``--seed``. Under ``--virtualized`` the KV pages
lease segments from the tenant's MMU pool (sized from the card's free
memory once the weights are on it, or 1 GiB on the CPU), newcomers defer
under pool pressure, every prefill and
decode step runs through ``tenant.device.run``, and the VMM's stats print
at the end. The VLM's image patches and the enc-dec's audio frames are
stub frontend outputs drawn from ``np.random.default_rng(0)``, one row per
batch slot, as the reference's entry point draws them; ``--capacity``
counts a VLM slot's text tokens, its image rows come on top.
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
    ap.add_argument("--share-prefix", action="store_true",
                    help="refcounted prompt-prefix sharing: requests "
                         "with a common prompt prefix map the same KV "
                         "pages and skip prefill for the shared span "
                         "(requires --chunk-tokens; attention-only "
                         "families)")
    ap.add_argument("--swap", action="store_true",
                    help="host-memory KV swap tier: under admission "
                         "pressure a victim slot's pages move to host "
                         "memory instead of the newcomer being deferred "
                         "(requires --chunk-tokens)")
    ap.add_argument("--models", default="",
                    help="comma-separated archs for multi-model serving "
                         "on one shared pool (model multiplexing plane); "
                         "overrides --arch and ignores --virtualized")
    ap.add_argument("--max-resident", type=int, default=0,
                    help="with --models: weight-residency budget — idle "
                         "families past this count hot-swap their "
                         "weights to the host tier (0 = unlimited)")
    ap.add_argument("--mux-pool-pages", type=int, default=0,
                    help="with --models: shared MMU pool size in pages "
                         "(0 = auto-size so every family fits)")
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
    if (args.share_prefix or args.swap) and args.chunk_tokens <= 0:
        ap.error("--share-prefix and --swap require --chunk-tokens")

    from repro_torch.configs import get_config
    from repro_torch.models import Model, resolve_device
    from repro_torch.obs import ObsHub
    from repro_torch.serving import ServeEngine

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    obs = ObsHub(enabled=args.metrics)
    if args.models:
        return serve_mux(args, device, obs)
    cfg = get_config(args.arch, reduced=not args.full)
    frontend = cfg.family == "vlm" or cfg.is_encdec
    if frontend and args.chunk_tokens > 0:
        ap.error(f"--chunk-tokens: {args.arch} prefills monolithically "
                 f"(its frontend needs the whole prompt at once)")
    model = Model(cfg, device=device)
    if args.share_prefix and model.state_row_bytes() > 0:
        ap.error(f"--share-prefix: {args.arch} keeps per-slot state rows "
                 f"(recurrent state or cross K/V), which a shared "
                 f"prefix's KV pages do not carry")
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init_compute_params(gen)
    vmm = None
    kw = dict(page_size=args.page_size, obs=obs, obs_tenant="server",
              chunk_tokens=args.chunk_tokens, state_paging=True,
              share_prefix=args.share_prefix, swap=args.swap,
              extra_batch=frontend_inputs(cfg, args.batch))
    if args.virtualized:
        vmm, tenant = virtual_server(device, args.policy, args.slo_ms, obs)
        kw.update(virtualized_engine_kw(tenant))
    engine = ServeEngine(cfg, model, args.batch,
                         args.capacity + model.n_prefix, **kw)

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
    if args.share_prefix or args.swap:
        print(f"[serve] kv hierarchy: {s.shared_prefix_hits} warm "
              f"admissions ({s.shared_prefix_tokens} shared tokens), "
              f"{s.cow_forks} CoW forks, {s.swap_outs} pages swapped / "
              f"{s.swap_ins} refaulted, {s.state_swap_outs} state pages "
              f"parked / {s.state_swap_ins} refaulted")
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


def frontend_inputs(cfg, batch):
    """The stub frontend outputs, one row per batch slot: a VLM's image
    patches, an enc-dec's audio frames ({} otherwise) — drawn from
    ``np.random.default_rng(0)`` in the reference's order."""
    extra = {}
    rng = np.random.default_rng(0)
    shape = (batch, cfg.frontend.n_tokens, cfg.frontend.d_in) \
        if cfg.frontend is not None else None
    if cfg.family == "vlm":
        extra["patches"] = rng.standard_normal(shape, dtype=np.float32)
    if cfg.is_encdec:
        extra["frames"] = rng.standard_normal(shape, dtype=np.float32)
    return extra


def serve_mux(args, device, obs):
    """``--models``: several model families as registered bitstreams on
    one shared pool, a tenant bound to each, requests interleaved."""
    from repro_torch.serving import ModelRegistry, MuxEngine

    names = [n.strip() for n in args.models.split(",") if n.strip()]
    reg = ModelRegistry(obs=obs, max_resident=args.max_resident or None)
    for name in names:
        reg.register(name, reduced=not args.full, device=device,
                     seed=args.seed)
    mux = MuxEngine(reg, names, batch_per_model=args.batch,
                    capacity=args.capacity, page_size=args.page_size,
                    chunk_tokens=max(args.chunk_tokens, 8),
                    pool_pages=args.mux_pool_pages or None, obs=obs)
    rng = np.random.default_rng(args.seed)
    for i, name in enumerate(names):
        mux.bind(f"tenant{i}", name)
    for i in range(args.requests):
        name = names[i % len(names)]
        plen = args.prompt_len + int(rng.integers(0, 8))
        prompt = rng.integers(0, reg[name].cfg.vocab, size=(plen,))
        mux.submit(prompt, tenant=f"tenant{names.index(name)}",
                   max_new_tokens=max(1, args.max_new - 4 * (i % 3)))
    t0 = time.perf_counter()
    finished = mux.run_round()
    dt = time.perf_counter() - t0
    s = mux.stats()
    total = sum(g["tokens"] for g in s["groups"].values())
    print(f"[mux] device {device}: {len(names)} families, "
          f"{sum(len(v) for v in finished.values())} requests, "
          f"{total} tokens in {dt:.2f}s "
          f"({total / max(dt, 1e-9):.1f} tok/s)")
    for name, g in s["groups"].items():
        e = g["engine"]
        print(f"[mux] {name}: {g['completed']} done, {g['tokens']} tok "
              f"in {g['active_s']:.2f}s active; "
              f"pages {e['pages_leased']}/{e['pages_freed']} "
              f"state {e['state_pages_leased']}/{e['state_pages_freed']} "
              f"swaps kv={e['swap_outs']}/{e['swap_ins']} "
              f"state={e['state_swap_outs']}/{e['state_swap_ins']}")
    r = s["registry"]
    print(f"[mux] registry: {r['resident']}/{len(names)} resident "
          f"(budget {r['max_resident']}), crc {r['crc_checks']} checks / "
          f"{r['crc_failures']} failures")
    for name, m in r["models"].items():
        print(f"[mux]   {name}: resident={m['resident']} "
              f"swap in/out={m['swap_ins']}/{m['swap_outs']} "
              f"({m['param_bytes'] / 1e6:.1f} MB, crc {m['crc']})")
    print(f"[mux] pool: {s['pool']}")
    if args.metrics:
        print("[obs] prometheus exposition:")
        print(obs.prometheus())
    return mux


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
