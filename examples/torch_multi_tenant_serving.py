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

Under ``torchrun`` the example runs the reference's sequence on a pod
``DeviceMesh`` of ranks, one rank a card (:func:`serve_on_pod`): 8 ranks
give the reference's 2×4 grid of (1, 4) slices, 4 ranks a 2×2 grid of
(1, 2) slices; every rank runs the same VMM, each tenant's decode
program runs over its slice's mesh (weights and caches placed by the
program's specs), and its logits are held to the same program built
natively on that mesh. The lead rank prints the slices' ranks and each
tenant's logits. One rank gives a (1, 1) pod: room for alice only.

Runs on the card unless ``--device cpu`` is given; reduced configs
unless ``--full``:

    PYTHONPATH=src python examples/torch_multi_tenant_serving.py \\
        [--device cpu] [--policy slo] [--full] [--metrics]
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        examples/torch_multi_tenant_serving.py --device cpu
"""
import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.core import (PRIORITY_HIGH, VMM, LegalityError,
                              ProgramRequest, report)
from repro_torch.core.vmm import world_barrier
from repro_torch.launch.mesh import make_local_mesh, pod_rows, shared_tempdir
from repro_torch.models import Model, resolve_device
from repro_torch.models.model import mesh_device
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


def decode_on_mesh(params, caches, vocab, mesh, t_spec, run,
                   run_async=None, tokens=None):
    """:func:`decode` over a slice's mesh: tokens placed by ``t_spec``,
    each step's logits gathered whole. With ``tokens`` (a list of
    ``(batch, 1)`` int32 tensors) the steps are teacher-forced on them
    instead. A rank outside ``mesh`` passes None for every input and gets
    Nones back (its ops are recorded)."""
    from repro_torch.parallel import partition as part
    member = mesh.get_coordinate() is not None
    device = mesh_device(mesh)
    token = torch.ones((BATCH, 1), dtype=torch.int32, device=device)
    out = []
    for p in range(TOKENS if tokens is None else len(tokens)):
        if tokens is not None:
            token = tokens[p]
        tok = part.distribute({"t": token}, {"t": t_spec}, mesh)["t"] \
            if member else None
        pos = torch.tensor(p, dtype=torch.int32, device=device)
        if p == 0 or run_async is None:
            res = run(params, caches, tok, pos)
        else:
            res = run_async(params, caches, tok, pos).result(timeout=600)
        if res is None:
            out.append(None)
            continue
        logits, caches = res
        logits = logits.full_tensor()
        out.append(logits)
        token = logits[:, :vocab].argmax(-1).to(torch.int32)[:, None]
    return out


def serve_on_pod(pod, args):
    """The two tenants on a pod ``DeviceMesh`` (every rank calls this,
    after ``init_process_group``): alice and bob on one row each, their
    decode programs over their slices' meshes, the cross-slice attack,
    a warm hit, the scheduler stats and the criteria report. → the
    result dict (every rank; a tenant's logits on its ranks only)."""
    import torch.distributed as dist

    from repro_torch.parallel import partition as part
    rank = dist.get_rank()
    lead = rank == int(pod.mesh.flatten()[0])
    _, shape = pod_rows(pod.size())
    device = mesh_device(pod)
    ckpt = shared_tempdir("mt_ckpt_")
    vmm = VMM(pod, policy=args.policy, ckpt_root=ckpt,
              hbm_per_chip=None if device.type == "cuda" else CPU_HBM,
              obs=ObsHub(enabled=args.metrics))
    result = {"policy": args.policy, "pod": tuple(pod.mesh.shape),
              "tenants": {}}
    lines = []
    try:
        room = vmm.floorplanner.rows * vmm.floorplanner.cols // (
            shape[0] * shape[1])
        tenants = []
        for (name, _, _), weight, prio in zip(TENANTS[:room], (3.0, 1.0),
                                              (PRIORITY_HIGH, None)):
            kw = ({"sched_priority": prio, "sched_slo_wait_s": 0.05}
                  if prio is not None else {}) if args.policy == "slo" \
                else {"sched_weight": weight}
            tenants.append(vmm.create_vm(name, shape, **kw))
        if lead:
            print("floorplan:", vmm.floorplanner.snapshot(), "ranks:",
                  {t.name: t.vslice.ranks for t in tenants})
        for tenant, (_, arch, seed) in zip(tenants, TENANTS):
            cfg = get_config(arch, reduced=not args.full)
            tenant.device.open()
            cell = ShapeCell("native", SEQ_LEN, BATCH, "decode")
            prog = tenant.device.reprogram(ProgramRequest(
                arch=arch, kind="decode", seq_len=SEQ_LEN,
                global_batch=BATCH, reduced=not args.full))
            mesh = tenant.vslice.mesh
            info = {"arch": arch, "ranks": tenant.vslice.ranks,
                    "pool_bytes": tenant.pool.n_segments
                    * tenant.pool.segment_bytes, "ops": TOKENS}
            params = caches = t_spec = None
            if tenant.vslice.member:
                p_specs, c_specs, t_spec, _ = prog.bitfile.compiled.specs
                model = Model(cfg, device)
                params = part.distribute(program_params(
                    prog.bitfile.abstract_args[0], model.init_compute_params(
                        torch.Generator(device=device).manual_seed(seed))),
                    p_specs, mesh)
                fresh = lambda: part.distribute(  # noqa: E731
                    model.init_cache(BATCH, SEQ_LEN), c_specs, mesh)
                caches = fresh()
            got = decode_on_mesh(params, caches, cfg.vocab, mesh, t_spec,
                                 tenant.device.run, tenant.device.run_async)
            if tenant.vslice.member:
                # fidelity: the same program built natively on the mesh
                step, _ = build_decode(cfg, mesh, cell)
                want = decode_on_mesh(params, fresh(), cfg.vocab, mesh,
                                      t_spec, step)
                info["native_equal"] = all(torch.equal(a, b)
                                           for a, b in zip(got, want))
                info["finite"] = bool(torch.isfinite(got[-1].float()).all())
                info["logits"] = [x.cpu() for x in got]
                if rank == tenant.vslice.ranks[0]:
                    lines.append(
                        f"[{tenant.name}] served {TOKENS} tokens of {arch} "
                        f"on slice {tenant.vslice.spec.shape} at "
                        f"{tenant.vslice.spec.origin}, ranks "
                        f"{tenant.vslice.ranks} (pool {info['pool_bytes']} "
                        f"bytes); logits {tuple(got[-1].shape)}, "
                        + ("equal to" if info["native_equal"]
                           else "DIFFERENT from")
                        + " the program built natively on the slice's mesh "
                        "bit for bit")
                del params, caches, got, want
            result["tenants"][tenant.name] = info

        if len(tenants) == 2:
            alice, bob = tenants
            try:
                bob.device.reprogram(alice.program.bitfile)
                result["attack_denied"] = False
            except LegalityError as e:
                result["attack_denied"] = True
                result["attack"] = f"cross-slice reprogram denied: {e}"
        else:
            result["attack"] = (f"a {result['pod']} pod holds one tenant: "
                                "no cross-slice attack to try")
        result["violations"] = vmm.auditor.summary()
        tenants[0].device.reprogram(ProgramRequest(
            arch=TENANTS[0][1], kind="decode", seq_len=SEQ_LEN,
            global_batch=BATCH, reduced=not args.full))
        result["hits"], result["misses"] = (vmm.compiler.hits,
                                            vmm.compiler.misses)
        result["sched"] = vmm.stats()["scheduler"]["tenants"]
        result["report"] = report(vmm).to_markdown()
    finally:
        vmm.shutdown()
        world_barrier(pod)
        if lead:
            shutil.rmtree(ckpt, ignore_errors=True)
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, lines)
    if lead:
        for rank_lines in gathered:
            for line in rank_lines:
                print(line)
        print(f"[isolation] {result['attack']}")
        print(f"compile cache: hits={result['hits']} "
              f"misses={result['misses']}")
        for name, st in result["sched"].items():
            print(f"[sched:{args.policy}] {name}: completed="
                  f"{st['completed']} failed={st['failed']} "
                  f"avg_wait={st['avg_wait_ms']:.2f}ms")
        print(result["report"])
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--policy", default="wfq", choices=["wfq", "slo"])
    ap.add_argument("--full", action="store_true",
                    help="the published configs (default: reduced)")
    ap.add_argument("--metrics", action="store_true",
                    help="enable the telemetry plane and print the "
                         "Prometheus exposition at exit")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if "WORLD_SIZE" in os.environ:            # under torchrun
        import torch.distributed as dist
        dist.init_process_group("gloo" if device.type == "cpu" else "nccl")
        try:
            pod = make_local_mesh(pod_rows(dist.get_world_size())[0],
                                  device_type=device.type)
            return serve_on_pod(pod, args)
        finally:
            dist.destroy_process_group()

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
