"""Fault tolerance and elasticity on the PyTorch port: train under the
VMM, lose the slice, migrate, resume from the tenant checkpoint, then
grow the slice (resource-elastic virtualization) — on one device.

A 2×4 view of one device: the trainer's (1, 4) slice holds 4/8 of the
device's memory (on a card, of its free memory). internlm2-1.8b trains
through the tenant's ``train`` program for 6 steps; the tenant's state
(parameters and AdamW's m and v) is checkpointed and its slice marked
failed (the ``slice_failed`` IRQ reaches the ``set_status`` handler);
``migrate_tenant`` moves it to a fresh (1, 4) slice and restores the
state, and 6 more steps run; ``elastic.resize`` grows it to (2, 4) —
the same device, now 8/8 of its memory — and 6 more run. The 18 losses
are held to the same 18 steps run natively without a failure or a
resize (fidelity).

Under ``torchrun`` the example runs the reference's sequence on a pod
``DeviceMesh`` of ranks, one rank a card (:func:`train_on_pod`): 8 ranks
give the reference's 2×4 grid and (1, 4) slice, 4 ranks a 2×2 grid and
(1, 2) slice. The tenant's train program runs over its slice's mesh,
the checkpoint is gathered there and written once, the migration and
the grow to the whole pod restore it with ``shardings_fn`` (the state
placed by the partition rules on the new slice's mesh), and the 18
losses are held to the same steps run natively on meshes of the same
ranks. The lead rank prints the slices' ranks and the losses. One rank
gives a (1, 1) pod: the migration goes back to its one rectangle and
there is no grow.

Runs on the card unless ``--device cpu`` is given; the reduced config
unless ``--full`` (``--depth N`` cuts the layers):

    PYTHONPATH=src python examples/torch_elastic_failover.py \\
        [--device cpu] [--full [--depth 2]] [--batch 4] [--seq 64]
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        examples/torch_elastic_failover.py --device cpu
"""
import argparse
import dataclasses
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch import optim
from repro_torch.bridge import batch_from_numpy
from repro_torch.checkpointing.checkpoint import flatten_with_path
from repro_torch.checkpointing.checkpoint import tree_map as ckpt_tree_map
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.core import VMM, ProgramRequest, elastic
from repro_torch.core.reconfig import CompileService
from repro_torch.core.vmm import world_barrier
from repro_torch.data import pipeline_for
from repro_torch.launch.mesh import make_local_mesh, pod_rows, shared_tempdir
from repro_torch.models import Model, resolve_device
from repro_torch.models.model import mesh_device
from repro_torch.parallel import abstract_params, build_step_for_cell

ARCH = "internlm2-1.8b"
PHASE_STEPS = 6
CPU_HBM = 1 << 30                   # one grid entry's memory on the CPU


def train_config(full=False, depth=None):
    """internlm2-1.8b, reduced unless ``full``, cut to ``depth`` layers."""
    cfg = get_config(ARCH, reduced=not full)
    return dataclasses.replace(cfg, n_layers=depth) if depth else cfg


def init_state(model, oc, device):
    """Parameters from a seeded generator and AdamW's zeroed state."""
    params = model.init(torch.Generator(device=device).manual_seed(0))
    return params, optim.init(oc, params)


def run_steps(run, params, opt_state, pipe, steps, device):
    """Train ``steps`` (an iterable of step indices) → (params, opt
    state, losses)."""
    losses = []
    for step in steps:
        batch = batch_from_numpy(pipe.batch(step), device)
        params, opt_state, m = run(params, opt_state, batch)
        losses.append(float(m["loss"]))
    return params, opt_state, losses


def bit_sums(tree):
    """{leaf key: the sum of its bits as int32 words (bytes for other
    widths)}, on the device: a cheap fingerprint of the leaves' exact
    bits. DTensor leaves are gathered whole (every rank of their mesh
    calls this)."""
    from torch.distributed.tensor import DTensor
    out = {}
    for path, leaf in flatten_with_path(tree):
        t = leaf.full_tensor() if isinstance(leaf, DTensor) else leaf
        t = t.detach().contiguous().reshape(-1)
        t = t.view(torch.int32) if t.element_size() == 4 else \
            t.view(torch.uint8)
        out[".".join(map(str, path))] = int(t.sum(dtype=torch.int64))
    return out


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def steps_on_mesh(run, specs, mesh, params, opt_state, pipe, steps, device):
    """:func:`run_steps` over ``mesh``: each batch placed by ``specs``. A
    rank outside the mesh passes None and gets None losses back (its
    ops are recorded)."""
    from repro_torch.parallel import partition as part
    member = mesh.get_coordinate() is not None
    losses = []
    for step in steps:
        batch = part.distribute(batch_from_numpy(pipe.batch(step), device),
                                specs[2], mesh) if member else None
        out = run(params, opt_state, batch)
        if out is None:
            losses.append(None)
            continue
        params, opt_state, m = out
        losses.append(float(m["loss"]))
    return params, opt_state, losses


def train_on_pod(pod, args):
    """The failover sequence on a pod ``DeviceMesh`` (every rank calls
    this, after ``init_process_group``) → the result dict on every rank
    (losses None where the rank was outside the trainer's slice)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.parallel import build_train
    from repro_torch.parallel import partition as part
    lead = dist.get_rank() == int(pod.mesh.flatten()[0])
    pod_shape, shape = pod_rows(pod.size())
    device = mesh_device(pod)
    cfg = train_config(args.full, args.depth)
    cell = ShapeCell("ef", args.seq, args.batch, "train")
    oc = optim.OptConfig(warmup_steps=2, decay_steps=30)
    pipe = pipeline_for(cfg, cell)
    aparams = abstract_params(Model(cfg, device="meta"))
    template = {"params": aparams, "opt": optim.init(oc, aparams)}

    def placed(vs):
        """The state's placements on ``vs``'s mesh (``shardings_fn``)."""
        p_specs = part.param_specs(cfg, aparams, vs.mesh)
        return {"params": part.shardings(p_specs, vs.mesh),
                "opt": part.shardings(part.opt_specs(cfg, p_specs),
                                      vs.mesh)}

    def start(specs, mesh):
        """Seeded parameters and AdamW's state, placed over ``mesh``."""
        if mesh.get_coordinate() is None:
            return None, None
        params, opt_state = init_state(Model(cfg, device), oc, device)
        return (part.distribute(params, specs[0], mesh),
                part.distribute(opt_state, specs[1], mesh))

    ckpt = shared_tempdir("ef_ckpt_")
    vmm = VMM(pod, policy="hybrid", ckpt_root=ckpt,
              hbm_per_chip=None if device.type == "cuda" else CPU_HBM)
    if args.depth:
        vmm.compiler = CompileService(
            lambda _cfg, target, c, **kw: build_step_for_cell(cfg, target, c,
                                                              **kw))
    out = {"losses": [], "pod": pod_shape, "slices": []}
    say = print if lead else (lambda *a, **k: None)
    try:
        tenant = vmm.create_vm("trainer", shape)
        tenant.device.open()
        tenant.device.reprogram(ProgramRequest(
            arch=ARCH, kind="train", seq_len=args.seq,
            global_batch=args.batch, reduced=not args.full,
            opt_flags=tuple(dataclasses.asdict(oc).items())))
        events = []
        tenant.device.set_status(lambda ev: events.append(ev.kind))

        def phase(first, params, opt_state):
            vs = tenant.vslice
            specs = tenant.program.bitfile.compiled.specs \
                if vs.member else None
            out["slices"].append((vs.spec.origin, vs.spec.shape, vs.ranks))
            params, opt_state, losses = steps_on_mesh(
                tenant.device.run, specs, vs.mesh, params, opt_state, pipe,
                range(first, first + PHASE_STEPS), device)
            out["losses"] += losses
            last = losses[-1]
            return params, opt_state, "-" if last is None else f"{last:.4f}"

        params, opt_state = start(
            tenant.program.bitfile.compiled.specs
            if tenant.vslice.member else None, tenant.vslice.mesh)
        params, opt_state, last = phase(0, params, opt_state)
        say(f"[phase1] {PHASE_STEPS} steps on slice "
            f"{tenant.vslice.spec.origin}, ranks {tenant.vslice.ranks}, "
            f"loss={last}")
        tenant.state = {"params": params, "opt": opt_state}
        # what the restore must give back, bit for bit (members)
        before = ckpt_tree_map(lambda x: x.to_local().clone(), tenant.state) \
            if tenant.vslice.member else None
        del params, opt_state
        t0 = time.perf_counter()
        vmm.checkpoint_tenant(tenant)
        out["checkpoint_s"] = time.perf_counter() - t0
        vmm.mark_slice_failed(tenant.vslice.slice_id)
        out["events"] = list(events)
        t0 = time.perf_counter()
        vmm.migrate_tenant(tenant, new_shape=shape, state_template=template,
                           shardings_fn=placed)
        out["migrate_s"] = time.perf_counter() - t0
        if before is not None:
            out["restored_equal"] = all(
                torch.equal(a, b.to_local()) for (_, a), (_, b) in zip(
                    flatten_with_path(before),
                    flatten_with_path(tenant.state)))
            out["restored_sums"] = bit_sums(tenant.state)
        del before
        say(f"[failure] checkpoint in {out['checkpoint_s']:.2f}s; slice "
            f"marked failed, events={events}; migrated to "
            f"{tenant.vslice.spec.origin}, ranks {tenant.vslice.ranks}, in "
            f"{out['migrate_s']:.2f}s")
        params, opt_state, last = phase(PHASE_STEPS,
                                        tenant.state.pop("params"),
                                        tenant.state.pop("opt"))
        say(f"[phase2] resumed, loss={last}")
        grow = pod_shape != shape
        if grow:
            tenant.state = {"params": params, "opt": opt_state}
            del params, opt_state
            t0 = time.perf_counter()
            elastic.resize(vmm, tenant, pod_shape, state_template=template,
                           shardings_fn=placed)
            out["resize_s"] = time.perf_counter() - t0
            say(f"[elastic] grown to {tenant.vslice.spec.shape}: ranks "
                f"{tenant.vslice.ranks} in {out['resize_s']:.2f}s")
            params, opt_state, last = phase(2 * PHASE_STEPS,
                                            tenant.state.pop("params"),
                                            tenant.state.pop("opt"))
            say(f"[phase3] on the grown slice, loss={last}")
        else:
            say(f"[elastic] a {pod_shape} pod has no larger slice: no grow")
        del params, opt_state
        st = vmm.stats()
        out["hits"], out["misses"] = st["compile_hits"], st["compile_misses"]
        say(f"compile cache: hits={out['hits']} misses={out['misses']}")
    finally:
        vmm.shutdown()
        world_barrier(pod)
        if lead:
            shutil.rmtree(ckpt, ignore_errors=True)

    # fidelity: the same steps natively on meshes of the same ranks, no
    # failure, no checkpoint
    first_ranks = out["slices"][0][2]
    mesh = DeviceMesh(pod.device_type, torch.tensor(
        [list(first_ranks)]), mesh_dim_names=("data", "model"))
    want = []
    params = opt_state = None
    if mesh.get_coordinate() is not None:
        run, _ = build_train(cfg, mesh, cell, oc)
        params, opt_state = start(run.specs, mesh)
        params, opt_state, want = steps_on_mesh(
            run, run.specs, mesh, params, opt_state, pipe,
            range(2 * PHASE_STEPS), device)
    if grow:
        # gathered on the first slice's ranks (collective there), sent
        # from its first rank to every rank
        whole = (full_tree(params), full_tree(opt_state)) \
            if mesh.get_coordinate() is not None else None
        box = [whole if dist.get_rank() == first_ranks[0] else None]
        del whole
        dist.broadcast_object_list(box, src=first_ranks[0])
        run, _ = build_train(cfg, pod, cell, oc)
        params = part.distribute(box[0][0], run.specs[0], pod, device)
        opt_state = part.distribute(box[0][1], run.specs[1], pod, device)
        del box
        *_, more = steps_on_mesh(run, run.specs, pod, params, opt_state,
                                 pipe, range(2 * PHASE_STEPS,
                                             3 * PHASE_STEPS), device)
        want = (want or [None] * 2 * PHASE_STEPS) + more
    del params, opt_state
    out["uninterrupted"] = want
    same = out["losses"] == want
    say(f"[fidelity] {len(want)} losses "
        f"{'equal to' if same else 'DIFFERENT from'} an uninterrupted "
        "run on meshes of the same ranks bit for bit")
    return out


def full_tree(tree):
    """DTensor leaves → whole CPU tensors (a tree every rank can take)."""
    return ckpt_tree_map(lambda x: x.full_tensor().cpu(), tree)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--full", action="store_true",
                    help="the published config (default: reduced)")
    ap.add_argument("--depth", type=int, default=None,
                    help="cut the model to this many layers")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
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
            return train_on_pod(pod, args)
        finally:
            dist.destroy_process_group()

    cfg = train_config(args.full, args.depth)
    cell = ShapeCell("ef", args.seq, args.batch, "train")
    model = Model(cfg, device)
    oc = optim.OptConfig(warmup_steps=2, decay_steps=30)
    pipe = pipeline_for(cfg, cell)

    grid = np.empty((2, 4), dtype=object)
    grid[:] = device
    ckpt = tempfile.mkdtemp(prefix="ef_ckpt_")
    vmm = VMM(grid, policy="hybrid", ckpt_root=ckpt,
              hbm_per_chip=None if device.type == "cuda" else CPU_HBM)
    if args.depth:
        # the compile service builds the published depth from the
        # request: give it a step builder of the cut config
        vmm.compiler = CompileService(
            lambda _cfg, dev, c, **kw: build_step_for_cell(cfg, dev, c,
                                                           **kw))
    out = {"losses": []}
    try:
        tenant = vmm.create_vm("trainer", (1, 4))
        tenant.device.open()
        tenant.device.reprogram(ProgramRequest(
            arch=ARCH, kind="train", seq_len=args.seq,
            global_batch=args.batch, reduced=not args.full,
            opt_flags=tuple(dataclasses.asdict(oc).items())))
        events = []
        tenant.device.set_status(lambda ev: events.append(ev.kind))

        params, opt_state = init_state(model, oc, device)
        params, opt_state, losses = run_steps(
            tenant.device.run, params, opt_state, pipe,
            range(PHASE_STEPS), device)
        out["losses"] += losses
        print(f"[phase1] {PHASE_STEPS} steps on slice "
              f"{tenant.vslice.spec.origin}, loss={losses[-1]:.4f}")

        # checkpoint the tenant's state, then lose the slice
        tenant.state = {"params": params, "opt": opt_state}
        del params, opt_state
        t0 = time.perf_counter()
        path = vmm.checkpoint_tenant(tenant)
        out["checkpoint_s"] = time.perf_counter() - t0
        out["checkpoint_bytes"] = dir_bytes(path)
        vmm.mark_slice_failed(tenant.vslice.slice_id)
        out["events"] = list(events)
        print(f"[failure] checkpoint {out['checkpoint_bytes']} bytes in "
              f"{out['checkpoint_s']:.2f}s; slice marked failed, "
              f"events={events}")

        # migrate to a fresh equal slice; the state restored from the
        # checkpoint onto the slice's device
        aparams = abstract_params(model)
        template = {"params": aparams, "opt": optim.init(oc, aparams)}
        old = tenant.vslice.spec.origin
        whole = vmm.card_bytes(device)      # what the new pool divides
        t0 = time.perf_counter()
        vmm.migrate_tenant(tenant, new_shape=(1, 4), state_template=template)
        out["migrate_s"] = time.perf_counter() - t0
        out["restore_s"] = vmm.stats()["ops"]["restore"]["mean_ms"] / 1e3
        out["restored_sums"] = bit_sums(tenant.state)
        out["pool_before"] = tenant.pool.n_segments * tenant.pool.segment_bytes
        out["share_before"] = out["pool_before"] / whole
        print(f"[migrated] {old} -> {tenant.vslice.spec.origin} "
              f"(healthy={tenant.vslice.healthy}) in {out['migrate_s']:.2f}s, "
              f"restore {out['restore_s']:.2f}s")

        params, opt_state, losses = run_steps(
            tenant.device.run, tenant.state.pop("params"),
            tenant.state.pop("opt"), pipe,
            range(PHASE_STEPS, 2 * PHASE_STEPS), device)
        out["losses"] += losses
        print(f"[phase2] resumed, loss={losses[-1]:.4f}")

        # elastic grow: (1, 4) → (2, 4) of the same device
        tenant.state = {"params": params, "opt": opt_state}
        del params, opt_state
        whole = vmm.card_bytes(device)
        t0 = time.perf_counter()
        elastic.resize(vmm, tenant, (2, 4), state_template=template)
        out["resize_s"] = time.perf_counter() - t0
        vs = tenant.vslice
        out["pool_after"] = tenant.pool.n_segments * tenant.pool.segment_bytes
        out["share_after"] = out["pool_after"] / whole
        out["slice"] = {"shape": vs.spec.shape, "entries": vs.n_devices,
                        "cards": [str(c) for c in vs.cards]}
        print(f"[elastic] grown to {vs.spec.shape}: {vs.n_devices} grid "
              f"entries on {len(vs.cards)} card(s) ({vs.device}), pool "
              f"{out['pool_before']} -> {out['pool_after']} bytes "
              f"({out['share_before']:.4f} -> {out['share_after']:.4f} of "
              f"the device's memory), in {out['resize_s']:.2f}s")
        params, opt_state, losses = run_steps(
            tenant.device.run, tenant.state.pop("params"),
            tenant.state.pop("opt"), pipe,
            range(2 * PHASE_STEPS, 3 * PHASE_STEPS), device)
        out["losses"] += losses
        print(f"[phase3] on the grown slice, loss={losses[-1]:.4f}")
        del params, opt_state
        out["stats"] = vmm.stats()
    finally:
        vmm.shutdown()
        shutil.rmtree(ckpt, ignore_errors=True)

    # fidelity: the same 18 steps natively, no failure and no resize
    step_fn = optim.make_train_step(model, oc)
    params, opt_state = init_state(model, oc, device)
    *_, out["uninterrupted"] = run_steps(
        step_fn, params, opt_state, pipe, range(3 * PHASE_STEPS), device)
    del params, opt_state
    same = out["losses"] == out["uninterrupted"]
    print(f"[fidelity] 18 losses {'equal to' if same else 'DIFFERENT from'}"
          f" an uninterrupted native run bit for bit")
    return out


if __name__ == "__main__":
    main()
