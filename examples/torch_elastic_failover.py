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

Runs on the card unless ``--device cpu`` is given; the reduced config
unless ``--full`` (``--depth N`` cuts the layers):

    PYTHONPATH=src python examples/torch_elastic_failover.py \\
        [--device cpu] [--full [--depth 2]] [--batch 4] [--seq 64]
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
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.core import VMM, ProgramRequest, elastic
from repro_torch.core.reconfig import CompileService
from repro_torch.data import pipeline_for
from repro_torch.models import Model, resolve_device
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


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--full", action="store_true",
                    help="the published config (default: reduced)")
    ap.add_argument("--depth", type=int, default=None,
                    help="cut the model to this many layers")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

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
