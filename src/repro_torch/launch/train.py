"""End-to-end training entry point of the port, on the card unless
``--device cpu`` is given (the counterpart of ``repro.launch.train``).

Examples::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --steps 8 --batch 4 --seq 32
    ... --virtualized                     # run through a VMM tenant
    ... --micro-steps 2 --grad-compress   # accumulation, bf16-compressed
    ... --fail-at 6; ... --resume         # simulated crash + restart

Parameters start from ``Model.init`` with a generator seeded 0 (fp32
``param_dtype``); batches come from ``data.pipeline_for(cfg, cell,
seed=0)``, so a restored run at step k sees the batch it would have
seen. The ``--virtualized`` path drives the same train step through a
tenant's ``reprogram``/``run`` operators (a ``ProgramRequest`` of kind
``train`` that carries the optimizer settings), then checkpoints the
tenant's ``{"params", "opt"}`` through the VMM. ``--fail-at N`` exits
with code 17 before step N; ``--resume`` restarts from the newest
checkpoint in ``--ckpt-dir``. The checkpoint of step k holds the state
after step k, so a resumed run goes on at step k + 1 and repeats the
uninterrupted run's losses (the reference's launcher runs step k again).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

FAIL_EXIT = 17


def opt_config(cfg, steps, micro_steps=1, grad_compress=False):
    """This launcher's AdamW settings for a run of ``steps`` steps (the
    reference launcher's): warmup 5, cosine over ``max(steps, 10)``, m/v
    in ``cfg.opt_dtype``."""
    from repro_torch import optim
    return optim.OptConfig(warmup_steps=5, decay_steps=max(steps, 10),
                           micro_steps=micro_steps,
                           grad_compress=grad_compress,
                           state_dtype=cfg.opt_dtype)


def parse_args(argv=None):
    from repro_torch.core.scheduler import POLICIES
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="full (paper-dims) config instead of reduced")
    ap.add_argument("--virtualized", action="store_true")
    ap.add_argument("--policy", default="hybrid", choices=POLICIES)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "vpod_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=0,
                    help="simulate a crash at this step (test restart)")
    ap.add_argument("--micro-steps", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the training loop → {step: loss} of the steps it ran."""
    args = parse_args(argv)
    from repro_torch import optim
    from repro_torch.bridge import batch_from_numpy
    from repro_torch.checkpointing import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import pipeline_for
    from repro_torch.models import Model, resolve_device
    from repro_torch.parallel import build_train

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=not args.full)
    cell = ShapeCell("cli", args.seq, args.batch, "train")
    model = Model(cfg, device=device)
    opt_cfg = opt_config(cfg, args.steps, args.micro_steps,
                         args.grad_compress)

    pipe = pipeline_for(cfg, cell, seed=0)
    mgr = CheckpointManager(args.ckpt_dir, save_interval=args.ckpt_every,
                            keep_n=2)

    params = model.init(torch.Generator(device=device).manual_seed(0))
    opt_state = optim.init(opt_cfg, params)
    first = 0
    if args.resume:
        restored = mgr.restore_latest({"params": params, "opt": opt_state},
                                      device=device)
        if restored is not None:
            saved, tree, _ = restored
            params, opt_state = tree["params"], tree["opt"]
            first = saved + 1
            print(f"[train] resumed from step {saved}")

    vmm = tenant = None
    if args.virtualized:
        from repro_torch.core import VMM, ProgramRequest
        grid = np.empty((1, 1), dtype=object)
        grid[0, 0] = device
        vmm = VMM(grid, policy=args.policy,
                  hbm_per_chip=None if device.type == "cuda" else 1 << 30,
                  ckpt_root=args.ckpt_dir + "_vmm")
        tenant = vmm.create_vm("trainer", (1, 1))
        tenant.device.open()
        req = ProgramRequest(
            arch=args.arch, kind="train", seq_len=args.seq,
            global_batch=args.batch, reduced=not args.full,
            opt_flags=tuple(dataclasses.asdict(opt_cfg).items()))
        tenant.device.reprogram(req)
        run = tenant.device.run
    else:
        run, _ = build_train(cfg, device, cell, opt_cfg)

    losses = {}
    t_start = time.perf_counter()
    try:
        for step in range(first, args.steps):
            if args.fail_at and step == args.fail_at:
                print(f"[train] simulated failure at step {step} — restart "
                      f"with --resume")
                raise SystemExit(FAIL_EXIT)
            batch = batch_from_numpy(pipe.batch(step), device)
            t0 = time.perf_counter()
            params, opt_state, metrics = run(params, opt_state, batch)
            loss = losses[step] = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if step % 5 == 0 or step == args.steps - 1:
                print(f"[train] step={step:4d} loss={loss:8.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):7.3f} "
                      f"dt={dt*1e3:7.1f}ms")
            if mgr.should_save(step):
                mgr.save(step, {"params": params, "opt": opt_state},
                         meta={"arch": args.arch})
    finally:
        mgr.close()
    total = time.perf_counter() - t_start
    print(f"[train] done: {args.steps - first} steps in {total:.1f}s")
    if vmm is not None:
        tenant.state = {"params": params, "opt": opt_state}
        vmm.checkpoint_tenant(tenant)
        print("[train] vmm stats:", vmm.stats())
        vmm.shutdown()
    return losses


if __name__ == "__main__":
    main()
