"""End-to-end training with the PyTorch port: a ~20M-param decoder LM
(scale with --width/--depth) trained for a few hundred steps on the
synthetic learnable stream, with checkpointing and restart support.

Runs on the card unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/torch_train_e2e.py --steps 200
    PYTHONPATH=src python examples/torch_train_e2e.py --device cpu \\
        --steps 40 --width 128 --depth 2
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch import optim
from repro_torch.bridge import batch_from_numpy
from repro_torch.checkpointing import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeCell, ShardingProfile
from repro_torch.data import pipeline_for
from repro_torch.models import Model, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "vpod_e2e_ckpt"))
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ModelConfig(
        name="e2e-lm", family="dense", n_layers=args.depth,
        d_model=args.width, n_heads=max(args.width // 64, 2),
        n_kv_heads=max(args.width // 128, 1), d_ff=args.width * 4,
        vocab=8192, max_seq_len=args.seq,
        sharding=ShardingProfile(remat="none"))
    print(f"model: {cfg.param_counts()['total'] / 1e6:.1f}M params")

    cell = ShapeCell("e2e", args.seq, args.batch, "train")
    model = Model(cfg, device)
    oc = optim.OptConfig(peak_lr=1e-3, warmup_steps=20,
                         decay_steps=args.steps)
    pipe = pipeline_for(cfg, cell, seed=0)
    mgr = CheckpointManager(args.ckpt, save_interval=50, keep_n=2)

    params = model.init(torch.Generator(device=device).manual_seed(0))
    opt_state = optim.init(oc, params)
    first = 0
    if args.resume:
        got = mgr.restore_latest({"params": params, "opt": opt_state},
                                 device=device)
        if got:
            saved, tree, _ = got
            params, opt_state = tree["params"], tree["opt"]
            first = saved + 1
            print(f"resumed from step {saved}")

    # the step consumes params and opt_state (updated in place)
    step_fn = optim.make_train_step(model, oc, donate=True)
    it = pipe.prefetch(start_step=first, depth=2)
    t0 = time.perf_counter()
    tokens, losses = 0, []
    try:
        for step in range(first, args.steps):
            batch = batch_from_numpy(next(it), device)
            params, opt_state, m = step_fn(params, opt_state, batch)
            tokens += args.batch * args.seq
            losses.append(float(m["loss"]))
            if step % 20 == 0 or step == args.steps - 1:
                dt = time.perf_counter() - t0
                print(f"step {step:4d}  loss {losses[-1]:7.4f}  "
                      f"lr {float(m['lr']):.2e}  "
                      f"{tokens / max(dt, 1e-9):,.0f} tok/s")
            if mgr.should_save(step):
                mgr.save(step, {"params": params, "opt": opt_state})
    finally:
        it.close()
        mgr.close()
    print(f"final loss {losses[-1]:.4f} ({args.steps - first} steps, "
          f"{time.perf_counter() - t0:.1f}s)")
    return losses


if __name__ == "__main__":
    main()
