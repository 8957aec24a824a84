#!/usr/bin/env python3
"""Loss curves of the first train steps of the families that
``chip_smoke.py`` trains, on one NVIDIA GPU.

    python3 tools/train_probe.py [--steps N] [--arch ARCH ...]
                                 [--variant base|zero-patches|lr/10 ...]
    python3 tools/train_probe.py --device cpu --reduced   # a tiny check

Each family keeps its cut from ``chip_smoke.TRAIN_FAMILIES`` (full
width; the reduced config with ``--reduced``) and runs N steps of
``pipeline_for(cfg, cell, seed=0)`` batches with the train launcher's
AdamW (``launch.train.opt_config``). After every step it evaluates,
without a gradient, step 0's batch and a batch the run never trains on
(step 1000), and prints the three losses beside the step's learning
rate and gradient norm. Variants:

- ``base``: as ``chip_smoke.py`` trains;
- ``zero-patches``: the VLM's stub image patches set to 0 in every batch
  (the projector's output is then 0 and it gets no gradient);
- ``lr/10``: the peak and floor learning rates divided by 10.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

HELD_OUT = 1000


def probe(device, arch, variant, steps, reduced):
    import torch
    import chip_smoke
    from repro_torch import optim
    from repro_torch.bridge import batch_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import pipeline_for
    from repro_torch.launch.train import opt_config
    from repro_torch.models import Model
    from repro_torch.parallel import build_train
    row = next(r for r in chip_smoke.TRAIN_FAMILIES if r[0] == arch)
    _, _, depth, n_experts, B, S, _ = row
    if reduced:
        cfg = get_config(arch, reduced=True)
        S = min(S, 64 + (cfg.frontend.n_tokens if cfg.frontend else 0))
    else:
        cfg = chip_smoke.family_cfg(arch, depth, n_experts=n_experts)
    opt = opt_config(cfg, steps)
    if variant == "lr/10":
        opt = dataclasses.replace(opt, peak_lr=opt.peak_lr / 10,
                                  min_lr=opt.min_lr / 10)
    cell = ShapeCell("train", S, B, "train")
    pipe = pipeline_for(cfg, cell, seed=0)

    def batch(step):
        b = pipe.batch(step)
        if variant == "zero-patches" and "patches" in b:
            b["patches"] = b["patches"] * 0
        return batch_from_numpy(b, device)

    model = Model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    trees = [params, optim.init(opt, params)]
    del params
    run, _ = build_train(cfg, device, cell, opt)
    first, held = batch(0), batch(HELD_OUT)

    def evaluate(params):
        with torch.no_grad():
            return (float(model.loss(params, first)[0]),
                    float(model.loss(params, held)[0]))

    e0, h0 = evaluate(trees[0])
    print(f"[probe] {arch} {variant}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, B={B} S={S}; before training: step 0's batch "
          f"{e0:.4f}, held-out batch {h0:.4f}", flush=True)
    for step in range(steps):
        params, state, m = run(*trees, batch(step))
        trees = [params, state]
        del params, state
        e, h = evaluate(trees[0])
        print(f"[probe] {arch} {variant} step {step}: lr {float(m['lr']):.3g}"
              f", grad norm {float(m['grad_norm']):.4f}, train loss "
              f"{float(m['loss']):.4f}; after it: step 0's batch {e:.4f}, "
              f"held-out {h:.4f}", flush=True)
    del trees
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser(prog="python3 tools/train_probe.py")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--arch", nargs="+",
                    default=["internvl2-2b", "internlm2-1.8b"])
    ap.add_argument("--variant", nargs="+", default=["base"],
                    choices=["base", "zero-patches", "lr/10"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(torch.cuda.get_device_name(0), flush=True)
    for arch in args.arch:
        for variant in args.variant:
            if variant == "zero-patches" and "internvl2" not in arch:
                continue
            probe(device, arch, variant, args.steps, args.reduced)
    return 0


if __name__ == "__main__":
    sys.exit(main())
