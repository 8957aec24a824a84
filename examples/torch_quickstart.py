"""Quickstart of the PyTorch port: the paper's scenario in one script.

1. Build an LM (an architecture of the repo, reduced dims).
2. Train a few steps natively.
3. Create a VMM, admit a tenant, *reprogram* its slice with the same
   train step, and run the same steps through it — the code is the same
   (fidelity), the control plane is mediated.

Runs on the card unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import dataclasses
import tempfile
import time

import numpy as np
import torch

from repro_torch import optim
from repro_torch.bridge import batch_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.core import VMM, ProgramRequest, report
from repro_torch.data import pipeline_for
from repro_torch.models import Model, resolve_device

ARCH = "qwen1.5-0.5b"
STEPS = 10


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(ARCH, reduced=True)
    cell = ShapeCell("quickstart", seq_len=64, global_batch=4, kind="train")
    model = Model(cfg, device)
    oc = optim.OptConfig(warmup_steps=2, decay_steps=STEPS)
    pipe = pipeline_for(cfg, cell)
    step_fn = optim.make_train_step(model, oc)

    def fresh():
        params = model.init(torch.Generator(device=device).manual_seed(0))
        return params, optim.init(oc, params)

    # --- native ---------------------------------------------------------
    params, opt_state = fresh()
    t0 = time.perf_counter()
    for i in range(STEPS):
        batch = batch_from_numpy(pipe.batch(i), device)
        params, opt_state, m = step_fn(params, opt_state, batch)
    native_loss = float(m["loss"])
    native_s = time.perf_counter() - t0
    print(f"[native]      {STEPS} steps, loss={native_loss:.4f}, "
          f"{native_s:.2f}s")

    # --- virtualized ----------------------------------------------------
    grid = np.empty((1, 1), dtype=object)
    grid[0, 0] = device
    vmm = VMM(grid, policy="hybrid",
              hbm_per_chip=None if device.type == "cuda" else 1 << 30,
              ckpt_root=tempfile.mkdtemp())
    tenant = vmm.create_vm("alice", slice_shape=(1, 1))
    tenant.device.open()
    tenant.device.reprogram(ProgramRequest(
        arch=ARCH, kind="train", seq_len=64, global_batch=4,
        opt_flags=tuple(dataclasses.asdict(oc).items())))

    params, opt_state = fresh()
    t0 = time.perf_counter()
    for i in range(STEPS):
        batch = batch_from_numpy(pipe.batch(i), device)
        params, opt_state, m = tenant.device.run(params, opt_state, batch)
    virt_loss = float(m["loss"])
    virt_s = time.perf_counter() - t0
    print(f"[virtualized] {STEPS} steps, loss={virt_loss:.4f}, "
          f"{virt_s:.2f}s  (ratio {virt_s / native_s:.3f})")

    tenant.state = {"params": params}
    vmm.checkpoint_tenant(tenant)
    print(report(vmm, perf_ratio=virt_s / native_s,
                 same_artifact=True).to_markdown())
    vmm.shutdown()
    return native_loss, virt_loss


if __name__ == "__main__":
    main()
