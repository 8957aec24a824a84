#!/usr/bin/env python3
"""``chip_smoke.py``'s ``[sharded]`` phase alone: the mesh step builders
on a one-rank NCCL mesh against the device builders and, on a machine
that shows two cards or more, the multi-card cases (``MULTI_CARD``, one
NCCL rank a card) against one card.

    python3 tools/sharded_phase.py        # on one card, or on four

It builds every kernel first (one nvcc a source, in parallel), prints
the cards' name and power limit, the phase's ``[sharded]`` lines and the
kernels' launches on the mesh runs, and exits nonzero when a check
fails.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke
    from repro_torch.kernels import common
    if not torch.cuda.is_available():
        print("sharded_phase: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    t = time.perf_counter()
    common.build_all()
    print(f"kernels built in {time.perf_counter() - t:.1f}s", flush=True)
    launches = {}
    chip_smoke.sharded_phase(torch.device("cuda"), launches,
                             smi.splitlines()[0])
    print(f"launches on the mesh runs: {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
