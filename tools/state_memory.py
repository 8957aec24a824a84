#!/usr/bin/env python3
"""The device bytes a recurrent family's prefill program leaves held once
it returns (its activations dropped) beyond the reckoning of its outputs'
own size (``chip_smoke.state_bytes`` plus the logits), for the
``repro_torch`` package under ``--src``: rwkv6-7b and recurrentgemma-2b
at full size, B=4 S=4096, bf16 weights from a seed, on the card. A state
row that is a view of its layer's (B, S, d) activation keeps that whole
activation. Two trees compare in one call, e.g. an earlier commit
unpacked with ``git archive <commit> | tar -x -C build/parent``:

    python3 tools/state_memory.py --src build/parent/src
    python3 tools/state_memory.py
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 tools/state_memory.py")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    src = os.path.abspath(ap.parse_args(argv).src)
    sys.path.insert(0, src)
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels import common
    from repro_torch.models import Model
    from repro_torch.parallel.steps import build_prefill
    device = torch.device("cuda")
    common.build_all()
    B, S = 4, 4096
    for arch in ("rwkv6-7b", "recurrentgemma-2b"):
        cfg = get_config(arch)
        params = Model(cfg, device).init_compute_params(
            torch.Generator(device=device).manual_seed(0))
        prefill, _ = build_prefill(cfg, device,
                                   ShapeCell("p", S, B, "prefill"))
        tokens = torch.randint(
            0, cfg.vocab, (B, S), device=device, dtype=torch.int32,
            generator=torch.Generator(device=device).manual_seed(6))
        prefill(params, {"tokens": tokens[:, :64]})        # warm-up
        torch.cuda.synchronize(device)
        before = torch.cuda.memory_allocated(device)
        logits, caches = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize(device)
        held = torch.cuda.memory_allocated(device) - before
        want = chip_smoke.state_bytes(cfg, B, S) + \
            logits.numel() * logits.element_size()
        mib = 2 ** 20
        print(f"[state-memory] {arch} ({src}) prefill B={B} S={S}: "
              f"{held / mib:.1f} MiB held by its outputs, reckoned "
              f"{want / mib:.1f} MiB; beyond the reckoning "
              f"{(held - want) / mib:.1f} MiB", flush=True)
        del logits, caches, params, prefill
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
