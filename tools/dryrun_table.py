#!/usr/bin/env python3
"""The production-mesh dry run's artifacts as one markdown table: a row
an arch, a column a shape; each cell gives the per-device GiB, the
step's lower bound (ms) on 16×16 / 2×16×16, and the useful-FLOP ratio
(16×16). Below it: the dominant roofline term of every cell, and the
cells whose bytes do not fit the card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun   # the sweep
    python3 tools/dryrun_table.py [--dir experiments/dryrun_torch]
        [--suffix _nosplitk]

A cell missing from the directory, or not ``ok``, prints as ``-``.
"""
import argparse
import collections
import json
import os

MESHES = ("pod16x16", "pods2x16x16")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SHORT = {"compute_s": "compute", "memory_s": "HBM",
         "collective_s": "collective"}


def cell(arts):
    """'GiB a / b, lb ms a / b, useful' of one arch × shape."""
    if not all(a and a.get("ok") for a in arts):
        return "-"
    gib = " / ".join(f"{a['memory']['per_device_bytes'] / 2**30:.2f}"
                     for a in arts)
    lb = " / ".join(f"{a['roofline']['step_time_lb_s'] * 1e3:.4g}"
                    for a in arts)
    return f"{gib}; {lb}; {arts[0]['model_flops']['useful_ratio']:.3f}"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--suffix", default="")
    args = ap.parse_args()
    arts = {}
    meshes = [m + args.suffix for m in MESHES]
    for name in sorted(os.listdir(args.dir)):
        if name.endswith(".json"):
            with open(os.path.join(args.dir, name)) as f:
                a = json.load(f)
            if a["mesh"] in meshes:
                arts[(a["arch"], a["shape"], a["mesh"])] = a
    print("| arch | " + " | ".join(SHAPES) + " |")
    print("| --- |" + " --- |" * len(SHAPES))
    for arch in sorted({a for a, _, _ in arts}):
        row = []
        for shape in SHAPES:
            got = [arts.get((arch, shape, m)) for m in meshes]
            row.append("" if not any(got) else cell(got))
        print(f"| {arch} | " + " | ".join(row) + " |")
    ok = [a for a in arts.values() if a.get("ok")]
    dom = collections.Counter(SHORT[a["roofline"]["dominant"]] for a in ok)
    nofit = sorted(f"{a['arch']} {a['shape']} {a['mesh']}" for a in ok
                   if not a["memory"]["fits_hbm"])
    print(f"\n{len(ok)}/{len(arts)} cells ok; dominant term: "
          + ", ".join(f"{k} {n}" for k, n in dom.most_common())
          + "; not fitting the card: " + (", ".join(nofit) or "none"))


if __name__ == "__main__":
    main()
