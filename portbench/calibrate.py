"""The readings a cell's correctness limits are set from, on the card, in
one process: the program's number on each of ``--seeds`` seeds (the
lower reading is their largest), and on the first ``--controls`` of
them the control's — the plain reference put in the program's place in
float8 (e4m3, e5m2 gradients), the step below the configurations' bf16
— and, for a training cell, the planted fault "half of the batch left
out" in the reference (a state left unchanged reads 1 by construction).
Each control and fault is judged against the cell's limits file, as a
run judges the program, and its verdict printed beside its readings.

    python3 portbench/calibrate.py --workload sc2-serve-code \
        --seeds 12 --controls 4 --seconds 15

``--seed`` (repeated) reads the given seeds instead. ``--look`` (a
training cell) adds the reference in bf16, the precision the
configurations state, as a witness, and prints each side's worst leaves
of the first gradient: path, its norm, the fp32 reference's, the gap.

Prints one JSON line a seed. The benchmark's own runs never run this.
"""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

#: the calibration's seeds, far from those the driver draws
FIRST_SEED = 4_100_000_000


def judged(readings, limits):
    """``readings`` with the verdict of the cell's limits beside them."""
    from portbench import harness
    ok, _ = harness.judge(readings, limits)
    return dict(readings, judged_correct=ok)


def serve_readings(ctx, control, look=False):
    import torch
    from portbench import weights
    from portbench.drivers import serve
    from portbench.reference import model as ref
    rec = serve.run(ctx, check=False)
    sample = rec.counts["sample"]
    torch.cuda.empty_cache()
    out = {"program": judged({"served_logit_gap": serve._widest_gap(
        ctx.arch, ctx.conf, ctx.seed, ctx.device, sample)}, ctx.limits),
        "served_requests": len(sample),
        "served_tokens": sum(len(t) for _, t in sample)}
    if control:
        top = serve.reference_top(ctx.arch, ctx.conf, ctx.seed, ctx.device)
        gaps = ref.served_gaps(
            ctx.arch, ctx.conf,
            lambda i: weights.make_layer(ctx.arch, ctx.conf, ctx.seed, i,
                                         ctx.device, "serve"),
            top, sample, precision="fp8", own_argmax=True)
        out["control_fp8"] = judged(
            {"served_logit_gap": float(max(g.max() for g in gaps))},
            ctx.limits)
    return out


def worst_leaves(got, want, paths, k=8):
    """The k leaves of the largest gap → [(path, norm, reference, gap)]."""
    from portbench.drivers import train
    gaps = train.leaf_gaps(got, want)
    top = sorted(range(len(gaps)), key=lambda i: -gaps[i])[:k]
    return [("/".join(map(str, paths[i])), got[i], want[i], gaps[i])
            for i in top]


def train_readings(ctx, control, look=False):
    from portbench import weights
    from portbench.drivers import train
    from portbench.reference import train as ref_train
    rec = train.run(ctx)
    want = rec.counts["reference"]
    out = {"program": judged(rec.counts["readings"], ctx.limits)}
    runs = []
    if control:
        runs += [("control_fp8", {"precision": "fp8"}),
                 ("fault_half_batch", {"fault": "half_batch"})]
    if look:
        runs.append(("reference_bf16", {"precision": "bf16"}))
    got = {"program": rec.counts["program"]}
    for name, kw in runs:
        got[name] = ref_train.follow(ctx.arch, ctx.conf, ctx.mix, ctx.seed,
                                     ctx.device, train.CHECKED_STEPS, **kw)
        out[name] = judged(train.compare(got[name]["losses"],
                                         got[name]["grad1"],
                                         got[name]["change"], want),
                           ctx.limits)
    if look:
        paths = weights.leaf_paths(ctx.arch, ctx.conf)
        out["worst_grad_leaves"] = {
            name: worst_leaves(g["grad1"], want["grad1"], paths)
            for name, g in got.items() if name != "fault_half_batch"}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--first-seed", type=int, default=FIRST_SEED)
    ap.add_argument("--seed", type=int, action="append",
                    help="read this seed (repeat for more) instead")
    ap.add_argument("--look", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from portbench import harness
    bench, cell, conf, mix, limits = harness.cell_files(args.workload)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    read = serve_readings if mix["driver"] == "serve" else train_readings
    seeds = args.seed or [args.first_seed + 7919 * i
                          for i in range(args.seeds)]
    for i, seed in enumerate(seeds):
        run_args = argparse.Namespace(seed=seed, seconds=args.seconds,
                                      trace=0)
        ctx = harness.Context(bench, cell, conf, mix, limits, run_args, dev,
                              time.monotonic())
        t = time.monotonic()
        row = {"seed": seed, **read(ctx, i < args.controls, args.look),
               "seconds": time.monotonic() - t}
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
