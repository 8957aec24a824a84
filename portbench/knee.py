"""The knee of a serving cell's mix offered in an open loop: the cell's
sizes run at stepped rates in one process, each rate one window without
the reference check.

    python3 portbench/knee.py --workload sc2-serve-code --seconds 30 \\
        --rates 3,4,5,6,7 [--seed N]

Prints one line a rate: requests due, first tokens by the close, the
backlog at the close (due requests still without a first token), the
time to first token's median and 95th percentile over the first and the
second half of the requests, and the tokens served a second. The knee is
the highest rate whose backlog does not grow: the second half's tail no
longer than the first half's by much, and no backlog at the close
beyond the slots."""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="portbench/knee.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, default=20261018)
    ap.add_argument("--repeat", type=int, default=1,
                    help="windows at each rate, to read their spread")
    args = ap.parse_args(argv)
    import torch
    from portbench import harness
    from portbench.drivers import serve
    bench, cell, conf, mix, limits = harness.cell_files(args.workload)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    rates = [float(r) for r in args.rates.split(",")]
    for rate in [r for r in rates for _ in range(args.repeat)]:
        run_args = argparse.Namespace(seed=args.seed, seconds=args.seconds,
                                      trace=0)
        ctx = harness.Context(bench, cell, conf,
                              dict(mix, loop="open", rate_per_s=rate,
                                   after_close="wait"),
                              limits, run_args, dev, time.monotonic())
        rec = serve.run(ctx, check=False)
        ttft = rec.counts["ttft_s"]
        half = len(ttft) // 2

        def q(v, p):
            return 1e3 * harness.quantile(v, p)
        row = {"rate_per_s": rate, "due": len(ttft),
               "first_by_close": sum(1 for x in ttft if x < math.inf),
               "backlog_at_close": rec.counts["backlog_at_close"],
               "ttft_p50_ms": [q(ttft[:half], 0.5), q(ttft[half:], 0.5)],
               "ttft_p95_ms": [q(ttft[:half], 0.95), q(ttft[half:], 0.95)],
               "ttft_p90_ms_all": q(ttft, 0.90),
               "serve_tok_s": rec.e2e["serve_tok_s"],
               "failed": rec.failed,
               "deferred": rec.counts["stats1"]["deferred"]
               - rec.counts["stats0"]["deferred"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del rec, ctx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
