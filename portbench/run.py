"""Run one cell of the port's benchmark on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the result as one JSON object on the last line of standard
output, and each number that decided ``correct`` beside its limit as the
last lines of standard error. Exits 2 without a result when there is no
card (or too few), when the cell's files or the port cannot be found,
and 3 when a module of JAX or of the JAX package was loaded.
"""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    try:
        from portbench import harness
        result = harness.run(args, T_PROCESS)
    except (ImportError, FileNotFoundError, KeyError) as exc:
        print(f"portbench: cannot run {args.workload}: {exc!r}",
              file=sys.stderr)
        return 2
    except harness.RunError as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; no result",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
