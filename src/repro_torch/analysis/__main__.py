"""CLI: ``python -m repro_torch.analysis [--json PATH] [--src DIR]``.

Checks ``src/repro_torch`` by default and prints the summary; ``--json``
(default ``-``: no file) writes the report to PATH, e.g. under
``build/``. It refuses the repository's committed ``ANALYSIS.json``,
which is the reference package's report.

Exit code 0 = legal; 1 = findings (printed, and written to the JSON
report when one is asked for); 2 = a refused ``--json`` path.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis import default_src_root, run_all

#: the committed report of the reference package (``python -m
#: repro.analysis`` writes it); this checker never overwrites it
COMMITTED_REPORT = os.path.join(
    os.path.dirname(os.path.dirname(default_src_root())), "ANALYSIS.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="concurrency + telemetry legality checker")
    ap.add_argument("--src", default=None,
                    help="source root to analyze (default: the "
                         "repro_torch package)")
    ap.add_argument("--schema-test", default=None,
                    help="path to the stats-schema golden test")
    ap.add_argument("--json", default="-",
                    help="machine-readable report path ('-', the "
                         "default, to skip; e.g. build/analysis.json)")
    args = ap.parse_args(argv)
    if args.json != "-" and os.path.realpath(args.json) == \
            os.path.realpath(COMMITTED_REPORT):
        print(f"--json {args.json}: the committed ANALYSIS.json is the "
              "reference package's report; write under build/ instead",
              file=sys.stderr)
        return 2

    findings, report = run_all(args.src, args.schema_test)
    if args.json != "-":
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.write("\n")

    src = args.src or default_src_root()
    n_edges = len(report["lock_order_edges"])
    n_models = len(report["declared_models"])
    n_metrics = len(report["metrics"])
    print(f"analyzed {src}: {n_models} declared models, "
          f"{n_edges} lock-order edges, {n_metrics} metric names")
    if not findings:
        print("legality: OK (0 findings)")
        return 0
    for rule, n in sorted(report["counts"].items()):
        print(f"  {rule}: {n}")
    for f in findings:
        print(f"  {f}")
    print(f"legality: FAIL ({len(findings)} findings)")
    return 1


if __name__ == "__main__":
    sys.exit(main())
