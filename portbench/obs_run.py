"""Run one cell as ``run.py`` does, with the port's span hub active for
the whole run of its driver:

    python3 portbench/obs_run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1> [--hub 0|1]

It prints ``run.py``'s result line with one more key, ``obs``: the
readings taken from the program's spans (``readers_obs``) under the
names ``<reading>.<cell suffix>`` (the suffix of the cell's
``vmm_tax_us.*`` metric), the idle time of the card by program span and
the share of the harness's ``tenant:*``/``engine step`` idle time that
program spans name (both with ``--trace 1``), the host synchronisations
by span, and the ring's counts. ``--hub 0`` runs the cell as ``run.py``
does (the other side of a comparison of what the hub costs).

The drivers take no hub of their own: this script activates one around
the cell's driver and keeps it on the record (``rec.obs``), which is
what a driver would do under ``ctx.trace``.
"""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

#: the readings, each a function of a run's record in ``readers_obs``
READINGS = ("vmm_self_us", "host_syncs_per_step", "dispatch_idle_share")


def suffix(bench, cell):
    """The cell's suffix in the names of its per-layer metrics."""
    for m in bench["per_layer"]:
        if m["name"].startswith("vmm_tax_us.") \
                and cell in m.get("workloads", ()):
            return m["name"].split(".", 1)[1]
    return cell


def obs_readings(rec, sfx):
    from portbench import readers_obs as ro
    out = {}
    for name in READINGS:
        value = getattr(ro, name)(rec)
        if value is not None:
            out[f"{name}.{sfx}"] = value
    spans = rec.obs.spans
    out["ring"] = {"written": spans.written, "dropped": spans.dropped,
                   "capacity": spans.capacity}
    out["syncs_by_span"] = ro.syncs_by_span(rec)
    out["tax_split"] = ro.tax_split(rec)
    out["idle_by_program_span_s"] = ro.program_idle(rec)
    out["named_share_pct"] = ro.named_share(rec)
    return out


def run(args, t_process, hub=True, device=None, root=ROOT):
    """``harness.run`` with a hub active around the cell's driver → the
    result dict, with ``obs`` when ``hub``."""
    from portbench import harness
    from repro_torch.obs import ObsHub
    bench, cell, _, mix, _ = harness.cell_files(args.workload, root)
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    plain, records = driver.run, []

    def with_hub(ctx, *a, **kw):
        h = ObsHub(enabled=False).activate()
        try:
            rec = plain(ctx, *a, **kw)
        finally:
            h.deactivate()
        rec.obs = h
        records.append(rec)
        return rec
    if hub:
        driver.run = with_hub
    try:
        result = harness.run(args, t_process, device=device, root=root)
    finally:
        driver.run = plain
    if hub:
        rec = records[0]
        n = len(rec.notes)
        result["obs"] = obs_readings(rec, suffix(bench, cell["name"]))
        for note in rec.notes[n:]:
            print(f"note: {note}", file=sys.stderr)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(prog="portbench/obs_run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--hub", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    from portbench import harness
    try:
        result = run(args, T_PROCESS, hub=bool(args.hub))
    except (ImportError, FileNotFoundError, KeyError,
            harness.RunError) as exc:
        print(f"portbench: cannot run {args.workload}: {exc!r}",
              file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
