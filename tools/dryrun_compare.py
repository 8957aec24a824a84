#!/usr/bin/env python3
"""The port's production-mesh dry run beside the reference's, cell by
cell: dot FLOPs and HBM bytes (port / reference), and the memory
reckoning of both (outputs, aliased outputs, a device's bytes).

    PYTHONPATH=src python -m repro_torch.launch.dryrun          # the port
    PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.dryrun \\
        --out build/dryrun_ref --no-save-hlo                      # reference
    python3 tools/dryrun_compare.py [--port experiments/dryrun_torch]
        [--ref build/dryrun_ref] [--json tools/dryrun_account.json]

Prints two markdown tables: the 16×16 ratios, and the memory of every
cell on both meshes (GiB; the reference's beside the port's, "-" where
its dry run did not compile the cell). ``--json`` writes the figures the
tables come from (``tests/test_torch_dryrun_account.py`` reads them).
"""
import argparse
import json
import os

MESHES = ("pod16x16", "pods2x16x16")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MEMORY = ("output_bytes", "alias_bytes", "temp_bytes", "per_device_bytes")


def load(directory, counts_key):
    """{(arch, shape, mesh): figures} of the default sweep's artifacts."""
    out = {}
    for name in sorted(os.listdir(directory)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(directory, name)) as f:
            a = json.load(f)
        if a["mesh"] not in MESHES:
            continue
        key = (a["arch"], a["shape"], a["mesh"])
        if not a.get("ok"):
            out[key] = {"ok": False, "error": a.get("error", "")[:120]}
            continue
        c = a[counts_key]
        out[key] = {"ok": True, "dot_flops": c["dot_flops"],
                    "mem_bytes": c["mem_bytes"],
                    **{k: a["memory"][k] for k in MEMORY}}
        if "kernels" in c:
            # flash's record: its forward, once more in a remat recompute
            out[key]["flash_flops"] = c["kernels"].get(
                "flash_attention", {}).get("flops", 0)
    return out


def gib(x):
    return f"{x / 2**30:.2f}"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", default="experiments/dryrun_torch")
    ap.add_argument("--ref", default="build/dryrun_ref")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    port, ref = load(args.port, "ops"), load(args.ref, "hlo")
    cells = sorted(set(port) | set(ref))
    if args.json:
        record = {"|".join(k): {"port": port.get(k), "ref": ref.get(k)}
                  for k in cells}
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1, sort_keys=True)
            f.write("\n")
    print("| arch × shape (16×16) | dot FLOPs port / ref | HBM bytes "
          "port / ref |")
    print("| --- | --- | --- |")
    for arch, shape, mesh in cells:
        p, r = port.get((arch, shape, mesh)), ref.get((arch, shape, mesh))
        if mesh != MESHES[0] or not (p and r and p["ok"] and r["ok"]):
            continue
        print(f"| {arch} {shape} | {p['dot_flops'] / r['dot_flops']:.3f} | "
              f"{p['mem_bytes'] / r['mem_bytes']:.3f} |")
    print()
    print("| arch × shape | output GiB port / ref | alias GiB port / ref | "
          "a device's GiB port / ref |")
    print("| --- | --- | --- | --- |")
    for arch in sorted({a for a, _, _ in cells}):
        for shape in SHAPES:
            got = [(port.get((arch, shape, m)), ref.get((arch, shape, m)))
                   for m in MESHES]
            if not any(p for p, _ in got):
                continue
            row = []
            for key in ("output_bytes", "alias_bytes", "per_device_bytes"):
                row.append(" ; ".join(
                    f"{gib(p[key]) if p and p['ok'] else '-'} / "
                    f"{gib(r[key]) if r and r['ok'] else '-'}"
                    for p, r in got))
            print(f"| {arch} {shape} | " + " | ".join(row) + " |")
    failed = sorted(f"{' '.join(k)} ({v['error'][:60]})"
                    for k, v in ref.items() if not v["ok"])
    print()
    print("cells on 16×16 ; 2×16×16. Reference cells that did not compile: "
          + ("; ".join(failed) or "none"))


if __name__ == "__main__":
    main()
