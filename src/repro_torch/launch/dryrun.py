"""Production-mesh dry run: count every (architecture × input shape ×
mesh) cell's step on one rank of the reference's production meshes and
derive the roofline terms from the counts — the counterpart of
``repro.launch.dryrun``.

The reference lowers and compiles each cell for 256 or 512 forced host
devices and reads the compiled module. Here each mesh runs in processes
of its own (a train cell in one, an arch's other cells in another, one
a CPU core at once): a process is one rank of a ``"fake"`` process
group of 256 (16×16, "pod16x16") or 512 (2×16×16, "pods2x16x16")
ranks, whose collectives take tensors and move nothing, with the
``DeviceMesh`` on ``"cpu"``. It builds each cell's step
(``parallel.build_step_for_cell``) and runs it once on the step's own
abstract arguments — meta tensors, so nothing is allocated and no
kernel launches; each kernel op returns empty outputs and records its
work — under ``launch.op_analysis``'s counter. Rank 0 and the world's
last rank (whose coordinates differ on every axis) both run; the
artifact holds the larger value of each count.

Per cell it writes ``<out>/<arch>_<shape>_<mesh><suffix>.json`` with the
reference's keys (``ops`` where the reference has ``hlo``) and, unless
``--no-save-ops``, ``….ops.json.gz``: both ranks' op records (FLOPs and
bytes by aten op and by kernel, collectives, memory), which
``--reanalyze`` recomputes the terms from.

H100 constants for the roofline (the port's card, not the reference's
chip): ``PEAK_FLOPS`` 989e12 — dense bf16 tensor-core FLOP/s of the H100
SXM (data sheet); ``HBM_BW`` 3.35e12 B/s — its HBM3 (data sheet);
``LINK_BW`` 450e9 B/s — NVLink 4, one direction (data sheet: 900 GB/s
both ways); ``HBM_BYTES`` — ``torch.cuda.get_device_properties(0)
.total_memory`` of the card (``chip_smoke.py`` prints it). The HBM term
reads ``mem_bytes``, unfused eager traffic (see ``op_analysis``): not
the post-fusion model the reference's term reads, and below the
reference's count in all but one production cell, so no bound of it.

Run: ``PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch
qwen1.5-0.5b,rwkv6-7b] [--shape train_4k] [--mesh single|multi|both]``;
exit code 0 only when every cell is ``ok``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

PEAK_FLOPS = 989e12          # H100 SXM bf16 dense, data sheet
HBM_BW = 3.35e12             # H100 SXM HBM3, data sheet
LINK_BW = 450e9              # NVLink 4, one direction, data sheet
HBM_BYTES = 85_017_493_504   # total_memory of NVIDIA H100 80GB HBM3

MESHES = {"pod16x16": (False, 256), "pods2x16x16": (True, 512)}
_UNIT = "@@unit "


def analyze_and_update(art, st, cfg, cell, n_dev):
    """Roofline terms from one rank's counts (an ``OpStats``) — reusable
    for offline re-analysis."""
    compute_s = st.dot_flops / PEAK_FLOPS
    memory_s = st.mem_bytes / HBM_BW
    collective_s = st.total_collective_bytes() / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    pc = cfg.param_counts()
    tokens = cell.global_batch * (
        cell.seq_len if cell.kind in ("train", "prefill") else 1)
    factor = 6 if cell.kind == "train" else 2
    model_flops_dev = factor * pc["active"] * tokens / n_dev
    ratio = model_flops_dev / max(st.dot_flops, 1)
    art.update({
        "ops": {
            "dot_flops": st.dot_flops,
            "mem_bytes": st.mem_bytes,
            "collective_bytes": st.collective_bytes,
            "collective_count": st.collective_count,
            "unknown_trip_whiles": st.unknown_trip_whiles,
            "kernels": st.kernels,
        },
        "roofline": {**terms, "dominant": dominant,
                     "step_time_lb_s": max(terms.values()),
                     "roofline_fraction_compute":
                         compute_s / max(terms.values())
                         if max(terms.values()) > 0 else 0.0},
        "model_flops": {"params_total": pc["total"],
                        "params_active": pc["active"],
                        "tokens": tokens,
                        "model_flops_per_dev": model_flops_dev,
                        "useful_ratio": ratio},
    })
    return art


def merge_max(stats):
    """One ``OpStats`` holding the larger value of each count of the
    ranks' ``stats``."""
    from repro_torch.launch.op_analysis import OpStats
    out = OpStats()
    for st in stats:
        out.dot_flops = max(out.dot_flops, st.dot_flops)
        out.mem_bytes = max(out.mem_bytes, st.mem_bytes)
        for mine, theirs in ((out.collective_bytes, st.collective_bytes),
                             (out.collective_count, st.collective_count),
                             (out.memory, st.memory)):
            for k, v in theirs.items():
                mine[k] = max(mine.get(k, 0), v)
        for name, rec in st.kernels.items():
            mine = out.kernels.setdefault(name, dict.fromkeys(rec, 0))
            for k, v in rec.items():
                mine[k] = max(mine[k], v)
    return out


# ---------------------------------------------------------------------------
# A worker: one rank of one mesh
# ---------------------------------------------------------------------------


def _configure(arch, moe_impl, no_splitk):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    prof, flags = cfg.sharding, []
    if moe_impl is not None:
        prof = dataclasses.replace(prof, moe_impl=moe_impl)
        flags.append(f"moe={moe_impl}")
    if no_splitk:
        prof = dataclasses.replace(prof, decode_splitk=False)
        flags.append("no_splitk")
    if prof is not cfg.sharding:
        cfg = dataclasses.replace(cfg, sharding=prof)
    return cfg, flags


def count_cell(cfg, cell, mesh):
    """One rank's counts of ``cell``'s step on ``mesh`` (meta arguments)
    → (OpStats, seconds to build, seconds to run)."""
    from repro_torch.launch.op_analysis import count_step
    from repro_torch.parallel import build_step_for_cell
    t0 = time.perf_counter()
    step, args = build_step_for_cell(cfg, mesh, cell)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = count_step(step, args)
    return st, t_build, time.perf_counter() - t0


def worker(mesh_name, rank, units, moe_impl, no_splitk):
    """Count ``units`` ((arch, shape) pairs) as ``rank`` of ``mesh_name``'s
    fake group; print one line of JSON a unit."""
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs.base import SHAPES_BY_NAME
    from repro_torch.launch.mesh import make_production_mesh
    torch.set_num_threads(1)
    multi, world = MESHES[mesh_name]
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        for arch, shape in units:
            cfg, _ = _configure(arch, moe_impl, no_splitk)
            res = {"arch": arch, "shape": shape, "rank": rank}
            try:
                st, tb, tr = count_cell(cfg, SHAPES_BY_NAME[shape], mesh)
                res.update(ok=True, record=st.to_record(), t_build_s=tb,
                           t_run_s=tr)
            except Exception as e:   # noqa: BLE001 — into the artifact
                res.update(ok=False, error=f"{type(e).__name__}: {e}",
                           traceback=traceback.format_exc()[-4000:])
            print(_UNIT + json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------


def _paths(out_dir, tag):
    return (os.path.join(out_dir, tag + ".json"),
            os.path.join(out_dir, tag + ".ops.json.gz"))


def _spawn(mesh_name, rank, units, args):
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--worker",
           mesh_name, str(rank), "--units",
           ",".join(f"{a}:{s}" for a, s in units)]
    if args.moe_impl:
        cmd += ["--moe-impl", args.moe_impl]
    if args.no_splitk:
        cmd.append("--no-splitk")
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env)


def _tasks(todo):
    """(mesh, rank, units) for the worker processes: each mesh's rank 0
    and last rank, a process for each train cell (the longest) and one
    for each arch's other cells."""
    tasks = []
    for mesh_name, units in todo.items():
        world = MESHES[mesh_name][1]
        groups = {}
        for arch, shape in units:
            key = (arch, shape) if shape.startswith("train") else (arch,)
            groups.setdefault(key, []).append((arch, shape))
        for rank in (0, world - 1):
            tasks += [(mesh_name, rank, g) for g in groups.values()]
    # the train cells first: they set the critical path
    return sorted(tasks, key=lambda t: not t[2][0][1].startswith("train"))


def _run_tasks(tasks, args):
    """Run the workers, one a CPU core at once → {(mesh, arch, shape):
    {rank: unit}}; a worker that dies leaves its remaining units out."""
    jobs = os.cpu_count() or 1
    got, running, pending = {}, [], list(tasks)
    while pending or running:
        while pending and len(running) < jobs:
            mesh_name, rank, units = pending.pop(0)
            running.append((mesh_name, rank,
                            _spawn(mesh_name, rank, units, args)))
        mesh_name, rank, proc = running.pop(0)
        out, _ = proc.communicate()
        for line in out.splitlines():
            if line.startswith(_UNIT):
                u = json.loads(line[len(_UNIT):])
                got.setdefault((mesh_name, u["arch"], u["shape"]),
                               {})[rank] = u
    return got


def _artifact(cfg, cell, mesh_name, flags, units, world):
    """The cell's artifact from its ranks' units (None for a rank whose
    worker died)."""
    from repro_torch.launch.op_analysis import OpStats
    art = {"arch": cfg.name, "shape": cell.name, "mesh": mesh_name,
           "n_devices": world, "kind": cell.kind, "opt_flags": flags,
           "ranks": sorted(units), "ok": False}
    bad = [u for u in units.values() if not u.get("ok")]
    if bad or len(units) < 2:
        u = bad[0] if bad else {"error": "a worker exited before this cell"}
        art["error"] = u.get("error")
        art["traceback"] = u.get("traceback", "")
        return art
    stats = {r: OpStats.from_record(u["record"]) for r, u in units.items()}
    st = merge_max(stats.values())
    mem = dict(st.memory)
    mem["fits_hbm"] = bool(mem["per_device_bytes"] <= HBM_BYTES)
    kernel_f = sum(k["flops"] for k in st.kernels.values())
    kernel_b = sum(k["bytes"] for k in st.kernels.values())
    art.update({
        "ok": True,
        "t_lower_s": max(u["t_build_s"] for u in units.values()),
        "t_compile_s": max(u["t_run_s"] for u in units.values()),
        "memory": mem,
        # what the aten ops alone count (the kernels' records aside)
        "cost_analysis": {"flops_naive": st.dot_flops - kernel_f,
                          "bytes_naive": st.mem_bytes - kernel_b},
    })
    return analyze_and_update(art, st, cfg, cell, world)


def _print_terms(tag, art, what="terms"):
    tm = art["roofline"]
    print(f"[{tag}] {what}: compute={tm['compute_s']*1e3:.2f}ms "
          f"memory={tm['memory_s']*1e3:.2f}ms "
          f"collective={tm['collective_s']*1e3:.2f}ms "
          f"dominant={tm['dominant']} useful_ratio="
          f"{art['model_flops']['useful_ratio']:.3f} per_device="
          f"{art['memory']['per_device_bytes'] / 2**30:.2f}GiB "
          f"fits={art['memory']['fits_hbm']}")


def _reanalyze(path, rec_path, cfg, cell, tag):
    from repro_torch.launch.op_analysis import OpStats
    with open(path) as f:
        art = json.load(f)
    if art.get("ok") and os.path.exists(rec_path):
        with gzip.open(rec_path, "rt") as f:
            recs = json.load(f)
        st = merge_max(OpStats.from_record(r) for r in recs.values())
        art = analyze_and_update(art, st, cfg, cell, art["n_devices"])
        _print_terms(tag, art, "re-analyzed")
        with open(path, "w") as f:
            json.dump(art, f, indent=1)
    return art


def run(args):
    from repro_torch.configs import list_archs
    from repro_torch.configs.base import applicable_shapes
    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    meshes = [m for m, on in (("pod16x16", args.mesh != "multi"),
                              ("pods2x16x16", args.mesh != "single")) if on]
    os.makedirs(args.out, exist_ok=True)
    cells, results, todo = [], {}, {}
    for arch in archs:
        cfg, flags = _configure(arch, args.moe_impl, args.no_splitk)
        for cell in applicable_shapes(cfg):
            if args.shape != "all" and cell.name not in args.shape.split(","):
                continue
            for mesh_name in meshes:
                tag = f"{cfg.name}_{cell.name}_{mesh_name}{args.suffix}"
                path, rec_path = _paths(args.out, tag)
                cells.append((cfg, cell, mesh_name, flags, tag))
                if os.path.exists(path) and not args.force:
                    if args.reanalyze:
                        results[tag] = _reanalyze(path, rec_path, cfg, cell,
                                                  tag)
                    else:
                        with open(path) as f:
                            results[tag] = json.load(f)
                    continue
                todo.setdefault(mesh_name, []).append((arch, cell.name))
    got = _run_tasks(_tasks(todo), args)
    for cfg, cell, mesh_name, flags, tag in cells:
        if tag in results:
            continue
        world = MESHES[mesh_name][1]
        units = got.get((mesh_name, cfg.name, cell.name), {})
        art = _artifact(cfg, cell, mesh_name + args.suffix, flags, units,
                        world)
        path, rec_path = _paths(args.out, tag)
        if art["ok"]:
            _print_terms(tag, art)
            if not args.no_save_ops:
                with gzip.open(rec_path, "wt") as f:
                    json.dump({str(r): u["record"]
                               for r, u in units.items()}, f)
        else:
            print(f"[{tag}] FAILED: {(art['error'] or '')[:200]}")
        with open(path, "w") as f:
            json.dump(art, f, indent=1)
        results[tag] = art
    arts = list(results.values())
    ok = sum(1 for r in arts if r.get("ok"))
    print(f"\n=== dry-run: {ok}/{len(arts)} cells counted ===")
    for r in arts:
        if not r.get("ok"):
            print("  FAIL:", r["arch"], r["shape"], r["mesh"],
                  (r.get("error") or "")[:120])
    return 0 if ok == len(arts) else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-save-ops", action="store_true")
    ap.add_argument("--reanalyze", action="store_true")
    ap.add_argument("--moe-impl", default=None, choices=["gather", "ep"])
    ap.add_argument("--no-splitk", action="store_true",
                    help="disable split-KV decode (reproduce baseline)")
    ap.add_argument("--suffix", default="",
                    help="artifact tag suffix (e.g. _opt for hillclimbs)")
    ap.add_argument("--worker", nargs=2, metavar=("MESH", "RANK"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--units", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        units = [tuple(u.split(":")) for u in args.units.split(",") if u]
        worker(args.worker[0], int(args.worker[1]), units, args.moe_impl,
               args.no_splitk)
        return 0
    return run(args)


if __name__ == "__main__":
    raise SystemExit(main())
