"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
runs its driver, reads its per-layer metrics and prints the result.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Their files are ``configs[...]["file"]`` and
``portbench/traffic/<traffic>.json``; the limits of its correctness
check are ``portbench/limits/<cell>.json``; the traffic file's
``driver`` names ``portbench/drivers/<driver>.py``; each per-layer
metric is ``portbench/metrics/<name>.py``; the configuration file's
``family`` names ``portbench/archs/<family>.py``, which holds all that
the benchmark knows of an architecture: its weights' layout by layer
index (``layer_spec``, ``top_groups``, ``FP32_LEAVES``), its plain
reference (``embed``, ``layer``, ``head``), its FLOPs by layer
(``layer_matmul_weights``, ``layer_context_flops``,
``top_matmul_weights``), the widths checked against the port
(``check_port``), its mixer's autograd node (``MIXER_NODE``) and the
sizes of its CPU tests (``TINY``). Adding a cell or a metric adds files
and entries and edits none; so does adding an architecture: one
``archs/`` file, one configuration file, their entries.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"
#: top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunError(Exception):
    """A run that cannot give a result (exit code 2)."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_files(name, root=ROOT):
    """→ (cell, configuration entry, configuration file, traffic mix,
    limits) of cell ``name``."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no cell {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[name]
    conf_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    conf = load_json(root / conf_entry["file"])
    mix = load_json(root / "portbench" / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(root / "portbench" / "limits" / f"{name}.json")
    return bench, cell, conf, mix, limits


def load_arch(family, root=ROOT):
    """The architecture family's module, ``portbench/archs/<family>.py``
    under ``root``."""
    path = root / "portbench" / "archs" / f"{family}.py"
    if not path.is_file():
        raise RunError(f"no architecture family file {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.archs.a_{family.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_config(arch, conf):
    """The port's ``ModelConfig`` of a configuration file: its arch
    (``reduced`` picks the port's CPU-sized variant, for the tests) with
    ``n_layers`` as the file states; the family checks that every width
    the file states equals the port's (``arch.check_port``)."""
    from repro_torch.configs import get_config
    cfg = get_config(conf["arch"], reduced=bool(conf.get("port_reduced")))
    cfg = dataclasses.replace(cfg, n_layers=conf["n_layers"])
    arch.check_port(conf, cfg)
    return cfg


def check_widths(conf, port):
    """Each width of ``port`` (the port's value by the file's key) that
    the file states must equal the file's."""
    for key, value in port.items():
        if key in conf and conf[key] != value:
            raise RunError(f"{conf['name']}: {key} is {conf[key]!r} in the "
                           f"file, {value!r} in the port")


def quantile(values, q):
    """The q-quantile (0 < q < 1) of ``values`` by the nearest rank;
    ``inf`` entries (requests that never got an answer) count."""
    vals = sorted(values)
    if not vals:
        return math.inf
    k = max(0, math.ceil(q * len(vals)) - 1)
    return vals[k]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def device_info(device, peak_bytes):
    import torch
    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": 1,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak_bytes)}


def load_metric(name):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.m_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench, cell, kind):
    """The ``end_to_end`` or ``per_layer`` entries a cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell["name"] in m["workloads"]]


class Context:
    """What a driver gets: the cell's files, its architecture family's
    module, the run's arguments, the device, and the process's start on
    the monotonic clock."""

    def __init__(self, bench, cell, conf, mix, limits, args, device,
                 t_process, root=ROOT):
        self.bench, self.cell, self.conf = bench, cell, conf
        self.mix, self.limits = mix, limits
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.device = device
        self.t_process = t_process
        if "family" not in conf:
            raise RunError(f"{conf['name']}: the file names no family")
        self.arch = load_arch(conf["family"], root)
        self.cfg = port_config(self.arch, conf)


def run(args, t_process, device=None, root=ROOT):
    """Run one cell → (result dict, checks dict). ``device`` None means
    the card, which must be there."""
    import torch
    bench, cell, conf, mix, limits = cell_files(args.workload, root)
    if device is None:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark runs on the card")
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{cell['name']} needs {cell['chips']} cards, "
                           f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = Context(bench, cell, conf, mix, limits, args, device, t_process,
                  root)
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    rec = driver.run(ctx)
    kind = "per_layer" if ctx.trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, cell, kind):
        if kind == "end_to_end":
            # "train_tok_s.rwkv6" is the driver's "train_tok_s" in a cell
            # that carries its own bound
            value = rec.e2e.get(m["name"],
                                rec.e2e.get(m["name"].split(".")[0]))
        else:
            value = load_metric(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(rec.correct), "attempted": int(rec.attempted),
              "failed": int(rec.failed), "metrics": metrics,
              "device": rec.device}
    if ctx.trace and rec.trace is not None:
        result["device"]["busy_s"] = rec.trace.busy_s
        result["device"]["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.device_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
    result["checks"] = rec.checks
    for note in rec.notes:
        print(f"note: {note}", file=sys.stderr)
    return result


class Record:
    """A driver's outcome."""

    def __init__(self):
        self.e2e = {}
        self.correct = False
        self.attempted = 0
        self.failed = 0
        self.device = {}
        self.trace = None
        self.checks = {}
        self.ctx = None
        self.spans = None
        self.counts = {}
        self.notes = []         # diagnostics, printed to standard error


def judge(readings, limits):
    """Each number the cell's limits file names against its limit (a
    reading at or below its limit passes; a missing one fails) → (all
    passed, {name: {value, limit}})."""
    out, ok = {}, True
    for name, entry in limits.items():
        value, limit = readings.get(name), entry["limit"]
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out
