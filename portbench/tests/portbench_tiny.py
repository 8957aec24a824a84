"""A copy of the benchmark's cells at the port's CPU sizes, for the tests:
the same BENCHMARK.json, traffic kinds, limits and architecture
families, each configuration cut to its family's ``TINY`` widths (the
port's reduced ones) and each mix to a few requests or short rows.
``run_cell`` drives a whole run on the CPU, the look for a card
skipped."""
import argparse
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the CPU cut of each traffic mix; a mix not named here carries its own
#: under the key ``tiny`` in its file
MIXES = {
    "code_completion": dict(clients=4, pool=512, pool_block=4,
                            prompt_tokens=[8, 120], output_tokens=[2, 6],
                            slots=4, capacity=128,
                            warmup=[[120, 2], [8, 2]]),
    "chat_closed": dict(clients=6, pool=512, prompt_tokens=[8, 60],
                        output_tokens=[4, 16], slots=6, capacity=96,
                        page_size=16, chunk_tokens=16,
                        warmup=[[60, 2], [8, 2]]),
    "packed_4k": dict(seq_len=64, doc_tokens={"log_mean": 2.5,
                                              "log_sigma": 1.0}),
}


def tiny_conf(entry):
    """The configuration file of a ``BENCHMARK.json`` entry, cut to its
    family's ``TINY`` widths → (its family's module, the configuration)."""
    from portbench import harness
    conf = json.loads((ROOT / entry["file"]).read_text())
    arch = harness.load_arch(conf["family"])
    conf.update(arch.TINY, port_reduced=True)
    return arch, conf


def config_entries():
    """Every configuration entry of ``BENCHMARK.json``."""
    return json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]


def make_root(tmp):
    """The tiny copy under ``tmp`` → its root."""
    tmp = Path(tmp)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic", "limits"):
        (tmp / "portbench" / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(ROOT / "portbench" / "archs", tmp / "portbench" / "archs",
                    ignore=shutil.ignore_patterns("__pycache__"),
                    dirs_exist_ok=True)
    for c in bench["configs"]:
        _, conf = tiny_conf(c)
        (tmp / c["file"]).write_text(json.dumps(conf))
    for w in bench["workloads"]:
        src = ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
        mix = json.loads(src.read_text())
        mix.update(MIXES.get(w["traffic"]) or mix["tiny"])
        (tmp / "portbench" / "traffic" / src.name).write_text(
            json.dumps(mix))
        shutil.copy(ROOT / "portbench" / "limits" / f"{w['name']}.json",
                    tmp / "portbench" / "limits")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def cell_context(root, cell, seed=2 ** 31 + 11, seconds=1.0, trace=0):
    import torch
    from portbench import harness
    bench, c, conf, mix, limits = harness.cell_files(cell, root)
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=trace)
    return harness.Context(bench, c, conf, mix, limits, args,
                           torch.device("cpu"), time.monotonic(), Path(root))


def run_cell(root, cell, seed=2 ** 31 + 11, seconds=1.0, trace=0):
    """A whole run of ``cell`` on the CPU → the result dict."""
    import torch
    from portbench import harness
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=trace)
    return harness.run(args, time.monotonic(), device=torch.device("cpu"),
                       root=Path(root))
