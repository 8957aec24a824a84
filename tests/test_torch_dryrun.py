"""The production-mesh dry run, ``python -m repro_torch.launch.dryrun``,
in a subprocess: qwen1.5-0.5b and rwkv6-7b on both production meshes
(rank 0 and the last rank of a 256- and a 512-rank ``"fake"`` group,
meta tensors): every cell's artifact is ``ok`` and carries the
reference's keys (``ops`` where it has ``hlo``), its op record is saved,
``--reanalyze`` recomputes the same terms from that record, and the
roofline's arithmetic is the reference's."""
import gzip
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCHS = ("qwen1.5-0.5b", "rwkv6-7b")
KEYS = {"arch", "shape", "mesh", "n_devices", "kind", "opt_flags", "ok",
        "ranks", "t_lower_s", "t_compile_s", "memory", "cost_analysis",
        "ops", "roofline", "model_flops"}
MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
          "per_device_bytes", "fits_hbm"}
OPS = {"dot_flops", "mem_bytes", "collective_bytes", "collective_count",
       "unknown_trip_whiles", "kernels"}


def _dryrun(out, *extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         ",".join(ARCHS), "--mesh", "both", "--out", str(out), *extra],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    p = _dryrun(out)
    return out, p


def _artifacts(out):
    arts = {}
    for name in os.listdir(out):
        if name.endswith(".json"):
            with open(os.path.join(out, name)) as f:
                arts[name[:-5]] = json.load(f)
    return arts


def test_every_cell_is_counted(sweep):
    out, p = sweep
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert "=== dry-run: 14/14 cells counted ===" in p.stdout, p.stdout
    arts = _artifacts(out)
    # 3 shapes of qwen, 4 of rwkv6 (long_500k: sub-quadratic), 2 meshes
    assert len(arts) == 14
    for tag, art in arts.items():
        assert art["ok"], (tag, art.get("error"))
        assert KEYS <= set(art), (tag, KEYS - set(art))
        assert MEMORY <= set(art["memory"])
        assert OPS <= set(art["ops"])
        world = {"pod16x16": 256, "pods2x16x16": 512}[art["mesh"]]
        assert art["n_devices"] == world
        assert art["ranks"] == [0, world - 1]
        assert art["ops"]["unknown_trip_whiles"] == 0
        assert art["ops"]["dot_flops"] > 0
        assert art["memory"]["fits_hbm"], tag
        assert os.path.exists(os.path.join(out, tag + ".ops.json.gz"))


def test_the_kernels_of_each_cell_are_recorded(sweep):
    arts = _artifacts(sweep[0])
    for mesh in ("pod16x16", "pods2x16x16"):
        q = arts[f"qwen1.5-0.5b_train_4k_{mesh}"]["ops"]["kernels"]
        # one a layer, and again in its recompute (remat "full")
        assert q["flash_attention"]["calls"] == 2 * 24
        d = arts[f"qwen1.5-0.5b_decode_32k_{mesh}"]["ops"]["kernels"]
        assert d["decode_attention"]["calls"] == 24
        w = arts[f"rwkv6-7b_prefill_32k_{mesh}"]["ops"]["kernels"]
        assert w["rwkv6_wkv"]["calls"] == 32
        # rwkv's one-token step launches no kernel
        assert not arts[f"rwkv6-7b_decode_32k_{mesh}"]["ops"]["kernels"]


def test_roofline_is_the_reference_arithmetic(sweep):
    from repro_torch.launch import dryrun
    for art in _artifacts(sweep[0]).values():
        ops, tm = art["ops"], art["roofline"]
        assert tm["compute_s"] == pytest.approx(
            ops["dot_flops"] / dryrun.PEAK_FLOPS)
        assert tm["memory_s"] == pytest.approx(
            ops["mem_bytes"] / dryrun.HBM_BW)
        assert tm["collective_s"] == pytest.approx(
            sum(ops["collective_bytes"].values()) / dryrun.LINK_BW)
        terms = {k: tm[k] for k in ("compute_s", "memory_s",
                                    "collective_s")}
        assert tm["dominant"] == max(terms, key=terms.get)
        assert tm["step_time_lb_s"] == max(terms.values())
        mf = art["model_flops"]
        assert mf["useful_ratio"] == pytest.approx(
            mf["model_flops_per_dev"] / ops["dot_flops"])


def test_two_ranks_hold_the_larger_count(sweep):
    """The artifact holds each count's larger value over rank 0 and the
    last rank; their op records are both kept."""
    out = sweep[0]
    tag = "rwkv6-7b_decode_32k_pods2x16x16"
    with gzip.open(os.path.join(out, tag + ".ops.json.gz"), "rt") as f:
        recs = json.load(f)
    assert sorted(recs) == ["0", "511"]
    with open(os.path.join(out, tag + ".json")) as f:
        art = json.load(f)
    assert art["ops"]["dot_flops"] == max(r["dot_flops"]
                                          for r in recs.values())
    assert art["memory"]["per_device_bytes"] == max(
        r["memory"]["per_device_bytes"] for r in recs.values())


def test_reanalyze_recomputes_the_same_terms(sweep):
    out = sweep[0]
    before = _artifacts(out)
    p = _dryrun(out, "--reanalyze")
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.count("re-analyzed") == 14, p.stdout
    after = _artifacts(out)
    for tag, art in before.items():
        assert after[tag]["roofline"] == art["roofline"], tag
        assert after[tag]["ops"]["dot_flops"] == art["ops"]["dot_flops"]


def test_merge_max_takes_each_count():
    from repro_torch.launch.dryrun import merge_max
    from repro_torch.launch.op_analysis import OpStats
    a = OpStats(dot_flops=5, mem_bytes=7,
                collective_bytes={"all-reduce": 3},
                collective_count={"all-reduce": 1},
                kernels={"k": {"calls": 1, "flops": 9, "bytes": 2}},
                memory={"per_device_bytes": 4})
    b = OpStats(dot_flops=6, mem_bytes=1,
                collective_bytes={"all-reduce": 2, "all-gather": 8},
                collective_count={"all-reduce": 2},
                kernels={"k": {"calls": 1, "flops": 3, "bytes": 5}},
                memory={"per_device_bytes": 9})
    m = merge_max([a, b])
    assert (m.dot_flops, m.mem_bytes) == (6, 7)
    assert m.collective_bytes == {"all-reduce": 3, "all-gather": 8}
    assert m.collective_count == {"all-reduce": 2}
    assert m.kernels == {"k": {"calls": 1, "flops": 9, "bytes": 5}}
    assert m.memory == {"per_device_bytes": 9}
