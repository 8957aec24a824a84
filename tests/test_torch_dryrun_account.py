"""The port's production-mesh dry run held to the reference's, from the
figures both runs left (``tools/dryrun_account.json``, written by
``tools/dryrun_compare.py`` from ``python -m repro_torch.launch.dryrun``'s
and ``python -m repro.launch.dryrun``'s artifacts; neither dry run runs
here).

* Every 16×16 cell's dot FLOPs, port / reference, pinned with its
  cause (:data:`DOT_FLOPS`): the port counts the placements its
  partition rules give, the reference GSPMD's.
* The port's HBM bytes (unfused eager traffic) are *below* the
  reference's count in every 16×16 cell but one, so they are no upper
  bound of it (:data:`HBM_ABOVE`).
* The memory reckoning: a recurrent prefill's outputs at the state's own
  size, a train step's params and optimizer state aliased (donated) as
  the reference's, and no prefill whose temporaries grow from 16×16 to
  2×16×16.
* The reference cannot lower mixtral's and kimi's train step (jax
  0.9.0, ``ShardingTypeError``): pinned from its artifacts, and shown
  live at a reduced size on a (2, 2) CPU mesh beside the port, which
  counts the same cell.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
with open(os.path.join(ROOT, "tools", "dryrun_account.json")) as _f:
    ACCOUNT = json.load(_f)

#: why the port's dot FLOPs differ from the reference's in a cell
CAUSES = {
    "kv_replicated":
        "where the K/V heads (recurrentgemma: its 10 q-heads and one K/V "
        "head) do not divide the model axis the rules replicate them "
        "(parallel/partition.py:117), so every rank projects every such "
        "head over all its rows (models/attention.py:312-327); GSPMD "
        "splits those projections' rows over 'model' and gathers after",
    "gspmd_whole":
        "at decode's few rows a rank GSPMD all-gathers weights and "
        "computes the lm head and the FFN (kimi, mixtral's long_500k: "
        "projections too) whole on every rank; the port keeps the "
        "rules' blocks",
    "flash_recompute":
        "train: the port's flash backward recomputes the attention "
        "forward (flash's record, once of its two calls a layer); the "
        "reference's XLA attention keeps its scores",
    "rwkv_mix":
        "rwkv6: GSPMD splits the contraction of the token-shift LoRA "
        "mixes over 'model' and all-reduces; the port computes them whole "
        "on every rank (as GSPMD_PLACEMENT pins on (2, 2)); at train also "
        "the WKV backward's chunked recompute",
    "rwkv_one_row":
        "rwkv6 long_500k, one row: GSPMD splits every projection's "
        "contraction (d/16 a rank) and all-reduces; the port gives each "
        "rank its output block of the whole row, and the mixes whole",
}

#: 16×16 dot FLOPs, port / reference, to 3 places, and the causes (none
#: where they agree within 1%)
DOT_FLOPS = {
    ("internlm2-1.8b", "decode_32k"): (0.301, ("gspmd_whole",)),
    ("internlm2-1.8b", "prefill_32k"): (1.319, ("kv_replicated",)),
    ("internlm2-1.8b", "train_4k"):
        (1.735, ("kv_replicated", "flash_recompute")),
    ("internvl2-2b", "decode_32k"): (0.301, ("gspmd_whole",)),
    ("internvl2-2b", "prefill_32k"): (1.319, ("kv_replicated",)),
    ("internvl2-2b", "train_4k"):
        (1.735, ("kv_replicated", "flash_recompute")),
    ("kimi-k2-1t-a32b", "decode_32k"): (0.934, ("gspmd_whole",)),
    ("kimi-k2-1t-a32b", "prefill_32k"): (1.180, ("kv_replicated",)),
    ("mixtral-8x7b", "decode_32k"): (0.923, ("gspmd_whole",)),
    ("mixtral-8x7b", "long_500k"): (0.835, ("gspmd_whole",)),
    ("mixtral-8x7b", "prefill_32k"): (1.242, ("kv_replicated",)),
    ("phi3-mini-3.8b", "decode_32k"): (1.000, ()),
    ("phi3-mini-3.8b", "prefill_32k"): (1.000, ()),
    ("phi3-mini-3.8b", "train_4k"): (1.047, ("flash_recompute",)),
    ("qwen1.5-0.5b", "decode_32k"): (1.000, ()),
    ("qwen1.5-0.5b", "prefill_32k"): (1.000, ()),
    ("qwen1.5-0.5b", "train_4k"): (1.083, ("flash_recompute",)),
    ("recurrentgemma-2b", "decode_32k"): (0.233, ("gspmd_whole",)),
    ("recurrentgemma-2b", "long_500k"): (0.200, ("gspmd_whole",)),
    ("recurrentgemma-2b", "prefill_32k"): (1.503, ("kv_replicated",)),
    ("recurrentgemma-2b", "train_4k"):
        (1.220, ("kv_replicated", "flash_recompute")),
    ("rwkv6-7b", "decode_32k"): (1.120, ("rwkv_mix",)),
    ("rwkv6-7b", "long_500k"): (10.618, ("rwkv_one_row",)),
    ("rwkv6-7b", "prefill_32k"): (1.125, ("rwkv_mix",)),
    ("rwkv6-7b", "train_4k"): (1.122, ("rwkv_mix",)),
    ("starcoder2-15b", "decode_32k"): (0.272, ("gspmd_whole",)),
    ("starcoder2-15b", "prefill_32k"): (1.120, ("kv_replicated",)),
    ("starcoder2-15b", "train_4k"):
        (1.209, ("kv_replicated", "flash_recompute")),
    ("whisper-medium", "decode_32k"): (1.000, ()),
    ("whisper-medium", "prefill_32k"): (1.000, ()),
    ("whisper-medium", "train_4k"): (1.064, ("flash_recompute",)),
}

#: the one 16×16 cell whose unfused HBM bytes exceed the reference's
#: count, port / reference (one row: every rank reads its whole weights'
#: blocks, the reference a sixteenth of the contraction)
HBM_ABOVE = {("rwkv6-7b", "long_500k"): 3.540}

#: cells the reference's dry run does not lower (jax 0.9.0)
REFERENCE_FAULTS = {("mixtral-8x7b", "train_4k"),
                    ("kimi-k2-1t-a32b", "train_4k")}
MESHES = ("pod16x16", "pods2x16x16")


def _cell(arch, shape, mesh):
    got = ACCOUNT[f"{arch}|{shape}|{mesh}"]
    return got["port"], got["ref"]


def _compared():
    """The 16×16 cells both dry runs counted."""
    out = []
    for key, got in sorted(ACCOUNT.items()):
        arch, shape, mesh = key.split("|")
        if mesh == MESHES[0] and got["port"]["ok"] and got["ref"]["ok"]:
            out.append((arch, shape))
    return out


def test_every_cell_is_in_the_account():
    """Both dry runs' 66 cells; all the port's counted, the reference's
    all but the pinned faults."""
    assert len(ACCOUNT) == 66
    failed = set()
    for key, got in ACCOUNT.items():
        arch, shape, _ = key.split("|")
        assert got["port"]["ok"], key
        if not got["ref"]["ok"]:
            failed.add((arch, shape))
    assert failed == REFERENCE_FAULTS
    assert set(_compared()) == set(DOT_FLOPS)


@pytest.mark.parametrize("arch,shape", sorted(DOT_FLOPS))
def test_dot_flop_ratio_is_pinned_with_its_cause(arch, shape):
    port, ref = _cell(arch, shape, MESHES[0])
    ratio = port["dot_flops"] / ref["dot_flops"]
    want, causes = DOT_FLOPS[(arch, shape)]
    assert round(ratio, 3) == want, ratio
    assert all(c in CAUSES for c in causes)
    assert bool(causes) == (abs(ratio - 1) > 0.01)
    if causes == ("flash_recompute",):
        # the whole difference: one of flash's two forwards a layer
        net = (port["dot_flops"] - port["flash_flops"] / 2) / \
            ref["dot_flops"]
        assert net == pytest.approx(1.0, abs=1e-3)


def test_unfused_hbm_bytes_are_below_the_references_count():
    """Not an upper bound: the port's unfused eager bytes undercount the
    reference's HLO count in every 16×16 cell but rwkv6's long_500k."""
    ratios = {}
    for arch, shape in _compared():
        port, ref = _cell(arch, shape, MESHES[0])
        ratios[(arch, shape)] = port["mem_bytes"] / ref["mem_bytes"]
    above = {k: round(v, 3) for k, v in ratios.items() if v >= 1}
    assert above == HBM_ABOVE
    below = [v for k, v in ratios.items() if k not in HBM_ABOVE]
    assert 0.04 < min(below) and max(below) < 0.7


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b"])
def test_recurrent_prefill_outputs_hold_the_state_only(arch, mesh):
    """``prefill_32k``'s outputs (logits, ring blocks, state rows) at
    most the reference's: no state row keeps its layer's activation."""
    port, ref = _cell(arch, "prefill_32k", mesh)
    assert port["output_bytes"] <= ref["output_bytes"]
    assert port["output_bytes"] < 2**26


@pytest.mark.parametrize("mesh", MESHES)
def test_train_steps_alias_params_and_state(mesh):
    """Every ``train_4k`` cell donates: its outputs are its params and
    optimizer state (aliased) plus the metrics' scalars, and the aliased
    bytes are the reference's where it lowers."""
    for key, got in ACCOUNT.items():
        arch, shape, m = key.split("|")
        if shape != "train_4k" or m != mesh:
            continue
        port, ref = got["port"], got["ref"]
        assert 0 < port["output_bytes"] - port["alias_bytes"] < 64, key
        if ref["ok"]:
            assert port["alias_bytes"] == ref["alias_bytes"], key


def test_prefill_temporaries_do_not_grow_on_the_larger_mesh():
    """From 16×16 to 2×16×16 no prefill's temporaries grow: each layer's
    ring block at one row a rank is a copy, not a view that kept the
    layer's whole ring alive (internlm2 went 2.75 → 4.19 GiB before)."""
    for key, got in ACCOUNT.items():
        arch, shape, mesh = key.split("|")
        if shape != "prefill_32k" or mesh != MESHES[0]:
            continue
        small = got["port"]["temp_bytes"]
        big = ACCOUNT[f"{arch}|{shape}|{MESHES[1]}"]["port"]["temp_bytes"]
        assert big <= small, arch


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch,shape", sorted(REFERENCE_FAULTS))
def test_reference_fault_is_recorded(arch, shape, mesh):
    port, ref = _cell(arch, shape, mesh)
    assert port["ok"] and not ref["ok"]
    assert ref["error"].startswith("ShardingTypeError: Contracting "
                                   "dimensions are sharded")


REFERENCE_EP_TRAIN = textwrap.dedent('''
    import dataclasses, json, sys
    from repro.configs import get_config
    from repro.configs.base import ShapeCell
    from repro.launch.mesh import make_local_mesh
    from repro.parallel.steps import build_step_for_cell
    out = {}
    for arch in sys.argv[1].split(","):
        cfg = get_config(arch, reduced=True)
        # the full configs' MoE placement (the reduced ones gather)
        cfg = dataclasses.replace(cfg, sharding=dataclasses.replace(
            cfg.sharding, moe_impl="ep"))
        step, args = build_step_for_cell(cfg, make_local_mesh((2, 2)),
                                         ShapeCell("t", 32, 4, "train"))
        try:
            step.lower(*args)
            out[arch] = None
        except Exception as e:
            out[arch] = [type(e).__name__, str(e)[:200]]
    print(json.dumps(out))
''')

PORT_EP_TRAIN = textwrap.dedent('''
    import dataclasses, json, sys
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    torch.set_num_threads(1)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=4)
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.launch.mesh import make_local_mesh
    out = {}
    for arch in sys.argv[1].split(","):
        cfg = get_config(arch, reduced=True)
        cfg = dataclasses.replace(cfg, sharding=dataclasses.replace(
            cfg.sharding, moe_impl="ep"))
        st, _, _ = count_cell(cfg, ShapeCell("t", 32, 4, "train"),
                              make_local_mesh((2, 2), device_type="cpu"))
        out[arch] = st.dot_flops
    print(json.dumps(out))
''')


def test_reference_moe_ep_train_does_not_lower():
    """The fault at a reduced size: mixtral's and kimi's train step with
    the full configs' expert-parallel MoE does not lower on a (2, 2) CPU
    mesh of 4 forced host devices (the same ``ShardingTypeError`` as
    their production cells); the port counts the same cell on a rank of
    a (2, 2) ``"fake"`` group."""
    archs = ",".join(sorted(a for a, _ in REFERENCE_FAULTS))
    base = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_EP_TRAIN, archs],
        env=dict(base, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = subprocess.run([sys.executable, "-c", PORT_EP_TRAIN, archs],
                          env=base, cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-4000:]
    assert port.returncode == 0, port.stderr[-4000:]
    faults = json.loads(out.strip().splitlines()[-1])
    counted = json.loads(port.stdout.strip().splitlines()[-1])
    for arch in archs.split(","):
        assert faults[arch] is not None, arch
        name, msg = faults[arch]
        assert name == "ShardingTypeError", faults[arch]
        assert "Contracting dimensions are sharded" in msg
        assert counted[arch] > 0
