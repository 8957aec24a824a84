"""The port's train launcher (``python -m repro_torch.launch.train``) on the
CPU, reduced qwen: a crash at step 6 (exit 17), the restart from the
step-5 checkpoint with the uninterrupted run's losses (bitwise: the CPU
runs are deterministic and the checkpoint is exact), the run through a
VMM tenant with the native losses, and accumulation. Also
``CheckpointManager`` (interval, async save, ``keep_n``), the train
program through ``ProgramRequest(kind="train")``, and the guard that
keeps a kernel without a backward from handing back a detached output
under autograd.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpointing import CheckpointManager
from repro_torch.kernels import common
from repro_torch.launch import train

torch.set_num_threads(2)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARGS = ["--device", "cpu", "--steps", "10", "--batch", "4", "--seq", "32",
        "--ckpt-every", "5"]


def _run(tmp_path, *extra, name="ck"):
    return train.main(ARGS + ["--ckpt-dir", str(tmp_path / name),
                              *extra])


def test_fail_then_resume_repeats_the_uninterrupted_losses(tmp_path,
                                                           capsys):
    ck = str(tmp_path / "ck")
    # the crashed run's threads are this process's: the sums of a CPU
    # product depend on how it is split
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *ARGS, "--ckpt-dir", ck, "--fail-at", "6"],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == train.FAIL_EXIT, r.stdout + r.stderr
    assert "simulated failure at step 6" in r.stdout
    assert sorted(os.listdir(ck)) == ["step_00000005"]
    resumed = train.main(ARGS + ["--ckpt-dir", ck, "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 5" in out and "done: 4 steps" in out
    whole = _run(tmp_path, name="whole")
    assert sorted(resumed) == [6, 7, 8, 9]
    assert all(resumed[s] == whole[s] for s in resumed)


def test_virtualized_gives_the_native_losses(tmp_path, capsys):
    native = _run(tmp_path, name="n")
    virt = _run(tmp_path, "--virtualized", name="v")
    assert virt == native
    out = capsys.readouterr().out
    assert "vmm stats:" in out and "'failed': 0" in out
    # the tenant's {"params", "opt"} were checkpointed through the VMM
    assert os.listdir(tmp_path / "v_vmm" / "trainer")


def test_accumulation_runs_and_stays_close(tmp_path):
    """``--micro-steps 2 --grad-compress`` trains on the same batches:
    the mean of two half-batch losses, near the one-batch loss."""
    whole = _run(tmp_path, name="a")
    acc = _run(tmp_path, "--micro-steps", "2", "--grad-compress", name="b")
    assert sorted(acc) == sorted(whole)
    assert acc[0] == pytest.approx(whole[0], abs=1e-5)
    assert all(np.isfinite(v) for v in acc.values())


def test_train_program_through_a_tenant():
    """``build_step_for_cell`` of a train cell, through the VMM's
    compile service: the program's abstract args are the train trees,
    and a run updates the trees in place, returns them and the loss."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core import ProgramRequest
    from repro_torch.launch.serve import virtual_server
    from repro_torch.parallel import build_step_for_cell
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    step, (p_abs, o_abs, b_abs) = build_step_for_cell(
        cfg, "cpu", ShapeCell("t", 16, 2, "train"))
    assert sorted(o_abs) == ["m", "step", "v"]
    assert b_abs["labels"].shape == (2, 16)
    vmm, tenant = virtual_server("cpu")
    try:
        prog = tenant.device.reprogram(ProgramRequest(
            arch=cfg.name, kind="train", seq_len=16, global_batch=2))
        assert prog.bitfile.abstract_args[1]["step"].dtype == torch.int32
        from repro_torch import optim
        from repro_torch.bridge import batch_from_numpy
        from repro_torch.data import pipeline_for
        from repro_torch.models import Model
        params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
        state = optim.init(optim.OptConfig(), params)
        batch = batch_from_numpy(pipeline_for(
            cfg, ShapeCell("t", 16, 2, "train")).batch(0))
        before = params["lm_head"].clone()
        new, new_state, m = tenant.device.run(params, state, batch)
        assert int(new_state["step"]) == 1 and np.isfinite(float(m["loss"]))
        # the program consumes its inputs, as the reference's donates
        # them: the trees it returns are the ones it was given, updated
        assert new is params and new_state is state
        assert not torch.equal(new["lm_head"], before)
    finally:
        vmm.shutdown()


def _example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_example_native_equals_virtualized(capsys):
    native, virt = _example("torch_quickstart").main(["--device", "cpu"])
    assert native == virt
    assert "same-artifact lowering | True" in capsys.readouterr().out


def test_train_e2e_example_runs_and_resumes(tmp_path):
    """60 steps with a checkpoint at step 50; a restart goes on at 51
    with the same losses."""
    mod = _example("torch_train_e2e")
    args = ["--device", "cpu", "--width", "64", "--depth", "1", "--seq",
            "32", "--steps", "60", "--ckpt", str(tmp_path)]
    losses = mod.main(args)
    assert len(losses) == 60 and all(np.isfinite(losses))
    assert sorted(os.listdir(tmp_path)) == ["step_00000050"]
    assert mod.main(args + ["--resume"]) == losses[51:]


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------


def test_checkpoint_manager_keeps_the_last_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_interval=2, keep_n=2)
    assert [s for s in range(7) if mgr.should_save(s)] == [2, 4, 6]
    tree = {"w": torch.zeros(3), "b": [torch.ones(2, dtype=torch.bfloat16)]}
    for step in range(1, 6):
        tree = {"w": tree["w"] + 1, "b": [tree["b"][0] * 2]}
        fut = mgr.save(step, tree, meta={"step": step})
        tree["w"].add_(100)           # the host copy was already taken
        tree["w"].sub_(100)
    fut.result()
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000004",
                                            "step_00000005"]
    step, got, meta = mgr.restore_latest(tree)
    assert step == 5 and meta == {"step": 5}
    assert torch.equal(got["w"], torch.full((3,), 5.0))
    assert got["b"][0].dtype == torch.bfloat16
    assert torch.equal(got["b"][0], torch.full((2,), 32.0,
                                               dtype=torch.bfloat16))
    mgr.close()


def test_checkpoint_manager_blocking_save_and_empty_root(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "r"), keep_n=1,
                            async_save=False)
    assert mgr.restore_latest() is None
    path = mgr.save(3, {"x": torch.arange(4)})
    assert os.path.basename(path) == "step_00000003"
    mgr.save(4, {"x": torch.arange(4) + 1})
    assert sorted(os.listdir(tmp_path / "r")) == ["step_00000004"]
    step, flat, _ = mgr.restore_latest()
    assert step == 4 and torch.equal(flat["x"], torch.arange(4) + 1)
    mgr.close()


# ---------------------------------------------------------------------------
# no detached kernel output under autograd
# ---------------------------------------------------------------------------


def test_refuse_grad_raises_for_a_card_input_that_needs_a_gradient():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="rglru_scan: the kernel has no "
                                           "backward in the port"):
        common.refuse_grad("rglru_scan", torch.device("cuda"), x)


def test_refuse_grad_passes_without_grad_mode_or_gradient():
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(3)
    with torch.no_grad():
        common.refuse_grad("rglru_scan", torch.device("cuda"), x)
    common.refuse_grad("rglru_scan", torch.device("cuda"), y, 3)
    common.refuse_grad("rglru_scan", torch.device("cpu"), x)


def _functions(sub):
    path = os.path.join(ROOT, "src", "repro_torch", "kernels", sub,
                        "ops.py")
    tree = ast.parse(open(path, encoding="utf-8").read())
    return {fn.name: fn for fn in ast.walk(tree)
            if isinstance(fn, ast.FunctionDef)}


def _calls(fn):
    return [getattr(c.func, "attr", getattr(c.func, "id", ""))
            for c in ast.walk(fn) if isinstance(c, ast.Call)]


#: the kernels whose op goes through an ``autograd.Function``: sub → op
FUNCTION_OPS = {"flash_attention": "flash_attention_op",
                "rglru_scan": "rglru_scan_op",
                "rwkv6_wkv": "rwkv6_wkv_op"}


def _kernel_ops():
    base = os.path.join(ROOT, "src", "repro_torch", "kernels")
    for sub in sorted(os.listdir(base)):
        if os.path.exists(os.path.join(base, sub, "ops.py")):
            for name, fn in _functions(sub).items():
                if "entry" in _calls(fn):
                    yield sub, name


@pytest.mark.parametrize("sub,name", list(_kernel_ops()),
                         ids=[f"{s}.{n}" for s, n in _kernel_ops()])
def test_every_kernel_launch_is_guarded_or_differentiable(sub, name):
    """Every function that launches a kernel refuses a gradient first
    (``common.refuse_grad``), but those of flash, the RG-LRU scan and the
    RWKV-6 WKV, whose ops go through their ``autograd.Function`` and whose
    launch only that Function reaches: flash's and the WKV's from the
    forward (their backward is a plain recompute), the scan's from the
    forward and the backward (the reversed scan) through one dispatch."""
    fns = _functions(sub)
    if sub in FUNCTION_OPS:
        assert name == "_kernel"
        assert "apply" in _calls(fns[FUNCTION_OPS[sub]])
        callers, frontier = set(), {"_kernel"}
        while frontier:
            new = {n for n, fn in fns.items()
                   if frontier & set(_calls(fn))} - callers
            callers |= new
            frontier = new
        assert callers <= {"forward", "backward", "_scan"}, callers
        assert "forward" in callers
        assert FUNCTION_OPS[sub] not in callers
        return
    assert "refuse_grad" in _calls(fns[name]), name
