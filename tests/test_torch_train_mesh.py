"""The train driver under ``torchrun`` on two CPU ranks: the reference's
``(1, world)`` mesh, the mesh step builder, the same pipeline batches;
its losses against the one-process driver's (reduced qwen, bf16 compute:
the model axis sums partial products rounded to bf16, so within 1e-3
relative), with ``--micro-steps`` too, and the flag it refuses on a mesh
(``--virtualized``). Its checkpoints, ``--resume`` and ``--fail-at``:
``tests/test_torch_vslice_train_driver.py``."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARGS = ["--device", "cpu", "--steps", "6", "--batch", "4", "--seq", "32"]


def torchrun(*extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *ARGS,
         *extra], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=240)


def test_torchrun_losses_follow_the_one_process_driver(tmp_path):
    from repro_torch.launch import train
    want = train.main(ARGS + ["--ckpt-dir", str(tmp_path / "ck")])
    p = torchrun()
    assert p.returncode == 0, p.stdout + p.stderr[-3000:]
    assert "[train] mesh (1, 2) over cpu" in p.stdout, p.stdout
    got = {int(s): float(v) for s, v in
           re.findall(r"step=\s*(\d+) loss=\s*([\d.]+)", p.stdout)}
    assert set(got) == {0, 5}, p.stdout
    for step, loss in got.items():
        assert loss == pytest.approx(want[step], rel=1e-3), (step, loss)


def test_torchrun_refuses_what_is_not_ported_on_a_mesh(tmp_path):
    """``--micro-steps`` is ported on a mesh (the reference's
    micro-batches, row blocks of the global batch): the accumulated run,
    bf16-compressed, follows the one-process driver's."""
    from repro_torch.launch import train
    flags = ["--micro-steps", "2", "--grad-compress"]
    want = train.main(ARGS + flags + ["--ckpt-dir", str(tmp_path / "ck")])
    p = torchrun(*flags)
    assert p.returncode == 0, p.stdout + p.stderr[-3000:]
    assert "not ported on a mesh" not in p.stdout + p.stderr
    got = {int(s): float(v) for s, v in
           re.findall(r"step=\s*(\d+) loss=\s*([\d.]+)", p.stdout)}
    assert set(got) == {0, 5}, p.stdout
    for step, loss in got.items():
        assert loss == pytest.approx(want[step], rel=1e-3), (step, loss)


def test_torchrun_refuses_checkpoints_on_a_mesh():
    """Checkpoints are ported on a mesh; ``--virtualized`` (the
    reference's trains a (1, 1) slice whatever the mesh, which the
    one-process driver does) is refused there, with its reason."""
    p = torchrun("--virtualized")
    assert p.returncode != 0
    assert "--virtualized: not ported on a mesh (the reference's trains " \
        "a (1, 1) slice" in p.stdout + p.stderr
