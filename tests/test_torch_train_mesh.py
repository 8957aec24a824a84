"""The train driver under ``torchrun`` on two CPU ranks: the reference's
``(1, world)`` mesh, the mesh step builder, the same pipeline batches;
its losses against the one-process driver's (reduced qwen, bf16 compute:
the model axis sums partial products rounded to bf16, so within 1e-3
relative), and the flags that are not ported on a mesh refused
(checkpoints among them)."""
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


def test_torchrun_refuses_what_is_not_ported_on_a_mesh():
    p = torchrun("--micro-steps", "2")
    assert p.returncode != 0
    assert "--micro-steps: not ported on a mesh" in p.stdout + p.stderr


def test_torchrun_refuses_checkpoints_on_a_mesh():
    p = torchrun("--ckpt-dir", "ck", "--ckpt-every", "2")
    assert p.returncode != 0
    assert "--ckpt-dir, --ckpt-every: not ported on a mesh" in \
        p.stdout + p.stderr
