"""The two virtualization examples under ``torchrun`` with 4 CPU ranks:
a (2, 2) pod mesh, (1, 2) slices (the reference's 2×4 grid and (1, 4)
slices, halved). The multi-tenant example serves alice on ranks 0 and 1
and bob on ranks 2 and 3, each tenant's logits equal to its program
built natively on the slice's mesh, the cross-slice attack denied; the
failover example's 18 losses equal an uninterrupted run on meshes of the
same ranks bit for bit, after a migration and the grow to the pod."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def torchrun(example, *extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", os.path.join(ROOT, "examples", example),
         "--device", "cpu", *extra], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)


@pytest.fixture(scope="module")
def outputs():
    procs = {"mux": torchrun("torch_multi_tenant_serving.py"),
             "failover": torchrun("torch_elastic_failover.py")}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        out[name] = (p.returncode, stdout, stderr)
    return out


def test_multi_tenant_example_on_a_pod_mesh(outputs):
    rc, out, err = outputs["mux"]
    assert rc == 0, out + err[-3000:]
    assert "ranks: {'alice': (0, 1), 'bob': (2, 3)}" in out, out
    for name, at, ranks in (("alice", "(0, 0)", "(0, 1)"),
                            ("bob", "(1, 0)", "(2, 3)")):
        assert (f"[{name}] served 6 tokens" in out
                and f"on slice (1, 2) at {at}, ranks {ranks}" in out), out
    assert out.count("equal to the program built natively on the slice's "
                     "mesh bit for bit") == 2, out
    assert "cross-slice reprogram denied" in out
    assert "compile cache: hits=1 misses=2" in out


def test_failover_example_on_a_pod_mesh(outputs):
    rc, out, err = outputs["failover"]
    assert rc == 0, out + err[-3000:]
    assert "[phase1] 6 steps on slice (0, 0), ranks (0, 1)" in out, out
    assert "migrated to (0, 0), ranks (0, 1)" in out, out
    assert "[elastic] grown to (2, 2): ranks (0, 1, 2, 3)" in out, out
    assert "compile cache: hits=1 misses=2" in out
    assert "[fidelity] 18 losses equal to an uninterrupted run on meshes " \
        "of the same ranks bit for bit" in out, out
