"""The mesh step builders on 4 CPU ranks against the reference's sharded
steps and the port's one-device steps, for reduced
rwkv6-7b (WKV heads over "model"; on (1, 4) a channel block cuts a head, so the WKV runs on every head). The harness, the steps and the tolerances are
those of ``tests/test_torch_sharded_steps.py``."""
import pytest

import test_torch_sharded_steps as base

ARCH = "rwkv6-7b"
IDS = [f"{m[0]}x{m[1]}" for m in base.MESHES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return base.run_all((ARCH,), str(tmp_path_factory.mktemp("sharded")))[ARCH]


@pytest.mark.parametrize("mesh", base.MESHES, ids=IDS)
def test_prefill_equals_reference(runs, mesh):
    base.check_prefill(runs["port"][mesh], runs["ref"][mesh], ARCH, 2e-5,
                       True)


@pytest.mark.parametrize("mesh", base.MESHES, ids=IDS)
def test_prefill_equals_one_device(runs, mesh):
    base.check_prefill(runs["port"][mesh], runs["one"], ARCH, 1e-5, False)


@pytest.mark.parametrize("mesh", base.MESHES, ids=IDS)
def test_decode_equals_reference(runs, mesh):
    base.check_decode(runs["port"][mesh], runs["ref"][mesh], ARCH, 2e-5,
                      True)


@pytest.mark.parametrize("mesh", base.MESHES, ids=IDS)
def test_decode_equals_one_device(runs, mesh):
    base.check_decode(runs["port"][mesh], runs["one"], ARCH, 1e-5, False)


@pytest.mark.parametrize("mesh", base.MESHES, ids=IDS)
def test_train_equals_reference(runs, mesh):
    base.check_train(runs["port"][mesh], runs["ref"][mesh],
                     runs["start"], 2e-5, True)


@pytest.mark.parametrize("mesh", base.MESHES, ids=IDS)
def test_train_equals_one_device(runs, mesh):
    base.check_train(runs["port"][mesh], runs["one"], runs["start"],
                     1e-5, False)


@pytest.mark.parametrize("mesh", base.MESHES, ids=IDS)
def test_resident_parameter_bytes_are_the_rules_share(runs, mesh):
    base.check_bytes(runs, mesh)
