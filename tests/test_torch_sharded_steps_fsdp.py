"""ZeRO-3 on a mesh: ``fsdp_params`` (with ``fsdp_min_size`` 1, so every
leaf the rules allow takes it) splits the d_model rows and columns of
the parameters over "data" as well; the mesh builders gather each
layer's leaves over "data" where the layer runs (a reduce-scatter in the
backward). Reduced qwen1.5-0.5b and kimi-k2 (its dense first layer, the
gather MoE with a shared expert) in fp32 on a (2, 2) mesh of 4 gloo
ranks against the reference's sharded steps with the same profile and
the port's one-device steps; the harness, the steps and the tolerances
are those of ``tests/test_torch_sharded_steps.py``."""
import pytest

import test_torch_sharded_steps as base

ARCHS = ("qwen1.5-0.5b", "kimi-k2-1t-a32b")
MESH = (2, 2)
FSDP = {"fsdp_params": True, "fsdp_min_size": 1}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return base.run_all(ARCHS, str(tmp_path_factory.mktemp("fsdp")),
                        (MESH,), FSDP)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_reference(runs, arch):
    base.check_prefill(runs[arch]["port"][MESH], runs[arch]["ref"][MESH],
                       arch, 2e-5, True)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_one_device(runs, arch):
    base.check_prefill(runs[arch]["port"][MESH], runs[arch]["one"], arch,
                       1e-5, False)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_reference(runs, arch):
    base.check_decode(runs[arch]["port"][MESH], runs[arch]["ref"][MESH],
                      arch, 2e-5, True)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_one_device(runs, arch):
    base.check_decode(runs[arch]["port"][MESH], runs[arch]["one"], arch,
                      1e-5, False)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_equals_reference(runs, arch):
    base.check_train(runs[arch]["port"][MESH], runs[arch]["ref"][MESH],
                     runs[arch]["start"], 2e-5, True)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_equals_one_device(runs, arch):
    base.check_train(runs[arch]["port"][MESH], runs[arch]["one"],
                     runs[arch]["start"], 1e-5, False)


@pytest.mark.parametrize("arch", ARCHS)
def test_resident_parameter_bytes_are_the_rules_share(runs, arch):
    """With the rows over "data" too, a rank holds about a quarter."""
    base.check_bytes(runs[arch], MESH)
    serve, _ = runs[arch]["port"][MESH]["bytes"][0]
    whole = sum(t.numel() * t.element_size() for _, t in
                base.leaves(runs[arch]["one"]["params"]))
    assert serve[0] < 0.4 * whole, (serve, whole)
