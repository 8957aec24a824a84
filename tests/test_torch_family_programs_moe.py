"""The VMM's programs of mixtral-8x7b and kimi-k2 (gather MoE),
internvl2-2b (with ``patches``) and whisper-medium (with ``frames``),
built by the port's and the reference's ``CompileService`` and held to
each other as ``tests/test_torch_family_programs.py`` holds the dense
families (its checks, fixtures and tolerances)."""
import pytest

from test_torch_family_programs import (check_serving_programs,
                                        check_train_program, serve_vmms,
                                        train_vmms)

FAMILIES = ["mixtral-8x7b", "kimi-k2-1t-a32b", "internvl2-2b",
            "whisper-medium"]
__all__ = ["serve_vmms", "train_vmms"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_serving_programs_match_reference(serve_vmms, arch):
    check_serving_programs(serve_vmms, arch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_program_matches_reference(train_vmms, arch):
    check_train_program(train_vmms, arch)
