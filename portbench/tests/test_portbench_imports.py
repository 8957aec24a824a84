"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program."""
import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_no_jax_or_jax_package_by_top_level_name():
    bad = {(str(p.relative_to(BENCH)), m) for p in sources()
           for m in imported(p) if m.split(".")[0] in FORBIDDEN}
    assert not bad, bad
    assert sources(), "no sources found"


def test_reference_takes_nothing_of_the_program():
    ref = [p for p in sources() if "reference" in p.parts]
    assert ref
    bad = {(p.name, m) for p in ref for m in imported(p)
           if m.split(".")[0] == "repro_torch"}
    assert not bad, bad


def test_harness_reads_nothing_of_the_jax_benchmarks():
    for p in sources():
        assert "benchmarks/" not in p.read_text().replace(
            "portbench/", ""), p
