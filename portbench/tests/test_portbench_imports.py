"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program: neither ``reference/``
nor the reference layers of the architecture families, whose only look
at the program is the widths check (``check_port``)."""
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


def test_families_look_at_the_program_only_to_check_widths():
    archs = [p for p in sources() if "archs" in p.parts]
    assert archs
    for p in archs:
        tree = ast.parse(p.read_text())
        allowed = {id(n) for f in ast.walk(tree)
                   if isinstance(f, ast.FunctionDef) and f.name == "check_port"
                   for n in ast.walk(f)}
        bad = [(p.name, node.lineno) for node in ast.walk(tree)
               if isinstance(node, (ast.Import, ast.ImportFrom))
               and id(node) not in allowed
               and any(m.split(".")[0] == "repro_torch"
                       for m in ([a.name for a in node.names]
                                 if isinstance(node, ast.Import)
                                 else [node.module or ""]))]
        assert not bad, bad
