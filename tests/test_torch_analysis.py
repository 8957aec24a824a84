"""The port's static concurrency checker (``repro_torch.analysis``)
against the reference's (``repro.analysis``).

* every rule case of ``tests/test_analysis.py`` — a seeded violation
  and its disciplined twin — as one parametrised test: the same fixture
  tree goes through both checkers' pass, and the findings (and, for the
  lock-order pass, the graph; for telemetry, the metric summary) are
  equal and are the rules the case expects;
* ``run_all`` over ``src/repro_torch`` and over ``src/repro`` gives the
  reference's report, with 0 findings on the port;
* the CLI checks ``src/repro_torch`` by default and leaves the committed
  ``ANALYSIS.json`` (the reference's report) as it is.

Stdlib ``ast``/``tokenize`` only: each case takes well under a second.
"""
import hashlib
import os
import subprocess
import sys
import textwrap

import pytest

import repro.analysis as ref_analysis
import repro_torch.analysis as port_analysis
from repro.analysis import common as ref_common
from repro.analysis import guarded_by as ref_guarded_by
from repro.analysis import lock_order as ref_lock_order
from repro.analysis import telemetry as ref_telemetry
from repro_torch.analysis import common as port_common
from repro_torch.analysis import guarded_by as port_guarded_by
from repro_torch.analysis import lock_order as port_lock_order
from repro_torch.analysis import telemetry as port_telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SRC = os.path.join(REPO, "src", "repro_torch")
REF_SRC = os.path.join(REPO, "src", "repro")

CHECKERS = {
    "reference": (ref_common.Project, ref_guarded_by, ref_lock_order,
                  ref_telemetry),
    "port": (port_common.Project, port_guarded_by, port_lock_order,
             port_telemetry),
}

GUARDED_BAD = """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._x = 0          # guarded-by: _lock

        def bump(self):
            self._x += 1         # WRONG: no lock held

        def ok(self):
            with self._lock:
                return self._x
"""

UNDECLARED = """
    import threading

    class Plane:
        def __init__(self):
            self._lock = threading.Lock()
            self._q = []

        def put(self, x):
            with self._lock:
                self._q.append(x)
"""

AB_NESTING = """
    import threading

    class AB:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def fwd(self):
            with self._a:
                with self._b:
                    pass

        def {second}(self):
            with self.{outer}:
                with self.{inner}:
                    pass
"""

#: (case id, pass, {relpath: source}, schema-test text or None, the
#: rules the findings carry, each once) — the cases of
#: ``tests/test_analysis.py``
CASES = [
    ("guarded_by_unlocked_access", "guarded_by",
     {"mod.py": GUARDED_BAD}, None, ["guarded-by"]),
    ("guarded_by_clean", "guarded_by",
     {"mod.py": GUARDED_BAD.replace(
         "self._x += 1         # WRONG: no lock held",
         "with self._lock:\n                self._x += 1")}, None, []),
    ("unguarded_ok_waiver", "guarded_by",
     {"mod.py": GUARDED_BAD.replace(
         "# WRONG: no lock held",
         "# unguarded-ok: single-writer counter, test-only")}, None, []),
    ("condition_alias", "guarded_by", {"mod.py": """
        import threading

        class Q:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition(self._lock)
                self._q = []     # guarded-by: _lock

            def put(self, x):
                with self._cv:   # alias of _lock
                    self._q.append(x)
                    self._cv.notify()
    """}, None, []),
    ("nested_function_loses_lock", "guarded_by", {"mod.py": """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._x = 0      # guarded-by: _lock

            def deferred(self):
                with self._lock:
                    def cb():
                        return self._x
                    return cb
    """}, None, ["guarded-by"]),
    ("holds_seeds_held_set", "guarded_by", {"mod.py": """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._x = 0      # guarded-by: _lock

            def _peek(self):  # holds: _lock
                return self._x

            def get(self):
                with self._lock:
                    return self._peek()
    """}, None, []),
    ("holds_reacquire", "guarded_by", {"mod.py": """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._x = 0      # guarded-by: _lock

            def _peek(self):  # holds: _lock
                with self._lock:       # WRONG: non-reentrant
                    return self._x
    """}, None, ["lock-reacquire"]),
    ("holds_multiline_signature", "guarded_by", {"mod.py": """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._x = 0      # guarded-by: _lock

            def _account(self, a, b,
                         c):  # holds: _lock
                return self._x + a + b + c
    """}, None, []),
    ("model_decl_required", "guarded_by",
     {"core/scheduler.py": UNDECLARED}, None, ["model-decl"]),
    ("model_decl_elsewhere", "guarded_by",
     {"util/helper.py": UNDECLARED}, None, []),
    ("concurrency_note", "guarded_by",
     {"core/scheduler.py": UNDECLARED.replace(
         "class Plane:",
         "class Plane:  # concurrency: single-owner, lock is belt+braces")},
     None, []),
    ("lock_order_cycle", "lock_order",
     {"mod.py": AB_NESTING.format(second="rev", outer="_b",
                                  inner="_a")},
     None, ["lock-order-cycle"]),
    ("lock_order_consistent", "lock_order",
     {"mod.py": AB_NESTING.format(second="fwd2", outer="_a",
                                  inner="_b")}, None, []),
    ("interprocedural_cycle", "lock_order", {"mod.py": """
        import threading

        class Inner:
            def __init__(self):
                self._lock = threading.Lock()

            def poke(self, outer):
                with self._lock:
                    outer.touch()

        class Outer:
            def __init__(self):
                self._lock = threading.Lock()
                self.inner = Inner()

            def touch(self):
                with self._lock:
                    pass

            def drive(self):
                with self._lock:
                    self.inner.poke(self)
    """}, None, ["lock-order-cycle"]),
    ("callback_under_lock_direct", "lock_order", {"mod.py": """
        import threading

        class Plane:
            def __init__(self, relief_cb):
                self._lock = threading.Lock()
                self.relief_cb = relief_cb

            def relieve(self):
                with self._lock:
                    self.relief_cb(1)   # WRONG: user code under lock
    """}, None, ["callback-under-lock"]),
    ("callback_under_lock_transitive", "lock_order", {"mod.py": """
        import threading

        class Plane:
            def __init__(self, relief_cb):
                self._lock = threading.Lock()
                self.relief_cb = relief_cb

            def _fire(self):
                self.relief_cb(1)

            def relieve(self):
                with self._lock:
                    self._fire()        # WRONG: reaches relief_cb
    """}, None, ["callback-under-lock"]),
    ("callback_outside_lock", "lock_order", {"mod.py": """
        import threading

        class Plane:
            def __init__(self, relief_cb):
                self._lock = threading.Lock()
                self.relief_cb = relief_cb
                self.fired = 0           # guarded-by: _lock

            def relieve(self):
                with self._lock:
                    self.fired += 1
                self.relief_cb(1)        # hoisted out: legal
    """}, None, []),
    ("callback_table_taint", "lock_order", {"mod.py": """
        import threading

        class CQ:
            def __init__(self):
                self._lock = threading.Lock()
                self.handlers = {}

            def deliver(self, ev):
                with self._lock:
                    h = self.handlers[ev.source]
                    h(ev)               # WRONG: tainted call under lock
    """}, None, ["callback-under-lock"]),
    ("metric_type_conflict", "telemetry", {"mod.py": """
        def f(obs):
            obs.count("x_total", 1, tenant="a")

        def g(obs):
            obs.observe("x_total", 0.5, tenant="a")   # WRONG: forks type
    """}, None, ["metric-type"]),
    ("metric_label_conflict", "telemetry", {"mod.py": """
        def f(obs):
            obs.count("y_total", 1, tenant="a")

        def g(obs):
            obs.count("y_total", 1, tenant="a", op="r")  # WRONG: forks
    """}, None, ["metric-labels"]),
    ("metric_consistent_sites", "telemetry", {"mod.py": """
        def f(obs):
            obs.count("z_total", 1, tenant="a")

        def g(obs):
            obs.count("z_total", 2, tenant="b")
    """}, None, []),
    ("golden_producer_missing", "telemetry", {"mod.py": """
        def stats():
            return {"present_key": 1}
    """}, 'FOO_KEYS = {"present_key", "missing_key"}\n',
     ["golden-producer"]),
    ("golden_producer_satisfied", "telemetry", {"mod.py": """
        from dataclasses import dataclass

        @dataclass
        class S:
            field_key: int = 0

        def stats(out):
            out["stored_key"] = 2
            return {"present_key": 1}
    """}, 'FOO_KEYS = {"present_key", "stored_key", "field_key"}\n', []),
]


def _write_fixture(root, files):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def _run_pass(checker, which, root, schema):
    """→ (finding dicts, the pass's other output as plain data)."""
    project_cls, guarded_by, lock_order, telemetry = CHECKERS[checker]
    project = project_cls(str(root))
    if which == "guarded_by":
        findings, extra = guarded_by.run(project), \
            guarded_by.declared_models(project)
    elif which == "lock_order":
        findings, graph = lock_order.run(project)
        extra = graph.as_dict()
    else:
        findings, extra = telemetry.run(project, schema)
    return [f.as_dict() for f in findings], extra


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_rule_case_matches_the_reference(tmp_path, case):
    _, which, files, schema_text, want_rules = case
    root = tmp_path / "fixtures"
    _write_fixture(root, files)
    schema = None
    if schema_text is not None:
        schema = str(tmp_path / "schema_test.py")
        with open(schema, "w", encoding="utf-8") as f:
            f.write(schema_text)
    ref = _run_pass("reference", which, root, schema)
    port = _run_pass("port", which, root, schema)
    assert port == ref
    assert sorted({f["rule"] for f in port[0]}) == want_rules


def test_run_all_over_the_port_is_the_references_with_no_finding():
    findings, report = port_analysis.run_all(PORT_SRC)
    _, ref_report = ref_analysis.run_all(PORT_SRC)
    assert report == ref_report
    assert findings == [], "\n".join(str(f) for f in findings)
    assert report["counts"] == {}
    # the port's lock-bearing classes declare their model as the
    # reference's do, and its lock-order graph is a DAG with the
    # reference's documented plane → pool nesting
    for cls in ("DataPlane", "SegmentPool", "ModelRegistry", "Autoscaler"):
        assert cls in report["declared_models"]
    edges = {tuple(e.split(" -> ")) for e in report["lock_order_edges"]}
    assert ("DataPlane._lock", "SegmentPool._lock") in edges
    assert all(a != b for a, b in edges)


def test_default_root_is_the_port_and_finds_the_schema_test():
    assert os.path.realpath(port_analysis.default_src_root()) == \
        os.path.realpath(PORT_SRC)
    # the golden-producer pass reads tests/test_stats_schema.py by
    # default: naming it gives the same report
    _, default = port_analysis.run_all()
    _, named = port_analysis.run_all(
        PORT_SRC, os.path.join(REPO, "tests", "test_stats_schema.py"))
    assert default == named


def test_run_all_over_the_reference_is_the_references():
    findings, report = port_analysis.run_all(REF_SRC)
    ref_findings, ref_report = ref_analysis.run_all(REF_SRC)
    assert report == ref_report
    assert [f.as_dict() for f in findings] == \
        [f.as_dict() for f in ref_findings]


def _md5(path):
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


def test_cli_checks_the_port_and_leaves_analysis_json(tmp_path):
    committed = os.path.join(REPO, "ANALYSIS.json")
    before = _md5(committed)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out_json = tmp_path / "analysis.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--json",
         str(out_json)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert f"analyzed {PORT_SRC}:" in run.stdout
    assert "legality: OK (0 findings)" in run.stdout
    assert out_json.exists()
    refused = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--json",
         "ANALYSIS.json"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert refused.returncode == 2
    assert "reference package's report" in refused.stderr
    assert _md5(committed) == before
