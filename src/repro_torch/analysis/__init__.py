"""Concurrency legality suite (static passes + runtime lock watchdog) —
the PyTorch package's copy of ``repro.analysis``.

``python -m repro_torch.analysis`` runs the three static passes —
guarded-by, lock-order, telemetry legality — over ``src/repro_torch``
and prints the report (``--json PATH`` writes it; never over the
committed ``ANALYSIS.json``, which is the reference package's). The
runtime counterpart is :mod:`repro_torch.analysis.lock_watchdog`
(``REPRO_LOCK_WATCHDOG=1``).
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

from repro_torch.analysis.common import Finding, Project
from repro_torch.analysis import guarded_by, lock_order, telemetry

__all__ = ["Finding", "Project", "run_all"]


def default_src_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_all(src_root: Optional[str] = None,
            schema_test_path: Optional[str] = None) \
        -> Tuple[List[Finding], dict]:
    """Run every static pass; returns (findings, report-dict). The
    golden-producer pass reads ``tests/test_stats_schema.py`` beside the
    source root's ``src/`` (as text: nothing imports it) unless
    ``schema_test_path`` names another file."""
    root = src_root or default_src_root()
    project = Project(root)
    findings: List[Finding] = []
    gb = guarded_by.run(project)
    findings.extend(gb)
    lo, graph = lock_order.run(project)
    findings.extend(lo)
    if schema_test_path is None:
        cand = os.path.join(os.path.dirname(os.path.dirname(root)),
                            "tests", "test_stats_schema.py")
        schema_test_path = cand if os.path.exists(cand) else None
    tl, metric_summary = telemetry.run(project, schema_test_path)
    findings.extend(tl)
    report = {
        "findings": [f.as_dict() for f in findings],
        "counts": _counts(findings),
        "declared_models": guarded_by.declared_models(project),
        "lock_order_edges": graph.as_dict(),
        "metrics": metric_summary,
    }
    return findings, report


def _counts(findings: List[Finding]) -> dict:
    out: dict = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return out
