"""The five virtualization criteria (paper §III-A), made measurable.

`report(vmm, perf_ratio=…)` renders a CriteriaReport from a live VMM plus
benchmark results; used by benchmarks/criteria_report.py and the
integration tests.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

MMD_OPERATORS = ("open", "close", "read", "write", "get_info", "set_irq",
                 "set_status", "reprogram")


@dataclass
class CriteriaReport:
    # performance: virtualized / native step time (≤ ~1.1 is "comparable")
    perf_ratio: Optional[float] = None
    # fidelity: MMD-operator surface exercised + same-artifact property
    fidelity_operator_coverage: float = 0.0
    fidelity_same_artifact: Optional[bool] = None
    # multiplexing
    tenants: int = 0
    floorplan_utilization: float = 0.0
    # isolation: denied attack attempts (enforcement is working when > 0
    # under attack tests and == 0 under benign load)
    isolation_violations: dict = field(default_factory=dict)
    # interposition
    oplog_records: int = 0
    oplog_completeness: float = 0.0
    checkpoints: int = 0
    migrations: int = 0

    def to_markdown(self) -> str:
        rows = [
            ("performance (virt/native step ratio)",
             f"{self.perf_ratio:.3f}" if self.perf_ratio else "n/a"),
            ("fidelity: operator coverage",
             f"{self.fidelity_operator_coverage:.0%}"),
            ("fidelity: same-artifact lowering",
             str(self.fidelity_same_artifact)),
            ("multiplexing: tenants", str(self.tenants)),
            ("multiplexing: floorplan utilization",
             f"{self.floorplan_utilization:.0%}"),
            ("isolation: denials by kind", str(self.isolation_violations)),
            ("interposition: op-log records", str(self.oplog_records)),
            ("interposition: data-plane completeness",
             f"{self.oplog_completeness:.0%}"),
            ("interposition: checkpoints", str(self.checkpoints)),
            ("interposition: migrations", str(self.migrations)),
        ]
        out = ["| criterion | value |", "|---|---|"]
        out += [f"| {k} | {v} |" for k, v in rows]
        return "\n".join(out)


def report(vmm, perf_ratio: Optional[float] = None,
           same_artifact: Optional[bool] = None) -> CriteriaReport:
    ops_seen = vmm.oplog.ops_seen()
    coverage = sum(1 for o in MMD_OPERATORS if o in ops_seen) / len(
        MMD_OPERATORS)
    return CriteriaReport(
        perf_ratio=perf_ratio,
        fidelity_operator_coverage=coverage,
        fidelity_same_artifact=same_artifact,
        tenants=len(vmm.tenants),
        floorplan_utilization=vmm.floorplanner.utilization(),
        isolation_violations=vmm.auditor.summary(),
        oplog_records=vmm.oplog.n_records(),
        oplog_completeness=vmm.oplog.completeness(),
        checkpoints=len(vmm.oplog.query(op="checkpoint")),
        migrations=len(vmm.oplog.query(op="migrate")),
    )
