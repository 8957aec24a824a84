"""Isolation auditing — the record-keeping half of the paper's criterion.

Enforcement lives where the checks are cheap and mandatory (MMU ownership/
quota/bounds, reconfig slice-binding); the auditor centralizes every denied
operation so tests and the criteria report can assert on them.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List


@dataclass
class Violation:
    kind: str
    actor: str
    detail: dict
    ts: float = field(default_factory=time.time)


class IsolationAuditor:
    def __init__(self):
        self.violations: List[Violation] = []
        self._lock = threading.Lock()

    def record(self, kind: str, actor: str, detail: dict):
        with self._lock:
            self.violations.append(Violation(kind, actor, detail))

    def count(self, kind=None, actor=None) -> int:
        with self._lock:
            return sum(1 for v in self.violations
                       if (kind is None or v.kind == kind)
                       and (actor is None or v.actor == actor))

    def summary(self) -> dict:
        with self._lock:
            out: dict = {}
            for v in self.violations:
                out[v.kind] = out.get(v.kind, 0) + 1
            return out
