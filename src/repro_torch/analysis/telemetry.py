"""Telemetry legality: metric-name consistency + golden-key producers.

Two rules, both lint-time versions of failures that today only surface
when a dashboard scrape or a schema test runs:

1. **Instrument consistency.** Every obs metric name must be created
   with one metric type and one label-key set across all instrument
   sites. The registry's get-or-create is keyed on (type, name,
   labels), so an inconsistent site silently *forks* the series —
   ``plane_ops_total{tenant}`` and ``plane_ops_total{tenant,op}`` look
   like one counter in the code and two in the scrape. Sites are calls
   to the hub conveniences (``count``/``observe``/``set_gauge``) and
   direct registry instruments (``counter``/``gauge``/``histogram``)
   with a literal name; ``**labels`` pass-throughs are recorded but
   exempt from label comparison.

2. **Golden producers.** Every key pinned by a golden set in
   ``tests/test_stats_schema.py`` (``*_KEYS`` / ``*_FIELDS`` module
   constants) must have a producer in the analyzed tree — a dict-literal
   key or a dataclass field. A golden key with no producer is schema
   drift caught at lint time instead of test time.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.common import Finding, Project, SourceModule

# call attr -> metric type
_HUB_KINDS = {"count": "counter", "observe": "histogram",
              "set_gauge": "gauge"}
_REGISTRY_KINDS = {"counter": "counter", "gauge": "gauge",
                   "histogram": "histogram"}
# golden keys produced dynamically (reviewed by hand): percentile keys
# are built as f"p{q}" in the histogram summary and the op-log rollup
DYNAMIC_PRODUCERS = {"p50", "p95", "p99", "p50_ms", "p95_ms"}


@dataclass
class Site:
    path: str
    line: int
    kind: str
    labels: Optional[Tuple[str, ...]]   # None = **labels pass-through


def run(project: Project, schema_test_path: Optional[str] = None) \
        -> Tuple[List[Finding], Dict[str, dict]]:
    findings: List[Finding] = []
    sites = _collect_sites(project)

    for name, ss in sorted(sites.items()):
        kinds = sorted({s.kind for s in ss})
        if len(kinds) > 1:
            where = "; ".join(f"{s.path}:{s.line}={s.kind}" for s in ss)
            findings.append(Finding(
                "metric-type", ss[0].path, ss[0].line,
                f"metric '{name}' instrumented as {kinds} ({where})"))
        label_sets = sorted({s.labels for s in ss
                             if s.labels is not None})
        if len(label_sets) > 1:
            where = "; ".join(
                f"{s.path}:{s.line}={{{','.join(s.labels)}}}"
                for s in ss if s.labels is not None)
            findings.append(Finding(
                "metric-labels", ss[0].path, ss[0].line,
                f"metric '{name}' has inconsistent label sets "
                f"{['{' + ','.join(l) + '}' for l in label_sets]} "
                f"({where})"))

    if schema_test_path is not None:
        findings.extend(_check_goldens(project, schema_test_path))

    summary = {name: {"kinds": sorted({s.kind for s in ss}),
                      "labels": sorted({",".join(s.labels)
                                        for s in ss
                                        if s.labels is not None}),
                      "sites": len(ss)}
               for name, ss in sorted(sites.items())}
    return findings, summary


_HUB_RECEIVERS = {"obs", "hub"}
_REGISTRY_RECEIVERS = {"metrics", "registry", "_registry", "reg"}


def _receiver_names(expr: ast.AST) -> Set[str]:
    return {n.attr if isinstance(n, ast.Attribute) else n.id
            for n in ast.walk(expr)
            if isinstance(n, (ast.Attribute, ast.Name))}


def _collect_sites(project: Project) -> Dict[str, List[Site]]:
    sites: Dict[str, List[Site]] = {}
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            kind = _HUB_KINDS.get(attr) or _REGISTRY_KINDS.get(attr)
            if kind is None:
                continue
            want = _HUB_RECEIVERS if attr in _HUB_KINDS \
                else _REGISTRY_RECEIVERS
            if not (_receiver_names(node.func.value) & want):
                continue
            if not (node.args and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            name = node.args[0].value
            if any(isinstance(k, ast.keyword) and k.arg is None
                   for k in node.keywords):
                labels: Optional[Tuple[str, ...]] = None
            else:
                labels = tuple(sorted(k.arg for k in node.keywords))
            sites.setdefault(name, []).append(
                Site(mod.relpath, node.lineno, kind, labels))
    return sites


def _check_goldens(project: Project, schema_test_path: str) \
        -> List[Finding]:
    findings: List[Finding] = []
    try:
        test_mod = SourceModule(schema_test_path, schema_test_path)
    except (OSError, SyntaxError) as exc:
        return [Finding("telemetry", schema_test_path, 0,
                        f"cannot parse schema goldens: {exc}")]
    goldens: Dict[str, Tuple[Set[str], int]] = {}
    for node in test_mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            gname = node.targets[0].id
            if not (gname.endswith("_KEYS") or gname.endswith("_FIELDS")):
                continue
            if isinstance(node.value, ast.Set):
                keys = {e.value for e in node.value.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)}
                goldens[gname] = (keys, node.lineno)
    universe = _producer_universe(project)
    for gname, (keys, line) in sorted(goldens.items()):
        missing = sorted(keys - universe - DYNAMIC_PRODUCERS)
        if missing:
            findings.append(Finding(
                "golden-producer", schema_test_path, line,
                f"{gname} pins keys with no producer in src/repro: "
                f"{missing}"))
    return findings


def _producer_universe(project: Project) -> Set[str]:
    """Every string a stats dict/dataclass in the analyzed tree can emit:
    dict literal keys, dataclass field names, and literal subscript-store
    keys (``snap["x"] = ...``)."""
    out: Set[str] = set()
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Dict):
                for k in node.keys:
                    if isinstance(k, ast.Constant) and \
                            isinstance(k.value, str):
                        out.add(k.value)
            elif isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Store) and \
                    isinstance(node.slice, ast.Constant) and \
                    isinstance(node.slice.value, str):
                out.add(node.slice.value)
            elif isinstance(node, ast.ClassDef):
                if any((isinstance(d, ast.Name) and d.id == "dataclass")
                       or (isinstance(d, ast.Call)
                           and isinstance(d.func, ast.Name)
                           and d.func.id == "dataclass")
                       for d in node.decorator_list):
                    for item in node.body:
                        if isinstance(item, ast.AnnAssign) and \
                                isinstance(item.target, ast.Name):
                            out.add(item.target.id)
    return out
