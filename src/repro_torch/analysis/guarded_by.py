"""Guarded-by analysis: accesses to declared-guarded attributes must
happen inside ``with self.<lock>``.

For every class the pass folds the declared model over the MRO
(subclass methods are checked against base-class declarations — the
planes inherit ``DataPlane._lock``), then walks each method tracking the
set of locks held:

* ``with self._lock:`` / ``with self._cv:`` (condition aliases resolve
  to the underlying lock) / ``with self._stripes[i]:`` enter a scope;
* locals assigned from a lock attribute (``lk = self._stripes[i]``)
  count when used as ``with lk:``;
* a ``# holds: _lock`` annotation on the ``def`` line seeds the held
  set — and turns a re-acquire of that lock into a deadlock finding;
* nested functions and lambdas run later on unknown threads, so they
  are analyzed with an *empty* held set.

``__init__`` is exempt (construction happens-before publication).
Findings are waived only by ``# unguarded-ok: <reason>`` on the access.

The pass also enforces model declaration itself: any class in the
target-module list that constructs a lock must either declare at least
one guarded attribute or carry a class-level ``# concurrency:`` note —
an undeclared model is a finding, not a free pass.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.common import (
    CONCURRENCY_RE, HOLDS_RE, ClassInfo, Finding, Project, SourceModule,
    _self_attr_in,
)

# Modules (by path suffix) where every lock-constructing class must
# declare its model. Everything else is still *checked* against any
# declarations it carries.
MODEL_DECL_TARGETS = (
    "core/scheduler.py", "core/mmu.py", "core/vmm.py",
    "core/autoscaler.py", "serving/engine.py",
    "serving/model_registry.py", "serving/paged_kv.py",
    "serving/prefix_cache.py", "obs/metrics.py", "obs/trace.py",
    "obs/flight.py",
)


def run(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for mod in project.modules:
        is_target = mod.relpath.replace("\\", "/").endswith(
            MODEL_DECL_TARGETS)
        for ci in mod.classes.values():
            guarded, locks, alias = project.effective_model(ci)
            if is_target and ci.lock_attrs and not ci.guarded \
                    and not guarded and ci.concurrency_note is None:
                findings.append(Finding(
                    "model-decl", mod.relpath, ci.node.lineno,
                    f"{ci.name} constructs a lock but declares no "
                    f"guarded-by attributes and no # concurrency: note"))
            if not guarded:
                continue
            for meth in ci.methods.values():
                findings.extend(_check_method(
                    project, mod, ci, meth, guarded, locks, alias))
    return findings


def _resolve(attr: str, locks: Set[str], alias: Dict[str, str]) \
        -> Optional[str]:
    seen: Set[str] = set()
    while attr in alias and attr not in seen:
        seen.add(attr)
        attr = alias[attr]
    return attr if attr in locks else None


def _holds_annotation(mod: SourceModule, meth: ast.FunctionDef,
                      locks: Set[str], alias: Dict[str, str]) -> Set[str]:
    held: Set[str] = set()
    # the annotation may sit on any line of a multi-line signature
    sig_end = meth.body[0].lineno - 1 if meth.body else meth.lineno
    for line in range(meth.lineno, max(meth.lineno, sig_end) + 1):
        m = mod.comment_match(line, HOLDS_RE)
        if m:
            for name in m.group(1).split(","):
                lk = _resolve(name.strip(), locks, alias)
                if lk:
                    held.add(lk)
    return held


def _local_lock_aliases(meth: ast.FunctionDef, locks: Set[str],
                        alias: Dict[str, str]) -> Dict[str, str]:
    """Flow-insensitive map of locals assigned from a lock attribute."""
    out: Dict[str, str] = {}
    for node in ast.walk(meth):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            attr = _self_attr_in(node.value)
            if attr:
                lk = _resolve(attr, locks, alias)
                if lk:
                    out[node.targets[0].id] = lk
        elif isinstance(node, (ast.For, ast.comprehension)):
            # ``for i, lk in enumerate(self._stripes)`` — the last
            # unpack target iterates the lock list
            it = node.iter
            if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                    and it.func.id in ("enumerate", "zip") and it.args:
                it = it.args[-1]
            attr = _self_attr_in(it)
            if attr:
                lk = _resolve(attr, locks, alias)
                if lk:
                    tgt = node.target
                    if isinstance(tgt, ast.Tuple) and tgt.elts:
                        tgt = tgt.elts[-1]
                    if isinstance(tgt, ast.Name):
                        out[tgt.id] = lk
    return out


def _check_method(project: Project, mod: SourceModule, ci: ClassInfo,
                  meth: ast.FunctionDef, guarded: Dict[str, str],
                  locks: Set[str], alias: Dict[str, str]) -> List[Finding]:
    if meth.name == "__init__":
        return []
    findings: List[Finding] = []
    local_locks = _local_lock_aliases(meth, locks, alias)
    seed = _holds_annotation(mod, meth, locks, alias)

    def lock_of(expr: ast.AST) -> Optional[str]:
        attr = _self_attr_in(expr)
        if attr:
            return _resolve(attr, locks, alias)
        if isinstance(expr, ast.Name):
            return local_locks.get(expr.id)
        return None

    def visit(node: ast.AST, held: Set[str], stmt_line: int):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # deferred execution: no lock context survives the call site
            body = node.body if isinstance(node.body, list) \
                else [node.body]
            for child in body:
                visit(child, set(), getattr(child, "lineno", stmt_line))
            return
        if isinstance(node, ast.With):
            inner = set(held)
            for item in node.items:
                lk = lock_of(item.context_expr)
                if lk:
                    if lk in held and not mod.waiver(node.lineno):
                        findings.append(Finding(
                            "lock-reacquire", mod.relpath, node.lineno,
                            f"{ci.name}.{meth.name} re-acquires "
                            f"non-reentrant {lk} already held here "
                            f"(self-deadlock)"))
                    inner.add(lk)
                visit(item.context_expr, held, node.lineno)
            for child in node.body:
                visit(child, inner, getattr(child, "lineno", node.lineno))
            return
        line = getattr(node, "lineno", stmt_line)
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self" and node.attr in guarded:
            need = _resolve(guarded[node.attr], locks, alias) \
                or guarded[node.attr]
            if need not in held:
                reason = mod.waiver(line,
                                    getattr(node, "end_lineno", line)) \
                    or mod.waiver(stmt_line)
                if reason is None:
                    mode = "write" if isinstance(
                        node.ctx, (ast.Store, ast.Del)) else "read"
                    findings.append(Finding(
                        "guarded-by", mod.relpath, line,
                        f"{ci.name}.{meth.name} {mode}s self."
                        f"{node.attr} (guarded by {need}) without "
                        f"holding it"))
        for child in ast.iter_child_nodes(node):
            new_stmt = child.lineno if isinstance(child, ast.stmt) \
                else stmt_line
            visit(child, held, new_stmt)

    for stmt in meth.body:
        visit(stmt, set(seed), stmt.lineno)
    return findings


def declared_models(project: Project) -> Dict[str, dict]:
    """JSON-able summary of every declared concurrency model."""
    out: Dict[str, dict] = {}
    for mod in project.modules:
        for ci in mod.classes.values():
            if not (ci.guarded or ci.concurrency_note):
                continue
            out[ci.name] = {
                "path": mod.relpath,
                "guarded": dict(sorted(ci.guarded.items())),
                "locks": sorted(ci.lock_attrs),
                "condition_aliases": dict(sorted(ci.cond_alias.items())),
                "concurrency": ci.concurrency_note,
            }
    return out
