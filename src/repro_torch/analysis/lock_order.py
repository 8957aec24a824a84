"""Lock-order graph: cross-class acquisition DAG + callbacks-under-lock.

The pass summarizes every method (which locks it acquires, which calls
it makes and under which held locks), then:

1. resolves calls interprocedurally — ``self.m()`` through the MRO and
   subclass overrides, ``x.m()`` by name against every analyzed class
   (a deliberate over-approximation: a false edge is reviewable, a
   missed edge is a latent deadlock);
2. computes the transitive *may-acquire* set per method to a fixed
   point (recursion-safe), and emits an edge ``A -> B`` whenever lock B
   can be acquired while A is held;
3. fails on any cycle in the resulting graph (including self-edges:
   re-acquiring a non-reentrant lock) with a witness site per edge;
4. flags **user callbacks invoked under a lock** — the re-entrancy
   deadlock this codebase's hook style invites. Callback sites are
   calls through hook attributes (``relief_cb``, ``swap_cb``,
   ``admission_gate``, ``work``, IRQ ``raise_event``), future
   resolution (``set_result``/``set_exception`` wake arbitrary
   waiters/done-callbacks), and values tainted from callback tables
   (``handlers``, ``_providers``). The check is transitive: calling a
   method that *may* reach a callback while holding a lock is flagged
   at the call site.

Waive a reviewed site with ``# unguarded-ok: <reason>``.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from repro_torch.analysis.common import (
    ClassInfo, Finding, Project, SourceModule, _self_attr_in,
)

# Hook attributes whose call is a user callback (re-entrancy hazard
# under any held lock).
CALLBACK_ATTRS = {"relief_cb", "swap_cb", "admission_gate", "work",
                  "raise_event", "set_result", "set_exception"}
# Attributes holding tables of user callbacks; values read from them
# (directly or via locals) are tainted.
CALLBACK_SOURCES = {"handlers", "_providers"}


@dataclass
class _Call:
    kind: str                  # "self" | "other" | "local" | "callback"
    name: str
    held: FrozenSet[str]
    line: int
    # receiver type candidates: None = unknown (fall back to name-based
    # resolution); a set = only these classes (possibly none analyzed)
    recv_types: Optional[FrozenSet[str]] = None


@dataclass
class _Summary:
    key: Tuple[str, str]       # (class name or "", function name)
    mod: SourceModule
    acquires: List[Tuple[str, FrozenSet[str], int]] = \
        field(default_factory=list)
    calls: List[_Call] = field(default_factory=list)


class LockOrderGraph:
    def __init__(self):
        # edge -> one witness (path, line, description)
        self.edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}

    def add(self, a: str, b: str, path: str, line: int, why: str):
        self.edges.setdefault((a, b), (path, line, why))

    def cycles(self) -> List[List[str]]:
        adj: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            adj.setdefault(a, set()).add(b)
        out, done = [], set()
        for start in sorted(adj):
            if start in done:
                continue
            path: List[str] = []
            on_path: Set[str] = set()

            def dfs(n: str) -> Optional[List[str]]:
                if n in on_path:
                    return path[path.index(n):] + [n]
                if n in done:
                    return None
                on_path.add(n)
                path.append(n)
                for m in sorted(adj.get(n, ())):
                    cyc = dfs(m)
                    if cyc:
                        return cyc
                path.pop()
                on_path.discard(n)
                done.add(n)
                return None

            cyc = dfs(start)
            if cyc:
                out.append(cyc)
        return out

    def as_dict(self) -> dict:
        return {f"{a} -> {b}": f"{p}:{ln} ({why})"
                for (a, b), (p, ln, why) in sorted(self.edges.items())}


def run(project: Project) -> Tuple[List[Finding], LockOrderGraph]:
    summaries = _summarize(project)
    defs: Dict[str, List[Tuple[str, str]]] = {}
    subclasses: Dict[str, Set[str]] = {}
    for (cls, name) in summaries:
        defs.setdefault(name, []).append((cls, name))
    for ci in project.class_table.values():
        for b in ci.bases:
            if b in project.class_table:
                subclasses.setdefault(b, set()).add(ci.name)

    def resolve(key: Tuple[str, str], call: _Call) \
            -> List[Tuple[str, str]]:
        cls = key[0]
        if call.kind == "self" and cls:
            family = {c.name for c in
                      project.mro(project.class_table[cls])}
            stack = [cls]
            while stack:
                c = stack.pop()
                for s in subclasses.get(c, ()):
                    if s not in family:
                        family.add(s)
                        stack.append(s)
            hits = [(c, call.name) for c in sorted(family)
                    if (c, call.name) in summaries]
            if hits:
                return hits
        if call.kind == "local":
            mod_funcs = summaries.get(("", call.name))
            if mod_funcs is not None:
                return [("", call.name)]
            return []
        if call.recv_types is not None:
            hits = []
            for t in sorted(call.recv_types):
                ci = project.class_table.get(t)
                if ci is None:
                    continue            # known-foreign (stdlib etc.)
                for c in project.mro(ci):
                    if (c.name, call.name) in summaries:
                        hits.append((c.name, call.name))
                        break
                stack = [t]
                seen = {t}
                while stack:
                    c = stack.pop()
                    for s in subclasses.get(c, ()):
                        if s not in seen:
                            seen.add(s)
                            stack.append(s)
                            if (s, call.name) in summaries:
                                hits.append((s, call.name))
            return sorted(set(hits))
        return [k for k in defs.get(call.name, ()) if k in summaries]

    # ---- transitive may-acquire / may-callback fixed point -----------
    may_acquire: Dict[Tuple[str, str], Set[str]] = {
        k: {lock for lock, _h, _ln in s.acquires}
        for k, s in summaries.items()}
    may_callback: Dict[Tuple[str, str], Set[str]] = {
        k: {c.name for c in s.calls if c.kind == "callback"}
        for k, s in summaries.items()}
    changed = True
    while changed:
        changed = False
        for k, s in summaries.items():
            for call in s.calls:
                for tgt in resolve(k, call):
                    if not may_acquire[k] >= may_acquire[tgt]:
                        may_acquire[k] |= may_acquire[tgt]
                        changed = True
                    if not may_callback[k] >= may_callback[tgt]:
                        may_callback[k] |= may_callback[tgt]
                        changed = True

    # ---- edges + callback findings -----------------------------------
    graph = LockOrderGraph()
    findings: List[Finding] = []
    for k, s in summaries.items():
        who = f"{k[0]}.{k[1]}" if k[0] else k[1]
        for lock, held, line in s.acquires:
            for h in held:
                graph.add(h, lock, s.mod.relpath, line,
                          f"{who} acquires {lock} holding {h}")
        for call in s.calls:
            if not call.held:
                continue
            waived = s.mod.waiver(call.line)
            if call.kind == "callback":
                if not waived:
                    findings.append(Finding(
                        "callback-under-lock", s.mod.relpath, call.line,
                        f"{who} invokes user callback '{call.name}' "
                        f"while holding {sorted(call.held)}"))
                continue
            for tgt in resolve(k, call):
                for lock in may_acquire[tgt]:
                    for h in call.held:
                        graph.add(h, lock, s.mod.relpath, call.line,
                                  f"{who} -> {tgt[0]}.{tgt[1]}")
                cbs = may_callback[tgt]
                if cbs and not waived:
                    findings.append(Finding(
                        "callback-under-lock", s.mod.relpath, call.line,
                        f"{who} holds {sorted(call.held)} across "
                        f"{tgt[0]}.{tgt[1]}, which may invoke user "
                        f"callback(s) {sorted(cbs)}"))
    for cyc in graph.cycles():
        sites = "; ".join(
            f"{a}->{b} at {graph.edges[(a, b)][0]}:{graph.edges[(a, b)][1]}"
            for a, b in zip(cyc, cyc[1:]))
        findings.append(Finding(
            "lock-order-cycle", "(graph)", 0,
            f"lock-acquisition cycle {' -> '.join(cyc)} [{sites}]"))
    return findings, graph


# ---------------------------------------------------------------------------
# per-method summaries
# ---------------------------------------------------------------------------

def _summarize(project: Project) -> Dict[Tuple[str, str], _Summary]:
    out: Dict[Tuple[str, str], _Summary] = {}
    for mod in project.modules:
        for fn in mod.functions.values():
            s = _Summary(("", fn.name), mod)
            _walk_function(project, mod, None, fn, s)
            out[s.key] = s
        for ci in mod.classes.values():
            for meth in ci.methods.values():
                s = _Summary((ci.name, meth.name), mod)
                _walk_function(project, mod, ci, meth, s)
                out[s.key] = s
    return out


def _walk_function(project: Project, mod: SourceModule,
                   ci: Optional[ClassInfo], meth: ast.FunctionDef,
                   s: _Summary):
    guarded, locks, alias = (project.effective_model(ci)
                             if ci is not None else ({}, set(), {}))

    def canon(attr: str) -> Optional[str]:
        seen: Set[str] = set()
        while attr in alias and attr not in seen:
            seen.add(attr)
            attr = alias[attr]
        if attr in locks and ci is not None:
            return project.lock_owner(ci, attr)
        return None

    def self_elem_types(expr: ast.AST) -> Optional[Set[str]]:
        """Element types when ``expr`` reads from an annotated container:
        ``self.X[k]``, ``self.X.get(k)``, ``self.X.pop(k)``."""
        if ci is None:
            return None
        target = None
        if isinstance(expr, ast.Subscript):
            target = expr.value
        elif isinstance(expr, ast.Call) and \
                isinstance(expr.func, ast.Attribute) and \
                expr.func.attr in ("get", "pop"):
            target = expr.func.value
        attr = _self_attr_in(target) if target is not None else None
        if attr is None:
            return None
        for c in project.mro(ci):
            if attr in c.attr_elem_types:
                return set(c.attr_elem_types[attr])
        return None

    def iter_elem_types(it: ast.AST) -> Optional[Set[str]]:
        """Element types of a loop iterable over an annotated container
        (``self.X``, ``self.X.values()``, ``self.X.items()``)."""
        if ci is None:
            return None
        target = it
        if isinstance(it, ast.Call) and \
                isinstance(it.func, ast.Attribute) and \
                it.func.attr in ("values", "items"):
            target = it.func.value
        attr = _self_attr_in(target)
        if attr is None:
            return None
        for c in project.mro(ci):
            if attr in c.attr_elem_types:
                return set(c.attr_elem_types[attr])
        return None

    local_locks: Dict[str, str] = {}
    local_types: Dict[str, Set[str]] = {}
    tainted: Set[str] = set()

    def note_loop(target: ast.AST, it: ast.AST):
        if _tainted_expr(it, tainted):
            for t in ast.walk(target):
                if isinstance(t, ast.Name):
                    tainted.add(t.id)
        elems = iter_elem_types(it)
        if elems is not None:
            # `for v in d.values()` / `for k, v in d.items()`: the
            # value — the last unpack target — has the element type
            names = [t for t in ast.walk(target)
                     if isinstance(t, ast.Name)]
            if names:
                local_types[names[-1].id] = elems

    for node in ast.walk(meth):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            attr = _self_attr_in(node.value)
            lk = canon(attr) if attr else None
            if lk:
                local_locks[node.targets[0].id] = lk
            cands = mod.ctor_candidates(node.value)
            if cands is None:
                cands = self_elem_types(node.value)
            if cands is not None:
                local_types[node.targets[0].id] = cands
            if _tainted_expr(node.value, tainted):
                tainted.add(node.targets[0].id)
        elif isinstance(node, ast.For):
            note_loop(node.target, node.iter)
        elif isinstance(node, ast.comprehension):
            note_loop(node.target, node.iter)

    def lock_of(expr: ast.AST) -> Optional[str]:
        attr = _self_attr_in(expr)
        if attr:
            return canon(attr)
        if isinstance(expr, ast.Name):
            return local_locks.get(expr.id)
        return None

    def attr_types_of(start: Optional[ClassInfo], attr: str) \
            -> Optional[Set[str]]:
        if start is None:
            return None
        for c in project.mro(start):
            if attr in c.attr_types:
                return set(c.attr_types[attr])
        return None

    def recv_types_of(expr: ast.AST) -> Optional[FrozenSet[str]]:
        """Walk an attribute chain (``self.obs.tracer``) through the
        constructor-type map; None = unknown -> name-based fallback."""
        parts: List[str] = []
        cur = expr
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        parts.reverse()
        if isinstance(cur, ast.Name):
            if cur.id == "self":
                if not parts:
                    return frozenset({ci.name}) if ci else None
                types = attr_types_of(ci, parts[0])
                parts = parts[1:]
            else:
                types = local_types.get(cur.id)
        else:
            return None
        if types is None:
            return None
        for p in parts:
            nxt: Set[str] = set()
            for t in types:
                tc = project.class_table.get(t)
                sub = attr_types_of(tc, p)
                if sub is None:
                    return None
                nxt |= sub
            types = nxt
        return frozenset(types)

    def visit(node: ast.AST, held: FrozenSet[str]):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            body = node.body if isinstance(node.body, list) \
                else [node.body]
            for child in body:
                visit(child, frozenset())
            return
        if isinstance(node, ast.With):
            inner = set(held)
            for item in node.items:
                lk = lock_of(item.context_expr)
                if lk:
                    s.acquires.append((lk, held, node.lineno))
                    inner.add(lk)
                visit(item.context_expr, held)
            for child in node.body:
                visit(child, frozenset(inner))
            return
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute):
                recv_self = (isinstance(f.value, ast.Name)
                             and f.value.id == "self")
                is_super = (isinstance(f.value, ast.Call)
                            and isinstance(f.value.func, ast.Name)
                            and f.value.func.id == "super")
                if f.attr in CALLBACK_ATTRS:
                    s.calls.append(_Call("callback", f.attr, held,
                                         node.lineno))
                    if f.attr == "raise_event":
                        # also a real method: chase its acquisitions
                        s.calls.append(_Call("other", f.attr, held,
                                             node.lineno))
                elif recv_self or is_super:
                    s.calls.append(_Call("self", f.attr, held,
                                         node.lineno))
                else:
                    s.calls.append(_Call("other", f.attr, held,
                                         node.lineno,
                                         recv_types_of(f.value)))
            elif isinstance(f, ast.Name):
                if f.id in tainted:
                    s.calls.append(_Call("callback", f.id, held,
                                         node.lineno))
                else:
                    s.calls.append(_Call("local", f.id, held,
                                         node.lineno))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in meth.body:
        visit(stmt, frozenset())


def _tainted_expr(expr: ast.AST, tainted: Set[str]) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Attribute) and n.attr in CALLBACK_SOURCES:
            return True
        if isinstance(n, ast.Name) and n.id in tainted:
            return True
    return False
