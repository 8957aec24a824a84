"""Shared infrastructure for the concurrency legality passes.

The legality suite mirrors the paper's shell-side bitstream checks: a
design (here: a lock-bearing module) declares its concurrency model in
the source, and the passes verify the code against the declaration
*before* it runs. The declaration language is comments, so it lives next
to the code it governs and shows up in diffs:

``# guarded-by: _lock``
    On an attribute assignment (``self.x = ... # guarded-by: _lock``):
    every read/write of ``self.x`` outside ``with self._lock`` is a
    finding.
``# holds: _lock``
    On a ``def`` line: the method documents that callers enter it with
    the lock held. Its body is checked as if the lock were held, and it
    must never re-acquire it (non-reentrant locks deadlock).
``# unguarded-ok: <reason>``
    On an access line: a documented exception. The reason is mandatory
    and is carried into ANALYSIS.json.
``# concurrency: <model>``
    On a ``class`` line: declares a lock-free discipline (for example
    ``single-owner`` objects confined to the engine's step thread).

This module parses sources once (AST + tokenize for comments) and builds
the class model both passes share: which attributes are locks, which
attributes each lock guards, condition-variable aliases, and method
tables with cross-module base resolution.
"""
from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

GUARDED_RE = re.compile(r"guarded-by:\s*([A-Za-z_]\w*)")
HOLDS_RE = re.compile(r"holds:\s*([A-Za-z_]\w*(?:\s*,\s*[A-Za-z_]\w*)*)")
UNGUARDED_OK_RE = re.compile(r"unguarded-ok:\s*(\S.*)")
CONCURRENCY_RE = re.compile(r"concurrency:\s*(\S.*)")

# Attribute names treated as lock constructors when assigned in a class.
_LOCK_CTORS = {"Lock", "RLock"}


@dataclass
class Finding:
    """One legality violation, machine-readable for ANALYSIS.json."""
    rule: str
    path: str
    line: int
    message: str

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class ClassInfo:
    """Per-class concurrency model extracted from one module."""
    name: str
    module: "SourceModule"
    node: ast.ClassDef
    bases: List[str] = field(default_factory=list)
    # attr -> guard lock attr (both unqualified, e.g. "_entries" -> "_lock")
    guarded: Dict[str, str] = field(default_factory=dict)
    # attrs that *are* locks (assigned threading.Lock()/RLock(), a list
    # of locks, a lock passed in as a parameter, or used in `with self.X`)
    lock_attrs: Set[str] = field(default_factory=set)
    # subset of lock_attrs actually constructed here (threading.Lock()
    # in a method body) — preferred for canonical node naming
    ctor_locks: Set[str] = field(default_factory=set)
    # condition-variable aliases: attr -> underlying lock attr
    cond_alias: Dict[str, str] = field(default_factory=dict)
    concurrency_note: Optional[str] = None
    methods: Dict[str, ast.FunctionDef] = field(default_factory=dict)
    # attr -> candidate constructor class names (`self.x = Ctor(...)`,
    # `self.x = REGISTRY[k](...)`, dataclass field annotations); used
    # to narrow call resolution
    attr_types: Dict[str, Set[str]] = field(default_factory=dict)
    # attr -> element class names for annotated containers
    # (`self.x: Dict[str, _TenantEntry]` -> {"_TenantEntry"})
    attr_elem_types: Dict[str, Set[str]] = field(default_factory=dict)

    def resolve_lock(self, attr: str) -> Optional[str]:
        """Alias-resolve an attr used as a lock (``_cv`` -> ``_lock``)."""
        seen = set()
        while attr in self.cond_alias and attr not in seen:
            seen.add(attr)
            attr = self.cond_alias[attr]
        return attr if attr in self.lock_attrs else None


class SourceModule:
    """One parsed source file: AST, per-line comments, class table."""

    def __init__(self, path: str, relpath: str):
        self.path = path
        self.relpath = relpath
        with open(path, "r", encoding="utf-8") as f:
            self.text = f.read()
        self.tree = ast.parse(self.text, filename=relpath)
        self.comments: Dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(self.text).readline):
                if tok.type == tokenize.COMMENT:
                    self.comments[tok.start[0]] = tok.string
        except tokenize.TokenError:
            pass
        self.classes: Dict[str, ClassInfo] = {}
        self.functions: Dict[str, ast.FunctionDef] = {}
        # module-level registry dicts whose values are classes
        # (e.g. ``BACKENDS = {"bitmap": BitmapBackend, ...}``)
        self.registry_dicts: Dict[str, Set[str]] = {}
        self._build()

    # -- annotation lookups --------------------------------------------
    def comment_match(self, line: int, pattern: re.Pattern):
        c = self.comments.get(line)
        return pattern.search(c) if c else None

    def waiver(self, first: int, last: Optional[int] = None) \
            -> Optional[str]:
        """``unguarded-ok`` reason on any line of a statement span."""
        for ln in range(first, (last or first) + 1):
            m = self.comment_match(ln, UNGUARDED_OK_RE)
            if m:
                return m.group(1).strip()
        return None

    # -- model construction --------------------------------------------
    def _build(self):
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                self.classes[node.name] = self._build_class(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Dict):
                vals = {v.id for v in node.value.values
                        if isinstance(v, ast.Name)}
                if vals and len(vals) == len(node.value.values):
                    self.registry_dicts[node.targets[0].id] = vals
        # second pass: attr construction/annotation types (registry
        # dicts may be declared anywhere in the module)
        for ci in self.classes.values():
            for item in ci.node.body:      # dataclass-style fields
                if isinstance(item, ast.AnnAssign) and \
                        isinstance(item.target, ast.Name):
                    direct, elems = _ann_types(item.annotation)
                    if direct:
                        ci.attr_types.setdefault(
                            item.target.id, set()).update(direct)
                    if elems:
                        ci.attr_elem_types.setdefault(
                            item.target.id, set()).update(elems)
            for meth in ci.methods.values():
                for stmt in ast.walk(meth):
                    if not (isinstance(stmt, (ast.Assign, ast.AnnAssign))):
                        continue
                    targets = stmt.targets if isinstance(stmt, ast.Assign) \
                        else [stmt.target]
                    for t in targets:
                        if not (isinstance(t, ast.Attribute) and
                                isinstance(t.value, ast.Name) and
                                t.value.id == "self"):
                            continue
                        if stmt.value is not None:
                            cands = self.ctor_candidates(stmt.value)
                            if cands is not None:
                                ci.attr_types.setdefault(
                                    t.attr, set()).update(cands)
                        if isinstance(stmt, ast.AnnAssign):
                            direct, elems = _ann_types(stmt.annotation)
                            if direct:
                                ci.attr_types.setdefault(
                                    t.attr, set()).update(direct)
                            if elems:
                                ci.attr_elem_types.setdefault(
                                    t.attr, set()).update(elems)

    def ctor_candidates(self, value: ast.AST) -> Optional[Set[str]]:
        """Constructor class-name candidates for an assigned value, or
        None when the expression's type cannot be pinned down."""
        if isinstance(value, ast.Call):
            f = value.func
            if isinstance(f, ast.Name):
                if f.id in self.registry_dicts:
                    return set(self.registry_dicts[f.id])
                if _classy(f.id):
                    return {f.id}
                if f.id in _BUILTIN_CONTAINERS:
                    # builtin containers are foreign types: their method
                    # names (add/append/pop/...) must never fall back to
                    # name-based resolution against project classes
                    return {f.id}
            elif isinstance(f, ast.Attribute):
                if _classy(f.attr):
                    return {f.attr}
            elif isinstance(f, ast.Subscript) and \
                    isinstance(f.value, ast.Name) and \
                    f.value.id in self.registry_dicts:
                return set(self.registry_dicts[f.value.id])
        return None

    def _build_class(self, node: ast.ClassDef) -> ClassInfo:
        ci = ClassInfo(name=node.name, module=self, node=node)
        ci.bases = [b.id if isinstance(b, ast.Name) else
                    b.attr if isinstance(b, ast.Attribute) else ""
                    for b in node.bases]
        m = self.comment_match(node.lineno, CONCURRENCY_RE)
        if m:
            ci.concurrency_note = m.group(1).strip()
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ci.methods[item.name] = item
                self._scan_method(ci, item)
        # any attr used as `with self.X` is a lock even if assigned from
        # a parameter (e.g. a registry stripe handed to a Counter)
        for meth in ci.methods.values():
            for w in ast.walk(meth):
                if isinstance(w, ast.With):
                    for it in w.items:
                        attr = _self_attr_in(it.context_expr)
                        if attr and attr not in ci.cond_alias:
                            ci.lock_attrs.add(attr)
        return ci

    def _scan_method(self, ci: ClassInfo, meth: ast.FunctionDef):
        for stmt in ast.walk(meth):
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                continue
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            for t in targets:
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                attr = t.attr
                value = stmt.value
                ctor = _lock_ctor_name(value)
                if ctor in _LOCK_CTORS:
                    ci.lock_attrs.add(attr)
                    ci.ctor_locks.add(attr)
                elif ctor == "Condition":
                    arg_attr = None
                    if isinstance(value, ast.Call) and value.args:
                        arg_attr = _self_attr_in(value.args[0])
                    if arg_attr:
                        ci.cond_alias[attr] = arg_attr
                    else:
                        ci.lock_attrs.add(attr)
                elif _contains_lock_ctor(value):
                    # e.g. `self._stripes = [threading.Lock() for ...]`
                    ci.lock_attrs.add(attr)
                    ci.ctor_locks.add(attr)
                gm = self.comment_match(stmt.lineno, GUARDED_RE) or \
                    self.comment_match(getattr(stmt, "end_lineno",
                                               stmt.lineno), GUARDED_RE)
                if gm:
                    ci.guarded[attr] = gm.group(1)


#: Builtin container constructors — foreign receiver types whose method
#: names must not resolve against project classes.
_BUILTIN_CONTAINERS = frozenset({
    "set", "dict", "list", "tuple", "frozenset", "deque", "defaultdict",
    "OrderedDict", "bytearray",
})


def _classy(name: str) -> bool:
    """CamelCase (possibly underscore-private) -> conventionally a class."""
    stripped = name.lstrip("_")
    return bool(stripped) and stripped[0].isupper()


def _ann_types(ann: ast.AST) -> Tuple[Set[str], Set[str]]:
    """(direct class names, container element class names) named by an
    annotation. ``Optional[T]`` unwraps to T; ``Dict[K, V]``/``List[T]``
    contribute their last argument as the element type. Only
    capitalized names count (conventionally classes)."""

    def names(a: ast.AST) -> Set[str]:
        if isinstance(a, ast.Name) and _classy(a.id) and \
                a.id not in ("Optional", "Dict", "List", "Set", "Tuple",
                             "Callable", "Any", "Union", "FrozenSet"):
            return {a.id}
        if isinstance(a, ast.Name) and a.id in _BUILTIN_CONTAINERS:
            return {a.id}
        if isinstance(a, ast.Constant) and isinstance(a.value, str) and \
                _classy(a.value):
            return {a.value}
        if isinstance(a, ast.Attribute) and _classy(a.attr):
            return {a.attr}
        return set()

    if isinstance(ann, ast.Subscript):
        base = ann.value
        base_name = base.id if isinstance(base, ast.Name) else \
            base.attr if isinstance(base, ast.Attribute) else ""
        args = ann.slice.elts if isinstance(ann.slice, ast.Tuple) \
            else [ann.slice]
        if base_name == "Optional":
            return _ann_types(args[0])
        if base_name in ("Dict", "List", "Set", "FrozenSet", "Deque",
                         "dict", "list", "set", "deque"):
            return set(), names(args[-1])
        return set(), set()
    return names(ann), set()


def _lock_ctor_name(value: ast.AST) -> Optional[str]:
    if isinstance(value, ast.Call):
        f = value.func
        if isinstance(f, ast.Attribute):
            return f.attr
        if isinstance(f, ast.Name):
            return f.id
    return None


def _contains_lock_ctor(value: ast.AST) -> bool:
    for n in ast.walk(value):
        if isinstance(n, ast.Call):
            name = _lock_ctor_name(n)
            if name in _LOCK_CTORS:
                return True
    return False


def _self_attr_in(expr: ast.AST) -> Optional[str]:
    """`self.X`, `self.X[i]`, or `(self.X)` -> X; else None."""
    if isinstance(expr, ast.Subscript):
        expr = expr.value
    if isinstance(expr, ast.Attribute) and \
            isinstance(expr.value, ast.Name) and expr.value.id == "self":
        return expr.attr
    return None


class Project:
    """All analyzed modules plus the cross-module class table."""

    # the analysis package itself is exempt (it is the checker, and its
    # runtime half deliberately wraps raw lock primitives)
    EXCLUDE_PARTS = ("analysis",)

    def __init__(self, src_root: str):
        self.src_root = src_root
        self.modules: List[SourceModule] = []
        for dirpath, _dirs, files in sorted(os.walk(src_root)):
            rel_dir = os.path.relpath(dirpath, src_root)
            if any(p in self.EXCLUDE_PARTS
                   for p in rel_dir.split(os.sep)):
                continue
            for fn in sorted(files):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, os.path.dirname(src_root))
                self.modules.append(SourceModule(path, rel))
        # class name -> ClassInfo (names are unique in this codebase;
        # last one wins otherwise, which both passes tolerate)
        self.class_table: Dict[str, ClassInfo] = {}
        for mod in self.modules:
            self.class_table.update(mod.classes)

    def mro(self, ci: ClassInfo) -> List[ClassInfo]:
        """Linearized bases (declaration order, depth-first, deduped)."""
        out, seen, stack = [], set(), [ci]
        while stack:
            c = stack.pop(0)
            if c.name in seen:
                continue
            seen.add(c.name)
            out.append(c)
            for b in c.bases:
                bc = self.class_table.get(b)
                if bc is not None:
                    stack.append(bc)
        return out

    def effective_model(self, ci: ClassInfo) -> Tuple[
            Dict[str, str], Set[str], Dict[str, str]]:
        """(guarded, lock_attrs, cond_alias) folded over the MRO."""
        guarded: Dict[str, str] = {}
        locks: Set[str] = set()
        alias: Dict[str, str] = {}
        for c in reversed(self.mro(ci)):
            guarded.update(c.guarded)
            locks |= c.lock_attrs
            alias.update(c.cond_alias)
        return guarded, locks, alias

    def lock_owner(self, ci: ClassInfo, attr: str) -> str:
        """Canonical node name for a lock attr: the *base-most* class
        that constructs it (so every plane's ``_lock`` is one node,
        ``DataPlane._lock``), else the base-most class that uses it."""
        _g, _l, alias = self.effective_model(ci)
        seen: Set[str] = set()
        a = attr
        while a in alias and a not in seen:
            seen.add(a)
            a = alias[a]
        mro = self.mro(ci)
        for c in reversed(mro):
            if a in c.ctor_locks:
                return f"{c.name}.{a}"
        for c in reversed(mro):
            if a in c.lock_attrs:
                return f"{c.name}.{a}"
        return f"{ci.name}.{a}"
