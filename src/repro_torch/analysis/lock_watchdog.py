"""Runtime lock watchdog — the dynamic half of the legality suite.

Opt-in instrumented-lock mode (strictly off by default, like
``NULL_HUB``): while enabled, every ``threading.Lock()`` created from
``src/repro_torch`` code is wrapped so the watchdog can record

* the **actual acquisition order** (a directed edge A -> B whenever B
  is acquired while A is held on the same thread), keyed by lock
  *creation site* so every ``DataPlane._lock`` instance is one graph
  node — the same node the static pass models;
* **held-across-callback events**: the hot paths call
  :func:`note_callback` at each user-callback dispatch (relief/swap
  hooks, admission gates, IRQ handler delivery, obs providers); firing
  one while any instrumented lock is held is a violation.

Activation: ``REPRO_LOCK_WATCHDOG=1`` in the environment or
:func:`watching` in a test. When not enabled, :func:`note_callback` is
a single global-flag check and no lock is ever wrapped — the serving
loop pays nothing.

This is the PyTorch package's own copy of ``repro``'s watchdog: it
imports nothing of ``repro`` and wraps only locks created under
``src/repro_torch``.
"""
from __future__ import annotations

import ast
import contextlib
import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

_REAL_LOCK = threading.Lock
_enabled = False
_installed = False

_SRC_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _thread_stack() -> List[str]:
    try:
        return _TLS.stack
    except AttributeError:
        _TLS.stack = []
        return _TLS.stack


_TLS = threading.local()


class LockWatchdog:
    """Global recorder: edges, violations, creation-site names."""

    def __init__(self):
        self._mu = _REAL_LOCK()
        # (a, b) -> witness thread name
        self.edges: Dict[Tuple[str, str], str] = {}
        self.violations: List[dict] = []
        self._site_names: Dict[Tuple[str, int], str] = {}

    # -- recording (called from instrumented locks) --------------------
    def note_acquire(self, site: str):
        stack = _thread_stack()
        if stack and stack[-1] != site:
            edge = (stack[-1], site)
            if edge not in self.edges:
                with self._mu:
                    self.edges.setdefault(
                        edge, threading.current_thread().name)
        stack.append(site)

    def note_release(self, site: str):
        stack = _thread_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == site:
                del stack[i]
                return

    def note_callback(self, tag: str):
        stack = _thread_stack()
        if stack:
            with self._mu:
                self.violations.append({
                    "kind": "callback-under-lock", "callback": tag,
                    "held": list(stack),
                    "thread": threading.current_thread().name})

    # -- verdicts ------------------------------------------------------
    def cycles(self) -> List[List[str]]:
        adj: Dict[str, set] = {}
        for (a, b) in self.edges:
            adj.setdefault(a, set()).add(b)
        out, done = [], set()
        for start in sorted(adj):
            path, on_path = [], set()

            def dfs(n):
                if n in on_path:
                    return path[path.index(n):] + [n]
                if n in done:
                    return None
                on_path.add(n)
                path.append(n)
                for m in sorted(adj.get(n, ())):
                    c = dfs(m)
                    if c:
                        return c
                path.pop()
                on_path.discard(n)
                done.add(n)
                return None

            c = dfs(start)
            if c:
                out.append(c)
        return out

    def problems(self) -> List[str]:
        out = [f"lock-order cycle: {' -> '.join(c)}"
               for c in self.cycles()]
        out += [f"callback '{v['callback']}' invoked on "
                f"{v['thread']} holding {v['held']}"
                for v in self.violations]
        return out

    def snapshot(self) -> dict:
        return {"edges": {f"{a} -> {b}": t
                          for (a, b), t in sorted(self.edges.items())},
                "violations": list(self.violations),
                "cycles": self.cycles()}

    def reset(self):
        with self._mu:
            self.edges.clear()
            self.violations.clear()

    # -- lock naming by creation site ----------------------------------
    def site_name(self, filename: str, lineno: int) -> str:
        key = (filename, lineno)
        name = self._site_names.get(key)
        if name is None:
            name = _resolve_site(filename, lineno)
            with self._mu:
                self._site_names[key] = name
        return name


def _resolve_site(filename: str, lineno: int) -> str:
    """Map a ``threading.Lock()`` creation site to ``Class.attr``."""
    base = os.path.basename(filename)
    try:
        with open(filename, "r", encoding="utf-8") as f:
            tree = ast.parse(f.read())
    except (OSError, SyntaxError):
        return f"{base}:{lineno}"
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        for node in ast.walk(cls):
            if isinstance(node, (ast.Assign, ast.AnnAssign)) and \
                    node.lineno <= lineno <= \
                    getattr(node, "end_lineno", node.lineno):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Attribute):
                        return f"{cls.name}.{t.attr}"
                    if isinstance(t, ast.Name):
                        return f"{cls.name}.{t.id}"
    return f"{base}:{lineno}"


WATCHDOG = LockWatchdog()


class _WatchedLock:
    """Wrapper with the full Lock + Condition-lock protocol."""

    __slots__ = ("_inner", "_site", "_owner")

    def __init__(self, site: str):
        self._inner = _REAL_LOCK()
        self._site = site
        self._owner: Optional[int] = None

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._owner = threading.get_ident()
            WATCHDOG.note_acquire(self._site)
        return ok

    def release(self):
        self._owner = None
        WATCHDOG.note_release(self._site)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    # Condition(lock) support — keep the held-stack coherent across
    # wait()'s release/reacquire without recording spurious edges.
    def _release_save(self):
        self._owner = None
        WATCHDOG.note_release(self._site)
        self._inner.release()

    def _acquire_restore(self, _state):
        self._inner.acquire()
        self._owner = threading.get_ident()
        _thread_stack().append(self._site)

    def _is_owned(self):
        return self._owner == threading.get_ident()

    def __repr__(self):
        return f"<WatchedLock {self._site} inner={self._inner!r}>"


def _lock_factory():
    if not _enabled:
        return _REAL_LOCK()
    frame = sys._getframe(1)
    filename = frame.f_code.co_filename
    if not filename.startswith(_SRC_ROOT + os.sep) or \
            os.sep + "analysis" + os.sep in filename:
        return _REAL_LOCK()
    return _WatchedLock(WATCHDOG.site_name(filename, frame.f_lineno))


def install():
    """Patch ``threading.Lock`` with the site-filtering factory. Idempotent;
    with the watchdog disabled the factory returns raw locks."""
    global _installed
    if not _installed:
        threading.Lock = _lock_factory
        _installed = True


def enable():
    global _enabled
    install()
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def note_callback(tag: str):
    """Hot-path hook at user-callback dispatch sites. Near-zero when
    the watchdog is off (single global check)."""
    if _enabled:
        WATCHDOG.note_callback(tag)


@contextlib.contextmanager
def watching(reset: bool = True):
    """Enable for a scope; yields the recorder. Locks created inside
    the scope are instrumented; pre-existing locks are not. Restores
    the previous enabled state on exit, so a scoped use inside an
    env-enabled run (REPRO_LOCK_WATCHDOG=1) doesn't turn the run-wide
    watchdog off."""
    was = _enabled
    if reset:
        WATCHDOG.reset()
    enable()
    try:
        yield WATCHDOG
    finally:
        if not was:
            disable()


def env_requested() -> bool:
    return os.environ.get("REPRO_LOCK_WATCHDOG", "") not in ("", "0")
