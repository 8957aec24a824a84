"""Host span timeline — where the host's time goes inside the port.

The request tracer follows one request through its phases; this module
follows the host through the layers: each *span* is one call of a layer
boundary (``engine.step``, ``plane.run``, ``model.layer``, ...) with its
two stamps on ``time.monotonic()`` (the clock the tracer, the scheduler
and the benchmark's device trace share), the span that was open around
it on its thread, the thread, and a key (a request id, a step or layer
number; -1 for none) and a tag (such as a layer's mixer). An *instant*
is one stamp under the innermost open span: each host synchronisation
with the card is one, named ``sync``.

Records go to a preallocated ring of fixed capacity: once it is full the
oldest are overwritten and ``dropped`` counts them, so a reader can tell
a whole interval from one that lost records.

Recording is off until a timeline is *activated* (``ObsHub.activate``):
the sites read the module attribute :data:`ACTIVE` and do nothing more
while it is None, so an inactive timeline costs each site one ``is
None`` check and allocates nothing. Sites deep in the model and the
train step reach the active timeline that way, as the kernel wrappers
reach ``kernels.common.recorder``::

    tl = spans.ACTIVE
    sid = tl.open("model.layer", i, tag=spec.mixer) if tl is not None else 0
    ...
    if sid:
        tl.close(sid)

Spans nest per thread. A span opened on another thread (the autograd
engine's, which runs the mixers' backward) has no parent on the thread
that waits for it; readers place it by its interval.

While a timeline is active, a warning that reports a host
synchronisation (``torch.cuda.set_sync_debug_mode("warn")``, set at
activation when CUDA is there) is recorded as a ``sync`` instant instead
of being shown, every time: an ``always`` filter keeps Python from
showing only the first from each line.
"""
from __future__ import annotations

import math
import threading
import time
import warnings
from typing import Dict, List, Optional

import numpy as np

#: the timeline the sites record into; None: recording is off
ACTIVE: Optional["SpanTimeline"] = None

#: the text of the warning torch gives for each synchronising CUDA call
SYNC_WARNING = "called a synchronizing CUDA operation"
SYNC = "sync"

KIND_SPAN, KIND_INSTANT = 0, 1

#: records a timeline holds by default (10.7 MB of host memory): a whole
#: traced run of the busiest benchmark cell, set-up and a 51 s window,
#: writes about a sixth of this
DEFAULT_CAPACITY = 1 << 18


class SpanTimeline:
    """A bounded ring of span and instant records, shared by threads."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._t0 = None        # guarded-by: _lock
        self._t1 = None        # guarded-by: _lock
        self._name = None      # guarded-by: _lock
        self._tag = None       # guarded-by: _lock
        self._parent = None    # guarded-by: _lock
        self._thread = None    # guarded-by: _lock
        self._key = None       # guarded-by: _lock
        self._kind = None      # guarded-by: _lock
        self._n = 0            # guarded-by: _lock
        self._ids: Dict[str, int] = {"": 0}         # guarded-by: _lock
        self._names: List[str] = [""]               # guarded-by: _lock
        self._threads: Dict[int, int] = {}          # guarded-by: _lock
        self._lock = threading.Lock()
        self._local = threading.local()

    def _allocate(self):
        """Make the ring (at activation: an idle timeline holds none)."""
        c = self.capacity
        with self._lock:
            if self._t0 is not None:
                return
            self._t0 = np.zeros(c, np.float64)
            self._t1 = np.zeros(c, np.float64)
            self._name = np.zeros(c, np.int32)
            self._tag = np.zeros(c, np.int32)
            self._parent = np.zeros(c, np.int64)
            self._thread = np.zeros(c, np.int32)
            self._key = np.zeros(c, np.int64)
            self._kind = np.zeros(c, np.int8)

    # -- recording -----------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _intern(self, s: str) -> int:  # holds: _lock
        i = self._ids.get(s)
        if i is None:
            i = self._ids[s] = len(self._names)
            self._names.append(s)
        return i

    def _thread_id(self) -> int:  # holds: _lock
        ident = threading.get_ident()
        i = self._threads.get(ident)
        if i is None:
            i = self._threads[ident] = len(self._threads)
        return i

    def _put(self, kind, name, key, tag, t0, t1, parent) -> int:
        with self._lock:
            self._n += 1
            rid = self._n
            s = (rid - 1) % self.capacity
            self._t0[s] = t0
            self._t1[s] = t1
            self._name[s] = self._intern(name)
            self._tag[s] = self._intern(tag)
            self._parent[s] = parent
            self._thread[s] = self._thread_id()
            self._key[s] = key
            self._kind[s] = kind
        return rid

    def open(self, name: str, key: int = -1, t: Optional[float] = None,
             tag: str = "") -> int:
        """Open a span under the innermost one open on this thread → its
        id (never 0). ``t``: a ``time.monotonic()`` reading the caller
        already made."""
        st = self._stack()
        rid = self._put(KIND_SPAN, name, key, tag,
                        time.monotonic() if t is None else t, math.nan,
                        st[-1] if st else 0)
        st.append(rid)
        return rid

    def close(self, rid: int, t: Optional[float] = None) -> float:
        """Close span ``rid`` (and any that an exception left open inside
        it on this thread) → its end."""
        t = time.monotonic() if t is None else t
        st = self._stack()
        if rid in st:
            while st.pop() != rid:
                pass
        with self._lock:
            if rid > self._n - self.capacity:
                self._t1[(rid - 1) % self.capacity] = t
        return t

    def instant(self, name: str) -> int:
        """One stamp under the innermost open span of this thread."""
        st = self._stack()
        t = time.monotonic()
        return self._put(KIND_INSTANT, name, -1, "", t, t,
                         st[-1] if st else 0)

    # -- reading -------------------------------------------------------
    @property
    def written(self) -> int:
        with self._lock:
            return self._n

    @property
    def dropped(self) -> int:
        """Records overwritten since the timeline was made."""
        with self._lock:
            return max(0, self._n - self.capacity)

    def records(self) -> "Records":
        """A copy of the records the ring holds, oldest first."""
        with self._lock:
            n, c = self._n, self.capacity
            first = max(1, n - c + 1)
            ids = np.arange(first, n + 1, dtype=np.int64)
            if self._t0 is None:
                cols = {k: np.zeros(0) for k in Records.COLUMNS}
            else:
                s = (ids - 1) % c
                cols = {"t0": self._t0[s], "t1": self._t1[s],
                        "name": self._name[s], "tag": self._tag[s],
                        "parent": self._parent[s],
                        "thread": self._thread[s], "key": self._key[s],
                        "kind": self._kind[s]}
            return Records(ids, cols, list(self._names), max(0, n - c))


class Records:
    """Columns of a timeline's records (numpy arrays, one row a record)
    and the names their integer columns point into."""

    COLUMNS = ("t0", "t1", "name", "tag", "parent", "thread", "key", "kind")

    def __init__(self, ids, cols, names, dropped):
        self.ids = ids
        self.t0, self.t1 = cols["t0"], cols["t1"]
        self.name, self.tag = cols["name"], cols["tag"]
        self.parent, self.thread = cols["parent"], cols["thread"]
        self.key, self.kind = cols["key"], cols["kind"]
        self.names = names
        #: records lost to the ring before the oldest held
        self.dropped = dropped

    def __len__(self):
        return len(self.ids)

    def name_of(self, i) -> str:
        return self.names[self.name[i]]

    def select(self, name: str, kind: int = KIND_SPAN) -> np.ndarray:
        """Row indices of the records named ``name``."""
        try:
            nid = self.names.index(name)
        except ValueError:
            return np.zeros(0, np.int64)
        return np.flatnonzero((self.name == nid) & (self.kind == kind))

    def row_of(self, rid):
        """Row index of record id ``rid`` (None: not held)."""
        if not len(self.ids) or rid < self.ids[0] or rid > self.ids[-1]:
            return None
        return int(rid - self.ids[0])

    def children_time(self, rows, child: str) -> np.ndarray:
        """For each span in ``rows``, the time of its direct children
        named ``child``."""
        out = np.zeros(len(rows))
        pos = {int(self.ids[r]): j for j, r in enumerate(rows)}
        for c in self.select(child):
            j = pos.get(int(self.parent[c]))
            if j is not None:
                out[j] += self.t1[c] - self.t0[c]
        return out

    def spans(self, t0: float = -math.inf, t1: float = math.inf):
        """→ [(name, t0, t1)] of the closed spans that overlap [t0, t1]."""
        rows = np.flatnonzero((self.kind == KIND_SPAN)
                              & ~np.isnan(self.t1)
                              & (self.t1 > t0) & (self.t0 < t1))
        return [(self.names[self.name[r]], float(self.t0[r]),
                 float(self.t1[r])) for r in rows]


# -- activation --------------------------------------------------------
_saved: dict = {}


def _show(message, category, filename, lineno, file=None, line=None):
    tl = ACTIVE
    if tl is not None and SYNC_WARNING in str(message):
        tl.instant(SYNC)
        return
    _saved["showwarning"](message, category, filename, lineno, file, line)


def activate(timeline: SpanTimeline):
    """Make ``timeline`` the one every site records into, and route the
    host's synchronisation warnings into it."""
    global ACTIVE
    if ACTIVE is not None:
        raise RuntimeError("a span timeline is already active")
    timeline._allocate()
    _saved["showwarning"] = warnings.showwarning
    _saved["filters"] = warnings.filters[:]
    warnings.filterwarnings("always", message=SYNC_WARNING)
    warnings.showwarning = _show
    _saved["sync_mode"] = None
    import torch
    if torch.cuda.is_available():
        _saved["sync_mode"] = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
    ACTIVE = timeline


def deactivate():
    """Stop recording and restore the warning and sync-debug settings."""
    global ACTIVE
    if ACTIVE is None:
        return
    ACTIVE = None
    if _saved.get("sync_mode") is not None:
        import torch
        torch.cuda.set_sync_debug_mode(_saved["sync_mode"])
    warnings.showwarning = _saved.pop("showwarning")
    warnings.filters[:] = _saved.pop("filters")
    warnings._filters_mutated()     # as warnings.catch_warnings does
