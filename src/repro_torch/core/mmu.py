"""Software MMU — the paper's §IV.C memory-management unit, adapted to
device memory (the PyTorch package's own copy of ``repro.core.mmu``).

The paper divides board DRAM into 1 MB segments and serves allocations
first-fit from a bitmap ("an array with free segments marked 0 and used
segments marked 1"), noting "the algorithm can be further improved by using
a linked list". We implement all three generations:

* ``bitmap``   — the paper's exact algorithm (first-fit contiguous scan).
* ``freelist`` — the paper's named future work (sorted free-run list).
* ``buddy``    — beyond-paper power-of-two allocator (O(log n), low
  external fragmentation at 2× internal-fragmentation cost).

Segment size is a pool parameter: the paged KV cache sets it to one KV
page, so one segment is one page; ``SEGMENT_BYTES`` is only the default
for plain segment allocations. A pool's size is whatever its creator
asks for.

Isolation: every allocation records its owner; ``free``/``translate``
validate ownership and quota, and violations feed the IsolationAuditor —
this is the enforcement half of the paper's software-side data protection.

Paging: beyond the paper's contiguous first-fit segments, the pool also
serves *page-granular* allocations through a per-handle ``PageTable``
(logical block index → physical page, one page = one segment, no
contiguity requirement). This is the substrate for the paged KV cache in
``repro_torch.serving.paged_kv``: a serving slot leases pages on admission,
grows its table on demand (counted as ``page_faults``), and returns the
pages on EOS — making serving memory tenant-accountable through the same
ownership/quota machinery as plain segment allocations.

Page hierarchy: every page-granular frame carries a **refcount**, so
multiple tables (and out-of-table pins, e.g. a prefix cache) can map
the same physical frame — the multi-tenancy move of sharing immutable
resources while enforcing isolation on write:

* ``alloc_pages(..., shared_prefix=[...])`` maps existing frames at the
  front of a fresh table (refcount++ each, no new HBM);
* ``fork_page`` is the copy-on-write pivot: it swaps one shared mapping
  for a freshly allocated private frame and drops the old reference
  (the caller copies the bytes device-side);
* ``retain_frame``/``release_frame`` pin frames from outside any table;
* ``swap_out_page``/``swap_in_page`` mark a table entry swapped
  (physical page → ``SWAPPED``) releasing the frame, and later fault it
  back in on a fresh frame — the host-memory swap tier's MMU half.

A frame is returned to the backend allocator exactly when its last
reference drops, wherever that drop comes from (free, fork, swap,
unpin).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

SEGMENT_BYTES = 16 * 2 ** 20          # 16 MiB

#: PageTable entry sentinel: the logical block is swapped out to the
#: host tier — it has no physical frame until ``swap_in_page``.
SWAPPED = -1


class MMUError(Exception):
    pass


class IsolationViolation(MMUError):
    pass


class OutOfMemory(MMUError):
    pass


class QuotaExceeded(MMUError):
    pass


@dataclass
class Allocation:
    handle: int
    owner: str
    start_seg: int
    n_segs: int
    n_bytes: int

    @property
    def byte_range(self):
        return (self.start_seg * SEGMENT_BYTES,
                self.start_seg * SEGMENT_BYTES + self.n_bytes)


# ===========================================================================
# Allocator backends
# ===========================================================================


class BitmapAllocator:
    """Paper-faithful: first-fit over a used/free segment array."""

    def __init__(self, n_segments: int):
        self.n = n_segments
        self.used = np.zeros(n_segments, dtype=bool)

    def alloc(self, n_segs: int) -> Optional[int]:
        if n_segs > self.n:
            return None
        run = 0
        for i in range(self.n):
            run = 0 if self.used[i] else run + 1
            if run == n_segs:
                start = i - n_segs + 1
                self.used[start:i + 1] = True
                return start
        return None

    def free(self, start: int, n_segs: int):
        assert self.used[start:start + n_segs].all()
        self.used[start:start + n_segs] = False

    def free_segments(self) -> int:
        return int((~self.used).sum())

    def largest_free_run(self) -> int:
        best = run = 0
        for u in self.used:
            run = 0 if u else run + 1
            best = max(best, run)
        return best


class FreelistAllocator:
    """The paper's proposed improvement: sorted list of free runs."""

    def __init__(self, n_segments: int):
        self.n = n_segments
        self.runs: List[List[int]] = [[0, n_segments]]   # [start, len]

    def alloc(self, n_segs: int) -> Optional[int]:
        for i, (start, length) in enumerate(self.runs):
            if length >= n_segs:
                if length == n_segs:
                    self.runs.pop(i)
                else:
                    self.runs[i] = [start + n_segs, length - n_segs]
                return start
        return None

    def free(self, start: int, n_segs: int):
        self.runs.append([start, n_segs])
        self.runs.sort()
        merged = [self.runs[0]]
        for s, l in self.runs[1:]:
            if merged[-1][0] + merged[-1][1] == s:
                merged[-1][1] += l
            else:
                merged.append([s, l])
        self.runs = merged

    def free_segments(self) -> int:
        return sum(l for _, l in self.runs)

    def largest_free_run(self) -> int:
        return max((l for _, l in self.runs), default=0)


class BuddyAllocator:
    """Beyond-paper: power-of-two buddy system."""

    def __init__(self, n_segments: int):
        self.order_max = max(1, int(np.ceil(np.log2(max(n_segments, 1)))))
        self.n = 1 << self.order_max
        self.limit = n_segments                     # real capacity
        self.free_lists: Dict[int, list] = {o: [] for o in
                                            range(self.order_max + 1)}
        self.free_lists[self.order_max].append(0)
        self._allocated: Dict[int, int] = {}        # start → order
        # reserve the phantom tail beyond n_segments
        self._phantom = []
        tail = n_segments
        while tail < self.n:
            o = 0
            while tail % (1 << (o + 1)) == 0 and tail + (1 << (o + 1)) <= self.n:
                o += 1
            blk = self._carve(tail, o)
            self._phantom.append((blk, o))
            tail += 1 << o

    def _carve(self, start, order):
        """Split blocks until ``start`` is the head of an ``order`` block."""
        o = order
        while True:
            for oo in range(o, self.order_max + 1):
                for blk in self.free_lists[oo]:
                    if blk <= start < blk + (1 << oo):
                        self.free_lists[oo].remove(blk)
                        while oo > o:
                            oo -= 1
                            half = blk + (1 << oo)
                            if start < half:
                                self.free_lists[oo].append(half)
                            else:
                                self.free_lists[oo].append(blk)
                                blk = half
                        return blk
            raise MMUError("carve failed")

    def alloc(self, n_segs: int) -> Optional[int]:
        order = max(0, int(np.ceil(np.log2(max(n_segs, 1)))))
        for o in range(order, self.order_max + 1):
            if self.free_lists[o]:
                blk = self.free_lists[o].pop(0)
                while o > order:
                    o -= 1
                    self.free_lists[o].append(blk + (1 << o))
                self._allocated[blk] = order
                return blk
        return None

    def free(self, start: int, n_segs: int):
        order = self._allocated.pop(start)
        blk = start
        while order < self.order_max:
            buddy = blk ^ (1 << order)
            if buddy in self.free_lists[order]:
                self.free_lists[order].remove(buddy)
                blk = min(blk, buddy)
                order += 1
            else:
                break
        self.free_lists[order].append(blk)

    def free_segments(self) -> int:
        real = sum((1 << o) * len(lst) for o, lst in self.free_lists.items())
        return real

    def largest_free_run(self) -> int:
        # adjacent non-buddy free blocks form one contiguous run even
        # though the buddy system never coalesces them
        blocks = sorted((start, 1 << o)
                        for o, lst in self.free_lists.items()
                        for start in lst)
        best = 0
        run_start = run_end = None
        for start, length in blocks:
            if run_end == start:
                run_end += length
            else:
                run_start, run_end = start, start + length
            best = max(best, run_end - run_start)
        return best


BACKENDS = {"bitmap": BitmapAllocator, "freelist": FreelistAllocator,
            "buddy": BuddyAllocator}


# ===========================================================================
# Per-slice pool with ownership + quota (the MMU proper)
# ===========================================================================


@dataclass
class MMUStats:
    allocs: int = 0
    frees: int = 0
    denied: int = 0
    alloc_ns_total: int = 0
    peak_segs: int = 0
    # paging counters (PageTable API)
    pages_allocated: int = 0
    pages_freed: int = 0            # physical frames returned (refs → 0)
    page_faults: int = 0            # demand growths of a live page table
    # page-hierarchy counters (prefix sharing / CoW / swap tier)
    shared_maps: int = 0            # mappings served by an existing frame
    cow_forks: int = 0              # shared frames forked on first write
    swap_outs: int = 0              # table entries evicted to host tier
    swap_ins: int = 0               # refaults back onto fresh frames

    def alloc_latency_us(self):
        return (self.alloc_ns_total / max(self.allocs, 1)) / 1e3


@dataclass
class PageTable:
    """Per-handle logical→physical page map (one page = one segment).

    Unlike ``Allocation`` there is no contiguity: each logical block index
    maps to an arbitrary physical page, so a table can grow on demand
    without relocation — the property the paged KV cache relies on.
    """

    handle: int
    owner: str
    pages: List[int] = field(default_factory=list)

    @property
    def n_pages(self) -> int:
        return len(self.pages)

    def lookup(self, logical: int) -> int:
        return self.pages[logical]


class SegmentPool:
    """One slice's HBM pool: backend allocator + ownership + quotas."""

    def __init__(self, total_bytes: int, backend: str = "bitmap",
                 segment_bytes: int = SEGMENT_BYTES, auditor=None,
                 obs=None):
        self.segment_bytes = segment_bytes
        self.n_segments = max(1, total_bytes // segment_bytes)
        self.backend_name = backend
        self.alloc_backend = BACKENDS[backend](self.n_segments)  # guarded-by: _lock
        self.allocations: Dict[int, Allocation] = {}     # guarded-by: _lock
        self.page_tables: Dict[int, PageTable] = {}      # guarded-by: _lock
        # page-hierarchy state: physical frame → reference count (every
        # table mapping + every out-of-table pin holds one reference);
        # _pins tracks the pin component so the consistency invariant
        # can be checked exactly
        self.frame_refs: Dict[int, int] = {}             # guarded-by: _lock
        self._pins: Dict[int, int] = {}                  # guarded-by: _lock
        self.quota_segs: Dict[str, int] = {}             # guarded-by: _lock
        self.denied_by_owner: Dict[str, int] = {}        # guarded-by: _lock
        self.stats = MMUStats()                          # guarded-by: _lock
        self.auditor = auditor
        # telemetry hub (repro_torch.obs.ObsHub); None/disabled → zero-cost.
        # Registry stripe locks only ever nest *inside* the pool lock.
        self.obs = obs
        self._next_handle = 0                            # guarded-by: _lock
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def set_quota(self, owner: str, n_bytes: int):
        with self._lock:
            self.quota_segs[owner] = -(-n_bytes // self.segment_bytes)

    def clear_quota(self, owner: str):
        with self._lock:
            self.quota_segs.pop(owner, None)

    def set_quota_segs(self, owner: str, n_segs: int):
        """Segment-denominated quota (migration carries quotas across
        pools with differing segment sizes already rounded)."""
        with self._lock:
            self.quota_segs[owner] = n_segs

    def quota_segs_of(self, owner: str) -> Optional[int]:
        with self._lock:
            return self.quota_segs.get(owner)

    def _owner_segs(self, owner: str) -> int:  # holds: _lock
        segs = sum(a.n_segs for a in self.allocations.values()
                   if a.owner == owner)
        segs += sum(t.n_pages for t in self.page_tables.values()
                    if t.owner == owner)
        return segs

    def _deny(self, owner: str, cause: str = "denied"):  # holds: _lock
        self.stats.denied += 1
        self.denied_by_owner[owner] = self.denied_by_owner.get(owner, 0) + 1
        if self.obs is not None and self.obs.enabled:
            self.obs.count("mmu_denials_total", owner=owner, cause=cause)

    def alloc(self, n_bytes: int, owner: str) -> Allocation:
        n_segs = max(1, -(-n_bytes // self.segment_bytes))
        t0 = time.perf_counter_ns()
        with self._lock:
            q = self.quota_segs.get(owner)
            if q is not None and self._owner_segs(owner) + n_segs > q:
                self._deny(owner, "quota_exceeded")
                if self.auditor:
                    self.auditor.record("quota_exceeded", owner,
                                        {"ask_segs": n_segs, "quota": q})
                raise QuotaExceeded(f"{owner}: {n_segs} segs over quota {q}")
            start = self.alloc_backend.alloc(n_segs)
            if start is None:
                # _deny, not a bare stats bump: OOM must show up in the
                # per-owner denial counts the SLO admission gate reads
                self._deny(owner, "oom")
                raise OutOfMemory(
                    f"{owner}: {n_segs} segs; "
                    f"{self.alloc_backend.free_segments()} free")
            h = self._next_handle
            self._next_handle += 1
            a = Allocation(h, owner, start, n_segs, n_bytes)
            self.allocations[h] = a
            self.stats.allocs += 1
            dt_ns = time.perf_counter_ns() - t0
            self.stats.alloc_ns_total += dt_ns
            used = self.n_segments - self.alloc_backend.free_segments()
            self.stats.peak_segs = max(self.stats.peak_segs, used)
            if self.obs is not None and self.obs.enabled:
                self.obs.count("mmu_allocs_total", owner=owner)
                self.obs.observe("mmu_alloc_s", dt_ns / 1e9)
            return a

    def free(self, handle: int, owner: str):
        with self._lock:
            a = self.allocations.get(handle)
            if a is None:
                raise MMUError(f"unknown handle {handle}")
            if a.owner != owner:
                self.stats.denied += 1
                if self.auditor:
                    self.auditor.record("cross_owner_free", owner,
                                        {"handle": handle,
                                         "real_owner": a.owner})
                raise IsolationViolation(
                    f"{owner} cannot free {a.owner}'s allocation")
            self.alloc_backend.free(a.start_seg, a.n_segs)
            del self.allocations[handle]
            self.stats.frees += 1

    def translate(self, handle: int, owner: str, offset: int = 0) -> int:
        """handle+offset → byte address, with ownership + bounds check.

        Holds the pool lock: ``self.allocations`` must not be read racily
        against a concurrent ``free()`` (handle reuse / mid-delete).
        """
        t0 = time.perf_counter_ns() \
            if self.obs is not None and self.obs.enabled else 0
        with self._lock:
            a = self.allocations.get(handle)
            if a is None:
                raise MMUError(f"unknown handle {handle}")
            if a.owner != owner:
                self.stats.denied += 1
                if self.auditor:
                    self.auditor.record("cross_owner_access", owner,
                                        {"handle": handle,
                                         "real_owner": a.owner})
                raise IsolationViolation(
                    f"{owner} cannot access {a.owner}'s memory")
            if not (0 <= offset < a.n_bytes):
                self.stats.denied += 1
                raise IsolationViolation(
                    f"offset {offset} outside allocation of {a.n_bytes} bytes")
            addr = a.start_seg * self.segment_bytes + offset
        if t0:
            self.obs.observe("mmu_translate_s",
                             (time.perf_counter_ns() - t0) / 1e9)
        return addr

    # ==================================================================
    # Page-table API (page = one segment, no contiguity — the paged KV
    # cache substrate; see module docstring)
    # ==================================================================
    def _alloc_single_pages(self, n: int, owner: str,
                            check_quota: bool = True,
                            quota_extra: int = 0) -> List[int]:  # holds: _lock
        """n single-segment pages, or raise (lock held by caller).

        Each fresh frame starts with refcount 1. ``check_quota=False``
        skips the quota test for mapping-neutral allocations (CoW fork,
        swap-in refault: one mapping is replaced by another, so the
        owner's logical footprint does not change). ``quota_extra``
        charges additional mappings the caller is about to create
        (shared-prefix maps) against the quota in the same check."""
        if check_quota:
            q = self.quota_segs.get(owner)
            if q is not None and \
                    self._owner_segs(owner) + n + quota_extra > q:
                self._deny(owner, "quota_exceeded")
                if self.auditor:
                    self.auditor.record("quota_exceeded", owner,
                                        {"ask_pages": n + quota_extra,
                                         "quota": q})
                raise QuotaExceeded(
                    f"{owner}: {n + quota_extra} pages over quota {q}")
        pages: List[int] = []
        for _ in range(n):
            start = self.alloc_backend.alloc(1)
            if start is None:
                for p in pages:                      # roll back partial
                    self.alloc_backend.free(p, 1)
                self._deny(owner, "oom")
                raise OutOfMemory(
                    f"{owner}: {n} pages; "
                    f"{self.alloc_backend.free_segments()} free")
            pages.append(start)
        for p in pages:
            self.frame_refs[p] = 1
        self.stats.pages_allocated += n
        used = self.n_segments - self.alloc_backend.free_segments()
        self.stats.peak_segs = max(self.stats.peak_segs, used)
        if self.obs is not None and self.obs.enabled:
            self.obs.count("mmu_pages_allocated_total", n, owner=owner)
        return pages

    def _release_frame_locked(self, p: int, owner: str):  # holds: _lock
        """Drop one reference; free the frame at refcount 0."""
        refs = self.frame_refs.get(p)
        assert refs is not None and refs > 0, \
            f"release of untracked frame {p}"
        if refs == 1:
            del self.frame_refs[p]
            self.alloc_backend.free(p, 1)
            self.stats.pages_freed += 1
            if self.obs is not None and self.obs.enabled:
                self.obs.count("mmu_pages_freed_total", 1, owner=owner)
        else:
            self.frame_refs[p] = refs - 1

    def alloc_pages(self, n: int, owner: str,
                    shared_prefix: Optional[List[int]] = None) -> PageTable:
        """Lease ``n`` fresh pages under a fresh page table
        (quota-checked). ``shared_prefix`` maps existing live frames at
        the *front* of the table first (refcount++ each, no new HBM) —
        the prefix-sharing admission path: logical blocks 0..k-1 are the
        shared prompt prefix, blocks k.. are private."""
        shared = list(shared_prefix or [])
        with self._lock:
            for p in shared:
                if p not in self.frame_refs:
                    raise MMUError(f"shared prefix frame {p} is not live")
            pages = self._alloc_single_pages(n, owner,
                                             quota_extra=len(shared))
            for p in shared:
                self.frame_refs[p] += 1
            self.stats.shared_maps += len(shared)
            if shared and self.obs is not None and self.obs.enabled:
                self.obs.count("mmu_shared_maps_total", len(shared),
                               owner=owner)
            h = self._next_handle
            self._next_handle += 1
            t = PageTable(h, owner, shared + pages)
            self.page_tables[h] = t
            return t

    def grow_pages(self, handle: int, owner: str, n: int = 1) -> PageTable:
        """Demand-grow a live table by ``n`` pages (a page fault)."""
        with self._lock:
            t = self._check_table(handle, owner, "cross_owner_grow")
            t.pages.extend(self._alloc_single_pages(n, owner))
            self.stats.page_faults += 1
            if self.obs is not None and self.obs.enabled:
                self.obs.count("mmu_page_faults_total", owner=owner)
            return t

    def free_pages(self, handle: int, owner: str):
        """Return the table's mappings; each frame is freed only when
        its last reference (other tables, pins) drops. Swapped entries
        hold no frame and are simply dropped."""
        with self._lock:
            t = self._check_table(handle, owner, "cross_owner_free")
            for p in t.pages:
                if p == SWAPPED:
                    continue
                self._release_frame_locked(p, owner)
            self.stats.frees += 1
            del self.page_tables[handle]

    def fork_page(self, handle: int, owner: str, logical: int):
        """Copy-on-write pivot: swap logical block ``logical``'s shared
        mapping for a fresh private frame and drop the old reference.
        Returns ``(old_page, new_page)`` — the *caller* copies the page
        bytes device-side (old → new) before writing. Mapping-neutral,
        so no quota check; raises OutOfMemory if the pool is dry (the
        table is left untouched)."""
        with self._lock:
            t = self._check_table(handle, owner, "cross_owner_fork")
            if not (0 <= logical < t.n_pages):
                self.stats.denied += 1
                raise IsolationViolation(
                    f"logical block {logical} outside table of "
                    f"{t.n_pages} pages")
            old = t.pages[logical]
            if old == SWAPPED:
                raise MMUError(f"block {logical} is swapped out; "
                               "refault before forking")
            new = self._alloc_single_pages(1, owner, check_quota=False)[0]
            t.pages[logical] = new
            self._release_frame_locked(old, owner)
            self.stats.cow_forks += 1
            if self.obs is not None and self.obs.enabled:
                self.obs.count("mmu_cow_forks_total", owner=owner)
            return old, new

    def retain_frame(self, page: int):
        """Pin a live frame from outside any table (prefix cache): the
        frame survives its owning tables' release until released."""
        with self._lock:
            if page not in self.frame_refs:
                raise MMUError(f"retain of untracked frame {page}")
            self.frame_refs[page] += 1
            self._pins[page] = self._pins.get(page, 0) + 1

    def release_frame(self, page: int, owner: str = "pin"):
        """Drop a ``retain_frame`` pin; frees the frame if that was the
        last reference."""
        with self._lock:
            n = self._pins.get(page, 0)
            if n <= 0:
                raise MMUError(f"release of unpinned frame {page}")
            if n == 1:
                del self._pins[page]
            else:
                self._pins[page] = n - 1
            self._release_frame_locked(page, owner)

    def frame_ref(self, page: int) -> int:
        """Current reference count of a physical frame (0 = not live)."""
        with self._lock:
            return self.frame_refs.get(page, 0)

    def swap_out_page(self, handle: int, owner: str, logical: int) -> int:
        """Mark a table entry swapped (→ host tier) and release its
        frame. Returns the old physical page so the caller can key its
        host copy. The caller must have copied the page bytes off the
        device *before* this call — the frame may be reused at once."""
        with self._lock:
            t = self._check_table(handle, owner, "cross_owner_swap")
            old = t.pages[logical]
            if old == SWAPPED:
                raise MMUError(f"block {logical} already swapped")
            t.pages[logical] = SWAPPED
            self._release_frame_locked(old, owner)
            self.stats.swap_outs += 1
            if self.obs is not None and self.obs.enabled:
                self.obs.count("mmu_swap_outs_total", owner=owner)
            return old

    def swap_in_page(self, handle: int, owner: str, logical: int) -> int:
        """Refault a swapped entry onto a fresh frame (mapping-neutral:
        the swapped entry already counts toward the owner's footprint).
        Returns the new physical page; the caller copies the host bytes
        back in."""
        with self._lock:
            t = self._check_table(handle, owner, "cross_owner_swap")
            if t.pages[logical] != SWAPPED:
                raise MMUError(f"block {logical} is not swapped out")
            new = self._alloc_single_pages(1, owner, check_quota=False)[0]
            t.pages[logical] = new
            self.stats.swap_ins += 1
            if self.obs is not None and self.obs.enabled:
                self.obs.count("mmu_swap_ins_total", owner=owner)
            return new

    def translate_page(self, handle: int, owner: str, logical: int) -> int:
        """logical block index → physical byte address (ownership +
        bounds checked — the per-access isolation gate)."""
        with self._lock:
            t = self._check_table(handle, owner, "cross_owner_access")
            if not (0 <= logical < t.n_pages):
                self.stats.denied += 1
                raise IsolationViolation(
                    f"logical block {logical} outside table of "
                    f"{t.n_pages} pages")
            if t.pages[logical] == SWAPPED:
                raise MMUError(
                    f"block {logical} is swapped out — refault first")
            return t.pages[logical] * self.segment_bytes

    def _check_table(self, handle: int, owner: str,
                     event: str) -> PageTable:  # holds: _lock
        t = self.page_tables.get(handle)
        if t is None:
            raise MMUError(f"unknown page table {handle}")
        if t.owner != owner:
            self.stats.denied += 1
            if self.auditor:
                self.auditor.record(event, owner,
                                    {"handle": handle,
                                     "real_owner": t.owner})
            raise IsolationViolation(
                f"{owner} cannot touch {t.owner}'s page table")
        return t

    # -- introspection: public methods lock; memory_stats() composes the
    # _locked internals under a single acquisition ----------------------
    def _pages_in_use_locked(self) -> int:  # holds: _lock
        return sum(1 for t in self.page_tables.values()
                   for p in t.pages if p != SWAPPED)

    def pages_in_use(self) -> int:
        """Logical mappings with a physical frame (shared frames count
        once per mapping; swapped entries count zero)."""
        with self._lock:
            return self._pages_in_use_locked()

    def frames_in_use(self) -> int:
        """Distinct physical frames live under the page API."""
        with self._lock:
            return len(self.frame_refs)

    def _swapped_pages_locked(self) -> int:  # holds: _lock
        return sum(1 for t in self.page_tables.values()
                   for p in t.pages if p == SWAPPED)

    def swapped_pages(self) -> int:
        with self._lock:
            return self._swapped_pages_locked()

    # ------------------------------------------------------------------
    def utilization(self) -> float:
        with self._lock:
            return 1.0 - self.alloc_backend.free_segments() / self.n_segments

    def free_segments(self) -> int:
        """Locked view of the backend's free-segment count."""
        with self._lock:
            return self.alloc_backend.free_segments()

    def _fragmentation_locked(self) -> float:  # holds: _lock
        free = self.alloc_backend.free_segments()
        if free == 0:
            return 0.0
        return 1.0 - self.alloc_backend.largest_free_run() / free

    def fragmentation(self) -> float:
        """External fragmentation: 1 − largest free run / free segments."""
        with self._lock:
            return self._fragmentation_locked()

    def memory_stats(self) -> dict:
        """Paging/occupancy snapshot for VMM.stats()['memory']."""
        with self._lock:
            return {
                "segments_total": self.n_segments,
                "segments_in_use":
                    self.n_segments - self.alloc_backend.free_segments(),
                "pages_in_use": self._pages_in_use_locked(),
                "page_tables": len(self.page_tables),
                "page_faults": self.stats.page_faults,
                "pages_allocated": self.stats.pages_allocated,
                "pages_freed": self.stats.pages_freed,
                "fragmentation": self._fragmentation_locked(),
                "quota_denials": dict(self.denied_by_owner),
                # page-hierarchy view (prefix sharing / CoW / swap tier)
                "frames_in_use": len(self.frame_refs),
                "shared_frames": sum(1 for r in self.frame_refs.values()
                                     if r > 1),
                "shared_maps": self.stats.shared_maps,
                "cow_forks": self.stats.cow_forks,
                "swap_outs": self.stats.swap_outs,
                "swap_ins": self.stats.swap_ins,
                "swapped_pages": self._swapped_pages_locked(),
            }

    def overlaps_ok(self) -> bool:
        """Invariant: no two live allocations/frames overlap (property
        tests) — contiguous spans and single-segment frames together.
        Shared frames appear in many tables but are *one* physical span;
        swapped entries hold no frame."""
        with self._lock:
            frames = {p for t in self.page_tables.values()
                      for p in t.pages if p != SWAPPED}
            spans = sorted(
                [(a.start_seg, a.start_seg + a.n_segs)
                 for a in self.allocations.values()]
                + [(p, p + 1) for p in frames])
            return all(spans[i][1] <= spans[i + 1][0]
                       for i in range(len(spans) - 1))

    def refcounts_consistent(self) -> bool:
        """Hierarchy invariant: every live frame's refcount equals its
        table mappings plus its pins, every count is positive, and every
        mapped frame is tracked."""
        with self._lock:
            maps: Dict[int, int] = {}
            for t in self.page_tables.values():
                for p in t.pages:
                    if p != SWAPPED:
                        maps[p] = maps.get(p, 0) + 1
            for p, r in self.frame_refs.items():
                if r <= 0 or r != maps.get(p, 0) + self._pins.get(p, 0):
                    return False
            return all(p in self.frame_refs for p in maps)
