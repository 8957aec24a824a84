"""PagedKVCache — MMU-owned paged KV memory for the serving engine (the
PyTorch port of ``repro.serving.paged_kv``).

K/V live in shared physical page pools ``(La, num_pages, page_size, Hkv,
hd)`` over the attention layers on the model's device, built by
``Model.init_paged_state`` beside the per-slot recurrent rows (which
:class:`~repro_torch.serving.paged_state.PagedRecurrentState` leases),
and every serving slot *leases* its pages from a
:class:`repro_torch.core.mmu.SegmentPool` page table (one page = one MMU
segment):

* admission leases ``ceil(prompt_len / page_size)`` pages (or one
  chunk's worth under chunked prefill) under the request's owner id
  (quota-checked → ``QuotaExceeded``; pool exhausted → ``OutOfMemory``,
  the engine re-queues the request);
* decode and later prefill chunks grow the slot's block table on demand
  — an MMU page fault;
* EOS recycling frees the pages back to the pool.

On top of that flat lease sits the reference's three-level page
hierarchy:

* **Prefix sharing** (``share_prefix=True``): admission hashes the
  prompt's aligned page chunks against a
  :class:`~repro_torch.serving.prefix_cache.PrefixCache`; cached chunks
  are mapped by reference (MMU refcount++) instead of leased fresh, and
  the engine skips prefill for the shared span.
* **Copy-on-write**: the first write into a page whose frame refcount is
  >1 forks a private frame (``SegmentPool.fork_page``) and copies the
  page on the device (``Model.copy_kv_page``, ``index_copy_`` on device
  indices — no host sync), so sharing never leaks one owner's tokens
  into another's cache.
* **Swap tier** (``swap=True``): under pressure whole slots can be
  suspended — private pages move device→host into a
  :class:`~repro_torch.serving.swap.HostSwapTier`, block-table entries
  are marked ``SWAPPED``, and the refault path pages them back in on
  resume. With swap enabled the pool may be *smaller* than
  ``num_pages`` — oversubscription is the point.

Isolation is per request owner: each slot's table is leased, grown and
freed under its own owner id and quota in the MMU, and a multiply mapped
frame must carry the refcount that proves the sharing intentional. An
attention-free model has empty K/V pools but still leases pages, as the
reference does.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.mmu import SWAPPED, OutOfMemory, SegmentPool
from repro_torch.kernels.common import cdiv
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.swap import HostSwapTier


class PagedKVCache:
    # concurrency: single-owner — accessed only by its engine's step
    # thread; all cross-thread state lives in the SegmentPool (locked)
    """Physical page pool + per-slot block tables, leased from an MMU."""

    def __init__(self, cfg, model, batch_size: int, capacity: int,
                 page_size: int = 16, pool: Optional[SegmentPool] = None,
                 obs=None, share_prefix: bool = False,
                 swap: bool = False, extra_pages: int = 0):
        self.model = model
        self.page_size = page_size
        self.obs = obs
        self.blocks_per_slot = cdiv(capacity, page_size)
        self.num_pages = batch_size * self.blocks_per_slot
        self.page_bytes = model.kv_page_bytes(page_size)
        if pool is None:
            # extra_pages: headroom the engine asks for beyond the KV
            # working set (paged recurrent-state rows share this pool)
            pool = SegmentPool(total_bytes=(self.num_pages + extra_pages)
                               * self.page_bytes,
                               backend="bitmap",
                               segment_bytes=self.page_bytes, obs=obs)
        # the pool may be oversubscribed (the engine defers/truncates on
        # a dry pool; with ``swap=True`` it parks slots to host memory
        # instead) but must at least fit one slot's working set
        if pool.n_segments < self.blocks_per_slot:
            raise ValueError(
                f"pool has {pool.n_segments} segments; paged cache needs "
                f"at least {self.blocks_per_slot} pages "
                f"(1 page = 1 segment)")
        self.pool = pool
        # the device arrays must cover EVERY frame the MMU can hand out,
        # not just this engine's own working set: with a shared pool,
        # frames ≥ num_pages are real
        self.frame_count = max(self.num_pages, pool.n_segments)
        self.state = model.init_paged_state(batch_size, self.frame_count,
                                            page_size)
        self.tables: List[Optional[object]] = [None] * batch_size
        self.owners: List[Optional[str]] = [None] * batch_size
        # host-side block-table mirror, fixed width → stable decode shapes
        self._bt = np.zeros((batch_size, self.blocks_per_slot), np.int32)
        # the prefix cache is unbounded: its pins are evicted on demand
        # (_with_evict) when the pool runs dry
        self.prefix = PrefixCache(pool, page_size) if share_prefix else None
        self.swap_tier = HostSwapTier(obs=obs) if swap else None
        # monotonic hierarchy counters (kv_stats); forks fire inside
        # ensure(), the engine takes deltas
        self.prefix_hits = 0
        self.shared_tokens_total = 0
        self.cow_forks = 0
        self.swap_outs = 0
        self.swap_ins = 0

    # ------------------------------------------------------------------
    # Leasing (slot ↔ MMU page table)
    # ------------------------------------------------------------------
    def admit(self, slot: int, owner: str, prompt_len: int,
              lease_len: Optional[int] = None, prompt=None) -> int:
        """Lease pages for a newcomer's prompt (only the first
        ``lease_len`` tokens' worth under chunked prefill; later chunks
        grow the table through :meth:`ensure`). Raises QuotaExceeded /
        OutOfMemory without touching any slot state.

        With prefix sharing on and ``prompt`` given, cached prefix pages
        are mapped by reference and the return value is the number of
        prompt tokens the cache already covers (the engine starts its
        prefill cursor past them). Returns 0 on a cold admission."""
        assert self.tables[slot] is None, f"slot {slot} still leased"
        shared, shared_frames = 0, []
        if self.prefix is not None and prompt is not None:
            # the last prompt token is always prefilled — its logits
            # seed sampling — so the shareable span is plen - 1
            shared, shared_frames = self.prefix.lookup(
                prompt, max_tokens=prompt_len - 1)
        cover = prompt_len
        if lease_len is not None:
            cover = min(prompt_len, shared + lease_len)
        n_blocks = max(1, cdiv(cover, self.page_size))
        n_new = max(0, n_blocks - len(shared_frames))
        # one slot's worth of pages is each request-owner's quota
        self.pool.set_quota(owner, self.blocks_per_slot
                            * self.pool.segment_bytes)
        try:
            table = self._with_evict(
                lambda: self.pool.alloc_pages(
                    n_new, owner, shared_prefix=shared_frames or None))
        except Exception:
            self.pool.clear_quota(owner)     # failed lease: no stale entry
            raise
        self.tables[slot] = table
        self.owners[slot] = owner
        self._bt[slot, :] = 0
        self._bt[slot, :table.n_pages] = table.pages
        if shared:
            self.prefix_hits += 1
            self.shared_tokens_total += shared
            if self.obs is not None and self.obs.enabled:
                self.obs.count("kv_shared_pages_total", len(shared_frames))
        return shared

    def _with_evict(self, fn):
        """Run an allocating MMU op; on OutOfMemory shed prefix-cache
        pins (LRU first, then everything) and retry — shared immutable
        pages are reclaimed before any allocation is refused."""
        try:
            return fn()
        except OutOfMemory:
            if self.prefix is None or len(self.prefix) == 0:
                raise
            self.prefix.evict(max(4, len(self.prefix) // 4))
            try:
                return fn()
            except OutOfMemory:
                self.prefix.evict_all()
                return fn()

    def ensure(self, slot: int, pos: int, write_from: Optional[int] = None
               ) -> bool:
        """Grow the slot's table so write position ``pos`` has a page (an
        MMU page fault when growth happens), then make every page in the
        write window ``[write_from or pos, pos]`` privately writable —
        refaulting swapped pages and CoW-forking shared frames. Returns
        True if the table grew."""
        table = self.tables[slot]
        blk = pos // self.page_size
        grew = False
        while table.n_pages <= blk:
            self._with_evict(
                lambda: self.pool.grow_pages(table.handle,
                                             self.owners[slot]))
            self._bt[slot, table.n_pages - 1] = table.pages[-1]
            grew = True
        first = (write_from if write_from is not None
                 else pos) // self.page_size
        for b in range(first, blk + 1):
            self._make_writable(slot, b)
        return grew

    def release(self, slot: int):
        """EOS recycling: return the slot's pages to the pool (shared
        frames just drop a ref) and discard any swapped payloads."""
        table = self.tables[slot]
        if table is None:
            return
        if self.swap_tier is not None:
            self.swap_tier.drop(table.handle)
        self.pool.free_pages(table.handle, self.owners[slot])
        self.pool.clear_quota(self.owners[slot])
        self.tables[slot] = None
        self.owners[slot] = None
        self._bt[slot, :] = 0

    # ------------------------------------------------------------------
    # Page hierarchy: sharing / copy-on-write / swap
    # ------------------------------------------------------------------
    def register_prefix(self, slot: int, prompt) -> int:
        """Publish a freshly prefilled slot's pages into the prefix cache
        (pins their frames). No-op when sharing is off."""
        if self.prefix is None:
            return 0
        return self.prefix.insert(prompt, list(self.tables[slot].pages))

    def _page_index(self, page: int) -> torch.Tensor:
        """``page`` as a (1,) int64 tensor on the pools' device; a card
        gets it through pinned memory without a host sync."""
        t = torch.tensor([page], dtype=torch.long)
        if self.model.device.type != "cuda":
            return t.to(self.model.device)
        return t.pin_memory().to(self.model.device, non_blocking=True)

    def _make_writable(self, slot: int, blk: int):
        """Guarantee ``blk`` is backed by a private resident frame:
        refault if swapped, CoW-fork (+ device page copy) if shared."""
        table = self.tables[slot]
        page = table.pages[blk]
        if page == SWAPPED:
            self._refault_block(slot, blk)
            return
        if self.pool.frame_ref(page) <= 1:
            return
        old, new = self._with_evict(
            lambda: self.pool.fork_page(table.handle, self.owners[slot],
                                        blk))
        self.state = self.model.copy_kv_page(
            self.state, self._page_index(old), self._page_index(new))
        self._bt[slot, blk] = new
        self.cow_forks += 1
        if self.obs is not None and self.obs.enabled:
            self.obs.count("kv_cow_forks_total")

    def _refault_block(self, slot: int, blk: int):
        """Page a swapped block back in: fresh frame from the MMU, then
        host→device scatter of the saved payload."""
        t0 = time.perf_counter()
        table = self.tables[slot]
        new = self._with_evict(
            lambda: self.pool.swap_in_page(table.handle, self.owners[slot],
                                           blk))
        payload = self.swap_tier.pop((table.handle, blk))
        if payload is not None:
            dev = self.swap_tier.load(payload, self.model.device)
            self.state = self.model.write_kv_page(self.state, new, dev)
        self._bt[slot, blk] = new
        self.swap_ins += 1
        if self.obs is not None and self.obs.enabled:
            self.obs.count("kv_refaults_total")
            self.obs.observe("kv_refault_s", time.perf_counter() - t0)

    def swap_out(self, slot: int) -> int:
        """Evict the slot's privately held pages to the host tier
        (device→host gather, then the frame released to the MMU). Shared
        frames stay resident — dropping our ref would free nothing.
        Returns pages moved."""
        assert self.swap_tier is not None, "swap tier not enabled"
        t0 = time.perf_counter()
        table = self.tables[slot]
        moved = 0
        for blk in range(table.n_pages):
            page = table.pages[blk]
            if page == SWAPPED or self.pool.frame_ref(page) > 1:
                continue
            self.swap_tier.put((table.handle, blk),
                               self.model.read_kv_page(self.state, page))
            self.pool.swap_out_page(table.handle, self.owners[slot], blk)
            self._bt[slot, blk] = 0
            moved += 1
        self.swap_outs += moved
        if moved and self.obs is not None and self.obs.enabled:
            self.obs.count("kv_swapped_pages_total", moved)
            self.obs.observe("kv_swap_out_s", time.perf_counter() - t0)
        return moved

    def swap_in(self, slot: int) -> int:
        """Refault every swapped block of a suspended slot (resume)."""
        table = self.tables[slot]
        n = 0
        for blk in range(table.n_pages):
            if table.pages[blk] == SWAPPED:
                self._refault_block(slot, blk)
                n += 1
        return n

    def swapped_blocks(self, slot: int) -> int:
        table = self.tables[slot]
        if table is None:
            return 0
        return sum(1 for p in table.pages if p == SWAPPED)

    # ------------------------------------------------------------------
    # Device state
    # ------------------------------------------------------------------
    def write_prefill(self, caches, slot: int, length: int):
        """Scatter a batch=1 prefill cache into the slot's leased pages
        and rows."""
        block_row = torch.from_numpy(self._bt[slot]).to(self.model.device)
        self.state = self.model.write_prefill_paged(
            self.state, caches, slot, block_row, length, self.page_size)

    def block_tables(self) -> np.ndarray:
        """(B, blocks_per_slot) int32 — padded entries are 0 (any
        in-range page; reads of them are masked by per-slot lengths)."""
        return self._bt.copy()

    # ------------------------------------------------------------------
    # Isolation / introspection
    # ------------------------------------------------------------------
    def translate(self, slot: int, logical: int, owner: str) -> int:
        """Ownership-checked logical block → physical byte address; a
        cross-slot access raises IsolationViolation through the MMU."""
        return self.pool.translate_page(self.tables[slot].handle, owner,
                                        logical)

    def live_pages(self) -> dict:
        """slot → list of physical pages (property-test surface)."""
        return {i: list(t.pages) for i, t in enumerate(self.tables)
                if t is not None}

    def no_double_mapping(self) -> bool:
        """Every multiply mapped frame carries an MMU refcount at least
        as large as its mapping count — sharing is legal only when the
        refcounts prove it intentional."""
        counts: dict = {}
        for t in self.tables:
            if t is None:
                continue
            for p in t.pages:
                if p != SWAPPED:
                    counts[p] = counts.get(p, 0) + 1
        return all(n == 1 or self.pool.frame_ref(p) >= n
                   for p, n in counts.items())

    def tables_in_bounds(self) -> bool:
        return all(p == SWAPPED or 0 <= p < self.pool.n_segments
                   for t in self.tables if t is not None
                   for p in t.pages)

    def memory_stats(self) -> dict:
        return self.pool.memory_stats()

    def kv_stats(self) -> dict:
        """Hierarchy counters and the sub-tiers' stats (benchmark
        surface)."""
        out = {
            "prefix_hits": self.prefix_hits,
            "shared_tokens_total": self.shared_tokens_total,
            "cow_forks": self.cow_forks,
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
        }
        if self.prefix is not None:
            out["prefix_cache"] = self.prefix.stats()
        if self.swap_tier is not None:
            out["swap_tier"] = self.swap_tier.stats()
        return out
