"""PagedKVCache — MMU-owned paged KV memory for the serving engine (the
PyTorch port of ``repro.serving.paged_kv``, leasing subset).

K/V live in shared physical page pools ``(L, num_pages, page_size, Hkv,
hd)`` on the model's device, built by ``Model.init_paged_state``, and
every serving slot *leases* its pages from a
:class:`repro_torch.core.mmu.SegmentPool` page table (one page = one MMU
segment):

* admission leases ``ceil(prompt_len / page_size)`` pages (or one
  chunk's worth under chunked prefill) under the request's owner id
  (quota-checked → ``QuotaExceeded``; pool exhausted → ``OutOfMemory``,
  the engine re-queues the request);
* decode and later prefill chunks grow the slot's block table on demand
  — an MMU page fault;
* EOS recycling frees the pages back to the pool.

The reference's page hierarchy (prefix sharing with copy-on-write, the
host swap tier) is not ported yet: ``share_prefix=True`` and
``swap=True`` raise ``NotImplementedError``.

Isolation is per request owner: each slot's table is leased, grown and
freed under its own owner id and quota in the MMU.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.mmu import SegmentPool
from repro_torch.kernels.common import cdiv


class PagedKVCache:
    # concurrency: single-owner — accessed only by its engine's step
    # thread; all cross-thread state lives in the SegmentPool (locked)
    """Physical page pool + per-slot block tables, leased from an MMU."""

    def __init__(self, cfg, model, batch_size: int, capacity: int,
                 page_size: int = 16, pool: Optional[SegmentPool] = None,
                 obs=None, share_prefix: bool = False,
                 swap: bool = False):
        if share_prefix or swap:
            raise NotImplementedError(
                "paged KV: prefix sharing and the swap tier are not "
                "ported yet")
        self.model = model
        self.page_size = page_size
        self.blocks_per_slot = cdiv(capacity, page_size)
        self.num_pages = batch_size * self.blocks_per_slot
        self.page_bytes = model.kv_page_bytes(page_size)
        if pool is None:
            pool = SegmentPool(total_bytes=self.num_pages * self.page_bytes,
                               backend="bitmap",
                               segment_bytes=self.page_bytes, obs=obs)
        # the pool may be oversubscribed (the engine defers/truncates on
        # a dry pool) but must at least fit one slot's working set
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
        self.state = model.init_paged_state(self.frame_count, page_size)
        self.tables: List[Optional[object]] = [None] * batch_size
        self.owners: List[Optional[str]] = [None] * batch_size
        # host-side block-table mirror, fixed width → stable decode shapes
        self._bt = np.zeros((batch_size, self.blocks_per_slot), np.int32)

    # ------------------------------------------------------------------
    # Leasing (slot ↔ MMU page table)
    # ------------------------------------------------------------------
    def admit(self, slot: int, owner: str, prompt_len: int,
              lease_len: Optional[int] = None):
        """Lease pages for a newcomer's prompt (only the first
        ``lease_len`` tokens' worth under chunked prefill; later chunks
        grow the table through :meth:`ensure`). Raises QuotaExceeded /
        OutOfMemory without touching any slot state."""
        assert self.tables[slot] is None, f"slot {slot} still leased"
        cover = prompt_len if lease_len is None \
            else min(prompt_len, lease_len)
        n_blocks = max(1, cdiv(cover, self.page_size))
        # one slot's worth of pages is each request-owner's quota
        self.pool.set_quota(owner, self.blocks_per_slot
                            * self.pool.segment_bytes)
        try:
            table = self.pool.alloc_pages(n_blocks, owner)
        except Exception:
            self.pool.clear_quota(owner)     # failed lease: no stale entry
            raise
        self.tables[slot] = table
        self.owners[slot] = owner
        self._bt[slot, :] = 0
        self._bt[slot, :table.n_pages] = table.pages

    def ensure(self, slot: int, pos: int):
        """Grow the slot's table so write position ``pos`` has a page (an
        MMU page fault when growth happens)."""
        table = self.tables[slot]
        while table.n_pages <= pos // self.page_size:
            self.pool.grow_pages(table.handle, self.owners[slot])
            self._bt[slot, table.n_pages - 1] = table.pages[-1]

    def release(self, slot: int):
        """EOS recycling: return the slot's pages to the pool."""
        table = self.tables[slot]
        if table is None:
            return
        self.pool.free_pages(table.handle, self.owners[slot])
        self.pool.clear_quota(self.owners[slot])
        self.tables[slot] = None
        self.owners[slot] = None
        self._bt[slot, :] = 0

    # ------------------------------------------------------------------
    # Device state
    # ------------------------------------------------------------------
    def write_prefill(self, caches, slot: int, length: int):
        """Scatter a batch=1 prefill cache into the slot's leased pages."""
        block_row = torch.from_numpy(self._bt[slot]).to(self.model.device)
        self.state = self.model.write_prefill_paged(
            self.state, caches, block_row, length, self.page_size)

    def block_tables(self) -> np.ndarray:
        """(B, blocks_per_slot) int32 — padded entries are 0 (any
        in-range page; reads of them are masked by per-slot lengths)."""
        return self._bt.copy()

    # ------------------------------------------------------------------
    # Isolation / introspection
    # ------------------------------------------------------------------
    def no_double_mapping(self) -> bool:
        """No physical page is mapped by two live slots."""
        seen = [p for t in self.tables if t is not None for p in t.pages]
        return len(seen) == len(set(seen))

    def tables_in_bounds(self) -> bool:
        return all(0 <= p < self.pool.n_segments
                   for t in self.tables if t is not None for p in t.pages)

    def memory_stats(self) -> dict:
        return self.pool.memory_stats()
