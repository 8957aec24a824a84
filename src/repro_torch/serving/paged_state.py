"""PagedRecurrentState — MMU-leased per-slot recurrent state (the PyTorch
port of ``repro.serving.paged_state``).

Attention families keep their serving memory in KV pages; recurrent
families (RWKV-6 time-mix ``shift``/``s``, RG-LRU ``h``/``conv``,
channel-mix ``shift``) keep a fixed-size per-slot row instead. This
module gives those rows the paged KV cache's virtualization story:

* admission leases ``ceil(state_row_bytes / segment_bytes)`` pages from
  the same :class:`~repro_torch.core.mmu.SegmentPool` the KV cache draws
  from, under a per-request ``<owner>/state`` quota — recurrent state is
  tenant-accountable memory, visible in ``memory_stats()``;
* under pressure a slot *parks*: the row is gathered device→host into a
  :class:`~repro_torch.serving.swap.HostSwapTier` (DMA-metered), the
  device row is zeroed (the host copy is the only copy — refault must
  restore it or outputs diverge), and the frames are released via
  ``swap_out_page``;
* resume *refaults*: fresh frames via ``swap_in_page``, then the saved
  leaves scatter back into the slot's row on the state's device.

The model's row helpers update the state in place and return it. A
model with no per-slot rows (pure attention) reports
``state_row_bytes() == 0`` and this class degrades to a no-op.
"""
from __future__ import annotations

import time
from typing import List, Optional

from repro_torch.core.mmu import SWAPPED, SegmentPool
from repro_torch.kernels.common import cdiv
from repro_torch.serving.swap import HostSwapTier


class PagedRecurrentState:
    # concurrency: single-owner — accessed only by its engine's step
    # thread; all cross-thread state lives in the SegmentPool (locked)
    """Per-slot recurrent-state rows leased from an MMU segment pool."""

    def __init__(self, cfg, model, batch_size: int,
                 pool: SegmentPool, obs=None, transfer=None):
        self.cfg = cfg
        self.model = model
        self.B = batch_size
        self.pool = pool
        self.obs = obs
        self.row_bytes = int(model.state_row_bytes())
        self.enabled = self.row_bytes > 0
        self.page_bytes = pool.segment_bytes
        self.blocks_per_slot = max(1, cdiv(self.row_bytes,
                                           self.page_bytes)) \
            if self.enabled else 0
        self.tables: List[Optional[object]] = [None] * batch_size
        self.owners: List[Optional[str]] = [None] * batch_size
        self.tier = HostSwapTier(transfer=transfer, obs=obs) \
            if self.enabled else None
        # monotonic counters (the engine takes per-call deltas)
        self.pages_leased = 0
        self.pages_freed = 0
        self.swap_outs = 0
        self.swap_ins = 0

    # ------------------------------------------------------------------
    # Leasing
    # ------------------------------------------------------------------
    def _owner(self, owner: str) -> str:
        # state pages live under their own quota namespace so the KV
        # cache's per-slot page quota is not consumed by state leases
        return f"{owner}/state"

    def admit(self, slot: int, owner: str):
        """Lease the slot's state pages. Raises MMUError (quota / OOM)
        without touching slot bookkeeping — the engine defers the
        request exactly as it does for a bounced KV lease."""
        if not self.enabled:
            return
        assert self.tables[slot] is None, f"slot {slot} still leased"
        so = self._owner(owner)
        self.pool.set_quota(so, self.blocks_per_slot * self.page_bytes)
        try:
            table = self.pool.alloc_pages(self.blocks_per_slot, so)
        except Exception:
            self.pool.clear_quota(so)        # failed lease: no stale entry
            raise
        self.tables[slot] = table
        self.owners[slot] = so
        self.pages_leased += self.blocks_per_slot
        if self.obs is not None and self.obs.enabled:
            self.obs.count("state_pages_leased_total",
                           self.blocks_per_slot)

    def release(self, slot: int):
        """EOS recycling: drop any parked payload, free the pages."""
        table = self.tables[slot]
        if table is None:
            return
        self.tier.drop(table.handle)
        self.pages_freed += table.n_pages
        self.pool.free_pages(table.handle, self.owners[slot])
        self.pool.clear_quota(self.owners[slot])
        self.tables[slot] = None
        self.owners[slot] = None

    # ------------------------------------------------------------------
    # Park / refault (the host swap tier)
    # ------------------------------------------------------------------
    def park(self, state, slot: int):
        """Suspend the slot's recurrent state: rows gather device→host,
        the device row is zeroed (the host payload becomes the only
        copy), and every state page swaps out. Returns
        ``(state', pages_moved)`` — 0 when disabled or already parked."""
        table = self.tables[slot]
        if not self.enabled or table is None:
            return state, 0
        if self.swapped_blocks(slot):
            return state, 0                  # already parked
        t0 = time.perf_counter()
        leaves = self.model.read_state_row(state, slot)
        self.tier.put((table.handle, 0), leaves)
        state = self.model.reset_state_row(state, slot)
        for blk in range(table.n_pages):
            self.pool.swap_out_page(table.handle, self.owners[slot], blk)
        self.swap_outs += table.n_pages
        if self.obs is not None and self.obs.enabled:
            self.obs.count("state_swapped_pages_total", table.n_pages)
            self.obs.observe("state_swap_out_s",
                             time.perf_counter() - t0)
        return state, table.n_pages

    def refault(self, state, slot: int):
        """Resume: fresh frames for every swapped state page, then the
        parked payload scatters back into the slot's row. Returns
        ``(state', pages_moved)``. Raises MMUError if the pool cannot
        back the pages yet."""
        table = self.tables[slot]
        if not self.enabled or table is None:
            return state, 0
        swapped = [blk for blk in range(table.n_pages)
                   if table.pages[blk] == SWAPPED]
        if not swapped:
            return state, 0
        t0 = time.perf_counter()
        for blk in swapped:
            self.pool.swap_in_page(table.handle, self.owners[slot], blk)
        payload = self.tier.pop((table.handle, 0))
        if payload is not None:
            dev = self.tier.load(payload, self.model.device)
            state = self.model.write_state_row(state, slot, dev)
        self.swap_ins += len(swapped)
        if self.obs is not None and self.obs.enabled:
            self.obs.count("state_refaults_total", len(swapped))
            self.obs.observe("state_refault_s", time.perf_counter() - t0)
        return state, len(swapped)

    def swapped_blocks(self, slot: int) -> int:
        table = self.tables[slot]
        if table is None:
            return 0
        return sum(1 for p in table.pages if p == SWAPPED)

    # ------------------------------------------------------------------
    # Introspection (property-test surfaces)
    # ------------------------------------------------------------------
    def live_pages(self) -> dict:
        """slot → list of physical state pages."""
        return {i: list(t.pages) for i, t in enumerate(self.tables)
                if t is not None}

    def stats(self) -> dict:
        return {
            "row_bytes": self.row_bytes,
            "blocks_per_slot": self.blocks_per_slot,
            "pages_leased": self.pages_leased,
            "pages_freed": self.pages_freed,
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
            "tier": self.tier.stats() if self.tier is not None else {},
        }
