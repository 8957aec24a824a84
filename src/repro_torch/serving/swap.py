"""HostSwapTier — host-memory backing store for swapped device state (the
PyTorch port of ``repro.serving.swap``).

Under pressure a victim's private state moves device→host through the
:class:`~repro_torch.core.shell.TransferEngine`, so DMA bytes and stage
timings land in the same accounting as every other host↔device move,
and its frames go back to the MMU; the refault path pages the payload
back in on resume. ``PagedKVCache`` parks KV pages here and
:class:`~repro_torch.serving.paged_state.PagedRecurrentState` per-slot
recurrent rows.

Payloads are keyed ``(page_table_handle, logical_block)``: handles are
never reused across leases, so a stale payload can never be refaulted
into a different request's pages. Each payload records its leaves' torch
dtypes (a bf16 leaf crosses as its int16 bits) and is loaded back onto
the device the caller names.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.shell import TransferEngine


class HostSwapTier:
    # concurrency: single-owner — used only by its engine's step thread;
    # the TransferEngine it calls locks its own counters
    """Keyed host store of device payloads (flat leaf lists)."""

    def __init__(self, transfer: TransferEngine = None, obs=None):
        self.transfer = transfer if transfer is not None \
            else TransferEngine(mode="vm_nocopy")
        self.obs = obs
        self._store: Dict[Tuple[int, int],
                          Tuple[List[np.ndarray], List[torch.dtype]]] = {}
        self.bytes_stored = 0
        self.peak_bytes = 0
        self.puts = 0
        self.pops = 0

    def __len__(self) -> int:
        return len(self._store)

    def put(self, key: Tuple[int, int], device_leaves) -> int:
        """Device→host copy of one payload's leaves; returns bytes
        moved."""
        host = [self.transfer.d2h(a) for a in device_leaves]
        dtypes = [a.dtype for a in device_leaves]
        nbytes = sum(a.nbytes for a in host)
        self._store[key] = (host, dtypes)
        self.puts += 1
        self.bytes_stored += nbytes
        self.peak_bytes = max(self.peak_bytes, self.bytes_stored)
        if self.obs is not None and self.obs.enabled:
            self.obs.count("kv_swap_bytes_total", nbytes)
        return nbytes

    def pop(self, key: Tuple[int, int]):
        """Take a payload ``(host leaves, dtypes)`` out of the tier (None
        if absent — e.g. a mapping-only test without device arrays)."""
        payload = self._store.pop(key, None)
        if payload is not None:
            self.pops += 1
            self.bytes_stored -= sum(a.nbytes for a in payload[0])
        return payload

    def load(self, payload, device) -> List[torch.Tensor]:
        """Host→device for a popped payload (the refault data move),
        onto ``device``."""
        host, dtypes = payload
        return [self.transfer.h2d(a, device=device, dtype=d)
                for a, d in zip(host, dtypes)]

    def drop(self, handle: int) -> int:
        """Discard every payload of a released page table (EOS while
        suspended / aborted mid-swap). Returns payloads dropped."""
        stale = [k for k in self._store if k[0] == handle]
        for k in stale:
            self.bytes_stored -= sum(a.nbytes for a in self._store[k][0])
            del self._store[k]
        return len(stale)

    def stats(self) -> dict:
        return {
            "payloads": len(self._store),
            "bytes_stored": self.bytes_stored,
            "peak_bytes": self.peak_bytes,
            "puts": self.puts,
            "pops": self.pops,
        }
