"""PrefixCache — hash-chained prompt-prefix → physical-page index (the
PyTorch port's copy of ``repro.serving.prefix_cache``; host-side only).

Millions of users share the same system prompt; their KV pages for that
span are byte-identical. This cache maps *aligned prompt-prefix chunks*
(one KV page each) to the physical frames that already hold them, so a
warm admission leases the shared span by reference (MMU refcount++, no
HBM, no prefill) and only computes the private suffix.

Keys are a **hash chain**: page ``k``'s key is
``H(key_{k-1} ‖ tokens[k·ps:(k+1)·ps])`` — equal keys imply equal whole
prefixes, so a lookup can never splice pages from different histories.
Besides full pages the cache keeps **partial-tail** entries (a prompt's
last ``len % ps`` tokens): a request whose prompt *extends* a cached
prompt maps that partially-filled page too and copy-on-writes it on its
first write past the shared span.

Entries pin their frame via ``SegmentPool.retain_frame`` so shared
pages survive the original owner's EOS; eviction is LRU, either at the
``capacity_pages`` watermark or on demand (``evict``) when the pool
runs dry — shared immutable pages are the first thing given back under
pressure, before any admission is denied.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

_SEED = b"kv-prefix-chain-v1"


def _chain(prev: bytes, tokens: np.ndarray) -> bytes:
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.digest()


class PrefixCache:
    # concurrency: single-owner — driven by one engine step thread; the
    # pin/unpin calls it makes go through the pool's own lock
    """LRU map of hash-chained prompt prefixes to pinned physical pages."""

    def __init__(self, pool, page_size: int,
                 capacity_pages: Optional[int] = None):
        self.pool = pool
        self.page_size = page_size
        self.capacity_pages = capacity_pages
        # key → physical frame. Full-page key: ("full", chain_digest);
        # partial-tail key: ("tail", chain_digest_incl_tail, tail_len).
        self._entries: "OrderedDict[tuple, int]" = OrderedDict()
        # chain_digest → {tail_len: count} — lookup needs to know which
        # tail lengths exist under a matched prefix before it can hash
        # the candidate slice of the probe prompt
        self._tails: Dict[bytes, Dict[int, int]] = {}
        # tail entry key → its chain digest, so eviction can clean the
        # tail index without re-hashing
        self._tail_parent: Dict[tuple, bytes] = {}
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------------
    def lookup(self, prompt, max_tokens: int) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``prompt`` covering at most
        ``max_tokens`` tokens → ``(shared_tokens, frames)``. Callers cap
        ``max_tokens`` at ``len(prompt) - 1`` so at least the last
        prompt token is always prefilled (its logits seed sampling)."""
        prompt = np.asarray(prompt, np.int32)
        ps = self.page_size
        frames: List[int] = []
        key = _SEED
        k = 0
        while (k + 1) * ps <= min(max_tokens, len(prompt)):
            nk = _chain(key, prompt[k * ps:(k + 1) * ps])
            frame = self._entries.get(("full", nk))
            if frame is None:
                break
            self._entries.move_to_end(("full", nk))
            frames.append(frame)
            key = nk
            k += 1
        shared = k * ps
        # partial tail: the longest cached tail under the matched chain
        # whose tokens equal ours (hash compare) still fits the cap
        for tl in sorted(self._tails.get(key, ()), reverse=True):
            if shared + tl > min(max_tokens, len(prompt)):
                continue
            tk = ("tail", _chain(key, prompt[shared:shared + tl]), tl)
            frame = self._entries.get(tk)
            if frame is not None:
                self._entries.move_to_end(tk)
                frames.append(frame)
                shared += tl
                break
        if shared:
            self.hits += 1
        else:
            self.misses += 1
        return shared, frames

    # ------------------------------------------------------------------
    def insert(self, prompt, pages: List[int]) -> int:
        """Publish a freshly prefilled prompt's pages: every full page
        plus the partial tail, each pinned (refcount++). Pages already
        cached under the same chain are skipped, so a warm request only
        publishes its new suffix. Returns newly pinned entries."""
        prompt = np.asarray(prompt, np.int32)
        ps = self.page_size
        key = _SEED
        pinned = 0
        for k in range(len(prompt) // ps):
            key = _chain(key, prompt[k * ps:(k + 1) * ps])
            ek = ("full", key)
            if ek in self._entries:
                self._entries.move_to_end(ek)
                continue
            if k >= len(pages) or pages[k] < 0:     # swapped / missing
                continue
            self.pool.retain_frame(pages[k])
            self._entries[ek] = pages[k]
            pinned += 1
        tail_len = len(prompt) % ps
        blk = len(prompt) // ps
        if tail_len and blk < len(pages) and pages[blk] >= 0:
            ek = ("tail", _chain(key, prompt[blk * ps:]), tail_len)
            if ek not in self._entries:
                self.pool.retain_frame(pages[blk])
                self._entries[ek] = pages[blk]
                tails = self._tails.setdefault(key, {})
                tails[tail_len] = tails.get(tail_len, 0) + 1
                self._tail_parent[ek] = key
                pinned += 1
            else:
                self._entries.move_to_end(ek)
        self.insertions += pinned
        if self.capacity_pages is not None:
            while len(self._entries) > self.capacity_pages:
                self._evict_one()
        return pinned

    # ------------------------------------------------------------------
    def _evict_one(self) -> bool:
        """Unpin the LRU entry. Returns True if dropping the pin
        actually freed the frame (no live table still maps it)."""
        if not self._entries:
            return False
        ek, frame = self._entries.popitem(last=False)
        if ek[0] == "tail":
            parent = self._tail_parent.pop(ek, None)
            if parent is not None and parent in self._tails:
                tl = ek[2]
                tails = self._tails[parent]
                tails[tl] = tails.get(tl, 1) - 1
                if tails[tl] <= 0:
                    del tails[tl]
                if not tails:
                    del self._tails[parent]
        last = self.pool.frame_ref(frame) == 1
        self.pool.release_frame(frame, owner="prefix_cache")
        self.evictions += 1
        return last

    def evict(self, n_entries: int) -> int:
        """Drop up to ``n_entries`` LRU entries; returns how many frames
        were actually freed (a pin shared with a live table frees 0)."""
        freed = 0
        for _ in range(min(n_entries, len(self._entries))):
            freed += int(self._evict_one())
        return freed

    def evict_all(self) -> int:
        return self.evict(len(self._entries))

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "insertions": self.insertions,
            "evictions": self.evictions,
        }
