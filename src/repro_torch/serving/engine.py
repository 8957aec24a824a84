"""Continuous-batching serving engine over MMU-backed paged KV memory —
the PyTorch port of ``repro.serving.engine`` (monolithic and chunked
prefill; attention and recurrent families).

Each batch slot owns a *position* and a *block table*:

* K/V live in shared physical page pools leased per request from the
  software MMU (:class:`repro_torch.serving.paged_kv.PagedKVCache`);
* admission prefills **only the newcomer** (batch=1, its own length)
  and scatters the result into freshly leased pages — no recompute on
  occupied slots and no full re-prefill (``stats.full_prefills`` stays
  0);
* with ``chunk_tokens > 0`` newcomers are admitted at once with a
  prefill cursor and each step writes at most ``chunk_tokens`` of prompt
  while occupied slots keep decoding; decode then runs fused (attention
  + on-device sampling, only (B,) token ids leave the device);
* decode passes a per-slot ``(B,)`` positions vector (-1 marks a dead
  slot) plus the block tables; EOS recycling frees the slot's pages back
  to the MMU the moment it finishes;
* with ``state_paging=True`` a recurrent model's per-slot rows lease
  their own pages from the same pool at admission
  (:class:`~repro_torch.serving.paged_state.PagedRecurrentState`) and
  free them at finish; in chunked mode a slot's rows are zeroed at
  admission, since the first chunk reads them as its initial state;
* the KV page hierarchy rides on chunked prefill: with
  ``share_prefix=True`` (attention-only families; the cached pages carry
  no recurrent rows) a warm admission maps the cached pages of its
  prompt's prefix and starts its prefill cursor past them (the slot's
  pages are published after its last chunk; a write into a shared page
  forks it copy-on-write), and with ``swap=True`` admission or decode
  pressure parks a victim slot — its private KV pages and recurrent rows
  move to the host tier — and the slot resumes (refaults) once the pool
  can hold it again.

* a VLM or enc-dec model takes its frontend inputs from ``extra_batch``
  (``"patches"`` / ``"frames"``, one row per slot, sliced at admission as
  the reference does) and prefills monolithically: chunked prefill is
  off. A VLM slot leases and writes pages for its ``n_prefix`` image
  rows *and* its prompt, and decodes from position ``n_prefix + plen``;
  an enc-dec slot's cross K/V rows of ``enc_len`` encoder positions sit
  in its state rows.

Host-side sampling (monolithic mode, and the first token after the last
prefill chunk) uses a seeded numpy RNG, draw for draw as the reference
does. ``submit()`` returns a request id; ``future(rid)`` exposes a
``concurrent.futures.Future`` resolved with the finished ``Request``.

Virtualized serving (``launch/serve.py --virtualized``) passes
``prefill_wrap``/``decode_wrap``, which route every model step through a
VMM tenant's data plane (on a broker thread under the queued policies),
a ``pool`` that is the tenant's MMU pool, and an ``admission_gate`` such
as :func:`pool_pressure_gate` that defers newcomers under pool pressure.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.analysis.lock_watchdog import note_callback
from repro_torch.core.mmu import MMUError
from repro_torch.models.attention import check_chunk_prefill
from repro_torch.obs import (NULL_HUB, PHASE_ADMITTED, PHASE_DECODE,
                             PHASE_DEFERRED, PHASE_PREFILL,
                             PHASE_PREFILL_CHUNK, PHASE_REFAULT,
                             PHASE_SWAP_OUT)
from repro_torch.serving.paged_kv import PagedKVCache
from repro_torch.serving.paged_state import PagedRecurrentState


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0            # 0 → greedy
    out_tokens: list = field(default_factory=list)
    done: bool = False

    def context(self) -> np.ndarray:
        """Prompt plus everything generated so far."""
        if not self.out_tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out_tokens, np.int32)])


@dataclass
class EngineStats:
    steps: int = 0
    decode_steps: int = 0
    prefills: int = 0                   # one per admitted newcomer
    prefill_chunks: int = 0             # chunked-prefill chunk count
    full_prefills: int = 0              # paged engine: must stay 0
    admitted: int = 0
    deferred: int = 0                   # admissions bounced by the MMU
    completed: int = 0
    generated_tokens: int = 0
    # engine-local paging deltas: leased counts admission-time and
    # demand-grown pages, so leased == freed once every request finished
    pages_leased: int = 0
    pages_freed: int = 0
    page_faults: int = 0
    # KV page hierarchy (engine-local deltas, same convention as above)
    shared_prefix_hits: int = 0         # warm admissions (prefix cache)
    shared_prefix_tokens: int = 0       # prompt tokens covered by sharing
    cow_forks: int = 0                  # private forks of shared pages
    swap_outs: int = 0                  # pages evicted to the host tier
    swap_ins: int = 0                   # pages refaulted back to device
    # paged recurrent state (state_paging=True): per-slot rows' pages
    state_pages_leased: int = 0
    state_pages_freed: int = 0
    state_swap_outs: int = 0            # state pages parked to host
    state_swap_ins: int = 0             # state pages refaulted back


class ServeEngine:
    def __init__(self, cfg, model, batch_size: int, capacity: int,
                 page_size: int = 16, pool=None,
                 prefill_wrap: Optional[Callable] = None,
                 decode_wrap: Optional[Callable] = None,
                 extra_batch: Optional[dict] = None, eos_id: int = -1,
                 admission_gate: Optional[Callable] = None,
                 seed: int = 0, obs=None, obs_tenant: str = "serve",
                 chunk_tokens: int = 0, share_prefix: bool = False,
                 swap: bool = False, state_paging: bool = False,
                 owner_prefix: str = ""):
        row_bytes = model.state_row_bytes()
        if share_prefix and row_bytes > 0:
            # a warm admission maps only the prefix's KV pages and starts
            # the cursor past them: the slot's recurrent rows would never
            # see the shared tokens and decode from a wrong state
            raise NotImplementedError(
                "serving: prefix sharing keeps KV pages only; a family "
                "with recurrent state rows cannot share a prefix")
        self.cfg = cfg
        self.model = model
        self.device = model.device
        self.B = batch_size
        self.capacity = capacity
        self.eos_id = eos_id
        # admission_gate(owner, n_pages) -> bool: False defers the
        # newcomer before the MMU is asked (pool-pressure hook)
        self.admission_gate = admission_gate
        # frontend inputs, one row per slot (vlm patches, enc-dec frames)
        self.extra_batch = {k: torch.as_tensor(np.asarray(v)).to(
            model.device) for k, v in (extra_batch or {}).items()}
        want = {k for k, has in (("patches", cfg.family == "vlm"),
                                 ("frames", cfg.is_encdec)) if has}
        if set(self.extra_batch) != want:
            raise ValueError(
                f"{cfg.name}: frontend inputs {sorted(want)} expected; "
                f"got {sorted(self.extra_batch)}")
        for k, v in self.extra_batch.items():
            # the rows' length sizes the cross K/V rows the state pages
            # were leased for (Model.enc_len): no other length fits
            fe = cfg.frontend
            if (v.dim() != 3 or v.shape[0] < batch_size
                    or tuple(v.shape[1:]) != (fe.n_tokens, fe.d_in)):
                raise ValueError(
                    f"{cfg.name}: {k} must be (>={batch_size}, "
                    f"{fe.n_tokens}, {fe.d_in}), one row per slot; got "
                    f"{tuple(v.shape)}")
        # rows a frontend puts before the prompt in the slot's KV (the
        # VLM's image patches): leased, written and decoded past
        self._n_prefix = model.n_prefix
        self.chunk_tokens = int(chunk_tokens)
        # vlm/enc-dec frontends need the whole prompt at once: they stay
        # monolithic (reference engine.py:120)
        self._chunked = self.chunk_tokens > 0 and not self.extra_batch
        # sharing and swap ride on chunked prefill: a warm admission
        # starts the chunk cursor past the shared span, and a parked
        # slot resumes through the same cursorless decode
        self._share = share_prefix and self._chunked
        self._swap = swap and self._chunked
        self._parked: dict = {}           # slot → saved decode position
        # slots parked mid-step, after their token was emitted but before
        # its KV write: on resume that token feeds decode once more for
        # the write but is not emitted twice
        self._emitted_parked: set = set()
        # engines sharing one pool (the model mux) namespace their
        # request owners, so two rid spaces never meet in one MMU owner
        self.owner_prefix = owner_prefix
        self.obs = obs if obs is not None else NULL_HUB
        self.obs_tenant = obs_tenant
        if self.obs.enabled:
            self.obs.registry.register_provider(
                f"engine/{obs_tenant}", lambda: dict(self.stats.__dict__))
        self.rng = np.random.default_rng(seed)
        # concurrency: submission surface (waiting/_futures/_rid/
        # completed) is lock-guarded; the step path (slots, positions,
        # cursors, kv) is single-owner — exactly one thread calls
        # step()/run_round() at a time
        self._rid = 0                                  # guarded-by: _lock
        self.waiting: "collections.deque[Request]" = \
            collections.deque()                        # guarded-by: _lock
        self.completed: dict = {}                      # guarded-by: _lock
        self._futures: dict = {}                       # guarded-by: _lock
        self._lock = threading.Lock()
        self.stats = EngineStats()
        # per-slot decode state: positions (-1 = dead) + MMU-leased pages
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.positions = np.full(batch_size, -1, np.int32)
        # when the engine sizes its pool AND pages recurrent state, size
        # it for the state rows too (the KV working set alone would leave
        # recurrent-family admissions dead on arrival)
        extra_pages = 0
        if state_paging and pool is None and row_bytes > 0:
            pb = model.kv_page_bytes(page_size)
            extra_pages = batch_size * max(1, -(-row_bytes // pb))
        self.kv = PagedKVCache(cfg, model, batch_size, capacity,
                               page_size=page_size, pool=pool,
                               obs=self.obs, share_prefix=self._share,
                               swap=self._swap, extra_pages=extra_pages)
        if self._chunked:
            check_chunk_prefill(
                self.chunk_tokens, self.kv.blocks_per_slot * page_size,
                [cfg.window if s.mixer == "swa" else 0
                 for s in model.specs if s.is_attn])
        # paged recurrent state: per-slot rows leased from the KV pool;
        # a no-op (None) for attention-only models
        self.rstate = None
        if state_paging and row_bytes > 0:
            self.rstate = PagedRecurrentState(cfg, model, batch_size,
                                              pool=self.kv.pool,
                                              obs=self.obs)
        # chunked prefill reads a slot's rows as its initial chunk state:
        # a recycled slot is zeroed at admission
        self._reset_rows = self._chunked and row_bytes > 0
        self._logits: Optional[np.ndarray] = None    # (B, V*) host copy
        # chunked-prefill bookkeeping: cursor = prompt tokens written so
        # far (-1 = not prefilling); _next = sampled-but-unemitted token
        # per slot (the fused decode path never ships logits to host)
        self._cursor = np.full(batch_size, -1, np.int64)
        self._next = np.zeros(batch_size, np.int64)
        self._rr = 0                     # chunk-scheduler rotation
        # model steps, optionally wrapped (virtualized serving routes each
        # through a VMM tenant's data plane)
        def wrap(w, fn):
            return w(fn) if w is not None else fn
        self._prefill_fn = wrap(prefill_wrap, model.prefill)
        self._chunk_fn = wrap(prefill_wrap, model.prefill_chunk_paged)
        self._decode_fn = wrap(decode_wrap, model.decode_paged)
        self._fused_fn = wrap(decode_wrap, model.decode_paged_fused)

    def _dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    def submit(self, prompt_tokens, max_new_tokens=16, temperature=0.0):
        prompt = np.asarray(prompt_tokens, np.int32)
        if self._n_prefix + len(prompt) > self.capacity:
            raise ValueError(f"prompt of {len(prompt)} tokens (after "
                             f"{self._n_prefix} frontend rows) exceeds KV "
                             f"capacity {self.capacity}")
        # one critical section: rid assignment, future registration and
        # the queue append are atomic, so FIFO order matches rid order
        with self._lock:
            rid = self._rid
            self._rid += 1
            self._futures[rid] = Future()
            self.waiting.append(Request(rid, prompt, max_new_tokens,
                                        temperature))
        if self.obs.enabled:
            self.obs.tracer.start(self.obs_tenant, rid,
                                  prompt_len=len(prompt),
                                  max_new_tokens=max_new_tokens)
        return rid

    def future(self, rid: int) -> Future:
        """Completion future for a submitted request id."""
        with self._lock:
            return self._futures[rid]

    def has_work(self) -> bool:
        with self._lock:
            return (bool(self.waiting)
                    or any(r is not None for r in self.slots))

    # ------------------------------------------------------------------
    # Admission: prefill the newcomer alone into freshly leased pages
    # ------------------------------------------------------------------
    def _defer(self, req: Request, cause: str):
        self.stats.deferred += 1
        if self.obs.enabled:
            self.obs.tracer.event(self.obs_tenant, req.rid, PHASE_DEFERRED,
                                  cause=cause)
        with self._lock:
            self.waiting.appendleft(req)

    def _admit(self, params):
        for i in range(self.B):
            if self.slots[i] is not None:
                continue
            with self._lock:
                if not self.waiting:
                    break
                req = self.waiting.popleft()
            plen = len(req.prompt)
            # the slot's sequence: a VLM's image rows, then the prompt
            seq_len = self._n_prefix + plen
            # chunked: the admission ask is one chunk's pages, later
            # chunks fault the rest of the table in incrementally
            lease_len = (min(plen, self.chunk_tokens) if self._chunked
                         else seq_len)
            owner = f"{self.owner_prefix}req{req.rid}"
            n_pages = max(1, -(-lease_len // self.kv.page_size))
            if self.rstate is not None:
                n_pages += self.rstate.blocks_per_slot
            live = any(s is not None for s in self.slots)
            if self.admission_gate is not None:
                note_callback("engine.admission_gate")
            gated = (self.admission_gate is not None and live
                     and not self.admission_gate(owner, n_pages))
            if gated and self._swap and self._swap_out_victim():
                # swap before deny: parking a victim freed its private
                # pages — ask the gate again before deferring
                gated = not self.admission_gate(owner, n_pages)
            if gated:
                # pool pressure: defer the newcomer before touching the
                # MMU. Advisory only — with no live slot (nothing will
                # ever free a page) the lease is tried, so exhaustion
                # still surfaces as MMUError below
                self._defer(req, "pool_pressure")
                break
            prompt = req.prompt if self._share else None
            try:
                try:
                    shared = self.kv.admit(i, owner, seq_len,
                                           lease_len=lease_len,
                                           prompt=prompt)
                except MMUError:
                    # the lease bounced on a dry pool: park a victim and
                    # retry once
                    if not (self._swap and self._swap_out_victim()):
                        raise
                    shared = self.kv.admit(i, owner, seq_len,
                                           lease_len=lease_len,
                                           prompt=prompt)
            except MMUError as exc:
                # pool exhausted / quota: requeue at the front, retry
                # next step once EOS recycling returns pages
                self._defer(req, type(exc).__name__)
                if all(s is None for s in self.slots):
                    raise         # nothing live will ever free a page
                break
            if self.rstate is not None:
                # the slot's recurrent-state pages lease from the same
                # pool, under the same deferral story
                try:
                    try:
                        self.rstate.admit(i, owner)
                    except MMUError:
                        if not (self._swap and self._swap_out_victim()):
                            raise
                        self.rstate.admit(i, owner)
                except MMUError as exc:
                    self.kv.release(i)     # its lease was not counted yet
                    self._defer(req, type(exc).__name__)
                    if all(s is None for s in self.slots):
                        raise
                    break
                self.stats.state_pages_leased += self.rstate.blocks_per_slot
            if self._reset_rows:
                self.kv.state = self.model.reset_state_row(self.kv.state, i)
            if shared:
                self.stats.shared_prefix_hits += 1
                self.stats.shared_prefix_tokens += shared
            if self.obs.enabled:
                self.obs.tracer.event(self.obs_tenant, req.rid,
                                      PHASE_ADMITTED, slot=i,
                                      pages=self.kv.tables[i].n_pages,
                                      shared_tokens=shared)
            self.slots[i] = req
            self.stats.admitted += 1
            self.stats.pages_leased += self.kv.tables[i].n_pages
            if self._chunked:
                # the chunk scheduler writes the prompt across later
                # steps; positions stays -1 (dead for decode) meanwhile.
                # A warm admission starts past the shared span, whose
                # K/V pages are already resident and mapped
                self.positions[i] = -1
                self._cursor[i] = shared
                continue
            logits, caches = self._prefill_fn(params,
                                              self._newcomer_batch(i, req))
            self.kv.write_prefill(caches, i, seq_len)
            if self.obs.enabled:
                self.obs.tracer.event(self.obs_tenant, req.rid,
                                      PHASE_PREFILL, tokens=plen)
            logits = logits.float().cpu().numpy()
            if self._logits is None:
                self._logits = np.zeros((self.B, logits.shape[-1]),
                                        np.float32)
            self._logits[i] = logits[0]
            self.positions[i] = seq_len               # next write position
            self.stats.prefills += 1

    def _newcomer_batch(self, slot: int, req: Request) -> dict:
        """The newcomer's prefill batch: its prompt and its slot's row of
        each frontend input."""
        batch = {"tokens": self._dev(req.prompt[None])}
        for k, v in self.extra_batch.items():
            batch[k] = v[slot:slot + 1]
        return batch

    # ------------------------------------------------------------------
    # Chunked prefill: bounded prompt writes interleaved with decode
    # ------------------------------------------------------------------
    def _sample_one(self, logits, temperature):
        """Host-side sample of one token from (V*,) logits — once per
        request, for the first token after the last prefill chunk."""
        lg = logits[:self.cfg.vocab]
        if temperature <= 0.0:
            return int(np.argmax(lg))
        g = self.rng.gumbel(size=lg.shape[0])
        return int(np.argmax(lg / temperature + g))

    def _abort_prefill(self, i, exc):
        """A chunk's page fault bounced on the MMU mid-prefill: release
        everything written so far and requeue the request at the front."""
        req = self.slots[i]
        self.stats.pages_freed += self.kv.tables[i].n_pages
        self.kv.release(i)
        self._release_state(i)
        self.slots[i] = None
        self.positions[i] = -1
        self._cursor[i] = -1
        self._defer(req, f"{type(exc).__name__}_mid_prefill")
        if all(s is None for s in self.slots):
            raise exc

    def _prefill_chunks(self, params):
        """One step's chunk budget: at most ``chunk_tokens`` of prompt
        across the slots that are mid-prefill, round-robin."""
        prefilling = [i for i in range(self.B)
                      if self.slots[i] is not None and self._cursor[i] >= 0]
        if not prefilling:
            return
        budget = self.chunk_tokens
        rot = self._rr % len(prefilling)
        self._rr += 1
        for i in prefilling[rot:] + prefilling[:rot]:
            req = self.slots[i]
            plen = len(req.prompt)
            start = int(self._cursor[i])
            c = min(self.chunk_tokens, plen - start)
            if c > budget:
                break
            budget -= c
            before = self.kv.tables[i].n_pages
            try:
                # incremental leasing: fault in the pages this chunk
                # spans; write_from=start makes the whole chunk window
                # privately writable, so a warm request writing past its
                # shared span into a shared partial page forks it here
                self.kv.ensure(i, start + c - 1, write_from=start)
            except MMUError as exc:
                grown = self.kv.tables[i].n_pages - before
                self.stats.page_faults += grown
                self.stats.pages_leased += grown
                self._abort_prefill(i, exc)
                continue
            grown = self.kv.tables[i].n_pages - before
            self.stats.page_faults += grown
            self.stats.pages_leased += grown
            logits, self.kv.state = self._chunk_fn(
                params, self.kv.state,
                self._dev(req.prompt[None, start:start + c]), i,
                self._dev(self.kv.block_tables()[i]), start)
            self._cursor[i] = start + c
            self.stats.prefill_chunks += 1
            if self.obs.enabled:
                self.obs.tracer.event(self.obs_tenant, req.rid,
                                      PHASE_PREFILL_CHUNK, tokens=c,
                                      start=start)
                self.obs.observe("serve_prefill_chunk_tokens", c,
                                 tenant=self.obs_tenant)
            if start + c >= plen:
                # prefill complete: sample the first token on the host
                # (the one logits round-trip per request), then the slot
                # joins the fused decode batch
                lg = logits.float().cpu().numpy()[0]
                self._next[i] = self._sample_one(lg, req.temperature)
                self._cursor[i] = -1
                self.positions[i] = plen
                self.stats.prefills += 1
                if self._share:
                    # publish the prompt's pages: later requests with
                    # this prefix admit warm
                    self.kv.register_prefix(i, req.prompt)
                if self.obs.enabled:
                    self.obs.tracer.event(self.obs_tenant, req.rid,
                                          PHASE_PREFILL, tokens=plen)

    def _release_state(self, i: int):
        """Return slot ``i``'s recurrent-state pages (no-op without paged
        state)."""
        if self.rstate is None or self.rstate.tables[i] is None:
            return
        self.stats.state_pages_freed += self.rstate.tables[i].n_pages
        self.rstate.release(i)

    # ------------------------------------------------------------------
    # Swap tier: park a victim slot under pressure, resume when calm
    # ------------------------------------------------------------------
    def _swap_out_victim(self, exclude=None, mid_step: bool = False
                         ) -> bool:
        """Suspend one decoding slot — the one holding the most pages,
        the biggest single relief. Returns True if any pages moved."""
        candidates = [j for j in range(self.B)
                      if self.slots[j] is not None and j != exclude
                      and j not in self._parked
                      and self.positions[j] >= 0 and self._cursor[j] < 0]
        candidates.sort(key=lambda j: self.kv.tables[j].n_pages,
                        reverse=True)
        for j in candidates:
            if self._park(j, mid_step=mid_step):
                return True
        return False

    def _park(self, j: int, mid_step: bool = False) -> bool:
        """Suspend slot ``j``: private KV pages and recurrent rows to the
        host tier, its decode position saved. False if nothing moved (a
        fully shared slot without recurrent state)."""
        moved = self.kv.swap_out(j)
        smoved = 0
        if self.rstate is not None:
            self.kv.state, smoved = self.rstate.park(self.kv.state, j)
        if moved == 0 and smoved == 0:
            return False
        self._parked[j] = int(self.positions[j])
        if mid_step:
            self._emitted_parked.add(j)
        self.positions[j] = -1
        self.stats.swap_outs += moved
        self.stats.state_swap_outs += smoved
        if self.obs.enabled:
            self.obs.tracer.event(self.obs_tenant, self.slots[j].rid,
                                  PHASE_SWAP_OUT, pages=moved,
                                  state_pages=smoved)
            self.obs.flight_record(
                self.obs_tenant, "kv_swap_out",
                {"slot": j, "pages": moved, "state_pages": smoved,
                 "rid": self.slots[j].rid})
        return True

    def _try_resume(self):
        """Refault the oldest parked slot once the pool can hold it
        again. Newcomers keep priority: while the queue is non-empty and
        a slot is free, pages go to admissions first (mid-decode
        truncation guarantees progress, so parked slots never deadlock
        the engine)."""
        if not self._parked:
            return
        with self._lock:
            waiting = bool(self.waiting)
        if waiting and any(s is None for s in self.slots):
            return
        ms = self.kv.pool.memory_stats()
        free = ms["segments_total"] - ms["segments_in_use"]
        idle = not waiting and all(
            self.slots[j] is None or j in self._parked
            for j in range(self.B))
        for j in sorted(self._parked):
            need = self.kv.swapped_blocks(j)
            if self.rstate is not None:
                need += self.rstate.swapped_blocks(j)
            # reserve the growth page when the pending write position
            # sits past the table: resuming into an exactly full pool
            # would park the slot again before it emits anything
            if (self._parked[j] // self.kv.page_size
                    >= self.kv.tables[j].n_pages):
                need += 1
            if need > free:
                if not (idle and self.kv.prefix is not None
                        and len(self.kv.prefix)):
                    continue
                # only parked slots remain and prefix-cache pins hold the
                # pool: shed them — liveness beats cache warmth
                self.kv.prefix.evict_all()
                ms = self.kv.pool.memory_stats()
                free = ms["segments_total"] - ms["segments_in_use"]
                if need > free:
                    continue
            n = self.kv.swap_in(j)
            sn = 0
            if self.rstate is not None:
                self.kv.state, sn = self.rstate.refault(self.kv.state, j)
            self.positions[j] = self._parked.pop(j)
            self.stats.swap_ins += n
            self.stats.state_swap_ins += sn
            if self.obs.enabled:
                self.obs.tracer.event(self.obs_tenant, self.slots[j].rid,
                                      PHASE_REFAULT, pages=n,
                                      state_pages=sn)
                self.obs.flight_record(
                    self.obs_tenant, "kv_refault",
                    {"slot": j, "pages": n, "state_pages": sn,
                     "rid": self.slots[j].rid})
            return                       # one resume per step

    # ------------------------------------------------------------------
    # Stepping
    # ------------------------------------------------------------------
    def _finish(self, i, finished):
        r = self.slots[i]
        r.done = True
        self._parked.pop(i, None)
        self._emitted_parked.discard(i)
        self.slots[i] = None                      # recycle the slot
        self.positions[i] = -1
        self._cursor[i] = -1
        self.stats.pages_freed += self.kv.tables[i].n_pages
        self.kv.release(i)                        # pages back to the MMU
        self._release_state(i)
        with self._lock:
            self.completed[r.rid] = r
            fut = self._futures.get(r.rid)
        self.stats.completed += 1
        finished.append(r)
        if self.obs.enabled:
            self.obs.tracer.finish(self.obs_tenant, r.rid, "done",
                                   tokens=len(r.out_tokens))
        # resolve OUTSIDE the lock: set_result runs done-callbacks (user
        # code) on this thread
        if fut is not None and not fut.done():
            fut.set_result(r)

    def step(self, params) -> List[Request]:
        """One engine step: admit waiting requests into free slots, emit
        one token per active slot, recycle finished slots, advance
        decode with per-slot positions. Returns the finished requests."""
        if not self.obs.enabled:
            return self._step(params)
        t0 = time.perf_counter()
        finished = self._step(params)
        self.obs.observe("engine_step_s", time.perf_counter() - t0,
                         tenant=self.obs_tenant)
        return finished

    def _step(self, params) -> List[Request]:
        # CoW forks fire inside kv.ensure() at several call sites: take
        # the step's delta, so a fresh ``EngineStats()`` counts cleanly
        # while the cache keeps monotonic counts
        cf0 = self.kv.cow_forks
        try:
            return self._step_body(params)
        finally:
            self.stats.cow_forks += self.kv.cow_forks - cf0

    def _step_body(self, params) -> List[Request]:
        finished: List[Request] = []
        self._admit(params)
        if self._chunked:
            self._prefill_chunks(params)
        if self._swap:
            self._try_resume()
        # mid-prefill slots (positions -1) occupy a slot but don't emit
        active = [i for i in range(self.B) if self.slots[i] is not None
                  and self.positions[i] >= 0]
        if not active:
            return finished
        self.stats.steps += 1
        nxt = (self._next if self._chunked
               else self._sample(self._logits, active))
        token = np.zeros((self.B, 1), np.int32)
        for i in active:
            r = self.slots[i]
            if i in self._emitted_parked:
                # first step after a mid-step park resumed: _next[i] was
                # emitted in the step that parked the slot — feed it to
                # decode once for its pending K/V write, not emit it again
                self._emitted_parked.discard(i)
                token[i, 0] = int(nxt[i])
                continue
            if len(r.out_tokens) >= r.max_new_tokens:   # zero-budget case
                self._finish(i, finished)
                continue
            tok = int(nxt[i])
            r.out_tokens.append(tok)
            self.stats.generated_tokens += 1
            if self.obs.enabled:
                self.obs.tracer.token(self.obs_tenant, r.rid)
            token[i, 0] = tok
            if tok == self.eos_id or len(r.out_tokens) >= r.max_new_tokens:
                self._finish(i, finished)
            elif self.positions[i] >= self.capacity:
                self._finish(i, finished)               # KV budget: truncate
        for i in [i for i in range(self.B) if self.slots[i] is not None
                  and self.positions[i] >= 0]:
            if self.positions[i] < 0:
                continue       # parked by an earlier slot's swap relief
            # demand paging — engine-local deltas; demand-grown pages
            # count as leased so pages_leased/pages_freed balance at EOS
            before = self.kv.tables[i].n_pages
            failed = False
            try:
                try:
                    self.kv.ensure(i, int(self.positions[i]))
                except MMUError:
                    if not self._swap:
                        raise
                    # swap relief: park another decoder so this slot's
                    # fault can be served; with none to shed, suspend
                    # this slot itself — it resumes (and completes its
                    # pending K/V write) once pages free up
                    if self._swap_out_victim(exclude=i, mid_step=True):
                        self.kv.ensure(i, int(self.positions[i]))
                    elif self._park(i, mid_step=True):
                        continue
                    else:
                        raise
            except MMUError:
                failed = True
            grown = self.kv.tables[i].n_pages - before
            self.stats.page_faults += grown
            self.stats.pages_leased += grown
            if failed:
                # a shared pool ran dry mid-decode: truncate this slot
                # (its tokens are already delivered), don't wedge the
                # batch; pages grown before the failure were counted
                self._finish(i, finished)
        remaining = [i for i in range(self.B) if self.slots[i] is not None
                     and self.positions[i] >= 0]
        if not remaining:
            return finished
        self.stats.decode_steps += 1
        args = (params, self.kv.state, self._dev(token),
                self._dev(self.positions), self._dev(self.kv.block_tables()))
        if self._chunked:
            # fused decode: paged attention + on-device sampling — only
            # the (B,) sampled token ids cross to host, not (B, V) logits
            temps = np.zeros(self.B, np.float32)
            for i in remaining:
                temps[i] = self.slots[i].temperature
            toks, self.kv.state = self._fused_fn(
                *args, self._dev(temps), self.stats.steps)
            toks = toks.cpu().numpy()
            for i in remaining:
                self._next[i] = int(toks[i])
        else:
            logits, self.kv.state = self._decode_fn(*args)
            self._logits = logits.float().cpu().numpy()
        if self.obs.enabled:
            for i in remaining:
                self.obs.tracer.event(self.obs_tenant, self.slots[i].rid,
                                      PHASE_DECODE)
        for i in remaining:
            self.positions[i] += 1
        return finished

    def run_round(self, params) -> List[Request]:
        """Drain: step until nothing is waiting or in flight."""
        finished: List[Request] = []
        while self.has_work():
            finished.extend(self.step(params))
        return finished

    # ------------------------------------------------------------------
    def _sample(self, logits, rows):
        """Vectorized per-row host sampling: one argmax for every greedy
        row; temperature rows via the Gumbel-max trick."""
        V = self.cfg.vocab
        lg = logits[:, :V]
        out = np.argmax(lg, axis=-1).astype(np.int64)
        temps = np.zeros(logits.shape[0])
        for i in rows:
            temps[i] = self.slots[i].temperature
        hot = [i for i in rows if temps[i] > 0.0]
        if hot:
            g = self.rng.gumbel(size=(len(hot), V))
            scaled = lg[hot] / temps[hot][:, None] + g
            out[hot] = np.argmax(scaled, axis=-1)
        return out


def pool_pressure_gate(pool, util_hwm: float = 0.9,
                       headroom_pages: int = 0) -> Callable:
    """Admission-pressure hook over a shared ``SegmentPool``.

    Returns ``gate(owner, n_pages) -> bool`` for ``ServeEngine``'s
    ``admission_gate``: admit only while the pool can cover the ask plus
    ``headroom_pages`` AND *post-admission* occupancy stays at or under
    ``util_hwm`` — gating on current occupancy would let one large ask
    fill the pool outright and re-create the mid-decode ``MMUError``
    truncation this hook exists to prevent. Under pressure the engine
    defers the newcomer (it retries once EOS recycling returns pages).
    """
    def gate(owner: str, n_pages: int) -> bool:
        ms = pool.memory_stats()
        total = max(ms["segments_total"], 1)
        free = ms["segments_total"] - ms["segments_in_use"]
        util_after = (ms["segments_in_use"] + n_pages) / total
        return free >= n_pages + headroom_pages and util_after <= util_hwm
    return gate
