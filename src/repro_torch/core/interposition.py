"""Interposition — recording and replaying the VM↔device interaction.

The paper: "Interposition is the ability of recording accesses between the
VMs and physical device with software … empowers VM live migration,
checkpoint and restore." Here:

* ``OpLog`` — every mediated operation is appended (FEV: all ops;
  HYBRID: control plane always, data plane sampled). Queryable for the
  criteria report.
* ``TenantCheckpointer`` — snapshot/restore of a tenant's device-resident
  state (params / optimizer / step / loaded-program identity) through the
  checkpointing substrate; restore places the state on the *target*
  slice's device, which is what makes live migration possible.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

from repro_torch.checkpointing import latest as ckpt_latest
from repro_torch.checkpointing import restore as ckpt_restore
from repro_torch.checkpointing import save as ckpt_save


@dataclass
class OpRecord:
    tenant: str
    op: str
    detail: dict
    t_start: float
    t_end: float = 0.0

    @property
    def duration_ms(self):
        return (self.t_end - self.t_start) * 1e3


class OpLog:
    def __init__(self, sample_data_plane: float = 1.0):
        self.records: List[OpRecord] = []
        self.sample_data_plane = sample_data_plane
        self._n_data_ops = 0
        self._lock = threading.Lock()

    CONTROL_OPS = {"open", "close", "alloc", "free", "reprogram",
                   "checkpoint", "restore", "migrate", "set_irq",
                   "set_status", "get_info", "admit", "evict"}

    def begin(self, tenant: str, op: str, detail=None) -> Optional[OpRecord]:
        if op not in self.CONTROL_OPS:
            with self._lock:
                self._n_data_ops += 1
                if self.sample_data_plane < 1.0 and (
                        self._n_data_ops * self.sample_data_plane) % 1.0 \
                        >= self.sample_data_plane:
                    return None
        r = OpRecord(tenant, op, detail or {}, time.perf_counter())
        with self._lock:
            self.records.append(r)
        return r

    def end(self, rec: Optional[OpRecord]):
        if rec is not None:
            rec.t_end = time.perf_counter()

    def query(self, tenant=None, op=None) -> List[OpRecord]:
        with self._lock:
            return [r for r in self.records
                    if (tenant is None or r.tenant == tenant)
                    and (op is None or r.op == op)]

    def completeness(self) -> float:
        """Fraction of issued data-plane ops that were recorded."""
        with self._lock:
            n_logged = sum(1 for r in self.records
                           if r.op not in self.CONTROL_OPS)
            return n_logged / max(self._n_data_ops, 1)

    def op_latency_stats(self) -> dict:
        """Per-op latency rollup from the ``perf_counter`` stamps every
        record already carries: ``{op: {count, mean_ms, p50_ms,
        p95_ms}}`` over completed records. This is the registry surface
        ``VMM.stats()["ops"]`` exposes (and fig6b reads) instead of
        benchmarks re-measuring with private timers."""
        with self._lock:
            by_op = {}
            for r in self.records:
                if r.t_end > 0.0:
                    by_op.setdefault(r.op, []).append(r.duration_ms)
        out = {}
        for op, ds in by_op.items():
            ds.sort()
            n = len(ds)
            out[op] = {
                "count": n,
                "mean_ms": sum(ds) / n,
                "p50_ms": ds[n // 2],
                "p95_ms": ds[min(int(0.95 * (n - 1)), n - 1)],
            }
        return out


class TenantCheckpointer:
    """Snapshot / restore of tenant device state (onto any device)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def path(self, tenant_name: str) -> str:
        return os.path.join(self.root, tenant_name)

    def snapshot(self, tenant_name: str, step: int, state_tree,
                 meta: dict) -> str:
        return ckpt_save(self.path(tenant_name), step, state_tree, meta)

    def restore(self, tenant_name: str, template, device=None):
        d = ckpt_latest(self.path(tenant_name))
        if d is None:
            raise FileNotFoundError(
                f"no checkpoint for tenant {tenant_name}")
        return ckpt_restore(d, template, device)
