"""Tenant & GuestDevice — the guest-side of the virtualization boundary.

``GuestDevice`` exposes the paper's MMD-layer interface operators
(§IV.C): ``open, close, read, write, get_info, set_irq, set_status,
reprogram`` — plus the memory operators the paper forwards to the VMM
(``alloc``/``free``, i.e. clCreateBuffer's path) and ``run``. Fidelity
means a tenant written against GuestDevice cannot tell whether ops are
mediated (FEV), passed through (BEV), or split (HYBRID): the VMM decides.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict

import numpy as np


@dataclass
class GuestBuffer:
    handle: int
    nbytes: int
    shape: tuple
    dtype: str
    device_array: object = None


class GuestDevice:
    """The eight MMD operators + mediated memory ops. All calls delegate
    to the VMM, which enforces policy (FEV/BEV/HYBRID)."""

    def __init__(self, vmm, tenant):
        self._vmm = vmm
        self._tenant = tenant
        self._open = False

    # -- the 8 interface operators (paper §IV.C) -----------------------
    def open(self):
        self._vmm.op_open(self._tenant)
        self._open = True

    def close(self):
        self._vmm.op_close(self._tenant)
        self._open = False

    def read(self, handle: int) -> np.ndarray:
        return self._vmm.op_read(self._tenant, handle)

    def write(self, handle: int, data: np.ndarray):
        return self._vmm.op_write(self._tenant, handle, data)

    def get_info(self) -> dict:
        return self._vmm.op_get_info(self._tenant)

    def set_irq(self, handler: Callable):
        return self._vmm.op_set_irq(self._tenant, handler)

    def set_status(self, handler: Callable):
        return self._vmm.op_set_status(self._tenant, handler)

    def reprogram(self, request) -> object:
        """request: core.reconfig.ProgramRequest (or a pre-built Bitfile —
        which exercises the legality checks)."""
        return self._vmm.op_reprogram(self._tenant, request)

    # -- memory ops (forwarded to the VMM MMU, §IV.C) -----------------------
    def alloc(self, nbytes: int, shape=(), dtype="float32") -> int:
        return self._vmm.op_alloc(self._tenant, nbytes, shape, dtype)

    def free(self, handle: int):
        return self._vmm.op_free(self._tenant, handle)

    # -- data plane ----------------------------------------------------------
    def run(self, *args, **kw):
        return self._vmm.op_run(self._tenant, *args, **kw)

    # -- async data plane (scheduler submit() path; returns Futures) --------
    def run_async(self, *args, **kw):
        return self._vmm.op_run_async(self._tenant, *args, **kw)

    def write_async(self, handle: int, data: np.ndarray):
        return self._vmm.op_write_async(self._tenant, handle, data)

    def read_async(self, handle: int):
        return self._vmm.op_read_async(self._tenant, handle)


@dataclass
class Tenant:
    name: str
    vslice: object                      # core.vslice.VSlice
    pool: object                        # core.mmu.SegmentPool
    cq: object                          # core.shell.CompletionQueue
    device: GuestDevice = None
    buffers: Dict[int, GuestBuffer] = field(default_factory=dict)
    program: object = None              # LoadedProgram
    program_request: object = None
    state: dict = field(default_factory=dict)   # device-resident train state
    step: int = 0
    straggler_count: int = 0
    lock: threading.RLock = field(default_factory=threading.RLock)
    inflight: int = 0
    quiesced: bool = False
    _cv: threading.Condition = None

    def __post_init__(self):
        self._cv = threading.Condition(self.lock)

    # -- quiesce / freeze protocol (PR freeze signal analogue) -------------
    def enter_op(self):
        with self._cv:
            while self.quiesced:
                self._cv.wait()
            self.inflight += 1

    def exit_op(self):
        with self._cv:
            self.inflight -= 1
            self._cv.notify_all()

    class _Quiesce:
        def __init__(self, tenant):
            self.t = tenant

        def __enter__(self):
            with self.t._cv:
                self.t.quiesced = True
                while self.t.inflight > 0:
                    self.t._cv.wait()
            return self

        def __exit__(self, *exc):
            with self.t._cv:
                self.t.quiesced = False
                self.t._cv.notify_all()

    def quiesce(self):
        return Tenant._Quiesce(self)
