"""Reconfiguration — the PR-controller analogue.

FPGA partial reconfiguration ↔ loading a freshly built step program onto
a vSlice. The mapping:

* bitfile            → ``Bitfile``: the built step program + metadata
* CRC check          → content fingerprint verified at load
* decode + PR flow   → ``ProgramLoader.load`` with the freeze protocol
* bitfile↔PRR check  → slice binding: a Bitfile records the topology class
  and concrete slice fingerprint it was built for; the VMM refuses a
  load whose binding does not match the caller's slice (the paper's
  "user in VM0 reprograms PRR1" attack), while allowing *re-binding*
  across identical-topology slices (warm migration).
* PCIe reconfig cost → "compile" seconds: building the step through
  ``repro_torch.parallel.steps`` and building and loading every CUDA
  kernel library the step launches; the ``CompileService`` cache turns
  repeat loads into warm reconfigurations. There is no ahead-of-time
  graph compilation (no ``torch.compile``, no CUDA graphs).
"""
from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.vslice import VSlice


class ReconfigError(Exception):
    pass


class LegalityError(ReconfigError):
    """Bitfile↔slice legality violation (isolation criterion)."""


@dataclass
class ProgramRequest:
    """What a tenant asks to have 'flashed': a named step program."""
    arch: str
    kind: str                    # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int
    reduced: bool = True
    opt_flags: Tuple = ()

    @property
    def program_key(self) -> str:
        h = hashlib.sha256(repr((self.arch, self.kind, self.seq_len,
                                 self.global_batch, self.reduced,
                                 self.opt_flags)).encode())
        return h.hexdigest()[:16]


@dataclass
class Bitfile:
    program_key: str
    topology_key: str            # e.g. "2x4" — shape class compatibility
    slice_fingerprint: str       # concrete binding
    compiled: object             # the step callable
    abstract_args: tuple
    crc: str = ""
    compile_seconds: float = 0.0

    def __post_init__(self):
        if not self.crc:
            self.crc = self._compute_crc()

    def _compute_crc(self) -> str:
        h = hashlib.sha256(
            f"{self.program_key}|{self.topology_key}|"
            f"{self.slice_fingerprint}".encode())
        return h.hexdigest()[:16]

    def verify_crc(self) -> bool:
        return self.crc == self._compute_crc()


def weights_fingerprint(params) -> str:
    """Content hash of a weights tree — leaf paths, shapes, dtypes and
    bytes, over the reference's layout and JAX key-path strings
    (``['segments'][0][0]['mixer']['wq']``), so the same weights give the
    same hash in both packages. bf16 leaves hash their raw bytes under
    the dtype name ``bfloat16``. This is the ``slice_fingerprint`` of a
    weights-as-bitstream :class:`Bitfile`: the CRC commits to the actual
    parameter bytes."""
    from repro_torch.bridge import stacked_layout
    from repro_torch.checkpointing.checkpoint import flatten_with_path
    h = hashlib.blake2b(digest_size=8)
    for path, leaf in flatten_with_path(stacked_layout(params)):
        if leaf.dtype == torch.bfloat16:
            raw, name = leaf.view(torch.int16).numpy(), "bfloat16"
        else:
            raw = leaf.numpy()
            name = str(raw.dtype)
        h.update(keystr(path).encode())
        h.update(str(tuple(leaf.shape)).encode())
        h.update(name.encode())
        h.update(raw.tobytes())
    return h.hexdigest()


def keystr(path) -> str:
    """JAX's ``keystr`` of a path: ``['key']`` per dict key, ``[i]`` per
    index."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


@dataclass
class LoadedProgram:
    bitfile: Bitfile
    slice_id: int

    def __call__(self, *args):
        return self.bitfile.compiled(*args)


class CompileService:
    """Builds step programs for a slice's device, with a program cache.

    Cache key = (program_key, topology_key): a program built once for a
    1×1 slice is a warm hit for *any* 1×1 slice (the paper's observation
    that PR bitfiles are only shell/region-compatible, made less painful
    by topology-class reuse). A step runs on whatever device its inputs
    live on, so re-binding needs no rebuild."""

    def __init__(self, step_builder: Optional[Callable] = None):
        # step_builder(cfg, device, cell) → (step, abstract_args)
        if step_builder is None:
            from repro_torch.parallel.steps import build_step_for_cell
            step_builder = build_step_for_cell
        self._build = step_builder
        self.cache: Dict[Tuple[str, str], Bitfile] = {}  # guarded-by: _lock
        self.hits = 0                                     # guarded-by: _lock
        self.misses = 0                                   # guarded-by: _lock
        self._lock = threading.Lock()

    def compile(self, req: ProgramRequest, vslice: VSlice) -> Bitfile:
        key = (req.program_key, vslice.topology_key)
        with self._lock:
            if key in self.cache:
                self.hits += 1
                cached = self.cache[key]
                # re-bind to this concrete slice (warm reconfig)
                return Bitfile(cached.program_key, cached.topology_key,
                               vslice.fingerprint, cached.compiled,
                               cached.abstract_args,
                               compile_seconds=0.0)
        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeCell
        from repro_torch.parallel.steps import step_kernels
        cfg = get_config(req.arch, reduced=req.reduced)
        cell = ShapeCell("custom", req.seq_len, req.global_batch,
                         req.kind)
        device = vslice.device
        t0 = time.perf_counter()
        step, abstract_args = self._build(cfg, device, cell)
        if getattr(device, "type", None) == "cuda":
            from repro_torch.kernels import common
            for name in step_kernels(req.kind):
                common.library(name)          # nvcc at first use, then load
        dt = max(time.perf_counter() - t0, 1e-9)
        bf = Bitfile(req.program_key, vslice.topology_key,
                     vslice.fingerprint, step, abstract_args,
                     compile_seconds=dt)
        with self._lock:
            self.misses += 1
            self.cache[key] = bf
        return bf


class ProgramLoader:
    """The PR flow: legality checks + freeze protocol + load."""

    def __init__(self, auditor=None):
        self.loaded: Dict[int, LoadedProgram] = {}   # slice_id → program
        self.auditor = auditor
        self.reconfigs = 0
        self.crc_checks = 0
        self.crc_failures = 0

    def verify_bitfile(self, bitfile: Bitfile, owner: str = "?"):
        """CRC-only verification (counted) — every load AND every
        model-registry swap-in goes through here, so a corrupted
        bitstream never reaches a slice or a serving engine silently."""
        self.crc_checks += 1
        if not bitfile.verify_crc():
            self.crc_failures += 1
            if self.auditor:
                self.auditor.record("bitfile_crc_fail", owner, {})
            raise LegalityError("bitfile CRC check failed")

    def validate(self, bitfile: Bitfile, vslice: VSlice, owner: str = "?"):
        self.verify_bitfile(bitfile, owner)
        if bitfile.topology_key != vslice.topology_key:
            if self.auditor:
                self.auditor.record("bitfile_topology_mismatch", owner,
                                    {"bitfile": bitfile.topology_key,
                                     "slice": vslice.topology_key})
            raise LegalityError(
                f"bitfile for topology {bitfile.topology_key} cannot load "
                f"on slice {vslice.topology_key}")
        if bitfile.slice_fingerprint != vslice.fingerprint:
            if self.auditor:
                self.auditor.record("cross_slice_reprogram", owner,
                                    {"bitfile_slice":
                                     bitfile.slice_fingerprint,
                                     "target_slice": vslice.fingerprint})
            raise LegalityError(
                "bitfile is bound to a different slice (the paper's "
                "cross-PRR reprogram attack) — VMM must re-bind it")

    def load(self, bitfile: Bitfile, vslice: VSlice, quiesce: Callable,
             owner: str = "?") -> LoadedProgram:
        self.validate(bitfile, vslice, owner)
        # freeze protocol: drain + block the slice while swapping programs
        with quiesce():
            prog = LoadedProgram(bitfile, vslice.slice_id)
            self.loaded[vslice.slice_id] = prog
            self.reconfigs += 1
        return prog

    def unload(self, vslice: VSlice):
        self.loaded.pop(vslice.slice_id, None)
