"""vSlice — the PRR (partial-reconfiguration region) analogue, on a grid
of ``torch.device``s.

A vSlice is a *contiguous sub-rectangle* of the pod's device grid (a 2-D
numpy object array of ``torch.device``). The Floorplanner is the spatial
allocator: it carves disjoint rectangles from the grid (first-fit over
anchor positions), the analogue of the paper's PRR floorplanning. A grid
may name one card several times: a 1×3 view of one card gives three
slices that time-multiplex it, as the paper's PRRs share one FPGA.

Programs run on one card: a slice whose grid entries all name one card
(a (1, 4) slice of a 2×4 view of one card) runs there, on k shares of
that card's memory; a slice whose entries name two or more cards is
carved and checked like any other, but asking it for its ``device``
raises (a VSlice over several cards is ROADMAP item 9.1).
"""
from __future__ import annotations

import hashlib
import itertools
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def card(d):
    """The physical device a grid entry names (``cuda`` → the current
    CUDA device's index), so that entries naming one card compare equal;
    an entry that is no device name (a stand-in object) is itself."""
    if not isinstance(d, (torch.device, str)):
        return d
    d = torch.device(d)
    if d.index is None and d.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return d


@dataclass(frozen=True)
class SliceSpec:
    origin: Tuple[int, int]          # (row, col) in the pod device grid
    shape: Tuple[int, int]           # (data_extent, model_extent)

    @property
    def n_devices(self) -> int:
        return self.shape[0] * self.shape[1]


class VSlice:
    """A carved sub-grid. ``fingerprint`` identifies topology+devices —
    the quantity embedded into compiled 'bitfiles' for legality checks."""

    def __init__(self, slice_id: int, spec: SliceSpec, devices: np.ndarray,
                 axis_names=("data", "model")):
        assert devices.shape == spec.shape, (devices.shape, spec.shape)
        self.slice_id = slice_id
        self.spec = spec
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.healthy = True

    @property
    def n_devices(self) -> int:
        return self.spec.n_devices

    @property
    def cards(self) -> Tuple[torch.device, ...]:
        """The distinct physical devices the slice's grid entries name,
        in grid order."""
        out = []
        for d in self.devices.flatten():
            c = card(d)
            if c not in out:
                out.append(c)
        return tuple(out)

    @property
    def device(self):
        """The one card every grid entry of the slice names (a slice of k
        entries of a one-card view is that card, with k shares of its
        memory)."""
        cards = self.cards
        if len(cards) != 1:
            raise NotImplementedError(
                f"slice {self.spec.shape} spans {len(cards)} cards: a VSlice "
                "over several cards (its programs on the slice's mesh) is "
                "not ported yet (ROADMAP item 9.1, multi-card VSlices; the "
                "step builders already take a DeviceMesh)")
        return cards[0]

    @property
    def topology_key(self) -> str:
        """Topology-class key: identical-shape slices are inter-compatible
        (a program compiled for one 2×4 slice can be re-bound to another)."""
        return f"{self.spec.shape[0]}x{self.spec.shape[1]}"

    @property
    def fingerprint(self) -> str:
        ids = ",".join(str(_device_id(d)) for d in self.devices.flatten())
        h = hashlib.sha256(
            f"{self.spec.origin}|{self.spec.shape}|{ids}".encode())
        return h.hexdigest()[:16]

    def __repr__(self):
        return (f"VSlice(id={self.slice_id}, origin={self.spec.origin}, "
                f"shape={self.spec.shape}, healthy={self.healthy})")


def _device_id(d):
    """``torch.device.index`` where the reference hashed ``Device.id``
    (a CPU device has index None → 0); any other object its ``id``."""
    if hasattr(d, "type") and hasattr(d, "index"):
        return d.index or 0
    return getattr(d, "id", d)


class Floorplanner:
    """First-fit rectangle allocator over the pod device grid."""

    def __init__(self, pod):
        """``pod``: a 2-D array of devices, or any object whose
        ``.devices`` is one."""
        devs = np.asarray(getattr(pod, "devices", pod), dtype=object)
        if devs.ndim == 3:      # multi-pod (pod, data, model): flatten pods
            devs = devs.reshape(-1, devs.shape[-1])
        assert devs.ndim == 2, devs.shape
        self.grid = devs
        self.rows, self.cols = devs.shape
        self.occupancy = np.zeros((self.rows, self.cols), dtype=bool)
        self.slices: Dict[int, VSlice] = {}
        self._next_id = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def allocate(self, shape: Tuple[int, int]) -> Optional[VSlice]:
        h, w = shape
        if h > self.rows or w > self.cols:
            return None
        with self._lock:
            for r, c in itertools.product(range(self.rows - h + 1),
                                          range(self.cols - w + 1)):
                window = self.occupancy[r:r + h, c:c + w]
                if not window.any():
                    self.occupancy[r:r + h, c:c + w] = True
                    sid = self._next_id
                    self._next_id += 1
                    vs = VSlice(sid, SliceSpec((r, c), (h, w)),
                                self.grid[r:r + h, c:c + w])
                    self.slices[sid] = vs
                    return vs
        return None

    def free(self, slice_id: int):
        with self._lock:
            vs = self.slices.pop(slice_id)
            (r, c), (h, w) = vs.spec.origin, vs.spec.shape
            self.occupancy[r:r + h, c:c + w] = False

    # ------------------------------------------------------------------
    def utilization(self) -> float:
        return float(self.occupancy.mean())

    def fragmentation(self) -> float:
        """1 − (largest free rectangle / total free area)."""
        free = ~self.occupancy
        total = int(free.sum())
        if total == 0:
            return 0.0
        best = 0
        # O(R²C) largest-rectangle-of-ones scan (grids are ≤ 32×16)
        heights = np.zeros(self.cols, int)
        for r in range(self.rows):
            heights = np.where(free[r], heights + 1, 0)
            for c in range(self.cols):
                if heights[c] == 0:
                    continue
                minh = heights[c]
                for c2 in range(c, self.cols):
                    if heights[c2] == 0:
                        break
                    minh = min(minh, heights[c2])
                    best = max(best, minh * (c2 - c + 1))
        return 1.0 - best / total

    def snapshot(self):
        return {sid: (vs.spec.origin, vs.spec.shape)
                for sid, vs in self.slices.items()}
