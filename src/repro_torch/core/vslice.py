"""vSlice — the PRR (partial-reconfiguration region) analogue, on a pod
``DeviceMesh`` of ranks or on a grid of ``torch.device``s.

A vSlice is a *contiguous sub-rectangle* of the pod's grid. The
Floorplanner is the spatial allocator: it carves disjoint rectangles
from the grid (first-fit over anchor positions), the analogue of the
paper's PRR floorplanning. Two kinds of pod:

* **A ``DeviceMesh``** (``launch.mesh.make_local_mesh((2, 4))``): the
  grid entries are ranks, one process a rank, every rank running the
  same control plane. A slice carved from it has ``mesh``, a
  ``DeviceMesh`` over its rectangle of ranks with axes ("data",
  "model"), so tenant code runs against a slice exactly as against a
  pod (the reference's fidelity criterion). Building a mesh is
  collective over the world (``new_group``), so every rank builds it,
  in allocation order, after the allocator's lock is released; meshes
  are kept by rectangle, so a migration back to a rectangle reuses its
  process groups. A rank outside the slice sees ``member`` False.
* **A 2-D array of ``torch.device``** (one process): a grid may name one
  card several times, so a 1×3 view of one card gives three slices that
  time-multiplex it, as the paper's PRRs share one FPGA. Such a slice
  has no mesh; it runs on the one card its entries name (``device``),
  on k shares of that card's memory.

``device`` is the one card of a one-card slice; a slice over several
cards has none (its programs and data live on its ``mesh``) and asking
for it raises.
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
    the quantity embedded into compiled 'bitfiles' for legality checks.
    ``mesh`` is the slice's ``DeviceMesh`` when it was carved from a pod
    mesh (``devices`` are then ranks), None on a device grid."""

    def __init__(self, slice_id: int, spec: SliceSpec, devices: np.ndarray,
                 axis_names=("data", "model"), mesh=None):
        assert devices.shape == spec.shape, (devices.shape, spec.shape)
        self.slice_id = slice_id
        self.spec = spec
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.mesh = mesh
        self.healthy = True

    @property
    def ranks(self) -> Tuple[int, ...]:
        """The ranks of a slice of a pod mesh, in grid order."""
        if self.mesh is None:
            raise ValueError("a slice of a device grid has no ranks")
        return tuple(int(r) for r in self.devices.flatten())

    @property
    def member(self) -> bool:
        """Whether this process runs the slice's programs: always on a
        device grid; on a pod mesh, when its rank is in the rectangle."""
        return self.mesh is None or self.mesh.get_coordinate() is not None

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
        memory; a one-rank slice of a pod mesh is that rank's card)."""
        cards = self.cards
        if len(cards) != 1:
            raise ValueError(
                f"slice {self.spec.shape} spans {len(cards)} "
                f"{'ranks' if self.mesh is not None else 'cards'}: it has no "
                "single device; its programs and data live on its mesh "
                "(VSlice.mesh, a slice carved from a pod DeviceMesh; place "
                "data with a (mesh, spec) sharding)")
        if self.mesh is not None:
            if not self.member:
                raise ValueError("this rank is outside the slice: it has "
                                 "no device of it")
            from repro_torch.models.model import mesh_device
            return mesh_device(self.mesh)
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


def _is_mesh(pod) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(pod, DeviceMesh)


def _device_id(d):
    """``torch.device.index`` where the reference hashed ``Device.id``
    (a CPU device has index None → 0); any other object its ``id``."""
    if hasattr(d, "type") and hasattr(d, "index"):
        return d.index or 0
    return getattr(d, "id", d)


class Floorplanner:
    """First-fit rectangle allocator over the pod device grid."""

    def __init__(self, pod):
        """``pod``: a ``DeviceMesh`` (its grid entries are ranks), a 2-D
        array of devices, or any object whose ``.devices`` is one."""
        self.pod_mesh = pod if _is_mesh(pod) else None
        if self.pod_mesh is not None:
            devs = np.asarray(pod.mesh.tolist(), dtype=object)
        else:
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
        # a pod mesh's slice meshes by rectangle; built and read only on
        # the control-plane thread (outside _lock: building one is a
        # collective over the world)
        self._meshes: Dict[tuple, object] = {}  # unguarded-ok: control thread

    # ------------------------------------------------------------------
    def allocate(self, shape: Tuple[int, int]) -> Optional[VSlice]:
        h, w = shape
        if h > self.rows or w > self.cols:
            return None
        vs = None
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
                    break
        if vs is not None and self.pod_mesh is not None:
            vs.mesh = self.mesh_of(vs.spec)
        return vs

    def mesh_of(self, spec: SliceSpec):
        """The ``DeviceMesh`` over ``spec``'s rectangle of the pod mesh,
        axes ("data", "model"), built on first use (collective: every
        rank calls this in the same order) and kept."""
        key = (spec.origin, spec.shape)
        mesh = self._meshes.get(key)
        if mesh is None:
            from torch.distributed.device_mesh import DeviceMesh
            (r, c), (h, w) = spec.origin, spec.shape
            ranks = torch.tensor(
                self.grid[r:r + h, c:c + w].astype(np.int64).tolist())
            mesh = DeviceMesh(self.pod_mesh.device_type, ranks,
                              mesh_dim_names=("data", "model"))
            self._meshes[key] = mesh
        return mesh

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
