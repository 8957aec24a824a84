"""Elastic re-slicing — resource-elastic virtualization (paper ref [15])
built on the live-migration primitive (the port of
``repro.core.elastic``).

* ``resize``     — grow/shrink one tenant's slice.
* ``defragment`` — re-pack all slices toward the grid origin so the
  largest possible contiguous rectangle is free (admission headroom),
  the floorplanning hygiene the paper calls "essential to achieve
  performance and equality among users".

On one card a grow or shrink changes how many shares of the card's
memory the tenant's pool holds (``VMM._make_pool``); the program is
re-bound to the new slice and the state restored onto the card. On a pod
mesh a resize moves the tenant to another rectangle of ranks: its
program is built for the new slice's mesh and ``shardings_fn(vs)``
places the restored state over it; ``defragment`` re-binds each moved
slice's program to its new mesh the same way. Every rank makes these
calls in the same order (the meshes they build are collective).
"""
from __future__ import annotations

from typing import Tuple


def resize(vmm, tenant, new_shape: Tuple[int, int], state_template=None,
           shardings_fn=None):
    """Grow or shrink a tenant's slice (checkpoint → re-slice → restore)."""
    return vmm.migrate_tenant(tenant, new_shape=new_shape,
                              state_template=state_template,
                              shardings_fn=shardings_fn)


def defragment(vmm) -> int:
    """Re-pack tenants largest-first. Returns number of migrations."""
    tenants = sorted(vmm.tenants.values(),
                     key=lambda t: -t.vslice.n_devices)
    moves = 0
    for t in tenants:
        old_origin = t.vslice.spec.origin
        shape = t.vslice.spec.shape
        # free, then take the first-fit (lowest) anchor
        vmm.floorplanner.free(t.vslice.slice_id)
        vs = vmm.floorplanner.allocate(shape)
        assert vs is not None   # freeing own rectangle guarantees a fit
        if vs.spec.origin != old_origin:
            moves += 1
            t.vslice = vs
            if t.program_request is not None:
                bf = vmm.compiler.compile(t.program_request, vs)
                t.program = vmm.loader.load(bf, vs, t.quiesce,
                                            owner=t.name)
        else:
            t.vslice = vs
    return moves
