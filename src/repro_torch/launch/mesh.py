"""Mesh construction over an initialised ``torch.distributed`` process
group — the counterpart of ``repro.launch.mesh``.

Functions, not module state: importing this module touches neither the
process group nor a device. One rank runs one process; on the card each
rank drives ``cuda:<local rank>``.
"""
from __future__ import annotations

import math


def _device_type(device_type):
    import torch
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device_type='cpu' to "
                               "build a mesh of CPU ranks")
        return "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_type='cuda' but no CUDA device")
    return device_type


def _world():
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group first (torchrun, or an "
                           "explicit init_method)")
    return dist.get_world_size()


def make_local_mesh(shape=None, axes=("data", "model"), device_type=None):
    """A mesh of ``shape`` (default ``(1, world)``) over the group's ranks,
    on ``cuda`` unless ``device_type='cpu'``. Raises without a card (unless
    asked for the CPU), without a process group, or when ``prod(shape)``
    exceeds the world size."""
    from torch.distributed.device_mesh import init_device_mesh
    dtype = _device_type(device_type)
    n = _world()
    if shape is None:
        shape = (1, n)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    if math.prod(shape) > n:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; the "
                         f"group has {n}")
    if dtype == "cuda":
        import torch
        import torch.distributed as dist
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dtype, shape, mesh_dim_names=tuple(axes))


def pod_rows(world: int):
    """→ (pod shape, row shape) of the reference's virtualization pods
    for ``world`` ranks: two rows of ``world / 2`` (its examples' (2, 4)
    grid of (1, 4) slices at 8 ranks), or (1, 1) and (1, 1) for one
    rank."""
    if world == 1:
        return (1, 1), (1, 1)
    if world % 2:
        raise ValueError(f"{world} ranks: a pod of two rows needs an even "
                         "world")
    return (2, world // 2), (1, world // 2)


def shared_tempdir(prefix: str, group=None) -> str:
    """A temporary directory made by rank 0 and its path broadcast to
    every rank (every rank calls this; ``group``: a group over every
    rank, default the world's): where the ranks of one host keep files
    they all read, such as a VMM's tenant checkpoints."""
    import tempfile

    import torch.distributed as dist
    box = [tempfile.mkdtemp(prefix=prefix) if dist.get_rank() == 0
           else None]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The reference's production meshes: 16×16 ("data", "model"), or
    2×16×16 with a leading "pod" axis. Raises unless the group has that
    many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    device_type = _device_type(device_type)
    n = _world()
    if n != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks; the group has {n}")
    return make_local_mesh(shape, axes, device_type)
