"""Step builders: assemble a model into prefill / decode step programs on
one device — the PyTorch counterparts of ``repro.parallel.steps``.

The virtualization compile service (``core/reconfig.py``) builds the
VMM's programs here, and native callers use the same builders: the
paper's *fidelity* criterion (one artifact for native and virtualized
execution). Each builder returns ``(step, abstract_args)``: ``step`` is
an eager callable that runs on the device its inputs live on, and
``abstract_args`` are meta tensors (shapes and dtypes, no data), with
parameters in bf16 as the reference's ``dtype_override`` makes them.
Sharding across devices is not ported: a step runs on one device.
"""
from __future__ import annotations

import torch

from repro_torch.models import Model

#: the CUDA kernels each step kind launches (built and loaded at compile)
STEP_KERNELS = {"prefill": ("flash_attention",),
                "decode": ("decode_attention",)}


def step_kernels(kind: str):
    return STEP_KERNELS.get(kind, ())


def abstract_params(model, dtype_override=None):
    """Meta tensors with the shapes (and, with ``dtype_override``, the
    floating dtype) of ``model.init``'s parameters."""
    meta = Model(model.cfg, device="meta").init(None)
    dt = getattr(torch, dtype_override) if dtype_override else None

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [conv(v) for v in tree]
        if dt is not None and tree.is_floating_point():
            return tree.to(dt)
        return tree
    return conv(meta)


def build_prefill(cfg, device, cell):
    """→ (prefill, abstract_args). prefill(params, batch) → (last
    logits, ring caches of capacity ``cell.seq_len``)."""
    model = Model(cfg, device=device)
    params_abs = abstract_params(model, dtype_override="bfloat16")
    batch_abs = model.input_specs(cell)
    cap = cell.seq_len

    def prefill_step(params, batch):
        return model.prefill(params, batch, capacity=cap)
    return prefill_step, (params_abs, batch_abs)


def build_decode(cfg, device, cell):
    """→ (decode, abstract_args). decode(params, caches, token, pos) →
    (logits, caches), the caches updated in place (the reference donates
    them)."""
    model = Model(cfg, device=device)
    B = cell.global_batch
    params_abs = abstract_params(model, dtype_override="bfloat16")
    cache_abs = Model(cfg, device="meta").init_cache(B, cell.seq_len)
    token_abs = torch.empty((B, 1), dtype=torch.int32, device="meta")
    pos_abs = torch.empty((), dtype=torch.int32, device="meta")

    def decode_step(params, caches, token, pos):
        return model.decode(params, caches, token, pos)
    return decode_step, (params_abs, cache_abs, token_abs, pos_abs)


def build_step_for_cell(cfg, device, cell):
    """Dispatch on the cell kind."""
    if cell.kind == "train":
        raise NotImplementedError(
            "train steps are not ported yet (the training slice)")
    if cell.kind == "prefill":
        return build_prefill(cfg, device, cell)
    if cell.kind == "decode":
        return build_decode(cfg, device, cell)
    raise ValueError(cell.kind)
