"""Step builders: assemble a model into train / prefill / decode step
programs on one device — the PyTorch counterparts of
``repro.parallel.steps``.

The virtualization compile service (``core/reconfig.py``) builds the
VMM's programs here, and native callers use the same builders: the
paper's *fidelity* criterion (one artifact for native and virtualized
execution). Each builder returns ``(step, abstract_args)``: ``step`` is
an eager callable that runs on the device its inputs live on, and
``abstract_args`` are meta tensors (shapes and dtypes, no data), with
serving parameters in bf16 as the reference's ``dtype_override`` makes
them and training parameters in ``param_dtype``.
Sharding across devices is not ported: a step runs on one device.
"""
from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.models import Model

#: the CUDA kernels a step kind launches for each mixer of the stack
#: (built and loaded at compile); rwkv's one-token step is plain PyTorch.
#: A train step launches each kernel in the forward and again in each
#: rematerialised layer's recompute; the scan's backward is one more
#: launch of the scan (the WKV's and flash's backwards are torch ops).
STEP_KERNELS = {"train": {"attn": "flash_attention",
                          "swa": "flash_attention",
                          "rglru": "rglru_scan", "rwkv": "rwkv6_wkv"},
                "prefill": {"attn": "flash_attention",
                            "swa": "flash_attention",
                            "rglru": "rglru_scan", "rwkv": "rwkv6_wkv"},
                "decode": {"attn": "decode_attention",
                           "swa": "decode_attention"}}


def step_kernels(kind: str, cfg):
    """The kernels a ``kind`` step of ``cfg``'s stack launches."""
    table = STEP_KERNELS.get(kind, {})
    out = []
    for mixer in cfg.block_pattern:
        name = table.get(mixer)
        if name is not None and name not in out:
            out.append(name)
    return tuple(out)


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
    logits, ring caches of capacity ``cell.seq_len`` and, for recurrent
    layers, their rows: the form the decode program takes)."""
    model = Model(cfg, device=device)
    params_abs = abstract_params(model, dtype_override="bfloat16")
    batch_abs = model.input_specs(cell)
    cap = cell.seq_len

    def prefill_step(params, batch):
        return model.prefill(params, batch, capacity=cap)
    return prefill_step, (params_abs, batch_abs)


def build_decode(cfg, device, cell):
    """→ (decode, abstract_args). decode(params, caches, token, pos) →
    (logits, caches), the ring caches and recurrent rows updated in
    place (the reference donates them)."""
    model = Model(cfg, device=device)
    B = cell.global_batch
    params_abs = abstract_params(model, dtype_override="bfloat16")
    cache_abs = Model(cfg, device="meta").init_cache(B, cell.seq_len)
    token_abs = torch.empty((B, 1), dtype=torch.int32, device="meta")
    pos_abs = torch.empty((), dtype=torch.int32, device="meta")

    def decode_step(params, caches, token, pos):
        return model.decode(params, caches, token, pos)
    return decode_step, (params_abs, cache_abs, token_abs, pos_abs)


def build_train(cfg, device, cell, opt_cfg=None):
    """→ (train_step, abstract_args). train_step(params, opt_state,
    batch) → (params, opt_state, metrics) is ``optim.make_train_step``
    over ``Model(cfg, device).loss``: new trees, the inputs untouched
    (the reference donates them). ``opt_cfg`` defaults to
    ``OptConfig(state_dtype=cfg.opt_dtype)``."""
    model = Model(cfg, device=device)
    if opt_cfg is None:
        opt_cfg = optim.OptConfig(state_dtype=cfg.opt_dtype)
    params_abs = abstract_params(model)
    opt_abs = optim.init(opt_cfg, params_abs)
    batch_abs = model.input_specs(cell)
    return (optim.make_train_step(model, opt_cfg),
            (params_abs, opt_abs, batch_abs))


def build_step_for_cell(cfg, device, cell, opt_cfg=None):
    """Dispatch on the cell kind (``opt_cfg`` for a train cell)."""
    if cell.kind == "train":
        return build_train(cfg, device, cell, opt_cfg)
    if cell.kind == "prefill":
        return build_prefill(cfg, device, cell)
    if cell.kind == "decode":
        return build_decode(cfg, device, cell)
    raise ValueError(cell.kind)
