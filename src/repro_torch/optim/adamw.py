"""AdamW with a warmup-cosine schedule, global-norm clipping and gradient
accumulation (optionally bf16-compressed: each micro-step's gradient is
cast to bf16 before it is added) — the PyTorch counterpart of
``repro.optim.adamw`` on trees of tensors (nested dicts and lists, as
``Model.init`` makes them).

The reference's ``_decay_mask`` reads the last key of a leaf's path; the
port's trees keep the reference's leaf names (``wq``, ``bq``, ``scale``,
``router``, ...), so the same substring test decides the same leaves.
``m``/``v`` are kept in ``opt.state_dtype``, the parameters in their own
dtype, and the update is computed in fp32. Gradients come from
``torch.autograd.grad`` over every parameter leaf, none unused: a leaf
that no gradient reaches raises instead of training as a constant.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.checkpointing.checkpoint import (flatten_with_path,
                                                  tree_map, unflatten)
from repro_torch.obs import spans as obs_spans


@dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    micro_steps: int = 1            # gradient accumulation factor
    grad_compress: bool = False     # bf16-compressed accumulation
    state_dtype: str = "float32"    # m/v dtype ("bfloat16" for 1T models)


def leaves(tree):
    return [leaf for _, leaf in flatten_with_path(tree)]


def schedule(opt: OptConfig, step):
    """Learning rate at ``step`` (a 0-d tensor): linear warmup, then a
    cosine from ``peak_lr`` to ``min_lr`` over ``decay_steps``; fp32."""
    step = torch.as_tensor(step).float()
    warm = opt.peak_lr * step / max(opt.warmup_steps, 1)
    prog = ((step - opt.warmup_steps)
            / max(opt.decay_steps - opt.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = opt.min_lr + 0.5 * (opt.peak_lr - opt.min_lr) * (
        1.0 + torch.cos(math.pi * prog))
    return torch.where(step < opt.warmup_steps, warm, cos)


def init(opt: OptConfig, params):
    """Zeroed ``m`` and ``v`` in ``opt.state_dtype`` beside each leaf,
    and ``step`` 0 (int32) on the parameters' device."""
    sdt = getattr(torch, opt.state_dtype)
    dev = leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=sdt, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree):
    """sqrt of the sum of every leaf's squares, in fp32."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


def _decay_mask(path):
    """No weight decay on norms/biases/scalars (the reference's test on
    the leaf's last key)."""
    leaf = str(path[-1]) if path else ""
    return not any(s in leaf for s in
                   ("scale", "bias", "mu", "lam", "decay_base", "bonus"))


#: elements of a leaf updated at once: a larger leaf (an embedding, an
#: expert bank) is updated in blocks of rows, so the update's fp32
#: temporaries (about seven copies of what is updated at once) stay
#: within a few blocks' bytes; every op is elementwise, so the blocks give
#: the whole leaf's bits
UPDATE_BLOCK = 1 << 24


def _row_blocks(p):
    """Row slices of ``p`` of at most ``UPDATE_BLOCK`` elements (one
    block: the whole leaf)."""
    if p.dim() == 0 or p.numel() <= UPDATE_BLOCK:
        return None
    rows = max(1, UPDATE_BLOCK // (p.numel() // p.shape[0]))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


def _coefficients(opt: OptConfig, step, grads, grad_norm):
    """(lr, grad norm, clip scale, the two bias corrections) of the step
    numbered ``step`` (a 0-d tensor)."""
    lr = schedule(opt, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(opt.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.float()
    return lr, gnorm, scale, 1.0 - opt.beta1 ** stepf, \
        1.0 - opt.beta2 ** stepf


def _adamw(opt: OptConfig, coef, g, m32, v32, p, decay):
    """One leaf (or row block of one): ``m32``/``v32`` hold b1·m and b2·v
    in fp32 and become the new moments in place → the new parameter in
    fp32. m = b1·m + (1 - b1)·g, v = b2·v + (1 - b2)·g², upd = m̂ / (√v̂ +
    eps) (+ wd·p), p - lr·upd: the same operations in the same order,
    each into a buffer the update owns (fewer allocations)."""
    lr, _, scale, bc1, bc2 = coef
    g32 = g.float() * scale
    m32.add_(g32 * (1 - opt.beta1))
    v32.add_(g32.square_().mul_(1 - opt.beta2))
    upd = torch.div(m32, bc1).div_(torch.div(v32, bc2).sqrt_()
                                    .add_(opt.eps))
    if decay:
        upd.add_(p.float() * opt.weight_decay)
    return torch.sub(p.float(), upd.mul_(lr))


def _leaves_to_update(opt: OptConfig, grads, state, params):
    """(path, g, m, v, p, decay) of every leaf."""
    for (path, g), m, v, p in zip(flatten_with_path(grads),
                                  leaves(state["m"]), leaves(state["v"]),
                                  leaves(params)):
        yield path, g, m, v, p, bool(opt.weight_decay) and _decay_mask(path)


@torch.no_grad()
def update(opt: OptConfig, grads, state, params, grad_norm=None):
    """One AdamW step → (new_params, new_state, {"lr", "grad_norm"});
    the inputs are not modified: :func:`update_` on copies of ``state``
    and ``params``. ``grad_norm`` is the gradients' global norm when the
    caller has it (a rank of a mesh holds only blocks of the tree)."""
    return update_(opt, grads, tree_map(torch.clone, state),
                   tree_map(torch.clone, params), grad_norm)


@torch.no_grad()
def update_(opt: OptConfig, grads, state, params, grad_norm=None):
    """One AdamW step in place → (params, state, {"lr", "grad_norm"}), the
    very trees it was given: every parameter, ``m``, ``v`` and ``step`` is
    overwritten with its new value, a leaf over ``UPDATE_BLOCK`` row block
    by row block. The reference's train step donates its params and state
    so; a caller that still needs the old values clones them first
    (:func:`update` does)."""
    state["step"].add_(1)
    coef = _coefficients(opt, state["step"], grads, grad_norm)

    def one(g, m, v, p, decay):
        # an fp32 m/v is its own buffer; a bf16 one is copied back (the
        # same rounding as ``.to``)
        m32 = m.mul_(opt.beta1) if m.dtype == torch.float32 \
            else m.float() * opt.beta1
        v32 = v.mul_(opt.beta2) if v.dtype == torch.float32 \
            else v.float() * opt.beta2
        p.copy_(_adamw(opt, coef, g, m32, v32, p, decay))
        for leaf, buf in ((m, m32), (v, v32)):
            if leaf is not buf:
                leaf.copy_(buf)

    for _, g, m, v, p, decay in _leaves_to_update(opt, grads, state,
                                                  params):
        blocks = _row_blocks(p)
        if blocks is None:
            one(g, m, v, p, decay)
            continue
        for rows in blocks:
            one(g[rows], m[rows], v[rows], p[rows], decay)
    return params, state, {"lr": coef[0], "grad_norm": coef[1]}


def loss_and_grads(model, params, batch):
    """→ (loss, metrics, grads): ``model.loss`` on detached copies of the
    leaves that require a gradient, and ``torch.autograd.grad`` of the
    loss over every leaf (the counterpart of ``jax.value_and_grad`` with
    ``has_aux``). A leaf that the loss does not reach raises."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    tl = obs_spans.ACTIVE
    with torch.enable_grad():
        sid = tl.open("train.forward") if tl is not None else 0
        loss, metrics = model.loss(live, batch)
        if sid:
            tl.close(sid)
            sid = tl.open("train.backward")
        flat = leaves(live)
        grads = torch.autograd.grad(loss, flat)
        if sid:
            tl.close(sid)
    by_path = {path: g for (path, _), g in
               zip(flatten_with_path(live), grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(live, by_path))


def make_train_step(model, opt: OptConfig, donate=False):
    """→ ``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``, as the reference builds it: with ``micro_steps`` n > 1
    the batch is split into n contiguous row blocks and the gradients are
    summed in fp32 (bf16 with ``grad_compress``, each micro-step's
    gradient cast before it is added), then divided by n. With
    ``donate`` the step updates ``params`` and ``opt_state`` in place
    (:func:`update_`) and returns them, as the reference's jit with
    ``donate_argnums=(0, 1)``; else it returns new trees
    (:func:`update`) and leaves its inputs as they were."""
    apply = update_ if donate else update
    calls = [0]

    def train_step(params, opt_state, batch):
        tl = obs_spans.ACTIVE
        sid = tl.open("train.step", calls[0]) if tl is not None else 0
        calls[0] += 1
        if opt.micro_steps <= 1:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        else:
            n = opt.micro_steps
            gdt = torch.bfloat16 if opt.grad_compress else torch.float32
            grads, loss = None, torch.zeros(
                (), dtype=torch.float32, device=leaves(params)[0].device)
            for i in range(n):
                mb = {k: x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]
                      for k, x in batch.items()}
                mloss, _, g = loss_and_grads(model, params, mb)
                g = tree_map(lambda t: t.to(gdt), g)
                grads = g if grads is None else tree_map(torch.add, grads,
                                                         g)
                loss = loss + mloss
            grads = tree_map(lambda g: g.float() / n, grads)
            loss = loss / n
            metrics = {}
        osid = tl.open("train.optimizer") if sid else 0
        new_params, new_state, om = apply(opt, grads, opt_state, params)
        if sid:
            tl.close(osid)
            tl.close(sid)
        out = {"loss": loss, **om}
        out.update({k: v for k, v in metrics.items() if k != "n_tok"})
        return new_params, new_state, out

    return train_step
