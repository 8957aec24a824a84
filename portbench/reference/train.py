"""The reference's first training steps: the plain forward of
``reference.model``, its gradient by autograd, and AdamW written out from
Loshchilov and Hutter (decoupled weight decay), with the job's
hyperparameters from the traffic mix: a linear warm-up then a cosine
schedule, clipping by the global norm, and no decay on a leaf whose name
holds ``scale``, ``bias``, ``mu``, ``lam``, ``decay_base`` or ``bonus``
(the repository's rule). Everything in fp32, TF32 off; the weights and
batches are made again from the seed."""
from __future__ import annotations

import math

import torch

from portbench import generator, weights
from portbench.reference import model, ops

NO_DECAY = ("scale", "bias", "mu", "lam", "decay_base", "bonus")


def lr_at(opt, step):
    if step < opt["warmup_steps"]:
        return opt["peak_lr"] * step / max(opt["warmup_steps"], 1)
    prog = min(1.0, max(0.0, (step - opt["warmup_steps"])
                        / max(opt["decay_steps"] - opt["warmup_steps"], 1)))
    return opt["min_lr"] + 0.5 * (opt["peak_lr"] - opt["min_lr"]) * (
        1.0 + math.cos(math.pi * prog))


def initial(arch, conf, seed, device):
    """{path from the root: fp32 tensor} of the weights at step 0."""
    out = {}
    for name in arch.top_groups(conf):
        out.update(weights.make_top(arch, conf, seed, name, device, "train"))
    for i in range(conf["n_layers"]):
        out.update({("layers", i) + p: t for p, t in
                    weights.make_layer(arch, conf, seed, i, device,
                                       "train").items()})
    return out


def follow(arch, conf, mix, seed, device, steps, precision="fp32",
           fault=None):
    """→ {"losses", "grad1", "change"}: the loss of each of ``steps``
    steps, each leaf's norm of the first gradient after clipping (what
    AdamW's first moment holds over 1 - beta1), and each leaf's
    ‖p − p₀‖ after the steps, in ``weights.leaf_paths`` order.
    ``precision`` fp8 is the control; ``fault`` "half_batch" leaves half
    of each batch's tokens out (a planted fault, for its reading)."""
    ops.no_tf32()
    opt = mix["optimizer"]
    b1, b2 = opt["beta1"], opt["beta2"]
    paths = weights.leaf_paths(arch, conf)
    params = initial(arch, conf, seed, device)
    m = {p: torch.zeros_like(t) for p, t in params.items()}
    v = {p: torch.zeros_like(t) for p, t in params.items()}
    losses, grad1 = [], None
    for s in range(steps):
        b = {k: torch.from_numpy(x).to(device) for k, x in
             generator.train_batch(mix, seed, s, conf["vocab"]).items()}
        if fault == "half_batch":
            b["mask"][:, : b["mask"].shape[1] // 2] = 0
        live = {p: t.detach().requires_grad_() for p, t in params.items()}
        with torch.enable_grad():
            loss = model.loss(arch, conf, live, b, precision)
            grads = torch.autograd.grad(loss, [live[p] for p in paths])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = min(1.0, opt["clip_norm"] / max(float(gnorm), 1e-9))
            t = s + 1
            lr = lr_at(opt, t)
            bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
            if s == 0:
                grad1 = [float(g.norm()) * scale for g in grads]
            for p, g in zip(paths, grads):
                g = g * scale
                w = params[p].detach()
                m[p].mul_(b1).add_(g, alpha=1 - b1)
                v[p].mul_(b2).add_(g.square(), alpha=1 - b2)
                upd = (m[p] / bc1) / ((v[p] / bc2).sqrt() + opt["eps"])
                if opt["weight_decay"] and not any(
                        n in str(p[-1]) for n in NO_DECAY):
                    upd = upd + opt["weight_decay"] * w
                params[p] = (w - lr * upd)
        del grads, live, loss
    del m, v
    start = initial(arch, conf, seed, device)
    change = [float((params[p] - start[p]).norm()) for p in paths]
    return {"losses": losses, "grad1": grad1, "change": change}
