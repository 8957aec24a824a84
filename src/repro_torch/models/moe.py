"""Mixture-of-experts FFN — the PyTorch counterpart of
``repro.models.moe`` on one device: top-k routing in fp32 with the
reference's sort-based gather dispatch (``apply_moe_gather``).

Assignments are sorted by expert (stably), each placed into its expert's
capacity buffer of ``C = int(T·K·cf/E) + 1`` rows over all T tokens of
the call, assignments past C dropped; the experts run as batched
products ``(E, C, d) × (E, d, d_e)``, and each token sums its K weighted
contributions. A dead serving slot's placeholder row is routed like any
other and takes capacity, as in the reference. The expert-parallel
shard_map paths of the reference need a mesh and are not ported; on one
device the reference takes the gather path too.

Two choices keep the result deterministic on the card: top-k ties go to
the lower expert index (``jax.lax.top_k``'s rule: a stable descending
sort, where ``torch.topk`` promises no order), and the combine sums a
token's K contributions in a fixed order (``index_add_`` on CUDA adds
atomically, in no fixed order).

Training reads ``apply_moe``'s aux loss through ``lm.apply_stack_full``,
which sums it over the layers into ``Model.loss``. The dispatch and the
combine are differentiable as written: their one indexed write fills a
fresh buffer (``contrib``) that nothing saved before it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, dt


def init_moe(cfg, gen, device):
    """Router (fp32), stacked experts ``(E, d, de)`` / ``(E, de, d)`` and,
    when the config has them, the always-on shared experts."""
    m = cfg.moe
    E, de = m.n_experts, m.d_expert
    d, pd = cfg.d_model, cfg.param_dtype

    def stacked(d_in, d_out):
        return dense_init(gen, E * d_in, d_out, pd, device).reshape(
            E, d_in, d_out)
    p = {"router": dense_init(gen, d, E, "float32", device),
         "w_gate": stacked(d, de), "w_up": stacked(d, de),
         "w_down": stacked(de, d)}
    if m.n_shared_experts:
        dsh = de * m.n_shared_experts
        p["shared"] = {"w_gate": dense_init(gen, d, dsh, pd, device),
                       "w_up": dense_init(gen, d, dsh, pd, device),
                       "w_down": dense_init(gen, dsh, d, pd, device)}
    return p


def capacity(n_tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    return max(int(n_tokens * top_k * cf / n_experts) + 1, 1)


def route(cfg, p, xf):
    """fp32 routing of xf (T, d) → (probs (T, E), top_w (T, K)
    renormalised, top_i (T, K)); among equal probabilities the lower
    expert index comes first."""
    K = cfg.moe.top_k
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :K], top_i[:, :K]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_w, top_i


def apply_moe(cfg, p, x):
    """x (B, S, d) → (y, aux). One device: always the gather path."""
    return apply_moe_gather(cfg, p, x)


def apply_moe_gather(cfg, p, x):
    """The reference's sort/gather capacity dispatch (``moe.py:64-122``)
    → (y (B, S, d) in the compute dtype, the load-balance aux loss)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    K = m.top_k
    E = p["router"].shape[1]
    C = capacity(T, K, E, m.capacity_factor)
    cd = dt(cfg.compute_dtype)
    xf = x.reshape(T, d)
    dev = x.device

    probs, top_w, top_i = route(cfg, p, xf)
    dispatch_frac = F.one_hot(top_i, E).float().sum(1).mean(0)
    aux = E * torch.sum(dispatch_frac / K * probs.mean(0)) \
        * m.router_aux_coef

    eid = top_i.reshape(-1)                               # token-major
    order = torch.argsort(eid, stable=True)
    seid = eid[order]
    stok = order // K
    counts = torch.bincount(eid, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * K, device=dev) - starts[seid]
    keep = pos < C
    slot = seid * C + pos.clamp_max(C - 1)
    # dropped assignments land on the spare index E·C and are cut off
    slot_tok = torch.full((E * C + 1,), T, dtype=torch.long, device=dev)
    slot_tok[torch.where(keep, slot, E * C)] = stok
    x_pad = torch.cat([xf.to(cd), xf.new_zeros((1, d), dtype=cd)])
    xe = x_pad[slot_tok[:E * C]].reshape(E, C, d)

    g = torch.bmm(xe, p["w_gate"].to(cd))
    u = torch.bmm(xe, p["w_up"].to(cd))
    ye = torch.bmm(F.silu(g) * u, p["w_down"].to(cd))

    # back to token-major order, then each token's K contributions
    # summed in a fixed order
    w = (top_w.reshape(-1)[order] * keep).to(cd)
    contrib = torch.empty((T * K, d), dtype=cd, device=dev)
    contrib[order] = ye.reshape(E * C, d)[slot] * w[:, None]
    y = contrib.reshape(T, K, d).sum(1)

    if "shared" in p:
        sh = p["shared"]
        xc = xf.to(cd)
        y = y + (F.silu(xc @ sh["w_gate"].to(cd)) * (xc @ sh["w_up"].to(cd))
                 ) @ sh["w_down"].to(cd)
    return y.reshape(B, S, d), aux
