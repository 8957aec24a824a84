"""Mixture-of-experts FFN — the PyTorch counterpart of
``repro.models.moe`` on one device: top-k routing in fp32 with the
reference's sort-based gather dispatch (``apply_moe_gather``).

Assignments are sorted by expert (stably), each placed into its expert's
capacity buffer of ``C = int(T·K·cf/E) + 1`` rows over all T tokens of
the call, assignments past C dropped; the experts run as batched
products ``(E, C, d) × (E, d, d_e)``, and each token sums its K weighted
contributions. A dead serving slot's placeholder row is routed like any
other and takes capacity, as in the reference.

On a mesh (``mesh``, a rank's ``RankMesh`` narrowed to the layer's FFN,
whose specs say what the rules split), the rules place the experts
over "model" (E divisible by it: EP, with d_e also over "data" under
``shard_experts_data``) or, for a few big experts, d_e over "model"
(expert-TP). ``apply_moe`` dispatches as the reference does
(``moe.py:56-60``): with ``moe_impl="ep"`` and a model axis > 1, the
reference's three ``shard_map`` regimes (:func:`apply_moe_ep`) with
explicit collectives; otherwise the gather path as GSPMD partitions it
(:func:`_apply_moe_gather_mesh`): the same dispatch over the global
batch, each rank running its experts (or its d_e slice), the partial
sums meeting over the axes the weights are split on. Every path routes
and dispatches through one function, :func:`_dispatch`.

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


def apply_moe(cfg, p, x, mesh=None):
    """x (B, S, d) → (y, aux); dispatches on ``cfg.sharding.moe_impl``
    as the reference does (one device: the gather path)."""
    if mesh is None:
        return apply_moe_gather(cfg, p, x)
    if cfg.sharding.moe_impl == "ep" and mesh.tp > 1:
        return apply_moe_ep(cfg, p, x, mesh)
    return _apply_moe_gather_mesh(cfg, p, x, mesh)


def apply_moe_gather(cfg, p, x):
    """The reference's sort/gather capacity dispatch (``moe.py:64-122``)
    → (y (B, S, d) in the compute dtype, the load-balance aux loss)."""
    B, S, d = x.shape
    T = B * S
    C = capacity(T, cfg.moe.top_k, p["router"].shape[1],
                 cfg.moe.capacity_factor)
    xf = x.reshape(T, d)
    xe, combine, aux = _dispatch(cfg, p, xf, C)
    y = combine(_experts(cfg, xe, p["w_gate"], p["w_up"], p["w_down"]))
    if "shared" in p:
        y = y + _shared(cfg, p["shared"], xf)
    return y.reshape(B, S, d), aux


def _dispatch(cfg, p, xf, C):
    """Routing (fp32) and the capacity dispatch of the T tokens of ``xf``
    with capacity C (the reference's ``_route_dispatch_local``,
    ``moe.py:144``) → (xe (E, C, d) in the compute dtype, a combine
    closure ``ye (E, C, d) → y (T, d)`` that sums each token's K
    weighted contributions in a fixed order, aux). Assignments are
    sorted by expert (stably); those past C land on the spare index E·C
    and are cut off."""
    m = cfg.moe
    T, d = xf.shape
    K = m.top_k
    E = p["router"].shape[1]
    cd = dt(cfg.compute_dtype)
    dev = xf.device
    probs, top_w, top_i = route(cfg, p, xf)
    dispatch_frac = F.one_hot(top_i, E).float().sum(1).mean(0)
    aux = E * torch.sum(dispatch_frac / K * probs.mean(0)) \
        * m.router_aux_coef
    eid = top_i.reshape(-1)                               # token-major
    order = torch.argsort(eid, stable=True)
    seid = eid[order]
    stok = order // K
    # each expert's first row in the sorted order (= the exclusive sum
    # of the counts; no bincount, which has no meta kernel)
    starts = torch.searchsorted(seid, torch.arange(E, device=dev))
    pos = torch.arange(T * K, device=dev) - starts[seid]
    keep = pos < C
    slot = seid * C + pos.clamp_max(C - 1)
    slot_tok = torch.full((E * C + 1,), T, dtype=torch.long, device=dev)
    slot_tok[torch.where(keep, slot, E * C)] = stok
    x_pad = torch.cat([xf.to(cd), xf.new_zeros((1, d), dtype=cd)])
    xe = x_pad[slot_tok[:E * C]].reshape(E, C, d)
    w = (top_w.reshape(-1)[order] * keep).to(cd)

    def combine(ye):
        # back to token-major order, then each token's K contributions
        # summed in a fixed order
        contrib = torch.empty((T * K, d), dtype=ye.dtype, device=dev)
        contrib[order] = ye.reshape(E * C, d)[slot] * w[:, None]
        return contrib.reshape(T, K, d).sum(1)
    return xe, combine, aux


def _experts(cfg, xe, wg, wu, wd):
    """The experts as batched products ``(E, C, d) × (E, d, d_e)``."""
    cd = dt(cfg.compute_dtype)
    g = torch.bmm(xe, wg.to(cd))
    u = torch.bmm(xe, wu.to(cd))
    return torch.bmm(F.silu(g) * u, wd.to(cd))


def _shared(cfg, sh, xf):
    """The always-on shared experts of the tokens ``xf`` (T, d)."""
    cd = dt(cfg.compute_dtype)
    xc = xf.to(cd)
    return (F.silu(xc @ sh["w_gate"].to(cd)) * (xc @ sh["w_up"].to(cd))
            ) @ sh["w_down"].to(cd)


# ===========================================================================
# On a mesh
# ===========================================================================


def _apply_moe_gather_mesh(cfg, p, x, mesh, mean_aux=False):
    """The gather path as GSPMD partitions it: the rank's batch rows are
    gathered over the batch axes, routed and dispatched over the global
    batch (the one-device capacity and drops), each rank runs its block
    of the experts (EP) or of d_e (expert-TP, or 2-D over "data"), the
    partial sums meet over the axes the weights are split on, and the
    rank keeps its rows.

    It is also the reference's 2-D inference regime (``moe.py:205``,
    ``mean_aux``), which differs only in averaging the aux loss over
    the mesh. (The reference's 2-D regime also sums over "pod", which
    splits no weight: on a mesh with a pod axis its result is the pod
    size times this one.)"""
    m = cfg.moe
    b_ok = mesh.b_ok
    xg = mesh.all_gather(x, mesh.dp_axes, 0) if b_ok else x
    Bg, S, d = xg.shape
    T = Bg * S
    E = p["router"].shape[1]
    C = capacity(T, m.top_k, E, m.capacity_factor)
    xf = xg.reshape(T, d).to(dt(cfg.compute_dtype))
    xe, combine, aux = _dispatch(cfg, p, xf, C)
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    axes = []
    if mesh.split("w_gate", 0):                            # EP
        E_loc = wg.shape[0]
        e0 = mesh.tp_rank * E_loc
        ye_loc = _experts(cfg, xe[e0:e0 + E_loc], wg, wu, wd)
        ye = torch.cat([ye_loc.new_zeros((e0, C, d)), ye_loc,
                        ye_loc.new_zeros((E - e0 - E_loc, C, d))])
        axes.append("model")
        if mesh.split("w_gate", 2, "data"):               # d_e over data
            axes.append("data")
    else:
        ye = _experts(cfg, xe, wg, wu, wd)
        if mesh.split("w_gate", 2):                        # expert-TP
            axes.append("model")
    y = mesh.all_reduce(combine(ye), tuple(axes))
    if "shared" in p:
        y = y + _shared(cfg, p["shared"], xf)
    if mean_aux:
        aux = _mean_over(mesh, aux, mesh.dp_axes + ("model",))
    y = y.reshape(Bg, S, d)
    return (mesh.block(y, 0, mesh.dp_axes) if b_ok else y), aux


def apply_moe_ep(cfg, p, x, mesh):
    """The reference's expert parallelism over "model"
    (``moe.py:179-202``): token routing when E divides the model axis
    (expert-TP otherwise), the 2-D inference regime for B·S ≤ 2048 with
    ``shard_experts_data`` and d_e divisible by the batch axes (the few
    tokens of a decode-sized call gathered, every rank routing all of
    them: :func:`_apply_moe_gather_mesh`)."""
    m = cfg.moe
    if m.n_experts % mesh.tp != 0:
        return _apply_moe_expert_tp(cfg, p, x, mesh)
    B, S, _ = x.shape
    if (B * S <= 2048 and cfg.sharding.shard_experts_data
            and m.d_expert % mesh.dp == 0):
        return _apply_moe_gather_mesh(cfg, p, x, mesh, mean_aux=True)
    return _apply_moe_token_routing(cfg, p, x, mesh)


def _full_expert_width(mesh, p, name, dim):
    """An expert bank whose d_e the rules split over "data" → every d_e
    column (the token-routing regime keeps d_e whole)."""
    if mesh.split(name, dim, "data"):
        return mesh.all_gather(p[name], ("data",), dim)
    return p[name]


def _mean_over(mesh, aux, axes):
    n = mesh.size([a for a in axes if mesh.sizes[a] > 1])
    return mesh.all_reduce(aux, axes) / n if n > 1 else aux


def _apply_moe_token_routing(cfg, p, x, mesh):
    """(reference ``moe.py:328``) The rank's tokens (its batch rows,
    replicated over "model") are split into ``tp`` padded slices; each
    model rank routes its slice with capacity C over the slice, sends
    each expert's rows to the rank that owns it (``all_to_all``), runs
    its ``E / tp`` experts, sends the results back (``all_to_all``),
    combines, adds the shared experts on its slice, and the slices are
    gathered over "model"."""
    m = cfg.moe
    cd = dt(cfg.compute_dtype)
    Bl, S, d = x.shape
    E, tp = m.n_experts, mesh.tp
    E_loc = E // tp
    T = Bl * S
    xf = x.reshape(T, d).to(cd)
    T_m = -(-T // tp)
    xf_p = F.pad(xf, (0, 0, 0, T_m * tp - T))
    x_m = xf_p[mesh.tp_rank * T_m:(mesh.tp_rank + 1) * T_m]
    C = capacity(T_m, m.top_k, E, m.capacity_factor)
    xe, combine, aux = _dispatch(cfg, p, x_m, C)
    recv = mesh.all_to_all(xe.reshape(tp, E_loc, C, d), "model")
    xe_loc = recv.transpose(0, 1).reshape(E_loc, tp * C, d)
    ye = _experts(cfg, xe_loc, _full_expert_width(mesh, p, "w_gate", 2),
                  _full_expert_width(mesh, p, "w_up", 2),
                  _full_expert_width(mesh, p, "w_down", 1))
    back = ye.reshape(E_loc, tp, C, d).transpose(0, 1)
    got = mesh.all_to_all(back.contiguous(), "model")
    y_m = combine(got.reshape(E, C, d))
    if "shared" in p:
        y_m = y_m + _shared(cfg, p["shared"], x_m)
    y = mesh.all_gather(y_m, ("model",), 0)[:T]
    aux = _mean_over(mesh, aux, ("model",) + mesh.dp_axes)
    return y.reshape(Bl, S, d), aux


def _apply_moe_expert_tp(cfg, p, x, mesh):
    """(reference ``moe.py:278``) Every rank routes its batch rows over
    all E experts (capacity over its rows) and runs its d_e slice of
    every expert; the partial sums meet in an ``all_reduce`` over
    "model"; the shared experts are added after it."""
    m = cfg.moe
    Bl, S, d = x.shape
    T = Bl * S
    xf = x.reshape(T, d).to(dt(cfg.compute_dtype))
    C = capacity(T, m.top_k, m.n_experts, m.capacity_factor)
    xe, combine, aux = _dispatch(cfg, p, xf, C)
    ye = _experts(cfg, xe, p["w_gate"], p["w_up"], p["w_down"])
    y = mesh.all_reduce(combine(ye), ("model",))
    if "shared" in p:
        y = y + _shared(cfg, p["shared"], xf)
    aux = _mean_over(mesh, aux, mesh.dp_axes)
    return y.reshape(Bl, S, d), aux
