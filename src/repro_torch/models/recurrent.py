"""Recurrent mixers — the PyTorch counterparts of
``repro.models.recurrent``: the Griffin RG-LRU block (recurrentgemma),
the RWKV-6 time-mix and the RWKV channel-mix.

The full-sequence forms run their recurrence through the ported kernels
(``rglru_scan_op``, ``rwkv6_wkv_op``), as the reference does with
``use_pallas``; the one-token decode forms are plain tensor code, as in
the reference. States are fp32 (``h``, ``s``); the conv history and the
token shifts are in the compute dtype. Parameters keep the reference's
layouts and inits (shapes and scales; the random draws differ).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan.ops import rglru_scan_op
from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv_op
from repro_torch.models.layers import dense_init, dt

RG_CONV_WIDTH = 4
RG_C = 8.0                      # Griffin's fixed gate exponent scale
LORA_MIX = 32                   # RWKV6 ddlerp LoRA rank
LORA_DECAY = 64                 # RWKV6 decay LoRA rank

#: parameter names the reference reads in fp32 (``.astype(float32)`` or
#: uncast fp32 leaves), which ``Model.compute_params`` keeps in fp32
FP32_PARAMS = ("conv_w", "conv_b", "w_ra", "w_ix", "lam", "decay_base",
               "bonus_u")


def _randn(gen, shape, device):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def _uniform(gen, shape, lo, hi, device):
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return u * (hi - lo) + lo


def _gelu(x):
    return F.gelu(x, approximate="tanh")       # jax.nn.gelu's default


# ===========================================================================
# RG-LRU (Griffin recurrent block)
# ===========================================================================


def init_rglru(cfg, gen, device):
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    pd = cfg.param_dtype
    return {
        "w_x": dense_init(gen, d, d, pd, device),
        "w_g": dense_init(gen, d, d, pd, device),
        "w_o": dense_init(gen, d, d, pd, device),
        "conv_w": (_randn(gen, (RG_CONV_WIDTH, d), device) * 0.1).to(dt(pd)),
        "conv_b": torch.zeros((d,), dtype=dt(pd), device=device),
        # block-diagonal (per-head) gate projections — Griffin layout
        "w_ra": dense_init(gen, d, dh, pd, device).reshape(H, dh, dh),
        "w_ix": dense_init(gen, d, dh, pd, device).reshape(H, dh, dh),
        "lam": _uniform(gen, (d,), 2.0, 6.0, device),
    }


def _block_diag_gates(p, xr, heads):
    """sigmoid of the per-head gate projections of xr (B,S,n·dh) with
    the heads ``heads`` (a slice) of ``w_ra``/``w_ix``."""
    B, S, d = xr.shape
    w_ra, w_ix = p["w_ra"][heads], p["w_ix"][heads]
    xh = xr.reshape(B, S, w_ra.shape[0], w_ra.shape[1]).float()
    r = torch.sigmoid(torch.einsum("bshd,hde->bshe", xh,
                                   w_ra.float()).reshape(B, S, d))
    i = torch.sigmoid(torch.einsum("bshd,hde->bshe", xh,
                                   w_ix.float()).reshape(B, S, d))
    return r, i


def _rg_gates(p, xr, mesh=None):
    """xr (B,S,d) → recurrence gate log a (fp32 ≤ 0) and input gate i.
    On a mesh, xr holds the rank's block of the channels: whole heads
    take their own block of the (replicated) block-diagonal gates; a
    block that cuts a head is gathered over "model" first, and the rank
    keeps its channels of the gates."""
    d = xr.shape[-1]
    dh = p["w_ra"].shape[1]
    if mesh is None or not mesh.split("w_x", 1):
        r, i = _block_diag_gates(p, xr, slice(None))
    else:
        lo = mesh.tp_rank * d
        if d % dh == 0 and lo % dh == 0:
            r, i = _block_diag_gates(p, xr, slice(lo // dh, (lo + d) // dh))
        else:
            r, i = _block_diag_gates(
                p, mesh.all_gather(xr, ("model",), 2), slice(None))
            r, i = r[..., lo:lo + d], i[..., lo:lo + d]
    # log a_t = -c · softplus(Λ) · r_t  (≤ 0 ⇒ a_t ∈ (0,1])
    log_a = -RG_C * F.softplus(p["lam"].float())[None, None] * r
    return log_a, i


def _row_reduce(y, mesh):
    """A row-split out-projection's partial sums meet over "model"."""
    if mesh is not None and mesh.split("w_o", 0):
        return mesh.all_reduce(y, ("model",))
    return y


def _rg_conv_full(p, x):
    """Causal depthwise conv of width 4 by shifted adds. x (B,S,d)."""
    w, b = p["conv_w"].float(), p["conv_b"].float()
    xf = x.float()
    y = xf * w[0]
    for j in range(1, RG_CONV_WIDTH):
        shifted = F.pad(xf, (0, 0, j, 0))[:, :-j]
        y = y + shifted * w[j]
    return (y + b).to(x.dtype)


def rglru_full(cfg, p, x, h0=None, conv0=None, make_cache=False,
               mesh=None):
    """Full-sequence Griffin block. x (B,S,D) → (y, cache|None), cache =
    {"h": (B,d) fp32, "conv": (B,3,d)}. ``h0``/``conv0`` carry a slot's
    state into a prefill chunk. On a mesh the rank runs its block of the
    d channels (``w_x``/``w_g`` columns, conv, gates, the scan, its
    state rows) and the ``w_o`` rows' partial sums meet in one
    ``all_reduce`` over "model"."""
    cd = dt(cfg.compute_dtype)
    B, S = x.shape[:2]
    d = p["w_x"].shape[1]
    xc_in = x.to(cd)
    xb = xc_in @ p["w_x"].to(cd)
    gb = _gelu(xc_in @ p["w_g"].to(cd))
    if conv0 is not None:
        xb_ext = torch.cat([conv0.to(cd), xb], dim=1)
        xc = _rg_conv_full(p, xb_ext)[:, RG_CONV_WIDTH - 1:]
    else:
        xc = _rg_conv_full(p, xb)
    log_a, gate_i = _rg_gates(p, xc, mesh)
    a = torch.exp(log_a)                                      # (B,S,d) fp32
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    b_in = beta * (gate_i * xc.float())
    h0 = h0.float() if h0 is not None else \
        torch.zeros((B, d), dtype=torch.float32, device=x.device)
    h = rglru_scan_op(a.contiguous(), b_in.contiguous(), h0.contiguous())
    y = _row_reduce((gb.float() * h).to(cd) @ p["w_o"].to(cd), mesh)
    cache = None
    if make_cache:
        if conv0 is not None:
            # [conv history | chunk]: its tail is right even when the
            # chunk is shorter than the conv window (a 1-token last chunk)
            conv = xb_ext[:, -(RG_CONV_WIDTH - 1):]
        elif S >= RG_CONV_WIDTH - 1:
            conv = xb[:, S - (RG_CONV_WIDTH - 1):]
        else:
            conv = F.pad(xb, (0, 0, RG_CONV_WIDTH - 1 - S, 0))
        cache = {"h": h[:, -1], "conv": conv.to(cd)}
    return y, cache


def rglru_decode(cfg, p, x1, cache, mesh=None):
    """One-token Griffin step. x1 (B,1,D); cache {"h","conv"} (the
    rank's channels on a mesh, as in :func:`rglru_full`)."""
    cd = dt(cfg.compute_dtype)
    x1c = x1.to(cd)
    xb = x1c @ p["w_x"].to(cd)                                # (B,1,d)
    gb = _gelu(x1c @ p["w_g"].to(cd))
    w, bconv = p["conv_w"].float(), p["conv_b"].float()
    hist = cache["conv"].float()                              # oldest first
    xc = (xb[:, 0].float() * w[0] + hist[:, 2] * w[1] + hist[:, 1] * w[2]
          + hist[:, 0] * w[3] + bconv)[:, None]
    log_a, gate_i = _rg_gates(p, xc.to(cd), mesh)
    a = torch.exp(log_a[:, 0])
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a[:, 0]),
                                      1e-12))
    h = a * cache["h"] + beta * (gate_i[:, 0] * xc[:, 0])
    y = _row_reduce(((gb[:, 0].float() * h).to(cd)
                     @ p["w_o"].to(cd))[:, None], mesh)
    new_conv = torch.cat([hist[:, 1:], xb.float()], dim=1)
    return y, {"h": h, "conv": new_conv.to(cd)}


# ===========================================================================
# RWKV-6 time-mix (WKV) + channel-mix
# ===========================================================================


def init_rwkv_tmix(cfg, gen, device):
    d, dk = cfg.d_model, cfg.rwkv_head_dim
    H = d // dk
    pd = cfg.param_dtype
    return {
        "mu_base": torch.full((d,), 0.5, dtype=dt(pd), device=device),
        "mu_rkvwg": (_randn(gen, (5, d), device) * 0.02 + 0.5).to(dt(pd)),
        "mix_A": dense_init(gen, d, 5 * LORA_MIX, pd, device),
        "mix_B": (_randn(gen, (5, LORA_MIX, d), device) * 0.02).to(dt(pd)),
        "w_r": dense_init(gen, d, d, pd, device),
        "w_k": dense_init(gen, d, d, pd, device),
        "w_v": dense_init(gen, d, d, pd, device),
        "w_g": dense_init(gen, d, d, pd, device),
        "w_o": dense_init(gen, d, d, pd, device),
        "decay_base": _uniform(gen, (d,), -7.0, 1.0, device),
        "decay_A": dense_init(gen, d, LORA_DECAY, pd, device),
        "decay_B": dense_init(gen, LORA_DECAY, d, pd, device),
        "bonus_u": _randn(gen, (H, dk), device) * 0.02,
        "ln_scale": torch.ones((d,), dtype=dt(pd), device=device),
        "ln_bias": torch.zeros((d,), dtype=dt(pd), device=device),
    }


def _ddlerp(p, x, x_prev):
    """RWKV6 data-dependent token-shift lerp → (xr, xk, xv, xw, xg)."""
    cd = x.dtype
    dx = x_prev - x                                           # (B,S,d)
    base = x + dx * p["mu_base"].to(cd)
    lora = torch.tanh(base @ p["mix_A"].to(cd))               # (B,S,5R)
    B, S, _ = x.shape
    lora = lora.reshape(B, S, 5, LORA_MIX)
    mixes = (p["mu_rkvwg"].to(cd)[None, None]
             + torch.einsum("bsfr,frd->bsfd", lora, p["mix_B"].to(cd)))
    outs = x[:, :, None] + dx[:, :, None] * mixes             # (B,S,5,d)
    return tuple(outs[:, :, i] for i in range(5))


def _head_groupnorm(p, o_flat, H, cut_mesh=None):
    """Per-head LayerNorm (RWKV's GroupNorm with H groups), in the dtype
    of ``o_flat`` as in the reference. On a mesh whose channel blocks
    cut heads (``cut_mesh``), ``o_flat`` holds every head and the rank
    keeps its channels before the (split) affine."""
    B, S, d = o_flat.shape
    oh = o_flat.reshape(B, S, H, d // H)
    mu = oh.mean(-1, keepdim=True)
    var = oh.var(-1, keepdim=True, unbiased=False)
    oh = (oh - mu) * torch.rsqrt(var + 1e-5)
    out = oh.reshape(B, S, d)
    if cut_mesh is not None:
        out = cut_mesh.block(out, 2, ("model",))
    return out * p["ln_scale"].to(out.dtype) + p["ln_bias"].to(out.dtype)


def _split_d(mesh):
    """Whether the rank holds a block of the rwkv channels (the rules
    split ``w_r``'s columns over "model")."""
    return mesh is not None and mesh.split("w_r", 1)


def _cut_mesh(cfg, mesh):
    """``mesh`` when the rank's block of the channels cuts a head (the
    WKV then runs on every head), else None."""
    if _split_d(mesh) and (cfg.d_model // mesh.tp) % cfg.rwkv_head_dim:
        return mesh
    return None


def _full_rows(t, split, mesh):
    """A (B, d) shift row of the rank's channels → every channel."""
    return mesh.all_gather(t, ("model",), 1) if split else t


def _rwkv_proj(cfg, p, x, x_prev, mesh=None):
    """→ r, k, v (B,S,H,dk) fp32, g (B,S,d), logw (B,S,H,dk) fp32 ≤ 0.
    On a mesh that splits the channels: g is the rank's block; r, k, v
    and logw hold the rank's heads when its block is whole heads, else
    every head (gathered over "model")."""
    cd = dt(cfg.compute_dtype)
    B, S, d = x.shape
    dk = cfg.rwkv_head_dim
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev)
    r = (xr @ p["w_r"].to(cd)).float()
    k = (xk @ p["w_k"].to(cd)).float()
    v = (xv @ p["w_v"].to(cd)).float()
    g = xg @ p["w_g"].to(cd)
    ww = (p["decay_base"].float()[None, None]
          + (torch.tanh(xw @ p["decay_A"].to(cd))
             @ p["decay_B"].to(cd)).float())
    logw = -torch.exp(ww)
    if _split_d(mesh):
        logw = mesh.block(logw, 2, ("model",))
        if _cut_mesh(cfg, mesh) is not None:
            r, k, v, logw = (mesh.all_gather(t, ("model",), 2)
                             for t in (r, k, v, logw))
    return tuple(t.reshape(B, S, -1, dk) for t in (r, k, v)) + (
        g, logw.reshape(B, S, -1, dk))


def rwkv_tmix_full(cfg, p, x, cache=None, make_cache=False, mesh=None):
    """Full-sequence RWKV6 time-mix. cache {"shift": (B,d), "s":
    (B,H,K,K) fp32}. On a mesh that splits the channels the rank runs
    the WKV on its heads (on every head when its block cuts one), keeps
    its block of the shift and its heads of the state as the rules give
    them, and the ``w_o`` rows' partial sums meet in one ``all_reduce``
    over "model"."""
    cd = dt(cfg.compute_dtype)
    B, S, d = x.shape
    split = _split_d(mesh)
    x = x.to(cd)
    prev0 = (_full_rows(cache["shift"].to(cd), split, mesh)[:, None]
             if cache is not None
             else torch.zeros((B, 1, d), dtype=cd, device=x.device))
    x_prev = torch.cat([prev0, x[:, :-1]], dim=1)
    r, k, v, g, logw = _rwkv_proj(cfg, p, x, x_prev, mesh)
    H = r.shape[2]
    s0 = (cache["s"].float() if cache is not None else torch.zeros(
        (B, H, cfg.rwkv_head_dim, cfg.rwkv_head_dim), dtype=torch.float32,
        device=x.device))
    ot, s_fin = rwkv6_wkv_op(
        *(t.transpose(1, 2).contiguous() for t in (r, k, v, logw)),
        p["bonus_u"].float().contiguous(), s0.contiguous())
    o = ot.transpose(1, 2)
    o = _head_groupnorm(p, o.reshape(B, S, -1).to(cd), H,
                        _cut_mesh(cfg, mesh))
    y = _row_reduce((o * F.silu(g)) @ p["w_o"].to(cd), mesh)
    new_cache = None
    if make_cache:
        shift = mesh.block(x[:, -1], 1, ("model",)) if split else x[:, -1]
        new_cache = {"shift": shift, "s": s_fin}
    return y, new_cache


def rwkv_tmix_decode(cfg, p, x1, cache, mesh=None):
    """One-token RWKV6 step. x1 (B,1,d); on a mesh as
    :func:`rwkv_tmix_full`."""
    cd = dt(cfg.compute_dtype)
    B, _, d = x1.shape
    split = _split_d(mesh)
    x1 = x1.to(cd)
    prev = _full_rows(cache["shift"].to(cd), split, mesh)
    r, k, v, g, logw = _rwkv_proj(cfg, p, x1, prev[:, None], mesh)
    H = r.shape[2]
    r, k, v, g = r[:, 0], k[:, 0], v[:, 0], g[:, 0]           # (B,H,K)
    w = torch.exp(logw[:, 0])
    s = cache["s"]                                            # (B,H,K,V)
    o = (torch.einsum("bhk,bhkv->bhv", r, s)
         + torch.einsum("bhk,hk,bhk->bh", r, p["bonus_u"].float(),
                        k)[..., None] * v)
    s_new = w[..., None] * s + torch.einsum("bhk,bhv->bhkv", k, v)
    o = _head_groupnorm(p, o.reshape(B, 1, -1).to(cd), H,
                        _cut_mesh(cfg, mesh))[:, 0]
    y = _row_reduce(((o * F.silu(g)) @ p["w_o"].to(cd))[:, None], mesh)
    shift = mesh.block(x1[:, 0], 1, ("model",)) if split else x1[:, 0]
    return y, {"shift": shift, "s": s_new}


# ---------------------------------------------------------------------------
# RWKV channel-mix (the rwkv "FFN"; has a token-shift state)
# ---------------------------------------------------------------------------


def init_channelmix(cfg, gen, device):
    d, dff, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dt(pd), device=device),
        "mu_r": torch.full((d,), 0.5, dtype=dt(pd), device=device),
        "w_k": dense_init(gen, d, dff, pd, device),
        "w_v": dense_init(gen, dff, d, pd, device),
        "w_r": dense_init(gen, d, d, pd, device),
    }


def channelmix_full(cfg, p, x, cache=None, make_cache=False, mesh=None):
    """The channel-mix; on a mesh the rank computes its block of the
    hidden width (gathered over "model" before ``w_v``, whose columns
    the rules split) and its block of the d outputs (gathered after),
    and keeps its block of the shift."""
    cd = dt(cfg.compute_dtype)
    B, S, d = x.shape
    split = _split_d(mesh)
    x = x.to(cd)
    prev0 = (_full_rows(cache["shift"].to(cd), split, mesh)[:, None]
             if cache is not None
             else torch.zeros((B, 1, d), dtype=cd, device=x.device))
    x_prev = torch.cat([prev0, x[:, :-1]], dim=1)
    xk = x + (x_prev - x) * p["mu_k"].to(cd)
    xr = x + (x_prev - x) * p["mu_r"].to(cd)
    kh = torch.square(torch.relu(xk @ p["w_k"].to(cd)))
    if mesh is not None and mesh.split("w_k", 1):
        kh = mesh.all_gather(kh, ("model",), 2)
    y = torch.sigmoid(xr @ p["w_r"].to(cd)) * (kh @ p["w_v"].to(cd))
    if split:
        y = mesh.all_gather(y, ("model",), 2)
    if not make_cache:
        return y, None
    shift = mesh.block(x[:, -1], 1, ("model",)) if split else x[:, -1]
    return y, {"shift": shift}


def channelmix_decode(cfg, p, x1, cache, mesh=None):
    y, new = channelmix_full(cfg, p, x1, cache={"shift": cache["shift"]},
                             make_cache=True, mesh=mesh)
    return y, new
