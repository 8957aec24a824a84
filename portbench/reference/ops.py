"""Plain PyTorch pieces of the reference, in fp32 (TF32 off), written from
the published descriptions; nothing of ``repro_torch`` is imported.

``precision`` is ``"fp32"`` for the reference itself and ``"fp8"`` for
the control, the step below the bf16 the configurations state: every
product (``linear``) takes both operands in float8 e4m3, with a scale
per row of the activation and per column of the weight, and its
incoming gradient in e5m2, accumulating in fp32; and every activation
that a bf16 model keeps in bf16 (the residual stream, norms' outputs,
products' outputs, the gates' and mixes' elementwise results, the
logits) is rounded to e4m3 with a scale per row (``rnd``; the gradient
passes it unchanged).

``"bf16"`` is no control but a witness: the reference at the precision
the configurations state, every product's operands and every kept
activation rounded to bf16 (their gradients too, as autograd casts
them), so that a look can tell what bf16's rounding alone does to a
number that the program reads far from the fp32 reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fake_quant(x, dtype, dim, top):
    """``x`` rounded to the float8 ``dtype`` with one scale per slice
    along ``dim`` (its absolute maximum mapped to ``top``), back in
    fp32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq = fake_quant(x, torch.float8_e4m3fn, -1, E4M3_MAX)
        wq = fake_quant(w, torch.float8_e4m3fn, 0, E4M3_MAX)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        gq = fake_quant(gy, torch.float8_e5m2, -1, E5M2_MAX)
        return gq @ wq.t(), xq.t() @ gq


def rnd(x, precision):
    """``x`` as the precision keeps an activation: unchanged in fp32,
    rounded to bf16 in bf16, to e4m3 (a scale per row) in fp8."""
    if precision == "fp32":
        return x
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    return x + (fake_quant(x, torch.float8_e4m3fn, -1, E4M3_MAX)
                - x).detach()


def linear(x, w, precision):
    """x (T, d_in) @ w (d_in, d_out) in fp32, the fp8 control or the
    bf16 witness."""
    if precision == "fp32":
        return x @ w
    if precision == "fp8":
        return _Fp8Matmul.apply(x, w)
    if precision == "bf16":
        return (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()
    raise ValueError(precision)


def f32(p, *path):
    """The leaf at ``path`` of a group's ``{path: tensor}``, in fp32."""
    return p[path].float()


def layer_norm_head(top, x, eps, precision):
    """The final LayerNorm and the untied head: logits (T, V)."""
    h = rnd(layer_norm(x, f32(top, "final_norm", "scale"),
                       f32(top, "final_norm", "bias"), eps), precision)
    return rnd(linear(h, f32(top, "lm_head"), precision), precision)


def layer_norm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def rope(x, pos, theta):
    """Rotary positions on x (T, H, hd), the halves rotated as pairs
    (GPT-NeoX's layout, StarCoder2's)."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = pos.float()[:, None] * inv[None]
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def sinusoid(pos, d):
    """Absolute sinusoidal position vectors (T, d): sin of the first
    half's angles, then cos."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=pos.device) / half)
    ang = pos.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def causal_attention(q, k, v, heads_at_once=8):
    """q (T, H, hd), k/v (T, Hkv, hd) → (T, H, hd): softmax(q kᵀ/√hd)
    over the keys at or before each query; query head h reads key head
    h // (H / Hkv). Computed a few heads at a time to bound memory."""
    T, H, hd = q.shape
    rep = H // k.shape[1]
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    outs = []
    for h0 in range(0, H, heads_at_once):
        hs = torch.arange(h0, min(H, h0 + heads_at_once), device=q.device)
        qh = q[:, hs].transpose(0, 1)                       # (h, T, hd)
        kh = k[:, hs // rep].transpose(0, 1)
        vh = v[:, hs // rep].transpose(0, 1)
        s = (qh @ kh.transpose(1, 2)) / math.sqrt(hd)
        s = s.masked_fill(~mask, float("-inf"))
        outs.append((torch.softmax(s, dim=-1) @ vh).transpose(0, 1))
    return torch.cat(outs, dim=1)


def wkv(r, k, v, logw, u, chunk=32):
    """The RWKV-6 recurrence over (T, H, K) inputs in fp32, from a zero
    state: o_t = Σ_i r_ti (S_ij + u_i k_ti v_tj), S ← diag(w_t) S +
    k_t v_tᵀ with w_t = exp(logw_t). Computed in chunks of ``chunk``
    tokens: within a chunk from the decays' cumulative sums (every
    exponent ≤ 0), between chunks through the state."""
    T, H, K = r.shape
    pad = (-T) % chunk
    if pad:
        z = r.new_zeros(pad, H, K)
        r, k, v, logw = (torch.cat([t, z]) for t in (r, k, v, logw))
    n = r.shape[0] // chunk

    def heads(t):                                   # → (H, n, L, K)
        return t.reshape(n, chunk, H, K).permute(2, 0, 1, 3)
    r, k, v, logw = heads(r), heads(k), heads(v), heads(logw)
    cum = logw.cumsum(dim=2)                        # through t
    cumx = cum - logw                               # before t
    lower = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=r.device).tril(-1)    # j < t
    diff = cumx[:, :, :, None, :] - cum[:, :, None, :, :]
    decay = torch.exp(diff.masked_fill(~lower[:, :, None], float("-inf")))
    att = torch.einsum("hctk,hcjk,hctjk->hctj", r, k, decay)
    o = att @ v + (r * u[:, None, None, :] * k).sum(-1, keepdim=True) * v
    state = r.new_zeros(H, K, K)
    carry = []
    for c in range(n):
        carry.append((r[:, c] * torch.exp(cumx[:, c])) @ state)
        tot = cum[:, c, -1]                          # (H, K)
        kk = k[:, c] * torch.exp(tot[:, None, :] - cum[:, c])
        state = torch.exp(tot)[:, :, None] * state + kk.transpose(1, 2) \
            @ v[:, c]
    o = o + torch.stack(carry, dim=1)
    return o.permute(1, 2, 0, 3).reshape(n * chunk, H, K)[:T]


def silu(x):
    return F.silu(x)
