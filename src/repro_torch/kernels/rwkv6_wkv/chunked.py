"""The RWKV-6 WKV in the chunked form of the reference's
``repro.models.recurrent._wkv_chunk_scan``, in PyTorch: the formula the
WKV's backward differentiates (its ``autograd.Function``, ``ops.py``),
as the reference trains through XLA autodiff of that function.

The same algorithm and chunk (``WKV_CHUNK`` = 16; a ragged tail padded
with r = k = v = 0, logw = 0): per chunk, L the inclusive cumulative log
decay and Lp the exclusive one; the output reads the chunk's decayed
initial state, the pairwise intra-chunk decays in log space (every
exponent ≤ 0), and the current token's bonus; the state carries the
chunk's keys decayed to its end. The terms that do not depend on the
carried state are computed for every chunk at once, so only the carry
(one multiply-add a chunk, :class:`_Carry`, whose backward runs
the adjoint recurrence the same way) loops over the chunks. Inputs are
in the kernel's layout, (B, H, S, K)."""
import torch

WKV_CHUNK = 16


def wkv_chunked(r, k, v, logw, u, s0):
    """r, k, v, logw (B,H,S,K) fp32 (logw ≤ 0); u (H,K); s0 (B,H,K,V) →
    (o (B,H,S,V), s_final (B,H,K,V))."""
    B, H, S, K = r.shape
    c = min(WKV_CHUNK, S)
    pad = -S % c
    if pad:
        r, k, v, logw = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                         for t in (r, k, v, logw))
    n = (S + pad) // c
    r, k, v, lw = (t.reshape(B, H, n, c, t.shape[-1])
                   for t in (r, k, v, logw))
    L = torch.cumsum(lw, dim=3)                            # inclusive
    Lp = L - lw                                            # exclusive
    # intra-chunk: pairwise decay in log space (exponents <= 0)
    diff = Lp[:, :, :, :, None] - L[:, :, :, None]         # (B,H,n,c,c,K)
    ii = torch.arange(c, device=r.device)
    causal = (ii[:, None] > ii[None, :])[:, :, None]
    D = torch.where(causal, torch.exp(torch.clamp(diff, max=0.0)), 0.0)
    scores = torch.einsum("bhnik,bhnjk,bhnijk->bhnij", r, k, D)
    o = scores @ v
    # bonus (current token)
    o = o + (r * u[None, :, None, None] * k).sum(-1, keepdim=True) * v
    # inter-chunk: each chunk reads its decayed initial state
    r_dec = r * torch.exp(Lp)
    L_last = L[:, :, :, -1]                                # (B,H,n,K)
    upd = torch.einsum("bhnjk,bhnjv->bhnkv",
                       k * torch.exp(L_last[:, :, :, None] - L), v)
    decay = torch.exp(L_last)[..., None]                   # (B,H,n,K,1)
    reads, s = _Carry.apply(r_dec, decay, upd, s0)
    o = (o + reads).reshape(B, H, n * c, -1)
    return o[:, :, :S], s


class _Carry(torch.autograd.Function):
    """The carried state across chunks, ``s_{i+1} = d_i ⊙ s_i + u_i``
    from ``s0``, and each chunk's read of the state it starts from,
    ``r_i @ s_i``: r_dec (B,H,n,c,K), decay (B,H,n,K,1), upd (B,H,n,K,V),
    s0 (B,H,K,V) → (reads (B,H,n,c,V), s_n). Only the recurrence loops
    over the chunks (one multiply-add a chunk, each way); the
    reads and every other gradient are one batched product or product
    of all chunks at once — autograd through the loop would run seven
    more ops a chunk."""

    @staticmethod
    def forward(ctx, r_dec, decay, upd, s0):
        s, states = s0, []
        for d_i, u_i in zip(decay.unbind(2), upd.unbind(2)):
            states.append(s)
            s = torch.addcmul(u_i, d_i, s)                 # d_i ⊙ s + u_i
        S = torch.stack(states, dim=2)                     # each s_i
        ctx.save_for_backward(r_dec, decay, S)
        return r_dec @ S, s

    @staticmethod
    def backward(ctx, g_reads, g_s):
        r_dec, decay, S = ctx.saved_tensors
        g_r = g_reads @ S.transpose(-1, -2)
        direct = r_dec.transpose(-1, -2) @ g_reads        # ∂reads_i/∂s_i
        gs = torch.zeros_like(S[:, :, 0]) if g_s is None else g_s
        g_next = []                                       # ∂/∂s_{i+1}
        for d_i, x_i in zip(reversed(decay.unbind(2)),
                            reversed(direct.unbind(2))):
            g_next.append(gs)
            gs = torch.addcmul(x_i, d_i, gs)
        G = torch.stack(g_next[::-1], dim=2)
        return g_r, (G * S).sum(-1, keepdim=True), G, gs
