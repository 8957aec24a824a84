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
(one product and one update a chunk) loops over the chunks. Inputs are
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
    s, reads = s0, []
    for i in range(n):
        reads.append(r_dec[:, :, i] @ s)
        s = decay[:, :, i] * s + upd[:, :, i]
    o = (o + torch.stack(reads, dim=2)).reshape(B, H, n * c, -1)
    return o[:, :, :S], s
