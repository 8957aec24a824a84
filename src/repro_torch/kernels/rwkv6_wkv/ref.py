"""Plain PyTorch version of the RWKV-6 WKV: the sequential token
recurrence of ``repro.kernels.rwkv6_wkv.ref``, in fp32. The CPU path of
:func:`~repro_torch.kernels.rwkv6_wkv.ops.rwkv6_wkv_op`, and the
yardstick the CUDA kernel is held against on the card."""
import torch


def rwkv6_wkv_ref(r, k, v, logw, u, s0):
    """r, k, v, logw (B,H,S,K) fp32 (logw ≤ 0); u (H,K); s0 (B,H,K,K) →
    (o (B,H,S,K), s_final (B,H,K,K)).

    o_tj = Σ_i r_ti (S_ij + u_i k_ti v_tj);
    S_ij ← exp(logw_ti) S_ij + k_ti v_tj.
    """
    s = s0.float()
    o = torch.empty_like(r, dtype=torch.float32)
    for t in range(r.shape[2]):
        r_t, k_t, v_t = r[:, :, t], k[:, :, t], v[:, :, t]
        bonus = (r_t * u * k_t).sum(-1, keepdim=True)
        o[:, :, t] = torch.einsum("bhk,bhkv->bhv", r_t, s) + bonus * v_t
        s = torch.exp(logw[:, :, t])[..., None] * s + \
            k_t[..., None] * v_t[..., None, :]
    return o, s
