"""Plain PyTorch version of the flash-attention kernel (causal/window
GQA), in the model layout the op speaks. The CPU path of
:func:`~repro_torch.kernels.flash_attention.ops.flash_attention_op`, and
the yardstick the CUDA kernel is held against on the card."""
import torch

_NEG = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q (B,Sq,Hq,hd); k/v (B,Sk,Hkv,hd) → (B,Sq,Hq,hd), fp32 maths."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float()
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * hd ** -0.5
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qpos >= kpos
    if window > 0:
        ok &= (qpos - kpos) < window
    s = torch.where(ok, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
