"""Plain PyTorch versions of the ring-cache decode attention, the paged
decode attention (with and without the step's new token) and the
on-device sampler, in the call layout of their ops. The CPU path of the
wrappers in ``ops.py`` and the yardsticks the CUDA kernels are held
against on the card."""
import torch

_NEG = -1e30


def ring_valid(C, pos, window=0, device=None):
    """(C,) bool: the ring slots that hold one of the last
    ``min(pos + 1, C)`` positions (``slot <= pos`` or the ring is full),
    and with a window only those of ring age ``(pos % C - slot) mod C <
    window``. ``pos`` is an int or a 0-d integer tensor."""
    slot = torch.arange(C, device=device)
    pos = torch.as_tensor(pos, device=device).long()
    valid = (slot <= pos) | (pos >= C)
    if window > 0:
        valid &= torch.remainder(torch.remainder(pos, C) - slot, C) < window
    return valid


def decode_attention_ref(q, k_cache, v_cache, pos, *, window=0):
    """q (B,1,Hq,hd); ring caches (B,C,Hkv,hd); ``pos`` the shared
    position of the new token (int or 0-d tensor) → (B,1,Hq,hd).

    Invalid slots are replaced by zeros before any product, so a NaN in
    an unwritten slot cannot reach ``p·v``."""
    B, _, Hq, hd = q.shape
    C, Hkv = k_cache.shape[1], k_cache.shape[2]
    valid = ring_valid(C, pos, window, q.device)
    rows = valid[None, :, None, None]
    k = torch.where(rows, k_cache, torch.zeros_like(k_cache)).float()
    v = torch.where(rows, v_cache, torch.zeros_like(v_cache)).float()
    kr = k.repeat_interleave(Hq // Hkv, dim=2)
    vr = v.repeat_interleave(Hq // Hkv, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q[:, 0].float(), kr) * hd ** -0.5
    s = torch.where(valid[None, None], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhs,bshd->bhd", p, vr)
    return o[:, None].to(q.dtype)


def fused_paged_decode_ref(q, k_new, v_new, k_pages, v_pages, lengths,
                           block_tables, *, window=0):
    """q (B,1,Hq,hd); k_new/v_new (B,1,Hkv,hd) at logical index
    ``lengths-1``, not yet in the pools; pools (P,ps,Hkv,hd); lengths (B,)
    include the new token (0 = dead slot → zeros); block_tables (B,nb).

    Masked rows are replaced by zeros before any product, so a NaN left
    in a masked pool row cannot reach ``p·v`` (0·NaN would be NaN); an
    all-masked row divides by ``max(l, 1e-30)`` and returns zeros."""
    B, _, Hq, hd = q.shape
    _, ps, Hkv, _ = k_pages.shape
    G = Hq // Hkv
    nb = block_tables.shape[1]
    S = nb * ps
    idx = block_tables.long()
    k = k_pages[idx].reshape(B, S, Hkv, hd)
    v = v_pages[idx].reshape(B, S, Hkv, hd)
    lens = lengths.long()[:, None]
    tok = torch.arange(S, device=q.device)[None]
    is_new = (tok == lens - 1)[:, :, None, None]
    k = torch.where(is_new, k_new, k)
    v = torch.where(is_new, v_new, v)
    valid = tok < lens
    if window > 0:
        valid &= tok >= lens - window
    rows = valid[:, :, None, None]
    k = torch.where(rows, k, torch.zeros_like(k)).float()
    v = torch.where(rows, v, torch.zeros_like(v)).float()
    kr = k.repeat_interleave(G, dim=2)
    vr = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q[:, 0].float(), kr) * hd ** -0.5
    m = valid[:, None, :]
    s = torch.where(m, s, torch.full_like(s, _NEG))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(m, p, torch.zeros_like(p))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhs,bshd->bhd", p, vr)
    return o[:, None].to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, lengths, block_tables,
                               *, window=0):
    """q (B,1,Hq,hd); pools (P,ps,Hkv,hd) holding every valid token;
    lengths (B,) valid-token counts (0 = dead slot → zeros);
    block_tables (B,nb) → (B,1,Hq,hd). Masked rows are zeroed before any
    product, as in :func:`fused_paged_decode_ref`."""
    B, _, Hq, hd = q.shape
    _, ps, Hkv, _ = k_pages.shape
    G = Hq // Hkv
    S = block_tables.shape[1] * ps
    idx = block_tables.long()
    k = k_pages[idx].reshape(B, S, Hkv, hd)
    v = v_pages[idx].reshape(B, S, Hkv, hd)
    lens = lengths.long()[:, None]
    tok = torch.arange(S, device=q.device)[None]
    valid = tok < lens
    if window > 0:
        valid &= tok >= lens - window
    rows = valid[:, :, None, None]
    k = torch.where(rows, k, torch.zeros_like(k)).float()
    v = torch.where(rows, v, torch.zeros_like(v)).float()
    kr = k.repeat_interleave(G, dim=2)
    vr = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q[:, 0].float(), kr) * hd ** -0.5
    m = valid[:, None, :]
    s = torch.where(m, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    p = torch.where(m, p, torch.zeros_like(p))
    o = torch.einsum("bhs,bshd->bhd", p, vr)
    return o[:, None].to(q.dtype)


def sample_tokens_ref(logits, temps, noise):
    """argmax(logits + noise·T) per row → (B,) int32, in torch.argmax's
    (and np.argmax's) order: scores are ordered totally, a NaN above
    +inf; among equal scores, and among NaNs, the lowest index wins; -0.0
    and +0.0 are equal; an all -inf row picks 0. T = 0 with an infinite
    noise value gives a NaN score (0·inf), which wins its row."""
    scores = logits.float() + noise.float() * temps.float()[:, None]
    return torch.argmax(scores, dim=-1).to(torch.int32)
