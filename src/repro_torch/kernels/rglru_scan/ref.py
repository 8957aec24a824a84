"""Plain PyTorch version of the RG-LRU scan: the sequential recurrence in
fp32. The CPU path of
:func:`~repro_torch.kernels.rglru_scan.ops.rglru_scan_op`, and the
yardstick the CUDA kernel is held against on the card."""
import torch


def rglru_scan_ref(a, b, h0):
    """h_t = a_t ⊙ h_{t-1} + b_t with h_{-1} = h0. a, b (B,S,D) fp32;
    h0 (B,D) → h (B,S,D) fp32."""
    h = h0.float()
    out = torch.empty_like(a, dtype=torch.float32)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
