"""Work of the RWKV-6 WKV recurrence over (B, H, S, K) fp32 inputs, as
the algorithm needs it: per token and head, r·S (2K² FLOPs), the state's
decay, outer product and sum (3K²) and the bonus term (4K); r, k, v and
the decays read once, the output written once, the state read and
written once, in fp32."""


def forward(B, H, S, K):
    """→ (flops, bytes) of one call."""
    flops = B * H * S * (5 * K * K + 4 * K)
    nbytes = 4 * (5 * B * H * S * K + H * K + 2 * B * H * K * K)
    return flops, nbytes
