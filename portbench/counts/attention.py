"""Work of causal grouped-query attention, as the algorithm needs it.

FLOPs: q·kᵀ and p·v over the (query, key) pairs at or before each
query, 2 × 2 × hd a pair and a query head. Bytes: q, k and v read once
and the output written once, in the served element size; the scores
never leave the chip."""


def causal_gqa(B, S, Hq, Hkv, hd, itemsize=2):
    """→ (flops, bytes) of one call over B rows of S tokens."""
    pairs = S * (S + 1) // 2
    flops = 4 * B * Hq * hd * pairs
    nbytes = itemsize * B * S * hd * (2 * Hq + 2 * Hkv)
    return flops, nbytes
