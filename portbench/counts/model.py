"""Model FLOPs of the configurations, counted from their sizes (never from
the program): 2 FLOPs a weight of every product a token passes through
(the layers' projections and the head, not the embedding lookup), plus
causal attention's context term and the WKV recurrence's state term."""

from portbench.counts import wkv


def matmul_weights(conf):
    """Weights of the products one token passes through (head included)."""
    d, ff = conf["d_model"], conf["d_ff"]
    if conf["mixer"] == "attn":
        H, Hkv, hd = conf["n_heads"], conf["n_kv_heads"], conf["d_head"]
        layer = d * H * hd * 2 + 2 * d * Hkv * hd
    else:
        r_mix, r_decay = conf["lora_mix_rank"], conf["lora_decay_rank"]
        layer = 5 * d * d + d * 5 * r_mix + 5 * r_mix * d \
            + 2 * d * r_decay
    layer += 2 * d * ff if conf["ffn"] == "gelu" else 2 * d * ff + d * d
    return conf["n_layers"] * layer + d * conf["vocab"]


def forward_flops(conf, n_tokens, start=0):
    """Forward FLOPs of ``n_tokens`` consecutive tokens whose first sits
    at position ``start`` (a prefill chunk, or one decode token)."""
    flops = 2 * matmul_weights(conf) * n_tokens
    if conf["mixer"] == "attn":
        # keys at or before each query: Σ (p + 1) over the positions
        keys = n_tokens * start + n_tokens * (n_tokens + 1) // 2
        flops += 4 * conf["n_heads"] * conf["d_head"] * keys \
            * conf["n_layers"]
    else:
        K = conf["rwkv_head_dim"]
        f, _ = wkv.forward(1, conf["d_model"] // K, n_tokens, K)
        flops += f * conf["n_layers"]
    return flops


def train_flops(conf, n_tokens):
    """A training step's model FLOPs over rows of ``n_tokens``: the
    forward and the backward's two products a forward product, no
    recomputation."""
    return 3 * forward_flops(conf, n_tokens)
