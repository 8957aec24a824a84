"""Model FLOPs of the configurations, counted from their sizes (never from
the program): 2 FLOPs a weight of every product a token passes through
(the layers' projections and the head, not the embedding lookup), plus
each layer's context or state term (causal attention's keys, a
recurrence's state). The architecture family (``portbench/archs/``)
gives each layer's terms by its index; they are summed here."""


def matmul_weights(arch, conf):
    """Weights of the products one token passes through (head included)."""
    return arch.top_matmul_weights(conf) + sum(
        arch.layer_matmul_weights(conf, i) for i in range(conf["n_layers"]))


def forward_flops(arch, conf, n_tokens, start=0):
    """Forward FLOPs of ``n_tokens`` consecutive tokens whose first sits
    at position ``start`` (a prefill chunk, or one decode token)."""
    return 2 * matmul_weights(arch, conf) * n_tokens + sum(
        arch.layer_context_flops(conf, i, n_tokens, start)
        for i in range(conf["n_layers"]))


def train_flops(arch, conf, n_tokens):
    """A training step's model FLOPs over rows of ``n_tokens``: the
    forward and the backward's two products a forward product, no
    recomputation."""
    return 3 * forward_flops(arch, conf, n_tokens)
