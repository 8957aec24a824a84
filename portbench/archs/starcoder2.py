"""StarCoder2 (arXiv:2402.19173): pre-norm LayerNorm blocks; q/k/v
projections with biases, rotary positions on q and k, grouped-query
causal attention, an output projection; a GELU (tanh) MLP with biases; a
final LayerNorm and an untied head. Every layer is alike.

The benchmark's part of the family: the weights' layout (the port's
``models/attention.py`` and ``models/layers.py``), the plain fp32
reference block, the model FLOPs, the widths checked against the port,
the mixer's autograd node and the CPU sizes of the tests.
"""
from __future__ import annotations

import torch

from portbench import harness
from portbench.reference import ops
from portbench.weights import affine, layer_norm, layer_norm_top, normal

#: leaf names that a served model keeps in fp32
FP32_LEAVES = ("scale", "bias")
#: the autograd node whose backward ``mixer_bwd_share`` reads
MIXER_NODE = "_Flash"
#: the port's reduced widths, for the tests on the CPU
TINY = dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
            d_ff=256, vocab=512, rope_theta=10000.0)
WIDTHS = ("d_model", "n_heads", "n_kv_heads", "d_head", "d_ff", "vocab",
          "rope_theta", "norm_eps", "qkv_bias", "use_rope")


def layer_spec(conf, i):
    """→ [(path, shape, init)] of layer ``i``, ``path`` a tuple of keys
    inside the layer's dict."""
    d, ff = conf["d_model"], conf["d_ff"]
    H, Hkv, hd = conf["n_heads"], conf["n_kv_heads"], conf["d_head"]
    out = layer_norm("norm1", d) + layer_norm("norm2", d)
    out += [(("mixer", "wq"), (d, H, hd), normal(d ** -0.5)),
            (("mixer", "wk"), (d, Hkv, hd), normal(d ** -0.5)),
            (("mixer", "wv"), (d, Hkv, hd), normal(d ** -0.5)),
            (("mixer", "wo"), (H, hd, d), normal((H * hd) ** -0.5))]
    if conf["qkv_bias"]:
        out += [(("mixer", "bq"), (H, hd), affine(0.0, 0.1)),
                (("mixer", "bk"), (Hkv, hd), affine(0.0, 0.1)),
                (("mixer", "bv"), (Hkv, hd), affine(0.0, 0.1))]
    out += [(("ffn", "w_up"), (d, ff), normal(d ** -0.5)),
            (("ffn", "b_up"), (ff,), affine(0.0, 0.1)),
            (("ffn", "w_down"), (ff, d), normal(ff ** -0.5)),
            (("ffn", "b_down"), (d,), affine(0.0, 0.1))]
    return out


top_groups = layer_norm_top


def layer(conf, i, p, x, precision):
    """Block ``i`` on x (T, d)."""
    T, d = x.shape
    H, Hkv, hd = conf["n_heads"], conf["n_kv_heads"], conf["d_head"]
    eps = conf["norm_eps"]
    pos = torch.arange(T, device=x.device)

    def r(t):
        return ops.rnd(t, precision)
    h = r(ops.layer_norm(x, ops.f32(p, "norm1", "scale"),
                         ops.f32(p, "norm1", "bias"), eps))

    def proj(name, bias, heads):
        w = ops.f32(p, "mixer", name).reshape(d, heads * hd)
        y = r(ops.linear(h, w, precision)).reshape(T, heads, hd)
        return r(y + ops.f32(p, "mixer", bias)) if ("mixer", bias) in p \
            else y
    q = r(ops.rope(proj("wq", "bq", H), pos, conf["rope_theta"]))
    k = r(ops.rope(proj("wk", "bk", Hkv), pos, conf["rope_theta"]))
    v = proj("wv", "bv", Hkv)
    o = r(ops.causal_attention(q, k, v).reshape(T, H * hd))
    x = r(x + r(ops.linear(o, ops.f32(p, "mixer", "wo").reshape(H * hd, d),
                           precision)))
    h2 = r(ops.layer_norm(x, ops.f32(p, "norm2", "scale"),
                          ops.f32(p, "norm2", "bias"), eps))
    u = r(ops.gelu_tanh(r(ops.linear(h2, ops.f32(p, "ffn", "w_up"),
                                     precision))
                        + ops.f32(p, "ffn", "b_up")))
    return r(x + r(ops.linear(u, ops.f32(p, "ffn", "w_down"), precision)
                   + ops.f32(p, "ffn", "b_down")))


def embed(conf, top, tokens, precision):
    """Token embeddings (T, d); the positions are rotary, in the layers."""
    return ops.rnd(ops.f32(top, "tok_embed")[tokens], precision)


def head(conf, top, x, precision):
    return ops.layer_norm_head(top, x, conf["norm_eps"], precision)


def top_matmul_weights(conf):
    """Weights of the products outside the layers a token passes through:
    the head (the embedding is a lookup)."""
    return conf["d_model"] * conf["vocab"]


def layer_matmul_weights(conf, i):
    """Weights of layer ``i``'s products one token passes through."""
    d, ff = conf["d_model"], conf["d_ff"]
    H, Hkv, hd = conf["n_heads"], conf["n_kv_heads"], conf["d_head"]
    return d * H * hd * 2 + 2 * d * Hkv * hd + 2 * d * ff


def layer_context_flops(conf, i, n_tokens, start):
    """Layer ``i``'s FLOPs beyond its products for ``n_tokens`` tokens
    from position ``start``: q·kᵀ and p·v over the keys at or before each
    query, Σ (p + 1) over the positions."""
    keys = n_tokens * start + n_tokens * (n_tokens + 1) // 2
    return 4 * conf["n_heads"] * conf["d_head"] * keys


def check_port(conf, cfg):
    """The widths the file states against the port's ``cfg``."""
    harness.check_widths(conf, {
        **{k: getattr(cfg, k) for k in WIDTHS},
        "mixer": "/".join(cfg.block_pattern), "ffn": cfg.ffn_kind,
        "norm": cfg.norm})
