"""RWKV-6 "Finch" (arXiv:2404.05892): the time-mix with the data-dependent
token shift (a LoRA of rank ``lora_mix_rank`` over five mixes), the
data-dependent decay (a LoRA of rank ``lora_decay_rank``; the ranks are
the weights' shapes), the WKV recurrence with its bonus ``u``, a per-head
LayerNorm and the SiLU gate; the channel-mix with its token shift,
squared ReLU and sigmoid gate; a final LayerNorm and an untied head.
Every layer is alike. Departures from the published model, as the
repository defines it: sinusoidal absolute positions are added to the
embeddings, and there is no LayerNorm right after the embedding.

The benchmark's part of the family: the weights' layout (the port's
``models/recurrent.py`` and ``models/layers.py``), the plain fp32
reference block, the model FLOPs, the widths checked against the port
(the LoRA ranks among them, which the port fixes), the mixer's autograd
node and the CPU sizes of the tests.
"""
from __future__ import annotations

import torch

from portbench import harness
from portbench.counts import wkv
from portbench.reference import ops
from portbench.weights import affine, layer_norm, layer_norm_top, normal

#: leaf names that a served model keeps in fp32 (``Model.compute_params``
#: keeps the norms' and these recurrent leaves)
FP32_LEAVES = ("scale", "bias", "decay_base", "bonus_u")
#: the autograd node whose backward ``mixer_bwd_share`` reads
MIXER_NODE = "_Wkv"
#: the port's reduced widths, for the tests on the CPU
TINY = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_head=32,
            rwkv_head_dim=32, d_ff=128, vocab=512)
WIDTHS = ("d_model", "n_heads", "n_kv_heads", "d_head", "d_ff", "vocab",
          "rwkv_head_dim", "norm_eps", "use_rope")


def layer_spec(conf, i):
    """→ [(path, shape, init)] of layer ``i``, ``path`` a tuple of keys
    inside the layer's dict."""
    d, ff = conf["d_model"], conf["d_ff"]
    K = conf["rwkv_head_dim"]
    H = d // K
    r_mix, r_decay = conf["lora_mix_rank"], conf["lora_decay_rank"]
    out = layer_norm("norm1", d) + layer_norm("norm2", d)
    out += [(("mixer", "mu_base"), (d,), affine(0.5, 0.1)),
            (("mixer", "mu_rkvwg"), (5, d), affine(0.5, 0.1)),
            (("mixer", "mix_A"), (d, 5 * r_mix), normal(d ** -0.5)),
            (("mixer", "mix_B"), (5, r_mix, d), normal(0.05))]
    out += [(("mixer", w), (d, d), normal(d ** -0.5))
            for w in ("w_r", "w_k", "w_v", "w_g", "w_o")]
    out += [(("mixer", "decay_base"), (d,), affine(-3.0, 1.0)),
            (("mixer", "decay_A"), (d, r_decay), normal(d ** -0.5)),
            (("mixer", "decay_B"), (r_decay, d), normal(r_decay ** -0.5)),
            (("mixer", "bonus_u"), (H, K), affine(0.0, 0.1)),
            (("mixer", "ln_scale"), (d,), affine(1.0, 0.1)),
            (("mixer", "ln_bias"), (d,), affine(0.0, 0.1))]
    out += [(("ffn", "mu_k"), (d,), affine(0.5, 0.1)),
            (("ffn", "mu_r"), (d,), affine(0.5, 0.1)),
            (("ffn", "w_k"), (d, ff), normal(d ** -0.5)),
            (("ffn", "w_v"), (ff, d), normal(ff ** -0.5)),
            (("ffn", "w_r"), (d, d), normal(d ** -0.5))]
    return out


top_groups = layer_norm_top


def _shift(h):
    """The previous token's row (zeros before the first)."""
    return torch.cat([h.new_zeros(1, h.shape[1]), h[:-1]])


def layer(conf, i, p, x, precision):
    """Block ``i`` (time-mix, channel-mix) on x (T, d)."""
    T, d = x.shape
    K = conf["rwkv_head_dim"]
    H = d // K
    eps = conf["norm_eps"]

    def r(t):
        return ops.rnd(t, precision)

    def mx(name):
        return ops.f32(p, "mixer", name)

    def lin(a, name, group="mixer"):
        return r(ops.linear(a, ops.f32(p, group, name), precision))
    h = r(ops.layer_norm(x, ops.f32(p, "norm1", "scale"),
                         ops.f32(p, "norm1", "bias"), eps))
    dx = r(_shift(h) - h)
    base = r(h + dx * mx("mu_base"))
    lora = r(torch.tanh(lin(base, "mix_A"))).reshape(T, 5, -1)
    mixes = r(mx("mu_rkvwg")[None] + torch.einsum("tfr,frd->tfd", lora,
                                                  mx("mix_B")))
    xr, xk, xv, xw, xg = (r(h + dx * mixes[:, j]) for j in range(5))
    rr = lin(xr, "w_r").reshape(T, H, K)
    k = lin(xk, "w_k").reshape(T, H, K)
    v = lin(xv, "w_v").reshape(T, H, K)
    g = lin(xg, "w_g")
    ww = mx("decay_base") + lin(r(torch.tanh(lin(xw, "decay_A"))),
                                "decay_B")
    logw = -torch.exp(ww).reshape(T, H, K)
    o = r(ops.wkv(rr, k, v, logw, mx("bonus_u")).reshape(T, d)).reshape(
        T, H, K)
    mu = o.mean(-1, keepdim=True)
    var = ((o - mu) ** 2).mean(-1, keepdim=True)
    o = r(((o - mu) / torch.sqrt(var + 1e-5)).reshape(T, d))
    o = r(o * mx("ln_scale") + mx("ln_bias"))
    x = r(x + lin(r(o * r(ops.silu(g))), "w_o"))
    h2 = r(ops.layer_norm(x, ops.f32(p, "norm2", "scale"),
                          ops.f32(p, "norm2", "bias"), eps))
    dx2 = r(_shift(h2) - h2)
    xk2 = r(h2 + dx2 * ops.f32(p, "ffn", "mu_k"))
    xr2 = r(h2 + dx2 * ops.f32(p, "ffn", "mu_r"))
    kh = r(torch.square(torch.relu(lin(xk2, "w_k", "ffn"))))
    return r(x + r(torch.sigmoid(lin(xr2, "w_r", "ffn"))
                   * lin(kh, "w_v", "ffn")))


def embed(conf, top, tokens, precision):
    """Token embeddings plus sinusoidal absolute positions (T, d)."""
    x = ops.rnd(ops.f32(top, "tok_embed")[tokens], precision)
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    return ops.rnd(x + ops.sinusoid(pos, conf["d_model"]), precision)


def head(conf, top, x, precision):
    return ops.layer_norm_head(top, x, conf["norm_eps"], precision)


def top_matmul_weights(conf):
    """Weights of the products outside the layers a token passes through:
    the head (the embedding is a lookup)."""
    return conf["d_model"] * conf["vocab"]


def layer_matmul_weights(conf, i):
    """Weights of layer ``i``'s products one token passes through: the
    time-mix's five projections and its two LoRAs, the channel-mix's
    three."""
    d, ff = conf["d_model"], conf["d_ff"]
    r_mix, r_decay = conf["lora_mix_rank"], conf["lora_decay_rank"]
    return 5 * d * d + d * 5 * r_mix + 5 * r_mix * d + 2 * d * r_decay \
        + 2 * d * ff + d * d


def layer_context_flops(conf, i, n_tokens, start):
    """Layer ``i``'s FLOPs beyond its products: the WKV recurrence's state
    term, the same at every position."""
    K = conf["rwkv_head_dim"]
    f, _ = wkv.forward(1, conf["d_model"] // K, n_tokens, K)
    return f


def check_port(conf, cfg):
    """The widths the file states against the port's ``cfg``, the LoRA
    ranks among them (module constants of the port)."""
    from repro_torch.models import recurrent
    harness.check_widths(conf, {
        **{k: getattr(cfg, k) for k in WIDTHS},
        "lora_mix_rank": recurrent.LORA_MIX,
        "lora_decay_rank": recurrent.LORA_DECAY,
        "mixer": "/".join(cfg.block_pattern), "ffn": cfg.ffn_kind,
        "norm": cfg.norm})
