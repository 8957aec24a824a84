"""The plain reference of the two architectures the cells run, in fp32.

* ``attn`` + ``gelu`` (StarCoder2, arXiv:2402.19173): pre-norm LayerNorm
  blocks; q/k/v projections with biases, rotary positions on q and k,
  grouped-query causal attention, an output projection; a GELU (tanh)
  MLP with biases; a final LayerNorm and an untied head.
* ``rwkv`` + ``channelmix`` (RWKV-6 "Finch", arXiv:2404.05892): the
  time-mix with the data-dependent token shift (a LoRA of rank
  ``lora_mix_rank`` over five mixes), the data-dependent decay (a LoRA of
  rank ``lora_decay_rank``; the ranks are the weights' shapes), the WKV
  recurrence with its bonus ``u``, a per-head LayerNorm and the SiLU
  gate; the channel-mix with its token shift, squared ReLU and sigmoid
  gate. Departures from the published model, as the repository defines
  it: sinusoidal absolute positions are added to the embeddings, and
  there is no LayerNorm right after the embedding.

Parameters come as ``{path: tensor}`` per layer in the port's layout
(``portbench.weights``) and are read in fp32. The forward runs layer by
layer over a list of sequences, so that a 40-layer model needs one
layer's weights at a time.
"""
from __future__ import annotations

import torch

from portbench.reference import ops


def _f(p, *path):
    return p[path].float()


def attn_layer(conf, p, x, precision):
    """One StarCoder2 block on x (T, d)."""
    T, d = x.shape
    H, Hkv, hd = conf["n_heads"], conf["n_kv_heads"], conf["d_head"]
    eps = conf["norm_eps"]
    pos = torch.arange(T, device=x.device)

    def r(t):
        return ops.rnd(t, precision)
    h = r(ops.layer_norm(x, _f(p, "norm1", "scale"), _f(p, "norm1", "bias"),
                         eps))

    def proj(name, bias, heads):
        w = _f(p, "mixer", name).reshape(d, heads * hd)
        y = r(ops.linear(h, w, precision)).reshape(T, heads, hd)
        return r(y + _f(p, "mixer", bias)) if ("mixer", bias) in p else y
    q = r(ops.rope(proj("wq", "bq", H), pos, conf["rope_theta"]))
    k = r(ops.rope(proj("wk", "bk", Hkv), pos, conf["rope_theta"]))
    v = proj("wv", "bv", Hkv)
    o = r(ops.causal_attention(q, k, v).reshape(T, H * hd))
    x = r(x + r(ops.linear(o, _f(p, "mixer", "wo").reshape(H * hd, d),
                           precision)))
    h2 = r(ops.layer_norm(x, _f(p, "norm2", "scale"),
                          _f(p, "norm2", "bias"), eps))
    u = r(ops.gelu_tanh(r(ops.linear(h2, _f(p, "ffn", "w_up"), precision))
                        + _f(p, "ffn", "b_up")))
    return r(x + r(ops.linear(u, _f(p, "ffn", "w_down"), precision)
                   + _f(p, "ffn", "b_down")))


def _shift(h):
    """The previous token's row (zeros before the first)."""
    return torch.cat([h.new_zeros(1, h.shape[1]), h[:-1]])


def rwkv_layer(conf, p, x, precision):
    """One RWKV-6 block (time-mix, channel-mix) on x (T, d)."""
    T, d = x.shape
    K = conf["rwkv_head_dim"]
    H = d // K
    eps = conf["norm_eps"]

    def r(t):
        return ops.rnd(t, precision)

    def mx(name):
        return _f(p, "mixer", name)

    def lin(a, name, group="mixer"):
        return r(ops.linear(a, _f(p, group, name), precision))
    h = r(ops.layer_norm(x, _f(p, "norm1", "scale"), _f(p, "norm1", "bias"),
                         eps))
    dx = r(_shift(h) - h)
    base = r(h + dx * mx("mu_base"))
    lora = r(torch.tanh(lin(base, "mix_A"))).reshape(T, 5, -1)
    mixes = r(mx("mu_rkvwg")[None] + torch.einsum("tfr,frd->tfd", lora,
                                                  mx("mix_B")))
    xr, xk, xv, xw, xg = (r(h + dx * mixes[:, i]) for i in range(5))
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
    h2 = r(ops.layer_norm(x, _f(p, "norm2", "scale"),
                          _f(p, "norm2", "bias"), eps))
    dx2 = r(_shift(h2) - h2)
    xk2 = r(h2 + dx2 * _f(p, "ffn", "mu_k"))
    xr2 = r(h2 + dx2 * _f(p, "ffn", "mu_r"))
    kh = r(torch.square(torch.relu(lin(xk2, "w_k", "ffn"))))
    return r(x + r(torch.sigmoid(lin(xr2, "w_r", "ffn"))
                   * lin(kh, "w_v", "ffn")))


LAYERS = {"attn": attn_layer, "rwkv": rwkv_layer}


def embed(conf, top, tokens, precision="fp32"):
    """Token embeddings (T, d), plus sinusoidal positions where the model
    has no rotary positions."""
    x = ops.rnd(top[("tok_embed",)].float()[tokens], precision)
    if not conf["use_rope"]:
        pos = torch.arange(tokens.shape[0], device=tokens.device)
        x = ops.rnd(x + ops.sinusoid(pos, conf["d_model"]), precision)
    return x


def head(conf, top, x, precision):
    h = ops.rnd(ops.layer_norm(x, top[("final_norm", "scale")].float(),
                               top[("final_norm", "bias")].float(),
                               conf["norm_eps"]), precision)
    return ops.rnd(ops.linear(h, top[("lm_head",)].float(), precision),
                   precision)


@torch.no_grad()
def logits_at(conf, make_layer, top, seqs, rows, precision="fp32"):
    """Logits (len(rows[i]), V) of each sequence ``seqs[i]`` (a 1-D
    LongTensor) at its positions ``rows[i]``, layer by layer:
    ``make_layer(i)`` gives layer i's ``{path: tensor}``."""
    layer = LAYERS[conf["mixer"]]
    xs = [embed(conf, top, s, precision) for s in seqs]
    for i in range(conf["n_layers"]):
        p = make_layer(i)
        xs = [layer(conf, p, x, precision) for x in xs]
        del p
    return [head(conf, top, x[r], precision) for x, r in zip(xs, rows)]


def loss(conf, params, batch, precision="fp32"):
    """Mean next-token cross-entropy over the masked tokens of a batch
    {tokens, labels, mask} (B, S), each row through every layer, a layer
    recomputed in the backward (``torch.utils.checkpoint``).
    ``params`` is ``{path from the root: tensor}``."""
    from torch.utils.checkpoint import checkpoint
    layer = LAYERS[conf["mixer"]]
    top = {p: t for p, t in params.items() if p[0] != "layers"}
    per = [{p[2:]: t for p, t in params.items()
            if p[0] == "layers" and p[1] == i}
           for i in range(conf["n_layers"])]
    num = 0.0
    den = batch["mask"].float().sum().clamp_min(1.0)
    for b in range(batch["tokens"].shape[0]):
        x = embed(conf, top, batch["tokens"][b].long(), precision)
        for p in per:
            x = checkpoint(layer, conf, p, x, precision, use_reentrant=False)
        lg = head(conf, top, x, precision)
        nll = torch.logsumexp(lg, -1) - lg.gather(
            -1, batch["labels"][b].long()[:, None])[:, 0]
        num = num + (nll * batch["mask"][b].float()).sum()
    return num / den


def served_gaps(conf, make_layer, top, requests, precision="fp32",
                own_argmax=False):
    """For each served request (prompt, tokens): the gap, at every served
    position, between the reference's best logit and its logit of the
    served token (with ``own_argmax``: of the token this precision puts
    first instead, the control's reading). → list of 1-D tensors."""
    seqs, rows = [], []
    for prompt, toks in requests:
        full = list(prompt) + list(toks[:-1])
        seqs.append(torch.tensor(full, dtype=torch.long))
        rows.append(torch.arange(len(prompt) - 1, len(full)))
    dev = top[("lm_head",)].device
    seqs = [s.to(dev) for s in seqs]
    rows = [r.to(dev) for r in rows]
    if not own_argmax:
        ref = logits_at(conf, make_layer, top, seqs, rows, "fp32")
        picked = [torch.tensor(t, dtype=torch.long, device=dev)
                  for _, t in requests]
    else:
        ref = logits_at(conf, make_layer, top, seqs, rows, "fp32")
        low = logits_at(conf, make_layer, top, seqs, rows, precision)
        picked = [lg.argmax(-1) for lg in low]
    V = conf["vocab"]
    return [lg[:, :V].amax(-1) - lg[:, :V].gather(-1, t[:, None])[:, 0]
            for lg, t in zip(ref, picked)]

