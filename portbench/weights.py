"""Weights made by the benchmark from ``--seed``, in the port's parameter
layout, for the program and for the plain reference alike.

The layout is the one ``repro_torch.models.Model`` reads (``tok_embed``,
``layers``: one dict per layer, ``final_norm``, ``lm_head``; the leaf
names and shapes of ``models/attention.py``, ``models/recurrent.py`` and
``models/layers.py``). It is written out here, leaf by leaf, so that the
benchmark never calls the program to make its inputs.

Every group of leaves (the embedding, the head, the final norm, each
layer) is drawn in one ``torch.randn`` call on the device from a
generator seeded by ``(seed, group)``, so any one layer can be made again
alone: the reference makes each layer as it needs it, after the
program's state is freed. Two modes:

* ``serve``: the dtypes ``Model.compute_params`` gives a served model —
  product weights in the compute dtype (bf16), norm scales and biases and
  the recurrent fp32 leaves (``decay_base``, ``bonus_u``) in fp32;
* ``train``: every leaf in the parameter dtype (fp32), as
  ``Model.init`` gives a model to train.
"""
from __future__ import annotations

import math

import torch

#: leaf names that a served model keeps in fp32 (``Model.compute_params``
#: keeps the norm dicts' ``scale``/``bias`` and these recurrent leaves)
FP32_LEAVES = ("scale", "bias", "decay_base", "bonus_u")


def _normal(std):
    return ("affine", 0.0, std)


def _affine(mean, std):
    return ("affine", mean, std)


def _norm(d):
    return [("scale", (d,), _affine(1.0, 0.1)),
            ("bias", (d,), _affine(0.0, 0.1))]


def layer_spec(conf):
    """→ [(path, shape, init)] of one layer, ``path`` a tuple of keys
    inside the layer's dict."""
    d = conf["d_model"]
    out = [(("norm1",) + p[:1], p[1], p[2]) for p in _norm(d)]
    out += [(("norm2",) + p[:1], p[1], p[2]) for p in _norm(d)]
    if conf["mixer"] == "attn":
        H, Hkv, hd = conf["n_heads"], conf["n_kv_heads"], conf["d_head"]
        out += [(("mixer", "wq"), (d, H, hd), _normal(d ** -0.5)),
                (("mixer", "wk"), (d, Hkv, hd), _normal(d ** -0.5)),
                (("mixer", "wv"), (d, Hkv, hd), _normal(d ** -0.5)),
                (("mixer", "wo"), (H, hd, d), _normal((H * hd) ** -0.5))]
        if conf["qkv_bias"]:
            out += [(("mixer", "bq"), (H, hd), _affine(0.0, 0.1)),
                    (("mixer", "bk"), (Hkv, hd), _affine(0.0, 0.1)),
                    (("mixer", "bv"), (Hkv, hd), _affine(0.0, 0.1))]
    elif conf["mixer"] == "rwkv":
        K = conf["rwkv_head_dim"]
        H = d // K
        r_mix, r_decay = conf["lora_mix_rank"], conf["lora_decay_rank"]
        out += [(("mixer", "mu_base"), (d,), _affine(0.5, 0.1)),
                (("mixer", "mu_rkvwg"), (5, d), _affine(0.5, 0.1)),
                (("mixer", "mix_A"), (d, 5 * r_mix), _normal(d ** -0.5)),
                (("mixer", "mix_B"), (5, r_mix, d), _normal(0.05))]
        out += [(("mixer", w), (d, d), _normal(d ** -0.5))
                for w in ("w_r", "w_k", "w_v", "w_g", "w_o")]
        out += [(("mixer", "decay_base"), (d,), _affine(-3.0, 1.0)),
                (("mixer", "decay_A"), (d, r_decay), _normal(d ** -0.5)),
                (("mixer", "decay_B"), (r_decay, d),
                 _normal(r_decay ** -0.5)),
                (("mixer", "bonus_u"), (H, K), _affine(0.0, 0.1)),
                (("mixer", "ln_scale"), (d,), _affine(1.0, 0.1)),
                (("mixer", "ln_bias"), (d,), _affine(0.0, 0.1))]
    else:
        raise ValueError(f"mixer {conf['mixer']!r}")
    ff = conf["d_ff"]
    if conf["ffn"] == "gelu":
        out += [(("ffn", "w_up"), (d, ff), _normal(d ** -0.5)),
                (("ffn", "b_up"), (ff,), _affine(0.0, 0.1)),
                (("ffn", "w_down"), (ff, d), _normal(ff ** -0.5)),
                (("ffn", "b_down"), (d,), _affine(0.0, 0.1))]
    elif conf["ffn"] == "channelmix":
        out += [(("ffn", "mu_k"), (d,), _affine(0.5, 0.1)),
                (("ffn", "mu_r"), (d,), _affine(0.5, 0.1)),
                (("ffn", "w_k"), (d, ff), _normal(d ** -0.5)),
                (("ffn", "w_v"), (ff, d), _normal(ff ** -0.5)),
                (("ffn", "w_r"), (d, d), _normal(d ** -0.5))]
    else:
        raise ValueError(f"ffn {conf['ffn']!r}")
    return out


def top_groups(conf):
    """→ {group: [(path, shape, init)]} of the leaves outside the layers,
    ``path`` a tuple of keys from the tree's root."""
    d, V = conf["d_model"], conf["vocab"]
    return {"tok_embed": [(("tok_embed",), (V, d), _normal(1.0))],
            "final_norm": [(("final_norm",) + p[:1], p[1], p[2])
                           for p in _norm(d)],
            "lm_head": [(("lm_head",), (d, V), _normal(d ** -0.5))]}


def _dtype(path, mode):
    if mode == "train" or path[-1] in FP32_LEAVES:
        return torch.float32
    return torch.bfloat16


def _group_seed(seed: int, group: str) -> int:
    """A generator seed for one group of leaves: the run's seed and the
    group's name, folded into 63 bits."""
    h = 1469598103934665603
    for ch in f"{int(seed)}/{group}".encode():
        h = ((h ^ ch) * 1099511628211) % (1 << 63)
    return h


def make_group(spec, seed, group, device, mode):
    """The leaves of one group → {path: tensor}: one ``randn`` call per
    dtype on the device, each leaf a view of it, scaled in place."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_group_seed(seed, group))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        leaves = [s for s in spec if _dtype(s[0], mode) == dtype]
        if not leaves:
            continue
        n = sum(math.prod(shape) for _, shape, _ in leaves)
        flat = torch.randn(n, generator=gen, dtype=dtype, device=device)
        at = 0
        for path, shape, (_, mean, std) in leaves:
            size = math.prod(shape)
            leaf = flat[at:at + size].view(shape)
            leaf.mul_(std)
            if mean:
                leaf.add_(mean)
            out[path] = leaf
            at += size
    return out


def make_layer(conf, seed, i, device, mode):
    """Layer ``i``'s leaves → {path inside the layer: tensor}."""
    return make_group(layer_spec(conf), seed, f"layer{i}", device, mode)


def make_top(conf, seed, name, device, mode):
    return make_group(top_groups(conf)[name], seed, name, device, mode)


def nest(flat):
    """{path: tensor} → nested dicts."""
    out = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def make_tree(conf, seed, device, mode):
    """The whole parameter tree in the port's layout."""
    tree = {}
    for name in ("tok_embed", "final_norm", "lm_head"):
        tree.update(nest(make_top(conf, seed, name, device, mode)))
    tree["layers"] = [nest(make_layer(conf, seed, i, device, mode))
                      for i in range(conf["n_layers"])]
    return tree


def leaf_paths(conf):
    """Every leaf's path from the tree's root, in a fixed order."""
    paths = []
    for name, spec in top_groups(conf).items():
        paths += [p for p, _, _ in spec]
    for i in range(conf["n_layers"]):
        paths += [("layers", i) + p for p, _, _ in layer_spec(conf)]
    return paths


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
