"""Weights made by the benchmark from ``--seed``, in the port's parameter
layout, for the program and for the plain reference alike.

The layout is the one ``repro_torch.models.Model`` reads (``tok_embed``,
``layers``: one dict per layer, ``final_norm``, ``lm_head``). Each
architecture family writes out its leaves' names, shapes and draws in
``portbench/archs/<family>.py`` (``layer_spec(conf, i)``,
``top_groups(conf)``), so that the benchmark never calls the program to
make its inputs; this module draws them.

Every group of leaves (each group of ``top_groups``, each layer) is drawn
in one ``torch.randn`` call a dtype on the device from a generator seeded
by ``(seed, group)``, so any one layer can be made again alone: the
reference makes each layer as it needs it, after the program's state is
freed. Two modes:

* ``serve``: the dtypes ``Model.compute_params`` gives a served model —
  product weights in the compute dtype (bf16), the family's
  ``FP32_LEAVES`` (norm scales and biases, recurrent leaves) in fp32;
* ``train``: every leaf in the parameter dtype (fp32), as
  ``Model.init`` gives a model to train.
"""
from __future__ import annotations

import math

import torch


def normal(std):
    """A leaf drawn from N(0, std²)."""
    return ("affine", 0.0, std)


def affine(mean, std):
    """A leaf drawn from N(mean, std²)."""
    return ("affine", mean, std)


def layer_norm(name, d):
    """A LayerNorm's leaves under ``name``: its scale and bias."""
    return [((name, "scale"), (d,), affine(1.0, 0.1)),
            ((name, "bias"), (d,), affine(0.0, 0.1))]


def layer_norm_top(conf):
    """The groups outside the layers of a model with a token embedding,
    a final LayerNorm and an untied head."""
    d, V = conf["d_model"], conf["vocab"]
    return {"tok_embed": [(("tok_embed",), (V, d), normal(1.0))],
            "final_norm": layer_norm("final_norm", d),
            "lm_head": [(("lm_head",), (d, V), normal(d ** -0.5))]}


def _dtype(path, mode, fp32):
    if mode == "train" or path[-1] in fp32:
        return torch.float32
    return torch.bfloat16


def _group_seed(seed: int, group: str) -> int:
    """A generator seed for one group of leaves: the run's seed and the
    group's name, folded into 63 bits."""
    h = 1469598103934665603
    for ch in f"{int(seed)}/{group}".encode():
        h = ((h ^ ch) * 1099511628211) % (1 << 63)
    return h


def make_group(spec, seed, group, device, mode, fp32):
    """The leaves of one group → {path: tensor}: one ``randn`` call per
    dtype on the device, each leaf a view of it, scaled in place;
    ``fp32`` names the leaves a served model keeps in fp32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_group_seed(seed, group))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        leaves = [s for s in spec
                  if _dtype(s[0], mode, fp32) == dtype]
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


def make_layer(arch, conf, seed, i, device, mode):
    """Layer ``i``'s leaves → {path inside the layer: tensor}."""
    return make_group(arch.layer_spec(conf, i), seed, f"layer{i}", device,
                      mode, arch.FP32_LEAVES)


def make_top(arch, conf, seed, name, device, mode):
    return make_group(arch.top_groups(conf)[name], seed, name, device, mode,
                      arch.FP32_LEAVES)


def nest(flat):
    """{path: tensor} → nested dicts."""
    out = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def make_tree(arch, conf, seed, device, mode):
    """The whole parameter tree in the port's layout."""
    tree = {}
    for name in arch.top_groups(conf):
        tree.update(nest(make_top(arch, conf, seed, name, device, mode)))
    tree["layers"] = [nest(make_layer(arch, conf, seed, i, device, mode))
                      for i in range(conf["n_layers"])]
    return tree


def leaf_paths(arch, conf):
    """Every leaf's path from the tree's root, in a fixed order."""
    paths = []
    for spec in arch.top_groups(conf).values():
        paths += [p for p, _, _ in spec]
    for i in range(conf["n_layers"]):
        paths += [("layers", i) + p for p, _, _ in arch.layer_spec(conf, i)]
    return paths


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
