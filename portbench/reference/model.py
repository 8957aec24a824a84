"""The plain reference of a configuration, in fp32, layer by layer.

The layers themselves are the architecture family's
(``portbench/archs/<family>.py``: ``embed``, ``layer(conf, i, ...)``,
``head``, written from the published descriptions out of the pieces in
``reference/ops.py``); this module runs them. Parameters come as
``{path: tensor}`` per layer in the port's layout (``portbench.weights``)
and are read in fp32. The forward runs layer by layer over a list of
sequences, so that a 40-layer model needs one layer's weights at a time.
"""
from __future__ import annotations

import torch


@torch.no_grad()
def logits_at(arch, conf, make_layer, top, seqs, rows, precision="fp32"):
    """Logits (len(rows[i]), V) of each sequence ``seqs[i]`` (a 1-D
    LongTensor) at its positions ``rows[i]``, layer by layer:
    ``make_layer(i)`` gives layer i's ``{path: tensor}``."""
    xs = [arch.embed(conf, top, s, precision) for s in seqs]
    for i in range(conf["n_layers"]):
        p = make_layer(i)
        xs = [arch.layer(conf, i, p, x, precision) for x in xs]
        del p
    return [arch.head(conf, top, x[r], precision) for x, r in zip(xs, rows)]


def loss(arch, conf, params, batch, precision="fp32"):
    """Mean next-token cross-entropy over the masked tokens of a batch
    {tokens, labels, mask} (B, S), each row through every layer, a layer
    recomputed in the backward (``torch.utils.checkpoint``).
    ``params`` is ``{path from the root: tensor}``."""
    from torch.utils.checkpoint import checkpoint
    top = {p: t for p, t in params.items() if p[0] != "layers"}
    per = [{p[2:]: t for p, t in params.items()
            if p[0] == "layers" and p[1] == i}
           for i in range(conf["n_layers"])]
    num = 0.0
    den = batch["mask"].float().sum().clamp_min(1.0)
    for b in range(batch["tokens"].shape[0]):
        x = arch.embed(conf, top, batch["tokens"][b].long(), precision)
        for i, p in enumerate(per):
            x = checkpoint(arch.layer, conf, i, p, x, precision,
                           use_reentrant=False)
        lg = arch.head(conf, top, x, precision)
        nll = torch.logsumexp(lg, -1) - lg.gather(
            -1, batch["labels"][b].long()[:, None])[:, 0]
        num = num + (nll * batch["mask"][b].float()).sum()
    return num / den


def served_gaps(arch, conf, make_layer, top, requests, precision="fp32",
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
        ref = logits_at(arch, conf, make_layer, top, seqs, rows, "fp32")
        picked = [torch.tensor(t, dtype=torch.long, device=dev)
                  for _, t in requests]
    else:
        ref = logits_at(arch, conf, make_layer, top, seqs, rows, "fp32")
        low = logits_at(arch, conf, make_layer, top, seqs, rows, precision)
        picked = [lg.argmax(-1) for lg in low]
    V = conf["vocab"]
    return [lg[:, :V].amax(-1) - lg[:, :V].gather(-1, t[:, None])[:, 0]
            for lg, t in zip(ref, picked)]

