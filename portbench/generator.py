"""The one traffic generator: it reads a traffic mix's parameters
(``portbench/traffic/<mix>.json``) and the run's seed.

Every seed gets the same work in another order: lengths and gaps are the
quantiles of their distributions at evenly spaced probabilities,
permuted by the seed, and token ids are drawn from the seed. So runs on
different seeds spread no more than runs on one seed, and no operation
depends on a rare draw.

* ``open`` (serving): ``rate_per_s`` × the window's seconds requests,
  their gaps exponential (a Poisson process), due at fixed offsets from
  the window's start;
* ``closed`` (serving): ``clients`` clients, each sending its next
  request as soon as its last one finishes, from a pool of ``pool``
  requests that the clients take in turn (permuted in blocks of
  ``pool_block``, where the mix gives it);
* ``train``: rows of ``seq_len`` tokens packed from documents of
  log-normal length, an end-of-document token between them.
"""
from __future__ import annotations

import numpy as np


def _quantiles(n):
    return (np.arange(n) + 0.5) / n


def log_uniform(lo, hi, n):
    """n lengths at the evenly spaced quantiles of a log-uniform
    distribution over [lo, hi], rounded."""
    return np.rint(lo * (hi / lo) ** _quantiles(n)).astype(np.int64)


def _perm(rng, a):
    return a[rng.permutation(len(a))]


def request_tokens(seed, index, length, vocab):
    """Prompt ids of request ``index``, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 7, int(index)])
    return rng.integers(0, vocab, size=int(length), dtype=np.int64)


def open_arrivals(mix, seed, seconds):
    """→ list of (due offset s, prompt length, output tokens) of the
    requests due in a window of ``seconds``."""
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    rng = np.random.default_rng([int(seed), 1])
    gaps = _perm(rng, -np.log1p(-_quantiles(n)))
    due = np.cumsum(gaps)
    due = due / due[-1] * seconds * (n - 0.5) / n
    plen = _perm(rng, log_uniform(*mix["prompt_tokens"], n))
    out = _perm(rng, log_uniform(*mix["output_tokens"], n))
    return [(float(t), int(p), int(o)) for t, p, o in zip(due, plen, out)]


def closed_pool(mix, seed):
    """→ list of (prompt length, output tokens) that the clients take in
    turn (client c its requests c, c + clients, ...). With
    ``pool_block``, each block of that many requests holds the same
    quantiles in another order, so that the requests a window reaches
    have nearly the same sizes on every seed; without it, the pool is one
    block."""
    n = int(mix["pool"])
    block = int(mix.get("pool_block", n))
    rng = np.random.default_rng([int(seed), 2])

    def blocks(lo_hi):
        q = log_uniform(*lo_hi, block)
        return np.concatenate([_perm(rng, q) for _ in range(n // block)])
    plen = blocks(mix["prompt_tokens"])
    out = blocks(mix["output_tokens"])
    return [(int(p), int(o)) for p, o in zip(plen, out)]


def train_batch(mix, seed, step, vocab):
    """Step ``step``'s batch → numpy {tokens, labels, mask} (B, S): each
    row packs documents of log-normal length (the evenly spaced quantiles
    of ``doc_tokens``' log-normal, permuted per step), each followed by
    ``eos``; the token after an end of document is not predicted (mask
    0), every other position is."""
    B, S = mix["batch"], mix["seq_len"]
    eos = mix["eos"]
    mu, sigma = mix["doc_tokens"]["log_mean"], mix["doc_tokens"]["log_sigma"]
    rng = np.random.default_rng([int(seed), 3, int(step)])
    from statistics import NormalDist
    z = np.array([NormalDist().inv_cdf(q) for q in _quantiles(64)])
    lengths = np.maximum(1, np.rint(np.exp(mu + sigma * z))).astype(int)
    rows = np.empty((B, S + 1), np.int64)
    for b in range(B):
        ids = rng.integers(1, vocab, size=S + 1)
        at = 0
        for n in _perm(rng, lengths):
            at += int(n)
            if at >= S + 1:
                break
            ids[at] = eos
            at += 1
        rows[b] = ids
    tokens, labels = rows[:, :-1], rows[:, 1:]
    mask = (tokens != eos).astype(np.float32)
    return {"tokens": tokens.astype(np.int32),
            "labels": labels.astype(np.int32), "mask": mask}
