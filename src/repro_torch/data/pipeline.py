"""Deterministic synthetic data pipeline — the port's own copy of
``repro.data.pipeline`` (numpy only, so the batches are the reference's
bit for bit; the training step moves them to the device).

Production-shaped: per-(seed, step, host) deterministic batches via
counter-based Philox bit generators (restart-safe — a restored run at step k
sees exactly the batch it would have seen), host-sharded slicing for
multi-host launches, and a background prefetch thread that overlaps batch
synthesis with device compute (the host-side analogue of the paper's DMA
pipelining).

Synthetic stream: a per-batch random linear-congruential token walk — cheap,
but gives a learnable structure so loss decreases in the examples (pure
uniform tokens would pin loss at ln V).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    family: str = "dense"
    n_frontend_tokens: int = 0      # vlm image tokens / whisper frames
    frontend_dim: int = 0


class SyntheticTokenPipeline:
    def __init__(self, dc: DataConfig, host_id: int = 0, n_hosts: int = 1):
        assert dc.global_batch % n_hosts == 0
        self.dc = dc
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.host_batch = dc.global_batch // n_hosts

    # ------------------------------------------------------------------
    def batch(self, step: int) -> dict:
        dc = self.dc
        # counter-based bit generator: 2×64-bit key = (seed⊕host, step)
        rng = np.random.Generator(np.random.Philox(
            key=np.array([np.uint64(dc.seed) ^ (np.uint64(self.host_id) << 32),
                          np.uint64(step)], dtype=np.uint64)))
        B, S = self.host_batch, dc.seq_len
        n_f = dc.n_frontend_tokens
        s_text = S - n_f if dc.family == "vlm" else S

        # learnable token walk: a GLOBAL affine bigram x_{t+1}=(13·x_t+7)%V
        # with 2% noise — a model learns the static mapping quickly (the
        # examples' loss curves mean something), while batches stay
        # deterministic per (seed, step, host)
        x0 = rng.integers(0, dc.vocab, size=(B,), dtype=np.int64)
        toks = np.empty((B, s_text + 1), dtype=np.int64)
        toks[:, 0] = x0
        for t in range(s_text):
            nxt = (13 * toks[:, t] + 7) % dc.vocab
            flip = rng.random(B) < 0.02
            rand = rng.integers(0, dc.vocab, size=(B,), dtype=np.int64)
            toks[:, t + 1] = np.where(flip, rand, nxt)
        tokens = toks[:, :-1].astype(np.int32)
        labels_text = toks[:, 1:].astype(np.int32)

        out = {"tokens": tokens}
        if dc.family == "vlm":
            out["patches"] = rng.standard_normal(
                (B, n_f, dc.frontend_dim), dtype=np.float32) * 0.1
            out["labels"] = np.concatenate(
                [np.zeros((B, n_f), np.int32), labels_text], axis=1)
            out["mask"] = np.concatenate(
                [np.zeros((B, n_f), np.float32),
                 np.ones((B, s_text), np.float32)], axis=1)
        else:
            if dc.family == "audio":
                out["frames"] = rng.standard_normal(
                    (B, n_f, dc.frontend_dim), dtype=np.float32) * 0.1
            out["labels"] = labels_text
            out["mask"] = np.ones((B, s_text), np.float32)
        return out

    # ------------------------------------------------------------------
    def prefetch(self, start_step: int = 0, depth: int = 2):
        """Background-thread prefetch iterator."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch(step), timeout=0.2)
                    step += 1
                except queue.Full:
                    continue

        th = threading.Thread(target=worker, daemon=True)
        th.start()

        class _Iter:
            def __iter__(self):
                return self

            def __next__(self):
                return q.get()

            def close(self):
                stop.set()

        return _Iter()


def pipeline_for(cfg, cell, seed=0, host_id=0, n_hosts=1):
    """Build the pipeline matching a (ModelConfig, ShapeCell)."""
    n_f, fd = 0, 0
    if cfg.frontend is not None:
        n_f, fd = cfg.frontend.n_tokens, cfg.frontend.d_in
    dc = DataConfig(vocab=cfg.vocab, seq_len=cell.seq_len,
                    global_batch=cell.global_batch, seed=seed,
                    family=cfg.family, n_frontend_tokens=n_f,
                    frontend_dim=fd)
    return SyntheticTokenPipeline(dc, host_id=host_id, n_hosts=n_hosts)
