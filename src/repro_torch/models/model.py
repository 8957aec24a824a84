"""Public model API — the PyTorch counterpart of ``repro.models.model``
for dense attention + swiglu decoders (``qwen1.5-0.5b``).

Parameters are a plain dict of tensors (``tok_embed``, ``lm_head``,
``final_norm``, ``layers``: one dict per layer) in the reference's
weight layouts, made by :meth:`Model.init` from a ``torch.Generator`` or
carried over from JAX by :mod:`repro_torch.bridge`. Serving entry
points update the paged state **in place** and also return it, so call
sites read like the reference's functional ones.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ops import sample_tokens_op
from repro_torch.models import lm
from repro_torch.models.attention import init_attn
from repro_torch.models.layers import (apply_norm, dense_init, dt,
                                       embed_init, init_ffn, init_norm)

#: seed of the fused step's Gumbel draws, combined with the step number
#: (the reference folds the step into ``PRNGKey(0x5e)``)
SAMPLE_SEED = 0x5e


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raise when there is none rather than
    run on the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the plain PyTorch versions on the CPU")
        device = "cuda"
    return torch.device(device)


class Model:
    """Init/apply facade for one architecture on one device."""

    def __init__(self, cfg, device=None):
        if cfg.is_encdec or cfg.family == "vlm" or not cfg.use_rope \
                or cfg.logit_softcap or cfg.tie_embeddings:
            raise NotImplementedError(
                f"{cfg.name}: only dense rope decoders are ported so far")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.specs = lm.layer_specs(cfg)

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator):
        """Random parameters with the reference's shapes and scales
        (``generator`` must live on ``self.device``)."""
        cfg, dev, pd = self.cfg, self.device, self.cfg.param_dtype
        params = {
            "tok_embed": embed_init(generator, cfg.padded_vocab, cfg.d_model,
                                    pd, dev),
            "layers": [{"norm1": init_norm(cfg, dev),
                        "norm2": init_norm(cfg, dev),
                        "mixer": init_attn(cfg, generator, dev),
                        "ffn": init_ffn(cfg, generator, dev)}
                       for _ in self.specs],
            "final_norm": init_norm(cfg, dev),
            "lm_head": dense_init(generator, cfg.d_model, cfg.padded_vocab,
                                  pd, dev, scale=0.02),
        }
        return params

    def compute_params(self, params):
        """Copy of ``params`` with every product weight cast once to the
        compute dtype (norm scales stay in fp32) — the same numbers as the
        reference's per-call ``.astype(compute_dtype)``."""
        cd = dt(self.cfg.compute_dtype)

        def cast(tree):
            if isinstance(tree, dict):
                return {k: (v if k == "scale" else cast(v))
                        for k, v in tree.items()}
            if isinstance(tree, list):
                return [cast(v) for v in tree]
            return tree.to(cd)
        return cast(params)

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------
    def _embed_tokens(self, params, tokens):
        return params["tok_embed"][tokens].to(dt(self.cfg.compute_dtype))

    def _lm_logits(self, params, x):
        cfg = self.cfg
        cd = dt(cfg.compute_dtype)
        x = apply_norm(cfg, params["final_norm"], x)
        logits = x.to(cd) @ params["lm_head"].to(cd)
        if cfg.padded_vocab != cfg.vocab:      # mask padded vocab columns
            pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
            zero = torch.zeros((), dtype=logits.dtype, device=x.device)
            logits = logits + torch.where(pad, torch.full_like(zero, -1e30),
                                          zero)
        return logits

    # ------------------------------------------------------------------
    # Prefill → (last-token logits, K/V caches)
    # ------------------------------------------------------------------
    def prefill(self, params, batch):
        """batch {"tokens": (B, S)} → (logits (B, V*), caches {"k","v"}
        (L, B, S, Hkv, hd))."""
        tokens = batch["tokens"]
        x = self._embed_tokens(params, tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x, caches = lm.apply_stack_full(self.cfg, params["layers"], x,
                                        positions)
        return self._lm_logits(params, x[:, -1:])[:, 0], caches

    # ------------------------------------------------------------------
    # Paged serving path (MMU-backed KV pages; see serving/paged_kv.py)
    # ------------------------------------------------------------------
    def init_paged_state(self, num_pages, page_size):
        return lm.init_paged_state(self.cfg, self.specs, num_pages,
                                   page_size, self.device)

    def write_prefill_paged(self, state, caches, block_row, length,
                            page_size):
        """Scatter a batch=1 prefill cache into one slot's leased pages
        (in place; no other slot touched)."""
        return lm.write_prefill_to_state(state, caches, block_row, length,
                                         page_size)

    def decode_paged(self, params, state, token, positions, block_tables):
        """token (B,1) int; positions (B,) int32 per-slot write positions
        (-1 = dead slot); block_tables (B, nb) int32 → (logits (B, V*),
        state)."""
        x = self._embed_tokens(params, token)
        x = lm.apply_stack_decode(self.cfg, params["layers"], x, state,
                                  positions, block_tables)
        return self._lm_logits(params, x[:, -1:])[:, 0], state

    def prefill_chunk_paged(self, params, state, tokens, block_row, start):
        """One slot's prompt chunk: tokens (1, L); block_row (nb,) the
        slot's block table; start the absolute position of tokens[0] →
        (logits (1, V*) of the chunk's last token, state)."""
        x = self._embed_tokens(params, tokens)
        positions = start + torch.arange(tokens.shape[1],
                                         device=tokens.device)
        x = lm.apply_stack_chunk(self.cfg, params["layers"], x, state,
                                 positions, block_row)
        return self._lm_logits(params, x[:, -1:])[:, 0], state

    def gumbel_noise(self, shape, step):
        """Gumbel(0, 1) draws from a generator seeded by (SAMPLE_SEED,
        step) on the model's device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(SAMPLE_SEED * 1_000_003 + int(step))
        u = torch.rand(shape, generator=gen, device=self.device)
        return -torch.log(-torch.log(u.clamp_min(1e-20)))

    def decode_paged_fused(self, params, state, token, positions,
                           block_tables, temps, step, noise=None):
        """Fused decode step: paged attention + on-device sampling — only
        (B,) token ids leave the device. temps (B,) fp32 (0 = greedy);
        ``noise`` (B, V*) overrides the step's Gumbel draws (tests inject
        the reference's). → (tokens (B,) int32, state)."""
        logits, state = self.decode_paged(params, state, token, positions,
                                          block_tables)
        if noise is None:
            noise = self.gumbel_noise(logits.shape, step)
        return sample_tokens_op(logits, temps, noise), state

    def kv_page_bytes(self, page_size) -> int:
        """Device bytes one KV page spans across all layers — the MMU
        lease granularity for the paged cache."""
        cfg = self.cfg
        itemsize = torch.empty((), dtype=dt(cfg.compute_dtype)).element_size()
        per_layer = 2 * page_size * cfg.n_kv_heads * cfg.d_head * itemsize
        return max(1, len(self.specs)) * per_layer

