"""Public model API — the PyTorch counterpart of ``repro.models.model``
for decoders whose layers mix attention, sliding-window attention,
RG-LRU and RWKV-6 (``qwen1.5-0.5b``, ``recurrentgemma-2b``,
``rwkv6-7b``).

Parameters are a plain dict of tensors (``tok_embed``, ``lm_head``,
``final_norm``, ``layers``: one dict per layer) in the reference's
weight layouts, made by :meth:`Model.init` from a ``torch.Generator`` or
carried over from JAX by :mod:`repro_torch.bridge`. Serving entry
points update the paged state (K/V pools and per-slot recurrent rows)
**in place** and also return it, so call sites read like the
reference's functional ones. A stack without rope (rwkv6) adds
sinusoidal absolute positions to the embeddings, as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ops import sample_tokens_op
from repro_torch.models import lm
from repro_torch.models.layers import (abs_position_vector, add_abs_positions,
                                       apply_norm, dense_init, dt,
                                       embed_init, init_norm)
from repro_torch.models.recurrent import FP32_PARAMS

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
        if cfg.is_encdec or cfg.family == "vlm" or cfg.logit_softcap \
                or cfg.tie_embeddings:
            raise NotImplementedError(
                f"{cfg.name}: only decoder-only stacks are ported so far")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.specs = lm.layer_specs(cfg)
        self.attn_only = all(s.is_attn for s in self.specs)
        if not cfg.use_rope and any(s.is_attn for s in self.specs):
            raise NotImplementedError(
                f"{cfg.name}: attention with absolute positions is not "
                "ported yet")

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
            "layers": [lm.init_layer(cfg, generator, spec, dev)
                       for spec in self.specs],
            "final_norm": init_norm(cfg, dev),
            "lm_head": dense_init(generator, cfg.d_model, cfg.padded_vocab,
                                  pd, dev, scale=0.02),
        }
        return params

    def compute_params(self, params):
        """Copy of ``params`` with every product weight cast once to the
        compute dtype — the same numbers as the reference's per-call
        ``.astype(compute_dtype)``. Norm scales and biases and the leaves
        the reference reads in fp32 (the recurrent gates, decays and
        bonus) keep their dtype."""
        cd = dt(self.cfg.compute_dtype)
        keep = ("scale", "bias") + FP32_PARAMS

        def cast(tree):
            if isinstance(tree, dict):
                return {k: (v if k in keep else cast(v))
                        for k, v in tree.items()}
            if isinstance(tree, list):
                return [cast(v) for v in tree]
            return tree.to(cd)
        return cast(params)

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------
    def _embed_tokens(self, params, tokens, positions=None):
        """Token embeddings in the compute dtype; without rope, plus the
        sinusoidal vectors of ``positions`` ((S,) for a chunk, (B, 1) for
        a decode step; None → 0..S-1, the reference's numpy table)."""
        x = params["tok_embed"][tokens].to(dt(self.cfg.compute_dtype))
        if self.cfg.use_rope:
            return x
        if positions is None:
            return add_abs_positions(x)
        return x + abs_position_vector(positions, self.cfg.d_model).to(
            x.dtype)

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
    def prefill(self, params, batch, capacity=None):
        """batch {"tokens": (B, S)} → (logits (B, V*), caches): ``"k"``,
        ``"v"`` (La, B, C, Hkv, hd) over the attention layers — C = S with
        no ``capacity``, else ring caches of ``capacity`` slots (position
        p at slot p % C) — and, for recurrent layers, ``"rows"`` (one dict
        of batch rows per layer; see ``lm``)."""
        tokens = batch["tokens"]
        x = self._embed_tokens(params, tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x, caches = lm.apply_stack_full(self.cfg, self.specs,
                                        params["layers"], x, positions,
                                        capacity or 0)
        return self._lm_logits(params, x[:, -1:])[:, 0], caches

    # ------------------------------------------------------------------
    # Decode: one token against contiguous ring caches
    # ------------------------------------------------------------------
    def decode(self, params, caches, token, pos):
        """token (B,1) int; pos the shared position (int or 0-d int32
        tensor on the caches' device) → (logits (B, V*), caches), the
        caches updated in place at slot ``pos % C``. Attention-only
        stacks (the recurrent families' ring decode is not ported yet)."""
        self._require_attn_only("decode on ring caches")
        x = self._embed_tokens(params, token)
        x = lm.apply_stack_decode_ring(self.cfg, params["layers"], x,
                                       caches, pos)
        return self._lm_logits(params, x[:, -1:])[:, 0], caches

    def init_cache(self, batch_size, capacity):
        """Zeroed ring caches {"k","v"}: (L, B, C, Hkv, hd)."""
        self._require_attn_only("ring caches")
        return lm.init_stack_cache(self.cfg, self.specs, batch_size,
                                   capacity, self.device)

    def input_specs(self, cell):
        """→ batch dict of meta tensors (shape and dtype, no data) for a
        ``ShapeCell`` — the stand-in for the reference's
        ``ShapeDtypeStruct``s."""
        B, S = cell.global_batch, cell.seq_len

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")
        if cell.kind == "decode":
            return {"token": meta((B, 1), torch.int32)}
        batch = {"tokens": meta((B, S), torch.int32)}
        if cell.kind == "train":
            batch["labels"] = meta((B, S), torch.int32)
            batch["mask"] = meta((B, S), torch.float32)
        return batch

    # ------------------------------------------------------------------
    # Paged serving path (MMU-backed KV pages; see serving/paged_kv.py)
    # ------------------------------------------------------------------
    def _require_attn_only(self, what):
        if not self.attn_only:
            raise NotImplementedError(
                f"{self.cfg.name}: {what} for recurrent layers is not "
                "ported yet")

    def init_paged_state(self, batch_size, num_pages, page_size):
        """Serving state: K/V page pools (La, P, ps, Hkv, hd) over the
        attn/swa layers, per-slot rows of ``batch_size`` slots for every
        recurrent leaf."""
        return lm.init_paged_state(self.cfg, self.specs, batch_size,
                                   num_pages, page_size, self.device)

    def write_prefill_paged(self, state, caches, slot, block_row, length,
                            page_size):
        """Scatter a batch=1 prefill cache into slot ``slot``'s leased
        pages and rows (in place; no other slot touched)."""
        return lm.write_prefill_to_state(state, caches, slot, block_row,
                                         length, page_size)

    def decode_paged(self, params, state, token, positions, block_tables):
        """token (B,1) int; positions (B,) int32 per-slot write positions
        (-1 = dead slot); block_tables (B, nb) int32 → (logits (B, V*),
        state)."""
        x = self._embed_tokens(params, token, positions.clamp_min(0)[:, None])
        x = lm.apply_stack_decode(self.cfg, self.specs, params["layers"], x,
                                  state, positions, block_tables)
        return self._lm_logits(params, x[:, -1:])[:, 0], state

    def prefill_chunk_paged(self, params, state, tokens, slot, block_row,
                            start):
        """One slot's prompt chunk: tokens (1, L); slot its batch row;
        block_row (nb,) the slot's block table; start the absolute
        position of tokens[0] → (logits (1, V*) of the chunk's last
        token, state)."""
        positions = start + torch.arange(tokens.shape[1],
                                         device=tokens.device)
        x = self._embed_tokens(params, tokens, positions)
        x = lm.apply_stack_chunk(self.cfg, self.specs, params["layers"], x,
                                 state, positions, block_row, int(slot))
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
        """Device bytes one KV page spans across all attn/swa layers — the
        MMU lease granularity for the paged cache (one layer's worth for
        an attention-free stack, as in the reference)."""
        cfg = self.cfg
        itemsize = torch.empty((), dtype=dt(cfg.compute_dtype)).element_size()
        n_attn = sum(s.is_attn for s in self.specs)
        per_layer = 2 * page_size * cfg.n_kv_heads * cfg.d_head * itemsize
        return max(1, n_attn) * per_layer

    # ------------------------------------------------------------------
    # Paged recurrent state (per-slot rows; see serving/paged_state.py)
    # ------------------------------------------------------------------
    def read_state_row(self, state, slot):
        """Slot ``slot``'s rows → flat leaf list in the reference's order
        (the recurrent-state swap tier's device→host read)."""
        return lm.gather_state_row(self.cfg, self.specs, state, slot)

    def write_state_row(self, state, slot, leaves):
        """Write a :meth:`read_state_row` leaf list back into slot
        ``slot``'s rows, in place (the refault write)."""
        return lm.scatter_state_row(self.cfg, self.specs, state, slot,
                                    leaves)

    def reset_state_row(self, state, slot):
        """Zero slot ``slot``'s rows in place — admission into a recycled
        slot must not read the previous occupant's recurrent state."""
        return lm.reset_state_row(self.cfg, self.specs, state, slot)

    def state_row_bytes(self) -> int:
        """Device bytes one slot's rows span across all layers — the MMU
        lease granularity for paged recurrent state; 0 for attention-only
        stacks."""
        st = lm.init_paged_state(self.cfg, self.specs, 1, 1, 1, "meta")
        return sum(leaf.numel() * leaf.element_size() for leaf in
                   lm.gather_state_row(self.cfg, self.specs, st, 0))

