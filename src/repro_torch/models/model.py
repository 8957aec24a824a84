"""Public model API — the PyTorch counterpart of ``repro.models.model``
for every family of the repo: decoders whose layers mix attention,
sliding-window attention, RG-LRU and RWKV-6 with swiglu, GELU, MoE or
channel-mix FFNs, the VLM (projected image patches before the text) and
the encoder-decoder (whisper: cross attention to the encoded frames).

Parameters are a plain dict of tensors (``tok_embed``, ``lm_head``,
``final_norm``, ``layers``: one dict per layer; ``projector`` for the
VLM; ``encoder`` {``layers``, ``final_norm``} and, when the frames'
width differs from the model's, ``enc_proj`` for the enc-dec) in the
reference's weight layouts, made by :meth:`Model.init` from a
``torch.Generator`` or carried over from JAX by
:mod:`repro_torch.bridge`. Serving entry points update the paged state
(K/V pools and per-slot rows) **in place** and also return it, so call
sites read like the reference's functional ones. A stack without rope
(rwkv6, whisper) adds sinusoidal absolute positions to the embeddings,
as the reference does.

Batch dicts, as in the reference: ``{"tokens" (B, S)}``; the VLM adds
``"patches" (B, n_img, d_in)`` (the vision frontend's stub output, whose
``n_img`` projected rows come before the text), the enc-dec
``"frames" (B, enc_len, d_in)`` (the conv stem's stub output).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention.ops import sample_tokens_op
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.models.layers import (abs_position_vector, apply_norm,
                                       dense_init, dt, embed_init,
                                       init_norm, sharded_cross_entropy,
                                       sinusoidal_positions,
                                       softmax_cross_entropy)
from repro_torch.models.recurrent import FP32_PARAMS
from repro_torch.obs import spans as obs_spans

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


def mesh_device(mesh) -> torch.device:
    """The device a rank of ``mesh`` (a ``DeviceMesh``, or a rank's view
    of one with the ``DeviceMesh`` as ``.mesh``) runs on: its card, or
    the CPU for a CPU mesh."""
    dm = mesh if hasattr(mesh, "device_type") else mesh.mesh
    if dm.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(dm.device_type)


class Model:
    """Init/apply facade for one architecture on one device, or on one
    rank of a mesh.

    With ``mesh`` (a ``parallel.rank_mesh.RankMesh``, which the step
    builders make: a rank's view of a ``DeviceMesh`` with the step's
    global batch, ring capacity and the placements of its parameters)
    the full-sequence forward, the loss, ``prefill`` and the ring
    ``decode`` take and return the rank's **local blocks** under the
    partition rules: its batch rows, its vocab block of the embedding,
    the head and the logits, its heads, channels and experts, and, under
    ``fsdp_params``, its block of their d_model rows (gathered over
    "data" where a layer runs). What is split is read from the view's
    specs. The collectives that join the blocks are explicit (see each
    layer). The paged serving paths stay on one device."""

    def __init__(self, cfg, device=None, mesh=None):
        if cfg.logit_softcap or cfg.tie_embeddings:
            raise NotImplementedError(
                f"{cfg.name}: logit soft-capping and tied embeddings are "
                "not ported (no configuration of the repo uses them)")
        self.cfg = cfg
        self.mesh = None
        if mesh is not None:
            self.mesh = mesh
            if device is None:
                device = mesh_device(mesh)
        self.device = resolve_device(device)
        self._fsdp = None if mesh is None else mesh.fsdp
        self.specs = lm.layer_specs(cfg)
        self.enc_specs = None
        if cfg.is_encdec:
            assert (cfg.encoder.d_model or cfg.d_model) == cfg.d_model, \
                "encoder d_model must match the decoder's"
            assert cfg.encoder.seq_len == cfg.frontend.n_tokens, \
                "the encoder reads every frame of the frontend"
            self.enc_specs = lm.encoder_specs(cfg)
        #: (device, dtype) → the sinusoid table of positions 0..n-1 in
        #: that dtype, n the longest sequence seen there
        self._pos_tables = {}

    @property
    def n_prefix(self) -> int:
        """Rows a frontend puts before the prompt's tokens in the
        decoder's sequence (the VLM's image patches; 0 otherwise)."""
        return self.cfg.frontend.n_tokens if self.cfg.family == "vlm" else 0

    @property
    def enc_len(self) -> int:
        """Encoder positions of an enc-dec model's cross rows (0 without
        an encoder)."""
        return self.cfg.encoder.seq_len if self.cfg.is_encdec else 0

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator):
        """Random parameters with the reference's shapes, scales and
        dtypes (``generator`` must live on ``self.device``)."""
        return self._init(generator, lambda tree: tree)

    def init_compute_params(self, generator: torch.Generator):
        """``compute_params(init(generator))``, the same numbers, with
        each layer cast as it is made: no copy of the whole model in
        ``param_dtype`` is ever held (starcoder2-15b's fp32 copy would
        not fit one card beside its bf16 one)."""
        return self._init(generator, self.compute_params)

    def _init(self, generator, cast):
        cfg, dev, pd = self.cfg, self.device, self.cfg.param_dtype
        params = {
            "tok_embed": cast(embed_init(generator, cfg.padded_vocab,
                                         cfg.d_model, pd, dev)),
            "layers": [cast(lm.init_layer(cfg, generator, spec, dev))
                       for spec in self.specs],
            "final_norm": init_norm(cfg, dev),
            "lm_head": cast(dense_init(generator, cfg.d_model,
                                       cfg.padded_vocab, pd, dev,
                                       scale=0.02)),
        }
        fe = cfg.frontend
        if fe is not None and fe.kind == "vision":
            params["projector"] = cast({
                "w1": dense_init(generator, fe.d_in, cfg.d_model, pd, dev),
                "w2": dense_init(generator, cfg.d_model, cfg.d_model, pd,
                                 dev)})
        if cfg.is_encdec:
            params["encoder"] = {
                "layers": [cast(lm.init_layer(cfg, generator, spec, dev))
                           for spec in self.enc_specs],
                "final_norm": init_norm(cfg, dev)}
            if fe.d_in != cfg.d_model:
                params["enc_proj"] = cast(dense_init(
                    generator, fe.d_in, cfg.d_model, pd, dev))
        return params

    def compute_params(self, params):
        """Copy of ``params`` (a tree of ``init``'s form, or one the
        reference made, carried over by ``bridge.py``) with every product
        weight cast once to the compute dtype — the same numbers as the
        reference's per-call ``.astype(compute_dtype)``. Norm scales and
        biases and the leaves the reference reads in fp32 (the recurrent
        gates, decays and bonus, the MoE router) keep their dtype."""
        cd = dt(self.cfg.compute_dtype)
        keep = ("scale", "bias", "router") + FP32_PARAMS

        def cast(tree):
            if isinstance(tree, dict):
                return {k: (v if k in keep else cast(v))
                        for k, v in tree.items()}
            if isinstance(tree, list):
                return [cast(v) for v in tree]
            return tree.to(cd)
        return cast(params)

    # ------------------------------------------------------------------
    # ZeRO-3 on a mesh (``fsdp_params``)
    # ------------------------------------------------------------------
    def _fsdp_gather(self, tree, specs):
        """The leaves that ``fsdp_params`` splits over "data" (a d_model
        row or column: ``specs``, the mesh view's ``fsdp`` tree),
        gathered whole over "data" for this use (backward: a
        reduce-scatter)."""
        if isinstance(tree, dict):
            return {k: self._fsdp_gather(v, specs[k])
                    for k, v in tree.items()}
        for d, entry in enumerate(specs):
            if entry == "data":
                return self.mesh.all_gather(tree, ("data",), d)
        return tree

    def _prepare(self, *keys):
        """``(i, p)`` → layer ``i``'s parameters as the layer uses them
        (None: as they are); ``keys`` lead to the stack's layer list
        (default the decoder's ``"layers"``)."""
        if self._fsdp is None:
            return None
        specs = self._fsdp
        for k in keys or ("layers",):
            specs = specs[k]
        return lambda i, p: self._fsdp_gather(p, specs[i])

    def _top(self, params, name):
        """A top-level leaf (``tok_embed``, ``lm_head``) as it is used."""
        if self._fsdp is None:
            return params[name]
        return self._fsdp_gather(params[name], self._fsdp[name])

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------
    def _lookup(self, params, tokens):
        """Token embeddings in the compute dtype. On a mesh whose rules
        split the vocab, the rank looks up the tokens of its block (zero
        rows for the others) and the rows meet in an ``all_reduce`` over
        "model" (exact: one row is nonzero)."""
        table = self._top(params, "tok_embed")
        cd = dt(self.cfg.compute_dtype)
        if self.mesh is None or not self.mesh.split("tok_embed", 0):
            return table[tokens].to(cd)
        V = table.shape[0]
        ids = tokens.long() - self.mesh.tp_rank * V
        ok = (ids >= 0) & (ids < V)
        x = torch.where(ok[..., None], table[ids.clamp(0, V - 1)], 0.0)
        return self.mesh.all_reduce(x.to(cd), ("model",))

    def _embed_tokens(self, params, tokens, positions):
        """Token embeddings in the compute dtype; without rope, plus the
        sinusoidal vectors of ``positions`` ((S,) for a chunk, (B, 1) for
        a decode step)."""
        tl = obs_spans.ACTIVE
        sid = tl.open("model.embed") if tl is not None else 0
        x = self._lookup(params, tokens)
        if not self.cfg.use_rope:
            x = x + abs_position_vector(positions, self.cfg.d_model).to(
                x.dtype)
        if sid:
            tl.close(sid)
        return x

    def _add_positions(self, x):
        """x (B, S, D) + the sinusoidal vectors of positions 0..S-1,
        sliced from the table this model holds for x's device and dtype:
        ``sinusoidal_positions`` (the reference's numpy bits) cast once to
        x's dtype and uploaded once. A call that needs more rows than the
        table has makes it anew at S rows (span ``model.pos_table``); it
        never shrinks. Row p does not depend on the table's length, so a
        slice has the bits of a table made at S."""
        S, D = x.shape[1], x.shape[2]
        key = (x.device, x.dtype)
        table = self._pos_tables.get(key)
        if table is None or table.shape[0] < S:
            tl = obs_spans.ACTIVE
            sid = tl.open("model.pos_table", S) if tl is not None else 0
            table = sinusoidal_positions(S, D).to(x.device).to(x.dtype)
            self._pos_tables[key] = table
            if sid:
                tl.close(sid)
        return x + table[:S][None]

    def _project_patches(self, params, patches):
        """The VLM projector: GELU (tanh form, ``jax.nn.gelu``'s
        default) between two products. On a mesh the rules split the
        hidden width (``w1``'s columns, ``w2``'s rows: both d_model, so
        both or neither) over "model": the rank's partial products meet
        in an ``all_reduce``."""
        cd = dt(self.cfg.compute_dtype)
        pr = params["projector"]
        h = F.gelu(patches.to(cd) @ pr["w1"].to(cd), approximate="tanh")
        y = h @ pr["w2"].to(cd)
        if self.mesh is not None and self.mesh.at("projector").split("w2",
                                                                     0):
            y = self.mesh.all_reduce(y, ("model",))
        return y

    def encode(self, params, frames):
        """Whisper's encoder over the stub frames (B, enc_len, d_in) →
        (B, enc_len, D): sinusoidal positions, non-causal attention and
        the GELU FFN in every layer (plain PyTorch attention, as in the
        reference), then the encoder's final norm."""
        cfg = self.cfg
        cd = dt(cfg.compute_dtype)
        x = frames.to(cd)
        if "enc_proj" in params:
            x = x @ params["enc_proj"].to(cd)
            if self.mesh is not None and self.mesh.split("enc_proj", 1):
                # the rules split its columns: the frames' width whole
                x = self.mesh.all_gather(x, ("model",), 2)
        x = self._add_positions(x)
        enc = params["encoder"]
        x, _, _ = lm.apply_stack_full(
            cfg, self.enc_specs, enc["layers"], x,
            torch.arange(x.shape[1], device=x.device), causal=False,
            make_cache=False,
            mesh=None if self.mesh is None else self.mesh.at("encoder",
                                                             "layers"),
            prepare=self._prepare("encoder", "layers"))
        return apply_norm(cfg, enc["final_norm"], x)

    def _assemble_inputs(self, params, batch):
        """→ (the decoder's input sequence, the encoder output or None):
        token embeddings after the VLM's projected patches; sinusoidal
        positions over the whole sequence without rope."""
        cfg = self.cfg
        tl = obs_spans.ACTIVE
        sid = tl.open("model.embed") if tl is not None else 0
        x = self._lookup(params, batch["tokens"])
        if cfg.family == "vlm":
            pre = self._project_patches(params, batch["patches"])
            x = torch.cat([pre, x], dim=1)
        enc_out = self.encode(params, batch["frames"]) if cfg.is_encdec \
            else None
        if not cfg.use_rope:
            x = self._add_positions(x)
        if sid:
            tl.close(sid)
        return x, enc_out

    def _vocab_split(self):
        """Whether this rank holds a block of the head's vocab columns."""
        return self.mesh is not None and self.mesh.split("lm_head", 1)

    def _layers_mesh(self):
        return None if self.mesh is None else self.mesh.at("layers")

    def _lm_logits(self, params, x):
        """Logits of the rank's vocab block on a mesh that splits it."""
        cfg = self.cfg
        tl = obs_spans.ACTIVE
        sid = tl.open("model.head") if tl is not None else 0
        cd = dt(cfg.compute_dtype)
        x = apply_norm(cfg, params["final_norm"], x)
        logits = x.to(cd) @ self._top(params, "lm_head").to(cd)
        if cfg.padded_vocab != cfg.vocab:      # mask padded vocab columns
            V = logits.shape[-1]
            lo = self.mesh.tp_rank * V if self._vocab_split() else 0
            pad = torch.arange(lo, lo + V, device=x.device) >= cfg.vocab
            zero = torch.zeros((), dtype=logits.dtype, device=x.device)
            logits = logits + torch.where(pad, torch.full_like(zero, -1e30),
                                          zero)
        if sid:
            tl.close(sid)
        return logits

    # ------------------------------------------------------------------
    # Full-sequence forward and loss (the train path)
    # ------------------------------------------------------------------
    def forward(self, params, batch):
        """→ (logits (B, S, V*), the MoE aux loss (fp32, 0 without
        MoE)); S counts the VLM's image rows before the text. No caches
        are built; each layer runs under ``cfg.sharding.remat`` while a
        gradient is recorded (reference ``model.py:121-131``). Train
        from ``init``'s tree (``param_dtype``): the layers cast each
        weight per call, so the gradients land on those leaves."""
        x, enc_out = self._assemble_inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _, aux = lm.apply_stack_full(self.cfg, self.specs,
                                        params["layers"], x, positions,
                                        enc_out=enc_out, make_cache=False,
                                        mesh=self._layers_mesh(),
                                        prepare=self._prepare())
        return self._lm_logits(params, x), aux

    def loss(self, params, batch):
        """batch adds ``"labels"`` (B, S) and ``"mask"`` (B, S) — over
        the whole sequence, image rows included (the pipeline's mask is
        0 there) → (ce + aux, {"ce", "aux", "n_tok"})."""
        logits, aux = self.forward(params, batch)
        if self.mesh is not None:
            ce, n_tok = sharded_cross_entropy(
                logits, batch["labels"], batch.get("mask"), self.mesh,
                self._vocab_split())
        else:
            ce, n_tok = softmax_cross_entropy(logits, batch["labels"],
                                              batch.get("mask"))
        return ce + aux, {"ce": ce, "aux": aux, "n_tok": n_tok}

    # ------------------------------------------------------------------
    # Prefill → (last-token logits, K/V caches)
    # ------------------------------------------------------------------
    def prefill(self, params, batch, capacity=None):
        """batch {"tokens": (B, S)} (+ ``"patches"`` / ``"frames"``) →
        (logits (B, V*), caches): ``"k"``, ``"v"`` (La, B, C, Hkv, hd)
        over the attention layers — C = S (the VLM's ``n_prefix`` patch
        rows + S) with no ``capacity``, else ring caches of ``capacity``
        slots (position p at slot p % C) — and, for recurrent and
        cross-attention layers, ``"rows"`` (one dict of batch rows per
        layer; see ``lm``)."""
        tl = obs_spans.ACTIVE
        sid = tl.open("model.prefill") if tl is not None else 0
        x, enc_out = self._assemble_inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, caches, _ = lm.apply_stack_full(self.cfg, self.specs,
                                           params["layers"], x, positions,
                                           capacity or 0, enc_out=enc_out,
                                           mesh=self._layers_mesh(),
                                           prepare=self._prepare())
        logits = self._lm_logits(params, x[:, -1:])[:, 0]
        if sid:
            tl.close(sid)
        return logits, caches

    # ------------------------------------------------------------------
    # Decode: one token against contiguous ring caches
    # ------------------------------------------------------------------
    def decode(self, params, caches, token, pos):
        """token (B,1) int; pos the shared position (int or 0-d int32
        tensor on the caches' device) → (logits (B, V*), caches), the
        caches updated in place: K/V at ring slot ``pos % C``, every
        recurrent row."""
        pvec = attn.position_vector(pos, token.device)   # once per step
        x = self._embed_tokens(params, token, pvec[None])
        x = lm.apply_stack_decode_ring(self.cfg, self.specs,
                                       params["layers"], x, caches, pos,
                                       pvec, self._layers_mesh(),
                                       self._prepare())
        return self._lm_logits(params, x[:, -1:])[:, 0], caches

    def init_cache(self, batch_size, capacity):
        """Zeroed ring caches of ``capacity`` slots (a ``swa`` layer's
        ring holds ``min(window, capacity)``) and, for recurrent and
        cross-attention layers, zeroed rows — the form
        ``prefill(capacity=)`` returns."""
        return lm.init_stack_cache(self.cfg, self.specs, batch_size,
                                   capacity, self.device, self.enc_len)

    def input_specs(self, cell):
        """→ batch dict of meta tensors (shape and dtype, no data) for a
        ``ShapeCell`` — the stand-in for the reference's
        ``ShapeDtypeStruct``s."""
        cfg = self.cfg
        B, S = cell.global_batch, cell.seq_len

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")
        if cell.kind == "decode":
            return {"token": meta((B, 1), torch.int32)}
        batch, s_text = {}, S
        if cfg.family == "vlm":
            s_text = S - cfg.frontend.n_tokens
            batch["patches"] = meta((B, cfg.frontend.n_tokens,
                                     cfg.frontend.d_in), torch.float32)
        if cfg.is_encdec:
            batch["frames"] = meta((B, cfg.frontend.n_tokens,
                                    cfg.frontend.d_in), torch.float32)
        batch["tokens"] = meta((B, s_text), torch.int32)
        if cell.kind == "train":
            batch["labels"] = meta((B, S), torch.int32)
            batch["mask"] = meta((B, S), torch.float32)
        return batch

    # ------------------------------------------------------------------
    # Paged serving path (MMU-backed KV pages; see serving/paged_kv.py)
    # ------------------------------------------------------------------
    def init_paged_state(self, batch_size, num_pages, page_size):
        """Serving state: K/V page pools (La, P, ps, Hkv, hd) over the
        attn/swa layers, per-slot rows of ``batch_size`` slots for every
        recurrent leaf and every cross K/V (``enc_len`` rows)."""
        return lm.init_paged_state(
            self.cfg, self.specs, batch_size, num_pages, page_size,
            self.device, self.enc_len)

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
        tl = obs_spans.ACTIVE
        sid = tl.open("model.decode_paged") if tl is not None else 0
        x = self._embed_tokens(params, token, positions.clamp_min(0)[:, None])
        x = lm.apply_stack_decode(self.cfg, self.specs, params["layers"], x,
                                  state, positions, block_tables)
        logits = self._lm_logits(params, x[:, -1:])[:, 0]
        if sid:
            tl.close(sid)
        return logits, state

    def prefill_chunk_paged(self, params, state, tokens, slot, block_row,
                            start):
        """One slot's prompt chunk: tokens (1, L); slot its batch row;
        block_row (nb,) the slot's block table; start the absolute
        position of tokens[0] → (logits (1, V*) of the chunk's last
        token, state). The VLM and the enc-dec prefill monolithically,
        as in the reference."""
        if self.cfg.family == "vlm" or self.cfg.is_encdec:
            raise NotImplementedError(
                "chunked prefill: vlm/enc-dec frontends prefill "
                "monolithically")
        tl = obs_spans.ACTIVE
        sid = tl.open("model.prefill_chunk_paged") if tl is not None else 0
        positions = start + torch.arange(tokens.shape[1],
                                         device=tokens.device)
        x = self._embed_tokens(params, tokens, positions)
        x = lm.apply_stack_chunk(self.cfg, self.specs, params["layers"], x,
                                 state, positions, block_row, int(slot))
        logits = self._lm_logits(params, x[:, -1:])[:, 0]
        if sid:
            tl.close(sid)
        return logits, state

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
        tl = obs_spans.ACTIVE
        sid = tl.open("model.decode_paged_fused") if tl is not None else 0
        logits, state = self.decode_paged(params, state, token, positions,
                                          block_tables)
        if sid:
            ssid = tl.open("model.sample")
        if noise is None:
            noise = self.gumbel_noise(logits.shape, step)
        toks = sample_tokens_op(logits, temps, noise)
        if sid:
            tl.close(ssid)
            tl.close(sid)
        return toks, state

    def copy_kv_page(self, state, src, dst):
        """Device-side page copy ``dst ← src`` across every K/V pool, in
        place — the copy-on-write byte move paired with
        ``SegmentPool.fork_page``. src/dst are (1,) int64 device
        tensors."""
        return lm.copy_kv_page_in_state(state, src, dst)

    def read_kv_page(self, state, page):
        """One physical page out of every K/V pool → flat leaf list in
        the reference's order (the swap tier's device→host read)."""
        return lm.gather_kv_page(self.cfg, self.specs, state, page)

    def write_kv_page(self, state, page, leaves):
        """Write a :meth:`read_kv_page` leaf list back into physical
        page ``page``, in place (the swap tier's refault write)."""
        return lm.scatter_kv_page(self.cfg, self.specs, state, page,
                                  leaves)

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
        """Device bytes one slot's rows span across all layers (recurrent
        state, cross K/V) — the MMU lease granularity for paged state rows;
        0 for decoder-only attention stacks."""
        st = lm.init_paged_state(self.cfg, self.specs, 1, 1, 1, "meta",
                                 self.enc_len)
        return sum(leaf.numel() * leaf.element_size() for leaf in
                   lm.gather_state_row(self.cfg, self.specs, st, 0))

