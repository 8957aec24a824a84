"""Model / run configuration system.

Every assigned architecture is a ``ModelConfig`` (exact public-literature
dims) plus a ``reduced()`` variant used by CPU smoke tests. Shapes-cells
(train_4k / prefill_32k / decode_32k / long_500k) are ``ShapeCell``s.

The config layer is deliberately framework-grade: frozen dataclasses,
validation at construction, a registry keyed by ``--arch`` id, and
serialization helpers used by the checkpointing manifest.

This is the PyTorch package's own copy of ``repro.configs.base``: the
same fields and values, minus ``use_pallas``. Every architecture of
the reference is registered, each from its own copied module.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (GShard/Mixtral-style top-k)."""

    n_experts: int
    top_k: int
    d_expert: int                   # per-expert FFN hidden size
    n_shared_experts: int = 0       # DeepSeek/Kimi-style always-on experts
    first_dense_layers: int = 0     # leading dense (non-MoE) layers
    dense_d_ff: int = 0             # FFN width of those dense layers
    capacity_factor: float = 1.25   # token capacity per expert
    router_aux_coef: float = 0.01   # load-balance auxiliary loss weight

    def __post_init__(self):
        assert self.n_experts >= 2 and 1 <= self.top_k <= self.n_experts


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (Whisper)."""

    n_layers: int
    seq_len: int                    # encoder sequence length (audio frames)
    d_model: int = 0                # 0 → same as decoder d_model
    n_heads: int = 0                # 0 → same as decoder


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: input_specs() supplies precomputed embeddings.

    ``kind='audio'``  — Whisper conv stem output (frames already downsampled).
    ``kind='vision'`` — InternViT patch embeddings + trainable projector.
    """

    kind: str                       # 'audio' | 'vision'
    n_tokens: int                   # frames / image tokens contributed
    d_in: int                       # embedding dim provided by the stub


@dataclass(frozen=True)
class ShardingProfile:
    """Logical→mesh axis mapping knobs (per-arch parallelism profile)."""

    tp_attn: str = "heads"          # 'heads' | 'flat' (shard heads*d_head dim)
    fsdp_params: bool = False       # ZeRO-3: shard params over the data axis
    fsdp_min_size: int = 2 ** 18    # leaves smaller than this stay replicated
    shard_experts_data: bool = False  # additionally shard expert d_ff on data
    # 'full' (recompute per layer) is the production default: 'dots'
    # (checkpoint_dots_with_no_batch_dims) keeps every projection output
    # and blows HBM at 4k×256 batch (measured: 24 GB temps on qwen-0.5b).
    remat: str = "full"             # 'none'|'dots'|'full'
    scan_layers: bool = True
    # MoE execution: 'gather' = pjit auto-spmd sort/gather dispatch (the
    # faithful baseline — measured catastrophically replicated by GSPMD,
    # EXPERIMENTS.md §Perf); 'ep' = shard_map expert parallelism with
    # all-to-all token routing (beyond-paper optimized path).
    moe_impl: str = "gather"
    # split-KV decode attention via shard_map when the KV cache is
    # sequence-sharded (kv-heads don't divide the model axis, or B=1):
    # replaces a per-layer cache all-gather with tiny m/l/o psums.
    decode_splitk: bool = True


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

MIXERS = ("attn", "swa", "rglru", "rwkv")
FFNS = ("swiglu", "gelu", "moe", "channelmix")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|encdec|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                 # 0 → d_model // n_heads

    # Block composition ----------------------------------------------------
    block_pattern: Tuple[str, ...] = ("attn",)  # repeated over n_layers
    ffn_kind: str = "swiglu"
    window: int = 0                 # sliding/local attention window (0 = full)

    # Attention flavour ----------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True           # whisper uses absolute positions instead
    logit_softcap: float = 0.0

    # Optional subsystems ----------------------------------------------------
    moe: Optional[MoEConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[FrontendConfig] = None

    # RWKV-specific ----------------------------------------------------------
    rwkv_head_dim: int = 64

    # Norm / misc ------------------------------------------------------------
    norm: str = "rmsnorm"           # 'rmsnorm' | 'layernorm'
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 524288

    # Precision --------------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_dtype: str = "float32"

    # Kernels: there is no switch. The device of the tensors picks the
    # implementation — CUDA tensors launch the hand-written kernels under
    # kernels/, CPU tensors run their plain PyTorch versions.

    sharding: ShardingProfile = field(default_factory=ShardingProfile)

    # citation / provenance ----------------------------------------------------
    source: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        assert self.family in (
            "dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio")
        for m in self.block_pattern:
            assert m in MIXERS, m
        assert self.ffn_kind in FFNS
        if self.d_head == 0:
            object.__setattr__(self, "d_head",
                               self.d_model // max(self.n_heads, 1))
        if self.ffn_kind == "moe":
            assert self.moe is not None
        if self.family in ("audio",):
            assert self.encoder is not None and self.frontend is not None

    # ------------------------------------------------------------------
    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    @property
    def attention_free(self) -> bool:
        return all(m in ("rglru", "rwkv") for m in self.block_pattern)

    @property
    def subquadratic(self) -> bool:
        """True if the arch can serve 500k-token contexts (skip rule)."""
        return all(m != "attn" for m in self.block_pattern)

    @property
    def n_q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so embedding / lm_head shard
        evenly on any mesh axis ≤ 256 (Megatron-style vocab padding). Padded
        logit columns are masked to -inf in the loss/head."""
        return ((self.vocab + 255) // 256) * 256

    def layer_mixer(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    # -- parameter counting (for MODEL_FLOPS = 6·N·D) -----------------------
    def param_counts(self) -> dict:
        """Returns dict(total=…, active=…) — analytic, matches init_params."""
        d, hd = self.d_model, self.d_head
        nq, nkv = self.n_heads, self.n_kv_heads
        counts = {"embed": self.vocab * d,
                  "lm_head": 0 if self.tie_embeddings else d * self.vocab}
        attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        if self.qkv_bias:
            attn += (nq + 2 * nkv) * hd
        ffn_dense = (3 if self.ffn_kind == "swiglu" else 2) * d * self.d_ff
        rglru = 0
        if "rglru" in self.block_pattern:
            # 2 in-proj branches, conv4, lru gates (2·d²·… see recurrent.py)
            rglru = 2 * d * d + 4 * d + 2 * d * d // 8 + 2 * d + d * d
        rwkv = 0
        if "rwkv" in self.block_pattern:
            rwkv = 4 * d * d + d * d + 5 * (d + 32 * d * 2) + d * d  # proj + lora-ish mixes
        total = counts["embed"] + counts["lm_head"]
        active = total
        n_attn = sum(1 for i in range(self.n_layers)
                     if self.layer_mixer(i) in ("attn", "swa"))
        n_rglru = sum(1 for i in range(self.n_layers)
                      if self.layer_mixer(i) == "rglru")
        n_rwkv = self.n_layers - n_attn - n_rglru
        total += n_attn * attn + n_rglru * rglru + n_rwkv * rwkv
        active += n_attn * attn + n_rglru * rglru + n_rwkv * rwkv
        if self.ffn_kind == "moe":
            m = self.moe
            n_moe = self.n_layers - m.first_dense_layers
            expert = 3 * d * m.d_expert
            total += (n_moe * m.n_experts * expert
                      + n_moe * m.n_shared_experts * expert
                      + m.first_dense_layers * 3 * d * m.dense_d_ff
                      + n_moe * d * m.n_experts)  # router
            active += (n_moe * (m.top_k + m.n_shared_experts) * expert
                       + m.first_dense_layers * 3 * d * m.dense_d_ff
                       + n_moe * d * m.n_experts)
        elif self.ffn_kind == "channelmix":
            cm = d * (self.d_ff) + self.d_ff * d + 2 * d
            total += self.n_layers * cm
            active += self.n_layers * cm
        else:
            total += self.n_layers * ffn_dense
            active += self.n_layers * ffn_dense
        if self.encoder is not None:
            e = self.encoder
            ed = e.d_model or d
            eh = e.n_heads or nq
            enc_layer = 4 * ed * ed + 2 * ed * self.d_ff
            cross = 4 * d * d
            total += e.n_layers * enc_layer + self.n_layers * cross
            active += e.n_layers * enc_layer + self.n_layers * cross
        if self.frontend is not None and self.frontend.kind == "vision":
            proj = self.frontend.d_in * d
            total += proj
            active += proj
        return {"total": int(total), "active": int(active)}

    # ------------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=str, indent=1)


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # 'train' | 'prefill' | 'decode'


TRAIN_4K = ShapeCell("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeCell("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeCell("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeCell("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def applicable_shapes(cfg: ModelConfig):
    """long_500k only for sub-quadratic archs (SSM / hybrid / SWA)."""
    out = []
    for s in ALL_SHAPES:
        if s is LONG_500K and not (cfg.subquadratic or cfg.window > 0):
            continue  # pure full-attention: documented skip (DESIGN.md §4)
        out.append(s)
    return tuple(out)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}
_REDUCED: dict = {}


def register(cfg: ModelConfig, reduced: ModelConfig):
    assert cfg.name not in _REGISTRY, cfg.name
    _REGISTRY[cfg.name] = cfg
    _REDUCED[cfg.name] = reduced
    return cfg


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    _ensure_loaded()
    table = _REDUCED if reduced else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    from repro_torch.configs import archs  # noqa: F401  (registers them)
