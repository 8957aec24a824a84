"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table)
[arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8, d_head=112) vocab=163840.
MoE: 384 experts, top-8, d_expert=2048, +1 shared expert; the first layer
is dense (d_ff=18432), DeepSeek-V3-style. Analytic totals from this config:
~1.03T total / ~33B active parameters — matching the 1t-a32b designation.

Parallelism profile: EP over the model axis (384/16 = 24 experts per chip),
expert d_ff additionally sharded over the data axis, ZeRO-3 (fsdp) parameter
+ optimizer-state sharding, bf16 master params/optimizer (documented in
EXPERIMENTS.md — fp32 state for 1T params cannot fit a 256-chip v5e pod).
"""
from repro_torch.configs.base import (
    MoEConfig, ModelConfig, ShardingProfile, register)

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=112,
    d_ff=2048,                 # per-expert hidden (assignment value)
    vocab=163840,
    ffn_kind="moe",
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048,
                  n_shared_experts=1, first_dense_layers=1,
                  dense_d_ff=18432, capacity_factor=1.25),
    rope_theta=5e4,
    param_dtype="bfloat16",
    opt_dtype="bfloat16",
    # production default: token-routing EP MoE via shard_map (§Perf: 7.9×
    # train step-time LB, 28× prefill collective vs the gather baseline,
    # which used shard_experts_data=True + auto-spmd; reproduce with
    # --moe-impl gather). NOTE: EP-over-model leaves expert weights
    # replicated across the data axis — kimi fundamentally needs ≥1024
    # chips (or 2-D expert sharding, §Perf next-levers) to fit training.
    sharding=ShardingProfile(fsdp_params=True, moe_impl="ep",
                             shard_experts_data=True),
    source="arXiv:2501.kimi2 (paper-table)",
)

REDUCED = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=32,
    vocab=512,
    ffn_kind="moe",
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32,
                  n_shared_experts=1, first_dense_layers=1,
                  dense_d_ff=128, capacity_factor=2.0),
    max_seq_len=256,
    sharding=ShardingProfile(remat="none"),
    source="reduced",
)

register(CONFIG, REDUCED)
