"""mixtral-8x7b — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336(expert) vocab=32000, SWA
window 4096. SWA is sub-quadratic → runs the long_500k cell with a rolling
window KV cache.
"""
from repro_torch.configs.base import (
    MoEConfig, ModelConfig, ShardingProfile, register)

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    ffn_kind="moe",
    block_pattern=("swa",),
    window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=14336,
                  capacity_factor=1.25),
    rope_theta=1e6,
    # production default: expert-TP shard_map MoE (EXPERIMENTS.md §Perf —
    # 17× step-time LB over the auto-spmd gather baseline; reproduce the
    # baseline with launch/dryrun.py --moe-impl gather)
    sharding=ShardingProfile(moe_impl="ep"),
    source="arXiv:2401.04088",
)

REDUCED = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab=512,
    ffn_kind="moe",
    block_pattern=("swa",),
    window=16,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=96, capacity_factor=2.0),
    max_seq_len=256,
    sharding=ShardingProfile(remat="none"),
    source="reduced",
)

register(CONFIG, REDUCED)
