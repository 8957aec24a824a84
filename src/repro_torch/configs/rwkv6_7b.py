"""rwkv6-7b — RWKV-6 "Finch": attention-free, data-dependent decay
[arXiv:2404.05892; hf].

32L d_model=4096 (64 heads × 64) channel-mix d_ff=14336 vocab=65536.
Constant-size recurrent state → runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig, ShardingProfile, register

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,          # wkv heads = d_model / rwkv_head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    block_pattern=("rwkv",),
    ffn_kind="channelmix",
    rwkv_head_dim=64,
    norm="layernorm",
    use_rope=False,
    source="arXiv:2404.05892",
)

REDUCED = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    block_pattern=("rwkv",),
    ffn_kind="channelmix",
    rwkv_head_dim=32,
    norm="layernorm",
    use_rope=False,
    max_seq_len=256,
    sharding=ShardingProfile(remat="none"),
    source="reduced",
)

register(CONFIG, REDUCED)
