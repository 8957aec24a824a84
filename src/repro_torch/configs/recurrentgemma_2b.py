"""recurrentgemma-2b — Griffin hybrid: RG-LRU + local attention, 1:2
[arXiv:2402.19427; hf].

26L d_model=2560 10H (MQA kv=1, d_head=256) d_ff=7680 vocab=256000.
Block pattern (rglru, rglru, swa) with a 2048-token local window — the
repeating (recurrent, recurrent, attention) Griffin layout. Sub-quadratic →
runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig, ShardingProfile, register

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_head=256,
    d_ff=7680,
    vocab=256000,
    block_pattern=("rglru", "rglru", "swa"),
    window=2048,
    source="arXiv:2402.19427",
)

REDUCED = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=3,
    d_model=64,
    n_heads=2,
    n_kv_heads=1,
    d_head=32,
    d_ff=128,
    vocab=512,
    block_pattern=("rglru", "rglru", "swa"),
    window=16,
    max_seq_len=256,
    sharding=ShardingProfile(remat="none"),
    source="reduced",
)

register(CONFIG, REDUCED)
