"""internlm2-1.8b — dense GQA transformer [arXiv:2403.17297; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544. RoPE + SwiGLU.
"""
from repro_torch.configs.base import ModelConfig, ShardingProfile, register

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92544,
    rope_theta=1e6,
    source="arXiv:2403.17297",
)

REDUCED = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    max_seq_len=256,
    sharding=ShardingProfile(remat="none"),
    source="reduced",
)

register(CONFIG, REDUCED)
