"""starcoder2-15b — dense GQA transformer [arXiv:2402.19173; hf].

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152. RoPE; classic
GELU MLP with biases (per the StarCoder2 paper). The assignment lists it
as [dense] full attention → long_500k is a documented skip.
"""
from repro_torch.configs.base import ModelConfig, ShardingProfile, register

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    ffn_kind="gelu",
    qkv_bias=True,
    norm="layernorm",
    rope_theta=1e5,
    source="arXiv:2402.19173",
)

REDUCED = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    ffn_kind="gelu",
    qkv_bias=True,
    norm="layernorm",
    max_seq_len=256,
    sharding=ShardingProfile(remat="none"),
    source="reduced",
)

register(CONFIG, REDUCED)
