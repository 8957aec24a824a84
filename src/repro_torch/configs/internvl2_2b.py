"""internvl2-2b — VLM: InternViT-300M frontend + InternLM2 backbone
[arXiv:2404.16821; hf].

Backbone: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
The vision frontend is a STUB per the assignment: ``input_specs()`` supplies
precomputed InternViT patch embeddings (256 tokens after pixel-unshuffle,
d_in=1024); a trainable MLP projector maps them into the LM stream.
"""
from repro_torch.configs.base import (
    FrontendConfig, ModelConfig, ShardingProfile, register)

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    rope_theta=1e6,
    frontend=FrontendConfig(kind="vision", n_tokens=256, d_in=1024),
    source="arXiv:2404.16821",
)

REDUCED = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    frontend=FrontendConfig(kind="vision", n_tokens=8, d_in=32),
    max_seq_len=256,
    sharding=ShardingProfile(remat="none"),
    source="reduced",
)

register(CONFIG, REDUCED)
