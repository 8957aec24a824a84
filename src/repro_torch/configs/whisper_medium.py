"""whisper-medium — enc-dec audio transformer [arXiv:2212.04356; unverified].

24L (each side) d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=51865.
Conv frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings (1500 frames = 30 s of audio after the 2× conv downsample).
Absolute (sinusoidal) positions, LayerNorm, GELU MLP — per the paper.
"""
from repro_torch.configs.base import (
    EncoderConfig, FrontendConfig, ModelConfig, ShardingProfile, register)

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    ffn_kind="gelu",
    norm="layernorm",
    use_rope=False,
    qkv_bias=True,
    encoder=EncoderConfig(n_layers=24, seq_len=1500),
    frontend=FrontendConfig(kind="audio", n_tokens=1500, d_in=1024),
    max_seq_len=32768,
    source="arXiv:2212.04356",
)

REDUCED = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    ffn_kind="gelu",
    norm="layernorm",
    use_rope=False,
    qkv_bias=True,
    encoder=EncoderConfig(n_layers=2, seq_len=24),
    frontend=FrontendConfig(kind="audio", n_tokens=24, d_in=64),
    max_seq_len=256,
    sharding=ShardingProfile(remat="none"),
    source="reduced",
)

register(CONFIG, REDUCED)
