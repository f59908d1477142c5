"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

GQA + QKV bias, tied embeddings. [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
    norm_eps=1e-6,
    train_microbatches=2,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-1.5b-smoke",
    family="dense",
    num_layers=2,
    d_model=48,
    num_heads=6,
    num_kv_heads=2,
    d_ff=144,
    vocab_size=256,
    qkv_bias=True,
    tie_embeddings=True,
    max_seq_len=256,
)
