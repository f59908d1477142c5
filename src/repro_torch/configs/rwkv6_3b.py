"""rwkv6-3b [ssm]: 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536.

Finch — data-dependent per-channel decay. [arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,       # d_model / head_size
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    rwkv=RWKVConfig(head_size=64, chunk=64),
    max_seq_len=1 << 20,
    train_microbatches=2,
)

SMOKE_CONFIG = ModelConfig(
    name="rwkv6-3b-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=224,
    vocab_size=256,
    rwkv=RWKVConfig(head_size=16, chunk=16),
    max_seq_len=1024,
)
