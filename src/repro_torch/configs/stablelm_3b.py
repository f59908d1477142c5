"""stablelm-3b [dense]: 32L d_model=2560 32H (MHA) d_ff=6912 vocab=50304.

[hf:stabilityai/stablelm-2-1_6b family; unverified]. StableLM-2 uses partial
rotary embeddings (25% of head_dim).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    rope_fraction=0.25,
    norm_eps=1e-5,
    activation="silu",
)

SMOKE_CONFIG = ModelConfig(
    name="stablelm-3b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=176,
    vocab_size=256,
    rope_fraction=0.25,
    max_seq_len=256,
)
