"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.

RoPE, GQA. [hf:THUDM/glm-4-9b; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=10000.0,
    norm_eps=1.5625e-7,
    train_microbatches=2,
)

SMOKE_CONFIG = ModelConfig(
    name="glm4-9b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=208,
    vocab_size=256,
    max_seq_len=256,
)
