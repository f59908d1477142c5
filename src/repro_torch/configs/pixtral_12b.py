"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, head_dim=128 (Mistral-Nemo backbone). The pixtral ViT
frontend is a stub — ``input_specs()`` provides precomputed patch
embeddings. [hf:mistralai/Pixtral-12B-2409; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1000000000.0,
    norm_eps=1e-5,
    train_microbatches=4,
)

SMOKE_CONFIG = ModelConfig(
    name="pixtral-12b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=256,
    max_seq_len=256,
)
