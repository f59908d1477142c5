"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
(per expert) vocab=151936, MoE 128 experts top-8, QK-norm, head_dim=128.
[hf:Qwen/Qwen3-235B-A22B family; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    norm_eps=1e-6,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536,
                  sharding_mode="ep"),
    opt_state_dtype="bfloat16",   # fits the 16GB/chip budget (DESIGN.md)
    train_microbatches=16,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=256,
    qk_norm=True,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32, sharding_mode="ep"),
    max_seq_len=256,
)
