"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (MHA kv=16) d_ff=1408
(per expert) vocab=163840, MoE 64 experts top-6 + 2 shared experts,
first layer dense (Moonlight / kimi). [hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared_experts=2, first_k_dense=1, dense_d_ff=11264,
                  sharding_mode="ep"),
    norm_eps=1e-6,
    train_microbatches=2,
)

SMOKE_CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=48,
    vocab_size=256,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=48,
                  num_shared_experts=2, first_k_dense=1, dense_d_ff=192,
                  sharding_mode="ep"),
    max_seq_len=256,
)
