"""zamba2-2.7b [hybrid]: 54L d_model=2560 (Mamba2) + shared attn blocks,
32H (MHA) for the shared blocks, d_ff=10240, vocab=32000, ssm_state=64.

Mamba2 backbone with 2 alternating shared (tied-weight) attention blocks
applied every 6 layers; shared-block input is concat(hidden, embeddings).
[arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=64),
    shared_attn_every=6,
    num_shared_blocks=2,
    max_seq_len=1 << 20,
    train_microbatches=2,
)

SMOKE_CONFIG = ModelConfig(
    name="zamba2-2.7b-smoke",
    family="hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=192,
    vocab_size=256,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1,
                  chunk=16),
    shared_attn_every=2,
    num_shared_blocks=2,
    max_seq_len=1024,
)
