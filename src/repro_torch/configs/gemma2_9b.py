"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.

Local(4096-window)+global alternating attention, logit softcaps (attn 50,
final 30), head_dim=256, GeGLU, sandwich norms, tied + scaled embeddings.
[arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    local_global_alternating=True,
    sandwich_norm=True,
    activation="gelu",
    tie_embeddings=True,
    scale_embeddings=True,
    norm_eps=1e-6,
    train_microbatches=8,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma2-9b-smoke",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=192,
    vocab_size=256,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=32,
    local_global_alternating=True,
    sandwich_norm=True,
    activation="gelu",
    tie_embeddings=True,
    scale_embeddings=True,
    max_seq_len=256,
)
