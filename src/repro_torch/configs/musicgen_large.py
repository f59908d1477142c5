"""musicgen-large [audio]: 48L d_model=2048 32H (MHA) d_ff=8192 vocab=2048.

Decoder-only over EnCodec tokens; sinusoidal positions; the EnCodec
frontend is a stub — ``input_specs()`` provides precomputed frame
embeddings (see DESIGN.md). [arXiv:2306.05284; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    pos_emb="sinusoidal",
    activation="gelu",
    norm_eps=1e-5,
)

SMOKE_CONFIG = ModelConfig(
    name="musicgen-large-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=128,
    pos_emb="sinusoidal",
    activation="gelu",
    max_seq_len=256,
)
