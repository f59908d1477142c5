"""Config system: model configs, input-shape specs, and the arch registry.

Every assigned architecture gets a module ``repro/configs/<id>.py`` exposing
``CONFIG`` (the exact published config) and ``SMOKE_CONFIG`` (a reduced config
of the same family for CPU tests). ``get_config(name)`` resolves either.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Literal, Sequence

Family = Literal["dense", "ssm", "hybrid", "moe", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int          # per-expert hidden dim
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    first_k_dense: int = 0    # leading dense layers (Moonlight-style)
    dense_d_ff: int = 0       # d_ff of the leading dense layers
    router_dtype: str = "float32"
    # "tp": experts replicated, expert-mlp dim sharded over model axis.
    # "ep": experts sharded over model axis (GSPMD inserts dispatch comms).
    # "ep_a2a": shard_map all-to-all expert parallelism (beyond-paper path).
    sharding_mode: str = "ep"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64        # mamba2 P
    n_groups: int = 1
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads
    # --- attention knobs ---
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0         # partial rotary (stablelm: 0.25)
    qkv_bias: bool = False             # qwen2
    qk_norm: bool = False              # qwen3
    attn_softcap: float = 0.0          # gemma2: 50.0
    final_softcap: float = 0.0         # gemma2: 30.0
    sliding_window: int = 0            # gemma2: 4096 on local layers
    local_global_alternating: bool = False  # gemma2 pattern (local, global)*
    pos_emb: str = "rope"              # "rope" | "sinusoidal" (musicgen)
    # --- norms / activation ---
    norm_eps: float = 1e-5
    sandwich_norm: bool = False        # gemma2 pre+post norms
    activation: str = "silu"           # "silu" | "gelu"
    tie_embeddings: bool = False
    scale_embeddings: bool = False     # gemma2: x *= sqrt(d_model)
    # --- family-specific ---
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    rwkv: RWKVConfig | None = None
    shared_attn_every: int = 0         # zamba2: shared attn block cadence
    num_shared_blocks: int = 2         # zamba2: alternating shared blocks
    # --- numerics ---
    param_dtype: str = "float32"       # master/param dtype in training
    compute_dtype: str = "bfloat16"
    kv_cache_dtype: str = ""           # "" -> compute_dtype; "float8_e4m3fn"
                                       # halves decode cache traffic (§Perf)
    opt_state_dtype: str = "float32"   # bf16 for the 235B config
    # --- scaling / serving ---
    max_seq_len: int = 131072
    remat: str = "full"                # "none" | "full" | "dots"
    scan_layers: bool = True
    train_microbatches: int = 1        # grad-accum splits for train_4k
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0

    # ---- derived quantities -------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads if self.num_kv_heads else 0

    def param_count(self) -> int:
        """Total parameter count (exact for our construction)."""
        D, L = self.d_model, self.num_layers
        n = self.vocab_size * D                      # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * D                 # lm head
        n += D                                       # final norm
        for i in range(L):
            n += self._layer_params(i)
        if self.shared_attn_every:
            n += self.num_shared_blocks * self._shared_block_params()
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        D, L, m = self.d_model, self.num_layers, self.moe
        n = self.vocab_size * D * (1 if self.tie_embeddings else 2) + D
        for i in range(L):
            n += self._attn_params() + 2 * D
            if i < m.first_k_dense:
                n += 3 * D * m.dense_d_ff
            else:
                active = m.top_k + m.num_shared_experts
                n += 3 * D * m.d_ff_expert * active + D * m.num_experts  # + router
        return n

    def _attn_params(self) -> int:
        D, H, KV, Dh = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        n = D * H * Dh + 2 * D * KV * Dh + H * Dh * D
        if self.qkv_bias:
            n += (H + 2 * KV) * Dh
        if self.qk_norm:
            n += 2 * Dh
        return n

    def _mamba_params(self) -> int:
        s = self.ssm
        D = self.d_model
        d_in = s.expand * D
        nheads = d_in // s.head_dim
        conv_dim = d_in + 2 * s.n_groups * s.d_state
        n = D * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)  # in_proj
        n += conv_dim * s.d_conv + conv_dim                        # conv + bias
        n += nheads * 3                                            # A_log, D, dt_bias
        n += d_in                                                  # pre-out norm
        n += d_in * D                                              # out_proj
        return n

    def _rwkv_params(self) -> int:
        D = self.d_model
        H = D // self.rwkv.head_size
        # time-mix: r,k,v,g,o projections + decay lora (D->64->D) + u + mixes
        n = 5 * D * D + D * 64 + 64 * D + D + 6 * D
        n += H * self.rwkv.head_size  # bonus u per head dim
        n += 2 * D                    # group-norm scale/bias
        # channel-mix: k (D->ff), v (ff->D), r (D->D) + mixes
        n += self.d_ff * D * 2 + D * D + 2 * D
        return n

    def _shared_block_params(self) -> int:
        # zamba2 shared block: attention + dense ffn + norms (+ input proj 2D->D)
        return self._attn_params() + 3 * self.d_model * self.d_ff + 4 * self.d_model + 2 * self.d_model * self.d_model

    def _layer_params(self, i: int) -> int:
        D = self.d_model
        if self.family == "ssm":
            return self._rwkv_params() + 2 * D
        if self.family == "hybrid":
            return self._mamba_params() + D
        n = self._attn_params() + (4 * D if self.sandwich_norm else 2 * D)
        if self.moe is not None:
            m = self.moe
            if i < m.first_k_dense:
                n += 3 * D * m.dense_d_ff
            else:
                n += 3 * D * m.d_ff_expert * (m.num_experts + m.num_shared_experts)
                n += D * m.num_experts
        else:
            n += 3 * D * self.d_ff
        return n

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV-cache bytes per token per sequence (serving cost model input)."""
        if self.family == "ssm":
            return 0  # constant-size state, not per-token
        per_layer = 2 * self.num_kv_heads * self.head_dim * dtype_bytes
        if self.family == "hybrid":
            n_attn = (self.num_layers // self.shared_attn_every) if self.shared_attn_every else 0
            return n_attn * per_layer
        if self.local_global_alternating:
            # local layers cap at sliding_window; count global layers only
            # (amortized per-token for long contexts)
            return (self.num_layers // 2) * per_layer
        return self.num_layers * per_layer

    def state_bytes(self, dtype_bytes: int = 4) -> int:
        """Fixed-size recurrent state bytes per sequence (SSM/hybrid)."""
        n = 0
        if self.family == "ssm":
            H = self.d_model // self.rwkv.head_size
            n = self.num_layers * (H * self.rwkv.head_size ** 2 + 2 * self.d_model)
        elif self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * self.d_model
            nheads = d_in // s.head_dim
            conv_dim = d_in + 2 * s.n_groups * s.d_state
            n = self.num_layers * (nheads * s.head_dim * s.d_state + conv_dim * (s.d_conv - 1))
        return n * dtype_bytes


# --------------------------------------------------------------------------
# Input shapes (assigned; every arch runs its applicable subset)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# Archs allowed to run long_500k (sub-quadratic / bounded-KV; see DESIGN.md).
LONG_CONTEXT_ARCHS = ("rwkv6-3b", "zamba2-2.7b", "gemma2-9b")

ARCH_IDS = (
    "stablelm-3b", "glm4-9b", "qwen2-1.5b", "gemma2-9b", "rwkv6-3b",
    "musicgen-large", "zamba2-2.7b", "moonshot-v1-16b-a3b",
    "qwen3-moe-235b-a22b", "pixtral-12b",
)


def arch_shape_cells(include_multipod: bool = False) -> list[tuple[str, str]]:
    """All applicable (arch, shape) dry-run cells."""
    cells = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                continue
            cells.append((arch, shape))
    return cells


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(name)}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def shape_for(name: str) -> ShapeSpec:
    return SHAPES[name]
