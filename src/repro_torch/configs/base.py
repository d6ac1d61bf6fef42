"""Config schema: model architecture, input shapes and training (port of
``repro.configs.base``; the port keeps its own copy and imports nothing of
the JAX package)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    qkv_bias: bool = False
    sliding_window: int = 0      # 0 = full attention
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE freq split (t,h,w)
    norm_eps: float = 1e-5
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "swiglu"          # swiglu | gelu
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_router: str = "skipper"  # skipper (paper technique) | topk
    moe_capacity_factor: float = 1.25
    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_chunk: int = 64
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    # --- hybrid (zamba2): one shared attention block every k ssm layers ---
    shared_attn_period: int = 0
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_frames: int = 1500
    # --- numerics / memory ---
    dtype: str = "bfloat16"
    remat: bool = True
    # Megatron-style sequence parallelism on the residual stream: the
    # remat-saved per-layer activations are sharded over ("model", seq);
    # each layer all-gathers on entry. Required to fit >=100B dense models.
    seq_sharded_residual: bool = False
    # Adam moment dtype: f32 for <70B, bf16 for huge models (large-scale trick)
    opt_state_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode with a bounded / linear-state cache?"""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatches: int = 1        # gradient accumulation
    z_loss: float = 1e-4
    seed: int = 0
    checkpoint_every: int = 100
    grad_compression: str = "none"   # none | bf16 (compressed cross-device psum)
