"""Unified model configuration covering the 10 assigned architectures
(the counterpart of ``repro/models/config.py``, with the same fields and
the same analytic parameter count).

One frozen dataclass; every architecture file in ``repro_torch/configs``
fills in the exact published numbers.  The model builder
(``models/lm.py``) reads only this config.  ``activation_dtype`` is a
torch dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

DENSE = "dense"        # attention + MLP block
MOE = "moe"            # attention + MoE block
MAMBA1 = "mamba1"      # Mamba-1 SSM block (attention-free)
MAMBA2 = "mamba2"      # Mamba-2 (SSD) block
ATTN = "attn"          # attention-only block (used by hybrid patterns)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 128

    # Block layout: a repeating pattern of block kinds. The full stack is
    # pattern * (n_layers // len(pattern)). Homogeneous patterns scan over
    # stacked per-layer params; hybrid patterns scan over super-blocks.
    pattern: Tuple[str, ...] = (DENSE,)

    # Attention options
    attn_type: str = "gqa"            # "gqa" | "mla" | "none"
    qk_norm: bool = False             # qwen3
    rope_theta: float = 10000.0
    mrope: bool = False               # qwen2-vl M-RoPE (3 position streams)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    causal: bool = True               # False for encoder stacks

    # MLA (deepseek)
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    v_head_dim: int = 0               # defaults to head_dim

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                 # expert hidden dim (d_ff if 0)
    dense_residual_ff: int = 0        # arctic: parallel dense MLP hidden dim
    router_noise: float = 0.0
    moe_impl: str = "dense"           # "dense" | "capacity"
    capacity_factor: float = 1.25

    # SSM (mamba)
    ssm_state: int = 16
    ssm_impl: str = "scan"            # "scan" | "ssd" (matmul-form
                                      # SSD block decomposition, mamba2)
    d_conv: int = 4
    expand: int = 2                   # d_inner = expand * d_model
    mamba_headdim: int = 64           # mamba2 head dim

    # Hybrid (zamba2): a single SHARED attention block applied at the end
    # of each pattern period (weights reused across periods).
    shared_attn_every: int = 0        # 0 = no shared block

    # Encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500           # whisper 30s @ 50Hz after conv stub
    cross_attention: bool = False

    # Frontend stubs ([audio]/[vlm]): inputs arrive as precomputed
    # embeddings of width d_model instead of token ids.
    embedding_inputs: bool = False    # whisper encoder side

    norm: str = "rmsnorm"             # "rmsnorm" | "layernorm"
    ce_impl: str = "gather"           # "gather" | "onehot" (onehot
                                      # keeps the CE local under V-sharding)
    attn_impl: str = "naive"          # "naive" | "flash" (the flash
                                      # kernels, forward and backward:
                                      # csrc/flash_{fwd,bwd}.cu)
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"               # "full" | "none"

    def __post_init__(self):
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern length {len(self.pattern)}")

    # ---- derived ----
    @property
    def activation_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"{self.name}: unknown dtype {self.dtype!r}")
        return dt

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def v_head(self) -> int:
        return self.v_head_dim or self.head_dim

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def moe_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def is_attention_free(self) -> bool:
        return (all(p in (MAMBA1, MAMBA2) for p in self.pattern)
                and self.shared_attn_every == 0)

    @property
    def has_ssm(self) -> bool:
        return any(p in (MAMBA1, MAMBA2) for p in self.pattern)

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k shape (decode cost is O(1) in history
        for SSM blocks; hybrid shared-attn decode is O(S) linear)."""
        return self.has_ssm

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-flops)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        total = v * d                                    # embed
        if not self.tie_embeddings:
            total += v * d                               # lm head
        per_kind = {}
        qdim = self.n_heads * (self.head_dim + (self.qk_rope_head_dim
                               if self.attn_type == "mla" else 0))
        attn = 0
        if self.attn_type == "gqa":
            attn = (d * self.n_heads * self.head_dim          # q
                    + 2 * d * self.n_kv_heads * self.head_dim  # k, v
                    + self.n_heads * self.head_dim * d)        # o
        elif self.attn_type == "mla":
            attn = (d * qdim                                   # q proj
                    + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                    + self.kv_lora_rank * self.n_heads * (
                        self.head_dim + self.v_head)
                    + self.n_heads * self.v_head * d)
        mlp = 3 * d * f                                        # gated mlp
        per_kind[DENSE] = attn + mlp
        per_kind[ATTN] = attn
        moe = (self.n_experts * 3 * d * self.moe_ff
               + self.n_shared_experts * 3 * d * self.moe_ff
               + d * self.n_experts)
        if self.dense_residual_ff:
            moe += 3 * d * self.dense_residual_ff
        per_kind[MOE] = attn + moe
        di = self.d_inner
        per_kind[MAMBA1] = (2 * d * di + di * self.d_conv
                            + di * (2 * self.ssm_state + 2)  # x_proj(B,C),dt
                            + di * self.ssm_state + di       # A, D
                            + di * d)
        nh = di // self.mamba_headdim
        per_kind[MAMBA2] = (d * (2 * di + 2 * self.ssm_state + nh)
                            + di * self.d_conv + 2 * nh + di * d)
        for p in self.pattern:
            total += self.n_periods * per_kind[p]
        if self.shared_attn_every:
            total += per_kind[ATTN]
        if self.encoder_layers:
            total += self.encoder_layers * per_kind[DENSE]
            if self.cross_attention:  # decoder cross-attn blocks
                total += self.n_layers * attn
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k + shared experts)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        inactive = (self.n_experts - self.top_k) * 3 * self.d_model * self.moe_ff
        n_moe = sum(1 for p in self.pattern if p == MOE) * self.n_periods
        return full - n_moe * inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
