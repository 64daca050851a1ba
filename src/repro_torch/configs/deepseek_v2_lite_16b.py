"""DeepSeek-V2-Lite 16B [moe] — MLA (kv_lora=512), 2 shared + 64 routed
experts, top-6 [arXiv:2405.04434].

Assigned numbers used verbatim: 27L d_model=2048 16H d_ff=1408 (expert
hidden dim) vocab=102400, MoE 64e top-6, MLA kv_lora_rank=512."""
import dataclasses

from repro_torch.models.config import MOE, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    pattern=(MOE,),
    attn_type="mla",
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    moe_impl="capacity",   # the JAX package's default; "dense" = baseline
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=64, moe_d_ff=64, vocab_size=512, kv_lora_rank=32,
    qk_rope_head_dim=16, n_experts=8, top_k=2, n_shared_experts=1)
