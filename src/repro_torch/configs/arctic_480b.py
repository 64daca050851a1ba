"""Snowflake Arctic 480B [moe] — 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base].

Assigned numbers: 35L d_model=7168 56H (kv=8) d_ff=4864 (expert hidden)
vocab=32000.  The dense-residual branch runs a parallel MLP of the same
hidden dim alongside the MoE (arctic's dense+MoE hybrid residual)."""
import dataclasses

from repro_torch.models.config import MOE, ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    pattern=(MOE,),
    n_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_residual_ff=4864,
    moe_impl="capacity",   # the JAX package's default; "dense" is the
    # paper-baseline dispatch
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=128, moe_d_ff=128, dense_residual_ff=128, vocab_size=512,
    n_experts=8, top_k=2)
