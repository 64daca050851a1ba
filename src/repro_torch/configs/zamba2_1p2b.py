"""Zamba2 1.2B [hybrid] — Mamba2 backbone + SHARED attention block applied
every other layer (weights reused) [arXiv:2411.15242].

Assigned numbers: 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000
ssm_state=64.  We model the layout as 19 periods of (mamba2, mamba2) with
the shared attention+MLP block at each period boundary; head_dim=64 so
32 heads x 64 = d_model."""
import dataclasses

from repro_torch.models.config import MAMBA2, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    pattern=(MAMBA2, MAMBA2),
    shared_attn_every=2,
    ssm_state=64,
    expand=2,
    mamba_headdim=64,
    ssm_impl="ssd",        # the JAX package's default: matmul-form SSD;
    # ssm_impl="scan" is the elementwise reference path
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, ssm_state=8, mamba_headdim=16)
