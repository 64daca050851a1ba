"""Qwen3 1.7B [dense] — qk_norm, GQA (kv=8) [hf:Qwen/Qwen3-8B family]."""
import dataclasses

from repro_torch.models.config import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    pattern=(DENSE,),
    qk_norm=True,
    rope_theta=1000000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512)
