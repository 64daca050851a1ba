"""Granite 20B [dense] — llama-arch code model, MQA (kv=1)
[arXiv:2405.04324]."""
import dataclasses

from repro_torch.models.config import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    pattern=(DENSE,),
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
    d_ff=256, vocab_size=512)
