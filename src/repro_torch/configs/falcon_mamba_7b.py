"""Falcon-Mamba 7B [ssm] — pure Mamba-1, attention-free
[arXiv:2410.05355]."""
import dataclasses

from repro_torch.models.config import MAMBA1, ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    pattern=(MAMBA1,),
    attn_type="none",
    ssm_state=16,
    expand=2,
    d_conv=4,
    tie_embeddings=True,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, vocab_size=512, ssm_state=8)
