"""Yi 6B [dense] — llama-arch GQA (kv=4) [arXiv:2403.04652]."""
import dataclasses

from repro_torch.models.config import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    pattern=(DENSE,),
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512)
