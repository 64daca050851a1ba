"""Qwen2-VL 72B [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

Backbone only per the assignment; the vision frontend is a stub —
``input_specs()`` supplies the 3-stream (temporal/height/width) M-RoPE
position ids that the frontend would produce."""
import dataclasses

from repro_torch.models.config import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    pattern=(DENSE,),
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1000000.0,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512, mrope_sections=(4, 6, 6))
