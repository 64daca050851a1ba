"""Whisper tiny [audio] — encoder-decoder, conv frontend stubbed
[arXiv:2212.04356].

``input_specs()`` supplies precomputed frame embeddings (B, 1500, 384) in
place of the log-mel + conv1d frontend, per the assignment."""
import dataclasses

from repro_torch.models.config import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    n_layers=4,                 # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    pattern=(DENSE,),
    encoder_layers=4,
    encoder_seq=1500,
    cross_attention=True,
    norm="layernorm",
    tie_embeddings=True,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    d_ff=128, vocab_size=512, encoder_layers=2, encoder_seq=64)
