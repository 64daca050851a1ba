"""The LM workload of the port: decoders of dense, MoE and Mamba blocks
over GQA or MLA attention (with Zamba2's shared attention block,
Qwen2-VL's M-RoPE, and Whisper's encoder and cross-attention), their
training forward and loss, prefill and decode."""
from .config import ATTN, DENSE, MAMBA1, MAMBA2, MOE, SHAPES, ModelConfig, \
    ShapeConfig
from .lm import (abstract_params, check_supported, decode_step, encoder_forward, forward, init_decode_state,
                 init_params, loss_fn, prefill_cross_kv)

__all__ = ["ATTN", "DENSE", "MAMBA1", "MAMBA2", "MOE", "SHAPES",
           "ModelConfig", "ShapeConfig", "abstract_params",
           "check_supported", "decode_step",
           "encoder_forward", "forward", "init_decode_state", "init_params",
           "loss_fn", "prefill_cross_kv"]
