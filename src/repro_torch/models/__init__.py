"""The LM workload of the port: decoders of dense or MoE blocks over GQA
or MLA attention, their training forward and loss, prefill and decode."""
from .config import ATTN, DENSE, MAMBA1, MAMBA2, MOE, SHAPES, ModelConfig, \
    ShapeConfig
from .lm import (check_supported, decode_step, forward, init_decode_state,
                 init_params, loss_fn)

__all__ = ["ATTN", "DENSE", "MAMBA1", "MAMBA2", "MOE", "SHAPES",
           "ModelConfig", "ShapeConfig", "check_supported", "decode_step",
           "forward", "init_decode_state", "init_params", "loss_fn"]
