"""Gradient compression for the data-parallel sync: int8 block
quantization with error feedback (the counterpart of
``repro/optim/compression.py``).

Composable with the s-step deferred sync (``train.make_defer_train_step``):
the deferred accumulator is quantized once per sync instead of once per
microbatch.  The arithmetic follows the JAX package operation by
operation in f32 (``torch.round`` rounds half to even, as ``jnp.round``
does), so ``q`` and ``scale`` equal JAX's bit for bit on the same input.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.tree import leaves, unflatten

BLOCK = 256


def _blockify(x: torch.Tensor):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK), pad


def block_scale(block_max: torch.Tensor) -> torch.Tensor:
    """The quantization step of a block from its ``max |x|``."""
    return block_max / 127.0 + 1e-12


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 ``clip(round(x / scale), -127, 127)``, ``scale`` broadcast."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def compress_int8(x: torch.Tensor):
    """-> (q: int8 blocks, scale: f32 per block, meta) with |err| <=
    scale / 2."""
    blocks, pad = _blockify(x.float())
    scale = block_scale(blocks.abs().amax(dim=1, keepdim=True))
    return quantize(blocks, scale), scale, (tuple(x.shape), pad)


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, meta):
    shape, pad = meta
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compress_one(g: torch.Tensor, r: torch.Tensor):
    """(dequantized ``g + r`` in g's dtype, the new residual)."""
    tot = g.float() + r
    deq = decompress_int8(*compress_int8(tot))
    return deq.to(g.dtype), tot - deq


def error_feedback_compress(grads, residual):
    """Quantize (grads + residual); the quantization error becomes the new
    residual (error feedback keeps the compressed SGD unbiased over time).
    Returns (dequantized grads, new residual), trees shaped like
    ``grads``.  The round trip models the int8 payload exactly."""
    pairs = [compress_one(g, r)
             for g, r in zip(leaves(grads), leaves(residual))]
    return (unflatten(grads, [d for d, _ in pairs]),
            unflatten(grads, [r for _, r in pairs]))


def init_residual(params):
    """Zero f32 residuals shaped like ``params``."""
    return unflatten(params, [torch.zeros_like(p, dtype=torch.float32)
                              for p in leaves(params)])
