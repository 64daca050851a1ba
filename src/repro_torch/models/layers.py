"""Shared layers of the LM: norms, embeddings, rotary embeddings, MLP (the
counterpart of ``repro/models/layers.py``).

Plain-dictionary style, as in the JAX package: ``init_*`` returns a dict
of parameters, the apply functions take ``(params, inputs)``.  Params are
stored in f32 and cast to the compute dtype on use.  Every init draws
from an explicit ``torch.Generator`` on the device the params live on.
``rmsnorm`` goes through ``kernels.ops.rmsnorm``: the hand-written
kernel on the card, its plain version on the CPU (the JAX model's jnp
rmsnorm and the Pallas kernel compute the same function).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Shape = Union[int, Tuple[int, ...]]


def dense_init(gen: torch.Generator, in_dim: int, out_shape: Shape,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal (within 2 std) fan-in init of shape (in_dim,
    *out_shape), f32, on the generator's device."""
    if isinstance(out_shape, int):
        out_shape = (out_shape,)
    std = scale if scale is not None else in_dim ** -0.5
    w = torch.empty((in_dim, *out_shape), dtype=torch.float32,
                    device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(std)


# ---------------------------------------------------------------- norms ---

def init_norm(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def init_layernorm(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def init_norm_for(kind: str, d: int, device) -> dict:
    """The params of a norm of ``kind`` ("rmsnorm" or "layernorm")."""
    return init_norm(d, device) if kind == "rmsnorm" else \
        init_layernorm(d, device)


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, statistics in f32, result in x's dtype:
    the RMSNorm kernel on the card."""
    return ops.rmsnorm(x, p["scale"], eps)


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


def apply_norm(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


# ----------------------------------------------------------------- MLP ----

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int) -> dict:
    return {"wi_gate": dense_init(gen, d_model, d_ff),
            "wi_up": dense_init(gen, d_model, d_ff),
            "wo": dense_init(gen, d_ff, d_model)}


def mlp(p: dict, x: torch.Tensor, dtype: torch.dtype,
        tp=None) -> torch.Tensor:
    """The gated MLP; with ``tp`` (a ``models.sharding.Sharded``) over this
    rank's d_ff columns: ``x`` through ``tp.copy``, the row-parallel
    ``wo`` product summed over ``model`` (``tp.reduce``)."""
    if tp is not None:
        x = tp.copy(x)
    gate = x @ p["wi_gate"].to(dtype)
    up = x @ p["wi_up"].to(dtype)
    out = (F.silu(gate) * up) @ p["wo"].to(dtype)
    return out if tp is None else tp.reduce(out)


# ------------------------------------------------------------- rotary -----

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def make_rope_cache(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin), each (..., S, 1, hd/2) f32, computed once per forward
    (the positions are the same for every layer)."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs
    angles = angles[..., None, :]                  # broadcast over heads
    return torch.cos(angles), torch.sin(angles)


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     -1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: Optional[torch.Tensor],
               theta: float, cache=None) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integers (ignored when a
    precomputed ``cache`` = (cos, sin) is given)."""
    if cache is None:
        cache = make_rope_cache(positions, x.shape[-1], theta)
    return _rotate(x, *cache)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL's M-RoPE.  x: (B, S, H, hd); positions3: (3, B, S), the
    temporal, height and width position streams.  The hd / 2 rotary
    frequencies are split into ``sections`` (their sum is hd / 2), each
    rotated by its own stream."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum "
                         f"to head_dim / 2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)
    # output_size: the length is known on the host, so neither the card
    # (a sync) nor a meta tensor (the dry run) has to read the repeats
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device), output_size=hd // 2)
    pos = positions3.float()[sec_id]                 # (hd/2, B, S)
    angles = (pos.movedim(0, -1) * freqs)[..., None, :]  # (B, S, 1, hd/2)
    return _rotate(x, torch.cos(angles), torch.sin(angles))


# ------------------------------------------------------------ embedding ---

def init_embedding(gen: torch.Generator, vocab: int, d_model: int) -> dict:
    table = torch.empty((vocab, d_model), dtype=torch.float32,
                        device=gen.device)
    table.normal_(0.0, 1.0, generator=gen)
    return {"table": table.mul_(0.02)}


def embed(p: dict, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The rows of the table at ``tokens``, in ``dtype`` (the cast is
    elementwise, so casting the gathered rows equals gathering from the
    cast table, without casting all of it)."""
    return p["table"][tokens].to(dtype)


def unembed(p: dict, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Logits through the vocab projection, product in ``dtype``, f32 out."""
    return (x.to(dtype) @ p["table"].to(dtype).T).float()
