"""GQA attention (covers MHA and MQA) with qk-norm (Qwen3) and RoPE: causal
full-sequence attention (training and prefill) and single-token decode
against a KV cache (the counterpart of the GQA part of
``repro/models/attention.py``).

Softmax and logit math in f32; products in the config's compute dtype.
With ``attn_impl="flash"`` causal full-sequence attention (training and
prefill) goes through ``kernels.ops.sdpa_flash``, differentiable: the
flash forward kernel, and in the backward the dq and dkv kernels;
``"naive"`` is plain PyTorch, as in the JAX package.  With ``tp`` (a
``models.sharding.Sharded``) the full-sequence forward runs
tensor-parallel over ``model``: the projections are this rank's heads
(column-parallel ``wq``, ``wk``, ``wv``), attention runs on them, and
the row-parallel ``wo`` product is summed over the ranks (``tp.reduce``);
the input passes through ``tp.copy``, whose backward sums its gradient.
MLA (DeepSeek), M-RoPE (Qwen2-VL) and cross-attention (Whisper) are not
ported yet and raise.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops
from .config import ModelConfig
from .layers import apply_rope, dense_init, init_norm, rmsnorm

NEG_INF = -2.0e38

UNPORTED_MLA = "MLA attention is not ported yet (ROADMAP A13.3)"
UNPORTED_MROPE = "M-RoPE is not ported yet (ROADMAP A13.8)"


def init_gqa(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": dense_init(gen, d, (h, hd)),
         "wk": dense_init(gen, d, (kv, hd)),
         "wv": dense_init(gen, d, (kv, hd)),
         "wo": dense_init(gen, h * hd, d).reshape(h, hd, d)}
    if cfg.qk_norm:
        p["q_norm"] = init_norm(hd, gen.device)
        p["k_norm"] = init_norm(hd, gen.device)
    return p


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, T, kv, hd) -> (B, T, kv * n_rep, hd), each kv head repeated
    n_rep times in place (``jnp.repeat`` on the head axis)."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _sdpa(q, k, v, mask, dtype):
    """q: (B,S,H,hd) k/v: (B,T,H,hd); mask: (S,T) or (B,S,T) bool or None."""
    hd = q.shape[-1]
    logits = torch.einsum("bshd,bthd->bhst", q, k).float() * hd ** -0.5
    if mask is not None:
        mask = mask[None, None] if mask.ndim == 2 else mask[:, None]
        logits = torch.where(mask, logits,
                             torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _project(x, w, dtype):
    """``einsum("bsd,dhk->bshk")``: (B, S, D) x (D, H, k) -> (B, S, H, k)."""
    return torch.einsum("bsd,dhk->bshk", x, w.to(dtype))


def gqa_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, rope_cache=None,
                tp=None) -> torch.Tensor:
    """Full-sequence self-attention (training and prefill): x (B, S, D) ->
    (B, S, D), causal unless ``cfg.causal`` is False; over this rank's
    heads with ``tp`` (module docstring)."""
    if cfg.mrope:
        raise NotImplementedError(UNPORTED_MROPE)
    dtype = x.dtype
    if tp is not None:
        x = tp.copy(x)
    q = _project(x, p["wq"], dtype)
    k = _project(x, p["wk"], dtype)
    v = _project(x, p["wv"], dtype)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    q = apply_rope(q, positions, cfg.rope_theta, cache=rope_cache)
    k = apply_rope(k, positions, cfg.rope_theta, cache=rope_cache)
    k = _repeat_kv(k, cfg.n_heads // cfg.n_kv_heads)
    v = _repeat_kv(v, cfg.n_heads // cfg.n_kv_heads)
    if cfg.attn_impl == "flash" and cfg.causal:
        out = ops.sdpa_flash(q, k, v, causal=True)
    else:
        mask = None
        if cfg.causal:
            S, T = q.shape[1], k.shape[1]
            mask = torch.ones((S, T), dtype=torch.bool,
                              device=x.device).tril()
        out = _sdpa(q, k, v, mask, dtype)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dtype))
    return out if tp is None else tp.reduce(out)


def gqa_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
               cache: Tuple[torch.Tensor, torch.Tensor], pos: torch.Tensor):
    """One-token decode.  x: (B, 1, D); cache: (k, v), each (B, S_max, kv,
    hd); pos: (B,) the position each row writes.  Returns (out, new
    cache); the caches are new tensors (the inputs are not written), and
    a ``pos`` at or past S_max writes nothing, as the JAX one-hot does."""
    if cfg.mrope:
        raise NotImplementedError(UNPORTED_MROPE)
    dtype = x.dtype
    q = _project(x, p["wq"], dtype)
    k_new = _project(x, p["wk"], dtype)
    v_new = _project(x, p["wv"], dtype)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k_new = rmsnorm(p["k_norm"], k_new)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)

    ck, cv = cache
    slots = torch.arange(ck.shape[1], device=ck.device)
    at = (slots[None] == pos[:, None])[..., None, None]      # (B, S, 1, 1)
    ck = torch.where(at, k_new.to(ck.dtype), ck)
    cv = torch.where(at, v_new.to(cv.dtype), cv)

    k = _repeat_kv(ck.to(dtype), cfg.n_heads // cfg.n_kv_heads)
    v = _repeat_kv(cv.to(dtype), cfg.n_heads // cfg.n_kv_heads)
    valid = slots[None] <= pos[:, None]                      # (B, S)
    out = _sdpa(q, k, v, valid[:, None, :], dtype)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dtype)), (ck, cv)


def init_gqa_cache(cfg: ModelConfig, batch: int, seq: int,
                   dtype: torch.dtype, device):
    shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


# dispatchers ---------------------------------------------------------

def _gqa_only(cfg: ModelConfig) -> None:
    if cfg.attn_type == "mla":
        raise NotImplementedError(UNPORTED_MLA)


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> dict:
    _gqa_only(cfg)
    return init_gqa(gen, cfg)


def attention_forward(p, cfg, x, positions, rope_cache=None, tp=None):
    _gqa_only(cfg)
    return gqa_forward(p, cfg, x, positions, rope_cache=rope_cache, tp=tp)


def attention_decode(p, cfg, x, cache, pos):
    _gqa_only(cfg)
    return gqa_decode(p, cfg, x, cache, pos)


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype: torch.dtype,
               device):
    _gqa_only(cfg)
    return init_gqa_cache(cfg, batch, seq, dtype, device)
