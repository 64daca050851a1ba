"""Plain oracles for the kernels of this package (the counterpart of
``repro/kernels/ref.py``): the gram and KMV oracles materialize the
kernel slab in f32, the attention oracles (forward and backward) the
whole (S, T) softmax."""
from __future__ import annotations

import torch

from repro_torch.core.kernels import KernelConfig, gram_slab


def gram_ref(A: torch.Tensor, B: torch.Tensor, cfg: KernelConfig,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Oracle for the gram kernel: ``epilogue(A @ B^T)`` in f32."""
    return gram_slab(A.float(), B.float(), cfg).to(out_dtype)


def kmv_ref(A: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
            cfg: KernelConfig,
            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Oracle for the KMV kernel: ``K(A, B)^T X`` with the slab
    materialized in f32 (the thing the kernel must never do)."""
    U = gram_slab(A.float(), B.float(), cfg)
    return (U.T @ X.float()).to(out_dtype)


NEG = -1e30          # the causal fill of the flash kernel and its oracle


def attention_scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
                     scale=None) -> torch.Tensor:
    """``q k^T * scale`` in f32 over (BH, S, hd) / (BH, T, hd), with the
    entries above the diagonal (``col > row``) set to -1e30 when causal."""
    hd = q.shape[-1]
    scale = scale if scale is not None else hd ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        S, T = q.shape[1], k.shape[1]
        mask = torch.ones((S, T), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG))
    return s


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale=None,
                        with_lse: bool = False):
    """Oracle for the flash kernel: the whole (S, T) softmax in f32.
    q/k/v: (BH, S|T, hd); returns o (BH, S, hdv) in q's dtype, and with
    ``with_lse`` also the row log-sum-exp (BH, S) in f32, as ``(o, lse)``
    (the kernel's plain version, ``flash_fwd_plain``)."""
    s = attention_scores(q, k, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bqk,bkd->bqd", p / l, v.float()).to(q.dtype)
    return (o, (m + torch.log(l))[..., 0]) if with_lse else o


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor,
                            causal: bool = True, scale=None):
    """Oracle for the flash backward kernels: ``(dq, dk, dv)`` through the
    whole (S, T) softmax in f32, from the forward's saved ``lse`` and
    ``delta = sum(do * o, -1)`` (both (BH, S) f32), as the TPU kernels
    compute them (``p = exp(s - lse)``, ``ds = p (do v^T - delta)
    scale``); each result is rounded once, to its input's dtype."""
    hd = q.shape[-1]
    scale = scale if scale is not None else hd ** -0.5
    p = torch.exp(attention_scores(q, k, causal, scale) - lse[..., None])
    dof = do.float()
    dp = torch.einsum("bqd,bkd->bqk", dof, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float())
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Oracle for the RMSNorm kernel (``models/layers.rmsnorm`` of the JAX
    package): statistics in f32, result in x's dtype."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)
