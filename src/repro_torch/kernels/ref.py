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
                        with_lse: bool = False, round_p: bool = False):
    """Oracle for the flash kernel: the whole (S, T) softmax in f32.
    q/k/v: (BH, S|T, hd); returns o (BH, S, hdv) in q's dtype, and with
    ``with_lse`` also the row log-sum-exp (BH, S) in f32, as ``(o, lse)``
    (the kernel's plain version, ``flash_fwd_plain``).  ``round_p``
    rounds ``p = exp(s - max)`` to v's dtype before the PV product and
    divides by the sum of the unrounded p afterwards, the TPU kernel's
    rounding (``flash_attention.py:64-68``) over one k tile."""
    s = attention_scores(q, k, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if round_p:
        o = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(),
                         v.float()) / l
    else:
        o = torch.einsum("bqk,bkd->bqd", p / l, v.float())
    o = o.to(q.dtype)
    return (o, (m + torch.log(l))[..., 0]) if with_lse else o


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor,
                            causal: bool = True, scale=None,
                            round_p: bool = False, round_dq: bool = False):
    """Oracle for the flash backward kernels: ``(dq, dk, dv)`` through the
    whole (S, T) softmax in f32, from the forward's saved ``lse`` and
    ``delta = sum(do * o, -1)`` (both (BH, S) f32), as the TPU kernels
    compute them (``p = exp(s - lse)``, ``ds = p (do v^T - delta)
    scale``); each result is rounded once, to its input's dtype.
    ``round_p`` rounds p and ds to the inputs' dtype in the dv and dk
    products, as the tensor-core dkv kernel does (ROADMAP C5); dq keeps
    f32 ds unless ``round_dq``, which rounds ds to k's dtype in the dq
    product, as the tensor-core dq kernel does (ROADMAP C7)."""
    hd = q.shape[-1]
    scale = scale if scale is not None else hd ** -0.5
    p = torch.exp(attention_scores(q, k, causal, scale) - lse[..., None])
    dof = do.float()
    dp = torch.einsum("bqd,bkd->bqk", dof, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bqk,bkd->bqd",
                      ds.to(k.dtype).float() if round_dq else ds, k.float())
    if round_p:
        p, ds = p.to(do.dtype).float(), ds.to(q.dtype).float()
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# Unit roundoffs: bf16 keeps 8 significant bits, f32 24.
U_BF16, U_F32 = 2.0 ** -8, 2.0 ** -24
# The JAX package's bf16 bound (tests/test_flash_attention.py:49), which no
# derived bound may exceed.
JAX_BF16_TOL = 3e-2


def _bf16_bound(terms: torch.Tensor, want: torch.Tensor,
                n: int) -> torch.Tensor:
    """Elementwise tolerance of a bf16 result that is an f32 sum of n
    products, each with one factor rounded to bf16 (relative U_BF16), then
    rounded once to bf16 on both sides (up to 2 U_BF16 of |want|):
    ``(U_BF16 + 2 n U_F32) terms + (2 U_BF16 + 2 n U_F32) |want|``, with
    ``terms`` the sum of the products' magnitudes (plus the smallest
    normal f32, so that an exact 0 passes and nothing else does where the
    sum is 0); never looser than the JAX package's bf16 bound."""
    f32 = 2 * n * U_F32              # the f32 sums, in any order
    want = want.float().abs()
    bound = ((U_BF16 + f32) * terms + (2 * U_BF16 + f32) * want
             + torch.finfo(torch.float32).tiny)
    return torch.minimum(bound, JAX_BF16_TOL * (1 + want))


def flash_fwd_bf16_tolerance(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             causal: bool = True,
                             scale=None) -> torch.Tensor:
    """Derived elementwise bound on |o_kernel - o| for the tensor-core
    forward against the plain version's ``o`` (f32 p): the kernel rounds
    each p / l to bf16 (relative U_BF16), so o moves by at most U_BF16
    sum_j (p_j / l) |v_j|, plus the f32 sums and both final roundings."""
    s = attention_scores(q, k, causal, scale)
    w = torch.softmax(s, -1)
    terms = torch.einsum("bqk,bkd->bqd", w, v.float().abs())
    return _bf16_bound(terms, o, k.shape[1])


def flash_dkv_bf16_tolerance(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor,
                             lse: torch.Tensor, delta: torch.Tensor,
                             dk: torch.Tensor, dv: torch.Tensor,
                             causal: bool = True, scale=None):
    """Derived elementwise bounds ``(on dk, on dv)`` for the tensor-core
    dkv kernel against the plain version's ``dk, dv`` (f32 p and ds): it
    rounds each p and ds to bf16, so dv moves by at most U_BF16 sum_q p
    |do| and dk by U_BF16 sum_q |ds| |q|, plus the f32 sums and both
    final roundings."""
    hd = q.shape[-1]
    scale = scale if scale is not None else hd ** -0.5
    p = torch.exp(attention_scores(q, k, causal, scale) - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    ds = (p * (dp - delta[..., None]) * scale).abs()
    t_dk = torch.einsum("bqk,bqd->bkd", ds, q.float().abs())
    t_dv = torch.einsum("bqk,bqd->bkd", p, do.float().abs())
    S = q.shape[1]
    return _bf16_bound(t_dk, dk, S), _bf16_bound(t_dv, dv, S)


def flash_dq_bf16_tolerance(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor,
                            dq: torch.Tensor, causal: bool = True,
                            scale=None) -> torch.Tensor:
    """Derived elementwise bound on |dq_kernel - dq| for the tensor-core dq
    kernel against the plain version's ``dq`` (f32 ds): it rounds each ds
    to bf16, so dq moves by at most U_BF16 sum_k |ds| |k|, plus the f32
    sums and both final roundings (``_bf16_bound``).

    Unlike dk, a row of dq can be a sum of few ds that are each a
    cancellation residue: at the first causal rows dp = do . v is nearly
    delta = do . o, so the f32 sums of the score products, which the
    tensor cores take in another order than the plain version, move ds by
    far more than its own size.  Both sides sum the same exact products
    of bf16 values (hd of them for s and dp, an error of at most e = 2 hd
    U_F32 of their magnitudes, both sides together), so ds moves by at
    most scale (|dp - delta| dp_rel + e sum_d |do| |v|) p, with p's
    relative error dp_rel = e scale sum_d |q| |k| (through s) + 3 U_F32
    (|s| + |lse|) + 4 U_F32 (the exp2 argument's roundings and exp2
    itself), plus 4 U_F32 |ds| for the products that form ds; dq adds
    that times |k| summed over the row.  The whole bound stays capped at
    the JAX package's bf16 bound."""
    hd = q.shape[-1]
    scale = scale if scale is not None else hd ** -0.5
    s = attention_scores(q, k, causal, scale)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    ds = (p * (dp - delta[..., None]) * scale).abs()
    ka = k.float().abs()
    terms = torch.einsum("bqk,bkd->bqd", ds, ka)
    e = 2 * hd * U_F32
    p_rel = (e * scale * torch.einsum("bqd,bkd->bqk", q.float().abs(), ka)
             + 3 * U_F32 * (s.abs() + lse.abs()[..., None]) + 4 * U_F32)
    d_ds = (scale * p * ((dp - delta[..., None]).abs() * p_rel
                         + e * torch.einsum("bqd,bkd->bqk", do.float().abs(),
                                            v.float().abs()))
            + 4 * U_F32 * ds)
    extra = torch.einsum("bqk,bkd->bqd", d_ds, ka)
    return torch.minimum(_bf16_bound(terms, dq, k.shape[1]) + extra,
                         JAX_BF16_TOL * (1 + dq.float().abs()))


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Oracle for the RMSNorm kernel (``models/layers.rmsnorm`` of the JAX
    package): statistics in f32, result in x's dtype."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)
