"""Dispatch for the port's kernels (the counterpart of
``repro/kernels/ops.py``): those of the solve path and the LM's flash
attention (forward and backward) and RMSNorm.

A tensor on the card launches the hand-written CUDA kernel, or raises;
a tensor on the CPU runs the kernel's plain PyTorch version.  There is
no fallback from one to the other.  The LM's kernels go through
``torch.autograd.Function``s (``FlashAttention``, ``RMSNorm``) on both
devices, so the CPU runs the same autograd wiring as the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.kernels import KernelConfig
from ._launch import on_card as _on_card
from .flash_attention import (FlashAttention, flash_attention,
                              flash_bwd_cuda, flash_bwd_plain)
from .gram import gram_cuda, gram_plain
from .kmv import kmv_cuda, kmv_plain
from .kmv_stream import (gather_rows_cuda, gather_rows_plain,
                         kmv_stream_cuda, kmv_stream_full_cuda,
                         kmv_stream_full_plain, kmv_stream_plain)
from .rmsnorm import RMSNorm


def kmv(A: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
        cfg: KernelConfig,
        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``K(A, B)^T X`` without the m x r slab: (r,) / (r, c)."""
    fn = kmv_cuda if _on_card(A, "kmv") else kmv_plain
    return fn(A, B, X, cfg, out_dtype)


def gram(A: torch.Tensor, B: torch.Tensor, cfg: KernelConfig,
         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``K(A, B) = epilogue(A B^T)``: (m, r)."""
    fn = gram_cuda if _on_card(A, "gram") else gram_plain
    return fn(A, B, cfg, out_dtype)


def _stream_on_card(Xc: torch.Tensor, B: torch.Tensor, name: str) -> bool:
    """The streamed kernels run on the card when the data is in pinned
    host memory and the device-side operand on the card, and plainly
    when everything is on the CPU; anything else raises — in particular
    pageable host data on the card path, whose copies would serialise
    the pipe."""
    if Xc.device.type != "cpu":
        raise ValueError(f"{name}: the chunked data must live in host "
                         f"memory, got {Xc.device}")
    if B.device.type == "cuda":
        if not Xc.is_pinned():
            raise ValueError(f"{name}: the chunked data must be pinned "
                             f"(page-locked) host memory on the card path")
        return True
    if B.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {B.device}")


def kmv_stream(Xc: torch.Tensor, B: torch.Tensor, Xvc: torch.Tensor,
               cfg: KernelConfig, out_dtype: torch.dtype = torch.float32,
               m: Optional[int] = None) -> torch.Tensor:
    """``K(A, B)^T X`` over host-resident chunks ``Xc (nc, cr, n)`` with
    the right-hand side chunked alike, ``Xvc (nc, cr, c)``, on B's
    device; rows at or past ``m`` are left out.  (r, c)."""
    on_card = _stream_on_card(Xc, B, "kmv_stream")
    if not on_card and Xvc.device.type != "cpu":
        raise ValueError(f"kmv_stream: Xvc on {Xvc.device} but B on the "
                         f"CPU")
    fn = kmv_stream_cuda if on_card else kmv_stream_plain
    return fn(Xc, B, Xvc, cfg, out_dtype, m=m)


def kmv_stream_full(Xc: torch.Tensor, Xvc: torch.Tensor, cfg: KernelConfig,
                    m: Optional[int] = None) -> torch.Tensor:
    """``K(A, A) X`` for the A of host-resident chunks ``Xc (nc, cr, n)``,
    X chunked alike as ``Xvc (nc, cr, c)``, on Xvc's device: the
    symmetric pipe on the card; rows at or past ``m`` are left out.
    (m, c) f32."""
    on_card = _stream_on_card(Xc, Xvc, "kmv_stream_full")
    fn = kmv_stream_full_cuda if on_card else kmv_stream_full_plain
    return fn(Xc, Xvc, cfg, m=m)


def gather_rows(Xc: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of host-resident chunks ``Xc``, on idx's device."""
    on_card = _stream_on_card(Xc, idx, "gather_rows")
    return (gather_rows_cuda if on_card else gather_rows_plain)(Xc, idx)


def make_solver_gram_fn():
    """``gram_fn`` for the solvers' materialized-slab (``slab_free=False``)
    path, with ``core.kernels.gram_slab``'s signature: the gram kernel on
    the card, its plain version on the CPU."""

    def fn(A, B, cfg):
        return gram(A, B, cfg).to(A.dtype)

    return fn


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: Optional[float] = None):
    """Flash attention forward over (BH, S|T, hd): ``(o, lse)``, through
    ``FlashAttention`` (the kernel on the card, its plain version on the
    CPU), so ``o`` is differentiable."""
    return FlashAttention.apply(q, k, v, causal, scale)


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
              causal: bool = True, scale: Optional[float] = None):
    """Flash attention backward: ``(dq, dk, dv)`` from the forward's
    ``lse`` and ``delta = sum(do * o, -1)``; the dq and dkv kernels on the
    card, their plain version on the CPU (``FlashAttention.backward``
    calls this)."""
    fn = flash_bwd_cuda if _on_card(q, "flash_bwd") else flash_bwd_plain
    return fn(q, k, v, do, lse, delta, causal, scale)


def sdpa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool = True) -> torch.Tensor:
    """Differentiable flash attention on (B, S, H, hd)-layout tensors (the
    model's convention); returns (B, S, H, hdv).  K/V must already be
    head-repeated (GQA)."""
    B, S, H, hd = q.shape
    T, hdv = k.shape[1], v.shape[-1]
    qt = q.transpose(1, 2).reshape(B * H, S, hd)
    kt = k.transpose(1, 2).reshape(B * H, T, hd)
    vt = v.transpose(1, 2).reshape(B * H, T, hdv)
    o = flash_attention(qt, kt, vt, causal)
    return o.reshape(B, H, S, hdv).transpose(1, 2)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis of x (any leading shape), in x's dtype,
    through ``RMSNorm`` (the kernel on the card, its plain version on the
    CPU; the backward is plain PyTorch on both)."""
    return RMSNorm.apply(x, scale, eps)
