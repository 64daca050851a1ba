"""Dispatch for the kernels of the solve path (the counterpart of
``repro/kernels/ops.py``).

A tensor on the card launches the hand-written CUDA kernel, or raises;
a tensor on the CPU runs the kernel's plain PyTorch version.  There is
no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels import KernelConfig
from .gram import gram_cuda, gram_plain
from .kmv import kmv_cuda, kmv_plain


def _on_card(A: torch.Tensor, name: str) -> bool:
    if A.device.type == "cuda":
        return True
    if A.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {A.device}")


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


def make_solver_gram_fn():
    """``gram_fn`` for the solvers' materialized-slab (``slab_free=False``)
    path, with ``core.kernels.gram_slab``'s signature: the gram kernel on
    the card, its plain version on the CPU."""

    def fn(A, B, cfg):
        return gram(A, B, cfg).to(A.dtype)

    return fn
