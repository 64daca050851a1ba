"""Plain oracles for the kernels of this package (the counterpart of
``repro/kernels/ref.py``): both materialize the kernel slab in f32."""
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
