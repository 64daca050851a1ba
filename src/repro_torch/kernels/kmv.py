"""KMV: ``U^T X`` with ``U = K(A, B)``, without the ``m x r`` slab.

The counterpart of ``repro/kernels/kmv.py`` (``kmv_pallas``).  The
kernel is ``csrc/kmv.cu``; ``kmv_cuda`` launches it and counts the
launches, ``kmv_plain`` is the plain PyTorch version of the same
function (the slab-free blocked loop of ``core.kernels.kmv_slab_free``,
in f32).  ``kernels.ops.kmv`` picks between them by device.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels import KernelConfig, kmv_slab_free
from . import build
from ._launch import (BM, BR, check_inputs, kernel_args, raise_on_error,
                      sm_count)

BLOCKS_PER_SM = 4          # grid size the m split aims for


def kmv_plain(A: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
              cfg: KernelConfig,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: the blocked slab-free contraction in f32."""
    return kmv_slab_free(A.float(), B.float(), X.float(), cfg).to(out_dtype)


def kmv_splits(m: int, r: int, sm_count: int):
    """``(splits, rows_per_split)`` of the m axis: enough row splits that
    (r tiles) x (splits) blocks fill the card, every split a whole number
    of BM-row tiles and none empty."""
    m_tiles = -(-m // BM)
    r_tiles = -(-r // BR)
    want = max(1, -(-BLOCKS_PER_SM * sm_count // r_tiles))
    tiles_per_split = -(-m_tiles // min(want, m_tiles))
    return -(-m_tiles // tiles_per_split), tiles_per_split * BM


def kmv_cuda(A: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
             cfg: KernelConfig,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the KMV kernel on the card: A (m, n), B (r, n) contiguous,
    f32 or bf16; X (m,) or (m, c).  Returns (r,) / (r, c) in
    ``out_dtype``; the sum is f32.  Never synchronises."""
    dtype_code = check_inputs("kmv", A, B)
    m, n = A.shape
    r = B.shape[0]
    vec = X.ndim == 1
    if X.ndim not in (1, 2) or X.shape[0] != m or X.numel() == 0:
        raise ValueError(f"kmv: X must be (m,) or (m, c) with m = {m} and "
                         f"c >= 1, got shape {tuple(X.shape)}")
    if X.device != A.device:
        raise ValueError(f"kmv: X on {X.device} but A on {A.device}")
    Xc = X.reshape(m, -1).to(torch.float32).contiguous()
    c = Xc.shape[1]
    splits, rows_per_split = kmv_splits(m, r, sm_count(A.device.index or 0))
    ws = torch.empty((splits, r, c), dtype=torch.float32, device=A.device)
    out = torch.empty((r, c), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        code = build.launcher("kmv")(
            A.data_ptr(), B.data_ptr(), Xc.data_ptr(), ws.data_ptr(),
            out.data_ptr(), m, r, n, c, splits, rows_per_split, dtype_code,
            *kernel_args(cfg), torch.cuda.current_stream().cuda_stream)
    raise_on_error("kmv", code)
    kmv_cuda.launches += 1
    out = out.to(out_dtype)
    return out[:, 0] if vec else out


kmv_cuda.launches = 0
