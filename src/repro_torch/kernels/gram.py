"""Gram: ``K(A, B) = epilogue(A B^T)``, the (m, r) kernel slab.

The counterpart of ``repro/kernels/gram.py`` (``gram_pallas``).  The
kernel is ``csrc/gram.cu``; ``gram_cuda`` launches it and counts the
launches, ``gram_plain`` is the plain PyTorch version.
``kernels.ops.gram`` picks between them by device.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels import KernelConfig
from . import build
from ._launch import (BM, DTYPE_CODES, check_inputs, kernel_args,
                      raise_on_error)
from .ref import gram_ref

MAX_GRID_Y = 65535       # CUDA's limit on gridDim.y (row tiles)

# The plain PyTorch version is the f32 oracle itself: one ``gram_slab``
# in f32, cast on output.
gram_plain = gram_ref


def gram_cuda(A: torch.Tensor, B: torch.Tensor, cfg: KernelConfig,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the gram kernel on the card: A (m, n), B (r, n) contiguous,
    f32 or bf16.  Returns (m, r) in ``out_dtype`` (f32 or bf16), summed
    in f32.  Never synchronises."""
    in_code = check_inputs("gram", A, B)
    if out_dtype not in DTYPE_CODES:
        raise ValueError(f"gram: out_dtype must be one of "
                         f"{list(DTYPE_CODES)}, got {out_dtype}")
    m, n = A.shape
    r = B.shape[0]
    if -(-m // BM) > MAX_GRID_Y:
        raise ValueError(f"gram: m = {m} rows exceed the kernel's grid "
                         f"({MAX_GRID_Y} tiles of {BM} rows)")
    out = torch.empty((m, r), dtype=out_dtype, device=A.device)
    with torch.cuda.device(A.device):
        code = build.launcher("gram")(
            A.data_ptr(), B.data_ptr(), out.data_ptr(), m, r, n, in_code,
            DTYPE_CODES[out_dtype], *kernel_args(cfg),
            torch.cuda.current_stream().cuda_stream)
    raise_on_error("gram", code)
    gram_cuda.launches += 1
    return out


gram_cuda.launches = 0
