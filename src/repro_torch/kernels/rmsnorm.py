"""RMSNorm: ``y = x * rsqrt(mean(x^2, -1) + eps) * scale`` row by row.

The counterpart of ``repro/kernels/rmsnorm.py`` (``rmsnorm_pallas``).  The
kernel is ``csrc/rmsnorm.cu`` (one warp per row, f32 statistics, the
result in x's dtype; bound by reading x and writing y once);
``rmsnorm_cuda`` launches it and counts the launches, ``rmsnorm_plain``
is the plain PyTorch version.  ``kernels.ops.rmsnorm`` picks between
them by device, and ``models.layers.rmsnorm`` goes through it, so every
norm of the LM runs this kernel on the card.
"""
from __future__ import annotations

import torch

from . import build
from ._launch import DTYPE_CODES, raise_on_error
from .ref import rmsnorm_ref

MAX_ROWS = 2 ** 31 - 1

# The plain version is the oracle itself.
rmsnorm_plain = rmsnorm_ref


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Launch the RMSNorm kernel on the card: x (..., D) contiguous, f32 or
    bf16; scale (D,) f32 on the same device.  Returns y shaped and typed
    like x.  Never synchronises."""
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: x must be a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"rmsnorm: x must be one of {list(DTYPE_CODES)}, "
                         f"got {x.dtype}")
    if x.ndim < 1 or x.numel() == 0:
        raise ValueError(f"rmsnorm: x must be non-empty, got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm: x must be contiguous")
    D = x.shape[-1]
    if (scale.dtype != torch.float32 or scale.shape != (D,)
            or scale.device != x.device or not scale.is_contiguous()):
        raise ValueError(f"rmsnorm: scale must be a contiguous f32 ({D},) "
                         f"tensor on {x.device}, got {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}")
    rows = x.numel() // D
    if rows > MAX_ROWS:
        raise ValueError(f"rmsnorm: {rows} rows exceed the kernel's "
                         f"{MAX_ROWS}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = build.launcher("rmsnorm")(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D,
            DTYPE_CODES[x.dtype], float(eps),
            torch.cuda.current_stream().cuda_stream)
    raise_on_error("rmsnorm", code)
    rmsnorm_cuda.launches += 1
    return out


rmsnorm_cuda.launches = 0
