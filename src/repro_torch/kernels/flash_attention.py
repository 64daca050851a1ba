"""Flash attention, forward: ``o = softmax(q k^T * scale) v`` and the row
log-sum-exp, over (BH, S, hd) q and (BH, T, hd) / (BH, T, hdv) k and v.

The counterpart of ``flash_fwd`` in ``repro/kernels/flash_attention.py``.
The kernel is ``csrc/flash_fwd.cu`` (one block per (bh, 64-row q tile),
the online-softmax recurrence in f32 registers, FP32 FMAs for f32 and
bf16 inputs alike; the causal mask is ``col <= row``, tiles above the
diagonal are skipped); ``flash_fwd_cuda`` launches it and counts the
launches, ``flash_fwd_plain`` is the plain PyTorch version (the oracle
plus the log-sum-exp).  ``kernels.ops.flash_fwd`` picks between them by
device.  The backward (``flash_bwd``) belongs to the training slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build
from ._launch import DTYPE_CODES, raise_on_error
from .ref import flash_attention_ref

HD_MAX = 128              # csrc/flash_fwd.cu FA_HD_MAX
MAX_GRID_Y = 65535        # CUDA's limit on gridDim.y (the BH axis)
BLOCK = 256               # the TPU kernel's default bq = bk


def check_shapes(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """Validate (BH, S, hd) q, (BH, T, hd) k, (BH, T, hdv) v; returns
    (BH, S, T, hd, hdv).  S and T must be multiples of min(256, S) and
    min(256, T), the shapes the TPU kernel takes at its default blocks
    (``flash_attention.py:89``); hd and hdv at most 128."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 3 or 0 in t.shape:
            raise ValueError(f"flash_fwd: {name} must be a non-empty "
                             f"(BH, len, dim) tensor, got "
                             f"{tuple(t.shape)}")
    BH, S, hd = q.shape
    T, hdv = k.shape[1], v.shape[2]
    if k.shape != (BH, T, hd) or v.shape[:2] != (BH, T):
        raise ValueError(f"flash_fwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit together")
    for name, n in (("S", S), ("T", T)):
        if n % min(BLOCK, n):
            raise ValueError(f"flash_fwd: {name} = {n} is not a multiple "
                             f"of min({BLOCK}, {name})")
    if hd > HD_MAX or hdv > HD_MAX:
        raise ValueError(f"flash_fwd: head dims ({hd}, {hdv}) exceed "
                         f"{HD_MAX}")
    return BH, S, T, hd, hdv


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o (BH, S, hdv) in q's dtype, lse (BH, S) f32)`` through the whole
    (S, T) softmax in f32: ``ref.flash_attention_ref`` with its lse."""
    check_shapes(q, k, v)
    return flash_attention_ref(q, k, v, causal, scale, with_lse=True)


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the flash forward kernel on the card: q, k, v contiguous CUDA
    tensors of one dtype (f32 or bf16).  Returns ``(o, lse)`` as
    ``flash_fwd_plain`` does.  Never synchronises."""
    BH, S, T, hd, hdv = check_shapes(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_fwd: {name} must be a CUDA tensor on "
                             f"{q.device}, got {t.device}")
        if t.dtype not in DTYPE_CODES or t.dtype != q.dtype:
            raise ValueError(f"flash_fwd: q, k and v must share a dtype in "
                             f"{list(DTYPE_CODES)}, got {q.dtype}, "
                             f"{k.dtype}, {v.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd: {name} must be contiguous")
    if BH > MAX_GRID_Y:
        raise ValueError(f"flash_fwd: BH = {BH} exceeds the kernel's grid "
                         f"({MAX_GRID_Y})")
    scale = scale if scale is not None else hd ** -0.5
    o = torch.empty((BH, S, hdv), dtype=q.dtype, device=q.device)
    lse = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = build.launcher("flash_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), BH, S, T, hd, hdv, DTYPE_CODES[q.dtype],
            int(bool(causal)), float(scale),
            torch.cuda.current_stream().cuda_stream)
    raise_on_error("flash_fwd", code)
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0
