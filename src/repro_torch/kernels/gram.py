"""Gram: ``K(A, B) = epilogue(A B^T)``, the (m, r) kernel slab.

The counterpart of ``repro/kernels/gram.py`` (``gram_pallas``).  The
kernel is ``csrc/gram.cu``; ``gram_cuda`` launches it and counts the
launches (also by shape), ``gram_plain`` is the plain PyTorch version.
``kernels.ops.gram`` picks between them by device.  ``gram_splits``
picks the kernel's output tile and its split of the feature axis.  f64
operands take the f64 route (``csrc/f64_tile.cuh``), and the plain
version keeps f64 for them.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels import KernelConfig
from . import build
from repro_torch.core.kernels import gram_slab
from ._launch import (DTYPE_CODES, DTYPE_F64, acc_dtype, check_inputs,
                      kernel_args, raise_on_error, sm_count)

MAX_GRID = 65535         # CUDA's limit on gridDim.y (row tiles) and .z
BK = 32                  # features a chunk, csrc/gram.cu G_BK
DOT_MAX = 4              # csrc/gram.cu G_DOT_MAX: m, r <= 4 take the dot kernel
# blocks the split aims for, per SM: at 2 the 19 996 x 32 slab (313 tiles of
# 64 threads) takes one split and leaves an SM ~5 warps; at 4 it takes two
BLOCKS_PER_SM = 4



def gram_plain(A: torch.Tensor, B: torch.Tensor, cfg: KernelConfig,
               out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version: one ``gram_slab`` in f32 (f64 for f64
    operands: the f32 oracle ``ref.gram_ref`` otherwise), cast to
    ``out_dtype``, by default that dtype."""
    acc = acc_dtype(A.dtype)
    return gram_slab(A.to(acc), B.to(acc), cfg).to(out_dtype or acc)


def gram_tile(m: int, r: int):
    """The kernel's (rows, columns) output tile: (4, 4), the dot kernel,
    when m and r are both at most 4; else 32 or 64 on each side, so a
    32-wide output does not mask half of a 64-wide tile."""
    if m <= DOT_MAX and r <= DOT_MAX:
        return DOT_MAX, DOT_MAX
    return (32 if m <= 32 else 64), (32 if r <= 32 else 64)


def gram_splits(m: int, r: int, n: int, sm_count: int):
    """``(bm, br, splits, per)``: the output tile (``gram_tile``) and a split
    of the feature axis into ``splits`` runs of ``per`` whole BK-feature
    chunks, none empty, so that output tiles x splits fill the card's SMs
    about BLOCKS_PER_SM times over; an output of that many tiles takes one
    split."""
    bm, br = gram_tile(m, r)
    tiles = -(-m // bm) * -(-r // br)
    chunks = -(-n // BK)
    want = max(1, min(chunks, -(-BLOCKS_PER_SM * sm_count // tiles),
                      MAX_GRID))
    per = -(-chunks // want)
    return bm, br, -(-chunks // per), per


def launch_f64(A: torch.Tensor, B: torch.Tensor,
               cfg: KernelConfig) -> torch.Tensor:
    """The f64 route through its C entry point, not counted as a launch:
    A (m, n), B (r, n) f64 CUDA tensors that ``check_inputs`` passed.
    Returns (m, r) f64."""
    m, n = A.shape
    r = B.shape[0]
    out = torch.empty((m, r), dtype=torch.float64, device=A.device)
    kind, degree, coef0, sigma = kernel_args(cfg)
    with torch.cuda.device(A.device):
        code = build.launcher("gram_f64")(
            A.data_ptr(), B.data_ptr(), out.data_ptr(), m, r, n, kind,
            degree, coef0, sigma, torch.cuda.current_stream().cuda_stream)
    raise_on_error("gram", code)
    return out


def gram_cuda(A: torch.Tensor, B: torch.Tensor, cfg: KernelConfig,
              out_dtype=None) -> torch.Tensor:
    """Launch the gram kernel on the card: A (m, n), B (r, n) contiguous,
    f32, bf16 or f64.  Returns (m, r) in ``out_dtype`` (f32 or bf16,
    summed in f32; default f32), or for f64 operands in f64 (the f64
    route, summed in f64).  Never synchronises."""
    in_code = check_inputs("gram", A, B, f64=True)
    if in_code == DTYPE_F64:
        if out_dtype not in (None, torch.float64):
            raise ValueError(f"gram: the f64 route writes f64, got "
                             f"out_dtype={out_dtype}")
        out = launch_f64(A, B, cfg)
        _count((A.shape[0], B.shape[0], A.shape[1], cfg.name))
        gram_cuda.launches_f64 += 1
        return out
    out_dtype = out_dtype or torch.float32
    if out_dtype not in DTYPE_CODES:
        raise ValueError(f"gram: out_dtype must be one of "
                         f"{list(DTYPE_CODES)}, got {out_dtype}")
    m, n = A.shape
    r = B.shape[0]
    bm, br, splits, per = gram_splits(m, r, n,
                                      sm_count(A.device.index or 0))
    if -(-m // bm) > MAX_GRID:
        raise ValueError(f"gram: m = {m} rows exceed the kernel's grid "
                         f"({MAX_GRID} tiles of {bm} rows)")
    out = torch.empty((m, r), dtype=out_dtype, device=A.device)
    ws = (torch.empty(splits * (m * r + m + r), dtype=torch.float32,
                      device=A.device) if splits > 1 else None)
    with torch.cuda.device(A.device):
        code = build.launcher("gram")(
            A.data_ptr(), B.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, m, r, n, in_code,
            DTYPE_CODES[out_dtype], *kernel_args(cfg), bm, br, splits, per,
            torch.cuda.current_stream().cuda_stream)
    raise_on_error("gram", code)
    _count((m, r, n, cfg.name))
    return out


def _count(shape: tuple) -> None:
    """One launch of ``gram_cuda`` at ``shape`` = (m, r, n, kernel)."""
    gram_cuda.launches += 1
    gram_cuda.by_shape[shape] = gram_cuda.by_shape.get(shape, 0) + 1


gram_cuda.launches = 0
gram_cuda.by_shape = {}           # launches by (m, r, n, kernel)
gram_cuda.launches_f64 = 0        # of those, the f64 route's
gram_cuda.warmup_launches = 0     # core.loop.RoundGraphs' warm-up rounds
