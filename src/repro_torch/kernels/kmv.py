"""KMV: ``U^T X`` with ``U = K(A, B)``, without the ``m x r`` slab.

The counterpart of ``repro/kernels/kmv.py`` (``kmv_pallas``).  The
kernel is ``csrc/kmv.cu`` (the contraction in ``csrc/kmv_partial.cuh``);
``kmv_plan`` picks its design for the width r of the output,
``kmv_cuda`` launches it and counts the launches, ``kmv_plain`` is the
plain PyTorch version of the same function (the slab-free blocked loop
of ``core.kernels.kmv_slab_free``, in f32).  ``kernels.ops.kmv`` picks
between them by device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.kernels import KernelConfig, kmv_slab_free
from . import build
from ._launch import check_inputs, kernel_args, raise_on_error, sm_count

# csrc/kmv_partial.cuh: the regimes' codes and limits
REGIME_CODES = {"rows": 0, "narrow": 1, "wide": 2, "symmetric": 3}
ROWS_MAX_R = 8             # r at most this: rows of A streamed by warps
ROWS_MAX_RC = 1024         # ... while the warps' (r x c) partials fit
ROWS_BLOCKS_PER_SM = 4     # 8-warp blocks the rows regime launches an SM
NARROW_MAX_R = 64          # r at most this: a tile as wide as r
NARROW_BM, WIDE_BM = 32, 128
# the wide regime takes 128 x 128 tiles when they number at least this many
# an SM, else 128 x 64 (K-RR's r = 256: 314 tiles of 128 columns, one an
# SM at a time, would leave the last of three waves a third full)
WIDE_TILES_PER_SM = 8
MAX_GRID_Y = 65535         # CUDA's limit on gridDim.y (the m splits)
WS_MAX_FLOATS = 1 << 24    # workspace the m split may take (64 MB)
# ... and the symmetric plan of c > 1 columns (256 MB): it needs a tile a
# split, and takes about half the wide plan's time for the same K(A, A), so
# a fleet's full matvec of F columns keeps it (m = 19 996 at c = 16: 201 MB;
# both plans timed by chip_smoke.py phase 9a).  At c = 1 the symmetric plan
# stays within WS_MAX_FLOATS.
SYM_WS_MAX_FLOATS = 1 << 26


class KmvPlan(NamedTuple):
    """How ``kmv_cuda`` launches: the regime, the tile (``bm`` rows of A x
    ``br`` columns; in "rows" a warp's row group x r) and the split of the
    m axis into ``splits`` runs of ``rows_per_split`` rows, none empty."""
    regime: str
    bm: int
    br: int
    splits: int
    rows_per_split: int


def row_group(r: int) -> int:
    """Rows of A a warp takes at a time in the rows regime
    (csrc/kmv_partial.cuh kmv_row_group): more as r grows, so that each
    load of B feeds more products."""
    return 1 if r <= 2 else (2 if r <= 4 else 4)


def kmv_plan(m: int, r: int, c: int, sm_count: int,
             same: bool = False) -> KmvPlan:
    """The design for an (m, r) KMV with c columns of X on a card of
    ``sm_count`` SMs (``same``: B is A, the full matvec K(A, A)^T X):

    - "rows" (r <= 8 and r c <= 1024): warps stream rows of A; the m axis
      is split evenly into about ROWS_BLOCKS_PER_SM blocks an SM;
    - "narrow" (r <= 64): 32-row tiles as wide as r rounds up to (32 or
      64), so r = 32 masks no column;
    - "wide": 128 x 128 tiles, or 128 x 64 where 128-wide tiles would be
      too few to fill the card evenly;
    - "symmetric": the wide 128 x 128 plan of a B that is A, a tile a
      split: K(A, A) is symmetric, so only the tiles on and above the
      diagonal are computed, each also standing for its mirror.

    A tile regime gives each block one BM-row tile of its column tile
    (the finest balance across SMs) unless the grid's y dimension or the
    workspace (splits x r x c floats) would grow past its limit; then
    each split takes a run of whole tiles.  The symmetric plan of c > 1
    columns may take a workspace of up to SYM_WS_MAX_FLOATS."""
    if r <= ROWS_MAX_R and r * c <= ROWS_MAX_RC:
        per = -(-m // min(m, ROWS_BLOCKS_PER_SM * sm_count))
        return KmvPlan("rows", row_group(r), r, -(-m // per), per)
    if r <= NARROW_MAX_R:
        regime, bm, br = "narrow", NARROW_BM, (32 if r <= 32 else 64)
    else:
        regime, bm = "wide", WIDE_BM
        tiles128 = -(-r // 128) * -(-m // WIDE_BM)
        br = 128 if tiles128 >= WIDE_TILES_PER_SM * sm_count else 64
    m_tiles = -(-m // bm)
    most = max(1, min(MAX_GRID_Y, WS_MAX_FLOATS // (r * c)))
    sym_most = most if c == 1 else min(MAX_GRID_Y,
                                       SYM_WS_MAX_FLOATS // (r * c))
    if same and m == r and br == bm and m_tiles <= sym_most:
        return KmvPlan("symmetric", bm, br, m_tiles, bm)
    per_tiles = -(-m_tiles // min(m_tiles, most))
    return KmvPlan(regime, bm, br, -(-m_tiles // per_tiles), per_tiles * bm)


def kmv_plain(A: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
              cfg: KernelConfig,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: the blocked slab-free contraction in f32."""
    return kmv_slab_free(A.float(), B.float(), X.float(), cfg).to(out_dtype)


def launch(A: torch.Tensor, B: torch.Tensor, Xc: torch.Tensor,
           cfg: KernelConfig, plan: KmvPlan, dtype_code: int) -> torch.Tensor:
    """The kernel through its C entry point at ``plan``, not counted as a
    launch: A (m, n), B (r, n) CUDA tensors that ``check_inputs`` passed
    (``dtype_code`` is what it returned), Xc (m, c) contiguous f32.
    Returns (r, c) f32.  A plan with one split fewer than the one
    ``kmv_plan`` gives leaves the last rows of A out: the wrong kernel
    that ``chip_smoke.py`` holds its parity check against."""
    m, n = A.shape
    r, c = B.shape[0], Xc.shape[1]
    ws = torch.empty(plan.splits * r * c + r, dtype=torch.float32,
                     device=A.device)
    out = torch.empty((r, c), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        code = build.launcher("kmv")(
            A.data_ptr(), B.data_ptr(), Xc.data_ptr(), ws.data_ptr(),
            out.data_ptr(), m, r, n, c, REGIME_CODES[plan.regime], plan.bm,
            plan.br, plan.splits, plan.rows_per_split, dtype_code,
            *kernel_args(cfg),
            torch.cuda.current_stream().cuda_stream)
    raise_on_error("kmv", code)
    return out


def kmv_cuda(A: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
             cfg: KernelConfig,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the KMV kernel on the card: A (m, n), B (r, n) contiguous,
    f32 or bf16; X (m,) or (m, c).  Returns (r,) / (r, c) in
    ``out_dtype``; the sum is f32.  Never synchronises."""
    dtype_code = check_inputs("kmv", A, B)
    m = A.shape[0]
    vec = X.ndim == 1
    if X.ndim not in (1, 2) or X.shape[0] != m or X.numel() == 0:
        raise ValueError(f"kmv: X must be (m,) or (m, c) with m = {m} and "
                         f"c >= 1, got shape {tuple(X.shape)}")
    if X.device != A.device:
        raise ValueError(f"kmv: X on {X.device} but A on {A.device}")
    Xc = X.reshape(m, -1).to(torch.float32).contiguous()
    same = B.data_ptr() == A.data_ptr() and B.shape == A.shape
    plan = kmv_plan(m, B.shape[0], Xc.shape[1],
                    sm_count(A.device.index or 0), same)
    out = launch(A, B, Xc, cfg, plan, dtype_code)
    kmv_cuda.launches += 1
    out = out.to(out_dtype)
    return out[:, 0] if vec else out


kmv_cuda.launches = 0
kmv_cuda.warmup_launches = 0      # core.loop.RoundGraphs' warm-up rounds
