"""Streamed KMV: ``U^T X`` with ``U = K(A, B)`` for an A that lives in
pinned host memory, chunked as ``Xc (nc, cr, n)``.

The counterpart of ``repro/kernels/kmv_stream.py``
(``kmv_stream_pallas``).  The kernel is ``csrc/kmv_stream.cu``: one C
call runs the whole pipe (chunk i+1 copied from pinned host memory into
one of two device slots on a side stream while chunk i contracts on the
current stream), so there is no per-chunk Python.  ``kmv_stream_cuda``
launches it and counts the launches; ``kmv_stream_plain`` is the same
chunk loop in plain PyTorch.  ``gather_rows_cuda`` reads sampled rows
of ``Xc`` straight from the mapped pinned buffer at device-side indices
(so a round never waits on the host for its schedule); its plain
version indexes the host buffer.  ``kernels.ops`` picks by device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.kernels import RBF, KernelConfig, apply_epilogue
from . import build
from ._launch import (DTYPE_CODES, check_inputs, kernel_args,
                      raise_on_error, sm_count)
from .kmv import kmv_splits

_COPY_STREAMS: Dict[int, torch.cuda.Stream] = {}
# Pinned host buffers read by queued kernel work, each with an event
# recorded after that work.  The pipe's copies and the row gather read
# host memory outside PyTorch's copy_, so the pinned-memory allocator
# does not know of them: without this hold, a buffer dropped while its
# reads are still queued could be handed to the next pin_memory
# allocation and overwritten under them.
_PENDING: List[Tuple["torch.cuda.Event", torch.Tensor]] = []


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream the pipe's host-to-device copies run on, one per
    device, made on first use."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    stream = _COPY_STREAMS.get(index)
    if stream is None:
        stream = _COPY_STREAMS[index] = torch.cuda.Stream(device=index)
    return stream


def _hold_until_done(host: torch.Tensor) -> None:
    """Keep ``host`` alive until the work queued so far on the current
    stream is done (and drop the holds whose work has finished)."""
    _PENDING[:] = [(e, t) for e, t in _PENDING if not e.query()]
    done = torch.cuda.Event()
    done.record()
    _PENDING.append((done, host))


def _rows_valid(m: Optional[int], nc: int, cr: int) -> int:
    m = nc * cr if m is None else m
    if not (nc - 1) * cr < m <= nc * cr:
        raise ValueError(f"kmv_stream: m = {m} true rows do not fit "
                         f"{nc} chunks of {cr} with a partial tail")
    return m


def kmv_stream_plain(Xc: torch.Tensor, B: torch.Tensor, Xvc: torch.Tensor,
                     cfg: KernelConfig,
                     out_dtype: torch.dtype = torch.float32,
                     m: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: the chunk loop in f32 on B's device, each
    chunk moved there in turn; rows at or past ``m`` (the padded tail)
    are left out.  Returns (r, c)."""
    nc, cr, _ = Xc.shape
    m = _rows_valid(m, nc, cr)
    dev = B.device
    Bf = B.float()
    cs = torch.sum(Bf * Bf, dim=1) if cfg.name == RBF else None
    acc = torch.zeros((B.shape[0], Xvc.shape[2]), dtype=torch.float32,
                      device=dev)
    for i in range(nc):
        rows = min(cr, m - i * cr)
        a = Xc[i, :rows].to(dev).float()
        x = Xvc[i, :rows].to(dev).float()
        dots = a @ Bf.T
        K = (apply_epilogue(dots, cfg, torch.sum(a * a, dim=1), cs)
             if cfg.name == RBF else apply_epilogue(dots, cfg))
        acc = acc + K.T @ x
    return acc.to(out_dtype)


def _check_stream_inputs(Xc, B, Xvc) -> None:
    if Xc.device.type != "cpu" or not Xc.is_pinned():
        raise ValueError(
            "kmv_stream: Xc must be a page-locked (pinned) host tensor on "
            "the card path — a pageable copy serialises the pipe and "
            "hides the overlap; build it with StreamingGramOperator."
            "from_dense(..., device='cuda') or Tensor.pin_memory()")
    if Xc.ndim != 3 or not Xc.is_contiguous() or 0 in Xc.shape:
        raise ValueError(f"kmv_stream: Xc must be a contiguous, non-empty "
                         f"(nc, cr, n) tensor, got shape "
                         f"{tuple(Xc.shape)}")
    nc, cr, n = Xc.shape
    if Xc.dtype not in DTYPE_CODES or B.dtype != Xc.dtype:
        raise ValueError(f"kmv_stream: Xc and B must share a dtype in "
                         f"{list(DTYPE_CODES)}, got {Xc.dtype} and "
                         f"{B.dtype}")
    if B.device.type != "cuda" or B.ndim != 2 or not B.is_contiguous() \
            or B.shape[0] == 0 or B.shape[1] != n:
        raise ValueError(f"kmv_stream: B must be a contiguous, non-empty "
                         f"(r, {n}) CUDA tensor, got {tuple(B.shape)} on "
                         f"{B.device}")
    if Xvc.device != B.device or Xvc.ndim != 3 or \
            tuple(Xvc.shape[:2]) != (nc, cr) or Xvc.shape[2] < 1:
        raise ValueError(f"kmv_stream: Xvc must be ({nc}, {cr}, c) on "
                         f"{B.device}, got {tuple(Xvc.shape)} on "
                         f"{Xvc.device}")


def _launch(Xc: torch.Tensor, resident: bool, B: torch.Tensor,
            Xvc: torch.Tensor, cfg: KernelConfig, m: int,
            out_dtype: torch.dtype) -> torch.Tensor:
    nc, cr, n = Xc.shape
    r = B.shape[0]
    Xv = Xvc.to(torch.float32).contiguous()
    c = Xv.shape[2]
    dev = B.device
    splits, rows_per_split = kmv_splits(cr, r, sm_count(dev.index or 0))
    # the two device slots of the pipe (unused when the chunks are
    # already resident), the per-block workspace and the output
    slots = torch.empty((0 if resident else 2, cr, n), dtype=Xc.dtype,
                        device=dev)
    ws = torch.empty((splits, r, c), dtype=torch.float32, device=dev)
    out = torch.empty((r, c), dtype=torch.float32, device=dev)
    slot_bytes = cr * n * slots.element_size()
    with torch.cuda.device(dev):
        compute = torch.cuda.current_stream()
        copy = _copy_stream(dev)
        s0 = slots.data_ptr()
        code = build.launcher("kmv_stream")(
            Xc.data_ptr(), s0, s0 + slot_bytes, B.data_ptr(),
            Xv.data_ptr(), ws.data_ptr(), out.data_ptr(), nc, cr, n, r, c,
            m, splits, rows_per_split, DTYPE_CODES[Xc.dtype], int(resident),
            *kernel_args(cfg), compute.cuda_stream, copy.cuda_stream)
        raise_on_error("kmv_stream", code)
        if not resident:
            # the compute stream waited on every chunk's copy, so this
            # event also covers the copy stream's reads of Xc
            _hold_until_done(Xc)
    return out.to(out_dtype)


def kmv_stream_cuda(Xc: torch.Tensor, B: torch.Tensor, Xvc: torch.Tensor,
                    cfg: KernelConfig,
                    out_dtype: torch.dtype = torch.float32,
                    m: Optional[int] = None) -> torch.Tensor:
    """Run the streamed KMV pipe on the card: Xc (nc, cr, n) pinned host
    memory, f32 or bf16; B (r, n) on the card in Xc's dtype; Xvc
    (nc, cr, c) on the card.  Rows at or past ``m`` (default nc * cr)
    are masked.  Returns (r, c) in ``out_dtype``, summed in f32.  Never
    synchronises; Xc is held until the queued copies have read it."""
    _check_stream_inputs(Xc, B, Xvc)
    m = _rows_valid(m, Xc.shape[0], Xc.shape[1])
    out = _launch(Xc, False, B, Xvc, cfg, m, out_dtype)
    kmv_stream_cuda.launches += 1
    return out


kmv_stream_cuda.launches = 0


def kmv_stream_resident(Xc: torch.Tensor, B: torch.Tensor,
                        Xvc: torch.Tensor, cfg: KernelConfig,
                        m: Optional[int] = None) -> torch.Tensor:
    """The pipe's contractions alone, over chunks already on the card
    (no copies): the compute-only yardstick of ``chip_smoke.py``.  The
    port's path never calls it, and it counts no launches."""
    if Xc.device != B.device or Xc.ndim != 3 or not Xc.is_contiguous():
        raise ValueError("kmv_stream_resident: Xc must be a contiguous "
                         "(nc, cr, n) tensor on B's device")
    check_inputs("kmv_stream_resident", Xc[0], B)
    m = _rows_valid(m, Xc.shape[0], Xc.shape[1])
    return _launch(Xc, True, B, Xvc, cfg, m, torch.float32)


def gather_rows_plain(Xc: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of the chunked data (row i of A is row i of the
    flattened chunks), on idx's device."""
    rows = Xc.view(-1, Xc.shape[2])[idx.to(Xc.device)]
    return rows.to(idx.device)


def gather_rows_cuda(Xc: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows ``idx`` (int64 on the card) of pinned host ``Xc`` into
    a (k, n) device tensor, reading the mapped host buffer from the
    kernel: no host synchronisation, k * n elements over the link.  Xc
    is held until the gather has read it."""
    if Xc.device.type != "cpu" or not Xc.is_pinned():
        raise ValueError("gather_rows: Xc must be a page-locked (pinned) "
                         "host tensor on the card path")
    if Xc.ndim != 3 or not Xc.is_contiguous() or Xc.dtype not in \
            DTYPE_CODES:
        raise ValueError(f"gather_rows: Xc must be a contiguous (nc, cr, "
                         f"n) f32/bf16 tensor, got {tuple(Xc.shape)} "
                         f"{Xc.dtype}")
    if idx.device.type != "cuda" or idx.ndim != 1 or \
            idx.dtype != torch.long:
        raise ValueError(f"gather_rows: idx must be 1-D int64 on the "
                         f"card, got {idx.dtype} {tuple(idx.shape)} on "
                         f"{idx.device}")
    k, n = idx.shape[0], Xc.shape[2]
    out = torch.empty((k, n), dtype=Xc.dtype, device=idx.device)
    if k == 0:
        return out
    idx = idx.contiguous()
    with torch.cuda.device(idx.device):
        code = build.launcher("gather_rows")(
            Xc.data_ptr(), idx.data_ptr(), out.data_ptr(), k, n,
            Xc.shape[0] * Xc.shape[1], DTYPE_CODES[Xc.dtype],
            torch.cuda.current_stream().cuda_stream)
        raise_on_error("gather_rows", code)
        _hold_until_done(Xc)
    gather_rows_cuda.launches += 1
    return out


gather_rows_cuda.launches = 0
