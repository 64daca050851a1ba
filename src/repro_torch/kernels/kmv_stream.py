"""Streamed KMV: ``U^T X`` with ``U = K(A, B)`` for an A that lives in
pinned host memory, chunked as ``Xc (nc, cr, n)``.

The counterpart of ``repro/kernels/kmv_stream.py``
(``kmv_stream_pallas``).  The kernel is ``csrc/kmv_stream.cu``: one C
call runs the whole pipe (chunk i+1 copied from pinned host memory into
one of two device slots on a side stream while chunk i contracts on the
current stream), so there is no per-chunk Python.  ``kmv_stream_cuda``
launches it and counts the launches; ``kmv_stream_plain`` is the same
chunk loop in plain PyTorch.  ``kmv_stream_full_cuda`` runs the full
matvec ``K(A, A) X`` of the convergence checks as one symmetric pipe
(an anchor chunk in a third slot, each chunk pair i <= j computed once
and serving its mirror); ``kmv_stream_full_plain`` is its pair loop in
plain PyTorch.  ``gather_rows_cuda`` reads sampled rows
of ``Xc`` straight from the mapped pinned buffer at device-side indices
(so a round never waits on the host for its schedule); its plain
version indexes the host buffer.  ``kmv_stream_apply_cuda`` is the
guarded rounds' residual update ``K(A, A[idx]) w`` through the same
two-slot pipe, each chunk's rows of the output contracted while the chunk
sits in its slot; ``kmv_stream_apply_plain`` is the JAX package's scan
over the chunks.  f64 data takes the f64 route (``csrc/f64_tile.cuh``;
the full matvec as the chunk pieces ``K(A, chunk_j)^T X``), and the plain
versions keep f64 for it.  ``kernels.ops`` picks by device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.kernels import RBF, KernelConfig, apply_epilogue
from . import _launch as card, build
from ._launch import (DTYPE_CODES, DTYPE_F64, acc_dtype, check_inputs,
                      kernel_args, raise_on_error, sm_count)
from .kmv import REGIME_CODES, ROWS_MAX_R, kmv_f64_plan, kmv_plan

# csrc/kmv_partial.cuh KMV_PAIR_BM: rows of the symmetric pipe's tiles
PAIR_BM = 128
# the dtypes the pipes take: the f32 / bf16 kernels' and the f64 route's
STREAM_DTYPES = {**DTYPE_CODES, torch.float64: DTYPE_F64}
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


def _kernel_block(a: torch.Tensor, b: torch.Tensor,
                  cfg: KernelConfig) -> torch.Tensor:
    """K(a, b) for two row blocks, as the plain versions build it."""
    dots = a @ b.T
    if cfg.name == RBF:
        return apply_epilogue(dots, cfg, torch.sum(a * a, dim=1),
                              torch.sum(b * b, dim=1))
    return apply_epilogue(dots, cfg)


def kmv_stream_plain(Xc: torch.Tensor, B: torch.Tensor, Xvc: torch.Tensor,
                     cfg: KernelConfig, out_dtype=None,
                     m: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: the chunk loop in f32 (f64 for f64 data) on
    B's device, each chunk moved there in turn; rows at or past ``m``
    (the padded tail) are left out.  Returns (r, c) in ``out_dtype``, by
    default the sum's dtype."""
    nc, cr, _ = Xc.shape
    m = _rows_valid(m, nc, cr)
    dev = B.device
    dt = acc_dtype(Xc.dtype)
    Bf = B.to(dt)
    cs = torch.sum(Bf * Bf, dim=1) if cfg.name == RBF else None
    acc = torch.zeros((B.shape[0], Xvc.shape[2]), dtype=dt, device=dev)
    for i in range(nc):
        rows = min(cr, m - i * cr)
        a = Xc[i, :rows].to(dev).to(dt)
        x = Xvc[i, :rows].to(dev).to(dt)
        dots = a @ Bf.T
        K = (apply_epilogue(dots, cfg, torch.sum(a * a, dim=1), cs)
             if cfg.name == RBF else apply_epilogue(dots, cfg))
        acc = acc + K.T @ x
    return acc.to(out_dtype or dt)


def kmv_stream_apply_plain(Xc: torch.Tensor, B: torch.Tensor,
                           W: torch.Tensor, cfg: KernelConfig,
                           m: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the streamed apply_at: ``K(A, B) @ W`` for
    the A of ``Xc`` (nc, cr, n), B (sb, n) and W (sb, c) on B's device,
    chunk by chunk in f32 (f64 for f64 data), as the JAX operator's scan
    does.  Returns (m, c)."""
    nc, cr, _ = Xc.shape
    m = _rows_valid(m, nc, cr)
    dt = acc_dtype(Xc.dtype)
    Bf, Wf = B.to(dt), W.to(dt)
    out = [_kernel_block(Xc[i, :min(cr, m - i * cr)].to(B.device).to(dt),
                         Bf, cfg) @ Wf for i in range(nc)]
    return torch.cat(out)


def _check_chunks(Xc, name: str) -> None:
    if not card.pinned_host(Xc):
        raise ValueError(
            f"{name}: Xc must be a page-locked (pinned) host tensor on "
            "the card path — a pageable copy serialises the pipe and "
            "hides the overlap; build it with StreamingGramOperator."
            "from_dense(..., device='cuda') or Tensor.pin_memory()")
    if Xc.ndim != 3 or not Xc.is_contiguous() or 0 in Xc.shape:
        raise ValueError(f"{name}: Xc must be a contiguous, non-empty "
                         f"(nc, cr, n) tensor, got shape "
                         f"{tuple(Xc.shape)}")


def _check_stream_inputs(Xc, B, Xvc) -> None:
    _check_chunks(Xc, "kmv_stream")
    nc, cr, n = Xc.shape
    if Xc.dtype not in STREAM_DTYPES or B.dtype != Xc.dtype:
        raise ValueError(f"kmv_stream: Xc and B must share a dtype in "
                         f"{list(STREAM_DTYPES)}, got {Xc.dtype} and "
                         f"{B.dtype}")
    if not card.card_tensor(B) or B.ndim != 2 or not B.is_contiguous() \
            or B.shape[0] == 0 or B.shape[1] != n:
        raise ValueError(f"kmv_stream: B must be a contiguous, non-empty "
                         f"(r, {n}) CUDA tensor, got {tuple(B.shape)} on "
                         f"{B.device}")
    if Xvc.device != B.device or Xvc.ndim != 3 or \
            tuple(Xvc.shape[:2]) != (nc, cr) or Xvc.shape[2] < 1:
        raise ValueError(f"kmv_stream: Xvc must be ({nc}, {cr}, c) on "
                         f"{B.device}, got {tuple(Xvc.shape)} on "
                         f"{Xvc.device}")


def _launch_f64(Xc: torch.Tensor, B: torch.Tensor, Xvc: torch.Tensor,
                cfg: KernelConfig, m: int) -> torch.Tensor:
    """The f64 route of the pipe over pinned chunks: (r, c) f64."""
    nc, cr, n = Xc.shape
    r = B.shape[0]
    Xv = Xvc.to(torch.float64).contiguous()
    c = Xv.shape[2]
    dev = B.device
    plan = kmv_f64_plan(cr, r, sm_count(dev.index or 0))
    slots = torch.empty((2, cr, n), dtype=Xc.dtype, device=dev)
    ws = torch.empty(plan.splits * r * c, dtype=torch.float64, device=dev)
    out = torch.empty((r, c), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        s0 = slots.data_ptr()
        code = build.launcher("kmv_stream_f64")(
            Xc.data_ptr(), s0, s0 + cr * n * slots.element_size(),
            B.data_ptr(), Xv.data_ptr(), ws.data_ptr(), out.data_ptr(), nc,
            cr, n, r, c, m, plan.splits, plan.rows_per_split,
            *kernel_args(cfg), torch.cuda.current_stream().cuda_stream,
            _copy_stream(dev).cuda_stream)
        raise_on_error("kmv_stream", code)
        _hold_until_done(Xc)
    return out


def _launch(Xc: torch.Tensor, resident: bool, B: torch.Tensor,
            Xvc: torch.Tensor, cfg: KernelConfig, m: int,
            out_dtype) -> torch.Tensor:
    if Xc.dtype == torch.float64:
        return _launch_f64(Xc, B, Xvc, cfg, m).to(out_dtype or torch.float64)
    nc, cr, n = Xc.shape
    r = B.shape[0]
    Xv = Xvc.to(torch.float32).contiguous()
    c = Xv.shape[2]
    dev = B.device
    plan = kmv_plan(cr, r, c, sm_count(dev.index or 0))
    # the two device slots of the pipe (unused when the chunks are
    # already resident), the per-block workspace with B's norms, the output
    slots = torch.empty((0 if resident else 2, cr, n), dtype=Xc.dtype,
                        device=dev)
    ws = torch.empty(plan.splits * r * c + r, dtype=torch.float32,
                     device=dev)
    out = torch.empty((r, c), dtype=torch.float32, device=dev)
    slot_bytes = cr * n * slots.element_size()
    with torch.cuda.device(dev):
        compute = torch.cuda.current_stream()
        copy = _copy_stream(dev)
        s0 = slots.data_ptr()
        code = build.launcher("kmv_stream")(
            Xc.data_ptr(), s0, s0 + slot_bytes, B.data_ptr(),
            Xv.data_ptr(), ws.data_ptr(), out.data_ptr(), nc, cr, n, r, c,
            m, REGIME_CODES[plan.regime], plan.bm, plan.br, plan.splits,
            plan.rows_per_split, DTYPE_CODES[Xc.dtype], int(resident),
            *kernel_args(cfg), compute.cuda_stream, copy.cuda_stream)
        raise_on_error("kmv_stream", code)
        if not resident:
            # the compute stream waited on every chunk's copy, so this
            # event also covers the copy stream's reads of Xc
            _hold_until_done(Xc)
    return out.to(out_dtype or torch.float32)


def kmv_stream_cuda(Xc: torch.Tensor, B: torch.Tensor, Xvc: torch.Tensor,
                    cfg: KernelConfig, out_dtype=None,
                    m: Optional[int] = None) -> torch.Tensor:
    """Run the streamed KMV pipe on the card: Xc (nc, cr, n) pinned host
    memory, f32, bf16 or f64; B (r, n) on the card in Xc's dtype; Xvc
    (nc, cr, c) on the card.  Rows at or past ``m`` (default nc * cr)
    are masked.  Returns (r, c) in ``out_dtype``, by default what the sum
    is in: f32, f64 for f64 data.  Never synchronises; Xc is held until
    the queued copies have read it."""
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
    return _launch(Xc, True, B, Xvc, cfg, m, None)


def kmv_stream_full_plain(Xc: torch.Tensor, Xvc: torch.Tensor,
                          cfg: KernelConfig,
                          m: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the symmetric pipe: ``K(A, A) X`` for the
    A of ``Xc`` (nc, cr, n), X chunked alike as ``Xvc`` (nc, cr, c), in
    f32 on Xvc's device.  The pair loop: each chunk pair i <= j once, its
    kernel block giving chunk j's rows their share and, off the diagonal,
    its transpose chunk i's.  Rows at or past ``m`` are left out.
    Returns (m, c) f32 (f64 for f64 data)."""
    nc, cr, _ = Xc.shape
    m = _rows_valid(m, nc, cr)
    dev = Xvc.device
    dt = acc_dtype(Xc.dtype)
    out = torch.zeros((nc * cr, Xvc.shape[2]), dtype=dt, device=dev)
    rows = [min(cr, m - k * cr) for k in range(nc)]
    for i in range(nc):
        a = Xc[i, :rows[i]].to(dev).to(dt)
        xa = Xvc[i, :rows[i]].to(dt)
        for j in range(i, nc):
            K = _kernel_block(a, Xc[j, :rows[j]].to(dev).to(dt), cfg)
            out[j * cr:j * cr + rows[j]] += K.T @ xa
            if j != i:
                out[i * cr:i * cr + rows[i]] += K @ Xvc[j, :rows[j]].to(dt)
    return out[:m]


def _check_full_inputs(Xc, Xvc) -> None:
    _check_chunks(Xc, "kmv_stream_full")
    nc, cr, _ = Xc.shape
    if Xc.dtype not in STREAM_DTYPES:
        raise ValueError(f"kmv_stream_full: Xc must be one of "
                         f"{list(STREAM_DTYPES)}, got {Xc.dtype}")
    if not card.card_tensor(Xvc) or Xvc.ndim != 3 or \
            tuple(Xvc.shape[:2]) != (nc, cr) or Xvc.shape[2] < 1:
        raise ValueError(f"kmv_stream_full: Xvc must be ({nc}, {cr}, c) "
                         f"on the card, got {tuple(Xvc.shape)} on "
                         f"{Xvc.device}")


def full_launch(Xc: torch.Tensor, Xvc: torch.Tensor, cfg: KernelConfig,
                m: int, resident: bool = False,
                drop: int = 0) -> torch.Tensor:
    """The symmetric pipe through its C entry point, not counted as a
    launch: Xc pinned (or, ``resident``, already on the card: the
    compute-only yardstick, no copies), Xvc on the card, both checked.
    Returns (m, c) f32.  ``drop`` builds the wrong variants that a parity
    check must fail: 1 leaves out the mirror's product of chunk pair
    (0, 1), 2 the whole pair (0, nc - 1)."""
    nc, cr, n = Xc.shape
    Xv = Xvc.to(torch.float32).contiguous()
    c = Xv.shape[2]
    dev = Xv.device
    tpc = -(-cr // PAIR_BM)
    # the anchor's slot and the two streaming slots, the pairs' workspace
    # slots with every row's |a|^2, the output
    slots = torch.empty((0 if resident else 3, cr, n), dtype=Xc.dtype,
                        device=dev)
    ws = torch.empty(2 * tpc * m * c + nc * cr, dtype=torch.float32,
                     device=dev)
    out = torch.empty((m, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = build.launcher("kmv_stream_sym")(
            Xc.data_ptr(), slots.data_ptr(), Xv.data_ptr(), ws.data_ptr(),
            out.data_ptr(), nc, cr, n, c, m, DTYPE_CODES[Xc.dtype],
            int(resident), drop, *kernel_args(cfg),
            torch.cuda.current_stream().cuda_stream,
            _copy_stream(dev).cuda_stream)
        raise_on_error("kmv_stream_full", code)
        if not resident:
            _hold_until_done(Xc)
    return out


def _full_f64(Xc: torch.Tensor, Xvc: torch.Tensor, cfg: KernelConfig,
              m: int) -> torch.Tensor:
    """The f64 route of the full matvec: the nc pieces ``K(A, chunk_j)^T
    X``, each one f64 pipe over all the chunks with chunk j on the card
    as B (the JAX operator's pieces).  (m, c) f64."""
    nc, cr, _ = Xc.shape
    dev = Xvc.device
    out = []
    for j in range(nc):
        B = Xc[j, :min(cr, m - j * cr)].to(dev, non_blocking=True)
        out.append(_launch_f64(Xc, B, Xvc, cfg, m))
    return torch.cat(out)


def kmv_stream_full_cuda(Xc: torch.Tensor, Xvc: torch.Tensor,
                         cfg: KernelConfig,
                         m: Optional[int] = None) -> torch.Tensor:
    """Run the symmetric streamed pipe on the card: ``K(A, A) X`` for the
    A of Xc (nc, cr, n), pinned host memory, f32 or bf16, with X chunked
    alike as Xvc (nc, cr, c) on the card.  Rows at or past ``m``
    (default nc * cr) are masked.  Returns (m, c) f32.  f64 data takes
    the f64 route's chunk pieces and returns f64.  Never synchronises;
    Xc is held until the queued copies have read it."""
    _check_full_inputs(Xc, Xvc)
    m = _rows_valid(m, Xc.shape[0], Xc.shape[1])
    if Xc.dtype == torch.float64:
        out = _full_f64(Xc, Xvc, cfg, m)
    else:
        out = full_launch(Xc, Xvc, cfg, m)
    kmv_stream_full_cuda.launches += 1
    return out


kmv_stream_full_cuda.launches = 0


def kmv_stream_full_resident(Xc: torch.Tensor, Xvc: torch.Tensor,
                             cfg: KernelConfig,
                             m: Optional[int] = None) -> torch.Tensor:
    """The symmetric pipe's launches alone, over chunks already on the
    card (no copies): the compute-only yardstick of ``chip_smoke.py``.
    The port's path never calls it, and it counts no launches."""
    if Xc.device != Xvc.device or Xc.ndim != 3 or not Xc.is_contiguous():
        raise ValueError("kmv_stream_full_resident: Xc must be a contiguous "
                         "(nc, cr, n) tensor on Xvc's device")
    check_inputs("kmv_stream_full_resident", Xc[0], Xc[0])
    m = _rows_valid(m, Xc.shape[0], Xc.shape[1])
    return full_launch(Xc, Xvc, cfg, m, resident=True)


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
    if not card.pinned_host(Xc):
        raise ValueError("gather_rows: Xc must be a page-locked (pinned) "
                         "host tensor on the card path")
    if Xc.ndim != 3 or not Xc.is_contiguous() or Xc.dtype not in \
            STREAM_DTYPES:
        raise ValueError(f"gather_rows: Xc must be a contiguous (nc, cr, "
                         f"n) f32/bf16/f64 tensor, got {tuple(Xc.shape)} "
                         f"{Xc.dtype}")
    if not card.card_tensor(idx) or idx.ndim != 1 or \
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
            Xc.shape[0] * Xc.shape[1], STREAM_DTYPES[Xc.dtype],
            torch.cuda.current_stream().cuda_stream)
        raise_on_error("gather_rows", code)
        _hold_until_done(Xc)
    gather_rows_cuda.launches += 1
    return out


gather_rows_cuda.launches = 0


def apply_launch(Xc: torch.Tensor, B: torch.Tensor, W: torch.Tensor,
                 cfg: KernelConfig, m: int) -> torch.Tensor:
    """The streamed apply_at through its C entry point, not counted as a
    launch: Xc pinned, B (sb, n) and W (sb, c) on the card, checked.  Returns (m, c), f32 (f64 for f64
    data).  The plan is the resident KMV's with its operands swapped,
    ``kmv_plan(sb, cr, c)`` (``kmv_f64_plan`` for f64), taken for a tail
    chunk's fewer rows too: a tile plan masks the columns past them, and
    chunks of at most ROWS_MAX_R rows take a tile plan, not "rows" (whose
    warps are sized for exactly r columns)."""
    nc, cr, n = Xc.shape
    sb = B.shape[0]
    f64 = Xc.dtype == torch.float64
    dt = acc_dtype(Xc.dtype)
    Wc = W.to(dt).contiguous()
    c = Wc.shape[1]
    dev = B.device
    sms = sm_count(dev.index or 0)
    plan = (kmv_f64_plan(sb, cr, sms) if f64
            else kmv_plan(sb, max(cr, ROWS_MAX_R + 1), c, sms))
    slots = torch.empty((2, cr, n), dtype=Xc.dtype, device=dev)
    ws = torch.empty(plan.splits * cr * c + (0 if f64 else cr), dtype=dt,
                     device=dev)
    out = torch.empty((nc * cr, c), dtype=dt, device=dev)
    s0 = slots.data_ptr()
    s1 = s0 + cr * n * slots.element_size()
    streams = (torch.cuda.current_stream(dev).cuda_stream,
               _copy_stream(dev).cuda_stream)
    head = (Xc.data_ptr(), s0, s1, B.data_ptr(), Wc.data_ptr(),
            ws.data_ptr(), out.data_ptr(), nc, cr, n, sb, c, m)
    with torch.cuda.device(dev):
        if f64:
            code = build.launcher("kmv_stream_apply_f64")(
                *head, plan.splits, plan.rows_per_split, *kernel_args(cfg),
                *streams)
        else:
            code = build.launcher("kmv_stream_apply")(
                *head, REGIME_CODES[plan.regime], plan.bm, plan.br,
                plan.splits, plan.rows_per_split, DTYPE_CODES[Xc.dtype],
                *kernel_args(cfg), *streams)
        raise_on_error("kmv_stream_apply", code)
        _hold_until_done(Xc)
    return out[:m]


def kmv_stream_apply_cuda(Xc: torch.Tensor, B: torch.Tensor,
                          W: torch.Tensor, cfg: KernelConfig,
                          m: Optional[int] = None) -> torch.Tensor:
    """Run the streamed apply_at on the card: ``K(A, B) @ W`` for the A
    of Xc (nc, cr, n), pinned host memory, f32, bf16 or f64, B (sb, n)
    in Xc's dtype and W (sb, c) on the card.  Rows at or past ``m`` are
    left out.  Returns (m, c), summed in f32 (f64 for f64 data).  Never
    synchronises; Xc is held until the queued copies have read it."""
    _check_chunks(Xc, "kmv_stream_apply")
    nc, cr, n = Xc.shape
    if Xc.dtype not in STREAM_DTYPES or B.dtype != Xc.dtype:
        raise ValueError(f"kmv_stream_apply: Xc and B must share a dtype "
                         f"in {list(STREAM_DTYPES)}, got {Xc.dtype} and "
                         f"{B.dtype}")
    if not card.card_tensor(B) or B.ndim != 2 or not B.is_contiguous() \
            or B.shape[0] == 0 or B.shape[1] != n:
        raise ValueError(f"kmv_stream_apply: B must be a contiguous, "
                         f"non-empty (sb, {n}) CUDA tensor, got "
                         f"{tuple(B.shape)} on {B.device}")
    if W.device != B.device or W.ndim != 2 or W.shape[0] != B.shape[0] \
            or W.shape[1] < 1:
        raise ValueError(f"kmv_stream_apply: W must be ({B.shape[0]}, c) "
                         f"on {B.device}, got {tuple(W.shape)} on "
                         f"{W.device}")
    m = _rows_valid(m, nc, cr)
    out = apply_launch(Xc, B, W, cfg, m)
    kmv_stream_apply_cuda.launches += 1
    return out


kmv_stream_apply_cuda.launches = 0
