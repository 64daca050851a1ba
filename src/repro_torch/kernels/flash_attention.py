"""Flash attention, forward and backward: ``o = softmax(q k^T * scale) v``
and the row log-sum-exp over (BH, S, hd) q and (BH, T, hd) / (BH, T,
hdv) k and v, and ``dq, dk, dv`` from the saved log-sum-exp.

The counterpart of ``repro/kernels/flash_attention.py``.  Two routes,
picked by ``flash_route`` from the dtype and head dims alone:

- ``"wgmma"`` (bf16, hd = hdv in {64, 128}, the LM's shapes): the
  forward is ``csrc/flash_fwd_wgmma.cu``, the dk/dv backward
  ``csrc/flash_bwd_wgmma.cu`` and the dq backward
  ``csrc/flash_bwd_dq_wgmma.cu``, all on the tensor cores (bf16
  ``wgmma`` on tiles that TMA brings into shared memory;
  ``csrc/wgmma_tile.cuh``).  The forward rounds p to bf16 before the PV
  product, as the TPU kernel does; the dk/dv kernel rounds p and ds to
  bf16 for its products and the dq kernel ds, which the TPU kernels do
  not (ROADMAP C5, C7).
- ``"fma"`` (f32, and bf16 at other head dims): ``csrc/flash_fwd.cu``
  (one block per (bh, 64-row q tile), the online-softmax recurrence in
  f32 registers, FP32 FMAs) and ``csrc/flash_bwd.cu``'s dq and dkv
  kernels, all in f32 from the widened inputs.

The causal mask is ``col <= row``; tiles above the diagonal are skipped.
``flash_fwd_cuda`` and ``flash_bwd_cuda`` launch the kernels and count
each launch by kernel (``launches`` / ``launches_wgmma`` for the
forward, ``launches_dq`` / ``launches_dq_wgmma`` and ``launches_dkv`` /
``launches_dkv_wgmma`` for the backward) and by shape (``by_shape``);
``flash_fwd_plain`` and ``flash_bwd_plain`` are the plain PyTorch
versions (the oracle with its log-sum-exp; ``round_p`` rounds p, and in
the backward's dk and dv ds, to bf16 where the tensor-core kernels do,
``round_dq`` ds in dq).
``FlashAttention`` (the counterpart of the JAX ``custom_vjp``) runs the
forward and, in its backward, ``delta = sum(do * o, -1)`` in f32 and then
``kernels.ops.flash_bwd``; each picks the kernel for a CUDA tensor and
the plain version for a CPU tensor.  On the tensor-core route it first
copies an operand that does not start on a TMA boundary (a view into a
larger buffer) into a fresh tensor (``_tma_ready``).  ``flash_attention``
is the differentiable entry point the LM's flash path takes (training
and prefill).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _launch, build
from ._launch import DTYPE_CODES, on_card, raise_on_error
from .ref import flash_attention_bwd_ref, flash_attention_ref

HD_MAX = 128              # csrc/flash_fwd.cu FA_HD_MAX
MAX_GRID_Y = 65535        # CUDA's limit on gridDim.y (the BH axis)
BLOCK = 256               # the TPU kernel's default bq = bk
WGMMA_HEAD_DIMS = (64, 128)   # csrc/flash_{fwd,bwd}_wgmma.cu
TMA_ALIGN = 16            # bytes: a TMA tensor map's base address


def flash_route(dtype: torch.dtype, hd: int, hdv: int) -> str:
    """The kernel family for a flash call: ``"wgmma"`` (the tensor-core
    forward and dk/dv kernels) for bf16 with ``hd == hdv`` in
    ``WGMMA_HEAD_DIMS``, ``"fma"`` (the FP32-FMA kernels) otherwise: f32,
    whose whole-model gradients are held to 1e-5, which bf16 operands
    cannot meet; head dims the wgmma tiles do not take (16, 24, 32, ...);
    and hd != hdv."""
    return ("wgmma" if dtype == torch.bfloat16 and hd == hdv
            and hd in WGMMA_HEAD_DIMS else "fma")


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
                    causal: bool = True, scale: Optional[float] = None,
                    round_p: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o (BH, S, hdv) in q's dtype, lse (BH, S) f32)`` through the whole
    (S, T) softmax in f32: ``ref.flash_attention_ref`` with its lse
    (``round_p``: p rounded to v's dtype before the PV product)."""
    check_shapes(q, k, v)
    return flash_attention_ref(q, k, v, causal, scale, with_lse=True,
                               round_p=round_p)


def _check_card(name: str, tensors, q: torch.Tensor, BH: int) -> None:
    """The card-side checks of a flash kernel's (name, tensor) operands:
    CUDA tensors on q's device, one dtype the kernels take, contiguous;
    and BH within the grid."""
    for arg, t in tensors:
        if not _launch.card_tensor(t) or t.device != q.device:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor on "
                             f"{q.device}, got {t.device}")
        if t.dtype not in DTYPE_CODES or t.dtype != q.dtype:
            raise ValueError(f"{name}: " + ", ".join(a for a, _ in tensors)
                             + f" must share a dtype in {list(DTYPE_CODES)},"
                             f" got {[u.dtype for _, u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if BH > MAX_GRID_Y:
        raise ValueError(f"{name}: BH = {BH} exceeds the kernel's grid "
                         f"({MAX_GRID_Y})")


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh copy of it when it does not start on a
    ``TMA_ALIGN``-byte boundary (a contiguous view that begins inside a
    larger buffer), so the tensor-core kernels can read it."""
    return t.clone() if t.data_ptr() % TMA_ALIGN else t


def _check_tma(name: str, tensors) -> None:
    """The tensor-core kernels read their operands through TMA tensor
    maps, whose base addresses must be 16-byte aligned."""
    for arg, t in tensors:
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"{name}: {arg} must start on a {TMA_ALIGN}-"
                             f"byte boundary for the tensor-core kernel")


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the flash forward kernel that ``flash_route`` names on the
    card: q, k, v contiguous CUDA tensors of one dtype (f32 or bf16).
    Returns ``(o, lse)`` as ``flash_fwd_plain`` does (the wgmma route
    with p rounded to bf16, as ``round_p``).  Counts the launch
    (``flash_fwd_cuda.launches`` for the FP32-FMA kernel,
    ``.launches_wgmma`` for the tensor-core one).  Never synchronises."""
    BH, S, T, hd, hdv = check_shapes(q, k, v)
    operands = (("q", q), ("k", k), ("v", v))
    _check_card("flash_fwd", operands, q, BH)
    scale = scale if scale is not None else hd ** -0.5
    o = torch.empty((BH, S, hdv), dtype=q.dtype, device=q.device)
    lse = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if flash_route(q.dtype, hd, hdv) == "wgmma":
            _check_tma("flash_fwd", operands)
            raise_on_error("flash_fwd_wgmma", build.launcher(
                "flash_fwd_wgmma")(*ptrs, BH, S, T, hd, int(bool(causal)),
                                   float(scale), stream))
            flash_fwd_cuda.launches_wgmma += 1
        else:
            raise_on_error("flash_fwd", build.launcher("flash_fwd")(
                *ptrs, BH, S, T, hd, hdv, DTYPE_CODES[q.dtype],
                int(bool(causal)), float(scale), stream))
            flash_fwd_cuda.launches += 1
    key = _shape_key(q, S, T, hd, hdv, causal)
    flash_fwd_cuda.by_shape[key] = flash_fwd_cuda.by_shape.get(key, 0) + 1
    return o, lse


def _shape_key(q, S, T, hd, hdv, causal) -> tuple:
    """(route, BH, S, T, hd, hdv, dtype, causal) of a launch."""
    return (flash_route(q.dtype, hd, hdv), q.shape[0], S, T, hd, hdv,
            str(q.dtype).replace("torch.", ""), bool(causal))


flash_fwd_cuda.launches = 0
flash_fwd_cuda.launches_wgmma = 0
flash_fwd_cuda.by_shape = {}        # launches by _shape_key


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = sum(do * o, -1)`` in f32, (BH, S): computed outside the
    backward kernels, as the JAX package does."""
    return (do.float() * o.float()).sum(-1)


def _check_bwd(q, k, v, do, lse, delta):
    BH, S, T, hd, hdv = check_shapes(q, k, v)
    if do.shape != (BH, S, hdv):
        raise ValueError(f"flash_bwd: do {tuple(do.shape)} must be "
                         f"{(BH, S, hdv)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (BH, S) or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError(f"flash_bwd: {name} must be a ({BH}, {S}) f32 "
                             f"tensor on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return BH, S, T, hd, hdv


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor, lse: torch.Tensor,
                    delta: torch.Tensor, causal: bool = True,
                    scale: Optional[float] = None, round_p: bool = False,
                    round_dq: bool = False):
    """``(dq, dk, dv)`` in q's, k's and v's dtypes through the whole (S, T)
    softmax in f32: ``ref.flash_attention_bwd_ref`` (``round_p``: p and
    ds rounded to the inputs' dtype in the dk and dv products;
    ``round_dq``: ds rounded in the dq product)."""
    _check_bwd(q, k, v, do, lse, delta)
    return flash_attention_bwd_ref(q, k, v, do, lse, delta, causal, scale,
                                   round_p=round_p, round_dq=round_dq)


def flash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                   causal: bool = True, scale: Optional[float] = None):
    """Launch the dq kernel and then the dkv kernel that ``flash_route``
    names on the card: q, k, v and do contiguous CUDA tensors of one dtype
    (f32 or bf16), lse and delta (BH, S) f32.  Returns ``(dq, dk, dv)`` as
    ``flash_bwd_plain`` does (the wgmma route's dk and dv as with
    ``round_p``, its dq as with ``round_dq``).  Counts each launch
    (``flash_bwd_cuda.launches_dq`` and ``.launches_dkv`` for the
    FP32-FMA kernels, ``.launches_dq_wgmma`` and ``.launches_dkv_wgmma``
    for the tensor-core ones).  Never synchronises."""
    BH, S, T, hd, hdv = _check_bwd(q, k, v, do, lse, delta)
    operands = (("q", q), ("k", k), ("v", v), ("do", do))
    _check_card("flash_bwd", operands, q, BH)
    for name, t in (("lse", lse), ("delta", delta)):
        if not t.is_contiguous():
            raise ValueError(f"flash_bwd: {name} must be contiguous")
    wgmma = flash_route(q.dtype, hd, hdv) == "wgmma"
    if wgmma:
        _check_tma("flash_bwd", operands)
    scale = scale if scale is not None else hd ** -0.5
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), BH, S, T, hd, hdv,
                DTYPE_CODES[q.dtype], int(bool(causal)), float(scale))
        stream = torch.cuda.current_stream().cuda_stream
        if wgmma:
            raise_on_error("flash_bwd_dq_wgmma", build.launcher(
                "flash_bwd_dq_wgmma")(*args[:7], BH, S, T, hd,
                                      int(bool(causal)), float(scale),
                                      stream))
            flash_bwd_cuda.launches_dq_wgmma += 1
            raise_on_error("flash_bwd_dkv_wgmma", build.launcher(
                "flash_bwd_dkv_wgmma")(*args[:6], dk.data_ptr(),
                                       dv.data_ptr(), BH, S, T, hd,
                                       int(bool(causal)), float(scale),
                                       stream))
            flash_bwd_cuda.launches_dkv_wgmma += 1
        else:
            launch = build.launcher("flash_bwd")
            raise_on_error("flash_bwd_dq", launch(*args, 0, stream))
            flash_bwd_cuda.launches_dq += 1
            raise_on_error("flash_bwd_dkv", launch(*args, 1, stream))
            flash_bwd_cuda.launches_dkv += 1
    key = _shape_key(q, S, T, hd, hdv, causal)
    flash_bwd_cuda.by_shape[key] = flash_bwd_cuda.by_shape.get(key, 0) + 1
    return dq, dk, dv


flash_bwd_cuda.by_shape = {}        # dq + dkv launch pairs by _shape_key
flash_bwd_cuda.launches_dq = 0
flash_bwd_cuda.launches_dq_wgmma = 0
flash_bwd_cuda.launches_dkv = 0
flash_bwd_cuda.launches_dkv_wgmma = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention over (BH, S|T, hd): ``(o, lse)``,
    with ``lse`` not differentiable (the counterpart of the JAX
    ``custom_vjp`` ``flash_attention``).  The forward runs the flash
    forward (the kernel on the card, its plain version on the CPU) and
    saves ``q, k, v, o, lse``; the backward computes ``delta`` in f32 and
    runs ``kernels.ops.flash_bwd``.  On the tensor-core route every
    operand starts on a TMA boundary (``_tma_ready``), and the aligned
    copies are the ones saved."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, scale=None):
        # the kernels take contiguous operands; a (B, S, H, hd) -> (B H,
        # S, hd) reshape with B = 1 is a strided view
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if flash_route(q.dtype, q.shape[-1], v.shape[-1]) == "wgmma":
            q, k, v = _tma_ready(q), _tma_ready(k), _tma_ready(v)
        fn = flash_fwd_cuda if on_card(q, "flash_fwd") else flash_fwd_plain
        o, lse = fn(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        from . import ops          # ops imports this module
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if flash_route(q.dtype, q.shape[-1], v.shape[-1]) == "wgmma":
            do = _tma_ready(do)
        dq, dk, dv = ops.flash_bwd(q, k, v, do, lse, flash_delta(o, do),
                                   ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable flash attention over (BH, S|T, hd): ``o`` (BH, S,
    hdv) in q's dtype."""
    return FlashAttention.apply(q, k, v, causal, scale)[0]
