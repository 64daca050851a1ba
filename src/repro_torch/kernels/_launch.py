"""Argument checks and codes shared by the kernel wrappers."""
from __future__ import annotations

import functools

import torch

from repro_torch.core.kernels import KernelConfig

KERNEL_CODES = {"linear": 0, "polynomial": 1, "rbf": 2}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the f64 route (csrc/f64_tile.cuh): kmv, gram and the streamed KMV take
# f64 through entry points of their own, which sum in f64
DTYPE_F64 = 2


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """What the KMV and gram kernels, and their plain versions, sum in
    for inputs of ``dtype``: f64 for f64, f32 for f32 and bf16."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def card_tensor(t: torch.Tensor) -> bool:
    """Whether a kernel may take ``t``: a CUDA tensor.  (Without a card,
    ``analysis.registry.capture`` widens this to CPU tensors while its
    stub launchers stand in for the kernels.)"""
    return t.device.type == "cuda"


def pinned_host(t: torch.Tensor) -> bool:
    """Whether ``t`` is page-locked host memory, which the streamed
    kernels read over the link (widened like ``card_tensor``)."""
    return t.device.type == "cpu" and t.is_pinned()


def check_inputs(name: str, A: torch.Tensor, B: torch.Tensor,
                 f64: bool = False) -> int:
    """Validate the (m, n) / (r, n) operands of a kernel; returns the
    dtype code (``DTYPE_F64`` for f64, which only a kernel with an f64
    route takes: ``f64=True``).  Raises on anything the kernel does not
    take."""
    for arg, t in (("A", A), ("B", B)):
        if not card_tensor(t):
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got "
                             f"{t.device}")
        if t.ndim != 2:
            raise ValueError(f"{name}: {arg} must be 2-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if 0 in t.shape:
            raise ValueError(f"{name}: {arg} must not be empty, got shape "
                             f"{tuple(t.shape)}")
    codes = {**DTYPE_CODES, torch.float64: DTYPE_F64} if f64 else \
        DTYPE_CODES
    if A.dtype not in codes or B.dtype != A.dtype:
        raise ValueError(f"{name}: A and B must share a dtype in "
                         f"{list(codes)}, got {A.dtype} and {B.dtype}")
    if A.shape[1] != B.shape[1]:
        raise ValueError(f"{name}: A {tuple(A.shape)} and B "
                         f"{tuple(B.shape)} differ in feature width")
    if A.device != B.device:
        raise ValueError(f"{name}: A on {A.device} but B on {B.device}")
    return codes[A.dtype]


def kernel_args(cfg: KernelConfig):
    """(kind, degree, coef0, sigma) as the C entry points take them."""
    return (KERNEL_CODES[cfg.name], int(cfg.degree), float(cfg.coef0),
            float(cfg.sigma))


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a card: what the kernels that split
    their work across blocks (kmv, gram) aim to fill."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def on_card(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def raise_on_error(name: str, code: int) -> None:
    """Raise for a C entry point's non-zero return: a CUDA error code, or
    from 1000 on (csrc/wgmma_tile.cuh WG_ERR_*) a tensor map that could
    not be made."""
    if code >= 1000:
        raise RuntimeError(f"{name}: the TMA tensor maps could not be made "
                           f"(code {code})")
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{code}")
