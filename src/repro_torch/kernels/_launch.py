"""Argument checks and codes shared by the kernel wrappers."""
from __future__ import annotations

import functools

import torch

from repro_torch.core.kernels import KernelConfig

KERNEL_CODES = {"linear": 0, "polynomial": 1, "rbf": 2}
BM = 64                    # tile rows (rows of A), csrc/kernel_tile.cuh
BR = 64                    # tile columns (rows of B)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_inputs(name: str, A: torch.Tensor, B: torch.Tensor) -> int:
    """Validate the (m, n) / (r, n) operands of a kernel; returns the
    dtype code.  Raises on anything the kernel does not take."""
    for arg, t in (("A", A), ("B", B)):
        if t.device.type != "cuda":
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
    if A.dtype not in DTYPE_CODES or B.dtype != A.dtype:
        raise ValueError(f"{name}: A and B must share a dtype in "
                         f"{list(DTYPE_CODES)}, got {A.dtype} and "
                         f"{B.dtype}")
    if A.shape[1] != B.shape[1]:
        raise ValueError(f"{name}: A {tuple(A.shape)} and B "
                         f"{tuple(B.shape)} differ in feature width")
    if A.device != B.device:
        raise ValueError(f"{name}: A on {A.device} but B on {B.device}")
    return DTYPE_CODES[A.dtype]


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
