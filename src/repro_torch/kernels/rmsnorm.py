"""RMSNorm: ``y = x * rsqrt(mean(x^2, -1) + eps) * scale`` row by row.

The counterpart of ``repro/kernels/rmsnorm.py`` (``rmsnorm_pallas``).  The
kernel is ``csrc/rmsnorm.cu`` (the model's widths D = 128 and 2048
compiled in, a row read once into registers; f32 statistics, the result
in x's dtype; bound by reading x and writing y once);
``rmsnorm_cuda`` launches it and counts the launches (also by shape),
``rmsnorm_plain``
is the plain PyTorch version.  ``RMSNorm`` is the differentiable
operator: its forward picks between them by device, its backward is
plain PyTorch in f32 (``dx`` and ``dscale`` by the analytic formula from
the saved x; the JAX model differentiates its jnp rmsnorm with autodiff
and has no backward kernel).  ``kernels.ops.rmsnorm`` applies it, and
``models.layers.rmsnorm`` goes through that, so every norm of the LM
runs this kernel on the card, in training too.
"""
from __future__ import annotations

import torch

from . import _launch, build
from ._launch import DTYPE_CODES, on_card, raise_on_error
from .ref import rmsnorm_ref

MAX_ROWS = 2 ** 31 - 1

# The plain version is the oracle itself.
rmsnorm_plain = rmsnorm_ref


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Launch the RMSNorm kernel on the card: x (..., D) contiguous, f32 or
    bf16; scale (D,) f32 on the same device.  Returns y shaped and typed
    like x.  Never synchronises."""
    if not _launch.card_tensor(x):
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
    key = (rows, D, str(x.dtype).replace("torch.", ""))
    rmsnorm_cuda.by_shape[key] = rmsnorm_cuda.by_shape.get(key, 0) + 1
    return out


rmsnorm_cuda.launches = 0
rmsnorm_cuda.by_shape = {}          # launches by (rows, D, dtype)


class RMSNorm(torch.autograd.Function):
    """``y = rmsnorm(x, scale, eps)`` (x any leading shape, scale (D,) f32),
    differentiable in x and scale.  Forward: the kernel on the card, its
    plain version on the CPU.  Backward, plain PyTorch in f32 on both:
    with ``r = rsqrt(mean(x^2) + eps)``, ``xn = x r`` and ``gs = dy
    scale``, ``dx = r (gs - xn mean(gs xn))`` in x's dtype and ``dscale =
    sum over rows of dy xn`` in f32."""

    @staticmethod
    def forward(ctx, x, scale, eps=1e-6):
        if on_card(x, "rmsnorm"):
            y = rmsnorm_cuda(x.contiguous(), scale, eps)
        else:
            y = rmsnorm_plain(x, scale, eps)
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        xf, g = x.float(), dy.float()
        r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + ctx.eps)
        xn = xf * r
        dx = dscale = None
        if ctx.needs_input_grad[0]:
            gs = g * scale.float()
            dx = (r * (gs - xn * (gs * xn).mean(-1, keepdim=True))
                  ).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dscale = (g * xn).reshape(-1, x.shape[-1]).sum(0).to(
                scale.dtype)
        return dx, dscale, None
