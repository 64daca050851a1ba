"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    There is no silent CPU fallback: with no CUDA device and no explicit
    ``device="cpu"`` this raises, so a run that was meant for the card
    never quietly measures the host instead.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the host explicitly")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available")
    return dev


def as_tensor(x, device: Optional[Union[str, torch.device]] = None
              ) -> torch.Tensor:
    """``x`` as a tensor (on ``device`` when given).  Arrays are copied:
    the numpy view of a JAX array is read-only, which torch cannot
    wrap."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x))
    return x if device is None else x.to(device)
