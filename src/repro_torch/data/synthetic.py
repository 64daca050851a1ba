"""Synthetic datasets shaped like the paper's LIBSVM benchmarks (Table
2/3) — the counterpart of ``repro/data/synthetic.py``, drawn from a
``torch.Generator`` (the same shapes and distributions; not the same
numbers as the JAX PRNG).

    duke-like:   m=44,    n=7129  dense, binary labels
    diabetes:    m=768,   n=8     dense, binary labels
    abalone:     m=4177,  n=8     dense, regression
    bodyfat:     m=252,   n=14    dense, regression
    news20-like: m=19996, n=8192  ~0.03% density, binary labels
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.device import resolve_device


def classification_dataset(gen: torch.Generator, m: int, n: int,
                           margin: float = 0.5,
                           dtype: torch.dtype = torch.float32,
                           device=None):
    """Two Gaussian blobs separated along a random direction, labels +-1.
    Features are scaled to unit-ish norms so RBF sigma=1 is sensible."""
    src, dst = gen.device, resolve_device(device)   # draw, then move
    w = torch.randn(n, generator=gen, device=src, dtype=dtype)
    w = w / torch.linalg.norm(w)
    y = torch.where(torch.rand(m, generator=gen, device=src) < 0.5,
                    1.0, -1.0).to(dtype)
    X = torch.randn((m, n), generator=gen, device=src,
                    dtype=dtype) / math.sqrt(n)
    X = X + margin * y[:, None] * w[None, :] / math.sqrt(n)
    return X.to(dst), y.to(dst)


def regression_dataset(gen: torch.Generator, m: int, n: int,
                       noise: float = 0.1,
                       dtype: torch.dtype = torch.float32, device=None):
    """y = sin(Xw) + noise — nonlinear so kernel methods beat linear ones."""
    src, dst = gen.device, resolve_device(device)   # draw, then move
    X = torch.randn((m, n), generator=gen, device=src,
                    dtype=dtype) / math.sqrt(n)
    w = torch.randn(n, generator=gen, device=src, dtype=dtype)
    y = torch.sin(X @ w) + noise * torch.randn(m, generator=gen,
                                               device=src, dtype=dtype)
    return X.to(dst), y.to(dst)


def sparse_classification_dataset(gen: torch.Generator, m: int, n: int,
                                  density: float = 0.001,
                                  dtype: torch.dtype = torch.float32,
                                  device=None):
    """Dense array with a news20-like sparsity pattern (uniform nnz
    placement); labels are drawn independently of the features."""
    src, dst = gen.device, resolve_device(device)   # draw, then move
    mask = torch.rand((m, n), generator=gen, device=src) < density
    vals = torch.randn((m, n), generator=gen, device=src, dtype=dtype)
    X = torch.where(mask, vals, torch.zeros((), dtype=dtype, device=src))
    y = torch.where(torch.rand(m, generator=gen, device=src) < 0.5,
                    1.0, -1.0).to(dtype)
    return X.to(dst), y.to(dst)


# The paper's dataset inventory, at matching scales (the JAX package's
# table, copied: this package imports nothing of the JAX one).
PAPER_DATASETS = {
    "duke": dict(kind="classification", m=44, n=7129),
    "diabetes": dict(kind="classification", m=768, n=8),
    "abalone": dict(kind="regression", m=4177, n=8),
    "bodyfat": dict(kind="regression", m=252, n=14),
    "colon-cancer": dict(kind="classification", m=62, n=2000),
    "news20-like": dict(kind="sparse", m=19996, n=8192, density=0.0003),
    "synthetic-sparse": dict(kind="sparse", m=2000, n=8192, density=0.01),
}


def load(name: str, gen: Optional[torch.Generator] = None,
         dtype: torch.dtype = torch.float32, device=None):
    """One dataset of ``PAPER_DATASETS`` on ``device`` (default: the card);
    ``gen`` defaults to a CPU generator seeded with 0."""
    spec = dict(PAPER_DATASETS[name])
    kind = spec.pop("kind")
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    make = {"classification": classification_dataset,
            "regression": regression_dataset}.get(
                kind, sparse_classification_dataset)
    return make(gen, dtype=dtype, device=device, **spec)
