"""Nystrom kernel approximation — the counterpart of
``repro/core/nystrom.py``.

K is approximated with l landmark rows: ``K ~= Phi Phi^T`` with
``Phi = K(., L) K_LL^{-1/2}`` in R^{m x l}.  The solvers read kernels
only through a ``GramOperator``, so Nystrom-(B)DCD is the linear-kernel
reduction over the factor Phi, packaged as ``LowRankGramOperator``.

``K(A, L)`` and ``K_LL`` go through ``kernels.ops.gram``: the gram
kernel on the card, its plain version on the CPU.  The eigendecomposition
of ``K_LL`` is a library call (``torch.linalg.eigh``), as the JAX package
leaves ``jnp.linalg.eigh`` to XLA.  Landmarks are drawn from a
``torch.Generator``: the JAX PRNG's streams cannot be replayed, so
parity takes injected landmarks (``fit_nystrom(landmarks=)``) or, for
kmeans, the first centre (``kmeans_landmarks(first=)``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .kernels import KernelConfig, LowRankGramOperator

LANDMARK_METHODS = ("uniform", "kmeans")


def _gram(A, B, cfg: KernelConfig) -> torch.Tensor:
    from repro_torch.kernels import ops   # ops imports core.kernels
    return ops.gram(A, B, cfg).to(A.dtype)


def landmark_generator(seed: int) -> torch.Generator:
    """The landmark draw's generator: its own stream of the facade seed
    (the schedule draws from ``seed`` itself), as the JAX facade folds 1
    into the seed's key."""
    state = np.random.SeedSequence([seed, 1]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


@dataclasses.dataclass(frozen=True)
class NystromMap:
    """Fitted feature map ``phi(x) = K(x, L) @ K_LL^{-1/2}``."""

    landmarks: torch.Tensor                 # (l, n)
    transform: torch.Tensor                 # (l, l) = K_LL^{-1/2}
    kernel: KernelConfig = dataclasses.field(default_factory=KernelConfig)

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        """phi(X): (q, n) -> (q, l)."""
        return _gram(X, self.landmarks, self.kernel) @ self.transform

    @property
    def rank(self) -> int:
        return self.landmarks.shape[0]


def _inv_sqrt_gram(landmarks: torch.Tensor, cfg: KernelConfig,
                   jitter: float) -> torch.Tensor:
    """``K_LL^{-1/2}`` by symmetric eigendecomposition, eigenvalues
    floored at ``jitter``."""
    w, V = torch.linalg.eigh(_gram(landmarks, landmarks, cfg))
    w = torch.clamp(w, min=jitter)
    return (V * w ** -0.5) @ V.T


def nystrom_map(A: torch.Tensor, landmarks: torch.Tensor,
                cfg: KernelConfig, jitter: float = 1e-6) -> torch.Tensor:
    """Phi = K(A, L) @ K_LL^{-1/2}."""
    return _gram(A, landmarks, cfg) @ _inv_sqrt_gram(landmarks, cfg, jitter)


def kmeans_landmarks(gen: Optional[torch.Generator], A: torch.Tensor,
                     l: int, iters: int = 10,
                     first: Optional[int] = None) -> torch.Tensor:
    """Lloyd's-algorithm landmarks from a farthest-first seeding: the
    first centre is row ``first`` (drawn from ``gen`` when None), every
    next one the row farthest from the centres so far, then ``iters``
    Lloyd steps (an empty cluster keeps its centre)."""
    m = A.shape[0]
    if first is None:
        first = int(torch.randint(0, m, (1,), generator=gen))
    a_sq = torch.sum(A * A, dim=1)

    def sq_dist_to(c):
        return torch.clamp(a_sq + torch.sum(c * c) - 2.0 * (A @ c),
                           min=0.0)

    centers = torch.zeros((l, A.shape[1]), dtype=A.dtype, device=A.device)
    centers[0] = A[first]
    mind = sq_dist_to(A[first])
    for k in range(1, l):
        nxt = A[torch.argmax(mind)]
        centers[k] = nxt
        mind = torch.minimum(mind, sq_dist_to(nxt))
    cols = torch.arange(l, device=A.device)
    for _ in range(iters):
        d = (a_sq[:, None] + torch.sum(centers * centers, dim=1)[None, :]
             - 2.0 * (A @ centers.T))                 # (m, l) sq dists
        assign = torch.argmin(d, dim=1)
        onehot = (assign[:, None] == cols[None, :]).to(A.dtype)
        counts = torch.sum(onehot, dim=0)
        sums = onehot.T @ A
        centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts, min=1.0)[:, None],
                              centers)
    return centers


def choose_landmarks(gen: Optional[torch.Generator], A: torch.Tensor,
                     l: int, method: str = "uniform") -> torch.Tensor:
    """``"uniform"`` row sampling without replacement, or ``"kmeans"``
    centroids."""
    if method not in LANDMARK_METHODS:
        raise ValueError(f"landmark method must be one of "
                         f"{LANDMARK_METHODS}, got {method!r}")
    if method == "kmeans":
        return kmeans_landmarks(gen, A, l)
    idx = torch.randperm(A.shape[0], generator=gen)[:l]
    return A[idx.to(A.device)]


def fit_nystrom(gen: Optional[torch.Generator], A: torch.Tensor,
                cfg: KernelConfig, l: int, method: str = "uniform",
                jitter: float = 1e-6,
                landmarks: Optional[torch.Tensor] = None) -> NystromMap:
    """Choose landmarks (or take the given ones) and fit the map."""
    if landmarks is None:
        landmarks = choose_landmarks(gen, A, l, method=method)
    landmarks = landmarks.to(device=A.device, dtype=A.dtype).contiguous()
    return NystromMap(landmarks=landmarks,
                      transform=_inv_sqrt_gram(landmarks, cfg, jitter),
                      kernel=cfg)


def lowrank_operator(fmap: NystromMap, A: torch.Tensor
                     ) -> LowRankGramOperator:
    """``LowRankGramOperator`` over ``Phi = fmap(A)``."""
    return LowRankGramOperator(Phi=fmap(A), fmap=fmap)


def nystrom_kernel_error(A: torch.Tensor, landmarks: torch.Tensor,
                         cfg: KernelConfig) -> float:
    """||K - Phi Phi^T||_F / ||K||_F — the rank-l approximation error
    (forms the m x m gram: a subsample's oracle)."""
    K = _gram(A, A, cfg)
    Phi = nystrom_map(A, landmarks, cfg)
    return float(torch.linalg.norm(K - Phi @ Phi.T) / torch.linalg.norm(K))
