"""Kernel functions (paper Table 1), the gram slab, and the exact
``GramOperator`` — the PyTorch counterpart of ``repro/core/kernels.py``.

Solvers never consume an ``m x (s*b)`` kernel slab directly: they read it
through an operator's three reductions (``matvec``, ``cross_block``,
``diag``).  ``ExactGramOperator`` routes them through ``kernels.ops``,
which launches the hand-written KMV / gram CUDA kernels for tensors on
the card and the plain PyTorch versions for tensors on the CPU.

Only the exact representation is ported here; the low-rank and
streaming operators are later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

LINEAR = "linear"
POLYNOMIAL = "polynomial"
RBF = "rbf"

_VALID = (LINEAR, POLYNOMIAL, RBF)


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Configuration of the kernel function K (paper Table 1).

    linear:      K(x, z) = x.z
    polynomial:  K(x, z) = (c + x.z)^d          (c >= 0, d >= 2)
    rbf:         K(x, z) = exp(-sigma ||x-z||^2) (sigma > 0)
    """

    name: str = RBF
    degree: int = 3
    coef0: float = 0.0
    sigma: float = 1.0

    def __post_init__(self):
        if self.name not in _VALID:
            raise ValueError(f"unknown kernel {self.name!r}; expected one "
                             f"of {_VALID}")


def integer_pow(x: torch.Tensor, degree: int) -> torch.Tensor:
    """``x ** degree`` by repeated multiplication (binary exponentiation),
    the same sequence of products as jnp's integer ``**`` — so the
    polynomial epilogue rounds the way the JAX package's does."""
    if degree == 0:
        return torch.ones_like(x)
    acc = None
    y = degree
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def apply_epilogue(dots: torch.Tensor, cfg: KernelConfig,
                   row_sqnorms: Optional[torch.Tensor] = None,
                   col_sqnorms: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Pointwise kernel epilogue on a block of dot products
    ``dots[i, j] = a_i . b_j``; RBF needs the squared row norms of A and
    B so that ``||a_i - b_j||^2 = ||a_i||^2 + ||b_j||^2 - 2 a_i.b_j``."""
    if cfg.name == LINEAR:
        return dots
    if cfg.name == POLYNOMIAL:
        return integer_pow(cfg.coef0 + dots, cfg.degree)
    if row_sqnorms is None or col_sqnorms is None:
        raise ValueError("the rbf epilogue needs row and column norms")
    sq = row_sqnorms[:, None] + col_sqnorms[None, :] - 2.0 * dots
    # clamp the tiny negatives cancellation produces, so exp stays <= 1
    return torch.exp(-cfg.sigma * torch.clamp(sq, min=0.0))


def gram_slab(A: torch.Tensor, B: torch.Tensor,
              cfg: KernelConfig) -> torch.Tensor:
    """The kernel slab ``K(A, B)``: (m, r) for A: (m, n), B: (r, n)."""
    dots = A @ B.T
    if cfg.name == RBF:
        return apply_epilogue(dots, cfg, torch.sum(A * A, dim=1),
                              torch.sum(B * B, dim=1))
    return apply_epilogue(dots, cfg)


def gram_full(A: torch.Tensor, cfg: KernelConfig) -> torch.Tensor:
    """Full m x m kernel matrix (oracles and closed-form solves only)."""
    return gram_slab(A, A, cfg)


def kernel_diag(B: torch.Tensor, cfg: KernelConfig) -> torch.Tensor:
    """``diag K(B, B)`` without forming the block: (r,) for B: (r, n)."""
    sq = torch.sum(B * B, dim=1)
    if cfg.name == LINEAR:
        return sq
    if cfg.name == POLYNOMIAL:
        return integer_pow(cfg.coef0 + sq, cfg.degree)
    return torch.ones_like(sq)                   # RBF: K(x, x) = 1


def kmv_slab_free(A: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
                  cfg: KernelConfig, block: int = 2048) -> torch.Tensor:
    """``U^T X`` with ``U = K(A, B)``, without an ``m x r`` slab.

    linear:    ``B (A^T X)`` — pure algebra, the slab never exists.
    poly/rbf:  a loop over ``block``-row chunks of A; each (block x r)
               kernel tile is built, contracted against its X chunk and
               dropped, so the extra memory is O(block * r).

    X: (m,) or (m, c); returns (r,) / (r, c).
    """
    vec = X.ndim == 1
    Xc = X[:, None] if vec else X
    if cfg.name == LINEAR:
        out = B @ (A.T @ Xc)
    else:
        cs = torch.sum(B * B, dim=1) if cfg.name == RBF else None
        out = torch.zeros((B.shape[0], Xc.shape[1]), dtype=Xc.dtype,
                          device=Xc.device)
        for lo in range(0, A.shape[0], block):
            a_blk = A[lo:lo + block]
            dots = a_blk @ B.T
            if cfg.name == RBF:
                Kb = apply_epilogue(dots, cfg,
                                    torch.sum(a_blk * a_blk, dim=1), cs)
            else:
                Kb = apply_epilogue(dots, cfg)
            out = out + Kb.T @ Xc[lo:lo + block]
    return out[:, 0] if vec else out


def _ops():
    # kernels.ops imports this module for KernelConfig; import it late
    from repro_torch.kernels import ops
    return ops


class GramOperator:
    """Abstract kernel representation: slab-free access to the gram
    matrix ``K`` of a fixed training set.

      ``matvec(idx, X)``    -> ``U^T X``       with ``U = K(A, A[idx])``
      ``cross_block(idx)``  -> ``U[idx, :]``   the sampled gram block
      ``diag(idx)``         -> ``diag K`` at idx
      ``round_data(idx, X)``-> (cross_block, matvec) of one s-step round
      ``full_matvec(X)``    -> ``K @ X``       one full-width KMV
      ``serve_weights(w)``  -> representation-side precompute for serving
      ``serve_block(Xq, sw)``-> ``K(Xq, train) @ w`` for one query block

    plus ``scale_rows(y)`` (the K-SVM ``diag(y)`` data scaling) and
    ``take(idx)`` (support-vector compaction), both returning a new
    operator.
    """

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def matvec(self, idx: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def cross_block(self, idx: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def diag(self, idx: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @property
    def n_samples(self) -> int:
        raise NotImplementedError

    @property
    def feature_dim(self) -> Optional[int]:
        """Width of the raw query rows ``serve_block`` accepts."""
        raise NotImplementedError

    @property
    def dtype(self) -> torch.dtype:
        """Dtype query blocks must arrive in (serving never casts)."""
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def scale_rows(self, y: torch.Tensor) -> "GramOperator":
        raise NotImplementedError

    def take(self, idx: torch.Tensor) -> "GramOperator":
        raise NotImplementedError

    def serve_weights(self, w: torch.Tensor) -> torch.Tensor:
        return w

    def serve_block(self, Xq: torch.Tensor, sw: torch.Tensor
                    ) -> torch.Tensor:
        raise NotImplementedError

    def round_data(self, idx: torch.Tensor, X: torch.Tensor):
        """(cross_block, matvec) for one s-step round."""
        return self.cross_block(idx), self.matvec(idx, X)

    def full_matvec(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ExactGramOperator(GramOperator):
    """Exact-kernel representation: raw features + kernel config.

    ``matvec``, ``round_data``, ``full_matvec`` and ``serve_block`` run
    the KMV kernel and ``cross_block`` the gram kernel (``kernels.ops``);
    on CPU tensors both dispatch to their plain PyTorch versions."""

    A: torch.Tensor
    cfg: KernelConfig

    def rows(self, idx):
        return self.A[idx]

    def matvec(self, idx, X):
        return _ops().kmv(self.A, self.A[idx], X, self.cfg).to(X.dtype)

    def cross_block(self, idx):
        B = self.A[idx]
        return _ops().gram(B, B, self.cfg).to(self.A.dtype)

    def diag(self, idx):
        return kernel_diag(self.A[idx], self.cfg)

    def round_data(self, idx, X):
        # one gather of the sampled rows serves both launches
        B = self.A[idx]
        return (_ops().gram(B, B, self.cfg).to(self.A.dtype),
                _ops().kmv(self.A, B, X, self.cfg).to(X.dtype))

    @property
    def n_samples(self) -> int:
        return self.A.shape[0]

    @property
    def feature_dim(self) -> int:
        return self.A.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.A.dtype

    @property
    def device(self) -> torch.device:
        return self.A.device

    def scale_rows(self, y):
        """Operator over ``diag(y) A`` — the solvers' K-SVM data scaling,
        kept exactly as the JAX package has it: for nonlinear kernels
        ``K(diag(y) A)`` is NOT ``diag(y) K diag(y)``."""
        return dataclasses.replace(self, A=y[:, None] * self.A)

    def take(self, idx):
        return dataclasses.replace(self, A=self.A[idx])

    def serve_block(self, Xq, sw):
        # K(A, Xq)^T sw == K(Xq, A) @ sw: one KMV with the queries as the
        # sampled rows, slab-free over the training dimension
        return _ops().kmv(self.A, Xq, sw, self.cfg).to(sw.dtype)

    def full_matvec(self, X):
        # K symmetric: K @ X == K(A, A)^T X — one full-width KMV
        return _ops().kmv(self.A, self.A, X, self.cfg).to(X.dtype)
