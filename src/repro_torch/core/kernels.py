"""Kernel functions (paper Table 1), the gram slab, and the exact
``GramOperator`` — the PyTorch counterpart of ``repro/core/kernels.py``.

Solvers never consume an ``m x (s*b)`` kernel slab directly: they read it
through an operator's three reductions (``matvec``, ``cross_block``,
``diag``).  ``ExactGramOperator`` routes them through ``kernels.ops``,
which launches the hand-written KMV / gram CUDA kernels for tensors on
the card and the plain PyTorch versions for tensors on the CPU.

Three representations: ``ExactGramOperator`` (raw features on the
device), ``LowRankGramOperator`` (a Nystrom factor ``Phi``, every
reduction an O(l)-wide product) and ``StreamingGramOperator`` (raw
features chunked in pinned host memory, streamed through the
``kmv_stream`` pipeline).
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
      ``apply_at(idx, w)``  -> ``K[:, idx] @ w`` the guarded recurrence
      ``full_matvec(X)``    -> ``K @ X``       one full-width KMV
      ``serve_weights(w)``  -> representation-side precompute for serving
      ``serve_block(Xq, sw)``-> ``K(Xq, train) @ w`` for one query block

    plus ``scale_rows(y)`` (the K-SVM ``diag(y)`` data scaling) and
    ``take(idx)`` (support-vector compaction), both returning a new
    operator.

    ``capturable`` says whether a round and a check through the operator
    can be captured as a CUDA graph (``core.loop.RoundGraphs``): launches
    on the current stream only, no host synchronisation.  The solvers and
    the facade drive a capturable operator's rounds through the graphs,
    any other's through the eager loop.
    """

    capturable = False

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

    def astype(self, dtype: torch.dtype) -> "GramOperator":
        """The same operator over data cast to ``dtype`` (the guarded
        fit's f64 rung)."""
        raise NotImplementedError

    def serve_weights(self, w: torch.Tensor) -> torch.Tensor:
        return w

    def serve_block(self, Xq: torch.Tensor, sw: torch.Tensor
                    ) -> torch.Tensor:
        raise NotImplementedError

    def round_data(self, idx: torch.Tensor, X: torch.Tensor):
        """(cross_block, matvec) for one s-step round."""
        return self.cross_block(idx), self.matvec(idx, X)

    def apply_at(self, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``K[:, idx] @ w``: the guarded rounds' residual recurrence
        (after a round adds w to ``alpha[idx]``, ``f = K alpha`` advances
        by this column combination).  (m,) for w: (s*b,)."""
        raise NotImplementedError

    def full_matvec(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


# repro: noqa[CHK-TREE] an operator is held by the round functions' closures
#   and never carried in a tree (the carry is alpha and f)
@dataclasses.dataclass(frozen=True)
class ExactGramOperator(GramOperator):
    """Exact-kernel representation: raw features + kernel config.

    ``matvec``, ``round_data``, ``full_matvec`` and ``serve_block`` run
    the KMV kernel and ``cross_block`` the gram kernel (``kernels.ops``);
    on CPU tensors both dispatch to their plain PyTorch versions."""

    capturable = True

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

    def astype(self, dtype):
        return dataclasses.replace(self, A=self.A.to(dtype))

    def serve_block(self, Xq, sw):
        # K(A, Xq)^T sw == K(Xq, A) @ sw: one KMV with the queries as the
        # sampled rows, slab-free over the training dimension
        return _ops().kmv(self.A, Xq, sw, self.cfg).to(sw.dtype)

    def apply_at(self, idx, w):
        # K symmetric: K(A, A[idx]) @ w == K(A[idx], A)^T w — the KMV
        # kernel with its operands swapped, contracting over the sb
        # sampled rows into all m outputs
        return _ops().kmv(self.A[idx], self.A, w, self.cfg).to(w.dtype)

    def full_matvec(self, X):
        # K symmetric: K @ X == K(A, A)^T X — one full-width KMV
        return _ops().kmv(self.A, self.A, X, self.cfg).to(X.dtype)


# repro: noqa[CHK-TREE] an operator is held by the round functions' closures
#   and never carried in a tree (the carry is alpha and f)
@dataclasses.dataclass(frozen=True)
class LowRankGramOperator(GramOperator):
    """Low-rank representation ``K ~= Phi Phi^T`` (Nystrom): every
    reduction is an O(l)-wide linear contraction over the factor
    ``Phi`` (m, l); the raw features and the nonlinear epilogue are
    never touched again.  ``fmap`` (a ``nystrom.NystromMap``) maps new
    points into the same feature space and is needed only to serve."""

    capturable = True

    Phi: torch.Tensor
    fmap: Optional[object] = None

    def rows(self, idx):
        return self.Phi[idx]

    def matvec(self, idx, X):
        return self.Phi[idx] @ (self.Phi.T @ X)

    def cross_block(self, idx):
        R = self.Phi[idx]
        return R @ R.T

    def diag(self, idx):
        R = self.Phi[idx]
        return torch.sum(R * R, dim=1)

    @property
    def n_samples(self) -> int:
        return self.Phi.shape[0]

    @property
    def rank(self) -> int:
        return self.Phi.shape[1]

    @property
    def feature_dim(self) -> Optional[int]:
        # queries arrive in raw feature space and go through the map
        if self.fmap is None:
            return None
        return self.fmap.landmarks.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.Phi.dtype

    @property
    def device(self) -> torch.device:
        return self.Phi.device

    def scale_rows(self, y):
        """``diag(y) Phi``: exactly ``diag(y) K~ diag(y)``, the textbook
        K-SVM scaling.  For nonlinear kernels this differs from the exact
        path's ``K(diag(y) A)`` convention, as in the JAX package."""
        return dataclasses.replace(self, Phi=y[:, None] * self.Phi)

    def take(self, idx):
        return dataclasses.replace(self, Phi=self.Phi[idx])

    def astype(self, dtype):
        fmap = self.fmap
        if fmap is not None:
            fmap = dataclasses.replace(
                fmap, landmarks=fmap.landmarks.to(dtype),
                transform=fmap.transform.to(dtype))
        return dataclasses.replace(self, Phi=self.Phi.to(dtype), fmap=fmap)

    def serve_weights(self, w):
        return self.Phi.T @ w                     # (l,): the whole model

    def serve_block(self, Xq, sw):
        if self.fmap is None:
            raise ValueError(
                "LowRankGramOperator has no feature map (fmap=None): "
                "serving new points needs one — build the operator with "
                "repro_torch.core.nystrom.fit_nystrom or the facade "
                "(SolverOptions(approx='nystrom'))")
        return self.fmap(Xq) @ sw                 # O(l) per query

    def apply_at(self, idx, w):
        return self.Phi @ (self.Phi[idx].T @ w)   # O(m l), no slab

    def full_matvec(self, X):
        return self.Phi @ (self.Phi.T @ X)        # O(m l), exact in K~


def _chunk(X: torch.Tensor, chunk_rows: int,
           pin: bool = False) -> torch.Tensor:
    """(m, ...) -> (nc, chunk_rows, ...) with a zero-padded tail chunk,
    in one fresh buffer on X's device (page-locked when ``pin``).
    Chunks are contiguous, so row i of X is row i of the flattened
    result."""
    m = X.shape[0]
    nc = -(-m // chunk_rows)
    out = torch.empty((nc * chunk_rows,) + tuple(X.shape[1:]),
                      dtype=X.dtype, device=X.device, pin_memory=pin)
    out[:m].copy_(X)
    out[m:].zero_()
    return out.view((nc, chunk_rows) + tuple(X.shape[1:]))


# repro: noqa[CHK-TREE] an operator is held by the round functions' closures
#   and never carried in a tree; its chunks stay in pinned host memory
@dataclasses.dataclass(frozen=True)
class StreamingGramOperator(GramOperator):
    """Out-of-core exact-kernel representation: the data lives on the
    HOST, chunked as ``Xc: (n_chunks, chunk_rows, n)`` with a
    zero-padded tail.  When the contractions run on the card
    (``compute_device`` is CUDA), ``Xc`` is page-locked and is never
    copied to the device whole: every reduction streams it through the
    ``kmv_stream`` pipeline (pinned host -> two device slots, copies on
    a side stream overlapping the contraction), so the device holds two
    chunks (three in ``full_matvec``), the right-hand side and the
    sampled rows, never A.

      ``matvec``/``serve_block``  one streamed KMV each;
      ``full_matvec``  one symmetric streamed pass (an anchor chunk in a
          third device slot, each chunk pair computed once);
      ``cross_block``/``diag``/``rows``  gather only the sampled rows
          from host memory: on the card a small kernel reads them
          straight from the mapped pinned buffer at device-side indices,
          so a round never waits on the host for its schedule.

    ``scale_rows`` and ``take`` build new pinned chunked buffers on the
    host.  With ``compute_device`` the CPU, everything is ordinary CPU
    tensors and the plain versions run.  Not ``capturable`` yet: the
    pipe's pinned copies and cross-stream events stay eager (ROADMAP
    A14d).
    """

    Xc: torch.Tensor                       # (nc, chunk_rows, n), host
    cfg: KernelConfig
    m: int                                 # true rows
    compute_device: torch.device

    @classmethod
    def from_dense(cls, A: torch.Tensor, cfg: KernelConfig,
                   chunk_rows: int, device=None
                   ) -> "StreamingGramOperator":
        """Chunk A (any device; it is read once, to the host) for
        streamed contractions on ``device`` (default: the CPU)."""
        if not isinstance(chunk_rows, int) or isinstance(chunk_rows, bool) \
                or chunk_rows < 1:
            raise ValueError(f"chunk_rows must be a positive int, got "
                             f"{chunk_rows!r}")
        dev = torch.device(device if device is not None else "cpu")
        chunk_rows = min(chunk_rows, A.shape[0])
        Xc = _chunk(A.cpu(), chunk_rows, pin=dev.type == "cuda")
        return cls(Xc, cfg, A.shape[0], dev)

    @property
    def chunk_rows(self) -> int:
        return self.Xc.shape[1]

    @property
    def n_chunks(self) -> int:
        return self.Xc.shape[0]

    @property
    def _pin(self) -> bool:
        return self.compute_device.type == "cuda"

    def rows(self, idx):
        return _ops().gather_rows(self.Xc, idx.to(self.compute_device))

    @property
    def _acc(self) -> torch.dtype:
        """The pipes' accumulation dtype: f64 for f64 data, else f32."""
        return (torch.float64 if self.Xc.dtype == torch.float64
                else torch.float32)

    def _stream_kmv(self, B: torch.Tensor, X: torch.Tensor
                    ) -> torch.Tensor:
        """``K(A, B)^T X`` streamed over the chunks."""
        vec = X.ndim == 1
        Xvc = _chunk(X.reshape(X.shape[0], -1).to(self._acc),
                     self.chunk_rows)                  # (nc, cr, c)
        out = _ops().kmv_stream(self.Xc, B, Xvc, self.cfg,
                                m=self.m).to(X.dtype)
        return out[:, 0] if vec else out

    def matvec(self, idx, X):
        return self._stream_kmv(self.rows(idx), X)

    def cross_block(self, idx):
        B = self.rows(idx)
        return _ops().gram(B, B, self.cfg).to(self.dtype)

    def diag(self, idx):
        return kernel_diag(self.rows(idx), self.cfg)

    def round_data(self, idx, X):
        # one gather of the sampled rows serves both launches
        B = self.rows(idx)
        return (_ops().gram(B, B, self.cfg).to(self.dtype),
                self._stream_kmv(B, X))

    @property
    def n_samples(self) -> int:
        return self.m

    @property
    def feature_dim(self) -> int:
        return self.Xc.shape[2]

    @property
    def dtype(self) -> torch.dtype:
        return self.Xc.dtype

    @property
    def device(self) -> torch.device:
        return self.compute_device

    def scale_rows(self, y):
        """Operator over ``diag(y) A`` (the exact path's K-SVM
        convention), computed on the host into a new chunked buffer; the
        padded tail stays zero."""
        dtype = torch.promote_types(y.dtype, self.dtype)   # as y * A
        yc = _chunk(y.to("cpu")[:, None], self.chunk_rows)
        out = torch.empty(self.Xc.shape, dtype=dtype, pin_memory=self._pin)
        torch.mul(yc, self.Xc, out=out)
        return dataclasses.replace(self, Xc=out)

    def take(self, idx):
        """Support-vector compaction (host side): gather the kept rows
        and re-chunk them into a new buffer."""
        kept = self.Xc.view(-1, self.Xc.shape[2])[idx.cpu()]
        cr = min(self.chunk_rows, kept.shape[0])
        return dataclasses.replace(self, Xc=_chunk(kept, cr, self._pin),
                                   m=kept.shape[0])

    def astype(self, dtype):
        """A new chunked host buffer (pinned on the card path) in
        ``dtype``."""
        out = torch.empty(self.Xc.shape, dtype=dtype, pin_memory=self._pin)
        out.copy_(self.Xc)
        return dataclasses.replace(self, Xc=out)

    def serve_block(self, Xq, sw):
        # K(Xq, A) @ sw == K(A, Xq)^T sw: the queries are the sampled
        # rows of one streamed KMV, the same pipe as training
        return self._stream_kmv(Xq, sw)

    def apply_at(self, idx, w):
        """``K[:, idx] @ w`` in one streamed pass: each chunk, while it
        sits in a device slot of the pipe, contracts its (cr, sb) kernel
        tile against w into its own rows of the output."""
        vec = w.ndim == 1
        out = _ops().kmv_stream_apply(self.Xc, self.rows(idx),
                                      w.reshape(w.shape[0], -1)
                                      .to(self._acc), self.cfg,
                                      m=self.m).to(w.dtype)
        return out[:, 0] if vec else out

    def full_matvec(self, X):
        """``K @ X`` in one symmetric streamed pass: K is symmetric, so
        each chunk pair i <= j is computed once and serves its mirror
        (the JAX operator computes the nc pieces ``K(A, chunk_j)^T X``,
        the same values)."""
        vec = X.ndim == 1
        Xvc = _chunk(X.reshape(X.shape[0], -1).to(self._acc),
                     self.chunk_rows)                  # (nc, cr, c)
        out = _ops().kmv_stream_full(self.Xc, Xvc, self.cfg,
                                     m=self.m).to(X.dtype)
        return out[:, 0] if vec else out
