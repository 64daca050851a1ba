"""Batched, slab-free prediction — the counterpart of
``repro/core/predict.py``.

Queries are served through the same ``GramOperator`` the solvers train
through: an exact operator answers each query block with one KMV
(``K(A, Xq)^T w == K(Xq, A) @ w``, the queries as the sampled rows), so
the ``q x m`` test-kernel slab never exists.  K-SVM models are compacted
to their support vectors first (``compact_support``).

Queries are cut into power-of-two blocks (capped at ``batch``), as in
the JAX package: a stream of varying query counts then reaches the
kernel with at most log2(batch) distinct block shapes.  ``w`` may be F
stacked models (m, F), served by one block call per bucket.
"""
from __future__ import annotations

import torch

from repro_torch.device import as_tensor
from .kernels import GramOperator


def validate_queries(op: GramOperator, X, name: str = "A_test"
                     ) -> torch.Tensor:
    """Eager serve-side input validation: a 2-D block of the operator's
    feature width and dtype (serving never casts), returned as a tensor
    on the operator's device.  The offending argument is named."""
    X = as_tensor(X)
    if X.ndim != 2:
        raise ValueError(f"{name} must be 2-D (queries x features), got "
                         f"shape {tuple(X.shape)}")
    if X.shape[1] != op.feature_dim:
        raise ValueError(
            f"{name} has {X.shape[1]} features but the fitted operator "
            f"expects {op.feature_dim} — the query block must match the "
            f"training feature width")
    if X.dtype != op.dtype:
        raise ValueError(
            f"{name} has dtype {X.dtype} but the fitted operator is "
            f"{op.dtype} — cast the queries explicitly (serving never "
            f"silently converts)")
    return X.to(op.device)


def compact_support(op: GramOperator, w: torch.Tensor, tol: float = 0.0):
    """Drop zero-weight training rows from the serving representation.

    Host-side (the kept set has a data-dependent size): call once when
    the model is built.  ``w`` may be stacked models (m, F): a row
    survives when any member uses it.  With no support vector at all one
    row is kept with its weight forced to exact zero.  Returns
    ``(compacted_op, compacted_w)``."""
    mags = w.abs() if w.ndim == 1 else w.abs().amax(
        dim=tuple(range(1, w.ndim)))
    keep = torch.nonzero(mags > tol).flatten()       # host sync
    if keep.numel() == 0:                # degenerate all-zero model
        keep = torch.zeros(1, dtype=torch.long, device=w.device)
        return op.take(keep), torch.zeros_like(w[keep])
    if keep.numel() == w.shape[0]:
        return op, w
    return op.take(keep), w[keep]


class BatchedPredictor:
    """``f(Xq) = scale * K(Xq, train) @ w`` served in power-of-two blocks.

    Built once per fitted model: the representation-side precompute
    (``op.serve_weights``) and the optional support-vector compaction
    happen here; every call pays only the per-block reductions."""

    def __init__(self, op: GramOperator, w: torch.Tensor, *,
                 batch: int = 1024, scale: float = 1.0,
                 compact: bool = False, compact_tol: float = 0.0):
        if not isinstance(batch, int) or batch < 1:
            raise ValueError(f"batch must be a positive int, got {batch!r}")
        if compact:
            op, w = compact_support(op, w, tol=compact_tol)
        self.op = op
        self.batch = batch
        self.scale = scale
        self.sw = op.serve_weights(w)

    def block_shape(self, q: int) -> int:
        """The power-of-two bucket a q-query request pads to (at least 8,
        capped at ``batch``)."""
        if q >= self.batch:
            return self.batch
        return min(self.batch, max(8, 1 << (q - 1).bit_length()))

    def __call__(self, A_test: torch.Tensor) -> torch.Tensor:
        q = A_test.shape[0]
        if q == 0:
            return torch.zeros((0,) + tuple(self.sw.shape[1:]),
                               dtype=self.sw.dtype, device=self.sw.device)
        out, lo = [], 0
        while lo < q:
            qb = self.block_shape(q - lo)
            Xq = A_test[lo:lo + qb]
            if Xq.shape[0] != qb:        # pad to the bucket, slice below
                Xq = torch.cat([Xq, Xq.new_zeros((qb - Xq.shape[0],
                                                  Xq.shape[1]))])
            out.append(self.op.serve_block(Xq.contiguous(), self.sw))
            lo += qb
        f = (torch.cat(out) if len(out) > 1 else out[0])[:q]
        return f * self.scale if self.scale != 1.0 else f


def batched_predict(op: GramOperator, w: torch.Tensor, A_test, *,
                    batch: int = 1024, scale: float = 1.0) -> torch.Tensor:
    """One-shot convenience wrapper over ``BatchedPredictor``."""
    return BatchedPredictor(op, w, batch=batch, scale=scale)(A_test)
