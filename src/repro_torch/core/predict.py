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
stacked models (m, F), served by one block call per bucket.  With
``stream=k`` the queries may be a host tensor larger than device memory:
k rows move to the device at a time, and each chunk's scores return to
the host before the next chunk starts.

``serve_cache_size`` stands for the reference's count of compiled
``_serve_block`` entries, which the serving engine's tests hold flat
after ``warmup``.  There is no jit cache here; what would grow in its
place is the set of distinct block calls serving has reached (a distinct
signature is a distinct KMV plan on the card) and the kernel entry
points bound (``kernels/build.py``: a bind builds its library when it is
missing).  ``warmup`` touches every bucket, so growth after it means a
block shape outside the buckets or a kernel built on the serving path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import as_tensor
from .kernels import GramOperator

# the signatures of every serve block issued (``serve_cache_size``)
_SERVE_BLOCKS = set()


def _signature(x):
    """What a block call's compiled form would depend on: tensor shapes,
    dtypes and devices, and the operator's static fields."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype), str(x.device))
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            _signature(getattr(x, f.name)) for f in dataclasses.fields(x))
    return x


def _serve_block(op: GramOperator, sw: torch.Tensor,
                 Xq: torch.Tensor) -> torch.Tensor:
    """One query block through the operator's serving reduction (one KMV
    for an exact operator, whatever the number of stacked models),
    recording the block's signature."""
    _SERVE_BLOCKS.add((_signature(op), _signature(sw), _signature(Xq)))
    return op.serve_block(Xq, sw)


def serve_cache_size() -> int:
    """The serving path's stand-in for the reference's jit-cache size
    (module docstring): distinct serve-block signatures reached plus
    kernel entry points bound.  Zero growth after ``warmup`` means
    admission reached no new block shape and built no kernel."""
    from repro_torch.kernels import build
    return len(_SERVE_BLOCKS) + len(build._LAUNCHERS)


def check_queries(op: GramOperator, X, name: str = "A_test"
                  ) -> torch.Tensor:
    """Serve-side input validation where the block lies: a 2-D block of
    the operator's feature width and dtype (serving never casts), as a
    tensor on the device it came on — a host block stays on the host, so
    the serving engine validates each request without a device copy.
    The offending argument is named."""
    X = as_tensor(X)
    if X.ndim != 2:
        raise ValueError(f"{name} must be 2-D (queries x features), got "
                         f"shape {tuple(X.shape)}")
    if op.feature_dim is None:
        raise ValueError(
            f"{name}: this operator cannot serve new points (a low-rank "
            f"factor without a feature map — build it with "
            f"repro_torch.core.nystrom.fit_nystrom or the facade)")
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
    return X


def validate_queries(op: GramOperator, X, name: str = "A_test"
                     ) -> torch.Tensor:
    """Eager serve-side input validation (``check_queries``), the block
    returned on the operator's device."""
    return check_queries(op, X, name).to(op.device)


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
                 compact: bool = False, compact_tol: float = 0.0,
                 stream: Optional[int] = None):
        if not isinstance(batch, int) or batch < 1:
            raise ValueError(f"batch must be a positive int, got {batch!r}")
        if stream is not None and (not isinstance(stream, int)
                                   or isinstance(stream, bool)
                                   or stream < 1):
            raise ValueError(f"stream must be None or a positive int "
                             f"(query rows per host chunk), got "
                             f"{stream!r}")
        if compact:
            op, w = compact_support(op, w, tol=compact_tol)
        self.op = op
        self.batch = batch
        self.scale = scale
        self.stream = stream
        self.sw = op.serve_weights(w)

    def block_shape(self, q: int) -> int:
        """The power-of-two bucket a q-query request pads to (at least 8,
        capped at ``batch``)."""
        if q >= self.batch:
            return self.batch
        return min(self.batch, max(8, 1 << (q - 1).bit_length()))

    def bucket_sizes(self):
        """Every block shape this predictor can issue: 8, 16, ...,
        ``batch``.  ``warmup`` issues each once, so steady traffic
        reaches no new one (``serve_cache_size``)."""
        sizes, b = [], 8
        while b < self.batch:
            sizes.append(b)
            b <<= 1
        sizes.append(self.batch)
        return sizes

    def warmup(self) -> int:
        """Serve one zero block of every bucket (building every kernel the
        blocks launch); returns the bucket count.  Synchronises."""
        fd = self.op.feature_dim
        for qb in self.bucket_sizes():
            _serve_block(self.op, self.sw,
                         torch.zeros((qb, fd), dtype=self.op.dtype,
                                     device=self.sw.device))
        if self.sw.device.type == "cuda":
            torch.cuda.synchronize(self.sw.device)
        return len(self.bucket_sizes())

    def __call__(self, A_test) -> torch.Tensor:
        A_test = as_tensor(A_test)
        q = A_test.shape[0]
        if q == 0:
            return torch.zeros((0,) + tuple(self.sw.shape[1:]),
                               dtype=self.sw.dtype, device=self.sw.device)
        if self.stream is not None and q > self.stream:
            # out-of-core queries: only ``stream`` rows are on the device
            # at a time, and their scores are back on the host before
            # the next chunk is touched
            dev = self.sw.device
            parts = [self._serve_chunk(
                A_test[lo:lo + self.stream].to(dev)).cpu()
                for lo in range(0, q, self.stream)]
            f = torch.cat(parts).to(dev)
        else:
            f = self._serve_chunk(A_test.to(self.sw.device))
        return f * self.scale if self.scale != 1.0 else f

    def _serve_chunk(self, A_test: torch.Tensor) -> torch.Tensor:
        """The bucketed block loop over one device-resident query chunk,
        unscaled."""
        q = A_test.shape[0]
        out, lo = [], 0
        while lo < q:
            qb = self.block_shape(q - lo)
            Xq = A_test[lo:lo + qb]
            if Xq.shape[0] != qb:        # pad to the bucket, slice below
                Xq = torch.cat([Xq, Xq.new_zeros((qb - Xq.shape[0],
                                                  Xq.shape[1]))])
            out.append(_serve_block(self.op, self.sw, Xq.contiguous()))
            lo += qb
        return (torch.cat(out) if len(out) > 1 else out[0])[:q]


def batched_predict(op: GramOperator, w: torch.Tensor, A_test, *,
                    batch: int = 1024, scale: float = 1.0) -> torch.Tensor:
    """One-shot convenience wrapper over ``BatchedPredictor``."""
    return BatchedPredictor(op, w, batch=batch, scale=scale)(A_test)
