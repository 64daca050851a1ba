"""The port's ExactGramOperator against the JAX package's, method by
method, on the same numpy inputs (the JAX operator's jnp KMV path; the
port's plain versions on the CPU).  KMV-based reductions are held to the
KMV bound 2e-4 (tests/test_kmv.py), the cross block to the gram bound
1e-4; polynomial absolute tolerances scale with the output (ROADMAP C2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernels import ExactGramOperator as JOp
from repro.core.kernels import KernelConfig as JKernelConfig
from repro.core.kernels import kernel_diag as j_kernel_diag
from repro_torch.core.kernels import (ExactGramOperator, KernelConfig,
                                      kernel_diag)

KERNELS = [dict(name="linear"),
           dict(name="polynomial", degree=3, coef0=1.0),
           dict(name="rbf", sigma=0.8)]
IDS = [k["name"] for k in KERNELS]


def _close(got, want, kernel, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = tol * max(1.0, float(np.abs(want).max())) \
        if kernel["name"] == "polynomial" else tol
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


@pytest.fixture
def problem():
    rng = np.random.default_rng(11)
    m, n = 70, 20
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    y = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
    idx = np.array([3, 17, 3, 64, 0, 41], np.int64)   # with a repeat
    X = rng.standard_normal(m).astype(np.float32)
    Xm = rng.standard_normal((m, 3)).astype(np.float32)
    Q = (rng.standard_normal((13, n)) / np.sqrt(n)).astype(np.float32)
    return A, y, idx, X, Xm, Q


def _pair(A, kernel):
    return (JOp(jnp.asarray(A), JKernelConfig(**kernel)),
            ExactGramOperator(torch.from_numpy(A), KernelConfig(**kernel)))


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_operator_methods_match_jax(kernel, problem):
    A, y, idx, X, Xm, Q = problem
    jop, op = _pair(A, kernel)
    jidx, tidx = jnp.asarray(idx, jnp.int32), torch.from_numpy(idx)
    t = torch.from_numpy
    np.testing.assert_array_equal(op.rows(tidx), jop.rows(jidx))
    _close(op.matvec(tidx, t(X)), jop.matvec(jidx, jnp.asarray(X)), kernel,
           2e-4)
    _close(op.matvec(tidx, t(Xm)), jop.matvec(jidx, jnp.asarray(Xm)),
           kernel, 2e-4)
    _close(op.cross_block(tidx), jop.cross_block(jidx), kernel, 1e-4)
    _close(op.diag(tidx), jop.diag(jidx), kernel, 1e-5)
    G, u = op.round_data(tidx, t(X))
    jG, ju = jop.round_data(jidx, jnp.asarray(X))
    _close(G, jG, kernel, 1e-4)
    _close(u, ju, kernel, 2e-4)
    _close(op.full_matvec(t(X)), jop.full_matvec(jnp.asarray(X)), kernel,
           2e-4)
    # serving: one model and F = 3 stacked models
    _close(op.serve_block(t(Q), op.serve_weights(t(X))),
           jop.serve_block(jnp.asarray(Q), jop.serve_weights(jnp.asarray(X))),
           kernel, 2e-4)
    _close(op.serve_block(t(Q), t(Xm)),
           jop.serve_block(jnp.asarray(Q), jnp.asarray(Xm)), kernel, 2e-4)
    assert (op.n_samples, op.feature_dim) == (jop.n_samples,
                                              jop.feature_dim)
    assert op.dtype == torch.float32 and jop.dtype == jnp.float32


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_scale_rows_keeps_the_ksvm_convention(kernel, problem):
    """scale_rows(y) is the operator over diag(y) A — for nonlinear
    kernels K(yA) is not yy^T o K(A), in both packages."""
    A, y, idx, X, _, _ = problem
    jop, op = _pair(A, kernel)
    jsc, sc = jop.scale_rows(jnp.asarray(y)), op.scale_rows(
        torch.from_numpy(y))
    np.testing.assert_allclose(sc.A, jsc.A, rtol=0, atol=0)
    jidx, tidx = jnp.asarray(idx, jnp.int32), torch.from_numpy(idx)
    _close(sc.matvec(tidx, torch.from_numpy(X)),
           jsc.matvec(jidx, jnp.asarray(X)), kernel, 2e-4)
    _close(sc.cross_block(tidx), jsc.cross_block(jidx), kernel, 1e-4)
    if kernel["name"] == "rbf":
        yy = np.outer(y, y)[np.ix_(idx, idx)]
        assert not np.allclose(sc.cross_block(tidx).numpy(),
                               yy * op.cross_block(tidx).numpy())


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_take_compacts_rows(kernel, problem):
    A, _, _, X, _, Q = problem
    jop, op = _pair(A, kernel)
    keep = np.array([0, 5, 9, 33, 69], np.int64)
    jt, tt = jop.take(jnp.asarray(keep)), op.take(torch.from_numpy(keep))
    assert tt.n_samples == 5
    w = X[keep]
    _close(tt.serve_block(torch.from_numpy(Q), torch.from_numpy(w)),
           jt.serve_block(jnp.asarray(Q), jnp.asarray(w)), kernel, 2e-4)


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_kernel_diag_matches_jax(kernel, problem):
    A = problem[0]
    _close(kernel_diag(torch.from_numpy(A), KernelConfig(**kernel)),
           j_kernel_diag(jnp.asarray(A), JKernelConfig(**kernel)), kernel,
           1e-5)
