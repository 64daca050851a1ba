"""The port's objectives and predict oracles against the JAX package's,
on the same numpy inputs.  The port computes every K-SVM quantity from
one full KMV (``Qa = y * K(A, A)(y * alpha)``) where the JAX package
forms the m x m gram; the values agree to f32 summation order (2e-4,
the KMV bound of tests/test_kmv.py, relative to the objective's scale).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KernelConfig as JKernelConfig
from repro.core import KRRConfig as JKRRConfig
from repro.core import SVMConfig as JSVMConfig
from repro.core import objectives as jobj
from repro_torch.core import KernelConfig, KRRConfig, SVMConfig
from repro_torch.core import objectives as obj

KERNELS = [dict(name="linear"),
           dict(name="polynomial", degree=3, coef0=1.0),
           dict(name="rbf", sigma=1.0)]
IDS = [k["name"] for k in KERNELS]


def _data(m=48, n=12, seed=0):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    y = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
    alpha = (rng.random(m) * (rng.random(m) < 0.6)).astype(np.float32)
    Q = (rng.standard_normal((9, n)) / np.sqrt(n)).astype(np.float32)
    return A, y, alpha, Q


def _scalar_close(got, want, scale, tol=2e-4):
    assert abs(float(got) - float(want)) <= tol * max(1.0, scale), (
        float(got), float(want))


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
@pytest.mark.parametrize("loss", ["l1", "l2"])
def test_ksvm_objectives_and_slab_free_gap_match_jax(kernel, loss):
    A, y, alpha, _ = _data()
    jcfg = JSVMConfig(C=1.0, loss=loss, kernel=JKernelConfig(**kernel))
    cfg = SVMConfig(C=1.0, loss=loss, kernel=KernelConfig(**kernel))
    jargs = (jnp.asarray(A), jnp.asarray(y), jnp.asarray(alpha))
    targs = (torch.from_numpy(A), torch.from_numpy(y),
             torch.from_numpy(alpha))
    primal = jobj.ksvm_primal_objective(*jargs, jcfg)
    dual = jobj.ksvm_dual_objective(*jargs, jcfg)
    scale = abs(float(primal)) + abs(float(dual))
    _scalar_close(obj.ksvm_primal_objective(*targs, cfg), primal, scale)
    _scalar_close(obj.ksvm_dual_objective(*targs, cfg), dual, scale)
    _scalar_close(obj.ksvm_duality_gap(*targs, cfg),
                  jobj.ksvm_duality_gap(*jargs, jcfg), scale)


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_krr_objectives_match_jax(kernel):
    A, _, _, _ = _data(seed=1)
    rng = np.random.default_rng(2)
    y = rng.standard_normal(A.shape[0]).astype(np.float32)
    jcfg = JKRRConfig(lam=0.5, kernel=JKernelConfig(**kernel))
    cfg = KRRConfig(lam=0.5, kernel=KernelConfig(**kernel))
    jA, jy = jnp.asarray(A), jnp.asarray(y)
    tA, ty = torch.from_numpy(A), torch.from_numpy(y)
    astar_j = jobj.krr_closed_form(jA, jy, jcfg)
    astar = obj.krr_closed_form(tA, ty, cfg)
    np.testing.assert_allclose(astar.numpy(), np.asarray(astar_j),
                               rtol=1e-4, atol=1e-6)
    alpha = np.asarray(astar_j) * 0.7
    ja, ta = jnp.asarray(alpha), torch.from_numpy(alpha)
    np.testing.assert_allclose(
        float(obj.krr_rel_residual(tA, ty, ta, cfg)),
        float(jobj.krr_rel_residual(jA, jy, ja, jcfg)), rtol=1e-5)
    d_j = jobj.krr_dual_objective(jA, jy, ja, jcfg)
    _scalar_close(obj.krr_dual_objective(tA, ty, ta, cfg), d_j,
                  abs(float(d_j)), tol=1e-5)
    np.testing.assert_allclose(
        float(obj.relative_solution_error(ta, astar)),
        float(jobj.relative_solution_error(ja, astar_j)), rtol=1e-3)


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_dense_predict_oracles_match_jax(kernel):
    A, y, alpha, Q = _data(seed=3)
    jk, k = JKernelConfig(**kernel), KernelConfig(**kernel)
    want = jobj.ksvm_predict(jnp.asarray(A), jnp.asarray(y),
                             jnp.asarray(alpha), jnp.asarray(Q),
                             JSVMConfig(kernel=jk))
    got = obj.ksvm_predict(torch.from_numpy(A), torch.from_numpy(y),
                           torch.from_numpy(alpha), torch.from_numpy(Q),
                           SVMConfig(kernel=k))
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=tol)
    want = jobj.krr_predict(jnp.asarray(A), jnp.asarray(alpha),
                            jnp.asarray(Q), JKRRConfig(lam=0.3, kernel=jk))
    got = obj.krr_predict(torch.from_numpy(A), torch.from_numpy(alpha),
                          torch.from_numpy(Q), KRRConfig(lam=0.3, kernel=k))
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=tol)
