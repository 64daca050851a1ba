"""The port's Nystrom representation against the JAX package's, on the
same numpy inputs: the map, the inverse square root, kmeans landmarks,
the low-rank operator, the low-rank duality gap, and the facade's
``approx="nystrom"`` fits and predictions.

The JAX PRNG's streams cannot be replayed in torch, so every parity
test injects the JAX draw: the landmark rows (``fit_nystrom(landmarks=)``,
``fit(..., landmarks=)``), or for kmeans the JAX first centre's index.

Tolerances, and why:
  * The map Phi = K(A, L) K_LL^{-1/2} and products built on it: 1e-4,
    absolute tolerance times max(1, max |output|) (polynomial outputs
    reach 1e2, ROADMAP C2).  Both packages take the eigendecomposition
    of an f32 K_LL in their own library; at the test shapes K_LL is full
    rank with condition number below 1e3, so the f32 rounding (~1e-7)
    grows to at most ~1e-4.  A rank-deficient K_LL (linear kernel,
    l > n) is floored at jitter = 1e-6 and amplifies it by up to
    1/sqrt(jitter) = 1e3: those cases are not compared entrywise.
  * Low-rank operator methods on one given Phi: 1e-5 (the same f32
    products in another order); rows and re-chunked factors exact.
  * Facade fits through independently built maps: iterates and
    predictions 1e-4 (the map's bound carried through the solve);
    through ``convert`` (the JAX map itself carried across): 1e-5, the
    f32 bound of tests/test_slabfree_parity.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import KernelRidge as JKernelRidge
from repro.api import KernelSVM as JKernelSVM
from repro.api import SolverOptions as JSolverOptions
from repro.core import nystrom as jn
from repro.core.dcd import SVMConfig as JSVMConfig
from repro.core.kernels import KernelConfig as JKernelConfig
from repro.core.kernels import LowRankGramOperator as JLowRank
from repro.core.objectives import ksvm_duality_gap as j_ksvm_duality_gap
from repro.core.objectives import \
    ksvm_duality_gap_lowrank as j_ksvm_duality_gap_lowrank
from repro_torch import convert
from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
from repro_torch.core import (KernelConfig, LowRankGramOperator, SVMConfig,
                              ksvm_duality_gap_lowrank, validate_queries)
from repro_torch.core import nystrom as tn

KERNELS = [dict(name="rbf", sigma=1.0), dict(name="rbf", sigma=0.3),
           dict(name="polynomial", degree=3, coef0=1.0)]
IDS = ["rbf-1", "rbf-0.3", "polynomial"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(
        1.0, float(np.abs(want).max())))


def _data(m, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)


@pytest.mark.parametrize("m,n,l", [(48, 5, 12), (96, 6, 24)])
@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_nystrom_map_and_inv_sqrt_match_jax(kernel, m, n, l):
    A = _data(m, n, seed=l)
    L = A[np.random.default_rng(m).choice(m, l, replace=False)]
    jk, tk = JKernelConfig(**kernel), KernelConfig(**kernel)
    T = tn._inv_sqrt_gram(torch.from_numpy(L), tk, 1e-6)
    jT = jn._inv_sqrt_gram(jnp.asarray(L), jk, 1e-6)
    _close(T, jT, 1e-4)
    Phi = tn.nystrom_map(torch.from_numpy(A), torch.from_numpy(L), tk)
    jPhi = np.asarray(jn.nystrom_map(jnp.asarray(A), jnp.asarray(L), jk))
    _close(Phi, jPhi, 1e-4)
    _close(Phi @ Phi.T, jPhi @ jPhi.T, 1e-4)
    fmap = tn.fit_nystrom(None, torch.from_numpy(A), tk, l,
                          landmarks=torch.from_numpy(L))
    np.testing.assert_array_equal(fmap.landmarks.numpy(), L)
    _close(fmap(torch.from_numpy(A)), jPhi, 1e-4)
    assert fmap.rank == l


def test_full_rank_nystrom_is_exact():
    """With every row a landmark the approximation is exact (as
    tests/test_nystrom.py holds for the JAX map)."""
    A = _data(48, 5, seed=2)
    cfg = KernelConfig("rbf", sigma=0.7)
    Phi = tn.nystrom_map(torch.from_numpy(A), torch.from_numpy(A), cfg)
    K = tn._gram(torch.from_numpy(A), torch.from_numpy(A), cfg)
    np.testing.assert_allclose((Phi @ Phi.T).numpy(), K.numpy(), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("l", [4, 10, 17])
def test_kmeans_landmarks_match_jax_from_the_jax_first_centre(l):
    A = _data(96, 6, seed=l)
    key = jax.random.key(l)
    first = int(jax.random.randint(key, (), 0, A.shape[0]))
    want = np.asarray(jn.kmeans_landmarks(key, jnp.asarray(A), l))
    got = tn.kmeans_landmarks(None, torch.from_numpy(A), l, first=first)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_choose_landmarks_uniform_and_kmeans_draws():
    A = torch.from_numpy(_data(80, 5, seed=1))
    L1 = tn.choose_landmarks(torch.Generator().manual_seed(3), A, 16)
    L2 = tn.choose_landmarks(torch.Generator().manual_seed(3), A, 16)
    assert torch.equal(L1, L2)
    rows = {tuple(r) for r in A.numpy().tolist()}
    assert len({tuple(r) for r in L1.numpy().tolist()} & rows) == 16
    K = tn.choose_landmarks(torch.Generator().manual_seed(3), A, 6,
                            method="kmeans")
    assert K.shape == (6, 5) and bool(torch.isfinite(K).all())
    with pytest.raises(ValueError, match="landmark method"):
        tn.choose_landmarks(None, A, 4, method="leverage")


def test_nystrom_kernel_error_matches_jax_and_falls_with_l():
    A = _data(128, 6, seed=0)
    cfg = dict(name="rbf", sigma=1.0)
    errs = []
    for l in (8, 32, 96):
        L = A[np.random.default_rng(l).choice(128, l, replace=False)]
        e = tn.nystrom_kernel_error(torch.from_numpy(A), torch.from_numpy(L),
                                    KernelConfig(**cfg))
        je = jn.nystrom_kernel_error(jnp.asarray(A), jnp.asarray(L),
                                     JKernelConfig(**cfg))
        assert abs(e - je) <= 1e-4 * max(1.0, je)
        errs.append(e)
    assert errs[0] > errs[1] > errs[2]


def _lowrank_pair(seed=4, m=40, l=7, n=5):
    rng = np.random.default_rng(seed)
    Phi = rng.standard_normal((m, l)).astype(np.float32)
    A = _data(m, n, seed)
    L = A[:l]
    jfmap = jn.NystromMap(
        landmarks=jnp.asarray(L),
        transform=jn._inv_sqrt_gram(jnp.asarray(L), JKernelConfig("rbf"),
                                    1e-6),
        kernel=JKernelConfig("rbf"))
    tfmap = convert.nystrom_map(np.asarray(jfmap.landmarks),
                                np.asarray(jfmap.transform),
                                dataclasses.asdict(jfmap.kernel),
                                device="cpu")
    return (JLowRank(jnp.asarray(Phi), fmap=jfmap),
            LowRankGramOperator(torch.from_numpy(Phi), fmap=tfmap), A)


def test_lowrank_operator_methods_match_jax():
    jop, op, A = _lowrank_pair()
    rng = np.random.default_rng(5)
    idx = np.array([0, 9, 9, 39, 21], np.int64)
    X = rng.standard_normal((40, 3)).astype(np.float32)
    w = rng.standard_normal(40).astype(np.float32)
    y = np.where(rng.random(40) < 0.5, 1.0, -1.0).astype(np.float32)
    jidx, tidx, t = jnp.asarray(idx, jnp.int32), torch.from_numpy(idx), \
        torch.from_numpy
    np.testing.assert_array_equal(op.rows(tidx).numpy(),
                                  np.asarray(jop.rows(jidx)))
    for got, want in [
            (op.matvec(tidx, t(X)), jop.matvec(jidx, jnp.asarray(X))),
            (op.matvec(tidx, t(w)), jop.matvec(jidx, jnp.asarray(w))),
            (op.cross_block(tidx), jop.cross_block(jidx)),
            (op.diag(tidx), jop.diag(jidx)),
            (op.round_data(tidx, t(w))[1],
             jop.round_data(jidx, jnp.asarray(w))[1]),
            (op.full_matvec(t(w)), jop.full_matvec(jnp.asarray(w))),
            (op.serve_weights(t(w)), jop.serve_weights(jnp.asarray(w))),
            (op.serve_block(t(A[:6]), op.serve_weights(t(w))),
             jop.serve_block(jnp.asarray(A[:6]),
                             jop.serve_weights(jnp.asarray(w))))]:
        _close(got, want, 1e-5)
    assert (op.n_samples, op.rank, op.feature_dim) == (
        jop.n_samples, jop.rank, jop.feature_dim)
    sc, jsc = op.scale_rows(t(y)), jop.scale_rows(jnp.asarray(y))
    np.testing.assert_array_equal(sc.Phi.numpy(), np.asarray(jsc.Phi))
    keep = np.array([1, 4, 30], np.int64)
    np.testing.assert_array_equal(op.take(t(keep)).Phi.numpy(),
                                  np.asarray(jop.take(jnp.asarray(keep)).Phi))


def test_lowrank_operator_without_a_map_cannot_serve():
    op = LowRankGramOperator(torch.zeros((5, 2)))
    assert op.feature_dim is None
    with pytest.raises(ValueError, match="cannot serve"):
        validate_queries(op, np.zeros((3, 4), np.float32))
    with pytest.raises(ValueError, match="feature map"):
        op.serve_block(torch.zeros((3, 4)), torch.zeros(2))


@pytest.mark.parametrize("loss", ["l1", "l2"])
def test_lowrank_gap_matches_jax_and_the_linear_gap(loss):
    rng = np.random.default_rng(7)
    m, l = 50, 9
    Phi = rng.standard_normal((m, l)).astype(np.float32) / 3
    y = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
    alpha = rng.random(m).astype(np.float32)
    got = ksvm_duality_gap_lowrank(torch.from_numpy(Phi),
                                   torch.from_numpy(y),
                                   torch.from_numpy(alpha),
                                   SVMConfig(C=0.7, loss=loss))
    jcfg = JSVMConfig(C=0.7, loss=loss, kernel=JKernelConfig("linear"))
    want = j_ksvm_duality_gap_lowrank(jnp.asarray(Phi), jnp.asarray(y),
                                      jnp.asarray(alpha), jcfg)
    _close(got, want, 1e-5)
    # the m x m linear-kernel gap over Phi is the same value
    _close(got, j_ksvm_duality_gap(jnp.asarray(Phi), jnp.asarray(y),
                                   jnp.asarray(alpha), jcfg), 1e-5)


def _svm_data(m=72, n=6, q=15, seed=0):
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(m + q) < 0.5, 1.0, -1.0).astype(np.float32)
    A = ((rng.standard_normal((m + q, n)) + 0.8 * y[:, None])
         / np.sqrt(n)).astype(np.float32)
    return A[:m], y[:m], A[m:]


def _krr_data(m=64, n=6, q=15, seed=1):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m + q, n)) / np.sqrt(n)).astype(np.float32)
    y = np.sin(A @ rng.standard_normal(n)).astype(np.float32)
    return A[:m], y[:m], A[m:]


@pytest.mark.parametrize("landmark_method", ["uniform", "kmeans"])
@pytest.mark.parametrize("problem", ["ksvm", "krr"])
@pytest.mark.parametrize("method", ["classical", "sstep"])
def test_facade_nystrom_fit_and_predict_match_jax(problem, method,
                                                  landmark_method):
    """A JAX ``approx="nystrom"`` fit, then the port's fit replaying its
    landmarks and schedule (the map rebuilt by the port: 1e-4), and the
    JAX estimator carried across through ``convert`` with its own map
    (1e-5)."""
    kw = dict(method=method, s=4, max_iters=32, approx="nystrom",
              landmarks=10, landmark_method=landmark_method, record=True,
              check_every=2, seed=3)
    if problem == "ksvm":
        A, y, Q = _svm_data()
        jest = JKernelSVM(C=1.0, kernel="rbf", options=JSolverOptions(**kw))
        est = KernelSVM(C=1.0, kernel="rbf", options=SolverOptions(**kw),
                        device="cpu")
    else:
        A, y, Q = _krr_data()
        jest = JKernelRidge(lam=0.5, kernel="rbf",
                            options=JSolverOptions(b=3, **kw))
        est = KernelRidge(lam=0.5, kernel="rbf",
                          options=SolverOptions(b=3, **kw), device="cpu")
    # jnp data: the JAX kmeans seeding indexes A with a traced argmax
    jres = jest.fit(jnp.asarray(A), jnp.asarray(y))
    jfmap = jest.op_.fmap
    res = est.fit(A, y, schedule=np.asarray(jres.schedule),
                  landmarks=np.asarray(jfmap.landmarks))
    assert isinstance(est.op_, LowRankGramOperator)
    assert res.representation == jres.representation == "nystrom(l=10)"
    _close(res.alpha, jres.alpha, 1e-4)
    _close(res.history, jres.history, 1e-4)
    predict = "decision_function" if problem == "ksvm" else "predict"
    want = np.asarray(getattr(jest, predict)(Q))
    _close(getattr(est, predict)(Q), want, 1e-4)

    fmap = convert.nystrom_map(np.asarray(jfmap.landmarks),
                               np.asarray(jfmap.transform),
                               dataclasses.asdict(jfmap.kernel),
                               device="cpu")
    conv = convert.fitted_estimator(
        problem, dataclasses.asdict(jest.cfg), np.asarray(jest.A_),
        np.asarray(jest.y_), np.asarray(jest.alpha_),
        options={k: v for k, v in kw.items()}
        | ({"b": 3} if problem == "krr" else {}),
        fmap=fmap, device="cpu")
    np.testing.assert_allclose(getattr(conv, predict)(Q).numpy(), want,
                               **TOL)


def test_facade_nystrom_seed_reproducible_and_validated():
    A, y, Q = _krr_data()
    kw = dict(s=4, b=3, max_iters=16, approx="nystrom", landmarks=8)
    r1 = KernelRidge(options=SolverOptions(seed=5, **kw),
                     device="cpu").fit(A, y)
    e2 = KernelRidge(options=SolverOptions(seed=5, **kw), device="cpu")
    r2 = e2.fit(A, y)
    np.testing.assert_array_equal(r1.alpha.numpy(), r2.alpha.numpy())
    e3 = KernelRidge(options=SolverOptions(seed=6, **kw), device="cpu")
    e3.fit(A, y)
    assert not torch.equal(e2.op_.fmap.landmarks, e3.op_.fmap.landmarks)
    # landmarks capped at m, as in the JAX facade
    big = KernelRidge(options=SolverOptions(**(kw | {"landmarks": 500})),
                      device="cpu")
    assert big.fit(A, y).representation == f"nystrom(l={A.shape[0]})"
    with pytest.raises(ValueError, match="approx"):
        KernelRidge(device="cpu").fit(A, y, landmarks=A[:4])
    with pytest.raises(ValueError, match="landmarks must have shape"):
        KernelRidge(options=SolverOptions(**kw), device="cpu").fit(
            A, y, landmarks=A[:4, :3])
    for bad in (dict(approx="svd"), dict(landmarks=0),
                dict(landmark_method="leverage")):
        with pytest.raises(ValueError):
            SolverOptions(**bad)
    with pytest.raises(ValueError, match="fmap"):
        convert.fitted_estimator(
            "krr", dict(lam=1.0, kernel=dict(name="rbf", degree=3,
                                             coef0=0.0, sigma=1.0)),
            A, y, np.zeros(A.shape[0], np.float32),
            options=dict(approx="nystrom"), device="cpu")


@pytest.mark.parametrize("kernel", [dict(name="rbf", sigma=0.8),
                                    dict(name="polynomial", degree=2,
                                         coef0=1.0)],
                         ids=["rbf", "polynomial"])
def test_nystrom_krr_setup_matches_jax(kernel):
    """``nystrom_krr_setup`` against JAX's on the JAX setup's landmarks:
    the linear-kernel config, the landmarks, and Phi, the map of new
    queries and a BDCD solve on (Phi, y) at this module's Nystrom bound
    (1e-4 of the largest value: ``K_LL^{-1/2}`` amplifies f32 rounding,
    test_nystrom_map_and_inv_sqrt_match_jax)."""
    from repro.core.bdcd import KRRConfig as JKRRConfig
    from repro.core.bdcd import bdcd_krr as j_bdcd_krr
    from repro.core.bdcd import block_schedule as j_block_schedule
    from repro_torch.core import KRRConfig, bdcd_krr

    A = _data(96, 6, seed=4)
    y = np.random.default_rng(4).standard_normal(96).astype(np.float32)
    jsetup = jn.nystrom_krr_setup(
        jax.random.key(5), jnp.asarray(A),
        JKRRConfig(lam=0.7, kernel=JKernelConfig(**kernel)), 24)
    setup = tn.nystrom_krr_setup(
        None, torch.from_numpy(A),
        KRRConfig(lam=0.7, kernel=KernelConfig(**kernel)), 24,
        landmarks=torch.from_numpy(np.asarray(jsetup.landmarks)))
    assert setup.cfg == KRRConfig(lam=0.7, kernel=KernelConfig("linear"))
    assert isinstance(setup.feature_map, tn.NystromMap)
    np.testing.assert_array_equal(setup.landmarks.numpy(),
                                  np.asarray(jsetup.landmarks))
    _close(setup.Phi, jsetup.Phi, 1e-4)
    Q = A[:7] + 0.1
    _close(setup.feature_map(torch.from_numpy(Q)),
           jsetup.feature_map(jnp.asarray(Q)), 1e-4)
    sched = j_block_schedule(jax.random.key(6), 64, 96, 4)
    ja, _ = j_bdcd_krr(jsetup.Phi, jnp.asarray(y), jnp.zeros(96), sched,
                       jsetup.cfg)
    a, _ = bdcd_krr(setup.Phi, torch.from_numpy(y), torch.zeros(96),
                    np.asarray(sched), setup.cfg)
    _close(a, ja, 1e-4)
