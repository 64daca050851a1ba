"""The port's sweeps and autotuner (``repro_torch.tune``) against the JAX
package's (``repro.tune``), on the same numpy inputs:

  * fleets (K-RR and K-SVM, exact and Nystrom, s-step and classical)
    replaying the JAX fleet's schedule (and landmarks) to 1e-5 (the f32
    bound of tests/test_tune.py), per-member stopping and frozen members
    included; a one-member fleet equals the single fit bit for bit;
  * the fleet round factories (``C=``/``lam=`` tensors) against the JAX
    factories vmapped over the same values;
  * ``reg_path`` / ``fit_path`` and ``cross_validate`` (the same folds;
    the same best value where both converge);
  * ``resolve_options`` and the facade's ``FitResult.comm`` /
    ``FitResult.plan`` against the JAX package's for the same explicit
    budgets, the measured probe, the ``"auto"`` validation;
  * ``kernels.kmv.kmv_plan``: every plan of the main path pinned.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import regression_dataset
from repro.api import KernelRidge as JKernelRidge
from repro.api import KernelSVM as JKernelSVM
from repro.api import SolverOptions as JSolverOptions
from repro.core import (KernelConfig as JKernelConfig, KRRConfig as
                        JKRRConfig, SVMConfig as JSVMConfig, block_schedule,
                        coordinate_schedule, run_rounds_fleet as
                        j_run_rounds_fleet, make_sstep_bdcd_round_fn as
                        j_make_sstep_bdcd, make_sstep_dcd_round_fn as
                        j_make_sstep_dcd, pad_rounds as j_pad_rounds)
from repro.core.perf_model import choose_chunk_rows as j_choose_chunk_rows
from repro.tune import cross_validate as j_cross_validate
from repro.tune import reg_path as j_reg_path
from repro.tune import resolve_options as j_resolve_options
from repro.tune import solve_fleet as j_solve_fleet
from repro.tune.path import _fold_indices as j_fold_indices
from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
from repro_torch.core import (KernelConfig, KRRConfig, NO_TOL, SVMConfig,
                              make_bdcd_round_fn, make_dcd_round_fn,
                              make_sstep_bdcd_round_fn,
                              make_sstep_dcd_round_fn, pad_rounds,
                              run_rounds, run_rounds_fleet)
from repro_torch.core.perf_model import DeviceBudget
from repro_torch.kernels.kmv import kmv_plan
from repro_torch.launch import solve
from repro_torch.tune import (TunedPlan, cross_validate, reg_path,
                              resolve_options, solve_fleet)
from repro_torch.tune.path import _fold_indices

M, N, H, S, B = 96, 16, 64, 8, 4
LAMS = (0.25, 1.0, 4.0, 16.0)
CS = (0.25, 1.0, 4.0)
TOL = dict(rtol=1e-5, atol=1e-5)
HBM = 16 * 2 ** 30
# the JAX package's budget, passed to the port explicitly: 16 GiB, its
# 16 MiB VMEM for a streamed working set of two slots, 800 GB/s
JAX_BUDGET = DeviceBudget(HBM, 16 * 2 ** 20, 800e9, slots=2)


def _krr_data(m=M, n=N, seed=0):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    y = np.sin(A @ rng.standard_normal(n)).astype(np.float32)
    return A, y


def _svm_data(m=M, n=N, seed=1, margin=0.8):
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
    w = rng.standard_normal(n)
    A = ((rng.standard_normal((m, n)) + margin * y[:, None] * w
          / np.linalg.norm(w)) / np.sqrt(n)).astype(np.float32)
    return A, y


def _kw(**over):
    kw = dict(method="sstep", s=S, b=B, max_iters=H, seed=5)
    kw.update(over)
    return kw


def _sched(problem, kw, m):
    key = jax.random.key(kw["seed"])
    if problem == "ksvm":
        return np.array(coordinate_schedule(key, kw["max_iters"], m))
    return np.array(block_schedule(key, kw["max_iters"], m, kw["b"]))


# ---------------------------------------------------------------------------
# fleets against the JAX fleets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["rbf", "linear"])
@pytest.mark.parametrize("method,s", [("sstep", S), ("classical", 1)])
def test_krr_fleet_matches_jax(kernel, method, s):
    A, y = _krr_data()
    kw = _kw(method=method, s=s)
    jf = j_solve_fleet(A, y, lams=LAMS, kernel=kernel,
                       options=JSolverOptions(**kw))
    tf = solve_fleet(A, y, lams=LAMS, kernel=kernel,
                     options=SolverOptions(**kw),
                     schedule=_sched("krr", kw, M), device="cpu")
    assert tf.alpha.shape == (len(LAMS), M) and tf.param == "lam"
    assert (tf.rounds_run, tf.iters_run) == (jf.rounds_run, jf.iters_run)
    np.testing.assert_allclose(tf.alpha.numpy(), np.asarray(jf.alpha), **TOL)
    assert tf.comm == pytest.approx(jf.comm, rel=1e-12)
    assert tf.representation == jf.representation == "exact"


@pytest.mark.parametrize("loss", ["l1", "l2"])
@pytest.mark.parametrize("method,s", [("sstep", S), ("classical", 1)])
def test_ksvm_fleet_matches_jax(loss, method, s):
    A, y = _svm_data()
    kw = _kw(method=method, s=s, b=1)
    jf = j_solve_fleet(A, y, Cs=CS, kernel="rbf", loss=loss,
                       options=JSolverOptions(**kw))
    tf = solve_fleet(A, y, Cs=CS, kernel="rbf", loss=loss,
                     options=SolverOptions(**kw),
                     schedule=_sched("ksvm", kw, M), device="cpu")
    np.testing.assert_allclose(tf.alpha.numpy(), np.asarray(jf.alpha), **TOL)
    assert tf.comm == pytest.approx(jf.comm, rel=1e-12)


@pytest.mark.parametrize("problem", ["krr", "ksvm"])
def test_nystrom_fleet_matches_jax(problem):
    A, y = _krr_data() if problem == "krr" else _svm_data()
    kw = _kw(approx="nystrom", landmarks=24,
             b=B if problem == "krr" else 1)
    grid = {"lams": LAMS} if problem == "krr" else {"Cs": CS}
    jf = j_solve_fleet(A, y, kernel="rbf", options=JSolverOptions(**kw),
                       **grid)
    tf = solve_fleet(A, y, kernel="rbf", options=SolverOptions(**kw),
                     schedule=_sched(problem, kw, M),
                     landmarks=np.asarray(jf.op.fmap.landmarks),
                     device="cpu", **grid)
    assert tf.representation == jf.representation == "nystrom(l=24)"
    np.testing.assert_allclose(tf.alpha.numpy(), np.asarray(jf.alpha), **TOL)
    assert tf.comm == pytest.approx(jf.comm, rel=1e-12)


@pytest.mark.parametrize("problem", ["krr", "ksvm"])
def test_fleet_per_member_stopping_matches_jax(problem):
    """The tolerance path: the same checks, per-member histories and
    converged mask, and every converged member at or below tol."""
    A, y = _krr_data() if problem == "krr" else _svm_data()
    kw = _kw(max_iters=1024, tol=5e-2 if problem == "krr" else 0.5,
             check_every=2, b=B if problem == "krr" else 1)
    grid = {"lams": LAMS} if problem == "krr" else {"Cs": CS}
    jf = j_solve_fleet(A, y, kernel="rbf", options=JSolverOptions(**kw),
                       **grid)
    tf = solve_fleet(A, y, kernel="rbf", options=SolverOptions(**kw),
                     schedule=_sched(problem, kw, M), device="cpu", **grid)
    assert tf.rounds_run == jf.rounds_run
    np.testing.assert_array_equal(tf.converged, np.asarray(jf.converged))
    assert tf.history.shape == np.asarray(jf.history).shape
    np.testing.assert_allclose(tf.history, np.asarray(jf.history),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tf.alpha.numpy(), np.asarray(jf.alpha), **TOL)
    for j in np.flatnonzero(tf.converged):
        assert tf.metric_history(j).min() <= kw["tol"]


def test_fleet_frozen_members_match_jax_and_do_not_drift():
    """A member that converges early holds its state while the rest keep
    iterating: its recorded metric never changes again, and its alpha is
    the JAX fleet's (tests/test_tune.py's data and grid)."""
    A, y = (np.asarray(t) for t in regression_dataset(jax.random.key(0),
                                                       m=M, n=N))
    # lambda = 1000 converges at check 9, lambda = 0.01 at check 14
    lams = (1000.0, 0.01)
    kw = _kw(max_iters=4096, tol=2e-2, check_every=2)
    jf = j_solve_fleet(A, y, lams=lams, kernel="rbf",
                       options=JSolverOptions(**kw))
    tf = solve_fleet(A, y, lams=lams, kernel="rbf",
                     options=SolverOptions(**kw),
                     schedule=_sched("krr", kw, M), device="cpu")
    assert tf.converged.all() and tf.rounds_run == jf.rounds_run
    hist = tf.metric_history(0)
    k = int(np.argmax(hist <= 2e-2))
    assert k < len(hist) - 1
    np.testing.assert_array_equal(hist[k:], hist[k])
    np.testing.assert_allclose(tf.alpha.numpy(), np.asarray(jf.alpha), **TOL)
    # the fleet cut at member 0's check gives its final alpha bit for bit
    cut = (k + 1) * kw["check_every"] * S
    tc = solve_fleet(A, y, lams=lams, kernel="rbf",
                     options=SolverOptions(**dict(kw, max_iters=cut)),
                     schedule=_sched("krr", kw, M)[:cut], device="cpu")
    assert torch.equal(tc.alpha[0], tf.alpha[0])
    assert not torch.equal(tc.alpha[1], tf.alpha[1])


@pytest.mark.parametrize("problem", ["krr", "ksvm"])
def test_one_member_fleet_is_the_single_fit_bit_for_bit(problem):
    A, y = _krr_data() if problem == "krr" else _svm_data()
    kw = _kw(max_iters=256, tol=1e-3, check_every=3,
             b=B if problem == "krr" else 1)
    opts = SolverOptions(**kw)
    if problem == "krr":
        single = KernelRidge(lam=0.5, kernel="rbf", options=opts,
                             device="cpu").fit(A, y)
        fleet = solve_fleet(A, y, lams=[0.5], kernel="rbf", options=opts,
                            device="cpu")
    else:
        single = KernelSVM(C=0.5, kernel="rbf", options=opts,
                           device="cpu").fit(A, y)
        fleet = solve_fleet(A, y, Cs=[0.5], kernel="rbf", options=opts,
                            device="cpu")
    assert torch.equal(fleet.alpha[0], single.alpha)
    np.testing.assert_array_equal(fleet.history[:, 0], single.history)
    assert fleet.rounds_run == single.rounds_run
    assert torch.equal(fleet.schedule, single.schedule)


def test_fleet_warm_start_and_validation():
    A, y = _krr_data()
    opts = SolverOptions(**_kw())
    w0 = np.full(M, 0.01, np.float32)
    a = solve_fleet(A, y, lams=LAMS, options=opts, warm_start=w0,
                    device="cpu")
    jf = j_solve_fleet(A, y, lams=LAMS, kernel=None,
                       options=JSolverOptions(**_kw()), warm_start=w0)
    b = solve_fleet(A, y, lams=LAMS, options=opts, device="cpu",
                    warm_start=np.broadcast_to(w0, (len(LAMS), M)),
                    schedule=_sched("krr", _kw(), M))
    np.testing.assert_allclose(b.alpha.numpy(), np.asarray(jf.alpha), **TOL)
    assert torch.equal(a.alpha, solve_fleet(A, y, lams=LAMS, options=opts,
                                             warm_start=w0,
                                             device="cpu").alpha)
    with pytest.raises(ValueError, match="exactly one"):
        solve_fleet(A, y, lams=LAMS, Cs=CS, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        solve_fleet(A, y, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        solve_fleet(A, y, lams=[1.0, -2.0], device="cpu")
    with pytest.raises(ValueError, match="slab-free"):
        solve_fleet(A, y, lams=LAMS, options=SolverOptions(slab_free=False),
                    device="cpu")
    # the 1d fleet runs (here on the (1, 1) mesh) and solves the serial
    # fleet's problems; 2d fleets stay refused, as in the JAX package
    d1 = solve_fleet(A, y, lams=LAMS, options=dataclasses.replace(
        opts, layout="1d"), warm_start=w0, device="cpu")
    np.testing.assert_allclose(d1.alpha.numpy(), a.alpha.numpy(), **TOL)
    assert d1.options.layout == "1d" and d1.comm["P"] == 1
    with pytest.raises(ValueError, match="2d fleets"):
        solve_fleet(A, y, lams=LAMS, options=SolverOptions(layout="2d"),
                    device="cpu")
    with pytest.raises(ValueError, match="warm_start"):
        solve_fleet(A, y, lams=LAMS, warm_start=np.zeros(3), device="cpu")
    assert a.comm["modeled_speedup"] > 1.0


def test_streamed_fleet_runs_the_eager_loop_and_matches_resident():
    A, y = _krr_data()
    kw = _kw(tol=1e-3, check_every=2, max_iters=256)
    res = solve_fleet(A, y, lams=LAMS, options=SolverOptions(**kw),
                      device="cpu")
    st = solve_fleet(A, y, lams=LAMS, options=SolverOptions(stream=40, **kw),
                     device="cpu")
    assert not st.op.capturable
    np.testing.assert_allclose(st.alpha.numpy(), res.alpha.numpy(), **TOL)
    np.testing.assert_allclose(st.history, res.history, rtol=1e-5)


# ---------------------------------------------------------------------------
# the fleet round factories and the fleet driver against the JAX ones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss", ["l1", "l2"])
def test_ksvm_fleet_round_matches_jax_vmapped_factory(loss):
    A, y = _svm_data()
    Cs = np.array(CS, np.float32)
    sched = _sched("ksvm", _kw(b=1), M)
    jcfg = JSVMConfig(C=1.0, loss=loss, kernel=JKernelConfig("rbf"))

    def member(alpha, C, xs):
        return j_make_sstep_dcd(jnp.asarray(A), jnp.asarray(y), jcfg, S,
                                C=C)(alpha, xs)
    vround = jax.vmap(member, in_axes=(0, 0, None))
    xs = j_pad_rounds(jnp.asarray(sched), S)
    ja = jnp.zeros((len(CS), M))
    for k in range(3):
        ja = vround(ja, jnp.asarray(Cs), (xs[0][k], xs[1][k]))
    rf = make_sstep_dcd_round_fn(torch.from_numpy(A), torch.from_numpy(y),
                                 SVMConfig(C=1.0, loss=loss,
                                           kernel=KernelConfig("rbf")), S,
                                 C=torch.from_numpy(Cs))
    txs = pad_rounds(torch.from_numpy(sched).long(), S)
    ta = torch.zeros((len(CS), M))
    for k in range(3):
        ta = rf(ta, (txs[0][k], txs[1][k]))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)


def test_krr_fleet_round_matches_jax_vmapped_factory():
    A, y = _krr_data()
    lams = np.array(LAMS, np.float32)
    sched = _sched("krr", _kw(), M)
    jcfg = JKRRConfig(lam=1.0, kernel=JKernelConfig("rbf"))

    def member(alpha, lam, xs):
        return j_make_sstep_bdcd(jnp.asarray(A), jnp.asarray(y), jcfg, S,
                                 lam=lam)(alpha, xs)
    vround = jax.vmap(member, in_axes=(0, 0, None))
    xs = j_pad_rounds(jnp.asarray(sched), S)
    ja = jnp.zeros((len(LAMS), M))
    for k in range(3):
        ja = vround(ja, jnp.asarray(lams), (xs[0][k], xs[1][k]))
    rf = make_sstep_bdcd_round_fn(torch.from_numpy(A), torch.from_numpy(y),
                                  KRRConfig(kernel=KernelConfig("rbf")), S,
                                  lam=torch.from_numpy(lams))
    txs = pad_rounds(torch.from_numpy(sched).long(), S)
    ta = torch.zeros((len(LAMS), M))
    for k in range(3):
        ta = rf(ta, (txs[0][k], txs[1][k]))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)


@pytest.mark.parametrize("problem", ["krr", "ksvm"])
def test_classical_fleet_rounds_match_their_single_rounds(problem):
    """``make_dcd_round_fn(C=)`` / ``make_bdcd_round_fn(lam=)`` with an
    (F,) tensor: member f of the fleet round is the single round at
    values[f]."""
    A, y = _krr_data() if problem == "krr" else _svm_data()
    At, yt = torch.from_numpy(A), torch.from_numpy(y)
    vals = (0.3, 1.0, 5.0)
    if problem == "krr":
        cfg = KRRConfig(kernel=KernelConfig("rbf"))
        sched = torch.from_numpy(_sched("krr", _kw(), M)).long()
        fleet = make_bdcd_round_fn(At, yt, cfg, lam=torch.tensor(vals))
        singles = [make_bdcd_round_fn(At, yt, cfg, lam=v) for v in vals]
    else:
        cfg = SVMConfig(loss="l2", kernel=KernelConfig("rbf"))
        sched = torch.from_numpy(_sched("ksvm", _kw(b=1), M)).long()
        fleet = make_dcd_round_fn(At, yt, cfg, C=torch.tensor(vals))
        singles = [make_dcd_round_fn(At, yt, cfg, C=v) for v in vals]
    fa = run_rounds(fleet, torch.zeros((len(vals), M)), sched).state
    for f, rf in enumerate(singles):
        sa = run_rounds(rf, torch.zeros(M), sched).state
        np.testing.assert_allclose(fa[f].numpy(), sa.numpy(), **TOL)


def test_run_rounds_fleet_matches_jax_driver():
    """The fleet driver on a toy round (each member halves toward its own
    target) against the JAX driver: the same checks, history, mask."""
    targets = np.array([1.0, 4.0, 16.0], np.float32)

    def metric_np(state):
        return np.abs(state - targets[:, None]).max(axis=1)

    jres = j_run_rounds_fleet(
        lambda st, x: st + 0.5 * (jnp.asarray(targets)[:, None] - st) * x,
        jnp.zeros((3, 5)), jnp.ones((40,)) * jnp.linspace(0.5, 1.0, 40),
        tol=0.05, check_every=3,
        metric_fn=lambda st: jnp.max(jnp.abs(
            st - jnp.asarray(targets)[:, None]), axis=1))
    tgt = torch.from_numpy(targets)
    tres = run_rounds_fleet(
        lambda st, x: st + 0.5 * (tgt[:, None] - st) * x,
        torch.zeros((3, 5)), torch.ones(40) * torch.linspace(0.5, 1.0, 40),
        tol=0.05, check_every=3,
        metric_fn=lambda st: torch.amax((st - tgt[:, None]).abs(), dim=1))
    assert tres.rounds_run == int(jres.rounds_run)
    assert tres.checks_run == int(jres.checks_run)
    np.testing.assert_array_equal(tres.converged.numpy(),
                                  np.asarray(jres.converged))
    np.testing.assert_allclose(tres.metric_history().numpy(),
                               np.asarray(jres.metric_history()), rtol=1e-6)
    np.testing.assert_allclose(tres.state.numpy(), np.asarray(jres.state),
                               rtol=1e-6)
    assert (metric_np(tres.state.numpy()) <= 0.05).all()
    eager = run_rounds_fleet(
        lambda st, x: st + 0.5 * (tgt[:, None] - st) * x,
        torch.zeros((3, 5)), torch.ones(40) * torch.linspace(0.5, 1.0, 40),
        tol=0.05, check_every=3, capture=False,
        metric_fn=lambda st: torch.amax((st - tgt[:, None]).abs(), dim=1))
    assert torch.equal(eager.state, tres.state)
    assert torch.equal(eager.metric_history(), tres.metric_history())


# ---------------------------------------------------------------------------
# warm-started paths and cross-validation
# ---------------------------------------------------------------------------

def test_reg_path_matches_jax():
    A, y = _krr_data()
    kw = _kw(max_iters=4096, tol=2e-2, check_every=4)
    jp = j_reg_path(A, y, lams=LAMS, kernel="rbf",
                    options=JSolverOptions(**kw))
    tp = reg_path(A, y, lams=LAMS, kernel="rbf", options=SolverOptions(**kw),
                  schedule=_sched("krr", kw, M), device="cpu")
    np.testing.assert_array_equal(tp.values, jp.values)
    assert list(tp.values) == sorted(LAMS, reverse=True)
    assert [r.iters_run for r in tp.results] == [r.iters_run
                                                 for r in jp.results]
    assert tp.total_iters == jp.total_iters
    np.testing.assert_allclose(tp.alphas.numpy(), np.asarray(jp.alphas),
                               **TOL)
    for i in range(len(LAMS)):
        np.testing.assert_allclose(tp.metric_history(i),
                                   jp.metric_history(i), rtol=1e-5,
                                   atol=1e-6)
    # the warm starts pay: fewer iterations than cold fits
    cold = sum(KernelRidge(lam=float(v), kernel="rbf", device="cpu",
                           options=SolverOptions(**kw)).fit(A, y).iters_run
               for v in tp.values)
    assert tp.total_iters < cold


@pytest.mark.parametrize("problem", ["krr", "ksvm"])
def test_fit_path_matches_jax_and_leaves_the_last_rung_fitted(problem):
    if problem == "krr":
        A, y = _krr_data()
        kw = _kw(max_iters=1024, tol=5e-2, check_every=4)
        jest = JKernelRidge(lam=123.0, kernel="rbf",
                            options=JSolverOptions(**kw))
        est = KernelRidge(lam=123.0, kernel="rbf", device="cpu",
                          options=SolverOptions(**kw))
        grid = LAMS
    else:
        A, y = _svm_data()
        kw = _kw(b=1, max_iters=512)
        jest = JKernelSVM(C=1.0, kernel="rbf", options=JSolverOptions(**kw))
        est = KernelSVM(C=1.0, kernel="rbf", device="cpu",
                        options=SolverOptions(**kw))
        grid = CS
    jpath = jest.fit_path(A, y, grid)
    path = est.fit_path(A, y, grid, schedule=_sched(problem, kw, M))
    assert path.param == ("lam" if problem == "krr" else "C")
    np.testing.assert_array_equal(path.values, jpath.values)
    np.testing.assert_allclose(path.alphas.numpy(), np.asarray(jpath.alphas),
                               **TOL)
    if problem == "krr":
        assert est.cfg.lam == jest.cfg.lam == min(LAMS)
        np.testing.assert_allclose(est.predict(A).numpy(),
                                   np.asarray(jest.predict(A)), **TOL)
    else:
        assert est.cfg.C == jest.cfg.C == max(CS)
        np.testing.assert_allclose(est.decision_function(A).numpy(),
                                   np.asarray(jest.decision_function(A)),
                                   **TOL)
    assert torch.equal(est.alpha_, path.results[-1].alpha)


@pytest.mark.parametrize("m,k,seed", [(96, 3, 0), (97, 5, 3), (10, 2, 7)])
def test_fold_indices_match_jax(m, k, seed):
    got, want = _fold_indices(m, k, seed), j_fold_indices(m, k, seed)
    assert len(got) == len(want) == k
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("via", ["fleet", "path"])
def test_cross_validate_krr_matches_jax(via):
    """Both packages solve each fold to tol 1e-5, where their solutions
    agree whatever the schedule: the same best lambda, scores within 1e-3
    relative."""
    A, y = _krr_data()
    kw = _kw(max_iters=8192, tol=1e-5, check_every=4)
    jcv = j_cross_validate(A, y, lams=LAMS, kernel="rbf",
                           options=JSolverOptions(**kw), folds=3, via=via)
    cv = cross_validate(A, y, lams=LAMS, kernel="rbf",
                        options=SolverOptions(**kw), folds=3, via=via,
                        device="cpu")
    assert cv.scores.shape == (3, len(LAMS)) and cv.score_name == "mse"
    assert cv.best_value == jcv.best_value and cv.best_index == \
        jcv.best_index
    np.testing.assert_allclose(cv.scores, jcv.scores, rtol=1e-3)
    assert cv.mean_scores[cv.best_index] == cv.mean_scores.min()


def test_cross_validate_ksvm_matches_jax():
    A, y = _svm_data(margin=3.0)
    kw = _kw(b=1, max_iters=2048, tol=1e-4, check_every=4)
    jcv = j_cross_validate(A, y, Cs=CS, kernel="rbf",
                           options=JSolverOptions(**kw), folds=3)
    cv = cross_validate(A, y, Cs=CS, kernel="rbf",
                        options=SolverOptions(**kw), folds=3, device="cpu")
    assert cv.score_name == "accuracy"
    np.testing.assert_allclose(cv.scores, jcv.scores, atol=1.0 / 32)
    assert cv.mean_scores[cv.best_index] > 0.8
    with pytest.raises(ValueError, match="via"):
        cross_validate(A, y, Cs=CS, via="grid", device="cpu")
    with pytest.raises(ValueError, match="folds"):
        cross_validate(A, y, Cs=CS, folds=1, device="cpu")


# ---------------------------------------------------------------------------
# the autotuner, FitResult.comm and FitResult.plan
# ---------------------------------------------------------------------------

AUTO_CASES = [dict(s="auto"), dict(s="auto", b="auto"),
              dict(s="auto", approx="auto", landmarks=24),
              dict(b="auto", layout="auto"),
              dict(s="auto", b=8, max_iters=1024),
              dict(method="classical", b="auto"),
              dict(s="auto", stream="auto")]


@pytest.mark.parametrize("case", AUTO_CASES,
                         ids=[str(sorted(c)) for c in AUTO_CASES])
@pytest.mark.parametrize("m,n", [(M, N), (50_000, 64)])
def test_resolve_options_matches_jax(case, m, n):
    kw = _kw(**case)
    jcfg = JKRRConfig(lam=1.0, kernel=JKernelConfig("rbf"))
    tcfg = KRRConfig(lam=1.0, kernel=KernelConfig("rbf"))
    jp = j_resolve_options(m, n, jcfg, JSolverOptions(**kw), problem="krr",
                           hbm_bytes=HBM)
    tp = resolve_options(m, n, tcfg, SolverOptions(**kw), problem="krr",
                         budget=JAX_BUDGET)
    assert isinstance(tp, TunedPlan)
    assert tp.choice == jp.choice
    assert tp.options.stream == jp.options.stream
    assert [dict(f) for f in tp.frontier] == [dict(f) for f in jp.frontier]
    assert tp.modeled == pytest.approx(jp.modeled, rel=1e-12)


@pytest.mark.parametrize("s,b,budget", [("auto", 8, 4 * 50_000 * 8 * 4),
                                        (256, "auto", 4 * 50_000 * 8)])
def test_resolve_options_budget_constraint_matches_jax(s, b, budget):
    """The HBM working-set constraint, and a PINNED s above it resolving
    the remaining knobs toward the smallest working set."""
    kw = dict(method="sstep", s=s, b=b, max_iters=1024)
    jp = j_resolve_options(50_000, 64, JKRRConfig(), JSolverOptions(**kw),
                           problem="krr", hbm_bytes=budget)
    tp = resolve_options(50_000, 64, KRRConfig(), SolverOptions(**kw),
                         problem="krr",
                         budget=DeviceBudget(budget, budget, 1e10))
    assert tp.choice == jp.choice
    assert [dict(f) for f in tp.frontier] == [dict(f) for f in jp.frontier]
    assert any(not f["feasible"] for f in tp.frontier)


@pytest.mark.parametrize("problem", ["krr", "ksvm"])
@pytest.mark.parametrize("rep", [{}, dict(approx="nystrom", landmarks=24),
                                 dict(stream=40), dict(method="classical")],
                         ids=["exact", "nystrom", "stream", "classical"])
def test_fit_comm_matches_jax(problem, rep):
    A, y = _krr_data() if problem == "krr" else _svm_data()
    kw = _kw(b=B if problem == "krr" else 1, **rep)
    if rep.get("method") == "classical":
        kw["s"] = 1
    if problem == "krr":
        jres = JKernelRidge(lam=0.5, kernel="rbf",
                            options=JSolverOptions(**kw)).fit(A, y)
        res = KernelRidge(lam=0.5, kernel="rbf", device="cpu",
                          options=SolverOptions(**kw)).fit(A, y)
    else:
        jres = JKernelSVM(C=0.5, kernel="rbf",
                          options=JSolverOptions(**kw)).fit(A, y)
        res = KernelSVM(C=0.5, kernel="rbf", device="cpu",
                        options=SolverOptions(**kw)).fit(A, y)
    assert res.comm == pytest.approx(jres.comm, rel=1e-12)
    assert res.plan is None and jres.plan is None


def _jax_budget(monkeypatch):
    """The facade tunes within the device's own budget: hand it the JAX
    package's."""
    monkeypatch.setattr(DeviceBudget, "of_device",
                        classmethod(lambda cls, device: JAX_BUDGET))


@pytest.mark.parametrize("problem", ["krr", "ksvm"])
def test_tuned_fit_carries_the_jax_plan(problem, monkeypatch):
    _jax_budget(monkeypatch)
    A, y = _krr_data() if problem == "krr" else _svm_data()
    kw = _kw(s="auto", b="auto" if problem == "krr" else 1)
    if problem == "krr":
        jres = JKernelRidge(lam=1.0, kernel="rbf",
                            options=JSolverOptions(**kw)).fit(A, y)
        res = KernelRidge(lam=1.0, kernel="rbf", device="cpu",
                          options=SolverOptions(**kw)).fit(A, y)
    else:
        jres = JKernelSVM(C=1.0, kernel="rbf",
                          options=JSolverOptions(**kw)).fit(A, y)
        res = KernelSVM(C=1.0, kernel="rbf", device="cpu",
                        options=SolverOptions(**kw)).fit(A, y)
    assert res.plan.choice == jres.plan.choice
    assert res.plan.modeled == pytest.approx(jres.plan.modeled, rel=1e-12)
    assert [dict(f) for f in res.plan.frontier] == [
        dict(f) for f in jres.plan.frontier]
    assert (res.options.s, res.options.b) == (jres.options.s,
                                              jres.options.b)
    assert res.comm == pytest.approx(jres.comm, rel=1e-12)
    feas = [f for f in res.plan.frontier if f["feasible"]]
    assert res.plan.modeled["time"] == min(f["time"] for f in feas)
    assert res.plan.budget == JAX_BUDGET


def test_probe_measures_the_top_candidates():
    """On the CPU the probe times each candidate's second call (the JAX
    package's rule); the winner is the fastest measured one."""
    A, y = _svm_data()
    opts = SolverOptions(**_kw(b=1, s="auto", probe=2, max_iters=32))
    res = KernelSVM(C=1.0, kernel="rbf", device="cpu",
                    options=opts).fit(A, y)
    probed = res.plan.probed
    assert probed is not None and 1 <= len(probed) <= 3
    for p in probed:
        assert p["measured_s"] > 0 and p["wall_s"] > 0
        assert {"capture_s", "warmup_s", "s", "b", "time"} <= set(p)
    assert res.options.s == min(probed, key=lambda p: p["measured_s"])["s"]
    jres = JKernelSVM(C=1.0, kernel="rbf", options=JSolverOptions(
        **_kw(b=1, s="auto", probe=2, max_iters=32))).fit(A, y)
    assert [(p["s"], p["b"]) for p in probed] == [
        (p["s"], p["b"]) for p in jres.plan.probed]


def test_stream_auto_resolves_the_chunk_within_the_budget(monkeypatch):
    """``stream=True`` resolves its chunk size from the streaming model
    within the budget; given the JAX package's budget it picks the JAX
    package's chunk (ROADMAP C8)."""
    A, y = _krr_data(m=600)
    kw = _kw(stream=True, max_iters=64)
    jres = JKernelRidge(lam=1.0, kernel="rbf",
                        options=JSolverOptions(**kw)).fit(A, y)
    own = KernelRidge(lam=1.0, kernel="rbf", device="cpu",
                      options=SolverOptions(**kw)).fit(A, y)
    _jax_budget(monkeypatch)
    res = KernelRidge(lam=1.0, kernel="rbf", device="cpu",
                      options=SolverOptions(**kw)).fit(
        A, y, schedule=_sched("krr", kw, 600))
    assert res.options.stream == jres.options.stream
    assert res.representation == "exact"
    np.testing.assert_allclose(res.alpha.numpy(), np.asarray(jres.alpha),
                               **TOL)
    assert own.plan.budget.dma_bps == float("inf")
    assert isinstance(own.options.stream, int) and own.options.stream >= 1


@pytest.mark.parametrize("floor,want", [(1, 128), (1536, 2048),
                                        (1408, 2048), (16_384, 8192)])
def test_stream_auto_keeps_the_budgets_chunk_floor(floor, want):
    """The tuner takes no chunk below ``DeviceBudget.min_chunk_rows`` (on
    the card, the rows whose chunk pair has a tile for every SM: 1536 on
    132 SMs, 1408 on 114), the largest candidate when none reaches it;
    with no floor it picks what the JAX model picks for the same budget
    and link.  An H100-like budget:
    38.56 GB for the working set, a 48 GB/s link."""
    kw = _kw(s=8, b=32, stream="auto", max_iters=2048)
    budget = DeviceBudget(80 * 2 ** 30, 38_560_000_000, 48e9,
                          min_chunk_rows=floor)
    tp = resolve_options(19_996, 8192, KRRConfig(), SolverOptions(**kw),
                         problem="krr", budget=budget)
    assert tp.options.stream == want
    if floor == 1:
        assert want == j_choose_chunk_rows(19_996, 8192, 256, "rbf",
                                           dma_bps=48e9,
                                           budget_bytes=38_560_000_000)


def test_solver_options_auto_validation():
    with pytest.raises(ValueError, match="positive int"):
        SolverOptions(s="AUTO")
    with pytest.raises(ValueError, match="positive int"):
        SolverOptions(b=0)
    with pytest.raises(ValueError, match="probe"):
        SolverOptions(probe=-1)
    with pytest.raises(ValueError, match="stream"):
        SolverOptions(stream="AUTO")
    with pytest.raises(ValueError, match="exact"):
        SolverOptions(stream=True, approx="nystrom")
    assert SolverOptions(s="auto", b="auto", layout="auto",
                         approx="auto").needs_autotune
    assert SolverOptions(stream=True).stream == "auto"
    assert not SolverOptions().needs_autotune
    with pytest.raises(ValueError, match="unresolved"):
        _ = SolverOptions(s="auto").s_eff
    assert SolverOptions(s="auto", method="classical").s_eff == 1


# ---------------------------------------------------------------------------
# kmv_plan: the main path's plans, and the fleet's full matvec
# ---------------------------------------------------------------------------

MAIN_PLANS = [  # (m, r, c, same) -> (regime, bm, br, splits, rows_per_split)
    ((19_996, 1, 1, False), ("rows", 1, 1, 527, 38)),
    ((19_996, 32, 1, False), ("narrow", 32, 32, 625, 32)),
    ((19_996, 256, 1, False), ("wide", 128, 64, 157, 128)),
    ((19_996, 1024, 1, False), ("wide", 128, 128, 157, 128)),
    ((19_996, 19_996, 1, True), ("symmetric", 128, 128, 157, 128)),
    ((19_996, 19_996, 1, False), ("wide", 128, 128, 157, 128)),
    # a full matvec past WS_MAX_FLOATS at c = 1 keeps the wide plan
    ((50_000, 50_000, 1, True), ("wide", 128, 128, 196, 256)),
    ((19_996, 32, 4, False), ("narrow", 32, 32, 625, 32)),
    ((19_996, 256, 16, False), ("wide", 128, 64, 157, 128)),
    ((19_996, 32, 8, False), ("narrow", 32, 32, 625, 32)),
    ((19_996, 19_996, 4, True), ("symmetric", 128, 128, 157, 128)),
    ((19_996, 19_996, 8, True), ("symmetric", 128, 128, 157, 128)),
    ((19_996, 19_996, 16, True), ("symmetric", 128, 128, 157, 128)),
    ((19_996, 19_996, 16, False), ("wide", 128, 128, 40, 512)),
    # the guarded rounds' apply_at, K(A[idx], A)^T w: K-SVM s = 32 takes
    # the narrow tile over its 32 sampled rows, K-RR's 256 the wide one
    ((32, 19_996, 1, False), ("narrow", 32, 32, 1, 32)),
    ((256, 19_996, 1, False), ("wide", 128, 64, 2, 128)),
]


@pytest.mark.parametrize("args,want", MAIN_PLANS,
                         ids=[f"m{a[0]}-r{a[1]}-c{a[2]}-"
                              f"{'sym' if a[3] else 'B'}"
                              for a, _ in MAIN_PLANS])
def test_kmv_plan_pins_the_main_paths_plans(args, want):
    """Every c = 1 plan of the main path at m = 19 996 on 132 SMs (an
    H100 SXM) stays as it was, and so does a c = 1 full matvec whose
    symmetric workspace would pass WS_MAX_FLOATS (m = 50 000); the
    fleet's full matvec B = A keeps the symmetric plan at c = 4, 8 and
    16 (its workspace passes WS_MAX_FLOATS, within SYM_WS_MAX_FLOATS);
    the guarded apply_at of sb = 32 rows takes the narrow tile, not a
    128-row tile three quarters padding."""
    m, r, c, same = args
    assert tuple(kmv_plan(m, r, c, 132, same)) == want


def test_solve_cli_takes_auto_knobs_and_prints_comm(capsys):
    solve.main(["--device", "cpu", "--problem", "krr", "--dataset",
                "bodyfat", "--b", "auto", "--s", "auto", "--probe", "1",
                "--H", "32"])
    out = capsys.readouterr().out
    assert "comm:" in out and "plan:" in out and "probed" in out
