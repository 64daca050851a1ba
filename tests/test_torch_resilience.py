"""The port's guarded solves (``repro_torch.resilience``, ``core.loop``'s
guarded driver, the facade's executor) against the JAX package's, on the
same numpy inputs, replaying the JAX ``FitResult.schedule`` from the same
start, at the sizes of tests/test_resilience.py (m = 192, n = 12).

Bounds: alpha 1e-5 (the f32 iterate bound, tests/test_slabfree_parity.py),
metric histories 1e-5 relative, drift below 1e-4
(tests/test_resilience.py), ``apply_at`` at the KMV bound 2e-4
(tests/test_kmv.py), the f64 plain versions against numpy f64 at 1e-12
relative.  This module injects NaN and Inf into solver carries on
purpose.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import KernelRidge as JKernelRidge
from repro.api import KernelSVM as JKernelSVM
from repro.api import SolverOptions as JSolverOptions
from repro.core.kernels import ExactGramOperator as JExact
from repro.core.kernels import KernelConfig as JKernelConfig
from repro.core.kernels import StreamingGramOperator as JStreaming
from repro.core.nystrom import fit_nystrom as j_fit_nystrom
from repro.core.nystrom import lowrank_operator as j_lowrank_operator
from repro.resilience import FaultPlan as JFaultPlan
from repro.resilience import finite_health as j_finite_health
from repro.resilience import inject as j_inject
from repro.resilience import next_fallback as j_next_fallback
from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
from repro_torch.core import (ExactGramOperator, KernelConfig, KRRConfig,
                              LowRankGramOperator, StreamingGramOperator,
                              SVMConfig, make_bdcd_round_fn,
                              make_dcd_round_fn, make_sstep_bdcd_round_fn,
                              make_sstep_dcd_round_fn, pad_rounds)
from repro_torch.core import loop
from repro_torch.core.distributed import AllreduceGramOperator
from repro_torch.launch.mesh import make_mesh
from repro_torch.core.nystrom import NystromMap
from repro_torch.core.perf_model import DeviceBudget
from repro_torch.kernels import ops
from repro_torch.kernels.gram import gram_plain
from repro_torch.kernels.kmv import kmv_plain
from repro_torch.kernels.kmv_stream import (kmv_stream_apply_plain,
                                            kmv_stream_full_plain,
                                            kmv_stream_plain)
from repro_torch.resilience import (DivergenceError, FaultPlan,
                                    SimulatedKill, finite_health, inject,
                                    make_correct_fn, next_fallback,
                                    poisoned_1d_factory)
from repro_torch.resilience.checkpoint import (load_fit, operator_meta,
                                               operator_template, save_fit)
from repro_torch.tune.autotune import resolve_options

TOL = dict(rtol=1e-5, atol=1e-5)


def _data(m=192, n=12, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    w = rng.standard_normal(n)
    yc = np.sign(A @ w + 0.1 * rng.standard_normal(m)).astype(np.float32)
    yr = (A @ w + 0.1 * rng.standard_normal(m)).astype(np.float32)
    return A, yc, yr


def _kw(**kw):
    base = dict(method="sstep", s=8, max_iters=384, seed=3, slab_free=True)
    base.update(kw)
    return base


def _estimators(problem, kernel, kw, jkw=None):
    """(JAX estimator, port estimator) of one problem and options."""
    if kernel == "linear":
        jk, k = JKernelConfig("linear"), KernelConfig("linear")
    else:
        jk, k = JKernelConfig("rbf", sigma=0.3), KernelConfig("rbf",
                                                              sigma=0.3)
    jkw = kw if jkw is None else jkw
    if problem == "ksvm":
        return (JKernelSVM(C=1.0, kernel=jk, options=JSolverOptions(**jkw)),
                KernelSVM(C=1.0, kernel=k, options=SolverOptions(**kw),
                          device="cpu"))
    return (JKernelRidge(lam=0.5, kernel=jk, options=JSolverOptions(**jkw)),
            KernelRidge(lam=0.5, kernel=k, options=SolverOptions(**kw),
                        device="cpu"))


def _events(health):
    return [(e.kind, e.round_idx, e.iter_idx, e.action)
            for e in health.events]


# ---------------------------------------------------------- guarded fits


@pytest.mark.parametrize("method", ["sstep", "classical"])
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
@pytest.mark.parametrize("problem", ["ksvm", "krr"])
def test_guarded_fit_matches_jax(problem, kernel, method):
    """The guarded carry, its corrections and checks against JAX's: alpha
    1e-5, the same number of corrections and checks, histories 1e-5
    relative, drift below 1e-4 on both sides."""
    A, yc, yr = _data()
    y = yc if problem == "ksvm" else yr
    kw = _kw(method=method, guard=True, recompute_every=5, record=True,
             check_every=4, max_iters=384 if method == "sstep" else 96)
    if problem == "krr":
        kw["b"] = 8
    jest, est = _estimators(problem, kernel, kw)
    jres = jest.fit(A, y)
    res = est.fit(A, y, schedule=np.asarray(jres.schedule))
    np.testing.assert_allclose(res.alpha.numpy(), np.asarray(jres.alpha),
                               **TOL)
    assert (res.rounds_run, res.iters_run) == (jres.rounds_run,
                                               jres.iters_run)
    h, jh = res.health, jres.health
    assert h.guarded and h.corrections == jh.corrections > 0
    assert len(h.drift) == len(jh.drift) == h.corrections
    np.testing.assert_allclose(h.drift, jh.drift, rtol=1e-5, atol=1e-5)
    assert h.max_drift < 1e-4 and jh.max_drift < 1e-4
    assert len(res.history) == len(jres.history) > 0
    np.testing.assert_allclose(res.history, jres.history, rtol=1e-5,
                               atol=1e-7)
    assert h.fallbacks == () and h.recompute_every == 5


def test_guarded_fit_is_the_unguarded_iterate_sequence():
    """The guarded carry is an algebraic rearrangement of the plain
    round: the same alpha to f32 roundoff (tests/test_resilience.py)."""
    A, yc, _ = _data()
    sched = np.asarray(JKernelSVM(C=1.0, options=JSolverOptions(
        **_kw())).fit(A, yc).schedule)
    plain = KernelSVM(C=1.0, kernel="rbf", options=SolverOptions(**_kw()),
                      device="cpu").fit(A, yc, schedule=sched)
    guard = KernelSVM(C=1.0, kernel="rbf", device="cpu",
                      options=SolverOptions(**_kw(guard=True,
                                                  recompute_every=16))
                      ).fit(A, yc, schedule=sched)
    np.testing.assert_allclose(guard.alpha.numpy(), plain.alpha.numpy(),
                               atol=5e-6)
    assert plain.health is None and guard.health.corrections > 0


# ------------------------------------------------------------- apply_at


def _operators(kernel, m=70, n=9, l=16, seed=5):
    """Matching JAX and port operators over the same data: exact,
    low-rank (one Nystrom map) and streamed (16-row chunks)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32) / 2
    jk = JKernelConfig(**kernel)
    k = KernelConfig(**kernel)
    import jax
    fmap = j_fit_nystrom(jax.random.key(0), jnp.asarray(A), jk, l)
    jlow = j_lowrank_operator(fmap, jnp.asarray(A))
    low = LowRankGramOperator(Phi=torch.from_numpy(np.asarray(jlow.Phi)))
    return A, {
        "exact": (JExact(jnp.asarray(A), jk),
                  ExactGramOperator(torch.from_numpy(A), k)),
        "lowrank": (jlow, low),
        "stream": (JStreaming.from_dense(jnp.asarray(A), jk, chunk_rows=16),
                   StreamingGramOperator.from_dense(torch.from_numpy(A), k,
                                                    16)),
    }


KERNELS = [dict(name="linear"), dict(name="polynomial", degree=3, coef0=1.0),
           dict(name="rbf", sigma=0.7)]


@pytest.mark.parametrize("rep", ["exact", "lowrank", "stream"])
@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: k["name"])
def test_apply_at_matches_jax(kernel, rep):
    """``K[:, idx] @ w`` of each representation against the JAX
    operator's, duplicate indices included, at the KMV bound."""
    _, ops_ = _operators(kernel)
    jop, op = ops_[rep]
    idx = np.array([3, 17, 17, 40, 69, 0, 5, 33], np.int64)
    w = np.random.default_rng(1).standard_normal(8).astype(np.float32)
    got = op.apply_at(torch.from_numpy(idx), torch.from_numpy(w)).numpy()
    want = np.asarray(jop.apply_at(jnp.asarray(idx, jnp.int32),
                                   jnp.asarray(w)))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * scale)


# -------------------------------------------------- faults and the ladder


@pytest.mark.parametrize("value", [float("nan"), float("inf")],
                         ids=["nan", "inf"])
@pytest.mark.parametrize("target", ["f", "alpha"])
def test_fault_recovers_as_jax_does(target, value):
    """A NaN or Inf on either carry leaf: the same HealthEvents as JAX
    (one rung, halve_s:8->4) and alpha within 1e-5 of JAX's."""
    A, yc, _ = _data()
    kw = _kw(guard=True, recompute_every=16)
    jest, est = _estimators("ksvm", "rbf", kw)
    with j_inject(JFaultPlan(nan_at_iter=96, target=target,
                             value=value)) as jplan:
        jres = jest.fit(A, yc)
    with inject(FaultPlan(nan_at_iter=96, target=target,
                          value=value)) as plan:
        res = est.fit(A, yc, schedule=np.asarray(jres.schedule))
    assert plan.carry_fired and jplan.carry_fired
    assert _events(res.health) == _events(jres.health)
    assert [e.action for e in res.health.fallbacks] == ["halve_s:8->4"]
    np.testing.assert_allclose(res.alpha.numpy(), np.asarray(jres.alpha),
                               **TOL)


def test_ladder_descends_to_f64_as_jax_does(monkeypatch):
    """A fault on a classical fit escalates to f64, as in JAX: the same
    events, alpha within 1e-5, and the rung's kernel arithmetic in f64."""
    A, _, yr = _data()
    kw = _kw(b=4, method="classical", guard=True)
    jest, est = _estimators("krr", "linear", kw)
    with j_inject(JFaultPlan(nan_at_iter=40, target="alpha")):
        jres = jest.fit(A, yr)
    seen = []
    for name in ("kmv", "gram"):
        fn = getattr(ops, name)

        def spy(*a, _fn=fn, **k):
            seen.append(a[0].dtype)
            return _fn(*a, **k)

        monkeypatch.setattr(ops, name, spy)
    with inject(FaultPlan(nan_at_iter=40, target="alpha")):
        res = est.fit(A, yr, schedule=np.asarray(jres.schedule))
    assert _events(res.health) == _events(jres.health)
    assert [e.action for e in res.health.fallbacks] == ["f64"]
    assert torch.float64 in seen and seen[0] == torch.float32
    assert res.alpha.dtype == torch.float32
    np.testing.assert_allclose(res.alpha.numpy(), np.asarray(jres.alpha),
                               **TOL)


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: k["name"])
def test_f64_plain_versions_compute_in_f64(kernel):
    """kmv, gram and the streamed plain versions keep f64 for f64 inputs:
    against numpy f64 at 1e-12 relative (f32 arithmetic reads ~1e-7)."""
    rng = np.random.default_rng(7)
    A = rng.standard_normal((50, 20)) / 3
    B = rng.standard_normal((7, 20)) / 3
    X = rng.standard_normal((50, 2))
    W = rng.standard_normal((7, 2))
    dots = A @ B.T
    if kernel["name"] == "linear":
        K = dots
    elif kernel["name"] == "polynomial":
        K = (kernel["coef0"] + dots) ** kernel["degree"]
    else:
        sq = (A * A).sum(1)[:, None] + (B * B).sum(1)[None, :] - 2 * dots
        K = np.exp(-kernel["sigma"] * np.maximum(sq, 0))
    cfg = KernelConfig(**kernel)
    t = torch.from_numpy
    close = dict(rtol=1e-12, atol=1e-12)
    got = gram_plain(t(A), t(B), cfg)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), K, **close)
    np.testing.assert_allclose(kmv_plain(t(A), t(B), t(X), cfg).numpy(),
                               K.T @ X, **close)
    Xc = t(np.concatenate([A, np.zeros((14, 20))]).reshape(4, 16, 20))
    Xvc = t(np.concatenate([X, np.zeros((14, 2))]).reshape(4, 16, 2))
    np.testing.assert_allclose(
        kmv_stream_plain(Xc, t(B), Xvc, cfg, m=50).numpy(), K.T @ X,
        **close)
    np.testing.assert_allclose(
        kmv_stream_apply_plain(Xc, t(B), t(W), cfg, m=50).numpy(), K @ W,
        **close)
    full = gram_plain(t(A), t(A), cfg).numpy() @ X
    np.testing.assert_allclose(
        kmv_stream_full_plain(Xc, Xvc, cfg, m=50).numpy(), full, **close)


@pytest.mark.parametrize("x64", [False, True])
@pytest.mark.parametrize("method", ["sstep", "classical"])
@pytest.mark.parametrize("s", [1, 2, 3, 8, 32])
def test_next_fallback_matches_jax(s, method, x64):
    from repro.resilience import DivergenceError as JDivergenceError
    try:
        want = j_next_fallback(s, method, x64)
    except JDivergenceError as e:
        with pytest.raises(DivergenceError, match="exhausted"):
            next_fallback(s, method, x64)
        assert "exhausted" in str(e)
        return
    assert next_fallback(s, method, x64) == want


def test_fallback_disabled_raises():
    A, yc, _ = _data()
    est = KernelSVM(C=1.0, kernel="rbf", device="cpu", options=SolverOptions(
        **_kw(guard=True, fallback=False)))
    with inject(FaultPlan(nan_at_iter=96)):
        with pytest.raises(DivergenceError, match="fallback is disabled"):
            est.fit(A, yc)


@pytest.mark.parametrize("leaf", [0, 1])
@pytest.mark.parametrize("value", [float("nan"), float("inf")])
def test_finite_health_sees_every_leaf(leaf, value):
    carry = [torch.ones(4), torch.zeros(3)]
    assert bool(finite_health(tuple(carry)))
    assert bool(j_finite_health(tuple(jnp.asarray(c.numpy())
                                      for c in carry)))
    carry[leaf][1] = value
    assert not bool(finite_health(tuple(carry)))
    assert not bool(j_finite_health(tuple(jnp.asarray(c.numpy())
                                          for c in carry)))


def test_poisoned_1d_factory_names_a11():
    """The poisoned factory scales its rank's shard (every contribution of
    that rank to the round's reduction) and leaves other ranks' alone;
    nonlinear kernels are refused, as in the JAX package."""
    mesh = make_mesh()
    rng = np.random.default_rng(0)
    A = torch.tensor(rng.standard_normal((12, 5)), dtype=torch.float32)
    x = torch.tensor(rng.standard_normal(12), dtype=torch.float32)
    idx = torch.tensor([3, 7, 7])
    lin = KernelConfig("linear")
    G, v = AllreduceGramOperator(mesh, "model", A, lin).round_data(idx, x)
    Gp, vp = poisoned_1d_factory(mesh, scale=3.0)(A, lin).round_data(idx, x)
    np.testing.assert_allclose(Gp.numpy(), 9.0 * G.numpy(), rtol=1e-6)
    np.testing.assert_allclose(vp.numpy(), 9.0 * v.numpy(), rtol=1e-6)
    Go, _ = poisoned_1d_factory(mesh, rank=1, scale=3.0)(A, lin).round_data(
        idx, x)
    assert torch.equal(Go, G)
    Gn, _ = poisoned_1d_factory(mesh)(A, lin).round_data(idx, x)
    assert bool(torch.isnan(Gn).all())
    with pytest.raises(ValueError, match="linear"):
        poisoned_1d_factory(mesh)(A, KernelConfig("rbf"))


# ------------------------------------------------------ the loop driver


def _guarded_krr_round(m=60, n=7, s=3, b=4, seed=2):
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
    op = ExactGramOperator(A, KernelConfig("rbf", sigma=0.4))
    cfg = KRRConfig(lam=0.5, kernel=op.cfg)
    sched = torch.from_numpy(rng.integers(0, m, (50, b)))
    return (make_sstep_bdcd_round_fn(A, y, cfg, s, op=op, guard=True), op,
            y, pad_rounds(sched, s), m)


@pytest.mark.parametrize("fault_round", [-1, 0, 6, 16])
@pytest.mark.parametrize("check_every,correct_every", [(4, 3), (5, 5),
                                                       (16, 0)])
def test_guarded_graph_driver_equals_the_eager_loop(check_every,
                                                    correct_every,
                                                    fault_round):
    """The run/buffer driver of the captured guarded rounds (executed
    eagerly on the CPU) against the plain per-round loop: the same state
    bit for bit, the same histories, corrections, first bad round and
    kind, whatever the runs' boundaries."""
    base, op, y, xs, m = _guarded_krr_round()
    R = xs[0].shape[0]
    hits = torch.arange(R) == fault_round

    def rf(carry, xz):
        a, f = base(carry, xz[:-1])
        return a, f + torch.where(xz[-1], torch.tensor(float("nan")),
                                  torch.tensor(0.0))

    guard = loop.GuardSpec(finite_health, make_correct_fn(op), correct_every)
    metric = lambda c: torch.linalg.norm(op.full_matvec(c[0]) - y)
    state0 = (torch.zeros(m), torch.zeros(m))
    kw = dict(tol=loop.NO_TOL, check_every=check_every, metric_fn=metric)
    got = loop._run_rounds_guarded(rf, state0, (*xs, hits), guard, **kw)
    want = loop._run_rounds_guarded_eager(rf, state0, (*xs, hits), guard,
                                          **kw)
    for a, b in zip(got.state, want.state):
        assert torch.equal(a, b)
    assert (got.rounds_run, got.checks_run, got.corrections,
            got.diverged_round, got.diverged_kind) == \
        (want.rounds_run, want.checks_run, want.corrections,
         want.diverged_round, want.diverged_kind)
    assert got.diverged_round == fault_round
    assert torch.equal(got.metric_history(), want.metric_history())
    if correct_every:
        assert torch.equal(got.drift_history(), want.drift_history())
    else:
        assert got.drift_history() is None


def test_guarded_runs_end_at_every_check_and_correction():
    runs = loop._guard_runs(20, 8, True, 3)
    ends = [lo + n for lo, n, _, _ in runs]
    assert ends == [3, 6, 8, 9, 12, 15, 16, 18, 20]
    assert [(c, k) for _, _, c, k in runs] == [
        (True, False), (True, False), (False, True), (True, False),
        (True, False), (True, False), (False, True), (True, False),
        (False, True)]
    assert [n for _, n, _, _ in loop._guard_runs(20, 8, False, 0)] == \
        [8, 8, 4]


def test_metric_blowup_stops_the_run_as_jax_does():
    """A metric above 1e4 x the best so far marks the run diverged at
    that round (kind METRIC) with the round's update kept."""
    vals = iter([1.0, 0.5, 1e5, 0.1])
    rf = lambda c, x: (c[0] + 1.0, c[1])
    guard = loop.GuardSpec(finite_health)
    for run in (loop._run_rounds_guarded, loop._run_rounds_guarded_eager):
        vals = iter([1.0, 0.5, 1e5, 0.1])
        res = run(rf, (torch.zeros(2), torch.zeros(2)), torch.zeros(8),
                  guard, tol=loop.NO_TOL, check_every=2,
                  metric_fn=lambda c: torch.tensor(next(vals)))
        assert (res.diverged_round, res.diverged_kind) == \
            (5, loop.DIVERGED_METRIC)
        assert res.rounds_run == 6 and float(res.state[0][0]) == 6.0
        assert res.checks_run == 3


@pytest.mark.parametrize("factory,kw", [
    (make_dcd_round_fn, dict(cfg=SVMConfig())),
    (make_sstep_dcd_round_fn, dict(cfg=SVMConfig(), s=4)),
    (make_bdcd_round_fn, dict(cfg=KRRConfig())),
    (make_sstep_bdcd_round_fn, dict(cfg=KRRConfig(), s=4))])
def test_guard_with_gram_fn_raises_as_jax(factory, kw):
    A, y = torch.zeros((8, 3)), torch.ones(8)
    with pytest.raises(ValueError, match="guard=True requires the "
                                         "GramOperator path"):
        factory(A, y, gram_fn=lambda *a: None, guard=True, **kw)


# ------------------------------------------------------ kill and resume


def test_kill_and_resume_reaches_the_uninterrupted_solution(tmp_path):
    """A fit killed mid-solve and resumed with resume_from= equals the
    uninterrupted guarded fit of the same checkpoint cadence bit for bit,
    and JAX's uninterrupted fit within 1e-5."""
    A, yc, _ = _data()
    d = str(tmp_path / "ckpt")
    kw = _kw(guard=True, recompute_every=16, checkpoint_every=8,
             checkpoint_dir=d)
    jres = JKernelSVM(C=1.0, kernel="rbf", options=JSolverOptions(
        **_kw(guard=True, recompute_every=16))).fit(A, yc)
    sched = np.asarray(jres.schedule)
    est = KernelSVM(C=1.0, kernel="rbf", options=SolverOptions(**kw),
                    device="cpu")
    with inject(FaultPlan(kill_at_iter=192)) as plan:
        with pytest.raises(SimulatedKill) as ei:
            est.fit(A, yc, schedule=sched)
    assert plan.kill_fired and ei.value.checkpoint_dir == d
    res = est.fit(A, yc, schedule=sched, resume_from=d)
    assert res.health.resumed_from == d
    assert _events(res.health)[0] == ("resume", 0, 192, "resume")
    full = KernelSVM(C=1.0, kernel="rbf", device="cpu", options=SolverOptions(
        **dict(kw, checkpoint_dir=str(tmp_path / "other")))).fit(
            A, yc, schedule=sched)
    assert torch.equal(res.alpha, full.alpha)
    np.testing.assert_allclose(res.alpha.numpy(), np.asarray(jres.alpha),
                               **TOL)


@pytest.mark.parametrize("what", ["seed", "schedule"])
def test_resume_refuses_a_foreign_checkpoint(tmp_path, what):
    """Another seed, or another replayed schedule under the same seed,
    is another solve: refused, naming the fields that differ."""
    A, yc, _ = _data()
    d = str(tmp_path)
    kw = _kw(guard=True, recompute_every=16, checkpoint_every=8,
             checkpoint_dir=d)
    est = KernelSVM(C=1.0, kernel="rbf", options=SolverOptions(**kw),
                    device="cpu")
    with inject(FaultPlan(kill_at_iter=192)):
        with pytest.raises(SimulatedKill):
            est.fit(A, yc)
    if what == "seed":
        other = KernelSVM(C=1.0, kernel="rbf", device="cpu",
                          options=SolverOptions(**dict(kw, seed=9)))
        call = dict()
        fields = ("schedule", "seed")
    else:
        other = est
        sched = np.random.default_rng(0).integers(0, A.shape[0], 384)
        call = dict(schedule=sched)
        fields = ("schedule",)
    with pytest.raises(ValueError, match="fingerprint") as ei:
        other.fit(A, yc, resume_from=d, **call)
    for name in fields:
        assert f"{name}: checkpoint=" in str(ei.value)


def test_resume_requires_guard():
    A, yc, _ = _data()
    est = KernelSVM(C=1.0, kernel="rbf", options=SolverOptions(**_kw()),
                    device="cpu")
    with pytest.raises(ValueError, match="requires options.guard=True"):
        est.fit(A, yc, resume_from="/nonexistent")


# ------------------------------------------------------------ validation


@pytest.mark.parametrize("bad", [
    dict(guard=True, checkpoint_every=4),
    dict(checkpoint_every=4, checkpoint_dir="ckpt"),
    dict(guard=True, recompute_every=-1),
    dict(guard=True, recompute_every="sometimes"),
    dict(checkpoint_every=-2),
    dict(checkpoint_every=1.5),
    dict(guard=True, slab_free=False)])
def test_guard_option_validation_raises_what_jax_raises(bad):
    with pytest.raises(ValueError) as jerr:
        JSolverOptions(**bad)
    with pytest.raises(ValueError) as err:
        SolverOptions(**bad)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("problem,kernel,s", [("ksvm", "linear", 8),
                                              ("ksvm", "rbf", 1),
                                              ("krr", "rbf", 4)])
def test_recompute_every_auto_resolves_to_jax(problem, kernel, s):
    """recompute_every="auto" through the facade, and with s="auto"
    through resolve_options, resolves to JAX's cadence."""
    A, yc, yr = _data()
    y = yc if problem == "ksvm" else yr
    kw = _kw(guard=True, s=s, max_iters=64, b=4 if problem == "krr" else 1)
    jest, est = _estimators(problem, kernel, kw)
    jres = jest.fit(A, y)
    res = est.fit(A, y, schedule=np.asarray(jres.schedule))
    assert res.options.recompute_every == jres.options.recompute_every >= 1
    assert res.health.recompute_every == res.options.recompute_every
    budget = DeviceBudget(16 * 2 ** 30, 16 * 2 ** 20, 800e9, slots=2)
    from repro.tune.autotune import resolve_options as j_resolve
    auto = dict(kw, s="auto")
    cfg = (SVMConfig(kernel=KernelConfig(kernel)) if problem == "ksvm"
           else KRRConfig(kernel=KernelConfig(kernel)))
    plan = resolve_options(4096, 64, cfg, SolverOptions(**auto),
                           problem=problem, budget=budget)
    jplan = j_resolve(4096, 64, jest.cfg, JSolverOptions(**auto),
                      problem=problem)
    assert plan.options.s == jplan.options.s
    assert plan.options.recompute_every == jplan.options.recompute_every


# -------------------------------------------------------- save and load


@pytest.mark.parametrize("rep", ["exact", "nystrom", "stream"])
def test_save_and_load_fit_round_trip(tmp_path, rep):
    """A guarded fit and its operator saved and loaded: arrays, scalars,
    options and the health ledger come back, and the loaded operator
    predicts what the fitted one does."""
    A, _, yr = _data()
    kw = _kw(b=4, guard=True, recompute_every=8, record=True)
    if rep == "nystrom":
        kw.update(approx="nystrom", landmarks=32)
    elif rep == "stream":
        kw.update(stream=64)
    est = KernelRidge(lam=0.5, kernel="rbf", options=SolverOptions(**kw),
                      device="cpu")
    res = est.fit(A, yr)
    save_fit(str(tmp_path), res, est.op_)
    got, op = load_fit(str(tmp_path), device="cpu")
    assert torch.equal(got.alpha, res.alpha)
    assert torch.equal(got.schedule, res.schedule)
    np.testing.assert_array_equal(got.history, res.history)
    assert got.options == res.options
    assert (got.rounds_run, got.iters_run, got.converged) == \
        (res.rounds_run, res.iters_run, res.converged)
    assert got.health.events == res.health.events
    np.testing.assert_array_equal(got.health.drift, res.health.drift)
    assert got.health.corrections == res.health.corrections > 0
    assert type(op) is type(est.op_)
    assert operator_meta(op) == operator_meta(est.op_)
    Q = torch.from_numpy(A[:5])
    np.testing.assert_allclose(
        op.serve_block(Q, op.serve_weights(res.alpha)).numpy(),
        est.op_.serve_block(Q, est.op_.serve_weights(res.alpha)).numpy(),
        rtol=1e-6, atol=1e-6)
    tmpl = operator_template(operator_meta(est.op_))
    assert type(tmpl) is type(est.op_)


def test_operator_template_of_a_nystrom_map_keeps_its_kernel():
    meta = {"kind": "lowrank", "has_fmap": True,
            "kernel": dataclasses.asdict(KernelConfig("rbf", sigma=0.2))}
    tmpl = operator_template(meta)
    assert isinstance(tmpl.fmap, NystromMap)
    assert tmpl.fmap.kernel == KernelConfig("rbf", sigma=0.2)
    with pytest.raises(ValueError, match="unknown operator kind"):
        operator_template({"kind": "sharded"})
