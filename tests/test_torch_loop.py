"""The port's round driver (``repro_torch.core.loop``): runs of rounds over
static buffers, the CPU twin of the captured CUDA graphs, against the
JAX package's jitted ``run_rounds`` (``lax.scan`` / ``lax.while_loop``)
on the same numpy data and schedule, and against the port's own eager
loop.

f32 iterates are held to 1e-5 against JAX (tests/test_slabfree_parity.py)
and bit for bit against the eager loop, which runs the same operations in
the same order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import KernelConfig as JKernelConfig
from repro.core import KRRConfig as JKRRConfig
from repro.core import SVMConfig as JSVMConfig
from repro.core import block_schedule as j_block_schedule
from repro.core import coordinate_schedule as j_coordinate_schedule
from repro.core import krr_rel_residual as j_krr_rel_residual
from repro.core import make_bdcd_round_fn as j_make_bdcd
from repro.core import make_dcd_round_fn as j_make_dcd
from repro.core import make_sstep_bdcd_round_fn as j_make_sstep_bdcd
from repro.core import make_sstep_dcd_round_fn as j_make_sstep_dcd
from repro.core import pad_rounds as j_pad_rounds
from repro.core import run_rounds as j_run_rounds
from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
from repro_torch.core import (NO_TOL, ExactGramOperator, GramOperator,
                              KernelConfig, KRRConfig,
                              LowRankGramOperator, StreamingGramOperator,
                              SVMConfig, krr_rel_residual,
                              make_bdcd_round_fn, make_dcd_round_fn,
                              make_sstep_bdcd_round_fn,
                              make_sstep_dcd_round_fn, pad_rounds,
                              run_rounds)
from repro_torch.core import loop

TOL = dict(rtol=1e-5, atol=1e-5)
C = loop.FAST_RUN


def _t(x):
    return torch.tensor(np.asarray(x))


def _svm_data(m=48, n=12, seed=0):
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
    A = ((rng.standard_normal((m, n)) + 0.4 * y[:, None]) /
         np.sqrt(n)).astype(np.float32)
    return A, y


def _krr_data(m=40, n=8, seed=1):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    y = np.sin(A @ rng.standard_normal(n)).astype(np.float32)
    return A, y


def _svm_rounds(R, s=2, seed=0):
    """An s-step K-SVM round function on both sides and R rounds of one
    schedule: (JAX round fn, JAX xs, port round fn, port xs, m)."""
    A, y = _svm_data(seed=seed)
    sched = j_coordinate_schedule(jax.random.key(seed + 7), R * s,
                                  A.shape[0])
    kernel = dict(name="rbf", sigma=0.8)
    jcfg = JSVMConfig(C=1.0, kernel=JKernelConfig(**kernel))
    cfg = SVMConfig(C=1.0, kernel=KernelConfig(**kernel))
    j_rf = j_make_sstep_dcd(jnp.asarray(A), jnp.asarray(y), jcfg, s)
    rf = make_sstep_dcd_round_fn(_t(A), _t(y), cfg, s)
    return (j_rf, j_pad_rounds(sched, s), rf,
            pad_rounds(_t(np.asarray(sched)).long(), s), A.shape[0])


def _krr_rounds(R, s=2, b=3, seed=3):
    A, y = _krr_data(seed=seed)
    sched = j_block_schedule(jax.random.key(seed + 11), R * s, A.shape[0],
                             b)
    kernel = dict(name="rbf", sigma=1.0)
    jcfg = JKRRConfig(lam=0.5, kernel=JKernelConfig(**kernel))
    cfg = KRRConfig(lam=0.5, kernel=KernelConfig(**kernel))
    jA, jy = jnp.asarray(A), jnp.asarray(y)
    j_rf = j_make_sstep_bdcd(jA, jy, jcfg, s)
    rf = make_sstep_bdcd_round_fn(_t(A), _t(y), cfg, s)
    j_metric = lambda a: j_krr_rel_residual(jA, jy, a, jcfg)  # noqa: E731
    metric = lambda a: krr_rel_residual(_t(A), _t(y), a, cfg)  # noqa: E731
    return (j_rf, j_pad_rounds(sched, s), j_metric, rf,
            pad_rounds(_t(np.asarray(sched)).long(), s), metric, A.shape[0])


def _j_run(j_rf, j_xs, m, **kw):
    return jax.jit(lambda a0: j_run_rounds(j_rf, a0, j_xs, **kw))(
        jnp.zeros(m, jnp.float32))


def _assert_bit_equal(got, want):
    for name in ("state", "state_hist", "metric_hist"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            assert torch.equal(g, w), name
    assert (got.checks_run, got.rounds_run, got.converged) == \
        (want.checks_run, want.rounds_run, want.converged)


# ---- the fast path (lax.scan) ------------------------------------------

@pytest.mark.parametrize("R", [1, C - 1, C, C + 1, 3 * C + 2])
def test_fast_path_runs_match_jax_scan(R):
    """Runs of FAST_RUN rounds and a tail run: one graph of the run length
    and one of the tail's on the card; the same buffers here."""
    j_rf, j_xs, rf, xs, m = _svm_rounds(R)
    want = _j_run(j_rf, j_xs, m)
    got = run_rounds(rf, torch.zeros(m), xs)
    assert got.rounds_run == R and got.checks_run == 0
    assert got.metric_hist is None and got.state_hist is None
    assert not got.converged
    np.testing.assert_allclose(got.state.numpy(), np.asarray(want.state),
                               **TOL)


@pytest.mark.parametrize("R", [C - 1, C + 1, 2 * C + 3])
def test_record_state_matches_jax_scan(R):
    """Each round's state, written into the run's static (c, m) buffer and
    copied out after the run, stacks as the scan's per-round states."""
    j_rf, j_xs, rf, xs, m = _svm_rounds(R, seed=1)
    want = _j_run(j_rf, j_xs, m, record_state=True)
    got = run_rounds(rf, torch.zeros(m), xs, record_state=True)
    assert got.state_hist.shape == (R, m)
    np.testing.assert_allclose(got.state_hist.numpy(),
                               np.asarray(want.state_hist), **TOL)
    np.testing.assert_array_equal(got.state_hist[-1].numpy(),
                                  got.state.numpy())


# ---- the tolerance path (lax.while_loop) --------------------------------

def _tol_between(hist, i):
    """A tolerance that the check i meets and the check before misses."""
    return float(np.sqrt(hist[i - 1] * hist[i])) if i else \
        float(hist[0]) * 1.0001


@pytest.mark.parametrize("where,check_every,R", [
    (where, 3, 14) for where in ("first", "between", "never")] + [
    (where, 4, 12) for where in ("first", "between", "never")] + [
    ("first", 5, 3), ("never", 5, 3)])
def test_tolerance_path_matches_jax_while_loop(where, check_every, R):
    """Runs of check_every rounds, each ending in its check (a shorter
    tail run ends in the forced final one): the same history, checks,
    rounds and verdict as the JAX while-loop."""
    j_rf, j_xs, j_metric, rf, xs, metric, m = _krr_rounds(R)
    full = np.asarray(_j_run(j_rf, j_xs, m, tol=NO_TOL,
                             check_every=check_every,
                             metric_fn=j_metric).metric_history())
    n_checks = -(-R // check_every)
    assert len(full) == n_checks
    if where == "first":
        tol = _tol_between(full, 0)
    elif where == "between":
        tol = _tol_between(full, 2)
    else:
        tol = NO_TOL
    want = _j_run(j_rf, j_xs, m, tol=tol, check_every=check_every,
                  metric_fn=j_metric)
    got = run_rounds(rf, torch.zeros(m), xs, tol=tol,
                     check_every=check_every, metric_fn=metric)
    assert got.checks_run == int(want.checks_run) == \
        {"first": 1, "between": 3, "never": n_checks}[where]
    assert got.rounds_run == int(want.rounds_run) == \
        min(got.checks_run * check_every, R)
    assert got.converged == bool(want.converged) == (where != "never")
    assert got.metric_hist.shape == (n_checks,)
    np.testing.assert_allclose(got.metric_history().numpy(),
                               np.asarray(want.metric_history()),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(got.state.numpy(), np.asarray(want.state),
                               **TOL)


# ---- the driver against the eager loop, bit for bit --------------------

def _four_solvers(seed=5):
    """(name, round fn, xs, m, metric fn) for the four solvers at a small
    size, each over a schedule long enough for a tail run."""
    A, y = _svm_data(seed=seed)
    Ak, yk = _krr_data(seed=seed)
    gen = torch.Generator().manual_seed(seed)
    rbf = KernelConfig("rbf", sigma=0.8)
    svm, krr = SVMConfig(C=1.0, kernel=rbf), KRRConfig(lam=0.5, kernel=rbf)
    tA, ty, tAk, tyk = _t(A), _t(y), _t(Ak), _t(yk)
    sched = torch.randint(0, A.shape[0], (C + 9,), generator=gen)
    blocks = torch.stack([torch.randperm(Ak.shape[0], generator=gen)[:3]
                          for _ in range(2 * C + 6)])
    krr_metric = lambda a: krr_rel_residual(tAk, tyk, a, krr)  # noqa: E731
    svm_metric = lambda a: a.abs().sum()                     # noqa: E731
    return [
        ("dcd", make_dcd_round_fn(tA, ty, svm), sched, A.shape[0],
         svm_metric),
        ("sstep_dcd", make_sstep_dcd_round_fn(tA, ty, svm, 4),
         pad_rounds(sched, 4), A.shape[0], svm_metric),
        ("bdcd", make_bdcd_round_fn(tAk, tyk, krr), blocks, Ak.shape[0],
         krr_metric),
        ("sstep_bdcd", make_sstep_bdcd_round_fn(tAk, tyk, krr, 4),
         pad_rounds(blocks, 4), Ak.shape[0], krr_metric),
    ]


@pytest.mark.parametrize("path", ["fast", "record", "tol"])
@pytest.mark.parametrize("solver", ["dcd", "sstep_dcd", "bdcd",
                                    "sstep_bdcd"])
def test_driver_equals_eager_loop_bit_for_bit(solver, path):
    name, rf, xs, m, metric = next(c for c in _four_solvers()
                                   if c[0] == solver)
    a0 = torch.full((m,), 0.01)
    kw = {"fast": {}, "record": dict(record_state=True),
          "tol": dict(tol=NO_TOL, check_every=7, metric_fn=metric)}[path]
    got = run_rounds(rf, a0, xs, **kw)
    want = loop._run_rounds_eager(rf, a0, xs, **kw)
    _assert_bit_equal(got, want)
    assert torch.equal(a0, torch.full((m,), 0.01))     # a0 left untouched


def test_stale_schedule_buffer_changes_the_iterates():
    """Runs replayed without refreshing their schedule buffer repeat the
    first run's coordinates: the wrong driver the chip run's bit-for-bit
    check must catch, and does here."""
    _, rf, xs, m, _ = _four_solvers()[1]
    want = loop._run_rounds_eager(rf, torch.zeros(m), xs)
    with loop.RoundGraphs(rf, torch.zeros(m), xs, 2) as g:
        assert g.n_runs >= 2
        for j in range(g.n_runs):
            g.run(j, refresh=j == 0)
        stale = g.state
    with loop.RoundGraphs(rf, torch.zeros(m), xs, 2) as g:
        for j in range(g.n_runs):
            g.run(j)
        assert torch.equal(g.state, want.state)
    assert not torch.equal(stale, want.state)


def test_round_graphs_split_rounds_into_runs():
    _, rf, xs, m, _ = _four_solvers()[0]
    R = xs.shape[0]
    g = loop.RoundGraphs(rf, torch.zeros(m), xs, 10)
    assert g.n_runs == -(-R // 10)
    assert [g.run_len(j) for j in range(g.n_runs)] == \
        [10] * (R // 10) + ([R % 10] if R % 10 else [])
    assert not g.on_card and g.capture_s == 0.0 and g.pool_bytes == 0
    for bad in (0, R + 1):
        with pytest.raises(ValueError, match="run_len"):
            loop.RoundGraphs(rf, torch.zeros(m), xs, bad)


def test_empty_schedule_runs_no_round():
    _, rf, _, m, metric = _four_solvers()[0]
    none = torch.zeros(0, dtype=torch.long)
    a0 = torch.zeros(m)
    fast = run_rounds(rf, a0, none)
    assert fast.rounds_run == 0 and torch.equal(fast.state, a0)
    tol = run_rounds(rf, a0, none, tol=1.0, metric_fn=metric)
    assert tol.checks_run == 0 and tol.metric_hist.numel() == 0
    with pytest.raises(ValueError, match="check_every"):
        run_rounds(rf, a0, none, metric_fn=metric, check_every=0)


# ---- nothing in a round reads the host ---------------------------------

class _NoHostReads(TorchDispatchMode):
    """Fails on ``aten._local_scalar_dense``: ``.item()``, ``bool(t)``, an
    index by a 0-dim tensor — the reads that stop a CUDA graph capture."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a round or check read a value on the host")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("path", ["operator", "slab", "nystrom"])
@pytest.mark.parametrize("solver", ["dcd", "sstep_dcd", "bdcd",
                                    "sstep_bdcd"])
def test_rounds_and_checks_never_read_the_host(solver, path):
    """What the captured driver replays — every solver's round on the
    exact operator, the materialized slab and a Nystrom factor, and the
    facade's checks — makes no host read, so it can be captured."""
    from repro_torch.core import (ksvm_duality_gap_op, krr_rel_residual_op,
                                  nystrom_map)
    from repro_torch.kernels.ops import make_solver_gram_fn
    svm = solver in ("dcd", "sstep_dcd")
    A, y = _svm_data(seed=2) if svm else _krr_data(seed=2)
    tA, ty = _t(A), _t(y)
    # a Nystrom fit runs the linear kernel over its factor Phi (the facade)
    kernel = KernelConfig("linear" if path == "nystrom" else "rbf")
    cfg = SVMConfig(C=1.0, kernel=kernel) if svm else KRRConfig(0.5, kernel)
    op = ExactGramOperator(tA, kernel)
    if path == "nystrom":
        op = LowRankGramOperator(nystrom_map(tA, tA[:8],
                                             KernelConfig("rbf")))
    train_op = op.scale_rows(ty) if svm else op
    kw = (dict(gram_fn=make_solver_gram_fn()) if path == "slab"
          else dict(op=train_op))
    A_s = op.Phi if path == "nystrom" else tA
    make = {"dcd": make_dcd_round_fn, "sstep_dcd": make_sstep_dcd_round_fn,
            "bdcd": make_bdcd_round_fn,
            "sstep_bdcd": make_sstep_bdcd_round_fn}[solver]
    s = 4 if solver.startswith("sstep") else None
    rf = make(A_s, ty, cfg, s, **kw) if s else make(A_s, ty, cfg, **kw)
    m = A.shape[0]
    sched = torch.arange(8) if svm else torch.arange(24).reshape(8, 3)
    xs = pad_rounds(sched, 4) if s else sched
    x0 = tuple(x[0] for x in xs) if s else xs[0]
    alpha = torch.full((m,), 0.05)
    with _NoHostReads():
        alpha = rf(rf(alpha, x0), x0)
        if svm:
            ksvm_duality_gap_op(op, ty, alpha, cfg)
        elif path == "nystrom":
            krr_rel_residual(A_s, ty, alpha, cfg)
        else:
            krr_rel_residual_op(op, ty, alpha, cfg)
    assert bool(torch.isfinite(alpha).all())


# ---- routing by the operator's attribute -------------------------------

def test_operators_state_whether_they_capture():
    assert GramOperator.capturable is False
    assert ExactGramOperator.capturable is True
    assert LowRankGramOperator.capturable is True
    assert StreamingGramOperator.capturable is False


class _Spy:
    """Counts the drivers a fit takes: RoundGraphs built, eager loops run."""

    def __init__(self, monkeypatch):
        self.graphs = self.eager = 0
        graphs, eager = loop.RoundGraphs, loop._run_rounds_eager
        spy = self

        class Graphs(graphs):
            def __init__(self, *a, **k):
                spy.graphs += 1
                super().__init__(*a, **k)

        def run_eager(*a, **k):
            spy.eager += 1
            return eager(*a, **k)

        monkeypatch.setattr(loop, "RoundGraphs", Graphs)
        monkeypatch.setattr(loop, "_run_rounds_eager", run_eager)


@pytest.mark.parametrize("problem", ["ksvm", "krr"])
@pytest.mark.parametrize("rep", ["exact", "nystrom", "stream"])
def test_facade_routes_by_the_operators_attribute(monkeypatch, problem,
                                                  rep):
    """Exact and Nystrom fits take the run driver, a streamed fit (not
    capturable) the eager loop, and all three give the eager iterates."""
    A, y = _svm_data(seed=9) if problem == "ksvm" else _krr_data(seed=9)
    extra = {"exact": {}, "nystrom": dict(approx="nystrom", landmarks=16),
             "stream": dict(stream=16)}[rep]
    opts = SolverOptions(method="sstep", s=4, b=3, max_iters=40, seed=1,
                         tol=1e-9, check_every=3, **extra)
    make = (lambda: KernelSVM(C=1.0, kernel="rbf", options=opts,
                              device="cpu")) if problem == "ksvm" else \
        (lambda: KernelRidge(lam=0.5, kernel="rbf", options=opts,
                             device="cpu"))
    spy = _Spy(monkeypatch)
    est = make()
    got = est.fit(A, y)
    want_graphs = rep != "stream"
    assert (spy.graphs, spy.eager) == (int(want_graphs),
                                       int(not want_graphs))
    # the same fit through the eager loop alone
    monkeypatch.setattr(loop, "RoundGraphs", None)
    monkeypatch.setattr(type(est.op_), "capturable", False)
    again = make().fit(A, y, schedule=got.schedule)
    assert torch.equal(got.alpha, again.alpha)
    np.testing.assert_array_equal(got.history, again.history)
    assert (got.rounds_run, got.converged) == (again.rounds_run,
                                              again.converged)


def test_solver_functions_route_a_streamed_operator_to_the_eager_loop(
        monkeypatch):
    from repro_torch.core import sstep_bdcd_krr
    A, y = _krr_data(seed=4)
    cfg = KRRConfig(lam=0.5, kernel=KernelConfig("rbf"))
    sched = torch.stack([torch.randperm(A.shape[0])[:3] for _ in range(9)])
    spy = _Spy(monkeypatch)
    op = StreamingGramOperator.from_dense(_t(A), cfg.kernel, 16)
    streamed, _ = sstep_bdcd_krr(_t(A), _t(y), torch.zeros(A.shape[0]),
                                 sched, cfg, 2, op=op)
    assert (spy.graphs, spy.eager) == (0, 1)
    exact, _ = sstep_bdcd_krr(_t(A), _t(y), torch.zeros(A.shape[0]), sched,
                              cfg, 2)
    assert (spy.graphs, spy.eager) == (1, 1)
    np.testing.assert_allclose(streamed.numpy(), exact.numpy(), **TOL)


def test_classical_rounds_match_jax_through_runs():
    """Classical DCD and BDCD, one coordinate (block) a round, over more
    rounds than one run holds."""
    A, y = _svm_data(seed=6)
    sched = j_coordinate_schedule(jax.random.key(2), C + 5, A.shape[0])
    jcfg = JSVMConfig(C=1.0, loss="l2", kernel=JKernelConfig("polynomial",
                                                             degree=3,
                                                             coef0=1.0))
    cfg = SVMConfig(C=1.0, loss="l2", kernel=KernelConfig(
        "polynomial", degree=3, coef0=1.0))
    want = _j_run(j_make_dcd(jnp.asarray(A), jnp.asarray(y), jcfg), sched,
                  A.shape[0])
    got = run_rounds(make_dcd_round_fn(_t(A), _t(y), cfg),
                     torch.zeros(A.shape[0]), _t(np.asarray(sched)).long())
    np.testing.assert_allclose(got.state.numpy(), np.asarray(want.state),
                               **TOL)
    Ak, yk = _krr_data(seed=6)
    blocks = j_block_schedule(jax.random.key(3), C + 2, Ak.shape[0], 4)
    jkcfg = JKRRConfig(lam=0.5, kernel=JKernelConfig("rbf"))
    kcfg = KRRConfig(lam=0.5, kernel=KernelConfig("rbf"))
    want = _j_run(j_make_bdcd(jnp.asarray(Ak), jnp.asarray(yk), jkcfg),
                  blocks, Ak.shape[0])
    got = run_rounds(make_bdcd_round_fn(_t(Ak), _t(yk), kcfg),
                     torch.zeros(Ak.shape[0]), _t(np.asarray(blocks)).long())
    np.testing.assert_allclose(got.state.numpy(), np.asarray(want.state),
                               **TOL)
