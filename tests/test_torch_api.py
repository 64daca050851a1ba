"""The port's facade against the JAX estimators, the state converter,
the import boundary, and the default device.

Facade parity replays the JAX fit's schedule through ``fit(schedule=)``
from the same data: alpha and predictions to 1e-5 (the f32 bound of
tests/test_slabfree_parity.py), the tolerance-path history to 1e-5
relative.
"""
import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.api import KernelRidge as JKernelRidge
from repro.api import KernelSVM as JKernelSVM
from repro.api import SolverOptions as JSolverOptions
from repro.core import block_schedule as j_block_schedule
from repro.core import coordinate_schedule as j_coordinate_schedule
from repro_torch import convert
from repro_torch.api import KernelRidge, KernelSVM, SolverOptions, UNPORTED
from repro_torch.data import synthetic
from repro_torch.launch import solve

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


def _svm_data(m=72, n=12, q=20, seed=0):
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(m + q) < 0.5, 1.0, -1.0).astype(np.float32)
    w = rng.standard_normal(n)
    A = ((rng.standard_normal((m + q, n)) + 0.8 * y[:, None] * w
          / np.linalg.norm(w)) / np.sqrt(n)).astype(np.float32)
    return A[:m], y[:m], A[m:]


def _krr_data(m=64, n=8, q=20, seed=1):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m + q, n)) / np.sqrt(n)).astype(np.float32)
    y = np.sin(A @ rng.standard_normal(n)).astype(np.float32)
    return A[:m], y[:m], A[m:]


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
@pytest.mark.parametrize("method,s", [("sstep", 8), ("classical", 1)])
def test_ksvm_fit_replay_and_predict_match_jax(kernel, method, s):
    A, y, Q = _svm_data()
    kw = dict(method=method, s=s, max_iters=60, seed=4)
    jest = JKernelSVM(C=1.0, kernel=kernel, options=JSolverOptions(**kw))
    jres = jest.fit(A, y)
    est = KernelSVM(C=1.0, kernel=kernel, options=SolverOptions(**kw),
                    device="cpu")
    res = est.fit(A, y, schedule=np.asarray(jres.schedule))
    assert (res.rounds_run, res.iters_run) == (jres.rounds_run,
                                               jres.iters_run)
    np.testing.assert_allclose(res.alpha.numpy(), np.asarray(jres.alpha),
                               **TOL)
    np.testing.assert_allclose(est.decision_function(Q).numpy(),
                               np.asarray(jest.decision_function(Q)), **TOL)
    agree = (est.predict(Q).numpy() == np.asarray(jest.predict(Q))).mean()
    assert agree == 1.0


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_krr_fit_replay_and_predict_match_jax(kernel):
    A, y, Q = _krr_data()
    kw = dict(method="sstep", s=4, b=4, max_iters=26, seed=5)
    jest = JKernelRidge(lam=0.5, kernel=kernel,
                        options=JSolverOptions(**kw))
    jres = jest.fit(A, y)
    est = KernelRidge(lam=0.5, kernel=kernel, options=SolverOptions(**kw),
                      device="cpu")
    res = est.fit(A, y, schedule=np.asarray(jres.schedule))
    np.testing.assert_allclose(res.alpha.numpy(), np.asarray(jres.alpha),
                               **TOL)
    np.testing.assert_allclose(est.predict(Q).numpy(),
                               np.asarray(jest.predict(Q)), **TOL)
    # a warm start from the first solution, replayed the same way
    a0 = np.asarray(jres.alpha)
    jres2 = jest.fit(A, y, warm_start=a0)
    res2 = est.fit(A, y, warm_start=a0,
                   schedule=np.asarray(jres2.schedule))
    np.testing.assert_allclose(res2.alpha.numpy(), np.asarray(jres2.alpha),
                               **TOL)


def test_tolerance_fits_stop_where_jax_stops():
    """The checked loop through the facade: the same stop, the same
    history.  The JAX fit's full schedule is redrawn from its seed (its
    FitResult.schedule is cut at the stop)."""
    A, y, _ = _krr_data(seed=2)
    kw = dict(method="sstep", s=2, b=4, max_iters=80, seed=6,
              check_every=2, record=True)
    jfull = JKernelRidge(lam=0.5, kernel="rbf",
                         options=JSolverOptions(**kw)).fit(A, y)
    hist = jfull.metric_history()
    tol = float(np.sqrt(hist[2] * hist[3]))          # stop at check 3
    kw.update(tol=tol, record=False)
    jres = JKernelRidge(lam=0.5, kernel="rbf",
                        options=JSolverOptions(**kw)).fit(A, y)
    full = j_block_schedule(jax.random.key(6), 80, A.shape[0], 4)
    res = KernelRidge(lam=0.5, kernel="rbf", options=SolverOptions(**kw),
                      device="cpu").fit(A, y, schedule=np.asarray(full))
    assert res.converged and jres.converged
    assert (res.rounds_run, res.iters_run) == (jres.rounds_run,
                                               jres.iters_run) == (8, 16)
    np.testing.assert_array_equal(res.schedule.numpy(),
                                  np.asarray(jres.schedule))
    np.testing.assert_allclose(res.history, jres.history, rtol=1e-5, atol=0)
    np.testing.assert_allclose(res.alpha.numpy(), np.asarray(jres.alpha),
                               **TOL)

    # K-SVM: the duality gap (one slab-free KMV here, the m x m gram there)
    A, y, _ = _svm_data(seed=3)
    kw = dict(method="sstep", s=4, max_iters=48, seed=7, check_every=3,
              record=True)
    jres = JKernelSVM(C=1.0, kernel="rbf",
                      options=JSolverOptions(**kw)).fit(A, y)
    res = KernelSVM(C=1.0, kernel="rbf", options=SolverOptions(**kw),
                    device="cpu").fit(A, y, schedule=np.asarray(
                        j_coordinate_schedule(jax.random.key(7), 48,
                                              A.shape[0])))
    np.testing.assert_allclose(res.history, jres.history, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jres.history).max()))


def test_materialized_slab_fit_matches_slab_free():
    A, y, Q = _svm_data(seed=8)
    sched = np.random.default_rng(0).integers(0, A.shape[0], 40)
    fits = [KernelSVM(kernel="rbf", device="cpu",
                      options=SolverOptions(s=8, slab_free=sf)).fit(
                          A, y, schedule=sched).alpha for sf in (True,
                                                                 False)]
    np.testing.assert_allclose(fits[0].numpy(), fits[1].numpy(), **TOL)


def test_convert_carries_a_jax_fit_across():
    A, y, Q = _svm_data(seed=9)
    jest = JKernelSVM(C=0.7, kernel="polynomial",
                      options=JSolverOptions(s=4, max_iters=40))
    jres = jest.fit(A, y)
    est = convert.fitted_estimator(
        "ksvm", dataclasses.asdict(jest.cfg), np.asarray(jest.A_),
        np.asarray(jest.y_), np.asarray(jest.alpha_),
        options={"s": 4, "max_iters": 40}, device="cpu")
    assert est.cfg.C == 0.7 and est.cfg.kernel.name == "polynomial"
    want = np.asarray(jest.decision_function(Q))
    np.testing.assert_allclose(est.decision_function(Q).numpy(), want,
                               rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
    sched = convert.schedule(jres.schedule, device="cpu")
    assert sched.dtype == torch.int64

    A, y, Q = _krr_data(seed=10)
    jreg = JKernelRidge(lam=0.3, kernel="rbf",
                        options=JSolverOptions(s=2, b=4, max_iters=20))
    jreg.fit(A, y)
    reg = convert.fitted_estimator(
        "krr", dataclasses.asdict(jreg.cfg), np.asarray(jreg.A_),
        np.asarray(jreg.y_), np.asarray(jreg.alpha_), device="cpu")
    np.testing.assert_allclose(reg.predict(Q).numpy(),
                               np.asarray(jreg.predict(Q)), **TOL)
    with pytest.raises(ValueError, match="A7"):
        convert.solver_options({"guard": True})


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_options_raise_naming_their_roadmap_item(name):
    default, item = UNPORTED[name]
    other = {"layout": "1d", "mesh": object(), "approx": "nystrom",
             "landmarks": 8, "landmark_method": "kmeans", "probe": 2,
             "guard": True, "recompute_every": 4, "checkpoint_every": 2,
             "checkpoint_dir": "ckpt", "fallback": False, "stream": 64,
             "telemetry": True}[name]
    with pytest.raises(ValueError, match=item):
        SolverOptions(**{name: other})
    SolverOptions(**{name: default})


@pytest.mark.parametrize("bad", [dict(method="newton"), dict(s=0),
                                 dict(b=-1), dict(s="AUTO"),
                                 dict(max_iters=0), dict(check_every=0),
                                 dict(tol=-1e-3), dict(tol=float("nan"))])
def test_bad_options_raise_eagerly(bad):
    with pytest.raises(ValueError):
        SolverOptions(**bad)


def test_eager_validation_of_inputs_and_hyperparameters():
    A, y, Q = _svm_data(seed=11)
    with pytest.raises(ValueError, match="C must be > 0"):
        KernelSVM(C=0.0, device="cpu")
    with pytest.raises(ValueError, match="lam must be > 0"):
        KernelRidge(lam=-1.0, device="cpu")
    bad = A.copy()
    bad[3, 2] = np.nan
    with pytest.raises(ValueError, match="A contains 1 non-finite"):
        KernelSVM(device="cpu").fit(bad, y)
    with pytest.raises(ValueError, match="y contains"):
        KernelSVM(device="cpu").fit(A, np.where(y > 0, np.inf, y))
    est = KernelSVM(device="cpu", options=SolverOptions(max_iters=8))
    est.fit(A, y)
    with pytest.raises(ValueError, match="A_test contains"):
        est.predict(np.full_like(Q, np.inf))
    with pytest.raises(ValueError, match="schedule indices"):
        est.fit(A, y, schedule=np.array([0, A.shape[0]]))
    with pytest.raises(ValueError, match="schedule must have shape"):
        KernelRidge(device="cpu", options=SolverOptions(b=4)).fit(
            A, y, schedule=np.zeros((5, 3), np.int64))


def test_default_device_is_the_card_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KernelSVM()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KernelRidge(lam=1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic.load("duke")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve.main(["--H", "8"])
    with pytest.raises(RuntimeError, match="CUDA"):
        KernelSVM(device="cuda")


def test_synthetic_datasets_have_the_papers_shapes():
    gen = torch.Generator().manual_seed(0)
    for name in ("duke", "bodyfat", "synthetic-sparse"):
        A, y = synthetic.load(name, gen, device="cpu")
        spec = synthetic.PAPER_DATASETS[name]
        assert tuple(A.shape) == (spec["m"], spec["n"])
        assert y.shape == (spec["m"],) and A.dtype == torch.float32
    A, y = synthetic.classification_dataset(gen, 30, 5, device="cpu")
    assert set(y.tolist()) <= {-1.0, 1.0}


def test_solve_cli_runs_on_the_host(capsys):
    solve.main(["--device", "cpu", "--H", "64", "--s", "8"])
    out = capsys.readouterr().out
    assert "max|a_s - a_dcd|" in out
    solve.main(["--device", "cpu", "--problem", "krr", "--dataset",
                "bodyfat", "--b", "4", "--s", "4", "--H", "32"])
    assert "rel err vs closed form" in capsys.readouterr().out


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                f"{path.relative_to(ROOT)} imports {mod}")
