"""Estimator facade — the counterpart of ``repro/api.py`` for the serial,
exact-kernel solve:

    from repro_torch.api import KernelSVM, SolverOptions

    clf = KernelSVM(C=1.0, kernel="rbf",
                    options=SolverOptions(method="sstep", s=32,
                                          tol=1e-6, max_iters=2048))
    result = clf.fit(A, y)          # FitResult: alpha, history, schedule
    labels = clf.predict(A_test)

``fit`` builds one ``ExactGramOperator`` (the KMV and gram kernels on the
card), drives the s-step or classical round function through
``core.loop.run_rounds`` — the plain loop when no tolerance or recording
is asked for, the checked loop otherwise — and keeps the operator for
prediction, which runs batched and slab-free through ``core.predict``.
K-SVM stops on the duality gap, K-RR on the relative residual; both are
one full KMV per check.

Estimators run on the CUDA card unless constructed with
``device="cpu"``; without a card and without that argument they raise.
``fit(..., schedule=...)`` replays a given coordinate schedule (for
example the ``FitResult.schedule`` of a JAX fit) instead of drawing one.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import (NO_TOL, BatchedPredictor, ExactGramOperator,
                              KernelConfig, KRRConfig, SVMConfig,
                              as_schedule, block_schedule,
                              coordinate_schedule, krr_rel_residual,
                              ksvm_duality_gap, make_bdcd_round_fn,
                              make_dcd_round_fn, make_sstep_bdcd_round_fn,
                              make_sstep_dcd_round_fn, pad_rounds,
                              run_rounds, validate_queries)
from repro_torch.device import as_tensor, resolve_device
from repro_torch.kernels.ops import make_solver_gram_fn

METHODS = ("classical", "sstep")
AUTO = "auto"

# Knobs of the JAX SolverOptions that this slice of the port does not
# run yet: their JAX defaults, and the ROADMAP item that ports each.
UNPORTED = {
    "layout": ("serial", "A11"),
    "mesh": (None, "A11"),
    "approx": (None, "A4"),
    "landmarks": (256, "A4"),
    "landmark_method": ("uniform", "A4"),
    "probe": (0, "A8"),
    "guard": (False, "A7"),
    "recompute_every": (AUTO, "A7"),
    "checkpoint_every": (0, "A7"),
    "checkpoint_dir": (None, "A7"),
    "fallback": (True, "A7"),
    "stream": (None, "A6"),
    "telemetry": (None, "A10"),
}


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """How to run the solve.

    method:      "classical" or "sstep" (same iterates, one kernel round
                 per s iterations).
    s:           s-step depth (ignored for method="classical").
    b:           block size (K-RR only; K-SVM is scalar-coordinate).
    slab_free:   read the kernel through the operator (default); False
                 forces the materialized-slab parity-oracle path.
    tol:         stop once the convergence metric (duality gap for K-SVM,
                 relative residual for K-RR) falls to tol; 0 disables it.
    check_every: metric cadence, in outer rounds.
    max_iters:   total inner-iteration budget H (H % s != 0 is fine).
    record:      keep the metric history even when tol == 0.
    seed:        seed of the schedule's ``torch.Generator``.

    The remaining fields are the JAX package's other knobs, accepted only
    at their defaults: any other value raises ``ValueError`` naming the
    ROADMAP item that ports it (``UNPORTED``).
    """

    method: str = "sstep"
    s: Union[int, str] = 16
    b: Union[int, str] = 1
    slab_free: bool = True
    tol: float = 0.0
    check_every: int = 8
    max_iters: int = 1024
    record: bool = False
    seed: int = 0
    layout: str = "serial"
    mesh: Optional[object] = None
    approx: Optional[str] = None
    landmarks: int = 256
    landmark_method: str = "uniform"
    probe: int = 0
    guard: bool = False
    recompute_every: Union[int, str] = AUTO
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    fallback: bool = True
    stream: Union[None, bool, int, str] = None
    telemetry: Optional[object] = None

    def __post_init__(self):
        for name, (default, item) in UNPORTED.items():
            value = getattr(self, name)
            if value is not default and value != default:
                raise ValueError(
                    f"{name}={value!r} is not ported to repro_torch yet "
                    f"(ROADMAP {item}); only {name}={default!r} runs")
        if self.method not in METHODS:
            raise ValueError(
                f"method must be one of {METHODS}, got {self.method!r}")
        for name in ("s", "b"):
            v = getattr(self, name)
            if v == AUTO:
                raise ValueError(f'{name}="auto" is not ported to '
                                 f'repro_torch yet (ROADMAP A8, the '
                                 f'autotuner priced by the A5 model)')
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        for name in ("max_iters", "check_every"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        if not self.tol >= 0.0:
            raise ValueError(f"tol must be >= 0, got {self.tol!r}")

    @property
    def s_eff(self) -> int:
        """Inner iterations per kernel round (1 for classical)."""
        return self.s if self.method == "sstep" else 1


@dataclasses.dataclass
class FitResult:
    """What ``fit`` observed: the solution and its trajectory."""

    alpha: torch.Tensor
    schedule: torch.Tensor         # the iterations actually executed —
                                   # truncated to iters_run on early stop,
                                   # so replaying it reproduces alpha
    history: Optional[np.ndarray]  # metric at each check point (or None)
    metric: str                    # "duality_gap" | "rel_residual"
    converged: bool
    rounds_run: int
    iters_run: int
    wall_time_s: float
    options: SolverOptions
    comm: Optional[dict] = None    # communication model: not ported (A5)

    def metric_history(self) -> Optional[np.ndarray]:
        """Every recorded metric value in evaluation order, or None when
        the run recorded none (``tol == 0`` and ``record=False``)."""
        return self.history


def _check_predict_batch(batch) -> int:
    if not isinstance(batch, int) or batch < 1:
        raise ValueError(
            f"predict_batch must be a positive int, got {batch!r}")
    return batch


def _check_positive(value: float, name: str) -> float:
    if not value > 0:
        raise ValueError(f"{name} must be > 0, got {value!r}")
    return value


def _check_finite(value, name: str, device: torch.device) -> torch.Tensor:
    """Eager input validation: non-finite data is rejected at the facade
    with the offending argument named."""
    value = as_tensor(value, device).contiguous()
    if value.is_floating_point() and not bool(torch.isfinite(value).all()):
        bad = int((~torch.isfinite(value)).sum())
        raise ValueError(
            f"{name} contains {bad} non-finite (nan/inf) value"
            f"{'s' if bad != 1 else ''} — clean or impute the data "
            f"before fitting")
    return value


def _as_kernel(kernel: Union[str, KernelConfig, None]) -> KernelConfig:
    if kernel is None:
        return KernelConfig()
    if isinstance(kernel, str):
        return KernelConfig(kernel)
    return kernel


def _check_schedule(schedule, problem: str, m: int, b: int,
                    device: torch.device) -> torch.Tensor:
    sched = as_schedule(schedule, device)
    want = 1 if problem == "ksvm" else 2
    if sched.ndim != want or (problem == "krr" and sched.shape[1] != b):
        shape = "(H,)" if problem == "ksvm" else f"(H, b={b})"
        raise ValueError(f"schedule must have shape {shape}, got "
                         f"{tuple(sched.shape)}")
    if sched.numel() and (int(sched.min()) < 0 or int(sched.max()) >= m):
        raise ValueError(f"schedule indices must lie in [0, {m})")
    return sched


def _fit(problem: str, A: torch.Tensor, y: torch.Tensor, cfg,
         opts: SolverOptions, *, a0=None, schedule=None):
    """One serial exact solve; returns ``(FitResult, operator)``."""
    m = A.shape[0]
    s = opts.s_eff
    b = opts.b if problem == "krr" else 1
    t0 = time.perf_counter()
    op = ExactGramOperator(A, cfg.kernel)
    if schedule is None:
        gen = torch.Generator().manual_seed(opts.seed)
        H = opts.max_iters
        schedule = (coordinate_schedule(gen, H, m, A.device)
                    if problem == "ksvm"
                    else block_schedule(gen, H, m, b, A.device))
    else:
        schedule = _check_schedule(schedule, problem, m, b, A.device)
        H = schedule.shape[0]
    if a0 is None:
        a0 = torch.zeros(m, dtype=A.dtype, device=A.device)
    else:
        a0 = as_tensor(a0).to(device=A.device, dtype=A.dtype)
        if a0.shape != (m,):
            raise ValueError(f"warm_start must have shape ({m},), got "
                             f"{tuple(a0.shape)}")

    gram_fn = None if opts.slab_free else make_solver_gram_fn()
    train_op = None
    if opts.slab_free:
        # K-SVM trains on diag(y) A; prediction keeps the unscaled op
        train_op = op.scale_rows(y) if problem == "ksvm" else op
    if problem == "ksvm":
        rf = (make_dcd_round_fn(A, y, cfg, gram_fn=gram_fn, op=train_op)
              if s == 1 else
              make_sstep_dcd_round_fn(A, y, cfg, s, gram_fn=gram_fn,
                                      op=train_op))
        metric_name = "duality_gap"
        metric_fn = lambda a: ksvm_duality_gap(A, y, a, cfg)  # noqa: E731
    else:
        rf = (make_bdcd_round_fn(A, y, cfg, gram_fn=gram_fn, op=train_op)
              if s == 1 else
              make_sstep_bdcd_round_fn(A, y, cfg, s, gram_fn=gram_fn,
                                       op=train_op))
        metric_name = "rel_residual"
        metric_fn = lambda a: krr_rel_residual(A, y, a, cfg)  # noqa: E731
    xs = schedule if s == 1 else pad_rounds(schedule, s)
    want_metric = opts.tol > 0.0 or opts.record
    res = run_rounds(rf, a0, xs,
                     tol=opts.tol if opts.tol > 0.0 else NO_TOL,
                     check_every=opts.check_every,
                     metric_fn=metric_fn if want_metric else None)
    if A.is_cuda:
        torch.cuda.synchronize(A.device)
    wall = time.perf_counter() - t0
    iters_run = min(res.rounds_run * s, H)
    history = (res.metric_history().double().cpu().numpy()
               if want_metric else None)
    result = FitResult(alpha=res.state, schedule=schedule[:iters_run],
                       history=history, metric=metric_name,
                       converged=res.converged, rounds_run=res.rounds_run,
                       iters_run=iters_run, wall_time_s=wall, options=opts)
    return result, op


class _Estimator:
    """What ``KernelSVM`` and ``KernelRidge`` share: the device, the fit
    plumbing and the fitted state kept for prediction."""

    problem = ""

    def __init__(self, cfg, options: Optional[SolverOptions],
                 predict_batch: int, device):
        self.cfg = cfg
        self.options = options or SolverOptions()
        self.predict_batch = _check_predict_batch(predict_batch)
        self.device = resolve_device(device)

    def fit(self, A, y, warm_start=None, schedule=None) -> FitResult:
        """Solve the dual.  ``warm_start`` seeds alpha (shape (m,));
        ``schedule`` replays a given coordinate schedule ((H,) for K-SVM,
        (H, b) for K-RR) instead of drawing one from ``options.seed``."""
        A = _check_finite(A, "A", self.device)
        y = _check_finite(y, "y", self.device)
        result, op = _fit(self.problem, A, y, self.cfg, self.options,
                          a0=warm_start, schedule=schedule)
        self._adopt(A, y, result.alpha, op, result)
        return result

    def _adopt(self, A, y, alpha, op=None, result=None):
        """Install a fitted state (from ``fit`` or ``convert``)."""
        self.A_, self.y_, self.alpha_ = A, y, alpha
        self.op_ = op if op is not None else ExactGramOperator(
            A, self.cfg.kernel)
        self.result_ = result
        self._predictor = None

    def _queries(self, A_test) -> torch.Tensor:
        A_test = validate_queries(self.op_, A_test, name="A_test")
        return _check_finite(A_test, "A_test", self.device)


class KernelSVM(_Estimator):
    """Kernel SVM solved by (s-step) Dual Coordinate Descent.  ``predict``
    serves through the fitted operator, compacted to the support
    vectors."""

    problem = "ksvm"

    def __init__(self, C: float = 1.0, loss: str = "l1",
                 kernel: Union[str, KernelConfig, None] = None,
                 options: Optional[SolverOptions] = None,
                 predict_batch: int = 1024, device=None):
        _check_positive(C, "C")
        super().__init__(SVMConfig(C=C, loss=loss, kernel=_as_kernel(kernel)),
                         options, predict_batch, device)

    def decision_function(self, A_test) -> torch.Tensor:
        A_test = self._queries(A_test)
        if self._predictor is None:
            self._predictor = BatchedPredictor(
                self.op_, self.alpha_ * self.y_, batch=self.predict_batch,
                compact=True)
        return self._predictor(A_test)

    def predict(self, A_test) -> torch.Tensor:
        return torch.sign(self.decision_function(A_test))


class KernelRidge(_Estimator):
    """Kernel ridge regression solved by (s-step) Block Dual Coordinate
    Descent.  ``predict`` serves batched and slab-free through the fitted
    operator."""

    problem = "krr"

    def __init__(self, lam: float = 1.0,
                 kernel: Union[str, KernelConfig, None] = None,
                 options: Optional[SolverOptions] = None,
                 predict_batch: int = 1024, device=None):
        _check_positive(lam, "lam")
        super().__init__(KRRConfig(lam=lam, kernel=_as_kernel(kernel)),
                         options, predict_batch, device)

    def predict(self, A_test) -> torch.Tensor:
        A_test = self._queries(A_test)
        if self._predictor is None:
            self._predictor = BatchedPredictor(
                self.op_, self.alpha_, batch=self.predict_batch,
                scale=1.0 / self.cfg.lam)
        return self._predictor(A_test)
