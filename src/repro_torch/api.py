"""Estimator facade — the counterpart of ``repro/api.py`` for the serial,
exact-kernel solve:

    from repro_torch.api import KernelSVM, SolverOptions

    clf = KernelSVM(C=1.0, kernel="rbf",
                    options=SolverOptions(method="sstep", s=32,
                                          tol=1e-6, max_iters=2048))
    result = clf.fit(A, y)          # FitResult: alpha, history, schedule
    labels = clf.predict(A_test)

``fit`` builds the kernel representation once — ``ExactGramOperator``
(the KMV and gram kernels on the card), ``StreamingGramOperator`` for
``SolverOptions(stream=k)`` (A chunked in pinned host memory, never on
the card whole, streamed through the ``kmv_stream`` pipeline) or
``LowRankGramOperator`` for ``approx="nystrom"`` (the solvers then run
the linear kernel over the Nystrom factor Phi) — drives the s-step or
classical round function through
``core.loop.run_rounds`` — the plain loop when no tolerance or recording
is asked for, the checked loop otherwise; on the card its rounds replay
as captured CUDA graphs, the counterpart of the JAX fit's ``jit``,
unless the operator is not ``capturable`` (the streamed one, whose
rounds stay eager) — and keeps the operator for prediction, which runs
batched and slab-free through ``core.predict``.
K-SVM stops on the duality gap, K-RR on the relative residual; both are
one full KMV per check, read through the operator's ``full_matvec`` (for
a streamed fit the streamed pipe, since A is not on the card; for a
low-rank fit the gap is the O(m l) factored one).

Estimators run on the CUDA card unless constructed with
``device="cpu"``; without a card and without that argument they raise.
``fit(..., schedule=...)`` replays a given coordinate schedule (for
example the ``FitResult.schedule`` of a JAX fit) instead of drawing one.

Knobs left at ``"auto"`` (``SolverOptions(s="auto", b="auto",
approx="auto", stream="auto")``) resolve through the autotuner
(``tune.autotune.resolve_options``, priced by ``core.perf_model`` within
the device's ``DeviceBudget``, refined by ``probe`` measured rounds)
before the solve; the plan lands on ``FitResult.plan``.  Every fit
carries ``FitResult.comm``, the Hockney model of its run.  ``fit_path``
solves a warm-started regularisation ladder (``tune.reg_path``); whole
grids solve as one fleet (``tune.solve_fleet``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import (LANDMARK_METHODS, NO_TOL, BatchedPredictor,
                              ExactGramOperator, KernelConfig, KRRConfig,
                              StreamingGramOperator, SVMConfig, as_schedule,
                              block_schedule, coordinate_schedule,
                              fit_nystrom, krr_rel_residual,
                              krr_rel_residual_op, ksvm_duality_gap_op,
                              landmark_generator, lowrank_operator,
                              make_bdcd_round_fn, make_dcd_round_fn,
                              make_sstep_bdcd_round_fn,
                              make_sstep_dcd_round_fn, pad_rounds,
                              run_rounds, validate_queries)
from repro_torch.core.perf_model import modeled_fit_cost
from repro_torch.device import as_tensor, resolve_device
from repro_torch.kernels.ops import make_solver_gram_fn

METHODS = ("classical", "sstep")
APPROX = (None, "nystrom")
AUTO = "auto"

# Knobs of the JAX SolverOptions that this slice of the port does not
# run yet: their JAX defaults, and the ROADMAP item that ports each
# (``layout="auto"`` runs: it resolves to "serial").
UNPORTED = {
    "layout": ("serial", "A11"),
    "mesh": (None, "A11"),
    "guard": (False, "A7"),
    "recompute_every": (AUTO, "A7"),
    "checkpoint_every": (0, "A7"),
    "checkpoint_dir": (None, "A7"),
    "fallback": (True, "A7"),
    "telemetry": (None, "A10"),
}


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """How to run the solve.

    method:      "classical" or "sstep" (same iterates, one kernel round
                 per s iterations).
    s:           s-step depth (ignored for method="classical"), or "auto":
                 resolved by the autotuner (``tune.autotune``) before the
                 solve; the plan lands on ``FitResult.plan``.
    b:           block size (K-RR only; K-SVM is scalar-coordinate), or
                 "auto" (tuned with s).
    layout:      "serial", or "auto" (resolves to "serial": the 1d and 2d
                 layouts are ROADMAP A11).
    slab_free:   read the kernel through the operator (default); False
                 forces the materialized-slab parity-oracle path.
    tol:         stop once the convergence metric (duality gap for K-SVM,
                 relative residual for K-RR) falls to tol; 0 disables it.
    check_every: metric cadence, in outer rounds.
    max_iters:   total inner-iteration budget H (H % s != 0 is fine).
    record:      keep the metric history even when tol == 0.
    seed:        seed of the schedule's ``torch.Generator`` (and, on its
                 own stream, of the landmark draw).
    approx:      None (exact kernel) or "nystrom": the solvers run the
                 linear kernel over the factor Phi of ``landmarks``
                 landmark rows chosen by ``landmark_method`` ("uniform"
                 or "kmeans"); or "auto" (the autotuner picks the cheaper
                 modeled representation).
    probe:       autotune refinement: when > 0 and a knob is "auto", the
                 top modeled candidates each run ``probe`` outer rounds
                 and the fastest measured one wins (on the card the
                 device time of the replayed rounds, capture excluded).
    stream:      None, or a positive int: A stays in pinned host memory
                 in chunks of that many rows and every kernel reduction
                 streams it through the ``kmv_stream`` pipeline; "auto"
                 (or True) resolves the chunk size from the streaming
                 cost model within the device's budget and measured link
                 (``perf_model.choose_chunk_rows``).  Needs slab_free,
                 the exact representation and the serial layout.

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
            if name == "layout" and value == AUTO:
                continue
            if value is not default and value != default:
                raise ValueError(
                    f"{name}={value!r} is not ported to repro_torch yet "
                    f"(ROADMAP {item}); only {name}={default!r} runs")
        self._check_representation()
        if self.method not in METHODS:
            raise ValueError(
                f"method must be one of {METHODS}, got {self.method!r}")
        for name in ("s", "b"):
            v = getattr(self, name)
            if v != AUTO and (not isinstance(v, int) or isinstance(v, bool)
                              or v < 1):
                raise ValueError(f"{name} must be a positive int or "
                                 f"{AUTO!r}, got {v!r}")
        for name in ("max_iters", "check_every"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        if not isinstance(self.probe, int) or isinstance(self.probe, bool) \
                or self.probe < 0:
            raise ValueError(f"probe must be an int >= 0, got "
                             f"{self.probe!r}")
        if not self.tol >= 0.0:
            raise ValueError(f"tol must be >= 0, got {self.tol!r}")

    def _check_representation(self):
        """The ``stream`` / ``approx`` knobs, under the JAX package's
        rules (``stream=True`` means "auto", ``stream=False`` None)."""
        if self.stream is True:
            object.__setattr__(self, "stream", AUTO)
        elif self.stream is False:
            object.__setattr__(self, "stream", None)
        if self.stream is not None:
            if self.stream != AUTO and (
                    not isinstance(self.stream, int) or self.stream < 1):
                raise ValueError(f"stream must be None, a positive int "
                                 f"chunk size, or {AUTO!r}, got "
                                 f"{self.stream!r}")
            if not self.slab_free:
                raise ValueError("stream= requires slab_free=True: the "
                                 "streamed representation only exists "
                                 "behind the GramOperator interface")
            if self.approx not in (None, AUTO):
                raise ValueError("stream= requires the exact "
                                 "representation (a low-rank factor is "
                                 "already O(m*l)-small — stream and "
                                 "approx are mutually exclusive)")
        if self.approx not in APPROX + (AUTO,):
            raise ValueError(f"approx must be one of {APPROX + (AUTO,)}, "
                             f"got {self.approx!r}")
        if not isinstance(self.landmarks, int) or \
                isinstance(self.landmarks, bool) or self.landmarks < 1:
            raise ValueError(f"landmarks must be a positive int, got "
                             f"{self.landmarks!r}")
        if self.landmark_method not in LANDMARK_METHODS:
            raise ValueError(f"landmark_method must be one of "
                             f"{LANDMARK_METHODS}, got "
                             f"{self.landmark_method!r}")

    @property
    def needs_autotune(self) -> bool:
        """Any knob left at "auto": ``fit`` resolves them through
        ``tune.autotune.resolve_options`` before solving."""
        return AUTO in (self.s, self.b, self.layout, self.approx,
                        self.stream)

    @property
    def s_eff(self) -> int:
        """Inner iterations per kernel round (1 for classical)."""
        if self.method != "sstep":
            return 1
        if self.s == AUTO:
            raise ValueError('s="auto" is unresolved — fit() resolves it '
                             'via tune.autotune.resolve_options before '
                             'solving')
        return self.s


@dataclasses.dataclass
class FitResult:
    """What ``fit`` observed: the solution, its trajectory and the
    modeled cost of the run."""

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
    comm: dict                     # Hockney model: flops/words/msgs/time
                                   # (perf_model.modeled_fit_cost)
    options: SolverOptions         # the RESOLVED options the solve ran
                                   # with (auto knobs already concrete)
    representation: str = "exact"  # "exact" | "nystrom(l=...)"
    plan: Optional[object] = None  # tune.TunedPlan when a knob was "auto"

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


def _build_representation(A: torch.Tensor, cfg, opts: SolverOptions,
                          device: torch.device, *, landmarks=None):
    """The once-per-fit representation build: ``(op, A_solve)``, where
    ``op`` is the operator the estimator keeps for prediction and
    ``A_solve`` the data the solvers run on — A for the exact and
    streamed representations (for a streamed fit A is the host tensor,
    whose shape is all the solvers read), Phi for Nystrom.  The landmark
    draw uses its own stream of ``opts.seed``; ``landmarks`` replays a
    given landmark set instead."""
    if opts.stream == AUTO or opts.approx == AUTO:
        raise ValueError("an 'auto' representation is unresolved — fit() "
                         "resolves it via tune.autotune.resolve_options "
                         "before building the representation")
    if opts.approx is None:
        if opts.stream is not None:
            return (StreamingGramOperator.from_dense(
                A, cfg.kernel, opts.stream, device=device), A)
        return ExactGramOperator(A, cfg.kernel), A
    l = min(opts.landmarks, A.shape[0])
    if landmarks is not None:
        landmarks = _check_finite(landmarks, "landmarks", device)
        if landmarks.ndim != 2 or landmarks.shape[1] != A.shape[1]:
            raise ValueError(f"landmarks must have shape (l, {A.shape[1]}),"
                             f" got {tuple(landmarks.shape)}")
    fmap = fit_nystrom(landmark_generator(opts.seed), A, cfg.kernel, l,
                       method=opts.landmark_method, landmarks=landmarks)
    op = lowrank_operator(fmap, A)
    return op, op.Phi


def _solve_cfg(cfg, opts: SolverOptions):
    """The config the solvers and metrics run on: ``cfg`` for the exact
    and streamed representations, the linear-kernel replacement over
    Phi for Nystrom (the factor already carries the nonlinearity)."""
    if opts.approx is None:
        return cfg
    return dataclasses.replace(cfg, kernel=KernelConfig("linear"))


def _metric_fn(problem: str, op, A_s, y, cfg, opts: SolverOptions):
    """The tolerance metric, read through the operator's ``full_matvec``
    (one full KMV: the resident kernel, the streamed pipe, or the O(m l)
    factored product).  The JAX facade evaluates it on the resident data
    instead: the same values by another route (ROADMAP C0).  The one
    exception is the Nystrom K-RR residual, a linear KMV over Phi, as in
    the JAX package."""
    if problem == "ksvm":
        return lambda a: ksvm_duality_gap_op(op, y, a, cfg)
    if opts.approx is not None:
        return lambda a: krr_rel_residual(A_s, y, a, _solve_cfg(cfg, opts))
    return lambda a: krr_rel_residual_op(op, y, a, cfg)


def _round_fn(problem: str, A_s, y, cfg_s, s: int, gram_fn, train_op,
              param=None):
    """The solver's round: classical at s = 1, s-step above; ``param``
    (an (F,) tensor of C or lambda values) makes it a fleet's."""
    if problem == "ksvm":
        if s == 1:
            return make_dcd_round_fn(A_s, y, cfg_s, gram_fn=gram_fn,
                                     op=train_op, C=param)
        return make_sstep_dcd_round_fn(A_s, y, cfg_s, s, gram_fn=gram_fn,
                                       op=train_op, C=param)
    if s == 1:
        return make_bdcd_round_fn(A_s, y, cfg_s, gram_fn=gram_fn,
                                  op=train_op, lam=param)
    return make_sstep_bdcd_round_fn(A_s, y, cfg_s, s, gram_fn=gram_fn,
                                    op=train_op, lam=param)


def _schedule(problem: str, opts: SolverOptions, m: int, b: int,
              device: torch.device, schedule=None) -> torch.Tensor:
    """The coordinate schedule: ``schedule`` replayed (validated), or
    ``max_iters`` draws from ``opts.seed``."""
    if schedule is not None:
        return _check_schedule(schedule, problem, m, b, device)
    gen = torch.Generator().manual_seed(opts.seed)
    if problem == "ksvm":
        return coordinate_schedule(gen, opts.max_iters, m, device)
    return block_schedule(gen, opts.max_iters, m, b, device)


def _comm(m: int, n: int, cfg, problem: str, opts: SolverOptions, op,
          iters: int) -> dict:
    """``FitResult.comm``: the Hockney model of the run, serial (P = 1),
    as the JAX facade prices it."""
    return modeled_fit_cost(
        m, n, cfg.kernel.name, b=opts.b if problem == "krr" else 1,
        s=opts.s_eff, iters=iters, P=1, approx=opts.approx,
        landmarks=op.rank if opts.approx is not None else 0)


def _fit(problem: str, A: torch.Tensor, y: torch.Tensor, cfg,
         opts: SolverOptions, device: torch.device, *, a0=None,
         schedule=None, landmarks=None, rep=None, stats=None):
    """One serial solve on ``device``; returns ``(FitResult, operator)``.
    A is on ``device``, or on the host for a streamed fit.  "auto" knobs
    resolve first (``tune.autotune.resolve_options`` within the device's
    own budget).  ``rep`` injects a prebuilt
    ``(operator, A_solve)`` (a warm-started ladder builds one for all its
    rungs); ``stats`` receives the captured rounds' timing
    (``core.loop.RoundGraphs.stats``)."""
    m, n = A.shape
    plan = None
    if opts.needs_autotune:
        from repro_torch.tune.autotune import resolve_options
        plan = resolve_options(m, n, cfg, opts, problem=problem, A=A, y=y,
                               device=device)
        opts = plan.options
    s = opts.s_eff
    b = opts.b if problem == "krr" else 1
    t0 = time.perf_counter()
    op, A_s = rep if rep is not None else _build_representation(
        A, cfg, opts, device, landmarks=landmarks)
    cfg_s = _solve_cfg(cfg, opts)
    m = op.n_samples
    schedule = _schedule(problem, opts, m, b, device, schedule)
    H = schedule.shape[0]
    if a0 is None:
        a0 = torch.zeros(m, dtype=A.dtype, device=device)
    else:
        a0 = as_tensor(a0).to(device=device, dtype=A.dtype)
        if a0.shape != (m,):
            raise ValueError(f"warm_start must have shape ({m},), got "
                             f"{tuple(a0.shape)}")

    gram_fn = None if opts.slab_free else make_solver_gram_fn()
    train_op = None
    if opts.slab_free:
        # K-SVM trains on diag(y) A (diag(y) Phi); prediction keeps the
        # unscaled op
        train_op = op.scale_rows(y) if problem == "ksvm" else op
    rf = _round_fn(problem, A_s, y, cfg_s, s, gram_fn, train_op)
    metric_name = "duality_gap" if problem == "ksvm" else "rel_residual"
    metric_fn = _metric_fn(problem, op, A_s, y, cfg, opts)
    xs = schedule if s == 1 else pad_rounds(schedule, s)
    want_metric = opts.tol > 0.0 or opts.record
    # captured CUDA graphs where the operator allows, else eager rounds
    res = run_rounds(rf, a0, xs,
                     tol=opts.tol if opts.tol > 0.0 else NO_TOL,
                     check_every=opts.check_every,
                     metric_fn=metric_fn if want_metric else None,
                     capture=op.capturable, stats=stats)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    iters_run = min(res.rounds_run * s, H)
    history = (res.metric_history().double().cpu().numpy()
               if want_metric else None)
    rep_name = (f"nystrom(l={op.rank})" if opts.approx is not None
                else "exact")
    result = FitResult(alpha=res.state, schedule=schedule[:iters_run],
                       history=history, metric=metric_name,
                       converged=res.converged, rounds_run=res.rounds_run,
                       iters_run=iters_run, wall_time_s=wall,
                       comm=_comm(m, n, cfg, problem, opts, op, iters_run),
                       options=opts, representation=rep_name, plan=plan)
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

    def fit(self, A, y, warm_start=None, schedule=None,
            landmarks=None) -> FitResult:
        """Solve the dual.  ``warm_start`` seeds alpha (shape (m,));
        ``schedule`` replays a given coordinate schedule ((H,) for K-SVM,
        (H, b) for K-RR) instead of drawing one from ``options.seed``;
        ``landmarks`` (l, n) replays a Nystrom landmark set instead of
        drawing one.  A streamed fit validates and chunks A on the host:
        A never goes to the card."""
        if landmarks is not None and self.options.approx is None:
            raise ValueError("landmarks= replays a Nystrom landmark set: "
                             "it needs options.approx='nystrom'")
        A = _check_finite(A, "A", self._data_device)
        y = _check_finite(y, "y", self.device)
        result, op = _fit(self.problem, A, y, self.cfg, self.options,
                          self.device, a0=warm_start, schedule=schedule,
                          landmarks=landmarks)
        self._adopt(A, y, result.alpha, op, result)
        return result

    def fit_path(self, A, y, values, schedule=None, landmarks=None):
        """Warm-started solve ladder over a grid of this estimator's
        regulariser (``tune.path.reg_path``): one representation build,
        each solve seeded from its neighbour's solution; ``schedule`` and
        ``landmarks`` replay as in ``fit``, for every rung.  Returns a
        ``PathResult``; the estimator is left fitted at the ladder's last
        (least regularised) member."""
        from repro_torch.tune.path import reg_path
        A = _check_finite(A, "A", self._data_device)
        y = _check_finite(y, "y", self.device)
        grid = {"lams" if self.problem == "krr" else "Cs": values}
        path = reg_path(A, y, cfg=self.cfg, options=self.options,
                        schedule=schedule, landmarks=landmarks,
                        device=self.device, **grid)
        last = path.results[-1]
        self.cfg = dataclasses.replace(
            self.cfg, **{path.param: float(path.values[-1])})
        self._adopt(A, y, last.alpha, path.op, last)
        return path

    @property
    def _data_device(self) -> torch.device:
        """Where A is kept: the host for a streamed estimator."""
        return (torch.device("cpu") if self.options.stream is not None
                else self.device)

    def _adopt(self, A, y, alpha, op=None, result=None):
        """Install a fitted state (from ``fit`` or ``convert``): a
        streamed estimator keeps its streamed operator and A on the
        host, no device copy."""
        if op is None:
            if self.options.approx is not None:
                raise ValueError("a low-rank estimator needs its fitted "
                                 "operator (the feature map of its fit)")
            op = _build_representation(A, self.cfg, self.options,
                                       self.device)[0]
        self.A_, self.y_, self.alpha_ = A, y, alpha
        self.op_ = op
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
