"""Estimator facade — the counterpart of ``repro/api.py``:

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

``SolverOptions(guard=True)`` runs a guarded solve (``resilience``): the
rounds carry the residual ``f = K alpha`` (a round's KMV becomes the
``apply_at`` of its update), check the carry every round, replace the
residual exactly every ``recompute_every`` rounds (``"auto"``: the
performance model's cadence), and on divergence walk the fallback
ladder (halve s, then classical, then f64 arithmetic on the card's f64
kernel route) from the last good state; ``checkpoint_every`` /
``checkpoint_dir`` cut mid-solve snapshots that ``fit(resume_from=)``
continues.  ``FitResult.health`` records what the guard saw.

``SolverOptions(layout="1d" | "2d")`` runs the paper's distributed
layouts (``core.distributed``) SPMD, one process a rank, every rank
calling the same ``fit`` on the same data over ``options.mesh`` (by
default the initialised default process group, ``launch.mesh``): the
whole schedule in one solver call, or on the tolerance path chunks of
``check_every`` rounds, each followed by rank 0's metric sent to every
rank; a guarded distributed fit checks and falls back at those chunk
boundaries.  The rounds run eagerly (a reduction cannot be captured).

``SolverOptions(telemetry=True)`` (or a ``repro_torch.obs.Telemetry``)
records the fit: host spans around the fit, the representation build and
the solve (each span over device work ends by draining the fit's
stream), and marks around each tolerance check and guarded correction
(on the card the device times of their own captured graphs,
``core.loop``); the handle lands on ``FitResult.telemetry`` for
``obs.audit_fit`` and the trace exporter.  Without it the fit runs as it
would with no telemetry code at all.  ``est.save(directory)`` writes a
serving artifact (``repro_torch.serve``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import (DIVERGED_NONFINITE, LANDMARK_METHODS, NO_TOL,
                              BatchedPredictor, GuardSpec,
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
from repro_torch.core import distributed
from repro_torch.core.perf_model import (choose_recompute_every,
                                         modeled_fit_cost)
from repro_torch.device import as_tensor, resolve_device
from repro_torch.kernels.ops import make_solver_gram_fn
from repro_torch.launch.mesh import make_mesh, world_size
from repro_torch.obs.spans import Telemetry
from repro_torch.resilience import (DivergenceError, HealthEvent,
                                    SimulatedKill, SolveHealth, active_plan,
                                    finite_health, init_residual,
                                    load_solve_state, make_correct_fn,
                                    next_fallback, save_solve_state,
                                    solve_fingerprint)
from repro_torch.resilience.health import (KIND_METRIC, KIND_NONFINITE,
                                           KIND_RESUME)

METHODS = ("classical", "sstep")
LAYOUTS = ("serial", "1d", "2d")
APPROX = (None, "nystrom")
AUTO = "auto"


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
    layout:      "serial"; "1d" (the paper's 1D-column layout: A's features
                 sharded over the mesh's ``model`` axis, one all-reduce a
                 round); "2d" (samples over ``data`` too, three smaller
                 collectives a round); or "auto" (the autotuner picks among
                 the layouts the world size allows).  The distributed
                 layouts run SPMD: every rank calls the same fit on the same
                 data (``launch.mesh``).
    mesh:        a ``launch.mesh.Mesh`` for the 1d / 2d layouts, or None:
                 (1, world) for 1d and (world, 1) for 2d over the
                 initialised default process group, (1, 1) without one.
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
    guard:       guarded solve (module docstring): the rounds carry the
                 residual ``f = K alpha``, check the carry every round,
                 correct the residual's drift, and on divergence fall back
                 (halve s, classical, f64) from the last good state;
                 ``FitResult.health`` records it.  Needs slab_free.
    recompute_every: drift-correction cadence in outer rounds (an exact
                 ``f = K alpha``, one full KMV); "auto" takes the
                 performance model's cadence within its 10% overhead
                 budget; 0 turns correction off.
    checkpoint_every: mid-solve snapshot cadence in outer rounds (0 =
                 off); needs ``checkpoint_dir`` and ``guard``.
    checkpoint_dir: where snapshots go (``train/checkpoint.py``'s atomic
                 step directories).
    fallback:    walk the ladder on divergence (default); False raises
                 ``DivergenceError`` at once.
    telemetry:   a ``repro_torch.obs.Telemetry`` handle, or True for a
                 fresh one: spans around the fit's phases and marks around
                 its checks and corrections (module docstring), on
                 ``FitResult.telemetry``.  None, False or a disabled
                 handle records nothing and changes nothing.
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
    telemetry: Union[None, bool, Telemetry] = None

    def __post_init__(self):
        # True is a fresh handle, False is off, as in the JAX package
        if self.telemetry is True:
            object.__setattr__(self, "telemetry", Telemetry())
        elif self.telemetry is False:
            object.__setattr__(self, "telemetry", None)
        if self.telemetry is not None and \
                not isinstance(self.telemetry, Telemetry):
            raise ValueError(f"telemetry must be None, a bool, or a "
                             f"repro_torch.obs.Telemetry, got "
                             f"{self.telemetry!r}")
        self._check_representation()
        if self.method not in METHODS:
            raise ValueError(
                f"method must be one of {METHODS}, got {self.method!r}")
        if self.layout not in LAYOUTS + (AUTO,):
            raise ValueError(f"layout must be one of "
                             f"{LAYOUTS + (AUTO,)}, got {self.layout!r}")
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
        if not self.slab_free and self.layout == "2d":
            raise ValueError("the 2d layout is slab-free by construction; "
                             "slab_free=False is only meaningful for the "
                             "serial and 1d layouts")
        self._check_guard()

    def _check_guard(self):
        """The guard's knobs, under the JAX package's rules."""
        if self.recompute_every != AUTO and (
                not isinstance(self.recompute_every, int)
                or isinstance(self.recompute_every, bool)
                or self.recompute_every < 0):
            raise ValueError(f"recompute_every must be an int >= 0 or "
                             f"{AUTO!r}, got {self.recompute_every!r}")
        if not isinstance(self.checkpoint_every, int) \
                or isinstance(self.checkpoint_every, bool) \
                or self.checkpoint_every < 0:
            raise ValueError(f"checkpoint_every must be an int >= 0, "
                             f"got {self.checkpoint_every!r}")
        if self.guard and not self.slab_free:
            raise ValueError("guard=True requires slab_free=True: the "
                             "guarded round protocol reads the kernel "
                             "through the GramOperator (the "
                             "materialized-slab oracle has no residual "
                             "recurrence to guard)")
        if self.checkpoint_every > 0 and self.checkpoint_dir is None:
            raise ValueError("checkpoint_every > 0 requires "
                             "checkpoint_dir=")
        if self.checkpoint_every > 0 and not self.guard:
            raise ValueError("checkpoint_every > 0 requires guard=True "
                             "(snapshots are cut at the guarded "
                             "executor's segment boundaries)")

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
            if self.layout not in ("serial", AUTO):
                raise ValueError(f"stream= requires the serial layout "
                                 f"(the distributed layouts shard the "
                                 f"data instead of streaming it), got "
                                 f"layout={self.layout!r}")
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


# repro: noqa[CHK-TREE] a host-side result record handed to the caller; no
#   tree function walks it
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
    health: Optional[SolveHealth] = None
                                   # guarded fits: drift, divergence and
                                   # fallback events, checkpoints, resume
    telemetry: Optional[Telemetry] = None
                                   # the handle the fit recorded into
                                   # (SolverOptions(telemetry=))

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


def _active_tel(opts: SolverOptions) -> Optional[Telemetry]:
    """The enabled telemetry handle of a fit, or None (a disabled handle
    maps to None, so the fit runs uninstrumented)."""
    t = opts.telemetry
    return t if (t is not None and t.enabled) else None


@contextlib.contextmanager
def _tspan(tel: Optional[Telemetry], name: str, phase: str,
           device: torch.device, **args):
    """``tel.span(...)`` that drains ``device`` before it closes, so it
    covers the work queued inside it; nothing when telemetry is off."""
    if tel is None:
        yield
        return
    with tel.span(name, phase, **args):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


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
              param=None, guard: bool = False):
    """The solver's round: classical at s = 1, s-step above; ``param``
    (an (F,) tensor of C or lambda values) makes it a fleet's, ``guard``
    the guarded carry's."""
    kw = dict(gram_fn=gram_fn, op=train_op, guard=guard)
    if problem == "ksvm":
        if s == 1:
            return make_dcd_round_fn(A_s, y, cfg_s, C=param, **kw)
        return make_sstep_dcd_round_fn(A_s, y, cfg_s, s, C=param, **kw)
    if s == 1:
        return make_bdcd_round_fn(A_s, y, cfg_s, lam=param, **kw)
    return make_sstep_bdcd_round_fn(A_s, y, cfg_s, s, lam=param, **kw)


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
          iters: int, P: int = 1) -> dict:
    """``FitResult.comm``: the Hockney model of the run at the layout's P
    ranks (1 for the serial layout), as the JAX facade prices it."""
    return modeled_fit_cost(
        m, n, cfg.kernel.name, b=opts.b if problem == "krr" else 1,
        s=opts.s_eff, iters=iters, P=P, approx=opts.approx,
        landmarks=op.rank if opts.approx is not None else 0)


def _resolve_mesh(opts: SolverOptions):
    """The 1d / 2d layouts' mesh: the user's (validated for the layout's
    axis names), or (1, world) for 1d and (world, 1) for 2d over the
    initialised default process group ((1, 1) without one)."""
    if opts.mesh is None:
        w = world_size()
        return make_mesh(*((1, w) if opts.layout == "1d" else (w, 1)))
    need = ("model",) if opts.layout == "1d" else ("data", "model")
    names = tuple(getattr(opts.mesh, "axis_names", ()))
    missing = [ax for ax in need if ax not in names]
    if missing:
        raise ValueError(f"mesh lacks axes {missing} required by the "
                         f"{opts.layout!r} layout (has {names})")
    return opts.mesh


def _from_rank0(mesh, fn, width: int, device) -> np.ndarray:
    """``fn()`` as rank 0 computes it, ``width`` float64 values, on every
    rank (one ``check`` collective, ``Mesh.root_value``): a metric or a
    guard's verdict read on the full data, so every rank takes the same
    branch.  The JAX package's one controller needs no such step
    (ROADMAP C16)."""
    t = torch.zeros(width, dtype=torch.float64, device=device)
    if mesh.rank == 0:
        t = torch.as_tensor(fn(), dtype=torch.float64,
                            device=device).reshape(width)
    return mesh.root_value(t).cpu().numpy()


def _dist_chunks(solve, alpha, schedule, s: int, opts: SolverOptions, mesh,
                 metric_fn, tel=None):
    """The 1d / 2d tolerance loop, shared by the fit and the 1d fleet:
    chunks of ``check_every`` rounds (whole multiples of s, so the rounds
    are those of the unchunked run), each ``solve(alpha, sched_c)`` in a
    ``dist_chunk`` span and followed by rank 0's metric (``_from_rank0``).
    A fleet's alpha is (F, m) and its metric (F,): members that met the
    tolerance keep their alpha while the others run on.  Returns
    ``(alpha, history, done, rounds_run, iters_run)``, ``done`` (F,) bool
    ((1,) for a fit)."""
    H = schedule.shape[0]
    chunk = opts.check_every * s
    fleet = alpha.ndim == 2
    done = np.zeros(alpha.shape[0] if fleet else 1, bool)
    pos = rounds_run = 0
    hist = []
    while pos < H:
        sched_c = schedule[pos:pos + chunk]
        iters = int(sched_c.shape[0])
        with _tspan(tel, "dist_chunk", "solve", alpha.device, iter_start=pos,
                    iters=iters, s=s, layout=opts.layout):
            new = solve(alpha, sched_c)
            alpha = (torch.where(torch.as_tensor(done, device=new.device)[
                :, None], alpha, new) if fleet else new)
            pos += iters
            rounds_run += -(-iters // s)
            # the metric read is the chunk's sync point
            vals = _from_rank0(mesh, lambda: metric_fn(alpha), done.size,
                               alpha.device)
        hist.append(vals if fleet else vals[0])
        if opts.tol > 0.0:
            done |= vals <= opts.tol
            if done.all():
                break
    return alpha, np.asarray(hist), done, rounds_run, pos


def _guard_cadence(problem: str, m: int, n: int, cfg, opts: SolverOptions,
                   s: int, b: int, approx) -> int:
    """``recompute_every="auto"``: the performance model's cadence for a
    serial fit at (s, b) (``perf_model.choose_recompute_every``)."""
    return choose_recompute_every(
        m, n, cfg.kernel.name, b=b if problem == "krr" else 1, s=s,
        approx=bool(approx),
        landmarks=min(opts.landmarks, m) if approx else 0)


def _fit(problem: str, A: torch.Tensor, y: torch.Tensor, cfg,
         opts: SolverOptions, device: torch.device, **kw):
    """``_fit_body`` inside the fit's telemetry, when it has an enabled
    handle: the handle is activated (the target of the round driver's
    marks) and the whole call is one phase="fit" span, the window
    ``obs.audit`` reconciles against the model; its device marks are
    read before it returns."""
    tel = _active_tel(opts)
    if tel is None:
        return _fit_body(problem, A, y, cfg, opts, device, **kw)
    with tel.activate(), tel.span("fit", phase="fit", problem=problem,
                                  m=int(A.shape[0]), n=int(A.shape[1])):
        out = _fit_body(problem, A, y, cfg, opts, device, **kw)
    tel.sync()
    return out


def _fit_body(problem: str, A: torch.Tensor, y: torch.Tensor, cfg,
              opts: SolverOptions, device: torch.device, *, a0=None,
              schedule=None, landmarks=None, rep=None, stats=None,
              resume_from=None):
    """One serial solve on ``device``; returns ``(FitResult, operator)``.
    A is on ``device``, or on the host for a streamed fit.  "auto" knobs
    resolve first (``tune.autotune.resolve_options`` within the device's
    own budget).  ``rep`` injects a prebuilt
    ``(operator, A_solve)`` (a warm-started ladder builds one for all its
    rungs); ``stats`` receives the captured rounds' timing
    (``core.loop.RoundGraphs.stats``); ``resume_from`` continues a
    guarded fit's checkpoint directory."""
    m, n = A.shape
    plan = None
    if opts.needs_autotune:
        from repro_torch.tune.autotune import resolve_options
        plan = resolve_options(m, n, cfg, opts, problem=problem, A=A, y=y,
                               device=device)
        opts = plan.options
    if opts.guard and opts.recompute_every == AUTO:
        # the backstop behind the autotuner's own resolution; the
        # distributed rounds recompute from alpha every round, so they
        # have no drifting residual to correct
        opts = dataclasses.replace(opts, recompute_every=_guard_cadence(
            problem, m, n, cfg, opts, opts.s_eff, opts.b, opts.approx)
            if opts.layout == "serial" else 0)
    if resume_from is not None and not opts.guard:
        raise ValueError("resume_from= requires options.guard=True (the "
                         "checkpoint holds a guarded-carry snapshot)")
    s = opts.s_eff
    b = opts.b if problem == "krr" else 1
    tel = _active_tel(opts)
    t0 = time.perf_counter()
    if rep is None:
        with _tspan(tel, "representation_build", "setup", device,
                    approx=bool(opts.approx)):
            rep = _build_representation(A, cfg, opts, device,
                                        landmarks=landmarks)
    op, A_s = rep
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

    metric_name = "duality_gap" if problem == "ksvm" else "rel_residual"
    want_metric = opts.tol > 0.0 or opts.record
    health = None
    fp = resume = None
    if opts.guard:
        fp = solve_fingerprint(problem, A.shape[0], A.dtype, cfg, opts,
                               schedule)
        if resume_from is not None:
            r_alpha, r_f, extra = load_solve_state(resume_from,
                                                   expect_fingerprint=fp)
            resume = {"alpha": r_alpha, "f": r_f,
                      "iters_done": int(extra["iters_done"]),
                      "s_cur": int(extra["s_cur"]),
                      "method_cur": extra["method_cur"],
                      "path": resume_from}
    P = 1
    if opts.layout != "serial":
        # every rank builds its own block from the solve matrix: for a
        # Nystrom fit A_s is Phi, so the 1d layout shards Phi's l columns
        # and its linear rounds reduce only the contracted (sb, sb+1) words
        mesh = _resolve_mesh(opts)
        P = mesh.shape["model"] if opts.layout == "1d" else mesh.size
        metric_fn = _metric_fn(problem, op, A_s, y, cfg, opts)
        if opts.guard:
            (alpha, history, converged, rounds_run, iters_run,
             health) = _run_guarded_dist(
                problem, op, A_s, y, a0, schedule, cfg, cfg_s, opts, mesh,
                fingerprint=fp, resume=resume, tel=tel)
        else:
            (alpha, history, converged, rounds_run,
             iters_run) = _run_dist(problem, A_s, y, a0, schedule, cfg_s,
                                    opts, mesh, metric_fn, tel)
    elif opts.guard:
        train_op = op.scale_rows(y) if problem == "ksvm" else op
        (alpha, history, converged, rounds_run, iters_run,
         health) = _run_guarded_serial(
            problem, op, train_op, A_s, y, a0, schedule, cfg, cfg_s, opts,
            fingerprint=fp, resume=resume, stats=stats, tel=tel)
    else:
        gram_fn = None if opts.slab_free else make_solver_gram_fn()
        train_op = None
        if opts.slab_free:
            # K-SVM trains on diag(y) A (diag(y) Phi); prediction keeps the
            # unscaled op
            train_op = op.scale_rows(y) if problem == "ksvm" else op
        rf = _round_fn(problem, A_s, y, cfg_s, s, gram_fn, train_op)
        metric_fn = _metric_fn(problem, op, A_s, y, cfg, opts)
        xs = schedule if s == 1 else pad_rounds(schedule, s)
        # captured CUDA graphs where the operator allows, else eager
        # rounds; the fast path has no sync point and carries no mark
        with _tspan(tel, "solve", "solve", device,
                    path="tol" if want_metric else "fast", s=s):
            res = run_rounds(rf, a0, xs,
                             tol=opts.tol if opts.tol > 0.0 else NO_TOL,
                             check_every=opts.check_every,
                             metric_fn=metric_fn if want_metric else None,
                             capture=op.capturable, stats=stats,
                             marks=tel is not None)
        alpha, converged, rounds_run = res.state, res.converged, \
            res.rounds_run
        iters_run = min(rounds_run * s, H)
        history = (res.metric_history().double().cpu().numpy()
                   if want_metric else None)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    rep_name = (f"nystrom(l={op.rank})" if opts.approx is not None
                else "exact")
    result = FitResult(alpha=alpha, schedule=schedule[:iters_run],
                       history=history, metric=metric_name,
                       converged=converged, rounds_run=rounds_run,
                       iters_run=iters_run, wall_time_s=wall,
                       comm=_comm(m, n, cfg, problem, opts, op, iters_run,
                                  P),
                       options=opts, representation=rep_name, plan=plan,
                       health=health, telemetry=tel)
    return result, op


def _run_dist(problem, A_s, y, a0, schedule, cfg_s, opts: SolverOptions,
              mesh, metric_fn, tel):
    """The 1d / 2d fit (the JAX facade's distributed branch) on one
    ``distributed.LayoutSolver``: one run over the whole schedule on the
    fast path, ``_dist_chunks`` on the tolerance path.  Returns ``(alpha,
    history, converged, rounds_run, iters_run)``."""
    s = opts.s_eff
    H = schedule.shape[0]
    solver = distributed.LayoutSolver(mesh, opts.layout, A_s, y, cfg_s,
                                      slab_free=opts.slab_free)
    if not (opts.tol > 0.0 or opts.record):
        with _tspan(tel, "solve", "solve", a0.device, path="dist_fast", s=s,
                    layout=opts.layout):
            alpha = solver.solve(a0, schedule, s)
        return alpha, None, False, -(-H // s), H
    alpha, hist, done, rounds_run, iters_run = _dist_chunks(
        lambda a, sched: solver.solve(a, sched, s), a0, schedule, s, opts,
        mesh, metric_fn, tel)
    return alpha, hist, bool(done[0]), rounds_run, iters_run


def _guarded_segment(problem, A_s, y, alpha, f, schedule, cfg_s, metric_fn,
                     opts: SolverOptions, train_op, s: int, fault,
                     stats=None, marks: bool = False):
    """One guarded segment: the guarded rounds of (problem, s) over the
    ``(alpha, f)`` carry from ``core.loop.run_rounds(guard=...)``.
    ``fault`` = (round, target, value) arms the fault lane: the round's
    update gets ``value`` added to the target leaf, through a per-round
    hit mask that rides the schedule and a device scalar, so captured
    rounds replay it with no host branch; None captures no lane."""
    base = _round_fn(problem, A_s, y, cfg_s, s, None, train_op, guard=True)
    xs = schedule if s == 1 else pad_rounds(schedule, s)
    rf = base
    if fault is not None:
        fault_round, target, value = fault
        single = isinstance(xs, torch.Tensor)
        R = (xs if single else xs[0]).shape[0]
        hits = torch.arange(R, device=alpha.device) == fault_round
        bad = torch.tensor(value, dtype=alpha.dtype, device=alpha.device)
        zero = torch.zeros((), dtype=alpha.dtype, device=alpha.device)

        def rf(carry, xz):
            a, fr = base(carry, xz[0] if single else xz[:-1])
            add = torch.where(xz[-1], bad, zero)
            return (a + add, fr) if target == "alpha" else (a, fr + add)

        xs = ((xs,) if single else tuple(xs)) + (hits,)
    guard = GuardSpec(
        health_fn=finite_health,
        correct_fn=(make_correct_fn(train_op) if opts.recompute_every >= 1
                    else None),
        correct_every=opts.recompute_every)
    want_metric = opts.tol > 0.0 or opts.record
    return run_rounds(rf, (alpha, f), xs,
                      tol=opts.tol if opts.tol > 0.0 else NO_TOL,
                      check_every=opts.check_every,
                      metric_fn=((lambda c: metric_fn(c[0])) if want_metric
                                 else None),
                      guard=guard, capture=train_op.capturable, stats=stats,
                      marks=marks)


def _run_guarded_serial(problem, op, train_op, A_s, y, a0, schedule, cfg,
                        cfg_s, opts: SolverOptions, *, fingerprint,
                        resume=None, stats=None, tel=None):
    """The host half of a guarded solve (the JAX package's
    ``_run_guarded_serial``): guarded segments bounded by the checkpoint
    cadence, the drift and metric histories harvested from each, and on
    divergence the fallback ladder (halve s, classical, f64) from the
    last good state, with an exact residual at every rung.  Returns
    ``(alpha, history, converged, rounds_run, iters_run, health)``."""
    from repro_torch.train.checkpoint import CheckpointManager

    H = schedule.shape[0]
    want_metric = opts.tol > 0.0 or opts.record
    base_dtype = a0.dtype
    s_cur, method_cur = opts.s_eff, opts.method
    x64 = False
    pos = rounds_done = 0
    converged = False
    alpha, f = a0, None
    events, drifts, hists = [], [], []
    checkpoints, resumed_from = 0, None
    if resume is not None:
        alpha = resume["alpha"].to(a0.device, base_dtype)
        if resume["f"] is not None:
            f = resume["f"].to(a0.device, base_dtype)
        pos = resume["iters_done"]
        s_cur, method_cur = resume["s_cur"], resume["method_cur"]
        resumed_from = resume["path"]
        events.append(HealthEvent(kind=KIND_RESUME, round_idx=rounds_done,
                                  iter_idx=pos, action="resume",
                                  detail=resumed_from))
    plan = active_plan()
    mgr = None
    if opts.checkpoint_every > 0:
        mgr = CheckpointManager(opts.checkpoint_dir, save_every=1)
    A_cur, y_cur, op_cur, train_cur = A_s, y, op, train_op
    if f is None:
        f = init_residual(train_cur, alpha)

    while pos < H and not converged:
        seg = (min(opts.checkpoint_every * s_cur, H - pos)
               if opts.checkpoint_every > 0 else H - pos)
        fault_round = (plan.carry_fault_round(pos, seg, s_cur)
                       if plan is not None else -1)
        fault = ((fault_round, plan.target, plan.value)
                 if fault_round >= 0 else None)
        metric_fn = _metric_fn(problem, op_cur, A_cur, y_cur, cfg, opts)
        with _tspan(tel, "guarded_segment", "solve", alpha.device,
                    iter_start=pos, iters=int(seg), s=s_cur):
            res = _guarded_segment(problem, A_cur, y_cur, alpha, f,
                                   schedule[pos:pos + seg], cfg_s,
                                   metric_fn, opts, train_cur, s_cur, fault,
                                   stats, marks=tel is not None)
        dh = res.drift_history()
        if dh is not None and len(dh):
            drifts.append(dh.double().cpu().numpy())
            if tel is not None:
                tel.metrics.counter(
                    "repro_guard_corrections_total",
                    "residual drift corrections applied").inc(len(dh))
        mh = res.metric_history()
        if mh is not None and len(mh):
            hists.append(mh.double().cpu().numpy())

        div = res.diverged_round
        if div >= 0:
            # the bad round's update was discarded: the carry is the last
            # good state, so the good prefix of the segment is consumed
            alpha, f = res.state
            pos += min(div * s_cur, seg)
            rounds_done += div
            kind = (KIND_NONFINITE if res.diverged_kind == DIVERGED_NONFINITE
                    else KIND_METRIC)
            if fault_round >= 0 and div >= fault_round:
                plan.carry_fired = True      # one-shot: do not fire again
            if not opts.fallback:
                raise DivergenceError(
                    f"guarded solve diverged ({kind}) at round "
                    f"{rounds_done} (iteration {pos}) and fallback is "
                    f"disabled", events=tuple(events))
            try:
                action, s_cur, method_cur, x64_new = next_fallback(
                    s_cur, method_cur, x64)
            except DivergenceError as e:
                raise DivergenceError(str(e),
                                      events=tuple(events)) from None
            events.append(HealthEvent(
                kind=kind, round_idx=rounds_done, iter_idx=pos,
                action=action,
                detail=f"resuming from last good state at iter {pos}"))
            if tel is not None:
                tel.metrics.counter(
                    "repro_guard_fallbacks_total",
                    "escalation-ladder steps taken").inc(
                        action=action, kind=kind)
                tel.mark("fallback", phase="guard")
            if x64_new and not x64:
                x64 = True
                # the rounds read A only for its shape, except the
                # Nystrom residual, which contracts Phi itself
                if opts.approx is not None:
                    A_cur = A_cur.double()
                y_cur = y_cur.double()
                op_cur = op_cur.astype(torch.float64)
                train_cur = train_cur.astype(torch.float64)
                alpha = alpha.double()
            # after any event the recurrence restarts from an exact
            # residual (the fault may have corrupted f alone)
            f = train_cur.full_matvec(alpha)
            continue

        alpha, f = res.state
        rounds_done += res.rounds_run
        if res.converged:
            converged = True
            pos += min(res.rounds_run * s_cur, seg)
        else:
            pos += seg
        if mgr is not None and not converged and pos < H:
            # the snapshot copies the carry to the host before returning
            save_solve_state(mgr, pos, alpha.to(base_dtype),
                             f.to(base_dtype), s_cur=s_cur,
                             method_cur=method_cur, fingerprint=fingerprint)
            checkpoints += 1
            if plan is not None and plan.should_kill(pos):
                plan.kill_fired = True
                mgr.wait()               # the snapshot is durable
                raise SimulatedKill(
                    f"simulated preemption at iteration {pos}",
                    opts.checkpoint_dir)
    if mgr is not None:
        mgr.wait()
    history = (np.concatenate(hists) if hists
               else (np.zeros(0) if want_metric else None))
    health = SolveHealth(
        guarded=True, recompute_every=opts.recompute_every,
        drift=np.concatenate(drifts) if drifts else np.zeros(0),
        corrections=sum(len(d) for d in drifts), events=tuple(events),
        checkpoints=checkpoints, resumed_from=resumed_from)
    return (alpha.to(base_dtype), history, converged, rounds_done, pos,
            health)


def _run_guarded_dist(problem, op, A_s, y, a0, schedule, cfg, cfg_s,
                      opts: SolverOptions, mesh, *, fingerprint,
                      resume=None, tel=None):
    """The guarded 1d / 2d fit (the JAX package's ``_run_guarded_dist``).
    The distributed rounds recompute their quantities from alpha every
    round, so there is no drifting residual to correct; the guard runs at
    chunk boundaries instead: rank 0 judges the chunk's alpha (finite,
    metric not blown up) and every rank takes its verdict
    (``_from_rank0``); an unhealthy chunk is re-run from its start state
    one rung down the fallback ladder (halve s, classical, f64).  One
    ``distributed.LayoutSolver`` serves every chunk (another for the f64
    rung).  Rank 0
    writes the checkpoints (every rank holds the same alpha); a simulated
    kill waits for the snapshot and for every rank before it raises.
    Returns ``(alpha, history, converged, rounds_run, iters_run,
    health)``."""
    from repro_torch.resilience.faults import poisoned_1d_factory
    from repro_torch.train.checkpoint import CheckpointManager

    H = schedule.shape[0]
    want_metric = opts.tol > 0.0 or opts.record
    base_dtype = a0.dtype
    blowup = 1e4
    s_cur, method_cur = opts.s_eff, opts.method
    x64 = False
    pos = rounds_done = 0
    converged = False
    alpha = a0
    events, hist = [], []
    checkpoints, resumed_from = 0, None
    best = float("inf")
    if resume is not None:
        alpha = resume["alpha"].to(a0.device, base_dtype)
        pos = resume["iters_done"]
        s_cur, method_cur = resume["s_cur"], resume["method_cur"]
        resumed_from = resume["path"]
        events.append(HealthEvent(kind=KIND_RESUME, round_idx=rounds_done,
                                  iter_idx=pos, action="resume",
                                  detail=resumed_from))
    plan = active_plan()
    mgr = None
    if opts.checkpoint_every > 0 and mesh.rank == 0:
        mgr = CheckpointManager(opts.checkpoint_dir, save_every=1)
    op_cur, A_cur, y_cur = op, A_s, y
    solver = distributed.LayoutSolver(mesh, opts.layout, A_s, y, cfg_s,
                                      slab_free=opts.slab_free)

    while pos < H and not converged:
        chunk = opts.check_every * s_cur
        if opts.checkpoint_every > 0:
            chunk = min(chunk, opts.checkpoint_every * s_cur)
        seg = min(chunk, H - pos)
        # the 1d fault harness: a poisoned operator scales one rank's
        # contribution to every reduction of the chunk holding the target
        # iteration (consumed once, as the serial fault lane)
        op_factory = None
        if (plan is not None and opts.layout == "1d"
                and plan.carry_fault_round(pos, seg, s_cur) >= 0):
            op_factory = poisoned_1d_factory(mesh, scale=plan.value)
        metric_fn = (_metric_fn(problem, op_cur, A_cur, y_cur, cfg,
                                opts) if want_metric else None)

        def verdict():
            ok = bool(torch.isfinite(alpha_new).all())
            return [float(ok), float(metric_fn(alpha_new))
                    if ok and metric_fn is not None else float("nan")]

        with _tspan(tel, "guarded_chunk", "solve", alpha.device,
                    iter_start=pos, iters=int(seg), s=s_cur,
                    layout=opts.layout):
            alpha_new = solver.solve(alpha, schedule[pos:pos + seg], s_cur,
                                     op_factory=op_factory)
            # the verdict is the chunk's sync point
            ok, val = _from_rank0(mesh, verdict, 2, alpha.device)
        healthy = ok == 1.0
        kind = KIND_NONFINITE
        if healthy and want_metric and not (
                np.isfinite(val) and (not np.isfinite(best)
                                      or val <= blowup * best)):
            healthy, kind = False, KIND_METRIC

        if not healthy:
            # last good state = the chunk-start alpha: chunks are the
            # guard's granularity here
            if op_factory is not None:
                plan.carry_fired = True
            if not opts.fallback:
                raise DivergenceError(
                    f"guarded {opts.layout} solve diverged ({kind}) in the "
                    f"chunk at iteration {pos} and fallback is disabled",
                    events=tuple(events))
            try:
                action, s_cur, method_cur, x64_new = next_fallback(
                    s_cur, method_cur, x64)
            except DivergenceError as e:
                raise DivergenceError(str(e),
                                      events=tuple(events)) from None
            events.append(HealthEvent(
                kind=kind, round_idx=rounds_done, iter_idx=pos,
                action=action,
                detail=f"re-running chunk from iteration {pos}"))
            if tel is not None:
                tel.metrics.counter(
                    "repro_guard_fallbacks_total",
                    "escalation-ladder steps taken").inc(
                        action=action, kind=kind)
                tel.mark("fallback", phase="guard")
            if x64_new and not x64:
                x64 = True
                A_cur, y_cur = A_cur.double(), y_cur.double()
                solver = distributed.LayoutSolver(
                    mesh, opts.layout, A_cur, y_cur, cfg_s,
                    slab_free=opts.slab_free)
                op_cur = op_cur.astype(torch.float64)
                alpha = alpha.double()
            continue

        alpha = alpha_new
        pos += seg
        rounds_done += -(-seg // s_cur)
        if want_metric:
            hist.append(val)
            best = min(best, val)
            if opts.tol > 0.0 and val <= opts.tol:
                converged = True
        if opts.checkpoint_every > 0 and not converged and pos < H:
            if mgr is not None:
                save_solve_state(mgr, pos, alpha.to(base_dtype), None,
                                 s_cur=s_cur, method_cur=method_cur,
                                 fingerprint=fingerprint)
            checkpoints += 1
            if plan is not None and plan.should_kill(pos):
                plan.kill_fired = True
                if mgr is not None:
                    mgr.wait()               # the snapshot is durable
                _from_rank0(mesh, lambda: 0.0, 1, alpha.device)  # all ranks
                raise SimulatedKill(
                    f"simulated preemption at iteration {pos}",
                    opts.checkpoint_dir)
    if mgr is not None:
        mgr.wait()
    history = np.asarray(hist) if want_metric else None
    health = SolveHealth(
        guarded=True, recompute_every=0, drift=np.zeros(0), corrections=0,
        events=tuple(events), checkpoints=checkpoints,
        resumed_from=resumed_from)
    return (alpha.to(base_dtype), history, converged, rounds_done, pos,
            health)


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
            landmarks=None, resume_from=None) -> FitResult:
        """Solve the dual.  ``warm_start`` seeds alpha (shape (m,));
        ``schedule`` replays a given coordinate schedule ((H,) for K-SVM,
        (H, b) for K-RR) instead of drawing one from ``options.seed``;
        ``landmarks`` (l, n) replays a Nystrom landmark set instead of
        drawing one; ``resume_from`` continues the mid-solve checkpoint
        directory of a guarded fit (``options.checkpoint_every``) of the
        same solve.  A streamed fit validates and chunks A on the host:
        A never goes to the card."""
        if landmarks is not None and self.options.approx is None:
            raise ValueError("landmarks= replays a Nystrom landmark set: "
                             "it needs options.approx='nystrom'")
        A = _check_finite(A, "A", self._data_device)
        y = _check_finite(y, "y", self.device)
        result, op = _fit(self.problem, A, y, self.cfg, self.options,
                          self.device, a0=warm_start, schedule=schedule,
                          landmarks=landmarks, resume_from=resume_from)
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

    def save(self, directory: str) -> str:
        """Persist the fitted model as a serving artifact
        (``repro_torch.serve.artifacts.save_model``): restore it with
        ``repro_torch.serve.load_model`` / ``ModelRegistry.load`` — no
        refit, no live estimator needed.  Returns the artifact path."""
        from repro_torch.serve.artifacts import save_model
        return save_model(directory, self)


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

    def save(self, directory: str) -> str:
        """Persist the fitted model as a serving artifact (see
        ``KernelSVM.save``).  Returns the artifact path."""
        from repro_torch.serve.artifacts import save_model
        return save_model(directory, self)
