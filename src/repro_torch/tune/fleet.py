"""Multi-problem solver fleets — the counterpart of
``repro/tune/fleet.py``.

Hyperparameter search is the dominant real workload for kernel methods:
every point of a lambda/C grid is a full solve against the same data.  A
fleet solves F such problems in lockstep on ONE shared ``GramOperator``:
the round functions take the regulariser as an (F,) tensor
(``make_*_round_fn(C=/lam=)``) and advance an (F, m) alpha, so each
round evaluates the kernel once for the whole fleet — one gram launch
for the shared cross block and one KMV launch with the F members'
alphas as its F columns — and only the O((sb)^2) local phase and the
state updates scale with F (``perf_model.fleet_fit_cost`` prices this
split).  The JAX package gets the same sharing from ``jax.vmap``; here
the local phase is written batched over F and the kernels never see a
vmap.

Tolerance stopping is per member (``loop.run_rounds_fleet``): each
member checks its own metric, from one full matvec of F columns a check,
converged members are frozen in place, and the loop exits when the whole
fleet is done.  On the card the rounds and checks replay as CUDA graphs
(a streamed operator's stay eager, as a single streamed fit's do); a
capture that fails raises.  Only the serial layout runs here (the 1d
fleet is ROADMAP A11).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import (KernelConfig, KRRConfig, NO_TOL, SVMConfig,
                              krr_rel_residual_fleet, ksvm_gap_fleet,
                              pad_rounds, run_rounds_fleet)
from repro_torch.core.objectives import _kmv
from repro_torch.core.perf_model import fleet_fit_cost
from repro_torch.device import as_tensor, resolve_device

FLEET_LAYOUTS = ("serial",)


@dataclasses.dataclass
class FleetResult:
    """Everything ``solve_fleet`` observed, fleet-wide.

    ``alpha[f]`` is member f's solution for ``values[f]``;
    ``history[:, f]`` its convergence trajectory (``metric_history``);
    ``comm`` the modeled fleet cost (``perf_model.fleet_fit_cost``, with
    the modeled ``sequential_time`` of F independent fits and the implied
    ``modeled_speedup``); ``schedule`` the coordinates the rounds ran.
    """

    alpha: torch.Tensor            # (F, m)
    values: np.ndarray             # (F,) the lambda/C grid, input order
    param: str                     # "lam" | "C"
    problem: str                   # "krr" | "ksvm"
    history: Optional[np.ndarray]  # (checks_run, F) or None
    metric: str                    # "rel_residual" | "duality_gap"
    converged: np.ndarray          # (F,) bool
    rounds_run: int
    iters_run: int
    wall_time_s: float
    comm: dict
    options: object                # the (resolved) SolverOptions
    representation: str
    op: object = None              # the shared representation operator
    schedule: Optional[torch.Tensor] = None

    def metric_history(self, member: Optional[int] = None):
        """Evaluated trajectory: (checks, F), or member f's (checks,)."""
        if self.history is None:
            return None
        return self.history if member is None else self.history[:, member]


def fleet_metric(problem: str, op, A_s, y, cfg, opts, values):
    """``(alpha (F, m)) -> (F,)``: the members' tolerance metrics from one
    full matvec of F columns, each member's value the single fit's
    formula (``api._metric_fn``'s routes: the operator's ``full_matvec``,
    and for a Nystrom K-RR fit the linear KMV over Phi)."""
    if problem == "ksvm":
        def metric(alpha):
            Qa = y[:, None] * op.full_matvec((y[None, :] * alpha).T)
            return ksvm_gap_fleet(Qa, alpha, values, cfg.loss)
        return metric
    if opts.approx is not None:
        return lambda alpha: krr_rel_residual_fleet(
            _kmv(A_s, A_s, alpha.T, KernelConfig("linear")), y, alpha,
            values)
    return lambda alpha: krr_rel_residual_fleet(
        op.full_matvec(alpha.T), y, alpha, values)


def solve_fleet(A, y, *, lams=None, Cs=None, kernel=None, loss: str = "l1",
                options=None, warm_start=None, schedule=None,
                landmarks=None, device=None) -> FleetResult:
    """Solve F problems — a lambda grid (K-RR, ``lams``) or a C grid
    (K-SVM, ``Cs``) on shared data — in lockstep on one shared
    representation operator (module docstring).

    ``options`` is the facade's ``SolverOptions`` ("auto" knobs resolve
    through the autotuner first); fleets are
    slab-free.  ``warm_start`` seeds the whole fleet: (F, m) per member,
    or (m,) broadcast.  ``schedule`` replays a coordinate schedule and
    ``landmarks`` a Nystrom landmark set, as ``fit`` does.  Runs on
    ``device`` (default: the card)."""
    from repro_torch.api import (SolverOptions, _as_kernel,
                                 _build_representation, _check_finite,
                                 _round_fn, _schedule, _solve_cfg)

    if (lams is None) == (Cs is None):
        raise ValueError("pass exactly one of lams= (K-RR fleet) or "
                         "Cs= (K-SVM fleet)")
    problem = "krr" if Cs is None else "ksvm"
    values = np.asarray(lams if Cs is None else Cs, dtype=np.float64)
    if values.ndim != 1 or values.size < 1:
        raise ValueError(f"the {'lams' if Cs is None else 'Cs'} grid must "
                         f"be a non-empty 1-D sequence, got shape "
                         f"{values.shape}")
    if np.any(values <= 0.0):
        raise ValueError("regularization values must be positive")
    opts = options or SolverOptions()
    if not opts.slab_free:
        raise ValueError("fleets are slab-free by construction "
                         "(one shared operator); slab_free=False is the "
                         "single-solve parity oracle")
    device = resolve_device(device)
    A = _check_finite(A, "A", torch.device("cpu")
                      if opts.stream is not None else device)
    y = _check_finite(y, "y", device)
    m, n = A.shape
    F = values.size
    if problem == "krr":
        cfg = KRRConfig(lam=1.0, kernel=_as_kernel(kernel))
    else:
        cfg = SVMConfig(C=1.0, loss=loss, kernel=_as_kernel(kernel))

    if opts.needs_autotune:
        from .autotune import resolve_options
        opts = resolve_options(m, n, cfg, opts, problem=problem, A=A, y=y,
                               device=device).options
    if opts.layout not in FLEET_LAYOUTS:
        raise ValueError(f"fleet layout must be one of {FLEET_LAYOUTS}, "
                         f"got {opts.layout!r} (the 1d fleet is ROADMAP "
                         f"A11)")

    s = opts.s_eff
    b = opts.b if problem == "krr" else 1
    schedule = _schedule(problem, opts, m, b, device, schedule)
    H = schedule.shape[0]

    t0 = time.perf_counter()
    rep_op, A_s = _build_representation(A, cfg, opts, device,
                                        landmarks=landmarks)
    cfg_s = _solve_cfg(cfg, opts)
    train_op = rep_op.scale_rows(y) if problem == "ksvm" else rep_op
    params = torch.tensor(values, dtype=A.dtype, device=device)
    if warm_start is None:
        a0 = torch.zeros((F, m), dtype=A.dtype, device=device)
    else:
        a0 = as_tensor(warm_start).to(device=device, dtype=A.dtype)
        if a0.shape not in ((m,), (F, m)):
            raise ValueError(f"warm_start must have shape ({m},) or "
                             f"({F}, {m}), got {tuple(a0.shape)}")
        a0 = a0.expand(F, m).clone()

    rf = _round_fn(problem, A_s, y, cfg_s, s, None, train_op, params)
    xs = schedule if s == 1 else pad_rounds(schedule, s)
    want_metric = opts.tol > 0.0 or opts.record
    metric_fn = (fleet_metric(problem, rep_op, A_s, y, cfg, opts, values)
                 if want_metric else None)
    res = run_rounds_fleet(rf, a0, xs,
                           tol=opts.tol if opts.tol > 0.0 else NO_TOL,
                           check_every=opts.check_every,
                           metric_fn=metric_fn, capture=rep_op.capturable)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    rounds_run = res.rounds_run
    iters_run = min(rounds_run * s, H)
    history = (res.metric_history().numpy() if want_metric else None)
    lm = rep_op.rank if opts.approx is not None else 0
    comm = fleet_fit_cost(m, n, cfg.kernel.name, F, b=b, s=s,
                          iters=iters_run, P=1, approx=opts.approx,
                          landmarks=lm)
    return FleetResult(
        alpha=res.state, values=values,
        param="lam" if problem == "krr" else "C", problem=problem,
        history=history,
        metric="rel_residual" if problem == "krr" else "duality_gap",
        converged=res.converged.numpy(),
        rounds_run=rounds_run, iters_run=iters_run, wall_time_s=wall,
        comm=comm, options=opts,
        representation=f"nystrom(l={lm})" if opts.approx is not None
        else "exact", op=rep_op, schedule=schedule[:iters_run])
