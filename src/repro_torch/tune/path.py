"""Warm-started regularisation paths and k-fold cross-validation — the
counterpart of ``repro/tune/path.py``.

``reg_path`` solves a regularisation ladder sequentially, seeding each
solve from its neighbour's solution: dual solutions vary continuously in
the regulariser, so a warm start enters each solve close to optimal and
the tolerance stopper exits in a fraction of the cold rounds.  The
ladder runs from strongest to weakest regularisation (lambda descending;
C ascending).  The representation is built once and reused by every
rung.

``cross_validate`` composes the two sweeps: per fold it solves the whole
grid as one fleet (``tune.fleet``) or, with ``via="path"``, as one
warm-started ladder, then predicts every member's validation rows
through the shared operator in one serving call (``serve_weights`` /
``serve_block`` take the (m, F)-stacked weights: one KMV of F columns
for the whole grid on the exact operator).  The folds are a numpy
permutation of the seed, the same as the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.core import KRRConfig, SVMConfig
from repro_torch.device import as_tensor, resolve_device

VIAS = ("fleet", "path")


@dataclasses.dataclass
class PathResult:
    """A solved regularisation ladder: ``results[i]`` is the ``FitResult``
    at ``values[i]`` (solved order: strongest -> weakest regularisation),
    warm-started from ``results[i-1]``; ``op`` is the shared
    representation operator (serve any rung through it)."""

    results: List[object]          # FitResult per rung
    values: np.ndarray             # (F,) ladder, solved order
    param: str                     # "lam" | "C"
    problem: str
    alphas: torch.Tensor           # (F, m) stacked solutions
    op: object                     # shared representation operator

    def metric_history(self, i: int):
        """Rung i's evaluated convergence trajectory."""
        return self.results[i].metric_history()

    @property
    def total_iters(self) -> int:
        """Inner iterations summed over the ladder — what warm starting
        shrinks against F independent cold solves."""
        return int(sum(r.iters_run for r in self.results))


def _problem_of(lams, Cs):
    if (lams is None) == (Cs is None):
        raise ValueError("pass exactly one of lams= (K-RR) or Cs= (K-SVM)")
    return ("krr" if Cs is None else "ksvm",
            np.asarray(lams if Cs is None else Cs, dtype=np.float64))


def _ladder(problem, values):
    """Strongest-to-weakest regularisation order (module docstring)."""
    if np.any(values <= 0.0):
        raise ValueError("regularization values must be positive")
    return np.sort(values)[::-1] if problem == "krr" else np.sort(values)


def reg_path(A, y, *, lams=None, Cs=None, cfg=None, kernel=None,
             loss: str = "l1", options=None, schedule=None, landmarks=None,
             device=None) -> PathResult:
    """Warm-started ladder over a lambda grid (K-RR) or C grid (K-SVM);
    see module docstring.  ``cfg`` (a ``KRRConfig``/``SVMConfig``) fixes
    the kernel and loss — the facade's ``fit_path`` passes its own;
    otherwise one is built from ``kernel``/``loss``.  Set ``options.tol``
    for the warm starts to pay off.  ``schedule`` and ``landmarks``
    replay as in ``fit`` (the same schedule for every rung, as the JAX
    package draws each rung's from the same seed)."""
    from repro_torch.api import (SolverOptions, _as_kernel,
                                 _build_representation, _check_finite, _fit)

    problem, values = _problem_of(lams, Cs)
    ladder = _ladder(problem, values)
    opts = options or SolverOptions()
    if cfg is None:
        cfg = (KRRConfig(lam=1.0, kernel=_as_kernel(kernel))
               if problem == "krr"
               else SVMConfig(C=1.0, loss=loss, kernel=_as_kernel(kernel)))
    device = resolve_device(device)
    A = _check_finite(A, "A", torch.device("cpu")
                      if opts.stream is not None else device)
    y = _check_finite(y, "y", device)

    if opts.needs_autotune:
        from .autotune import resolve_options
        plan = resolve_options(A.shape[0], A.shape[1], cfg, opts,
                               problem=problem, A=A, y=y, device=device)
        opts = plan.options

    rep = _build_representation(A, cfg, opts, device, landmarks=landmarks)
    results, alpha = [], None
    for v in ladder:
        cfg_i = (dataclasses.replace(cfg, lam=float(v)) if problem == "krr"
                 else dataclasses.replace(cfg, C=float(v)))
        res, _ = _fit(problem, A, y, cfg_i, opts, device, a0=alpha,
                      rep=rep, schedule=schedule)
        results.append(res)
        alpha = res.alpha
    return PathResult(results=results, values=ladder,
                      param="lam" if problem == "krr" else "C",
                      problem=problem,
                      alphas=torch.stack([r.alpha for r in results]),
                      op=rep[0])


@dataclasses.dataclass
class CVResult:
    """k-fold grid search scores.  ``scores[k, f]`` is fold k's
    validation score at ``values[f]`` (input grid order): MSE for K-RR
    (lower is better), accuracy for K-SVM (higher is better) — see
    ``score_name``.  ``best_value``/``best_index`` pick the grid point
    with the best mean score; ``folds[k]`` keeps fold k's
    ``FleetResult``/``PathResult``."""

    scores: np.ndarray             # (k, F)
    mean_scores: np.ndarray        # (F,)
    values: np.ndarray             # (F,) grid, input order
    param: str
    problem: str
    score_name: str                # "mse" | "accuracy"
    best_index: int
    best_value: float
    folds: List[object]


def _fold_indices(m: int, n_folds: int, seed: int):
    perm = np.random.RandomState(seed).permutation(m)
    return np.array_split(perm, n_folds)


def _score_members(problem, op, alpha_F, values, y_tr, A_val, y_val):
    """All F members' validation scores from one serving call: the shared
    operator takes the (m, F)-stacked weights (one KMV of F columns on
    the exact operator)."""
    W = alpha_F.T                                     # (m_tr, F)
    if problem == "ksvm":
        W = W * y_tr[:, None]
    preds = op.serve_block(A_val, op.serve_weights(W))    # (q, F)
    if problem == "krr":
        preds = preds / torch.as_tensor(values, dtype=preds.dtype,
                                        device=preds.device)[None, :]
        err = preds - y_val[:, None]
        return torch.mean(err * err, dim=0).double().cpu().numpy()
    hit = torch.sign(preds) == y_val[:, None]
    return torch.mean(hit.to(torch.float32), dim=0).double().cpu().numpy()


def cross_validate(A, y, *, lams=None, Cs=None, kernel=None,
                   loss: str = "l1", options=None, folds: int = 5,
                   via: str = "fleet", seed: int = 0,
                   device=None) -> CVResult:
    """k-fold grid search over a regularisation grid; see module
    docstring.  ``via="fleet"`` solves each fold's grid as one fleet;
    ``via="path"`` as one warm-started ladder."""
    from .fleet import solve_fleet

    if via not in VIAS:
        raise ValueError(f"via must be one of {VIAS}, got {via!r}")
    if not isinstance(folds, int) or folds < 2:
        raise ValueError(f"folds must be an int >= 2, got {folds!r}")
    problem, values = _problem_of(lams, Cs)
    device = resolve_device(device)
    A_h = as_tensor(A).cpu()
    y_h = as_tensor(y).cpu()
    m = A_h.shape[0]
    if folds > m:
        raise ValueError(f"folds={folds} exceeds m={m}")

    kw = {"lams": values} if problem == "krr" else {"Cs": values}
    scores, fold_results = [], []
    for val_idx in _fold_indices(m, folds, seed):
        tr_mask = np.ones(m, bool)
        tr_mask[val_idx] = False
        tr = torch.from_numpy(np.flatnonzero(tr_mask))
        vi = torch.from_numpy(np.asarray(val_idx))
        A_tr, y_tr = A_h[tr].to(device), y_h[tr].to(device)
        A_val, y_val = A_h[vi].to(device), y_h[vi].to(device)
        if via == "fleet":
            fr = solve_fleet(A_tr, y_tr, kernel=kernel, loss=loss,
                             options=options, device=device, **kw)
            alpha_F = fr.alpha
        else:
            fr = reg_path(A_tr, y_tr, kernel=kernel, loss=loss,
                          options=options, device=device, **kw)
            # ladder order -> input grid order
            pos = {float(v): i for i, v in enumerate(fr.values)}
            alpha_F = fr.alphas[[pos[float(v)] for v in values]]
        fold_results.append(fr)
        scores.append(_score_members(problem, fr.op, alpha_F, values,
                                     y_tr, A_val, y_val))
    scores = np.stack(scores)                        # (k, F)
    mean = scores.mean(axis=0)
    best = int(np.argmin(mean) if problem == "krr" else np.argmax(mean))
    return CVResult(scores=scores, mean_scores=mean, values=values,
                    param="lam" if problem == "krr" else "C",
                    problem=problem,
                    score_name="mse" if problem == "krr" else "accuracy",
                    best_index=best, best_value=float(values[best]),
                    folds=fold_results)
