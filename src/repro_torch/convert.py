"""Carry fitted state from the JAX package into the port.

The JAX side hands over plain data only — numpy arrays and dicts such as
``dataclasses.asdict(estimator.cfg)`` — so this module imports nothing
of ``repro``.  ``fitted_estimator`` returns a ``KernelSVM`` /
``KernelRidge`` that predicts what the JAX estimator with the same
``A``, ``y``, ``alpha`` and config predicts; ``schedule`` turns a JAX
``FitResult.schedule`` (int32) into the int64 schedule ``fit(...,
schedule=)`` replays.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch

from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
from repro_torch.core import KernelConfig, KRRConfig, SVMConfig, as_schedule
from repro_torch.device import as_tensor, resolve_device


def kernel_config(d: Mapping) -> KernelConfig:
    """``KernelConfig`` from ``dataclasses.asdict`` of the JAX one."""
    return KernelConfig(name=d["name"], degree=int(d["degree"]),
                        coef0=float(d["coef0"]), sigma=float(d["sigma"]))


def svm_config(d: Mapping) -> SVMConfig:
    return SVMConfig(C=float(d["C"]), loss=d["loss"],
                     kernel=kernel_config(d["kernel"]))


def krr_config(d: Mapping) -> KRRConfig:
    return KRRConfig(lam=float(d["lam"]), kernel=kernel_config(d["kernel"]))


def solver_options(d: Mapping) -> SolverOptions:
    """``SolverOptions`` from the JAX options' fields; a knob the port
    does not run yet raises unless it is at its default."""
    names = {f.name for f in dataclasses.fields(SolverOptions)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"unknown solver options {unknown}")
    return SolverOptions(**dict(d))


def schedule(arr, device=None) -> torch.Tensor:
    """A JAX coordinate schedule as the port's int64 indices."""
    return as_schedule(arr, resolve_device(device))


def fitted_estimator(problem: str, cfg: Mapping, A, y, alpha, *,
                     options: Optional[Mapping] = None,
                     predict_batch: int = 1024, device=None):
    """A fitted port estimator from a JAX estimator's state.

    problem: "ksvm" or "krr"; cfg: ``dataclasses.asdict`` of the JAX
    ``SVMConfig`` / ``KRRConfig``; A, y, alpha: arrays of the JAX
    estimator's ``A_``, ``y_``, ``alpha_``; options: the JAX options'
    fields (optional)."""
    opts = solver_options(options) if options is not None else None
    if problem == "ksvm":
        c = svm_config(cfg)
        est = KernelSVM(C=c.C, loss=c.loss, kernel=c.kernel, options=opts,
                        predict_batch=predict_batch, device=device)
    elif problem == "krr":
        c = krr_config(cfg)
        est = KernelRidge(lam=c.lam, kernel=c.kernel, options=opts,
                          predict_batch=predict_batch, device=device)
    else:
        raise ValueError(f"problem must be 'ksvm' or 'krr', got "
                         f"{problem!r}")

    def tensor(x):
        return as_tensor(x, est.device).contiguous()

    A_t, y_t, alpha_t = tensor(A), tensor(y), tensor(alpha)
    m = A_t.shape[0]
    if A_t.ndim != 2 or y_t.shape != (m,) or alpha_t.shape != (m,):
        raise ValueError(f"expected A (m, n), y (m,), alpha (m,); got "
                         f"{tuple(A_t.shape)}, {tuple(y_t.shape)}, "
                         f"{tuple(alpha_t.shape)}")
    est._adopt(A_t, y_t, alpha_t)
    return est
