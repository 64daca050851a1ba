"""Mid-solve checkpoint and resume for guarded fits, and whole fits
saved and loaded (the counterpart of ``repro/resilience/checkpoint.py``),
over the npy layout of ``train/checkpoint.py`` (atomic step
directories, one .npy a leaf, async writes that snapshot on the caller's
thread).

  * ``save_solve_state`` / ``load_solve_state`` snapshot the guarded
    carry ``(alpha, f)`` with what a continuation needs: iterations
    consumed, the current ladder position (s and method may have fallen
    back mid-run) and the solve's fingerprint.  The snapshot copies the
    carry to the host before the call returns, so the next replayed run
    may overwrite the static buffers it was read from.
  * ``solve_fingerprint`` pins everything the replay depends on: the
    problem, shapes, config, seed and budget, as in the JAX package, and
    also a digest of the schedule the fit runs, since ``fit(schedule=)``
    replays any schedule (ROADMAP C11).  ``fit(resume_from=)`` refuses a
    checkpoint of another solve, naming the fields that differ.
  * ``save_fit`` / ``load_fit`` round-trip a completed ``FitResult``
    (arrays as leaves, host scalars, options and the health ledger as
    JSON meta) with its operator; ``operator_meta`` /
    ``operator_template`` are the operator's static half as a JSON dict
    and back, for the exact, low-rank and streamed representations.

Checkpoints of the two packages are not readable across them (ROADMAP
A7).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.train.checkpoint import (CheckpointManager,
                                          available_steps, load_checkpoint,
                                          save_checkpoint)

SOLVE_STATE_KEYS = ("alpha", "f")


def operator_meta(op) -> dict:
    """The static half of an operator as a JSON-native dict: enough for
    ``operator_template`` to rebuild one of the same structure."""
    from repro_torch.core.kernels import (ExactGramOperator,
                                          LowRankGramOperator,
                                          StreamingGramOperator)

    if isinstance(op, ExactGramOperator):
        return {"kind": "exact", "kernel": dataclasses.asdict(op.cfg)}
    if isinstance(op, LowRankGramOperator):
        meta = {"kind": "lowrank", "has_fmap": op.fmap is not None}
        if op.fmap is not None:
            meta["kernel"] = dataclasses.asdict(op.fmap.kernel)
        return meta
    if isinstance(op, StreamingGramOperator):
        return {"kind": "stream", "kernel": dataclasses.asdict(op.cfg),
                "chunk_rows": int(op.chunk_rows), "m": int(op.m)}
    raise TypeError(f"cannot serialize operator of type "
                    f"{type(op).__name__}: only the exact, low-rank and "
                    f"streamed representations persist")


def operator_template(meta: dict):
    """Inverse of ``operator_meta``: an operator of the saved structure
    whose tensors are empty placeholders (``load_fit`` fills them)."""
    from repro_torch.core.kernels import (ExactGramOperator, KernelConfig,
                                          LowRankGramOperator,
                                          StreamingGramOperator)
    from repro_torch.core.nystrom import NystromMap

    kind = meta.get("kind")
    empty = torch.zeros(0)
    if kind == "exact":
        return ExactGramOperator(empty, KernelConfig(**meta["kernel"]))
    if kind == "lowrank":
        fmap = None
        if meta.get("has_fmap"):
            fmap = NystromMap(landmarks=empty, transform=empty,
                              kernel=KernelConfig(**meta["kernel"]))
        return LowRankGramOperator(Phi=empty, fmap=fmap)
    if kind == "stream":
        return StreamingGramOperator(empty, KernelConfig(**meta["kernel"]),
                                     int(meta["m"]), torch.device("cpu"))
    raise ValueError(f"unknown operator kind {kind!r} in checkpoint meta "
                     f"— cannot rebuild a template")


def _op_leaves(op) -> dict:
    """The operator's arrays, by name (a streamed operator's as its m
    true rows, host side)."""
    kind = operator_meta(op)["kind"]
    if kind == "exact":
        return {"A": op.A}
    if kind == "stream":
        return {"A": op.Xc.view(-1, op.Xc.shape[2])[:op.m]}
    leaves = {"Phi": op.Phi}
    if op.fmap is not None:
        leaves.update(landmarks=op.fmap.landmarks,
                      transform=op.fmap.transform)
    return leaves


def _op_from(template, meta: dict, leaves: dict, device: torch.device):
    """The template's operator holding ``leaves`` on ``device`` (a
    streamed operator chunks its rows on the host for it)."""
    from repro_torch.core.kernels import StreamingGramOperator

    kind = meta["kind"]
    if kind == "exact":
        return dataclasses.replace(template, A=leaves["A"].to(device))
    if kind == "stream":
        return StreamingGramOperator.from_dense(
            leaves["A"], template.cfg, int(meta["chunk_rows"]),
            device=device)
    fmap = template.fmap
    if fmap is not None:
        fmap = dataclasses.replace(
            fmap, landmarks=leaves["landmarks"].to(device),
            transform=leaves["transform"].to(device))
    return dataclasses.replace(template, Phi=leaves["Phi"].to(device),
                               fmap=fmap)


def options_meta(opts) -> dict:
    """Resolved ``SolverOptions`` as a JSON-native dict, without what does
    not persist: a mesh and a telemetry handle (whose CUDA events cannot
    even be copied) are stored as None."""
    return dataclasses.asdict(dataclasses.replace(opts, mesh=None,
                                                  telemetry=None))


def schedule_digest(schedule) -> str:
    """sha256 (16 hex digits) of a schedule's int64 indices and shape."""
    s = torch.as_tensor(schedule).detach().to("cpu", torch.int64)
    h = hashlib.sha256(str(tuple(s.shape)).encode())
    h.update(s.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def solve_fingerprint(problem: str, m: int, dtype, cfg, opts,
                      schedule=None) -> dict:
    """Everything a valid resume must match: the JAX package's fields
    (the iterates depend on the problem, its config and the schedule,
    drawn from seed and max_iters) plus ``schedule``, the digest of the
    schedule the fit runs, replayed or drawn.  The current ladder
    position (s, method) is resume state, stored beside it, not
    identity."""
    fp = {
        "problem": problem,
        "m": int(m),
        "dtype": str(dtype),
        "cfg": repr(cfg),
        "b": int(opts.b if problem == "krr" else 1),
        "seed": int(opts.seed),
        "max_iters": int(opts.max_iters),
        "layout": opts.layout,
    }
    if schedule is not None:
        fp["schedule"] = schedule_digest(schedule)
    return fp


def save_solve_state(manager: CheckpointManager, iters_done: int,
                     alpha, f, *, s_cur: int, method_cur: str,
                     fingerprint: dict) -> None:
    """Async snapshot at an outer-round boundary (``iters_done`` inner
    iterations consumed).  The carry is copied to the host on the
    caller's thread before this returns."""
    tree = {"alpha": alpha}
    if f is not None:
        tree["f"] = f
    manager.save_async(iters_done, tree,
                       extra={"iters_done": int(iters_done),
                              "s_cur": int(s_cur),
                              "method_cur": method_cur,
                              "has_f": f is not None,
                              "fingerprint": fingerprint})


def load_solve_state(directory: str, *,
                     expect_fingerprint: Optional[dict] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor], dict]:
    """The latest snapshot in ``directory`` as ``(alpha, f, extra)``, host
    tensors.  Raises ``FileNotFoundError`` when there is none and
    ``ValueError`` on a fingerprint mismatch, naming every field that
    differs."""
    steps = available_steps(directory)
    if not steps:
        raise FileNotFoundError(
            f"resume_from={directory!r}: no checkpoints found")
    tree, meta = load_checkpoint(directory, step=steps[-1])
    extra = meta["extra"]
    if expect_fingerprint is not None:
        saved = extra.get("fingerprint", {})
        bad = {k: (saved.get(k), v) for k, v in expect_fingerprint.items()
               if saved.get(k) != v}
        if bad:
            detail = ", ".join(f"{k}: checkpoint={s!r} vs fit={v!r}"
                               for k, (s, v) in sorted(bad.items()))
            raise ValueError(
                f"resume_from={directory!r} belongs to a different "
                f"solve — mismatched fingerprint fields: {detail}")
    by_path = dict(zip(meta["paths"], tree))
    f = by_path["f"] if extra.get("has_f") else None
    return by_path["alpha"], f, extra


def save_fit(directory: str, result, op=None, step: int = 0) -> str:
    """Persist a completed ``FitResult`` (and optionally its operator).
    Arrays travel as leaves; host scalars, the resolved options, the
    comm model and the health ledger as JSON meta.  ``plan`` (a tuning
    session) is not persisted.  Returns the checkpoint path."""
    arrays = {"alpha": result.alpha, "schedule": result.schedule}
    if result.history is not None:
        arrays["history"] = torch.as_tensor(np.asarray(result.history))
    health = getattr(result, "health", None)
    if health is not None:
        drift = np.zeros(0) if health.drift is None else health.drift
        arrays["health_drift"] = torch.as_tensor(np.asarray(drift,
                                                            np.float64))
    tree = {"arrays": arrays}
    if op is not None:
        tree["op"] = _op_leaves(op)
    meta = {
        "metric": result.metric,
        "converged": bool(result.converged),
        "rounds_run": int(result.rounds_run),
        "iters_run": int(result.iters_run),
        "wall_time_s": float(result.wall_time_s),
        "comm": {k: (float(v) if isinstance(v, float) else v)
                 for k, v in result.comm.items()},
        "options": options_meta(result.options),
        "representation": result.representation,
        "has_history": result.history is not None,
        "has_op": op is not None,
        "has_health": health is not None,
    }
    if health is not None:
        meta["health"] = {
            "guarded": bool(health.guarded),
            "recompute_every": int(health.recompute_every),
            "corrections": int(health.corrections),
            "checkpoints": int(health.checkpoints),
            "resumed_from": health.resumed_from,
            "events": [dataclasses.asdict(e) for e in health.events],
        }
    if op is not None:
        meta["op_meta"] = operator_meta(op)
    return save_checkpoint(directory, step, tree, extra={"fit": meta})


def load_fit(directory: str, op_template: Any = None, step: int = 0,
             device=None):
    """Inverse of ``save_fit``: ``(FitResult, op)`` with the arrays on
    ``device`` (the card unless ``device="cpu"``); ``op`` is None when
    the fit was saved without one.  ``op_template`` defaults to the one
    ``operator_template`` rebuilds from the saved meta."""
    from repro_torch.api import FitResult, SolverOptions
    from repro_torch.resilience.health import HealthEvent, SolveHealth

    dev = resolve_device(device)
    steps = available_steps(directory)
    if step not in steps:
        raise FileNotFoundError(
            f"no step {step} in {directory!r} (have {steps})")
    leaves, meta = load_checkpoint(directory, step=step)
    fit = meta["extra"]["fit"]
    by_path = dict(zip(meta["paths"], leaves))
    arrs = {p.split("/", 1)[1]: t for p, t in by_path.items()
            if p.startswith("arrays/")}
    op = None
    if fit["has_op"]:
        if op_template is None:
            op_template = operator_template(fit["op_meta"])
        op_leaves = {p.split("/", 1)[1]: t for p, t in by_path.items()
                     if p.startswith("op/")}
        op = _op_from(op_template, fit["op_meta"], op_leaves, dev)
    health = None
    if fit.get("has_health"):
        h = fit["health"]
        health = SolveHealth(
            guarded=h["guarded"], recompute_every=h["recompute_every"],
            drift=arrs["health_drift"].numpy(),
            corrections=h["corrections"],
            events=tuple(HealthEvent(**e) for e in h["events"]),
            checkpoints=h["checkpoints"], resumed_from=h["resumed_from"])
    result = FitResult(
        alpha=arrs["alpha"].to(dev), schedule=arrs["schedule"].to(dev),
        history=(arrs["history"].numpy() if fit["has_history"] else None),
        metric=fit["metric"], converged=fit["converged"],
        rounds_run=fit["rounds_run"], iters_run=fit["iters_run"],
        wall_time_s=fit["wall_time_s"], comm=fit["comm"],
        options=SolverOptions(**fit["options"]),
        representation=fit["representation"], health=health)
    return result, op
