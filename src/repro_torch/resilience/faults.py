"""Deterministic fault injection for guarded-solve tests (the
counterpart of ``repro/resilience/faults.py``).

  * ``FaultPlan(nan_at_iter=...)``: the facade's guarded executor arms
    its fault lane: in the round holding the given inner iteration,
    ``value`` (NaN or Inf) is added to the chosen carry leaf after the
    round's update.  The fault fires once, so the escalation ladder
    descends one rung per injected fault.  On the card the lane rides
    the captured rounds (a per-round hit mask in the schedule, the value
    a device scalar), so no host branch decides where it fires.
  * ``FaultPlan(kill_at_iter=...)``: the executor raises
    ``SimulatedKill`` at the first checkpoint boundary at or after that
    iteration, once the snapshot is durable; a test then re-fits with
    ``resume_from=``.
  * ``poisoned_1d_factory``: the 1d layouts' operator factory that scales
    one rank's shard before the round all-reduce; a guarded 1d fit arms
    it, instead of the lane, for the chunk holding ``nan_at_iter``.

``inject`` arms a plan; nothing consults this module unless a plan is
armed.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

FAULT_TARGETS = ("f", "alpha")


class SimulatedKill(RuntimeError):
    """Raised by the executor to simulate preemption mid-solve.  The
    checkpoint written just before the raise is durable: catch this and
    re-fit with ``resume_from=``."""

    def __init__(self, message: str, checkpoint_dir: str):
        super().__init__(message)
        self.checkpoint_dir = checkpoint_dir


@dataclasses.dataclass
class FaultPlan:
    """One deterministic fault scenario.

    nan_at_iter:  global inner-iteration index; the fault fires in the
                  round containing it.  None = no carry fault.
    value:        what is added to the target leaf (NaN, or Inf).
    target:       the guarded-carry leaf to poison: "f" (the residual
                  recurrence) or "alpha".
    kill_at_iter: simulate preemption at the first checkpoint boundary
                  at or after this iteration.  None = no kill.
    """

    nan_at_iter: Optional[int] = None
    value: float = float("nan")
    target: str = "f"
    kill_at_iter: Optional[int] = None
    # one-shot bookkeeping (set by the executor)
    carry_fired: bool = False
    kill_fired: bool = False

    def __post_init__(self):
        if self.target not in FAULT_TARGETS:
            raise ValueError(f"target must be one of {FAULT_TARGETS}, "
                             f"got {self.target!r}")

    def carry_fault_round(self, pos: int, seg_iters: int, s: int) -> int:
        """Round index within the segment [pos, pos + seg_iters) where
        the carry fault fires, or -1 (none, or already fired)."""
        if self.nan_at_iter is None or self.carry_fired:
            return -1
        if not pos <= self.nan_at_iter < pos + seg_iters:
            return -1
        return (self.nan_at_iter - pos) // s

    def should_kill(self, pos: int) -> bool:
        """Whether to simulate preemption at the checkpoint boundary
        after ``pos`` consumed iterations."""
        return (self.kill_at_iter is not None and not self.kill_fired
                and pos >= self.kill_at_iter)


_ACTIVE: Optional[FaultPlan] = None


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Arm ``plan`` for every guarded fit inside the block."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, plan
    try:
        yield plan
    finally:
        _ACTIVE = prev


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def poisoned_1d_factory(mesh, axis_name: str = "model", rank: int = 0,
                        scale: float = float("nan")):
    """``op_factory(A_loc, kcfg)`` for the 1d solvers on ``mesh`` that
    corrupts ONE rank's shard before the round all-reduce: the block of
    the rank at ``rank`` along ``axis_name`` is scaled by ``scale`` (NaN
    poisons the collective; a large finite scale perturbs it).  Linear
    kernels only: the RBF operator needs the reduced row norms, which
    this factory deliberately does not recompute from poisoned data.
    The JAX factory reads the rank inside ``shard_map``; here the mesh
    the solver runs on is given."""
    import torch

    from repro_torch.core.distributed import AllreduceGramOperator

    def factory(A_loc, kcfg):
        if kcfg.name != "linear":
            raise ValueError("poisoned_1d_factory supports linear "
                             f"kernels only, got {kcfg.name!r}")
        fac = scale if mesh.index(axis_name) == rank else 1.0
        return AllreduceGramOperator(
            mesh, axis_name, A_loc * torch.tensor(fac, dtype=A_loc.dtype,
                                                  device=A_loc.device),
            kcfg, None)

    return factory
