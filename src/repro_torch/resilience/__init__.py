"""Guarded solves: drift correction, divergence detection with the
fallback ladder, mid-solve checkpoint and resume, and fault injection
(the counterpart of ``repro/resilience``).

  guard.py       the health predicate, the residual's initial value and
                 exact recompute (drift correction), the escalation
                 ladder
  health.py      HealthEvent / SolveHealth (``FitResult.health``)
  checkpoint.py  mid-solve snapshots and whole fits over
                 train/checkpoint.py
  faults.py      deterministic fault injection for tests

``core/loop.run_rounds(guard=...)`` runs the guarded rounds (captured as
CUDA graphs on the card); the facade's executor (``repro_torch.api``)
walks the segments, the ladder and the checkpoints.
"""
from .guard import (DivergenceError, finite_health, init_residual,
                    make_correct_fn, next_fallback, LADDER_HALVE_S,
                    LADDER_CLASSICAL, LADDER_F64)
from .health import HealthEvent, SolveHealth
from .checkpoint import (SOLVE_STATE_KEYS, load_solve_state,
                         save_solve_state, solve_fingerprint)
from .faults import (FaultPlan, SimulatedKill, active_plan, inject,
                     poisoned_1d_factory)
