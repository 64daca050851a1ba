"""repro_torch.tune — solver fleets, warm-started regularisation paths
and the perf-model-driven autotuner (the counterpart of ``repro.tune``):

  * ``solve_fleet``     — F problems of a lambda or C grid on one shared
                          operator, one kernel launch a round for the
                          whole fleet (tune/fleet.py);
  * ``reg_path``        — a warm-started regularisation ladder;
    ``cross_validate``  — k-fold grid search composing fleet and path
                          (tune/path.py);
  * ``resolve_options`` — ``SolverOptions`` "auto" knobs resolved through
                          the Hockney model within the device's budget,
                          optionally refined by measured probe rounds,
                          returning a ``TunedPlan`` (tune/autotune.py).
"""
from .autotune import TunedPlan, resolve_options
from .fleet import FleetResult, solve_fleet
from .path import CVResult, PathResult, cross_validate, reg_path

__all__ = ["TunedPlan", "resolve_options", "FleetResult", "solve_fleet",
           "CVResult", "PathResult", "cross_validate", "reg_path"]
