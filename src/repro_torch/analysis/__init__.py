"""Static analysis of the port (the counterpart of ``repro/analysis``).

Five analyzers behind one CLI (``python -m repro_torch.analysis``):

* ``kernel`` (``kernel_check``): the hand-written CUDA kernels' sites,
  plans, TMA alignment, shared memory and the streamed pipe's copy
  discipline (the counterpart of ``pallas_check``);
* ``lint``: host syncs in captured round functions, tensor-carrying
  dataclasses that ``repro_torch.tree`` does not walk;
* ``comm``: the distributed solvers' collectives against
  ``perf_model``'s message schedule;
* ``guard``: every floating leaf of a guarded carry seen by the health
  predicate;
* ``obs``: every ``span_begin`` paired with a ``span_end``.

Findings carry stable check IDs and honour justified
``# repro: noqa[CHK-...]`` suppressions (``findings``).  ``CHECKS`` is
the catalog: per ID its analyzer, severity, what it flags and the JAX
check it stands for.  The JAX package's CHK-STATIC has no counterpart
(ROADMAP C39).
"""
from .findings import (ERROR, INFO, WARNING, Finding,  # noqa: F401
                       apply_suppressions, render_report)

ANALYZERS = ("kernel", "lint", "comm", "guard", "obs")

CHECKS = {
    "CHK-RACE": ("kernel", "error",
                 "a kernel plan's blocks cover a cell or slot twice",
                 "CHK-RACE"),
    "CHK-HOLE": ("kernel", "error",
                 "a kernel plan's blocks leave a cell uncovered",
                 "CHK-HOLE"),
    "CHK-ALIGN": ("kernel", "warning",
                  "TMA operand off its 16-byte boundary", "CHK-ALIGN"),
    "CHK-SMEM": ("kernel", "warning",
                 "dynamic shared memory over the card's opt-in limit",
                 "CHK-VMEM"),
    "CHK-SITE": ("kernel", "warning",
                 "C entry point not reached by the registry", "CHK-SITE"),
    "CHK-DMA": ("kernel", "error",
                "copy event recorded and waited out of pairs", "CHK-DMA"),
    "CHK-SYNC": ("lint", "error",
                 "host sync of a device value in a round function",
                 "CHK-TRACER"),
    "CHK-TREE": ("lint", "error",
                 "tensor-carrying dataclass the tree functions skip",
                 "CHK-PYTREE"),
    "CHK-COMM": ("comm", "error",
                 "collective executions != modeled message schedule",
                 "CHK-COMM"),
    "CHK-AXIS": ("comm", "error", "collective over unknown mesh axis",
                 "CHK-AXIS"),
    "CHK-SSTEP": ("comm", "error",
                  "s-step per-round collectives != classical",
                  "CHK-SSTEP"),
    "CHK-CARRY": ("guard", "error",
                  "guarded-carry leaf missed by the health predicate",
                  "CHK-CARRY"),
    "CHK-SPAN": ("obs", "error",
                 "span_begin without a same-function span_end",
                 "CHK-SPAN"),
    "CHK-NOQA": ("-", "error", "suppression without justification",
                 "CHK-NOQA"),
}


def run_all(only=None):
    """Run the selected analyzers (all by default) and resolve
    suppressions; returns every finding, the suppressed included."""
    from . import comm_check, guard_check, kernel_check, lint, obs_check
    runners = {"kernel": kernel_check.run, "lint": lint.run,
               "comm": comm_check.run, "guard": guard_check.run,
               "obs": obs_check.run}
    selected = ANALYZERS if not only else tuple(only)
    found = []
    for name in selected:
        found.extend(runners[name]())
    return apply_suppressions(found)
