"""The s-step collective auditor (the counterpart of
``repro/analysis/comm_check.py``).

The paper's claim is structural: the s-step solvers run the classical
update while communicating once every s steps, so H iterations cost
ceil(H / s) rounds of messages.  ``core.perf_model`` prices that
schedule; this module holds the code to it.  Every case of the
reference's matrix ({K-SVM, K-RR} x {1d, 2d} x {classical, s-step} x
{linear, rbf} at M, N, H, B, S = 32, 16, 16, 2, 4) runs the port's
``core.distributed`` solver on a ``(1, 1)`` mesh, where the mesh counts
its collectives without a process group, and takes the run's census
(``launch.collective_census``):

* CHK-COMM (error): the collectives executed != rounds x
  ``perf_model.round_collectives`` + ``setup_collectives``, the rounds
  being the message count of ``perf_model.modeled_fit_cost`` at P = 1,
  which the autotuner prices with.  An extra reduction in a round, or
  one that left the round loop, fails the count.
* CHK-AXIS (error): a collective over an axis the mesh does not have
  (``MESH_AXIS``, the whole mesh, is one it has).
* CHK-SSTEP (error): per solver, layout and kernel, the s-step run's
  collectives a round != the classical run's: the communication the
  s-step schedule avoids is the rounds, never the per-round schedule.

The JAX auditor traces a jaxpr, where a census counts sites times scan
trip counts; the port runs the solver, so every loop counts by its real
trip count (ROADMAP C38).  Findings anchor to the solver's ``def`` line
in ``core/distributed.py``.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
import os
from typing import List, Tuple

import torch

from repro_torch.core import distributed as dist
from repro_torch.core.bdcd import KRRConfig
from repro_torch.core.dcd import SVMConfig
from repro_torch.core.kernels import KernelConfig
from repro_torch.core.perf_model import (modeled_fit_cost, round_collectives,
                                         setup_collectives)
from repro_torch.launch.collective_census import (CollectiveUse,
                                                  collective_census)
from repro_torch.launch.mesh import MESH_AXIS, Mesh

from .findings import ERROR, Finding

M, N, H, B, S = 32, 16, 16, 2, 4          # the audited problem

SOLVERS = {
    ("ksvm", "1d"): dist.dist_sstep_dcd_ksvm,
    ("ksvm", "2d"): dist.dist_sstep_dcd_ksvm_2d,
    ("krr", "1d"): dist.dist_sstep_bdcd_krr,
    ("krr", "2d"): dist.dist_sstep_bdcd_krr_2d,
}
KERNEL_NAMES = ("linear", "rbf")


@dataclasses.dataclass(frozen=True)
class CommCase:
    """One audited run."""

    problem: str          # "ksvm" | "krr"
    layout: str           # "1d" | "2d"
    mode: str             # "classical" | "sstep"
    kernel: str           # "linear" | "rbf"

    @property
    def s(self) -> int:
        return 1 if self.mode == "classical" else S

    @property
    def rounds(self) -> int:
        return math.ceil(H / self.s)


CASES: Tuple[CommCase, ...] = tuple(
    CommCase(p, lay, m, k)
    for (p, lay) in SOLVERS
    for m in ("classical", "sstep")
    for k in KERNEL_NAMES)


def _cfg(case: CommCase):
    kern = KernelConfig(case.kernel)
    if case.problem == "ksvm":
        return SVMConfig(C=1.0, loss="l1", kernel=kern)
    return KRRConfig(lam=1.0, kernel=kern)


def _problem(case: CommCase):
    """The audited problem on the CPU, drawn from a seed: A (M, N), labels
    of +-1, a zero start and a schedule of H coordinates (K-RR: H blocks
    of B)."""
    gen = torch.Generator().manual_seed(0)
    A = torch.randn((M, N), generator=gen)
    y = torch.randint(0, 2, (M,), generator=gen).float() * 2 - 1
    shape = (H,) if case.problem == "ksvm" else (H, B)
    sched = torch.randint(0, M, shape, generator=gen)
    return A, y, torch.zeros(M), sched


def trace_case(case: CommCase) -> Tuple[CollectiveUse, ...]:
    """Run the case's solver on a ``(1, 1)`` mesh and return its census."""
    mesh = Mesh((1, 1))
    A, y, a0, sched = _problem(case)
    return collective_census(SOLVERS[(case.problem, case.layout)], mesh, A,
                             y, a0, sched, _cfg(case), s=case.s)


def expected_executions(case: CommCase) -> int:
    """The model's count: collectives a round x the Hockney message rounds
    (``modeled_fit_cost``'s messages at P = 1, one a round) plus the
    setup collectives (the RBF row norms)."""
    b = B if case.problem == "krr" else 1
    rounds = int(modeled_fit_cost(M, N, case.kernel, b=b, s=case.s,
                                  iters=H, P=1)["msgs"])
    if rounds != case.rounds:
        raise AssertionError((rounds, case))
    return (rounds * round_collectives(case.layout, case.kernel)
            + setup_collectives(case.layout, case.kernel))


def _anchor(case: CommCase) -> Tuple[str, int]:
    fn = SOLVERS[(case.problem, case.layout)]
    return (os.path.abspath(inspect.getsourcefile(fn)),
            inspect.getsourcelines(fn)[1])


def audit_case(case: CommCase, census=None) -> List[Finding]:
    """CHK-COMM and CHK-AXIS for one case (``census`` injectable for the
    fixtures)."""
    census = trace_case(case) if census is None else census
    path, line = _anchor(case)
    label = f"{case.problem}/{case.layout}/{case.mode}/{case.kernel}"
    out: List[Finding] = []
    total = sum(u.executions for u in census)
    want = expected_executions(case)
    if total != want:
        sites = [(u.prim, u.axes, u.executions,
                  f"{os.path.basename(u.path)}:{u.line}") for u in census]
        out.append(Finding(
            "CHK-COMM", ERROR, path, line,
            f"{label}: ran {total} collectives, the model says {want} "
            f"({case.rounds} rounds x "
            f"{round_collectives(case.layout, case.kernel)} + "
            f"{setup_collectives(case.layout, case.kernel)} setup) — "
            f"census: {sites}"))
    known = set(Mesh((1, 1)).axis_names) | {MESH_AXIS}
    for u in census:
        bad = [a for a in u.axes if a not in known]
        if bad:
            out.append(Finding(
                "CHK-AXIS", ERROR, path, line,
                f"{label}: {u.prim} over unknown mesh axis name(s) {bad} "
                f"— the mesh has {sorted(known)}"))
    return out


def _per_round(case: CommCase, census) -> float:
    """Collectives a round: the census without the setup, over the
    rounds."""
    total = sum(u.executions for u in census)
    return (total - setup_collectives(case.layout, case.kernel)) \
        / case.rounds


def audit() -> List[Finding]:
    findings: List[Finding] = []
    per_round = {}
    for case in CASES:
        census = trace_case(case)
        findings.extend(audit_case(case, census))
        per_round[(case.problem, case.layout, case.kernel,
                   case.mode)] = _per_round(case, census)
    for (p, lay) in SOLVERS:
        for k in KERNEL_NAMES:
            cl = per_round[(p, lay, k, "classical")]
            ss = per_round[(p, lay, k, "sstep")]
            if cl != ss:
                path, line = _anchor(CommCase(p, lay, "sstep", k))
                findings.append(Finding(
                    "CHK-SSTEP", ERROR, path, line,
                    f"{p}/{lay}/{k}: the s-step run makes {ss} collectives "
                    f"a round against the classical {cl} — per {H} "
                    f"iterations it must make the classical count over "
                    f"{S}"))
    return findings


def run() -> List[Finding]:
    return audit()
