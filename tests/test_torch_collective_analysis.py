"""The port's collective census and collective log
(``launch/collective_census.py``, ``launch/collective_log.py``) against
the JAX package's (``launch/jaxpr_analysis.py``, ``launch/hlo_analysis.py``).

* For every case of the reference's comm matrix ({K-SVM, K-RR} x {1d,
  2d} x {classical, s-step} x {linear, rbf}), the port's census of its
  solver run on a (1, 1) mesh executes as many collectives, over each
  axis, as JAX's ``collective_census`` of ``comm_check.trace_case``'s
  jaxpr (a scan's trip counts multiplied through; the port counts its
  loops by their real trips, ROADMAP C38).
* The bytes and counts by primitive that the port reads off its mesh's
  record equal JAX's ``collective_bytes`` / ``count_collectives`` on an
  HLO text made for the same collectives (one line a call, its result's
  shape and dtype): for a dry-run cell of the training step on the (2,
  16, 16) production mesh, whose FSDP gathers, reduce-scatters and
  tensor-parallel and ``pod`` reductions cover the three primitives."""
import dataclasses

import pytest
import torch

from repro.analysis import comm_check as jax_comm
from repro.launch.hlo_analysis import (collective_bytes as jax_bytes,
                                       count_collectives as jax_count)
from repro_torch.analysis import comm_check
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.collective_log import (collective_bytes,
                                               count_collectives)
from repro_torch.launch.mesh import COLLECTIVES, make_production_mesh
from repro_torch.models.sharding import MeshRules

HLO_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16", torch.int32: "s32", torch.int64: "s64",
              torch.float64: "f64"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _by_axes(census) -> dict:
    out = {}
    for u in census:
        out[tuple(u.axes)] = out.get(tuple(u.axes), 0) + u.executions
    return out


@pytest.mark.parametrize("case", comm_check.CASES,
                         ids=lambda c: f"{c.problem}-{c.layout}-{c.mode}-"
                                       f"{c.kernel}")
def test_census_executions_equal_jax(case):
    jcase = jax_comm.CommCase(case.problem, case.layout, case.mode,
                              case.kernel)
    want = jax_comm.trace_case(jcase)
    got = comm_check.trace_case(case)
    assert sum(u.executions for u in got) == \
        sum(u.executions for u in want)
    assert _by_axes(got) == _by_axes(want)
    assert comm_check.expected_executions(case) == \
        jax_comm.expected_executions(jcase)


def _hlo_text(log) -> str:
    """An HLO module text with one collective a logged call, written as
    XLA prints a collective: its result's shape, operands as bare
    references."""
    lines = ["HloModule dry_run", "ENTRY main {"]
    for i, c in enumerate(log):
        dims = ",".join(map(str, c.shape))
        layout = ",".join(str(d) for d in reversed(range(len(c.shape))))
        lines.append(f"  %c{i} = {HLO_DTYPES[c.dtype]}[{dims}]{{{layout}}} "
                     f"{c.prim}(%p{i}), replica_groups={{}}")
    lines.append("}")
    return "\n".join(lines)


def test_bytes_and_counts_equal_jax_on_the_same_collectives():
    cfg = dataclasses.replace(dryrun.probe_cfg(get_config("qwen3_1p7b"), 1),
                              attn_impl="flash")
    rules = MeshRules(make_production_mesh(multi_pod=True))
    saved = COLLECTIVES.log
    COLLECTIVES.log = []
    try:
        dryrun.measure(cfg, "train_4k", rules)
        log = list(COLLECTIVES.log)
    finally:
        COLLECTIVES.log = saved
    assert {c.prim for c in log} == {"all-gather", "all-reduce",
                                     "reduce-scatter"}
    assert any(c.axis == "pod" for c in log)
    text = _hlo_text(log)
    assert collective_bytes() == jax_bytes(text)
    assert count_collectives() == jax_count(text)
    assert sum(count_collectives().values()) == len(log)
