"""The port's static analysis (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``): the counterparts of ``test_analysis.py``.

Each check the port keeps has a positive and a negative fixture
(``torch_analysis_fixtures``); the suppression protocol is held against
JAX's ``apply_suppressions`` on the same source lines; the census of the
mesh's collectives counts every primitive and real loop trips; the comm
auditor's full matrix is clean, an extra all-reduce in a round fails it
and an unknown axis is caught; the guard auditor accepts the real carries
and flags a blind and a rejecting predicate; and the port's whole tree
is clean under every analyzer (the JAX twin fails for ROADMAP C1)."""
import ast

import pytest
import torch

import torch_analysis_fixtures as fx
from repro.analysis.findings import Finding as JaxFinding
from repro.analysis.findings import apply_suppressions as jax_suppress
from repro_torch.analysis import CHECKS, comm_check, guard_check, lint
from repro_torch.analysis import kernel_check, obs_check, registry, run_all
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.findings import ERROR, Finding, apply_suppressions
from repro_torch.core.perf_model import setup_collectives
from repro_torch.launch.collective_census import (COLLECTIVE_PRIMS,
                                                  collective_census,
                                                  count_collective_executions)
from repro_torch.launch.mesh import Mesh


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ kernel sanitizer --

@pytest.mark.parametrize("bad,good,check", [
    (fx.racing_symmetric, fx.sound_symmetric, "CHK-RACE"),
    (fx.missing_split, fx.sound_split, "CHK-HOLE"),
    (fx.gram_short_split, fx.sound_gram, "CHK-HOLE"),
    (fx.misaligned_tma, fx.aligned_tma, "CHK-ALIGN"),
    (fx.smem_hog, fx.modest_smem, "CHK-SMEM"),
], ids=["race", "hole", "gram-hole", "align", "smem"])
def test_kernel_positive_negative(bad, good, check):
    caught = kernel_check.analyze_calls(bad(), kernel_check.SM90_SMEM_OPTIN)
    assert check in {f.check for f in caught}, caught
    assert {f.check for f in caught} <= {check}, caught
    assert kernel_check.analyze_calls(good(),
                                      kernel_check.SM90_SMEM_OPTIN) == []


def test_real_kernels_all_captured_and_clean():
    """Without a card the registry's stub launchers record every entry
    point's plan: all 16 C entry points are reached, and the sanitizer
    finds nothing (the card run holds the shared memory too:
    ``test_torch_gpu.py::test_registry_reaches_every_site_on_the_card``)."""
    calls = registry.capture_entry_points(launch=False)
    covered = {c.site for c in calls}
    sites = {(s.path, s.line) for s in registry.discover_sites()}
    assert len(sites) == 16 and sites <= covered, sites - covered
    assert all(c.launches is None for c in calls)
    assert kernel_check.run(calls) == []


def test_dma_record_and_wait_discipline():
    """CHK-DMA on a pipe's events: the sound double buffer is clean; a
    consume wait on the prefetch's slot and a record nobody waits on are
    both caught; the port's csrc/ is clean."""
    assert kernel_check.check_dma_source("pipe.cu", fx.PIPE_GOOD) == []
    found = kernel_check.check_dma_source("pipe.cu", fx.PIPE_BAD)
    msgs = " ".join(f.message for f in found)
    assert {f.check for f in found} == {"CHK-DMA"} and len(found) == 2
    assert "'ready' recorded but never waited" in msgs and "[nxt]" in msgs
    assert kernel_check.check_dma() == []


# ---------------------------------------------------------- suppressions --

def test_noqa_suppresses_with_justification():
    f = Finding("CHK-X", ERROR, "mem.py", 2, "boom")
    out = apply_suppressions(
        [f], {"mem.py": ["# repro: noqa[CHK-X] known benign", "code()"]})
    assert out[0].suppressed and out[0].justification == "known benign"


def test_noqa_without_justification_is_a_finding():
    f = Finding("CHK-X", ERROR, "mem.py", 2, "boom")
    out = apply_suppressions(
        [f], {"mem.py": ["# repro: noqa[CHK-X]", "code()"]})
    assert out[0].check == "CHK-NOQA" and not out[0].suppressed


def test_noqa_other_id_does_not_suppress():
    f = Finding("CHK-X", ERROR, "mem.py", 2, "boom")
    out = apply_suppressions(
        [f], {"mem.py": ["# repro: noqa[CHK-Y] wrong check", "code()"]})
    assert not out[0].suppressed and out[0].check == "CHK-X"


SOURCES = {
    "same-line": (["x = 1  # repro: noqa[CHK-A] fine here"], 1),
    "above": (["# repro: noqa[CHK-A] the reason", "x = 1"], 2),
    "continued": (["# repro: noqa[CHK-A] a reason", "#   goes on", "x = 1"],
                  3),
    "two-ids": (["# repro: noqa[CHK-B, CHK-A] both", "x = 1"], 2),
    "bare": (["# repro: noqa[CHK-A]", "x = 1"], 2),
    "code-between": (["# repro: noqa[CHK-A] far", "y = 2", "x = 1"], 3),
    "other-id": (["# repro: noqa[CHK-B] not this one", "x = 1"], 2),
}


@pytest.mark.parametrize("case", sorted(SOURCES))
def test_apply_suppressions_matches_jax(case):
    """The port's copy of the protocol resolves every directive as the
    JAX package's does on the same source lines."""
    lines, at = SOURCES[case]
    got = apply_suppressions([Finding("CHK-A", ERROR, "f.py", at, "m")],
                             {"f.py": lines})
    want = jax_suppress([JaxFinding("CHK-A", ERROR, "f.py", at, "m")],
                        {"f.py": lines})
    assert [(f.check, f.suppressed, f.justification, f.line)
            for f in got] == [(f.check, f.suppressed, f.justification,
                               f.line) for f in want]


# ------------------------------------------------------------------ lint --

def test_sync_in_round_fn_caught():
    """The counterpart of CHK-TRACER: a branch on a tensor, ``.item()``
    and ``float()`` of a tensor in a round function."""
    found = lint._check_sync("<fx>", ast.parse(fx.SYNC_BAD))
    assert len(found) == 3
    assert {f.check for f in found} == {"CHK-SYNC"}


def test_sync_static_tests_allowed():
    assert lint._check_sync("<fx>", ast.parse(fx.SYNC_GOOD)) == []


def test_tree_dataclass_positive_negative():
    """The counterpart of CHK-PYTREE: a dataclass with tensor fields is
    flagged, one of plain numbers is not."""
    found = lint._check_tree([(fx, fx.CarriesTensors),
                              (fx, fx.CarriesNumbers)])
    assert [f.check for f in found] == ["CHK-TREE"]
    assert "CarriesTensors" in found[0].message


def test_lint_flags_known_host_records_only():
    """The port's host-side records are flagged (and suppressed in the
    tree); no round function reads the card on the host."""
    found = lint.run()
    tree = {f.message.split()[1] for f in found if f.check == "CHK-TREE"}
    assert {"FitResult", "FleetResult", "TensorSpec"} <= tree
    assert not any(f.check == "CHK-SYNC" for f in found)
    assert all(f.suppressed for f in apply_suppressions(found))


def test_static_check_has_no_counterpart():
    """CHK-STATIC guards jax.jit's cache; the port has none (ROADMAP
    C39).  Every other JAX check has a counterpart in the catalog."""
    from repro.analysis import CHECKS as JAX_CHECKS
    mapped = {v[3] for v in CHECKS.values()}
    assert set(JAX_CHECKS) - mapped == {"CHK-STATIC"}
    assert "CHK-STATIC" not in CHECKS


# ----------------------------------------------------------------- spans --

def test_span_positive_negative():
    bad = obs_check._check_function(
        "<fx>", ast.parse(fx.SPAN_BAD).body[0])
    assert {f.check for f in bad} == {"CHK-SPAN"} and len(bad) == 2
    good = obs_check._check_function(
        "<fx>", ast.parse(fx.SPAN_GOOD).body[0])
    assert good == [] and obs_check.run() == []


# ------------------------------------------------------ collective census --

@pytest.mark.parametrize("prim", sorted(COLLECTIVE_PRIMS))
def test_every_collective_prim_counted(prim):
    """Each primitive the mesh makes is a census site with its axis, its
    executions the calls made there (three in a loop of three)."""
    mesh = Mesh((1, 1))
    t = torch.ones(4, 2)
    call = {"all-reduce": lambda: mesh.all_reduce(t, "model"),
            "all-gather": lambda: mesh.all_gather(t, "model", 0),
            "reduce-scatter": lambda: mesh.reduce_scatter(t, "model", 0)}

    def once():
        call[prim]()

    def thrice():
        for _ in range(3):
            call[prim]()

    census = collective_census(once)
    assert [(u.prim, u.axes, u.executions) for u in census] == \
        [(prim, ("model",), 1)]
    census = collective_census(thrice)
    assert [(u.prim, u.axes, u.executions) for u in census] == \
        [(prim, ("model",), 3)]
    assert count_collective_executions(census) == 3


def test_census_counts_real_while_trips():
    """A while loop counts by its real trip count (the JAX census counts
    a while body once; ROADMAP C38)."""
    mesh = Mesh((1, 1))

    def f():
        c, k = torch.zeros(()), 0
        while k < 7:
            c = c + mesh.all_reduce(torch.ones(()), "model")
            k += 1

    census = collective_census(f)
    assert count_collective_executions(census) == 7
    assert all(u.axes == ("model",) for u in census)


# ------------------------------------------------------------ comm audit --

def test_comm_audit_full_matrix_clean():
    """For the four solvers x {1d, 2d} x {linear, rbf}, the collectives
    run equal the modeled schedule, and s-step makes 1/s as many."""
    assert comm_check.audit() == []


@pytest.mark.parametrize("problem,layout", sorted(comm_check.SOLVERS))
def test_sstep_executions_are_classical_over_s(problem, layout):
    for kernel in comm_check.KERNEL_NAMES:
        setup = setup_collectives(layout, kernel)
        cl = comm_check.expected_executions(
            comm_check.CommCase(problem, layout, "classical", kernel))
        ss = comm_check.expected_executions(
            comm_check.CommCase(problem, layout, "sstep", kernel))
        assert (cl - setup) == comm_check.S * (ss - setup)


def test_extra_all_reduce_fails_the_count(monkeypatch):
    """An extra all-reduce in every round (each round reduction made
    twice) trips CHK-COMM; the real code does not."""
    case = comm_check.CommCase("krr", "1d", "sstep", "linear")
    assert comm_check.audit_case(case) == []
    real = Mesh.all_reduce

    def twice(self, t, axis, kind="round", **kw):
        if kind == "round":
            real(self, t, axis, kind, **kw)
        return real(self, t, axis, kind, **kw)

    monkeypatch.setattr(Mesh, "all_reduce", twice)
    found = comm_check.audit_case(case)
    assert [f.check for f in found] == ["CHK-COMM"]


def test_unknown_axis_name_caught():
    case = comm_check.CommCase("ksvm", "1d", "classical", "linear")
    census = comm_check.trace_case(case)
    renamed = tuple(u._replace(axes=("ring",)) for u in census)
    found = comm_check.audit_case(case, renamed)
    assert "CHK-AXIS" in {f.check for f in found}


# ------------------------------------------------------------- CHK-CARRY --

def test_guard_check_accepts_real_carries():
    assert guard_check.run() == []


def test_guard_check_flags_blind_predicate(monkeypatch):
    """A predicate that reads only the first carry leaf misses the rest:
    one finding a family, anchored at the factory's def line."""
    monkeypatch.setattr(guard_check, "finite_health",
                        lambda state: torch.isfinite(state[0]).all())
    found = guard_check.run()
    assert len(found) == 4
    assert all(f.check == "CHK-CARRY" and f.severity == ERROR
               for f in found)
    assert all(f.line > 0 and f.path.endswith(".py") for f in found)


def test_guard_check_flags_rejecting_predicate(monkeypatch):
    monkeypatch.setattr(guard_check, "finite_health",
                        lambda state: torch.tensor(False))
    found = guard_check.run()
    assert len(found) == 4
    assert all("rejects a finite" in f.message for f in found)


# -------------------------------------------------------------- the gate --

def test_torch_tree_is_clean_under_full_analysis():
    findings = run_all()
    active = [f for f in findings if not f.suppressed]
    assert active == [], [f.format() for f in active]
    assert all(f.justification for f in findings if f.suppressed)


def test_cli_lists_checks_and_exits_clean(capsys):
    assert main(["--list-checks"]) == 0
    listed = capsys.readouterr().out
    assert all(check in listed for check in CHECKS)
    assert main(["--only", "obs", "--only", "lint", "--json"]) == 0
