"""Perf-model-driven autotuner for (s, b, layout, approx, stream) — the
counterpart of ``repro/tune/autotune.py``.

``resolve_options`` turns ``SolverOptions`` knobs left at ``"auto"`` into
concrete choices:

  1. enumerate the candidate grid over exactly the auto knobs (pinned
     knobs are respected verbatim);
  2. drop infeasible points — s*b whose slab working-set bound
     (``perf_model.slab_fits_hbm``, the constraint ``best_s`` enforces)
     exceeds the device-memory budget, b > m, s > max_iters;
  3. price every survivor with ``perf_model.modeled_fit_cost`` (exact
     rounds at data width, low-rank rounds at landmark width plus the
     one-time ``lowrank_setup_cost``);
  4. optionally refine by measurement (``options.probe > 0``): the top
     modeled candidates each run ``probe`` outer rounds through the real
     solver and the fastest measured one wins.

The grid, the feasibility rule, the ordering and the tie-breaks are the
JAX package's.  What differs is where the numbers come from.  The budget
is a ``perf_model.DeviceBudget``: by default the free memory of the card
at tune time, a share of it for a streamed working set of three chunk
slots, the measured host link, and chunks no smaller than fill the card,
where the JAX package assumes 16 GiB, a 16 MiB VMEM and 800 GB/s and
takes any chunk (ROADMAP C8).  ``layout="auto"`` searches the serial
layout alone at a world size of 1, and the serial, 1d and 2d layouts
(2d where the world size divides m) over the ranks of ``options.mesh``
or of the initialised default group, each priced at its P, as the JAX
package searches its devices.  Every rank of such a run tunes alike:
rank 0's budget and probe times are sent to every rank, so all of them
resolve the same plan and call the same (collective) probe fits.  On
the card a probe fit's rounds replay as CUDA graphs, so its
``measured_s`` is the device time of the replays, from CUDA events
around them: the warm-up round and the captures, which a fit of a few
rounds would otherwise be ranked by, are excluded, and each probe row
records them (``wall_s``, ``capture_s``, ``warmup_s``).  On the CPU (and
for a streamed probe, whose rounds stay eager) the probe fit runs twice
and the second call's wall is the measurement, as in the JAX package.

The chosen plan is a ``TunedPlan`` (resolved options, the winner's
modeled cost, the searched frontier) and lands on ``FitResult.plan``.
A guarded fit's ``recompute_every="auto"`` resolves for the winner
(``perf_model.choose_recompute_every``), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import torch

from repro_torch.core.perf_model import (STREAM_CHUNK_CANDIDATES,
                                         DeviceBudget, Machine,
                                         choose_chunk_rows,
                                         choose_recompute_every,
                                         modeled_fit_cost, slab_fits_hbm)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh, world_size

S_CANDIDATES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
B_CANDIDATES = (1, 2, 4, 8, 16, 32, 64)
PROBE_TOP_K = 3
LAYOUTS = ("serial", "1d", "2d")


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """What the autotuner decided and why: ``options`` has every knob
    concrete; ``modeled`` is the winner's ``modeled_fit_cost`` breakdown;
    ``frontier`` records every candidate searched (config, modeled time,
    feasibility); ``probed`` the measured refinement rows when
    ``probe > 0`` ran; ``budget`` the ``DeviceBudget`` it tuned within
    (None when no knob was "auto")."""

    options: object                # resolved SolverOptions
    modeled: dict
    frontier: Tuple[dict, ...]
    probed: Optional[Tuple[dict, ...]] = None
    budget: Optional[DeviceBudget] = None

    @property
    def choice(self) -> dict:
        o = self.options
        return {"s": o.s, "b": o.b, "layout": o.layout, "approx": o.approx}


def _chunk_rows(m: int, n: int, sb: int, kernel: str, mach,
                budget: DeviceBudget) -> int:
    """``stream="auto"``: the modeled best chunk size within the budget's
    streamed working set and link rate, among the candidates of at least
    ``budget.min_chunk_rows`` rows (the largest if none is)."""
    cands = tuple(cr for cr in STREAM_CHUNK_CANDIDATES
                  if cr >= budget.min_chunk_rows)
    return choose_chunk_rows(m, n, sb, kernel, mach=mach,
                             dma_bps=budget.dma_bps,
                             budget_bytes=budget.stream_bytes,
                             slots=budget.slots,
                             candidates=cands or STREAM_CHUNK_CANDIDATES[-1:])


def _ranks(opts) -> int:
    """The ranks a distributed layout would run over: the user's mesh, or
    the initialised default group."""
    return opts.mesh.size if opts.mesh is not None else world_size()


def _layout_P(layout: str, ndev: int) -> int:
    return 1 if layout == "serial" else max(ndev, 1)


def _tuning_mesh(opts, ndev: int):
    """The mesh over which ranks agree on the plan (None at one rank)."""
    if ndev == 1:
        return None
    return opts.mesh if opts.mesh is not None else make_mesh(ndev, 1)


def _agreed_budget(mesh, budget: DeviceBudget) -> DeviceBudget:
    """Rank 0's budget on every rank (one collective): each rank measures
    its own free memory and link, and ranks that tuned apart could pick
    different plans and then call different collectives."""
    t = torch.tensor([budget.hbm_bytes, budget.stream_bytes,
                      budget.dma_bps, budget.slots, budget.min_chunk_rows],
                     dtype=torch.float64)
    v = mesh.root_value(t.to(_device_of(mesh)), "setup").tolist()
    return DeviceBudget(int(v[0]), int(v[1]), v[2], slots=int(v[3]),
                        min_chunk_rows=int(v[4]))


def _device_of(mesh) -> torch.device:
    """Where the tuning mesh's reductions run: the card for NCCL."""
    import torch.distributed as dist
    return (torch.device("cuda") if dist.get_backend() == "nccl"
            else torch.device("cpu"))


def resolve_options(m: int, n: int, cfg, opts, *, problem: str = "krr",
                    A=None, y=None, mach: Machine = None,
                    budget: Optional[DeviceBudget] = None,
                    device=None, layouts=None) -> TunedPlan:
    """Resolve every ``"auto"`` knob of ``opts`` for an (m, n) problem
    (module docstring).  ``budget`` defaults to
    ``DeviceBudget.of_device(device)`` (``device`` defaults to the card);
    ``A``/``y`` enable the measured probe when ``opts.probe > 0``;
    ``layouts`` restricts the layout search (the fleet passes the layouts
    it runs)."""
    from repro_torch.api import AUTO

    ndev = _ranks(opts)
    if not opts.needs_autotune:
        return TunedPlan(options=opts,
                         modeled=_price(m, n, cfg, opts, problem, mach,
                                        ndev),
                         frontier=())
    mesh = _tuning_mesh(opts, ndev)
    if budget is None:
        budget = DeviceBudget.of_device(resolve_device(device))
        if mesh is not None:
            budget = _agreed_budget(mesh, budget)

    if opts.method != "sstep":
        s_cands = (1,)
    elif opts.s == AUTO:
        s_cands = tuple(s for s in S_CANDIDATES if s <= opts.max_iters)
    else:
        s_cands = (opts.s,)
    if problem != "krr":
        b_cands = (1,)
    elif opts.b == AUTO:
        b_cands = tuple(b for b in B_CANDIDATES if b <= m)
    else:
        b_cands = (opts.b,)
    if opts.layout == AUTO:
        lay_cands = ("serial",) if ndev == 1 else LAYOUTS
        if layouts is not None:
            lay_cands = tuple(lay for lay in lay_cands if lay in layouts)
        # the 2d layout shards samples: m must divide by the data axis
        # (the auto mesh puts every rank on it)
        lay_cands = tuple(lay for lay in lay_cands
                          if lay != "2d" or m % ndev == 0)
    else:
        lay_cands = (opts.layout,)
    if opts.approx == AUTO:
        # a rank >= m "approximation" is strictly more work than exact
        ap_cands = (None, "nystrom") if opts.landmarks < m else (None,)
    else:
        ap_cands = (opts.approx,)
    if opts.stream is not None:
        # the streamed representation is serial and exact by construction
        lay_cands, ap_cands = ("serial",), (None,)

    frontier = []
    for lay in lay_cands:
        for ap in ap_cands:
            lm = min(opts.landmarks, m)
            for b in b_cands:
                for s in s_cands:
                    # the KMV working-set bound of perf_model.best_s (s = 1
                    # is the classical floor); a streamed run has no
                    # m-tall working set — the ceiling streaming removes
                    feasible = (opts.stream is not None or s == 1
                                or slab_fits_hbm(m, s * b, budget.hbm_bytes))
                    cost = modeled_fit_cost(
                        m, n, cfg.kernel.name, b=b, s=s,
                        iters=opts.max_iters, P=_layout_P(lay, ndev),
                        mach=mach, approx=ap, landmarks=lm)
                    frontier.append({"s": s, "b": b, "layout": lay,
                                     "approx": ap, "time": cost["time"],
                                     "feasible": feasible})
    feas = [f for f in frontier if f["feasible"]]
    if not feas:
        # only reachable with s (and/or b) PINNED above the budget: the
        # remaining auto knobs resolve toward the smallest working set
        feas = sorted(frontier, key=lambda f: (f["s"] * f["b"], f["time"]))
    else:
        feas.sort(key=lambda f: (f["time"], f["s"], f["b"]))

    probed = None
    if opts.probe > 0 and A is not None and y is not None:
        probed = _probe(A, y, cfg, opts, problem, feas[:PROBE_TOP_K],
                        mach, budget, resolve_device(device))
        if mesh is not None:
            # rank 0's times: every rank picks the same winner
            t = torch.tensor([p["measured_s"] for p in probed],
                             dtype=torch.float64)
            for p, v in zip(probed, mesh.root_value(
                    t.to(_device_of(mesh)), "setup").tolist()):
                p["measured_s"] = v
        winner = min(probed, key=lambda p: p["measured_s"])
    else:
        winner = feas[0]

    resolved = dataclasses.replace(
        opts, s=winner["s"], b=winner["b"], layout=winner["layout"],
        approx=winner["approx"])
    if resolved.stream == AUTO:
        resolved = dataclasses.replace(resolved, stream=_chunk_rows(
            m, n, winner["s"] * winner["b"], cfg.kernel.name, mach, budget))
    if resolved.guard and resolved.recompute_every == AUTO:
        # drift correction priced for the winner's (s, b): the cadence
        # that keeps the guarded overhead within the model's budget; the
        # distributed layouts recompute from alpha every round, so their
        # correction is off
        resolved = dataclasses.replace(
            resolved, recompute_every=choose_recompute_every(
                m, n, cfg.kernel.name,
                b=winner["b"] if problem == "krr" else 1, s=winner["s"],
                mach=mach, approx=bool(winner["approx"]),
                landmarks=(min(opts.landmarks, m) if winner["approx"]
                           else 0)) if winner["layout"] == "serial" else 0)
    return TunedPlan(options=resolved,
                     modeled=_price(m, n, cfg, resolved, problem, mach,
                                    ndev),
                     frontier=tuple(frontier),
                     probed=None if probed is None else tuple(probed),
                     budget=budget)


def _price(m, n, cfg, opts, problem, mach, ndev):
    s = opts.s_eff if opts.s != "auto" or opts.method != "sstep" else 1
    b = opts.b if (problem == "krr" and isinstance(opts.b, int)) else 1
    lm = min(opts.landmarks, m) if opts.approx else 0
    return modeled_fit_cost(m, n, cfg.kernel.name, b=b, s=s,
                            iters=opts.max_iters,
                            P=_layout_P(opts.layout, ndev), mach=mach,
                            approx=opts.approx, landmarks=lm)


def _probe(A, y, cfg, opts, problem, candidates, mach, budget, device):
    """Measured refinement (module docstring): ``opts.probe`` outer rounds
    of each top candidate through the real facade solver (budget
    stopping, no metric).  Probe fits run with ``telemetry=None``: their
    spans belong to the tuner, not to the fit being tuned; the tuned
    fit's handle, when it has one, counts each probe instead."""
    from repro_torch.api import AUTO, _active_tel, _fit

    tel = _active_tel(opts)
    rows = []
    for cand in candidates:
        s_eff = cand["s"] if opts.method == "sstep" else 1
        stream = opts.stream
        if stream == AUTO:          # concretize per candidate so the
            m, n = A.shape          # probe fit needs no re-tuning
            stream = _chunk_rows(m, n, cand["s"] * cand["b"],
                                 cfg.kernel.name, mach, budget)
        probe_opts = dataclasses.replace(
            opts, s=cand["s"], b=cand["b"], layout=cand["layout"],
            approx=cand["approx"], tol=0.0, record=False, probe=0,
            stream=stream, max_iters=max(opts.probe * s_eff, 1),
            telemetry=None)
        stats = {}
        t0 = time.perf_counter()
        _fit(problem, A, y, cfg, probe_opts, device, stats=stats)
        wall = time.perf_counter() - t0
        row = dict(cand, wall_s=wall, capture_s=stats.get("capture_s"),
                   warmup_s=stats.get("warmup_s"))
        if stats.get("replay_s") is not None:
            row["measured_s"] = stats["replay_s"]
        else:                       # the first call paid the builds
            t0 = time.perf_counter()
            _fit(problem, A, y, cfg, probe_opts, device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            row["measured_s"] = time.perf_counter() - t0
        rows.append(row)
        if tel is not None:
            tel.metrics.counter(
                "repro_autotune_probes_total",
                "measured autotune probes run").inc(
                    layout=cand["layout"])
    return rows
