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
takes any chunk (ROADMAP C8).  Only the serial layout runs
here (``layout="auto"`` resolves to it; the 1d and 2d layouts are ROADMAP
A11).  On the card a probe fit's rounds replay as CUDA graphs, so its
``measured_s`` is the device time of the replays, from CUDA events
around them: the warm-up round and the captures, which a fit of a few
rounds would otherwise be ranked by, are excluded, and each probe row
records them (``wall_s``, ``capture_s``, ``warmup_s``).  On the CPU (and
for a streamed probe, whose rounds stay eager) the probe fit runs twice
and the second call's wall is the measurement, as in the JAX package.

The chosen plan is a ``TunedPlan`` (resolved options, the winner's
modeled cost, the searched frontier) and lands on ``FitResult.plan``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import torch

from repro_torch.core.perf_model import (STREAM_CHUNK_CANDIDATES,
                                         DeviceBudget, Machine,
                                         choose_chunk_rows,
                                         modeled_fit_cost, slab_fits_hbm)
from repro_torch.device import resolve_device

S_CANDIDATES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
B_CANDIDATES = (1, 2, 4, 8, 16, 32, 64)
PROBE_TOP_K = 3
LAYOUTS = ("serial",)


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


def resolve_options(m: int, n: int, cfg, opts, *, problem: str = "krr",
                    A=None, y=None, mach: Machine = None,
                    budget: Optional[DeviceBudget] = None,
                    device=None) -> TunedPlan:
    """Resolve every ``"auto"`` knob of ``opts`` for an (m, n) problem
    (module docstring).  ``budget`` defaults to
    ``DeviceBudget.of_device(device)`` (``device`` defaults to the card);
    ``A``/``y`` enable the measured probe when ``opts.probe > 0``."""
    from repro_torch.api import AUTO

    if not opts.needs_autotune:
        return TunedPlan(options=opts,
                         modeled=_price(m, n, cfg, opts, problem, mach),
                         frontier=())
    if budget is None:
        budget = DeviceBudget.of_device(resolve_device(device))

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
        lay_cands = LAYOUTS
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
                        iters=opts.max_iters, P=1, mach=mach, approx=ap,
                        landmarks=lm)
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
        winner = min(probed, key=lambda p: p["measured_s"])
    else:
        winner = feas[0]

    resolved = dataclasses.replace(
        opts, s=winner["s"], b=winner["b"], layout=winner["layout"],
        approx=winner["approx"])
    if resolved.stream == AUTO:
        resolved = dataclasses.replace(resolved, stream=_chunk_rows(
            m, n, winner["s"] * winner["b"], cfg.kernel.name, mach, budget))
    return TunedPlan(options=resolved,
                     modeled=_price(m, n, cfg, resolved, problem, mach),
                     frontier=tuple(frontier),
                     probed=None if probed is None else tuple(probed),
                     budget=budget)


def _price(m, n, cfg, opts, problem, mach):
    s = opts.s_eff if opts.s != "auto" or opts.method != "sstep" else 1
    b = opts.b if (problem == "krr" and isinstance(opts.b, int)) else 1
    lm = min(opts.landmarks, m) if opts.approx else 0
    return modeled_fit_cost(m, n, cfg.kernel.name, b=b, s=s,
                            iters=opts.max_iters, P=1, mach=mach,
                            approx=opts.approx, landmarks=lm)


def _probe(A, y, cfg, opts, problem, candidates, mach, budget, device):
    """Measured refinement (module docstring): ``opts.probe`` outer rounds
    of each top candidate through the real facade solver (budget
    stopping, no metric)."""
    from repro_torch.api import AUTO, _fit

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
            stream=stream, max_iters=max(opts.probe * s_eff, 1))
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
    return rows
