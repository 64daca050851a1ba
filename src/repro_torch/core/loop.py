"""Shared round-protocol loop for the solvers (the counterpart of
``repro/core/loop.py``).

Every solver is a state (alpha), a per-round transition
``round_fn(state, xs_k) -> state`` and a schedule of per-round data
``xs``.  ``run_rounds`` drives them:

  * fast path (``metric_fn=None``): every round, optionally stacking
    per-round states (the ``lax.scan`` of the JAX package);
  * tolerance path (``metric_fn`` given): evaluates ``metric_fn(state)``
    every ``check_every`` rounds and at the final round, records it into
    a fixed-size history, and stops once the metric falls to ``tol``
    (the ``lax.while_loop``).  The metric is read on the host only at
    those checks; rounds in between never synchronise.

The reference compiles both with ``jax.jit``; here ``RoundGraphs`` is the
compiled driver.  It splits the rounds into runs of ``c`` and captures a
run as one CUDA graph over static buffers: the state, which the graph
reads and overwrites in place, and the run's slice of ``xs``, copied in
before each replay.  On the tolerance path a run is the ``check_every``
rounds up to a check, and its graph ends in the check's metric, so the
host reads one value per check.  The graphs replay the round functions'
own launches (the KMV and gram kernels among them) in the eager order,
so their iterates equal the eager loop's bit for bit.  On the CPU the
same runs over the same buffers execute eagerly.  An operator whose
round cannot be captured (``GramOperator.capturable`` is False: the
streamed pipe's cross-stream copies) takes the eager loop,
``_run_rounds_eager``, through ``run_rounds(capture=False)``.

``run_rounds_fleet`` drives F problems of one schedule in lockstep (a
fleet, ``tune.fleet``): an (F, m) state, a per-member metric, and a
per-member ``done`` mask that freezes converged members; on the card its
runs replay through the same ``RoundGraphs``, the mask a static device
buffer the captured checks update.

``run_rounds(guard=GuardSpec(...))`` is the guarded driver (the JAX
package's ``_run_rounds_guarded``, ``resilience``): the state is the
guarded carry ``(alpha, f)``; a health check after every round discards
an unhealthy round's update and freezes on the last good state, stamping
the first bad round; every ``correct_every`` rounds the residual is
replaced by an exact recompute and its drift recorded; a checked metric
that is not finite or exceeds ``metric_blowup`` times the best so far
stops the run too.  The cadences count from the start of the call, as
the reference's count from the start of its segment (ROADMAP C10).  On
the card it runs through ``GuardedRoundGraphs``: runs end at every check
and correction, the freeze is a device flag and ``torch.where`` (a run
replays to its end, later rounds keeping the frozen state), a run ending
in a correction keeps the corrected state only while the flag holds, and
the host reads one small status tensor a run.
``_run_rounds_guarded_eager`` is the same steps in the same order with a
host check a round, the route of an operator that cannot be captured
and the reference the graphs are held to bit for bit.

``marks=True`` (a fit with telemetry, ``repro_torch.obs``) marks the
sync points the reference marks: each tolerance check as a
``metric_check`` span and each guarded correction as a
``drift_correction`` span, recorded into the active ``Telemetry``.  The
captured drivers then capture the check and the correction as graphs of
their own, replayed after the rounds' graph, and record CUDA events
between the replays, so a span is the device time of its check or
correction; the kernels, their order and so the bits are those of the
unmarked run, and each graph's launches are counted as before.  The
eager drivers record the marks around the calls themselves.  The fast
path has no sync point and carries no mark; ``marks=False`` changes
nothing.

``pad_rounds`` pads a ragged schedule to whole s-step rounds with a
validity mask, so the final short round makes exactly-zero updates.
"""
from __future__ import annotations

import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from repro_torch.device import as_tensor

NO_TOL = float("-inf")        # sentinel: record the metric, never stop early

# LoopResult.diverged_kind codes (0 = healthy throughout)
DIVERGED_NONE = 0
DIVERGED_NONFINITE = 1        # round_fn produced a non-finite carry leaf
DIVERGED_METRIC = 2           # metric went non-finite or blew up vs best

# Rounds a graph of the fast path holds.  A capture runs the rounds' Python
# once, so it costs the host about what the same rounds cost eagerly, and
# the graph's instantiation and first upload grow with its nodes (~780 a
# K-SVM s = 32 round): 64 such rounds took 1.0 s to capture on an H100's
# host, more than the whole eager fit of 128 rounds.  A replay costs the
# host ~0.3 ms (the schedule copy and the launch), which must stay below
# the run's device time so that the card never waits: 8 classical rounds
# take 2.2 ms there.  8 rounds keep both small.
FAST_RUN = 8

Rounds = Union[torch.Tensor, Sequence[torch.Tensor]]

# the keys of a marked driver's check and correction graphs, and the
# names of their spans
CHECK = "metric_check"
CORRECT = "drift_correction"


class GuardSpec(NamedTuple):
    """Guard hooks for ``run_rounds`` (``resilience``).

    health_fn:      state -> 0-dim bool tensor, True = healthy; runs on
                    the full post-round carry every round, on the device.
    correct_fn:     state -> (corrected_state, drift): residual
                    replacement with the observed relative drift.
    correct_every:  cadence of ``correct_fn`` in rounds (0 = never).
    metric_blowup:  stop when a checked metric exceeds ``metric_blowup``
                    times the best so far (inf disables).
    """

    health_fn: Callable
    correct_fn: Optional[Callable] = None
    correct_every: int = 0
    metric_blowup: float = 1e4


class LoopResult(NamedTuple):
    """Output of ``run_rounds``.

    state:       final solver state (alpha).
    state_hist:  per-round stacked states (fast path + record_state) or
                 None.
    metric_hist: (n_check_slots,) metric values (tolerance path; only the
                 first ``checks_run`` slots were evaluated) or None; a
                 fleet's is (n_check_slots, F).
    checks_run:  number of metric evaluations performed.
    rounds_run:  number of rounds executed.
    converged:   metric <= tol at some check; a fleet's is an (F,) bool
                 tensor, member by member.

    Guarded runs only (None otherwise):

    drift_hist:     (n_corrections,) relative drift at each residual
                    replacement (the first ``corrections`` evaluated), or
                    None without a correction cadence.
    corrections:    number of drift corrections performed.
    diverged_round: index of the first unhealthy round, or -1; on a
                    non-finite divergence ``state`` is the last good
                    (pre-round) carry.
    diverged_kind:  DIVERGED_NONE / DIVERGED_NONFINITE / DIVERGED_METRIC.
    """

    state: Any
    state_hist: Optional[torch.Tensor]
    metric_hist: Optional[torch.Tensor]
    checks_run: int
    rounds_run: int
    converged: bool
    drift_hist: Optional[torch.Tensor] = None
    corrections: Optional[int] = None
    diverged_round: Optional[int] = None
    diverged_kind: Optional[int] = None

    def metric_history(self) -> Optional[torch.Tensor]:
        """The evaluated prefix ``metric_hist[:checks_run]``, or None when
        no metric was recorded (fast path)."""
        if self.metric_hist is None:
            return None
        return self.metric_hist[:self.checks_run]

    def drift_history(self) -> Optional[torch.Tensor]:
        """The evaluated prefix ``drift_hist[:corrections]``, or None
        when the run was unguarded or had no correction cadence."""
        if self.drift_hist is None:
            return None
        return self.drift_hist[:self.corrections]


def pad_rounds(schedule: torch.Tensor, s: int):
    """Reshape an (H, ...) schedule into ((R, s, ...), (R, s)) rounds plus
    validity mask with R = ceil(H/s); padded slots carry index 0 and
    valid 0.0, so the masked round functions make them exact no-ops."""
    H = schedule.shape[0]
    R = -(-H // s)
    pad = R * s - H
    if pad:
        schedule = torch.cat([schedule, schedule.new_zeros(
            (pad,) + tuple(schedule.shape[1:]))])
    valid = (torch.arange(R * s, device=schedule.device) < H).to(
        torch.float32)
    return (schedule.reshape((R, s) + tuple(schedule.shape[1:])),
            valid.reshape(R, s))


def _n_rounds(xs: Rounds) -> int:
    return (xs if isinstance(xs, torch.Tensor) else xs[0]).shape[0]


def _round(xs: Rounds, k: int):
    if isinstance(xs, torch.Tensor):
        return xs[k]
    return tuple(x[k] for x in xs)


def _counted():
    """The counted kernel wrappers a captured round or check launches."""
    from repro_torch.kernels import ops   # ops imports core.kernels
    return ops.CAPTURED


def _counters():
    """``(wrapper, counter, name)`` of every launch counter of the
    captured wrappers: ``launches``, and ``launches_f64`` (the f64
    route's share) where a wrapper has one."""
    return [(fn, attr, fn.__name__ + ("" if attr == "launches"
                                      else "." + attr))
            for fn in _counted()
            for attr in ("launches", "launches_f64") if hasattr(fn, attr)]


def _launches():
    return [getattr(fn, attr) for fn, attr, _ in _counters()]


def _take_launches(before, into: str = "") -> Dict[str, int]:
    """Take the launches counted since ``before`` back off each counter
    (adding a wrapper's ``launches`` to its ``into`` counter, if named);
    returns them by counter name (the wrapper's for ``launches``)."""
    taken = {}
    for (fn, attr, name), b in zip(_counters(), before):
        d = getattr(fn, attr) - b
        setattr(fn, attr, b)
        if into and attr == "launches":
            setattr(fn, into, getattr(fn, into) + d)
        taken[name] = d
    return taken


class RoundGraphs:
    """The rounds of ``xs`` in runs of ``run_len``, each run replayed as
    one captured CUDA graph (module docstring).

    ``state`` is the static state buffer every run reads and overwrites;
    ``run(j)`` copies run j's slice of ``xs`` into the static schedule
    buffer and replays the graph of its length (the ``run_len`` one, or
    the tail's when ``run_len`` does not divide the rounds), returning
    the metric's static output, or None without ``metric_fn``.  With
    ``record_state`` the graph also writes each round's state into
    ``rec``, a static (run_len, ...) buffer.

    On the card the constructor runs one round (and the metric) eagerly
    on a scratch copy of the state, so that every kernel is built and
    every library handle made before a capture, then captures the graphs
    into one memory pool, which ``close`` releases.  The kernel wrappers
    in ``kernels.ops.CAPTURED`` count a launch when their Python runs,
    which for a graph is once, at capture: the capture's counts are taken
    back and each replay adds them, so ``launches`` stays the number of
    kernel launches made; the warm-up's go to ``warmup_launches``.  A
    round that synchronises with the host cannot be captured: the capture
    raises, and nothing runs it eagerly instead.  On the CPU the runs
    execute eagerly over the same buffers.

    Attributes read after construction: ``capture_s`` (seconds of the
    captures, instantiation included), ``warmup_s``, ``pool_bytes``
    (device memory the captures reserved) and ``graph_launches`` (each
    graph's launches a replay, by run length and wrapper name).  With
    ``timed``, CUDA events bracket every replay, and ``replay_s()`` sums
    their device seconds.  With ``marks`` the check is a graph of its own
    (key ``CHECK``), replayed after the run's rounds between the two
    events of its ``metric_check`` span (module docstring).
    """

    def __init__(self, round_fn: Callable, state0: torch.Tensor,
                 xs: Rounds, run_len: int, *,
                 metric_fn: Optional[Callable] = None,
                 record_state: bool = False, timed: bool = False,
                 marks: bool = False):
        R = _n_rounds(xs)
        if not 1 <= run_len <= R:
            raise ValueError(f"run_len must be in [1, {R}] for "
                             f"{R} rounds, got {run_len}")
        runs = [(lo, min(run_len, R - lo)) for lo in range(0, R, run_len)]
        self._setup(round_fn, state0.clone(), xs,
                    [(lo, n, n) for lo, n in runs], metric_fn, timed, marks)
        self.c = run_len
        self.rec = (state0.new_empty((run_len,) + tuple(state0.shape))
                    if record_state else None)
        if self.on_card:
            self._capture(sorted({n for _, n in runs}, reverse=True)
                          + ([CHECK] if self.marks else []))

    def _setup(self, round_fn, state, xs, runs, metric_fn, timed, marks):
        """What every driver of runs shares: ``runs`` is the list of
        ``(first round, rounds, graph key)``; ``marks`` is kept only
        where there is a check or a correction to mark."""
        self.R = _n_rounds(xs)
        self.round_fn, self.metric_fn = round_fn, metric_fn
        # a guarded run's key is (rounds, ends in a correction, a check)
        self.marks = marks and (metric_fn is not None or any(
            isinstance(key, tuple) and key[1] for _, _, key in runs))
        self._runs = runs
        self.n_runs = len(runs)
        self._xs = (xs,) if isinstance(xs, torch.Tensor) else tuple(xs)
        self._single = isinstance(xs, torch.Tensor)
        self.state = state
        longest = max(n for _, n, _ in runs)
        self._xbuf = tuple(x.new_empty((longest,) + tuple(x.shape[1:]))
                           for x in self._xs)
        self.rec = None
        first = state if isinstance(state, torch.Tensor) else state[0]
        self.on_card = first.device.type == "cuda"
        self.capture_s = self.warmup_s = 0.0
        self.pool_bytes = 0
        self.graph_launches: Dict[Any, Dict[str, int]] = {}
        self._events = [] if timed and self.on_card else None
        self._graphs: Dict[Any, Any] = {}

    def run_len(self, j: int) -> int:
        """Rounds in run j."""
        return self._runs[j][1]

    def _x(self, k: int):
        if self._single:
            return self._xbuf[0][k]
        return tuple(b[k] for b in self._xbuf)

    def _x0(self):
        """Round 0's slice of ``xs``, in the form the round takes."""
        x0 = tuple(x[0] for x in self._xs)
        return x0[0] if self._single else x0

    def _body(self, n: int):
        """n rounds over the static buffers, then the check's metric
        (unless the check is a graph of its own)."""
        state = self.state
        for k in range(n):
            state = self.round_fn(state, self._x(k))
            if self.rec is not None:
                self.rec[k].copy_(state)
        self.state.copy_(state)
        if self.metric_fn is None or self.marks:
            return None
        return self.metric_fn(self.state)

    def _graph_fn(self, key):
        """What the graph of ``key`` runs: a run's body, or the check."""
        if key == CHECK:
            return self.metric_fn(self.state)
        return self._body(key)

    def _warmup(self):
        """One round (and the check) on scratch copies of the state, so
        that every kernel is built and every library handle made before a
        capture."""
        scratch = self.round_fn(self.state.clone(), self._x0())
        if self.metric_fn is not None:
            self.metric_fn(scratch)

    def _capture(self, keys):
        dev = self._device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            t0 = time.perf_counter()
            before = _launches()
            self._warmup()
            _take_launches(before, "warmup_launches")
            side.synchronize()
            self.warmup_s = time.perf_counter() - t0
            pool = torch.cuda.graph_pool_handle()
            reserved = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            for key in keys:
                g = torch.cuda.CUDAGraph()
                before = _launches()
                g.capture_begin(pool=pool)
                try:
                    out = self._graph_fn(key)
                finally:
                    g.capture_end()
                self.graph_launches[key] = _take_launches(before)
                self._graphs[key] = (g, out)
            self.capture_s = time.perf_counter() - t0
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        torch.cuda.current_stream(dev).wait_stream(side)

    @property
    def _device(self) -> torch.device:
        return self._xbuf[0].device

    def run(self, j: int, refresh: bool = True):
        """Replay run j (execute it, on the CPU).  ``refresh=False`` skips
        the copy of its schedule slice, so the run repeats the previous
        run's coordinates: a wrong driver that checks must catch."""
        lo, n, key = self._runs[j]
        if refresh:
            for buf, x in zip(self._xbuf, self._xs):
                buf[:n].copy_(x[lo:lo + n])
        if self.marks:
            return self._run_marked(key)
        return self._replay(key)

    def _marked(self, name: str, key):
        """Replay the graph of ``key`` inside a ``name`` span."""
        from repro_torch.obs.spans import span_begin, span_end
        span_begin(name, device=self._device)
        out = self._replay(key)
        span_end(name, device=self._device)
        return out

    def _run_marked(self, key):
        """A run of a marked driver: its rounds, then its check."""
        self._replay(key)
        return self._marked(CHECK, CHECK)

    def _replay(self, key):
        """Replay the graph of ``key`` (execute it, on the CPU), counting
        its launches."""
        if not self.on_card:
            return self._graph_fn(key)
        g, out = self._graphs[key]
        if self._events is None:
            g.replay()
        else:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            g.replay()
            ev[1].record()
            self._events.append(ev)
        for fn, attr, name in _counters():
            setattr(fn, attr,
                    getattr(fn, attr) + self.graph_launches[key][name])
        return out

    def replay_s(self) -> Optional[float]:
        """Device seconds of the replays so far (``timed`` on the card),
        else None; synchronises."""
        if self._events is None:
            return None
        torch.cuda.synchronize(self._device)
        return sum(a.elapsed_time(b) for a, b in self._events) * 1e-3

    def stats(self) -> Dict[str, Any]:
        """What a caller timing the rounds reads: the replays' device
        seconds (``replay_s``, None unless ``timed`` on the card) and the
        capture and warm-up seconds they exclude."""
        return {"replay_s": self.replay_s(), "capture_s": self.capture_s,
                "warmup_s": self.warmup_s}

    def close(self):
        """Release the graphs and their memory pool (the state buffer,
        allocated outside the pool, stays valid)."""
        for g, _ in self._graphs.values():
            g.reset()
        self._graphs.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _guard_runs(R: int, check_every: int, has_metric: bool,
                correct_every: int) -> List[Tuple[int, int, bool, bool]]:
    """The runs of a guarded driver, ``(first round, rounds, ends in a
    correction, ends in a check)``: a run ends at every correction and
    every check (``check_every`` rounds and the last round, with a metric)
    and at least every ``FAST_RUN`` rounds without one."""
    step = check_every if has_metric else FAST_RUN
    ends = set(range(step, R, step)) | {R}
    if correct_every >= 1:
        ends |= set(range(correct_every, R + 1, correct_every))
    runs, lo = [], 0
    for e in sorted(ends):
        corr = correct_every >= 1 and e % correct_every == 0
        runs.append((lo, e - lo, corr,
                     has_metric and (e % check_every == 0 or e == R)))
        lo = e
    return runs


def _metric_verdict(v: float, dtype: torch.dtype, best, tol: float,
                    blowup: float):
    """``(bad, converged, best')`` of a checked metric value, compared in
    the metric's dtype as the reference's guarded check does: bad when
    not finite or above ``blowup`` times the best value so far."""
    cast = np.float64 if dtype == torch.float64 else np.float32
    v = cast(v)
    finite = bool(np.isfinite(v))
    blown = bool(np.isfinite(best)) and bool(v > cast(blowup) * best)
    conv = finite and bool(v <= cast(tol))
    return (not finite) or blown, conv, (min(best, v) if finite else best)


class GuardedRoundGraphs(RoundGraphs):
    """The guarded rounds' runs replayed as CUDA graphs (module
    docstring): ``runs`` from ``_guard_runs``; the state is the carry
    tuple, every leaf a static buffer; ``alive`` (0-dim bool) and ``good``
    (the run's healthy rounds) are static device buffers too.  A run's
    graph, keyed by (rounds, ends in a correction, ends in a check),
    replays each round as ``new = round_fn(state, x)``, ``ok =
    health_fn(new) & alive``, ``state = where(ok, new, state)``, then the
    correction (kept where ``alive``) and the check's metric, and returns
    one status tensor, f64: [alive, good, drift (if it corrects), metric
    (if it checks)], which ``run`` hands back for the host to read.

    With ``marks`` a run replays the graph of its rounds alone (key ``(n,
    False, False)``), then the correction's graph (``CORRECT``) and the
    check's (``CHECK``) where it ends in them, each inside its span; the
    status tensor is the three outputs concatenated."""

    def __init__(self, round_fn: Callable, state0: tuple, xs: Rounds,
                 runs, guard: GuardSpec, *,
                 metric_fn: Optional[Callable] = None, timed: bool = False,
                 marks: bool = False):
        self.guard = guard
        self._setup(round_fn, tuple(t.clone() for t in state0), xs,
                    [(lo, n, (n, corr, chk)) for lo, n, corr, chk in runs],
                    metric_fn, timed, marks)
        dev = state0[0].device
        self.alive = torch.ones((), dtype=torch.bool, device=dev)
        self.good = torch.zeros((), dtype=torch.int64, device=dev)
        if self.on_card:
            keys = {key for _, _, key in self._runs}
            extra = []
            if self.marks:
                extra = ([CORRECT] * any(k[1] for k in keys)
                         + [CHECK] * any(k[2] for k in keys))
                keys = {(k[0], False, False) for k in keys}
            self._capture(sorted(keys, reverse=True) + extra)

    def _graph_fn(self, key):
        """A run's body, or (marked) the correction or the check alone,
        each returning its part of the status tensor."""
        if key == CHECK:
            return self.metric_fn(self.state).double().reshape(1)
        if key == CORRECT:
            fixed, drift = self.guard.correct_fn(self.state)
            kept = tuple(torch.where(self.alive, a, b)
                         for a, b in zip(fixed, self.state))
            for buf, v in zip(self.state, kept):
                buf.copy_(v)
            return drift.double().reshape(1)
        return self._body(key)

    def unmark_tail(self, j: int) -> None:
        """Take back the marks of run j's correction and check, after the
        host read that a round of the run went bad (the device kept
        neither)."""
        if self.marks:
            from repro_torch.obs.spans import retract_marks
            _, _, (_, corr, chk) = self._runs[j]
            retract_marks(2 * (corr + chk))

    def _run_marked(self, key):
        n, corr, chk = key
        parts = [self._replay((n, False, False))]
        if corr:
            parts.append(self._marked(CORRECT, CORRECT))
        if chk:
            parts.append(self._marked(CHECK, CHECK))
        return torch.cat(parts)

    def _warmup(self):
        scratch = self.round_fn(tuple(t.clone() for t in self.state),
                                self._x0())
        self.guard.health_fn(scratch)
        if self.guard.correct_fn is not None:
            self.guard.correct_fn(scratch)
        if self.metric_fn is not None:
            self.metric_fn(scratch)

    def _body(self, key):
        n, corr, chk = key
        state = self.state
        self.good.zero_()
        for k in range(n):
            new = self.round_fn(state, self._x(k))
            ok = self.guard.health_fn(new) & self.alive
            # the freeze: where picks the old state wherever ok is False,
            # even where the new one holds a NaN
            state = tuple(torch.where(ok, a, b) for a, b in zip(new, state))
            self.alive.copy_(ok)
            self.good.add_(ok)
        out = [self.alive.double(), self.good.double()]
        if corr:
            fixed, drift = self.guard.correct_fn(state)
            state = tuple(torch.where(self.alive, a, b)
                          for a, b in zip(fixed, state))
            out.append(drift.double())
        for buf, v in zip(self.state, state):
            buf.copy_(v)
        if chk:
            out.append(self.metric_fn(self.state).double())
        return torch.stack(out)


def run_rounds(round_fn: Callable, state0: Any, xs: Rounds, *,
               tol: float = NO_TOL, check_every: int = 1,
               metric_fn: Optional[Callable] = None,
               record_state: bool = False,
               capture: bool = True,
               stats: Optional[dict] = None,
               guard: Optional[GuardSpec] = None,
               marks: bool = False) -> LoopResult:
    """Drive ``R = len(xs)`` rounds of ``round_fn`` (module docstring).

    ``xs`` is a tensor, or a tuple of tensors, with a shared leading
    round axis.  ``metric_fn(state)`` returns a 0-dim tensor; pass
    ``tol=NO_TOL`` to record it without ever stopping.  The rounds run
    through ``RoundGraphs`` (runs of ``FAST_RUN`` rounds on the fast
    path, of ``check_every`` on the tolerance path); ``capture=False``
    runs the eager loop instead, for an operator that cannot be captured
    (``GramOperator.capturable``).  A ``stats`` dict receives the
    captured driver's ``RoundGraphs.stats()`` (the replays timed with
    CUDA events on the card).

    ``guard`` switches to the guarded driver (module docstring): the
    state is the carry tuple, ``metric_fn`` takes the carry, and the
    result carries the guard's fields.  ``marks`` marks the checks and
    corrections into the active telemetry (module docstring).
    """
    if (metric_fn is not None or guard is not None) and check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    R = _n_rounds(xs)
    if guard is not None:
        if record_state:
            raise ValueError("guard= and record_state= are mutually "
                             "exclusive (guarded runs stack no per-round "
                             "states)")
        run = _run_rounds_guarded if capture and R else \
            _run_rounds_guarded_eager
        return run(round_fn, tuple(state0), xs, guard, tol=tol,
                   check_every=check_every, metric_fn=metric_fn,
                   stats=stats, marks=marks)
    if not capture or R == 0:
        return _run_rounds_eager(round_fn, state0, xs, tol=tol,
                                 check_every=check_every,
                                 metric_fn=metric_fn,
                                 record_state=record_state, marks=marks)
    timed = stats is not None
    if metric_fn is None:
        with RoundGraphs(round_fn, state0, xs, min(FAST_RUN, R),
                         record_state=record_state, timed=timed) as g:
            hist = (state0.new_empty((R,) + tuple(state0.shape))
                    if record_state else None)
            for j in range(g.n_runs):
                g.run(j)
                if hist is not None:
                    n = g.run_len(j)
                    hist[j * g.c:j * g.c + n].copy_(g.rec[:n])
            if timed:
                stats.update(g.stats())
            return LoopResult(g.state, hist, None, 0, R, False)

    n_checks = -(-R // check_every)
    hist = None
    nchk, k, converged = 0, 0, False
    with RoundGraphs(round_fn, state0, xs, min(check_every, R),
                     metric_fn=metric_fn, timed=timed, marks=marks) as g:
        for j in range(g.n_runs):
            v = g.run(j)
            k += g.run_len(j)
            if hist is None:
                hist = torch.full((n_checks,), float("inf"),
                                  dtype=v.dtype, device=v.device)
            hist[nchk] = v
            nchk += 1
            converged = bool(v <= tol)          # the check's host sync
            if converged:
                break
        if timed:
            stats.update(g.stats())
        return LoopResult(g.state, None, hist, nchk, k, converged)


def run_rounds_fleet(round_fn: Callable, state0: torch.Tensor, xs: Rounds,
                     *, tol: float = NO_TOL, check_every: int = 1,
                     metric_fn: Optional[Callable] = None,
                     capture: bool = True) -> LoopResult:
    """Drive F problems of one schedule in lockstep (the counterpart of
    the JAX package's ``loop.run_rounds_fleet``).

    ``state0`` is (F, m); ``round_fn(state, xs_k)`` advances every member
    at once (a fleet round: one kernel launch each for the whole fleet).
    Without ``metric_fn`` this is ``run_rounds``' fast path.  With it,
    ``metric_fn(state) -> (F,)`` is evaluated every ``check_every``
    rounds and at the last; a member at or below ``tol`` is done, and
    from then on its state is frozen (each later round still computes its
    update, ``torch.where`` keeps the old state), so a converged member
    never drifts; the loop stops once every member is done.  The mask is
    a static device buffer: the captured check updates it, the captured
    rounds read it, and the host reads the check's values and the mask
    once a check.  ``metric_hist`` is (n_checks, F) and ``converged`` the
    final (F,) mask, both on the host.  ``capture=False`` runs the eager
    loop (an operator that cannot be captured).
    """
    R = _n_rounds(xs)
    F = state0.shape[0]
    if metric_fn is None:
        res = run_rounds(round_fn, state0, xs, capture=capture)
        return LoopResult(res.state, None, None, 0, R,
                          torch.zeros(F, dtype=torch.bool))
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    done = torch.zeros(F, dtype=torch.bool, device=state0.device)

    def frozen_round(state, x):
        return torch.where(done[:, None], state, round_fn(state, x))

    def check(state):
        v = metric_fn(state)
        done.logical_or_(v <= tol)
        # one tensor, so the host reads values and mask in one copy
        return torch.stack((v, done.to(v.dtype)))

    n_checks = -(-R // check_every)
    hist = torch.full((n_checks, F), float("inf"), dtype=torch.float64)
    nchk, k = 0, 0
    if not capture or R == 0:
        state = state0
        while k < R:
            state = frozen_round(state, _round(xs, k))
            k += 1
            if k % check_every == 0 or k == R:
                out = check(state).cpu()         # the check's host read
                hist[nchk] = out[0]
                nchk += 1
                if bool(out[1].all()):
                    break
        return LoopResult(state, None, hist, nchk, k, done.cpu())
    with RoundGraphs(frozen_round, state0, xs, min(check_every, R),
                     metric_fn=check) as g:
        done.zero_()                # the warm-up's check may have set it
        for j in range(g.n_runs):
            out = g.run(j).cpu()                 # the check's host read
            k += g.run_len(j)
            hist[nchk] = out[0]
            nchk += 1
            if bool(out[1].all()):
                break
        return LoopResult(g.state, None, hist, nchk, k, done.cpu())


def _marked_fn(fn: Callable, name: str) -> Callable:
    """``fn(state)`` inside a ``name`` span of the active telemetry: CUDA
    events on the state's device, host times on the CPU."""
    from repro_torch.obs.spans import span_begin, span_end

    def marked(state):
        dev = (state if isinstance(state, torch.Tensor) else state[0]).device
        span_begin(name, device=dev)
        out = fn(state)
        span_end(name, device=dev)
        return out

    return marked


def _run_rounds_eager(round_fn: Callable, state0: Any, xs: Rounds, *,
                      tol: float = NO_TOL, check_every: int = 1,
                      metric_fn: Optional[Callable] = None,
                      record_state: bool = False,
                      marks: bool = False) -> LoopResult:
    """``run_rounds`` as a plain loop of eager launches, round by round:
    the route of an operator that cannot be captured, and the reference
    the captured driver is held to bit for bit."""
    R = _n_rounds(xs)
    state = state0
    if marks and metric_fn is not None:
        metric_fn = _marked_fn(metric_fn, CHECK)

    if metric_fn is None:
        hist = []
        for k in range(R):
            state = round_fn(state, _round(xs, k))
            if record_state:
                hist.append(state)
        state_hist = torch.stack(hist) if (record_state and hist) else None
        return LoopResult(state, state_hist, None, 0, R, False)

    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    n_checks = -(-R // check_every)
    hist = None
    nchk, k, converged = 0, 0, False
    while k < R and not converged:
        state = round_fn(state, _round(xs, k))
        k += 1
        if k % check_every == 0 or k == R:
            v = metric_fn(state)
            if hist is None:
                hist = torch.full((n_checks,), float("inf"),
                                  dtype=v.dtype, device=v.device)
            hist[nchk] = v
            nchk += 1
            converged = bool(v <= tol)          # the check's host sync
    if hist is None:                            # empty schedule: no checks
        hist = torch.zeros(0)
    return LoopResult(state, None, hist, nchk, k, converged)


def _guard_result(state, hist, nchk, k, conv, dhist, ncorr, div, kind,
                  has_metric, has_corr) -> LoopResult:
    return LoopResult(state, None, hist if has_metric else None, nchk, k,
                      conv, dhist if has_corr else None,
                      ncorr if has_corr else None, div, kind)


def _run_rounds_guarded(round_fn, state0: tuple, xs: Rounds,
                        guard: GuardSpec, *, tol: float, check_every: int,
                        metric_fn: Optional[Callable],
                        stats: Optional[dict] = None,
                        marks: bool = False) -> LoopResult:
    """The guarded rounds through ``GuardedRoundGraphs``: one host read
    of the run's status tensor a run."""
    R = _n_rounds(xs)
    has_metric = metric_fn is not None
    has_corr = guard.correct_fn is not None and guard.correct_every >= 1
    runs = _guard_runs(R, check_every, has_metric,
                       guard.correct_every if has_corr else 0)
    hist = torch.full((-(-R // check_every) if has_metric else 1,),
                      float("inf"), dtype=torch.float64)
    dhist = torch.zeros(-(-R // guard.correct_every) if has_corr else 1,
                        dtype=torch.float64)
    nchk = ncorr = k = 0
    conv, div, kind, best = False, -1, DIVERGED_NONE, np.inf
    mdtype = state0[0].dtype              # the metric's, as the carry's
    with GuardedRoundGraphs(round_fn, state0, xs, runs, guard,
                            metric_fn=metric_fn,
                            timed=stats is not None, marks=marks) as g:
        for j, (lo, n, corr, chk) in enumerate(runs):
            out = g.run(j).tolist()               # the run's host read
            if not out[0]:                        # a round went bad
                g.unmark_tail(j)
                div, kind = lo + int(out[1]), DIVERGED_NONFINITE
                k = div + 1
                break
            k = lo + n
            if corr:
                dhist[ncorr] = out[2]
                ncorr += 1
            if chk:
                v = out[-1]
                hist[nchk] = v
                nchk += 1
                bad, conv, best = _metric_verdict(v, mdtype, best, tol,
                                                  guard.metric_blowup)
                if bad:
                    div, kind = k - 1, DIVERGED_METRIC
                    break
                if conv:
                    break
        if stats is not None:
            stats.update(g.stats())
        state = g.state
    return _guard_result(state, hist.to(mdtype), nchk, k, conv, dhist,
                         ncorr, div, kind, has_metric, has_corr)


def _run_rounds_guarded_eager(round_fn, state0: tuple, xs: Rounds,
                              guard: GuardSpec, *, tol: float,
                              check_every: int,
                              metric_fn: Optional[Callable],
                              stats: Optional[dict] = None,
                              marks: bool = False) -> LoopResult:
    """The guarded rounds as a plain loop of eager launches with a host
    check a round (the reference's while loop): the route of an operator
    that cannot be captured, and the reference ``GuardedRoundGraphs`` is
    held to bit for bit."""
    R = _n_rounds(xs)
    if marks:
        if metric_fn is not None:
            metric_fn = _marked_fn(metric_fn, CHECK)
        if guard.correct_fn is not None:
            guard = guard._replace(
                correct_fn=_marked_fn(guard.correct_fn, CORRECT))
    has_metric = metric_fn is not None
    has_corr = guard.correct_fn is not None and guard.correct_every >= 1
    hist = torch.full((-(-R // check_every) if has_metric else 1,),
                      float("inf"), dtype=torch.float64)
    dhist = torch.zeros(-(-R // guard.correct_every) if has_corr else 1,
                        dtype=torch.float64)
    nchk = ncorr = k = 0
    conv, div, kind, best = False, -1, DIVERGED_NONE, np.inf
    mdtype = None
    state = state0
    while k < R:
        new = round_fn(state, _round(xs, k))
        k += 1
        if not bool(guard.health_fn(new)):       # the round's host check
            div, kind = k - 1, DIVERGED_NONFINITE
            break
        state = new
        if has_corr and k % guard.correct_every == 0:
            state, drift = guard.correct_fn(state)
            dhist[ncorr] = float(drift)
            ncorr += 1
        if has_metric and (k % check_every == 0 or k == R):
            v = metric_fn(state)
            mdtype = v.dtype
            hist[nchk] = float(v)
            nchk += 1
            bad, conv, best = _metric_verdict(float(v), mdtype, best, tol,
                                              guard.metric_blowup)
            if bad:
                div, kind = k - 1, DIVERGED_METRIC
                break
            if conv:
                break
    hist = hist.to(mdtype or state0[0].dtype)
    return _guard_result(state, hist, nchk, k, conv, dhist, ncorr, div,
                         kind, has_metric, has_corr)


def as_schedule(schedule, device: Optional[torch.device] = None
                ) -> torch.Tensor:
    """A coordinate schedule as int64 indices on ``device`` — the JAX
    package's schedules are int32, torch indexing takes int64.  Arrays
    are copied (a JAX array's numpy view is read-only)."""
    return as_tensor(schedule).to(device=device, dtype=torch.long)
