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

``pad_rounds`` pads a ragged schedule to whole s-step rounds with a
validity mask, so the final short round makes exactly-zero updates.
The guarded and fleet drivers are later slices of the port.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Union

import torch

from repro_torch.device import as_tensor

NO_TOL = float("-inf")        # sentinel: record the metric, never stop early

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


class LoopResult(NamedTuple):
    """Output of ``run_rounds``.

    state:       final solver state (alpha).
    state_hist:  per-round stacked states (fast path + record_state) or
                 None.
    metric_hist: (n_check_slots,) metric values (tolerance path; only the
                 first ``checks_run`` slots were evaluated) or None.
    checks_run:  number of metric evaluations performed.
    rounds_run:  number of rounds executed.
    converged:   metric <= tol at some check.
    """

    state: Any
    state_hist: Optional[torch.Tensor]
    metric_hist: Optional[torch.Tensor]
    checks_run: int
    rounds_run: int
    converged: bool

    def metric_history(self) -> Optional[torch.Tensor]:
        """The evaluated prefix ``metric_hist[:checks_run]``, or None when
        no metric was recorded (fast path)."""
        if self.metric_hist is None:
            return None
        return self.metric_hist[:self.checks_run]


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


def _launches():
    return [fn.launches for fn in _counted()]


def _take_launches(before, into: str = "") -> Dict[str, int]:
    """Take the launches counted since ``before`` back off each wrapper's
    ``launches`` (adding them to its ``into`` counter, if named); returns
    them by wrapper name."""
    taken = {}
    for fn, b in zip(_counted(), before):
        d = fn.launches - b
        fn.launches = b
        if into:
            setattr(fn, into, getattr(fn, into) + d)
        taken[fn.__name__] = d
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
    graph's launches a replay, by run length and wrapper name).
    """

    def __init__(self, round_fn: Callable, state0: torch.Tensor,
                 xs: Rounds, run_len: int, *,
                 metric_fn: Optional[Callable] = None,
                 record_state: bool = False):
        self.R = _n_rounds(xs)
        if not 1 <= run_len <= self.R:
            raise ValueError(f"run_len must be in [1, {self.R}] for "
                             f"{self.R} rounds, got {run_len}")
        self.round_fn, self.metric_fn = round_fn, metric_fn
        self.c = run_len
        self.n_runs = -(-self.R // run_len)
        self._xs = (xs,) if isinstance(xs, torch.Tensor) else tuple(xs)
        self._single = isinstance(xs, torch.Tensor)
        self.state = state0.clone()
        self._xbuf = tuple(x.new_empty((run_len,) + tuple(x.shape[1:]))
                           for x in self._xs)
        self.rec = (state0.new_empty((run_len,) + tuple(state0.shape))
                    if record_state else None)
        self.on_card = state0.device.type == "cuda"
        self.capture_s = self.warmup_s = 0.0
        self.pool_bytes = 0
        self.graph_launches: Dict[int, Dict[str, int]] = {}
        lengths = sorted({self.run_len(j) for j in range(self.n_runs)},
                         reverse=True)
        self._graphs: Dict[int, Any] = {}
        if self.on_card:
            self._capture(lengths)

    def run_len(self, j: int) -> int:
        """Rounds in run j."""
        return min(self.c, self.R - j * self.c)

    def _x(self, k: int):
        if self._single:
            return self._xbuf[0][k]
        return tuple(b[k] for b in self._xbuf)

    def _body(self, n: int):
        """n rounds over the static buffers, then the check's metric."""
        state = self.state
        for k in range(n):
            state = self.round_fn(state, self._x(k))
            if self.rec is not None:
                self.rec[k].copy_(state)
        self.state.copy_(state)
        return None if self.metric_fn is None else self.metric_fn(self.state)

    def _capture(self, lengths):
        dev = self.state.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            t0 = time.perf_counter()
            before = _launches()
            x0 = tuple(x[0] for x in self._xs)
            scratch = self.round_fn(self.state.clone(),
                                    x0[0] if self._single else x0)
            if self.metric_fn is not None:
                self.metric_fn(scratch)
            del scratch
            _take_launches(before, "warmup_launches")
            side.synchronize()
            self.warmup_s = time.perf_counter() - t0
            pool = torch.cuda.graph_pool_handle()
            reserved = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            for n in lengths:
                g = torch.cuda.CUDAGraph()
                before = _launches()
                g.capture_begin(pool=pool)
                try:
                    out = self._body(n)
                finally:
                    g.capture_end()
                self.graph_launches[n] = _take_launches(before)
                self._graphs[n] = (g, out)
            self.capture_s = time.perf_counter() - t0
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        torch.cuda.current_stream(dev).wait_stream(side)

    def run(self, j: int, refresh: bool = True):
        """Replay run j (execute it, on the CPU).  ``refresh=False`` skips
        the copy of its schedule slice, so the run repeats the previous
        run's coordinates: a wrong driver that checks must catch."""
        lo, n = j * self.c, self.run_len(j)
        if refresh:
            for buf, x in zip(self._xbuf, self._xs):
                buf[:n].copy_(x[lo:lo + n])
        if not self.on_card:
            return self._body(n)
        g, out = self._graphs[n]
        g.replay()
        for fn in _counted():
            fn.launches += self.graph_launches[n][fn.__name__]
        return out

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


def run_rounds(round_fn: Callable, state0: Any, xs: Rounds, *,
               tol: float = NO_TOL, check_every: int = 1,
               metric_fn: Optional[Callable] = None,
               record_state: bool = False,
               capture: bool = True) -> LoopResult:
    """Drive ``R = len(xs)`` rounds of ``round_fn`` (module docstring).

    ``xs`` is a tensor, or a tuple of tensors, with a shared leading
    round axis.  ``metric_fn(state)`` returns a 0-dim tensor; pass
    ``tol=NO_TOL`` to record it without ever stopping.  The rounds run
    through ``RoundGraphs`` (runs of ``FAST_RUN`` rounds on the fast
    path, of ``check_every`` on the tolerance path); ``capture=False``
    runs the eager loop instead, for an operator that cannot be captured
    (``GramOperator.capturable``).
    """
    if metric_fn is not None and check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    R = _n_rounds(xs)
    if not capture or R == 0:
        return _run_rounds_eager(round_fn, state0, xs, tol=tol,
                                 check_every=check_every,
                                 metric_fn=metric_fn,
                                 record_state=record_state)
    if metric_fn is None:
        with RoundGraphs(round_fn, state0, xs, min(FAST_RUN, R),
                         record_state=record_state) as g:
            hist = (state0.new_empty((R,) + tuple(state0.shape))
                    if record_state else None)
            for j in range(g.n_runs):
                g.run(j)
                if hist is not None:
                    n = g.run_len(j)
                    hist[j * g.c:j * g.c + n].copy_(g.rec[:n])
            return LoopResult(g.state, hist, None, 0, R, False)

    n_checks = -(-R // check_every)
    hist = None
    nchk, k, converged = 0, 0, False
    with RoundGraphs(round_fn, state0, xs, min(check_every, R),
                     metric_fn=metric_fn) as g:
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
        return LoopResult(g.state, None, hist, nchk, k, converged)


def _run_rounds_eager(round_fn: Callable, state0: Any, xs: Rounds, *,
                      tol: float = NO_TOL, check_every: int = 1,
                      metric_fn: Optional[Callable] = None,
                      record_state: bool = False) -> LoopResult:
    """``run_rounds`` as a plain loop of eager launches, round by round:
    the route of an operator that cannot be captured, and the reference
    the captured driver is held to bit for bit."""
    R = _n_rounds(xs)
    state = state0

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


def as_schedule(schedule, device: Optional[torch.device] = None
                ) -> torch.Tensor:
    """A coordinate schedule as int64 indices on ``device`` — the JAX
    package's schedules are int32, torch indexing takes int64.  Arrays
    are copied (a JAX array's numpy view is read-only)."""
    return as_tensor(schedule).to(device=device, dtype=torch.long)
