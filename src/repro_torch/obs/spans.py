"""Span and mark recorder for solves and serving windows (the counterpart
of ``repro/obs/spans.py``).

Two kinds of observation, one ``Telemetry`` handle:

  * HOST SPANS — ``with tel.span("representation_build", "setup"):`` —
    ``time.perf_counter`` intervals around host-side phases
    (representation build, guarded segments, engine steps).  A span
    that brackets work queued on the card ends by draining the fit's
    stream (the facade does this when telemetry is on), so it measures
    the work, not its enqueue.
  * MARKS — ``span_begin``/``span_end``/``chunk_mark`` — placed by the
    round driver (``core/loop.py``) at the sync points of the round
    protocol the reference marks: around each tolerance check
    (``metric_check``) and each guarded drift correction
    (``drift_correction``).  The fast path has no sync point and carries
    no mark.  With marks off the driver is unchanged: the same graphs
    are captured and the same kernels launched.

Where a mark lands.  The reference's marks are ``jax.debug.callback``s
inside the jitted loop, so their times are host ARRIVAL times near the
device event.  Here a mark given a CUDA ``device`` is a CUDA event
recorded on the current stream, and its time is the DEVICE time at which
the stream reached it: the driver captures a check (or a correction) as
a graph of its own and records the events between the rounds' replay and
the check's, so a ``metric_check`` interval is the device time of the
check's kernels.  Event times are mapped onto the ``perf_counter`` clock
through one anchor event per handle (recorded on a drained stream, its
host time read just before), so device marks and host spans share a
clock.  ``Telemetry.sync`` reads the pending events (the facade calls
it at the end of an instrumented fit; ``window`` and ``paired_marks``
call it too).  A mark without a CUDA device takes the host time at once,
as on the CPU.

The active slot is a module global, as in the reference: the round
driver finds the handle of the fit it runs through ``active_telemetry``
(``tel.activate()`` around the fit sets it) instead of carrying it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

# The process's active recording handle (None = record nothing).  Solves
# are driven one at a time per process (the facade and executors are
# host-serial), so a single slot suffices.
_ACTIVE: Optional["Telemetry"] = None


def active_telemetry() -> Optional["Telemetry"]:
    """The ``Telemetry`` the process currently records into, or None."""
    return _ACTIVE


@dataclasses.dataclass
class Span:
    """One closed interval: ``[t0, t1]`` on ``time.perf_counter``'s
    clock, tagged with a phase (setup/solve/serve/fit/...) and free-form
    args."""

    name: str
    phase: str
    t0: float
    t1: float
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Mark:
    """One instantaneous event.  ``kind`` follows the Chrome-trace
    phase letters: "B" (span begin), "E" (span end), "i" (instant)."""

    name: str
    phase: str
    t: float
    kind: str = "i"
    value: Optional[float] = None


def _on_card(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


class Telemetry:
    """The recording handle ``SolverOptions(telemetry=...)`` and
    ``ServingEngine(telemetry=...)`` accept.

    Holds the span/mark log plus a ``MetricsRegistry``
    (counters/gauges/histograms — obs/metrics.py).  ``enabled=False``
    makes every recording call a no-op and keeps the fit uninstrumented
    (the facade maps a disabled handle to no telemetry at all).
    """

    def __init__(self, *, enabled: bool = True, metrics=None):
        from .metrics import MetricsRegistry
        self.enabled = bool(enabled)
        self.spans: List[Span] = []
        self.marks: List[Mark] = []
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self._pending: List[tuple] = []   # device marks not read yet
        self._anchor = None               # (event, its perf_counter time)

    # -- host-side recording -------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, phase: str = "host", **args):
        """Record a closed host span around the with-body (no-op when
        disabled).  The span is appended at EXIT, so the log stays
        ordered by end time."""
        if not self.enabled:
            yield None
            return
        t0 = time.perf_counter()
        try:
            yield None
        finally:
            self.spans.append(Span(name, phase, t0, time.perf_counter(),
                                   dict(args)))

    def mark(self, name: str, phase: str = "host", value=None,
             kind: str = "i") -> None:
        """Record one instant event (no-op when disabled)."""
        if not self.enabled:
            return
        self.marks.append(Mark(name, phase, time.perf_counter(), kind,
                               None if value is None else float(value)))

    @contextlib.contextmanager
    def activate(self):
        """Make this handle the process's active recorder — the target
        of ``span_begin``/``span_end``/``chunk_mark`` under the
        with-body.  Disabled handles activate as None (the marks stay
        silent); the prior handle is restored on exit, so activations
        nest."""
        global _ACTIVE
        prev = _ACTIVE
        _ACTIVE = self if self.enabled else None
        try:
            yield self
        finally:
            _ACTIVE = prev

    # -- device marks ---------------------------------------------------

    def _device_mark(self, name: str, phase: str, kind: str, value,
                     device) -> None:
        """Queue a CUDA event on the current stream of ``device``; its
        time is read by ``sync``.  The first one anchors the handle's
        event clock to ``perf_counter`` on a drained stream."""
        device = torch.device(device)
        if self._anchor is None:
            # on a drained stream the anchor runs as soon as it is queued:
            # the host time just before is its time to within the launch
            # latency, and never later, so no mapped mark lands after the
            # host time at which its work had finished
            torch.cuda.synchronize(device)
            anchor = torch.cuda.Event(enable_timing=True)
            t_host = time.perf_counter()
            anchor.record(torch.cuda.current_stream(device))
            self._anchor = (anchor, t_host)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        self._pending.append((name, phase, kind, value, ev))

    def sync(self) -> None:
        """Wait for the pending device marks and append them to
        ``marks`` in record order, on the ``perf_counter`` clock."""
        if not self._pending:
            return
        anchor, t_anchor = self._anchor
        for name, phase, kind, value, ev in self._pending:
            ev.synchronize()
            t = t_anchor + anchor.elapsed_time(ev) * 1e-3
            self.marks.append(Mark(name, phase, t, kind,
                                   None if value is None else float(value)))
        self._pending.clear()

    # -- derived views --------------------------------------------------

    def window(self):
        """(t_min, t_max) over everything recorded, or None when empty."""
        self.sync()
        ts = [s.t0 for s in self.spans] + [m.t for m in self.marks]
        te = [s.t1 for s in self.spans] + [m.t for m in self.marks]
        if not ts:
            return None
        return min(ts), max(te)

    def paired_marks(self) -> List[Span]:
        """Stitch "B"/"E" marks into spans.  Pairing is per-name LIFO in
        record order; unmatched begins are dropped."""
        self.sync()
        open_by_name: Dict[str, List[Mark]] = {}
        out: List[Span] = []
        for m in self.marks:
            if m.kind == "B":
                open_by_name.setdefault(m.name, []).append(m)
            elif m.kind == "E" and open_by_name.get(m.name):
                b = open_by_name[m.name].pop()
                args = {} if m.value is None else {"value": m.value}
                out.append(Span(m.name, m.phase, b.t, m.t, args))
        return out

    def clear(self) -> None:
        """Drop every recorded span/mark (metrics are kept — counters
        are cumulative by design)."""
        self.spans.clear()
        self.marks.clear()
        self._pending.clear()


# ---------------------------------------------------------------------------
# Marks at the round protocol's sync points.  They record into the ACTIVE
# handle and do nothing when none is active; ``device`` (a CUDA device)
# makes the mark a CUDA event on that device's current stream, read by
# ``Telemetry.sync`` (module docstring).  Call sites are gated on the
# driver's ``marks`` flag, so an uninstrumented run makes no call at all.
# ---------------------------------------------------------------------------

def _record_mark(name: str, phase: str, kind: str, value=None,
                 device=None) -> None:
    tel = _ACTIVE
    if tel is None:
        return
    if _on_card(device):
        tel._device_mark(name, phase, kind, value, device)
        return
    tel.marks.append(Mark(name, phase, time.perf_counter(), kind,
                          None if value is None else float(value)))


def span_begin(name: str, phase: str = "round", device=None) -> None:
    """Open a marked span: a "B" mark, paired by ``span_end`` of the same
    name."""
    _record_mark(name, phase, "B", device=device)


def span_end(name: str, value=None, phase: str = "round",
             device=None) -> None:
    """Close the span opened by ``span_begin(name)``; ``value`` (a
    scalar, or a 0-dim tensor read when the mark is) rides along."""
    _record_mark(name, phase, "E", value, device)


def retract_marks(n: int) -> None:
    """Take back the last ``n`` marks recorded into the active handle: a
    captured guarded run marks its correction and check before the host
    learns that a round of the run went bad, and then the device kept
    neither (the reference marks only the ones that ran)."""
    tel = _ACTIVE
    if tel is None:
        return
    for _ in range(n):
        (tel._pending if tel._pending else tel.marks).pop()


def chunk_mark(name: str, value=None, phase: str = "round",
               device=None) -> None:
    """One instant ("i") mark — chunk boundaries, round seams."""
    _record_mark(name, phase, "i", value, device)
