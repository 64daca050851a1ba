"""Continuous-batching serving engine (the counterpart of
``repro/serve/engine.py``, layer 3 of ``repro_torch.serve``).

Query traffic does not arrive in tidy power-of-two blocks: requests for
different models trickle in one at a time, some with latency deadlines,
sometimes faster than the card can serve.  This engine turns that stream
into the fixed-shape blocks the predictors were warmed on:

  * ``submit`` validates EAGERLY and on the host (feature width, dtype,
    1-D/2-D shape — the offending argument named; a malformed request
    never reaches a block another request is riding in; no device copy
    per request), then enqueues a ``Ticket``.  The queue is BOUNDED:
    beyond ``max_queue`` waiting tickets new arrivals are SHED at submit
    time — the caller learns immediately (ticket.status == "shed").
  * ``step`` is one drain cycle: expired tickets retire first (deadline
    passed while queued), then each registry group admits up to
    ``slots`` queued rows, assembles them in ONE host buffer already
    padded to its power-of-two bucket (a reused buffer per bucket,
    page-locked when the group serves on the card), copies it to the
    device once, serves every member model's column in a single
    ``BatchedPredictor`` call (one KMV launch for an exact operator)
    and brings the (qb, F) result back with one copy; each ticket then
    takes its rows of its model's column on the host.  Admission issues
    only warmed buckets (``serve_cache_size`` growth == 0 after
    ``warmup``).
  * mixed-model traffic batches per GROUP, not per model: requests for
    F models sharing one operator ride the same block.

Time is injected (``clock=``): ``time.monotonic`` by default, a virtual
clock in tests.  Registry mutations (refit's atomic swap) are picked up
at step boundaries via the generation counter — a block finishes on the
weights it was formed with.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.predict import check_queries
from repro_torch.device import as_tensor
from .registry import ModelRegistry

PENDING = "pending"
DONE = "done"
EXPIRED = "expired"
SHED = "shed"


# repro: noqa[CHK-TREE] a queued request's host-side record; no tree carries it
@dataclasses.dataclass
class Ticket:
    """One submitted request: ``rows`` queries against one model.

    ``X`` is kept on the HOST: the engine assembles each group's block in
    a host buffer sized to its bucket and ships ONE copy per block.

    ``status`` walks pending -> done (``result`` holds the (rows,) values,
    a host tensor) | expired (deadline passed while queued) | shed
    (bounded queue was full at submit).  Times are in the engine clock's
    units.
    """

    id: int
    name: str
    X: torch.Tensor                     # (rows, n) query block, host
    t_submit: float
    deadline: Optional[float] = None    # absolute clock time, or None
    status: str = PENDING
    result: Optional[torch.Tensor] = None
    t_done: Optional[float] = None

    @property
    def rows(self) -> int:
        return self.X.shape[0]

    @property
    def latency(self) -> Optional[float]:
        """Submit-to-done latency (None until served)."""
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit


class ServingEngine:
    """Bounded-queue continuous batcher over a ``ModelRegistry``.

    ``slots`` is the per-group admission width of one step — at most
    that many queued rows form each group's block, so it must not exceed
    the registry's ``predict_batch`` (the largest warmed bucket); the
    constructor clamps.  ``max_queue`` bounds WAITING tickets across all
    models; ``clock`` supplies time.

    ``telemetry`` (``repro_torch.obs``) hangs serving metrics off the
    handle's registry: queue depth (gauge), ticket dispositions (counter,
    labelled by status), batch occupancy (histogram of admitted
    rows/slots per block) and submit-to-done latency (histogram); ``step``
    additionally records one phase="serve" host span (a step ends in the
    host copy of its results, so the span covers the device work).  A
    None/disabled handle costs nothing on the hot path.
    """

    def __init__(self, registry: ModelRegistry, *, slots: int = 256,
                 max_queue: int = 1024,
                 clock: Callable[[], float] = time.monotonic,
                 telemetry=None):
        if not isinstance(slots, int) or slots < 1:
            raise ValueError(f"slots must be a positive int, got {slots!r}")
        if not isinstance(max_queue, int) or max_queue < 1:
            raise ValueError(
                f"max_queue must be a positive int, got {max_queue!r}")
        self.registry = registry
        self.slots = min(slots, registry.predict_batch)
        self.max_queue = max_queue
        self.clock = clock
        self._queue: List[Ticket] = []
        self._next_id = 0
        self._generation = registry.generation
        self._bufs: Dict[tuple, torch.Tensor] = {}
        self.stats: Dict[str, int] = {
            "submitted": 0, "served": 0, "shed": 0, "expired": 0,
            "steps": 0, "blocks": 0}
        self._latencies: List[float] = []
        self._tel = (telemetry if telemetry is not None
                     and telemetry.enabled else None)
        if self._tel is not None:
            reg = self._tel.metrics
            self._m_depth = reg.gauge(
                "repro_serve_queue_depth", "tickets waiting in the "
                "bounded queue")
            self._m_tickets = reg.counter(
                "repro_serve_tickets_total", "ticket dispositions, "
                "labelled by terminal status")
            self._m_occupancy = reg.histogram(
                "repro_serve_batch_occupancy",
                "admitted rows / slots per served block",
                buckets=(0.125, 0.25, 0.5, 0.75, 0.9, 1.0))
            self._m_latency = reg.histogram(
                "repro_serve_ticket_latency_seconds",
                "submit-to-done latency (engine clock units)",
                buckets=(1e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5,
                         1.0, 5.0))
            # label keys resolved once; submit/done fire per ticket
            self._t_submitted = self._m_tickets.labels(
                status="submitted")
            self._t_shed = self._m_tickets.labels(status=SHED)
            self._t_expired = self._m_tickets.labels(status=EXPIRED)
            self._t_done = self._m_tickets.labels(status=DONE)
            self._g_depth = self._m_depth.labels()

    # -- admission ------------------------------------------------------

    def submit(self, name: str, X, *,
               deadline_s: Optional[float] = None) -> Ticket:
        """Enqueue queries for ``name``.  ``X`` is one query row (n,) or
        a block (rows, n); validation is EAGER and on the host —
        feature-dim/dtype mismatches raise ``ValueError`` naming ``X``
        here, never inside a mixed block.  Returns the ticket (status
        "shed" when the bounded queue was full)."""
        model = self.registry._model(name)   # KeyError on unknown name
        X = as_tensor(X)
        if X.ndim == 1:
            X = X[None, :]
        X = check_queries(model.op, X, name="X")
        if X.device.type != "cpu":
            X = X.cpu()
        now = self.clock()
        ticket = Ticket(id=self._next_id, name=name, X=X, t_submit=now,
                        deadline=(None if deadline_s is None
                                  else now + deadline_s))
        self._next_id += 1
        self.stats["submitted"] += 1
        if self._tel is not None:
            self._t_submitted.inc()
        if len(self._queue) >= self.max_queue:
            ticket.status = SHED
            self.stats["shed"] += 1
            if self._tel is not None:
                self._t_shed.inc()
            return ticket
        self._queue.append(ticket)
        if self._tel is not None:
            self._g_depth.set(len(self._queue))
        return ticket

    @property
    def pending(self) -> int:
        return len(self._queue)

    def warmup(self) -> int:
        """Serve every group's bucket set once (delegates to the
        registry).  After this, ``step`` reaches no new block shape —
        the invariant ``serve_cache_size`` observes."""
        return self.registry.warmup()

    # -- drain ----------------------------------------------------------

    def step(self) -> int:
        """One drain cycle; returns the number of rows served.

        Retire-expired -> admit-per-group -> serve-one-block-per-group
        -> scatter results.  Registry generation is sampled ONCE at the
        top: a refit swap is picked up at a step boundary (tickets of a
        block finish on the group state the block was formed from)."""
        if self._tel is None:
            return self._step()
        with self._tel.span("engine_step", "serve",
                            pending=len(self._queue)):
            served = self._step()
        self._g_depth.set(len(self._queue))
        return served

    def _buffer(self, qb: int, op) -> torch.Tensor:
        """The reused host buffer of a (qb, n) block of ``op``'s dtype,
        page-locked when the block goes to the card."""
        pin = op.device.type == "cuda"
        key = (qb, op.feature_dim, op.dtype, pin)
        buf = self._bufs.get(key)
        if buf is None:
            buf = torch.empty((qb, op.feature_dim), dtype=op.dtype,
                              pin_memory=pin)
            self._bufs[key] = buf
        return buf

    def _step(self) -> int:
        self.stats["steps"] += 1
        if self._generation != self.registry.generation:
            self._generation = self.registry.generation
        now = self.clock()
        survivors: List[Ticket] = []
        for t in self._queue:
            if t.deadline is not None and now > t.deadline:
                t.status = EXPIRED
                self.stats["expired"] += 1
                if self._tel is not None:
                    self._t_expired.inc()
            else:
                survivors.append(t)
        self._queue = survivors

        # admit: FIFO per group, up to ``slots`` rows each
        by_group: Dict[int, List[Ticket]] = {}
        admitted_rows: Dict[int, int] = {}
        admitted: List[Ticket] = []
        for t in self._queue:
            gid = id(self.registry.group(t.name))
            used = admitted_rows.get(gid, 0)
            if used + t.rows > self.slots:
                continue                 # next step; FIFO within group
            by_group.setdefault(gid, []).append(t)
            admitted_rows[gid] = used + t.rows
            admitted.append(t)
        if not admitted:
            return 0
        admitted_ids = {t.id for t in admitted}
        self._queue = [t for t in self._queue if t.id not in admitted_ids]

        served = 0
        for tickets in by_group.values():
            group = self.registry.group(tickets[0].name)
            # one host buffer already padded to the bucket, one copy in,
            # one block call, one copy back
            q = sum(t.rows for t in tickets)
            qb = group.predictor.block_shape(q)
            buf = self._buffer(qb, group.op)
            lo = 0
            for t in tickets:
                buf[lo:lo + t.rows] = t.X
                lo += t.rows
            buf[q:].zero_()
            Xq = buf.to(group.op.device, non_blocking=True)
            out_host = group.serve(Xq)[:q].cpu()   # (q, F): every model
            t_done = self.clock()
            lo = 0
            for t in tickets:
                t.result = out_host[lo:lo + t.rows, group.col[t.name]]
                lo += t.rows
                t.status = DONE
                t.t_done = t_done
                self._latencies.append(t.latency)
                served += t.rows
                if self._tel is not None:
                    self._t_done.inc()
                    self._m_latency.observe(t.latency)
            self.stats["served"] += len(tickets)
            self.stats["blocks"] += 1
            if self._tel is not None:
                self._m_occupancy.observe(q / self.slots)
        return served

    def run_until_idle(self, *, max_steps: int = 10_000) -> int:
        """Drain the queue completely; returns total rows served."""
        total = 0
        for _ in range(max_steps):
            if not self._queue:
                return total
            total += self.step()
        raise RuntimeError(
            f"queue failed to drain within {max_steps} steps "
            f"({len(self._queue)} tickets still pending)")

    # -- observability --------------------------------------------------

    def latency_quantiles(self, qs=(0.5, 0.99)) -> Dict[str, float]:
        """Observed submit-to-done latency quantiles (engine clock
        units) over every served ticket."""
        if not self._latencies:
            return {f"p{int(q * 100)}": float("nan") for q in qs}
        lat = np.asarray(self._latencies, np.float64)
        return {f"p{int(q * 100)}": float(np.quantile(lat, q))
                for q in qs}
