"""Process-local metrics registry (the counterpart of
``repro/obs/metrics.py``, with its names, exposition text and JSON).

Three instrument kinds — ``Counter`` (monotone), ``Gauge`` (last
value), ``Histogram`` (fixed buckets, derived quantiles) — behind one
``MetricsRegistry`` with Prometheus-text and JSON exports.  Adopted by
``serve/engine.py`` (queue depth, ticket outcomes, batch occupancy,
latency histogram), the guarded executor in ``repro_torch.api`` (drift
corrections, fallback escalations) and ``tune/autotune`` (probe
outcomes).

Naming scheme: ``repro_<subsystem>_<what>[_<unit>]`` — e.g.
``repro_serve_ticket_latency_seconds`` — with Prometheus conventions
(``_total`` for counters, base units, labels for low-cardinality
dimensions like ticket status).  Everything is plain host Python: no
torch, no locks (the engine and executors are single-threaded hosts), no
global state unless you opt into ``default_registry()``.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Iterable, Optional, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render_labels(key: _LabelKey, extra: Tuple[Tuple[str, str], ...] = ()
                   ) -> str:
    items = key + extra
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


class _Bound:
    """A counter/gauge pre-resolved to one label set.  ``labels()``
    builds the key ONCE; hot paths (per-ticket engine counters) then
    pay a single dict add per ``inc`` instead of rebuilding the sorted
    label tuple on every call."""

    __slots__ = ("_inst", "_key", "_floor")

    def __init__(self, inst, key, floor):
        self._inst = inst
        self._key = key
        self._floor = floor

    def inc(self, value: float = 1.0) -> None:
        if self._floor and value < 0:
            raise ValueError(f"counter {self._inst.name} cannot "
                             f"decrease (inc by {value})")
        vals = self._inst._values
        vals[self._key] = vals.get(self._key, 0.0) + value

    def set(self, value: float) -> None:
        if self._floor:
            raise TypeError(f"counter {self._inst.name} has no set()")
        self._inst._values[self._key] = float(value)


class Counter:
    """Monotonically increasing value, optionally split by labels."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: Dict[_LabelKey, float] = {}

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc by {value})")
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + value

    def labels(self, **labels) -> _Bound:
        """Pre-resolve a label set for hot-path increments."""
        return _Bound(self, _label_key(labels), self.kind == "counter")

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def expose(self):
        for key, v in sorted(self._values.items()):
            yield f"{self.name}{_render_labels(key)} {v:g}"

    def to_json(self):
        return {_render_labels(k) or "": v
                for k, v in sorted(self._values.items())}


class Gauge(Counter):
    """Last-written value (``set``) with counter-style labels; ``inc``
    accepts negative deltas."""

    kind = "gauge"

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + value

    def set(self, value: float, **labels) -> None:
        self._values[_label_key(labels)] = float(value)


class Histogram:
    """Fixed-bucket histogram: cumulative-at-export bucket counts, sum,
    count, and bucket-interpolated derived quantiles (``quantile`` —
    exact within a bucket's resolution, which is all an SLO gate
    needs)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = (
                     1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0,
                     5.0, 10.0)):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError(f"histogram {name} needs >= 1 bucket bound")
        self.name = name
        self.help = help
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # last slot = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        self.sum += value
        self.count += 1
        for i, b in enumerate(self.bounds):
            if value <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def quantile(self, q: float) -> float:
        """Derived quantile by linear interpolation inside the owning
        bucket; NaN when empty.  The overflow bucket clamps to its
        lower bound (no upper edge to interpolate toward)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return float("nan")
        target = q * self.count
        cum, lo = 0.0, 0.0
        for i, c in enumerate(self.counts):
            hi = self.bounds[i] if i < len(self.bounds) else math.inf
            if c and cum + c >= target:
                if math.isinf(hi):
                    return lo
                frac = (target - cum) / c
                return lo + frac * (hi - lo)
            cum += c
            lo = hi if not math.isinf(hi) else lo
        return lo

    def expose(self):
        cum = 0
        for i, b in enumerate(self.bounds):
            cum += self.counts[i]
            yield f'{self.name}_bucket{{le="{b:g}"}} {cum}'
        cum += self.counts[-1]
        yield f'{self.name}_bucket{{le="+Inf"}} {cum}'
        yield f"{self.name}_sum {self.sum:g}"
        yield f"{self.name}_count {self.count}"

    def to_json(self):
        return {"buckets": {f"{b:g}": c
                            for b, c in zip(self.bounds, self.counts)},
                "overflow": self.counts[-1], "sum": self.sum,
                "count": self.count,
                "p50": self.quantile(0.5), "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Create-or-fetch instrument registry.  Re-requesting a name
    returns the existing instrument; a kind clash raises (one name, one
    meaning — the exposition format requires it)."""

    def __init__(self):
        self._instruments: Dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        inst = self._instruments.get(name)
        if inst is not None:
            if not isinstance(inst, cls) or type(inst) is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst
        inst = cls(name, help, **kw)
        self._instruments[name] = inst
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        kw = {} if buckets is None else {"buckets": buckets}
        return self._get(Histogram, name, help, **kw)

    def __iter__(self):
        return iter(sorted(self._instruments.items()))

    def __len__(self):
        return len(self._instruments)

    def to_prometheus_text(self) -> str:
        """Prometheus text exposition (format 0.0.4): ``# HELP`` /
        ``# TYPE`` headers plus one sample line per series."""
        lines = []
        for name, inst in self:
            if inst.help:
                lines.append(f"# HELP {name} {inst.help}")
            lines.append(f"# TYPE {name} {inst.kind}")
            lines.extend(inst.expose())
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self) -> str:
        return json.dumps(
            {name: {"kind": inst.kind, "help": inst.help,
                    "values": inst.to_json()}
             for name, inst in self}, indent=1)


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry — for callers that want one shared
    scrape target instead of per-``Telemetry`` isolation."""
    return _DEFAULT
