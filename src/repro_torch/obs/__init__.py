"""repro_torch.obs — telemetry (the counterpart of ``repro/obs``).

* ``spans``   — the ``Telemetry`` handle: host spans, and marks at the
  round protocol's sync points (CUDA events on the card).
* ``metrics`` — counters/gauges/histograms with Prometheus/JSON export.
* ``audit``   — modeled-vs-measured per-phase reconciliation of a fit
  against ``perf_model.modeled_fit_cost``.
* ``export``  — Chrome-trace/Perfetto JSON of any recorded window.

CLI: ``python -m repro_torch.obs {report,trace,scrape} [--device cpu]``.

``core/loop.py`` imports ``obs.spans`` from inside the round drivers, so
this package __init__ stays dependency-light: the audit (which imports
``repro_torch.core.perf_model``) and the exporter load lazily through
the module ``__getattr__``.
"""
from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, default_registry)
from .spans import (Mark, Span, Telemetry, active_telemetry,  # noqa: F401
                    chunk_mark, span_begin, span_end)

_LAZY = {
    "audit_fit": "audit", "AuditReport": "audit", "PhaseRow": "audit",
    "to_chrome_trace": "export", "validate_chrome_trace": "export",
    "save_trace": "export", "load_trace": "export",
}

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "Mark", "Span", "Telemetry",
           "active_telemetry", "chunk_mark", "span_begin", "span_end",
           *_LAZY]


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.obs' has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
