"""Chrome-trace / Perfetto export of recorded telemetry (the counterpart
of ``repro/obs/export.py``, with its event layout).

``to_chrome_trace`` turns a ``Telemetry`` handle's span/mark log into
the Chrome Trace Event JSON format (the ``traceEvents`` array of
"X"/"B"/"E"/"i" events, microsecond timestamps) that chrome://tracing
and https://ui.perfetto.dev open directly.  Host spans land on the
"host" track, marks (on the card, CUDA-event times; ``obs/spans.py``)
on the "traced" track; per-event args carry the span's free-form
payload.

``validate_chrome_trace`` is the schema check the tests and
``chip_smoke.py`` gate on: required keys per event, non-negative ts/dur,
balanced per-track B/E nesting.
"""
from __future__ import annotations

import json
from typing import List

HOST_TID = 1
TRACED_TID = 2
PID = 1

_PHASES = {"X", "B", "E", "i", "M"}


def to_chrome_trace(telemetry, *, process_name: str = "repro_torch") -> dict:
    """Serialize ``telemetry`` (obs/spans.Telemetry) to a Chrome-trace
    dict.  Timestamps rebase to the earliest recorded event so the
    trace starts near t=0."""
    window = telemetry.window()
    base = window[0] if window else 0.0

    def us(t: float) -> float:
        return (t - base) * 1e6

    events: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": PID, "tid": 0,
         "args": {"name": process_name}},
        {"name": "thread_name", "ph": "M", "pid": PID, "tid": HOST_TID,
         "args": {"name": "host"}},
        {"name": "thread_name", "ph": "M", "pid": PID, "tid": TRACED_TID,
         "args": {"name": "traced"}},
    ]
    for s in telemetry.spans:
        events.append({"name": s.name, "cat": s.phase, "ph": "X",
                       "ts": us(s.t0), "dur": max(us(s.t1) - us(s.t0), 0.0),
                       "pid": PID, "tid": HOST_TID,
                       "args": {str(k): v for k, v in s.args.items()}})
    # begin/end marks export as paired complete ("X") events: marks of
    # different names may interleave, which strict B/E stack nesting
    # would reject — pairing first keeps the trace valid while
    # preserving the measured intervals
    for s in telemetry.paired_marks():
        events.append({"name": s.name, "cat": s.phase, "ph": "X",
                       "ts": us(s.t0), "dur": max(us(s.t1) - us(s.t0), 0.0),
                       "pid": PID, "tid": TRACED_TID,
                       "args": {str(k): v for k, v in s.args.items()}})
    for m in telemetry.marks:
        if m.kind != "i":
            continue
        args = {} if m.value is None else {"value": m.value}
        events.append({"name": m.name, "cat": m.phase, "ph": "i",
                       "ts": us(m.t), "s": "t", "pid": PID,
                       "tid": TRACED_TID, "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_chrome_trace(trace: dict) -> None:
    """Raise ``ValueError`` unless ``trace`` is structurally valid
    Chrome Trace Event JSON (the subset this exporter emits plus B/E
    pairs): a ``traceEvents`` list whose entries carry name/ph/pid/tid,
    timestamps where required, and balanced per-(pid, tid) B/E stacks."""
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be a dict with a 'traceEvents' list")
    events = trace["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    stacks = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i} missing required key {key!r}")
        ph = ev["ph"]
        if ph not in _PHASES:
            raise ValueError(f"event {i} has unknown phase {ph!r}")
        if ph != "M":
            if "ts" not in ev:
                raise ValueError(f"event {i} ({ph}) missing 'ts'")
            if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
                raise ValueError(f"event {i} has invalid ts {ev['ts']!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i} (X) has invalid dur {dur!r}")
        if ph in ("B", "E"):
            stack = stacks.setdefault((ev["pid"], ev["tid"]), [])
            if ph == "B":
                stack.append(ev["name"])
            else:
                if not stack or stack.pop() != ev["name"]:
                    raise ValueError(
                        f"event {i}: unbalanced E for {ev['name']!r} "
                        f"on track {(ev['pid'], ev['tid'])}")
    for track, stack in stacks.items():
        if stack:
            raise ValueError(
                f"track {track} left {len(stack)} B events unclosed: "
                f"{stack}")
    # must round-trip as JSON (chrome://tracing reads a file)
    json.dumps(trace)


def save_trace(path: str, telemetry, *,
               process_name: str = "repro_torch") -> str:
    """Export + schema-check + write; returns ``path``."""
    trace = to_chrome_trace(telemetry, process_name=process_name)
    validate_chrome_trace(trace)
    with open(path, "w") as f:
        json.dump(trace, f, indent=1)
    return path


def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
