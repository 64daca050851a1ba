"""Collective bytes and counts by primitive: the counterpart of
``repro/launch/hlo_analysis.py``.

The JAX module reads them from a compiled program's HLO text (every
``all-gather`` / ``all-reduce`` / ``reduce-scatter`` / ``all-to-all`` /
``collective-permute`` line, its bytes from the result's shape).  The
port has no HLO: every collective it makes goes through
``launch.mesh.Mesh``, which records each call's primitive under XLA's
name and its result's bytes in ``COLLECTIVES``.  These functions read
that record into the JAX module's two dicts, keyed the same way, so the
dry run's collective term is priced as the reference prices it.  A
Python loop counts every execution, so no trip-count correction is
needed (the JAX dry run's two-point probes exist for that).
"""
from __future__ import annotations

from typing import Dict, Tuple

from .mesh import COLLECTIVES, PRIMS, CollectiveCounter, axis_link_bw


def collective_bytes(counter: CollectiveCounter = COLLECTIVES
                     ) -> Dict[str, int]:
    """Result bytes of every collective made, by primitive (``PRIMS``
    names; only the primitives that ran)."""
    return {p: counter.prim_bytes[p] for p in PRIMS
            if counter.prim_calls.get(p)}


def count_collectives(counter: CollectiveCounter = COLLECTIVES
                      ) -> Dict[str, int]:
    """Collectives made, by primitive (the latency term's message
    count)."""
    return {p: counter.prim_calls[p] for p in PRIMS
            if counter.prim_calls.get(p)}


def collective_seconds(shape: Dict[str, int],
                       axis_bytes: Dict[Tuple[str, str], float]) -> float:
    """The bytes of every collective (``axis_bytes``: by ``(axis,
    primitive)``, as ``CollectiveCounter.axis_bytes`` holds them) over
    its axis's link rate on a mesh of ``shape`` (``mesh.axis_link_bw``;
    a reduction over the whole mesh, ``MESH_AXIS``, at the slowest
    axis's rate)."""
    rates = {a: axis_link_bw(shape, a) for a in shape}
    slowest = min(rates.values())
    return sum(b / rates.get(axis, slowest)
               for (axis, _), b in axis_bytes.items())


__all__ = ["collective_bytes", "collective_seconds", "count_collectives"]
