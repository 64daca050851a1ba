"""The collective census: every collective site of a run with how many
times it executed (the counterpart of ``repro/launch/jaxpr_analysis.py``).

The JAX module walks a jaxpr: a site is a collective equation, its
executions the scan trip counts multiplied through, a ``while`` body
counted once.  The port has no IR to walk.  Its census runs the function
with ``launch.mesh.COLLECTIVES`` recording each call (``log``): a site is
the file and line of the code that called the ``Mesh`` method, with its
primitive (XLA's name, ``mesh.PRIMS``) and axis, and its executions are
the calls made there.  Every loop, a ``while`` loop included, counts by
its real trip count (ROADMAP C38), and the census is of the run's own
data and mesh, which the caller picks: ``analysis.comm_check`` runs the
distributed solvers on a ``(1, 1)`` mesh, where the mesh counts its
collectives without a process group.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

from .mesh import COLLECTIVES, PRIMS, CollectiveCall

# the primitives a census can hold: those the mesh makes
COLLECTIVE_PRIMS = frozenset(PRIMS[:3])


class CollectiveUse(NamedTuple):
    """One collective site: ``prim`` (``PRIMS`` name), ``axes`` (the mesh
    axis names it communicates over), ``executions`` (the calls made
    there in the run), and the site itself (``path``, ``line``)."""

    prim: str
    axes: Tuple[str, ...]
    executions: int
    path: str = ""
    line: int = 0


def census_of(log: List[CollectiveCall]) -> Tuple[CollectiveUse, ...]:
    """The sites of a ``COLLECTIVES.log``, in the order each first ran."""
    rows: dict = {}
    for c in log:
        key = (c.path, c.line, c.prim, c.axis)
        rows[key] = rows.get(key, 0) + 1
    return tuple(CollectiveUse(prim, (axis,), n, path, line)
                 for (path, line, prim, axis), n in rows.items())


def collective_census(fn: Callable, *args, **kwargs
                      ) -> Tuple[CollectiveUse, ...]:
    """Run ``fn(*args, **kwargs)`` with the mesh recording, and return
    every collective site it reached with its executions.  The counts in
    ``COLLECTIVES`` go on as before."""
    saved = COLLECTIVES.log
    COLLECTIVES.log = []
    try:
        fn(*args, **kwargs)
        return census_of(COLLECTIVES.log)
    finally:
        COLLECTIVES.log = saved


def count_collective_executions(census: Tuple[CollectiveUse, ...]) -> int:
    """Total collective executions of a census."""
    return sum(u.executions for u in census)


__all__ = ["COLLECTIVE_PRIMS", "CollectiveUse", "census_of",
           "collective_census", "count_collective_executions"]
