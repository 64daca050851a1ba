"""Meshes of ranks for the distributed layouts — the counterpart of
``repro/launch/mesh.py``'s ``make_host_mesh``.

Process model
-------------
The JAX package is one controller driving a device mesh through
``shard_map``.  Here it is SPMD, the idiom of ``torch.distributed``: one
process per rank, and every rank calls the same ``fit`` (or the same
``core.distributed`` solver) on the same ``A``, ``y`` and seed.  Each rank
takes its own block of A, runs the same rounds, and meets the others
only in ``Mesh.all_reduce``.  The schedule is drawn from the seed on
every rank, so it is already the same everywhere; a value that only one
rank computes (the convergence metric on the full A, the guard's
verdict) is sent from rank 0 to the others (``Mesh.root_value``), so
every rank takes the same branch.

A ``Mesh`` has the axes ``("data", "model")``: rank ``r`` of the default
group sits at ``(r // model, r % model)``, and each axis has one process
group per line of ranks along it, built with ``dist.new_group`` over the
default group the caller initialised (``init_process_group``, with its
address, world size and rank given).  Over an initialised group every
reduction goes through the group's backend, also along an axis of one
rank (so a world of one NCCL rank drives NCCL); a mesh made with no
initialised group is ``(1, 1)`` and its reductions are the identity, as
``psum`` over an axis of size one is.

Every collective of the layouts goes through ``Mesh.all_reduce`` (the
one broadcast, ``root_value``, is an all-reduce in which only rank 0
contributes).  The LM trainers (``train.train_step``) also gather and
reduce-scatter along an axis (``Mesh.all_gather``,
``Mesh.reduce_scatter``).  Each call is counted, with the words it
carries (the full tensor's elements), in ``COLLECTIVES`` by axis and
kind: the solvers' ``"round"`` (the rounds' reductions), ``"setup"``
(once per solve call: the RBF row norms, the 2d layout's alpha assembly)
and ``"check"`` (the metric and guard values sent from rank 0); the
trainers' ``"grad"`` (a gradient sync over ``data``: the deferred
step's bucket, the sharded step's replicated leaves), ``"param"`` (an
FSDP gather of a leaf at use and the reduce-scatter of its gradient, or
a gather over ``model`` where the tensor-parallel route does not split
the leaf; in sharded decode also the vocab-parallel tables' sums and
gathers of rows and logits), ``"tp"`` (the tensor-parallel reductions
over ``model``, and a Mamba block's gathers over it of its ``in_proj``
activation, with the gradient's reduce-scatter, and of a decode
state) and ``"metric"`` (the clipping norm); sharded decode's
``"seq"`` (the split-S attention: the gather of its chunks' partial
softmaxes to merge them, and MLA's gather of the heads' queries over
``model``) and the serving steps' ``"token"`` (the gather of a step's
next tokens, or of the logits to sample from, over ``data``).  Every
backend gathers and reduce-scatters with its own call
(``all_gather_into_tensor``, ``reduce_scatter_tensor`` on flat buffers);
gloo takes CUDA tensors in both and moves them through host memory.

The JAX module's production mesh and its TPU hardware table have no
counterpart here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "model")
KINDS = ("round", "setup", "check", "grad", "param", "tp", "metric", "seq",
         "token")
OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# the axis name under which a reduction over every rank of the mesh is
# counted (``root_value``)
MESH_AXIS = "mesh"


class CollectiveCounter:
    """Calls and words of the mesh's collectives by ``(axis, kind)``."""

    def __init__(self):
        self.calls: Dict[Tuple[str, str], int] = {}
        self.words: Dict[Tuple[str, str], int] = {}

    def reset(self) -> None:
        self.calls.clear()
        self.words.clear()

    def add(self, axis: str, kind: str, words: int) -> None:
        key = (axis, kind)
        self.calls[key] = self.calls.get(key, 0) + 1
        self.words[key] = self.words.get(key, 0) + int(words)


COLLECTIVES = CollectiveCounter()


class Mesh:
    """A ``(data, model)`` grid of ranks (module docstring).

    ``shape`` maps each axis name to its extent, as a JAX mesh's does;
    ``coords`` this rank's position; ``groups`` one process group per
    axis (None on a mesh with no initialised group)."""

    axis_names = AXES

    def __init__(self, shape: Tuple[int, int],
                 coords: Tuple[int, int] = (0, 0),
                 groups: Optional[Dict[str, object]] = None,
                 world=None):
        self.shape = dict(zip(AXES, (int(shape[0]), int(shape[1]))))
        self.coords = dict(zip(AXES, coords))
        self.groups = groups
        self.world = world

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def rank(self) -> int:
        return self.coords["data"] * self.shape["model"] + \
            self.coords["model"]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
        return self.coords[axis]

    def _count(self, axis: str, kind: str, words: int) -> None:
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        COLLECTIVES.add(axis, kind, words)

    def _group(self, axis: str):
        return self.world if axis == MESH_AXIS else self.groups[axis]

    def all_reduce(self, t: torch.Tensor, axis: str, kind: str = "round",
                   op: str = "sum", inplace: bool = False) -> torch.Tensor:
        """The sum (``op="max"``: the maximum) of ``t`` over the ranks
        along ``axis`` (``MESH_AXIS``: over every rank), on every one of
        them: a new tensor, ``t`` left as it was, or with ``inplace`` ``t``
        itself (contiguous) reduced.  Counted in ``COLLECTIVES``."""
        self._count(axis, kind, t.numel())
        if self.groups is None:
            return t
        out = t if inplace else t.clone(
            memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=OPS[op], group=self._group(axis))
        return out

    def all_gather(self, t: torch.Tensor, axis: str, dim: int,
                   kind: str = "param") -> torch.Tensor:
        """The chunks ``t`` of every rank along ``axis``, concatenated
        along ``dim`` in their coordinate order: a new tensor on every
        rank.  Counted in ``COLLECTIVES`` with the gathered tensor's
        elements."""
        n = self.shape[axis]
        self._count(axis, kind, t.numel() * n)
        if self.groups is None:
            return t
        t = t.contiguous()
        buf = t.new_empty((n, *t.shape))
        dist.all_gather_into_tensor(buf.view(-1), t.view(-1),
                                    group=self._group(axis))
        return buf.movedim(0, dim).flatten(dim, dim + 1)

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int,
                       kind: str = "param") -> torch.Tensor:
        """This rank's chunk along ``dim`` (its coordinate along ``axis``)
        of the sum of ``t`` over the ranks along ``axis``: a new
        contiguous tensor.  Counted in ``COLLECTIVES`` with the elements
        of ``t``."""
        n = self.shape[axis]
        self._count(axis, kind, t.numel())
        if self.groups is None:
            return t
        chunks = t.unflatten(dim, (n, -1)).movedim(dim, 0).contiguous()
        out = chunks.new_empty(chunks.shape[1:])
        dist.reduce_scatter_tensor(out.view(-1), chunks.view(-1),
                                   group=self._group(axis))
        return out

    def root_value(self, t: torch.Tensor,
                   kind: str = "check") -> torch.Tensor:
        """Rank 0's ``t`` on every rank: an all-reduce over the mesh in
        which the other ranks contribute zeros (``x + 0`` is ``x``, NaN
        and infinities included).  ``t`` need only be meaningful on rank
        0, but must have the same shape and dtype everywhere."""
        return self.all_reduce(t if self.rank == 0 else torch.zeros_like(t),
                               MESH_AXIS, kind)


# the meshes built over the current default group, by shape (emptied when
# the default group is another object: a group destroyed and initialised
# again)
_MESHES: Dict[Tuple[int, int], Mesh] = {}


def make_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A ``(data, model)`` mesh over the initialised default group (every
    rank calls this with the same shape, in the same order: building the
    axis groups is collective), or the ``(1, 1)`` identity mesh when no
    group is initialised.  Meshes are cached per shape over the current
    default group (held by identity), so a fit that builds its mesh again
    reuses the groups, and a group initialised anew gets new ones."""
    if not dist.is_available() or not dist.is_initialized():
        if (data, model) != (1, 1):
            raise ValueError(f"a ({data}, {model}) mesh needs an "
                             f"initialised default process group "
                             f"(torch.distributed.init_process_group)")
        return Mesh((1, 1))
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"mesh ({data}, {model}) does not cover the "
                         f"{world} ranks of the default group")
    if any(m.world is not dist.group.WORLD for m in _MESHES.values()):
        _MESHES.clear()
    key = (data, model)
    if key not in _MESHES:
        rank = dist.get_rank()
        d, j = divmod(rank, model)
        groups = {}
        # every rank creates every group, in one order
        for jj in range(model):
            g = dist.new_group([i * model + jj for i in range(data)])
            if jj == j:
                groups["data"] = g
        for ii in range(data):
            g = dist.new_group([ii * model + k for k in range(model)])
            if ii == d:
                groups["model"] = g
        _MESHES[key] = Mesh((data, model), (d, j), groups,
                            dist.group.WORLD)
    return _MESHES[key]


def world_size() -> int:
    """Ranks of the initialised default group, or 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1

