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

A mesh may also carry the JAX production mesh's third axis, ``pod``
(``("pod", "data", "model")``, ``make_mesh(data, model, pod=)``): the
batch then splits over ``("pod", "data")`` (pod major), params are
replicated over ``pod``, and the train steps add the ``pod`` sums of
their gradients (``train.train_step``).  ``make_production_mesh`` is the
JAX module's production mesh as a *dry* mesh: the axes, one rank's
coordinates and no process group; its collectives are counted as a real
mesh's and return a new tensor of the result's shape on the tensor's
device (what the dry run, ``launch.dryrun``, runs through on ``meta``
tensors).  Beside the calls and words by ``(axis, kind)``, ``COLLECTIVES``
records each collective's primitive under XLA's name (``PRIMS``) and its
result's bytes, by primitive and by axis (``launch.collective_log`` reads
them), and, while ``COLLECTIVES.log`` is a list, one ``CollectiveCall``
a call: its primitive, axis, kind, result shape and dtype, and its site,
the file and line that called the mesh (``launch.collective_census``).

``HW`` is the card the port runs on, in place of the JAX module's TPU
table.
"""
from __future__ import annotations

import itertools
import math
import sys
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
KINDS = ("round", "setup", "check", "grad", "param", "tp", "metric", "seq",
         "token")
OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# the axis name under which a reduction over every rank of the mesh is
# counted (``root_value``)
MESH_AXIS = "mesh"
# the collective primitives, by the names XLA's HLO gives them (the mesh
# makes the first three)
PRIMS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

# The card the port runs on, for the dry run's roofline terms.  An NVIDIA
# H100 SXM5 as ``nvidia-smi --query-gpu=name,power.limit
# --format=csv,noheader`` names it, "NVIDIA H100 80GB HBM3, 700.00 W";
# the figures are NVIDIA's H100 data sheet (SXM5, dense, no sparsity):
# bf16 989 TFLOP/s, HBM3 3.35 TB/s and 80 GB; NVLink 4 at 900 GB/s a card
# both ways (18 links), 450 GB/s each way.  The link model: an axis whose
# ranks all sit in one 8-card node (NVSwitch, all to all) moves its bytes
# at ``nvlink_bw``; an axis that spans nodes at ``node_link_bw``, one
# 400 Gb/s NDR InfiniBand port a card each way (the DGX H100 node: eight
# ConnectX-7 ports for its eight cards).  Ranks fill nodes in rank order
# (the last axis fastest), so at (16, 16) every axis spans nodes.
HW = {
    "name": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700.0,
    "peak_flops_bf16": 989e12,     # FLOP/s
    "hbm_bw": 3.35e12,             # B/s
    "hbm_bytes": 80e9,
    "nvlink_bw": 450e9,            # B/s a card, each way, inside a node
    "cards_per_node": 8,
    "node_link_bw": 50e9,          # B/s a card, each way, across nodes
}


def axis_link_bw(shape: Dict[str, int], axis: str) -> float:
    """The rate (``HW``) at which a collective along ``axis`` of a mesh of
    ``shape`` (axis -> extent, in rank order) moves its bytes: NVLink where
    the axis's ranks lie in one node, InfiniBand where they span nodes."""
    names = list(shape)
    stride = math.prod(shape[a] for a in names[names.index(axis) + 1:])
    inside = stride * shape[axis] <= HW["cards_per_node"]
    return HW["nvlink_bw"] if inside else HW["node_link_bw"]


class CollectiveCall(NamedTuple):
    """One collective as ``COLLECTIVES.log`` records it: the primitive
    (``PRIMS``), axis and kind, the result's shape and dtype, and the
    file and line of the code that called the mesh."""

    prim: str
    axis: str
    kind: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    path: str
    line: int


class CollectiveCounter:
    """Calls and words of the mesh's collectives by ``(axis, kind)``;
    calls and result bytes by primitive (``prim_calls``, ``prim_bytes``)
    and bytes by ``(axis, primitive)`` (``axis_bytes``); with ``log`` a
    list, one ``CollectiveCall`` a call appended to it."""

    def __init__(self):
        self.calls: Dict[Tuple[str, str], int] = {}
        self.words: Dict[Tuple[str, str], int] = {}
        self.prim_calls: Dict[str, int] = {}
        self.prim_bytes: Dict[str, int] = {}
        self.axis_bytes: Dict[Tuple[str, str], int] = {}
        self.log: Optional[List[CollectiveCall]] = None

    def reset(self) -> None:
        for d in (self.calls, self.words, self.prim_calls, self.prim_bytes,
                  self.axis_bytes):
            d.clear()
        if self.log is not None:
            self.log.clear()

    def add(self, axis: str, kind: str, words: int,
            prim: str = "all-reduce", shape: Sequence[int] = (),
            dtype: torch.dtype = torch.float32) -> None:
        """Count one call carrying ``words`` elements whose result has
        ``shape`` and ``dtype``."""
        key = (axis, kind)
        self.calls[key] = self.calls.get(key, 0) + 1
        self.words[key] = self.words.get(key, 0) + int(words)
        nbytes = math.prod(shape) * dtype.itemsize
        self.prim_calls[prim] = self.prim_calls.get(prim, 0) + 1
        self.prim_bytes[prim] = self.prim_bytes.get(prim, 0) + nbytes
        ab = (axis, prim)
        self.axis_bytes[ab] = self.axis_bytes.get(ab, 0) + nbytes
        if self.log is not None:
            f = sys._getframe(1)
            while f is not None and f.f_code.co_filename == __file__:
                f = f.f_back
            path, line = ((f.f_code.co_filename, f.f_lineno)
                          if f is not None else ("<unknown>", 0))
            self.log.append(CollectiveCall(prim, axis, kind, tuple(shape),
                                           dtype, path, line))


COLLECTIVES = CollectiveCounter()


class Mesh:
    """A grid of ranks over ``axis_names`` (module docstring): ``("data",
    "model")``, or ``("pod", "data", "model")`` for a shape of three.

    ``shape`` maps each axis name to its extent, as a JAX mesh's does;
    ``coords`` this rank's position; ``groups`` one process group per
    axis (None on a mesh with no initialised group: a ``(1, 1)`` mesh, or
    a dry one of more ranks)."""

    def __init__(self, shape: Sequence[int],
                 coords: Optional[Sequence[int]] = None,
                 groups: Optional[Dict[str, object]] = None,
                 world=None):
        if len(shape) not in (2, 3):
            raise ValueError(f"a mesh has 2 or 3 axes, got shape {shape}")
        self.axis_names = AXES if len(shape) == 2 else POD_AXES
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        coords = (0,) * len(shape) if coords is None else coords
        self.coords = dict(zip(self.axis_names, coords))
        self.groups = groups
        self.world = world

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def rank(self) -> int:
        return self.index(self.axis_names)

    def axis_size(self, axis) -> int:
        """The ranks along ``axis`` (a tuple of axes: their product)."""
        if isinstance(axis, tuple):
            return math.prod(self.shape[a] for a in axis)
        return self.shape[axis]

    def index(self, axis) -> int:
        """This rank's coordinate along ``axis`` (``lax.axis_index``); for
        a tuple of axes the row-major index over them (the first axis
        major), as a spec entry ``("pod", "data")`` splits a dim."""
        if isinstance(axis, tuple):
            i = 0
            for a in axis:
                i = i * self.shape[a] + self.coords[a]
            return i
        return self.coords[axis]

    def _count(self, axis: str, kind: str, words: int,
               prim: str = "all-reduce", shape: Sequence[int] = (),
               dtype: torch.dtype = torch.float32) -> None:
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        COLLECTIVES.add(axis, kind, words, prim, shape, dtype)

    def _group(self, axis: str):
        return self.world if axis == MESH_AXIS else self.groups[axis]

    def _extent(self, axis: str) -> int:
        return self.size if axis == MESH_AXIS else self.shape[axis]

    def all_reduce(self, t: torch.Tensor, axis: str, kind: str = "round",
                   op: str = "sum", inplace: bool = False) -> torch.Tensor:
        """The sum (``op="max"``: the maximum) of ``t`` over the ranks
        along ``axis`` (``MESH_AXIS``: over every rank), on every one of
        them: a new tensor, ``t`` left as it was, or with ``inplace`` ``t``
        itself (contiguous) reduced.  Counted in ``COLLECTIVES``.  With no
        group ``t`` itself."""
        self._count(axis, kind, t.numel(), "all-reduce", t.shape, t.dtype)
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
        elements.  With no group ``t`` along an axis of one rank, else a
        new tensor of the gathered shape."""
        n = self._extent(axis)
        shape = list(t.shape)
        shape[dim] *= n
        self._count(axis, kind, t.numel() * n, "all-gather", shape, t.dtype)
        if self.groups is None:
            return t if n == 1 else t.new_empty(shape)
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
        of ``t`` (and the bytes of the chunk).  With no group ``t`` along
        an axis of one rank, else a new tensor of the chunk's shape."""
        n = self._extent(axis)
        shape = list(t.shape)
        shape[dim] //= n
        self._count(axis, kind, t.numel(), "reduce-scatter", shape, t.dtype)
        if self.groups is None:
            return t if n == 1 else t.new_empty(shape)
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
_MESHES: Dict[Tuple[int, ...], Mesh] = {}


def make_mesh(data: int = 1, model: int = 1,
              pod: Optional[int] = None) -> Mesh:
    """A ``(data, model)`` mesh (with ``pod``, ``(pod, data, model)``) over
    the initialised default group (every rank calls this with the same
    shape, in the same order: building the axis groups is collective), or
    the ``(1, 1)`` identity mesh when no group is initialised.  Meshes are
    cached per shape over the current default group (held by identity),
    so a fit that builds its mesh again reuses the groups, and a group
    initialised anew gets new ones."""
    shape = (data, model) if pod is None else (pod, data, model)
    if not dist.is_available() or not dist.is_initialized():
        if math.prod(shape) != 1:
            raise ValueError(f"a {shape} mesh needs an initialised default "
                             f"process group "
                             f"(torch.distributed.init_process_group)")
        return Mesh(shape)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} does not cover the {world} ranks "
                         f"of the default group")
    if any(m.world is not dist.group.WORLD for m in _MESHES.values()):
        _MESHES.clear()
    if shape not in _MESHES:
        names = AXES if pod is None else POD_AXES
        coords = []
        rest = dist.get_rank()
        for n in reversed(shape):
            rest, c = divmod(rest, n)
            coords.insert(0, c)
        strides = [math.prod(shape[k + 1:]) for k in range(len(shape))]
        groups = {}
        # every rank creates every group, axis by axis, each axis's lines
        # in the row-major order of the other axes' coordinates
        for k, name in enumerate(names):
            others = [range(n) if j != k else range(1)
                      for j, n in enumerate(shape)]
            for base in itertools.product(*others):
                ranks = [sum((base[j] if j != k else i) * strides[j]
                             for j in range(len(shape)))
                         for i in range(shape[k])]
                g = dist.new_group(ranks)
                if all(base[j] == coords[j] for j in range(len(shape))
                       if j != k):
                    groups[name] = g
        _MESHES[shape] = Mesh(shape, coords, groups, dist.group.WORLD)
    return _MESHES[shape]


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small ``(data, model)`` mesh over the initialised group's ranks,
    for tests and examples (the JAX module's ``make_host_mesh``)."""
    return make_mesh(data, model)


def make_production_mesh(*, multi_pod: bool = False,
                         coords: Optional[Sequence[int]] = None) -> Mesh:
    """The JAX package's production mesh as a dry mesh (module docstring):
    ``(data=16, model=16)``, 256 cards, or with ``multi_pod`` ``(pod=2,
    data=16, model=16)``, 512; ``coords`` the rank's coordinates (by
    default the first rank's)."""
    return Mesh((2, 16, 16) if multi_pod else (16, 16), coords)


def world_size() -> int:
    """Ranks of the initialised default group, or 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1
