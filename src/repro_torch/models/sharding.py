"""Sharding rules and the collectives of sharded params on a ``(data,
model)`` mesh (the counterpart of ``repro/models/sharding.py``, whose
rules it copies, and of what GSPMD does with them).

A spec is a tuple with one entry per dimension of a leaf: an axis name
of the mesh, or None where the dimension is not split.  ``param_spec``
is the JAX package's table row for row: weight matrices shard their
d_model dimension over ``data`` (FSDP) and their heads / d_ff / expert /
vocab dimension over ``model`` (TP / EP); each rule is checked for
divisibility against the mesh and falls back to replication for that
dimension.  The port keeps one dict per layer where the JAX package
stacks layers, so a block leaf here has one dimension fewer than JAX's
(``tree_pspecs`` applies the rule to the per-layer shape; ROADMAP C18
on the one rule that differs).

The port has no compiler to partition a program, so ``Sharded`` says how
a forward uses sharded params, as GSPMD would for these specs:

* a dimension on ``data`` is gathered at use (``Mesh.all_gather``) and
  the gradient of the gathered leaf is reduce-scattered back to the
  shards (``_Gather`` with ``reduce=True``): FSDP;
* the attention block and the MLP run tensor-parallel over ``model``
  where the specs split their heads / d_ff: column-parallel ``wq``,
  ``wk``, ``wv``, ``wi_gate``, ``wi_up`` and row-parallel ``wo``, one
  all-reduce of the block's output (``_ReduceFromTP``) and, in the
  backward, one of the gradient of its input (``_CopyToTP``);
* any other leaf split over ``model`` (the embedding and head tables on
  vocab, a spec that falls back to the d_model contraction, heads that
  do not divide ``model``) is gathered at use and its compute is
  replicated over ``model``: its gradient is the same on every rank
  along ``model``, so the backward keeps this rank's chunk
  (``_Gather`` with ``reduce=False``).  The JAX package shards the q
  rows over ``model`` instead where heads do not divide it (ROADMAP
  C21).

Every collective goes through ``launch.mesh.Mesh`` and is counted there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.tree import leaves, leaves_with_paths, unflatten

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: object                 # launch.mesh.Mesh
    fsdp: Optional[str] = "data"
    tp: Optional[str] = "model"

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in ("pod", "data")
                     if a in self.mesh.axis_names)

    def axis_size(self, name) -> int:
        if name is None:
            return 1
        if isinstance(name, tuple):
            return math.prod(self.axis_size(n) for n in name)
        return (self.mesh.shape[name] if name in self.mesh.axis_names
                else 0)

    def fit(self, shape, axes) -> Spec:
        """Right-align ``axes`` onto ``shape``; drop any axis that does
        not divide its dim (or is absent from the mesh)."""
        full = [None] * (len(shape) - len(axes)) + list(axes)
        out = []
        for dim, ax in zip(shape, full):
            size = self.axis_size(ax)
            out.append(ax if (ax is not None and size > 0
                              and dim % size == 0) else None)
        return tuple(out)


# ---- parameter rules: matched on (path substring, leaf name) -------------

def param_spec(rules: Optional[MeshRules], path: str, shape) -> Spec:
    """The spec of the leaf at ``path`` ("/"-joined keys) of ``shape``;
    the JAX package's ``param_spec``, rule for rule."""
    if rules is None:
        return (None,) * len(shape)
    F, T = rules.fsdp, rules.tp
    leaf = path.split("/")[-1]
    in_moe = "/moe/" in path or path.endswith("moe")
    table = {
        "table": (T, F),
        # attention
        "wq": (F, T, None),
        "wk": (F, T, None),
        "wv": (F, T, None),
        "wo": (T, None, F),
        # MLA
        "w_dkv": (F, None),
        "w_kr": (F, None),
        "w_uk": (None, T, None),
        "w_uv": (None, T, None),
        # mlp
        "wi_gate": (F, T),
        "wi_up": (F, T),
        # mamba
        "in_proj": (F, T),
        "conv_w": (T, None),
        "x_proj": (T, None),
        "dt_proj": (None, T),
        "A_log": (T, None),
        "D": (T,),
        "out_proj": (T, F),
        "dt_bias": (None,),
        "router": (F, None),
    }
    if in_moe and leaf in ("wi_gate", "wi_up"):
        axes = (T, F, None)            # (E, d, f): EP over model
    elif in_moe and leaf == "wo":
        axes = (T, None, F)            # (E, f, d)
    elif leaf == "wo" and len(shape) == 2:
        axes = (T, F)                  # plain mlp wo (f, d)
    elif leaf == "D" and len(shape) == 1 and shape[0] < 1024:
        axes = (None,)                 # mamba2 per-head D
    elif leaf in table:
        axes = table[leaf]
    else:
        axes = ()                      # norms, biases -> replicate

    # heads that do not divide the model axis: shard the d_model
    # contraction of a large q/k/v projection over model instead, and
    # wo's head_dim contraction (the JAX package's fallbacks, right-
    # aligned onto the last three dims)
    tsz = rules.axis_size(T)
    tail = tuple(shape[-3:])
    if leaf in ("wq", "wk", "wv") and len(shape) >= 3 and tsz > 0 \
            and tail[1] % tsz != 0 and tail[0] % tsz == 0 \
            and tail[1] * tail[2] * 2 >= tail[0]:
        axes = (T, None, F)            # (d->TP, heads, hd->FSDP)
    elif leaf == "wo" and len(shape) >= 3 and tsz > 0 \
            and tail[0] % tsz != 0 and tail[1] % tsz == 0:
        axes = (None, T, F)            # (h, hd->TP contraction, d->FSDP)
    return rules.fit(shape, axes)


def path_str(path) -> str:
    return "/".join(map(str, path))


def tree_pspecs(rules: Optional[MeshRules], params):
    """A tree of specs matching ``params`` (tensors, meta ones included),
    each leaf's from its path and full shape."""
    return unflatten(params, [param_spec(rules, path_str(p), tuple(t.shape))
                              for p, t in leaves_with_paths(params)])


def split_axes(mesh, spec: Spec):
    """``[(dim, axis), ...]`` of the dims ``spec`` splits over an axis of
    more than one rank."""
    return [(d, a) for d, a in enumerate(spec)
            if a is not None and mesh.shape[a] > 1]


def chunk_shape(mesh, shape, spec: Spec) -> list:
    """The shape of a rank's chunk of a leaf of ``shape``."""
    out = list(shape)
    for d, a in split_axes(mesh, spec):
        out[d] //= mesh.shape[a]
    return out


def shard_leaf(mesh, t: torch.Tensor, spec: Spec) -> torch.Tensor:
    """This rank's chunk of the full leaf ``t``: along each split dim the
    chunk at the rank's coordinate on that axis (a contiguous copy)."""
    for d, a in split_axes(mesh, spec):
        t = t.chunk(mesh.shape[a], d)[mesh.index(a)]
    return t.clone(memory_format=torch.contiguous_format)


def gather_leaf(mesh, t: torch.Tensor, spec: Spec,
                kind: str = "param") -> torch.Tensor:
    """The full leaf from every rank's chunk ``t`` (collective: every rank
    calls it for the same leaves in the same order)."""
    for d, a in split_axes(mesh, spec):
        t = mesh.all_gather(t, a, d, kind)
    return t


def spec_at(specs, path) -> Spec:
    """The spec at ``path`` (a leaf's keys) of a spec tree."""
    for k in path:
        specs = specs[k]
    return specs


def leaf_specs(specs, tree) -> list:
    """The spec of every leaf of ``tree``, in its leaf order, looked up
    by path (trees built elsewhere, ``convert.lm_params``'s, may order
    their keys otherwise)."""
    return [spec_at(specs, p) for p, _ in leaves_with_paths(tree)]


def shard_tree(rules: MeshRules, full, specs=None):
    """This rank's shards of every leaf of a tree of full leaves."""
    specs = tree_pspecs(rules, full) if specs is None else specs
    return unflatten(full, [shard_leaf(rules.mesh, t, s) for t, s in
                            zip(leaves(full), leaf_specs(specs, full))])


def gather_tree(rules: MeshRules, shards, specs):
    """The full leaves of a tree of this rank's shards (collective)."""
    return unflatten(shards, [gather_leaf(rules.mesh, t, s) for t, s in
                              zip(leaves(shards), leaf_specs(specs, shards))])


def replicated_axes(mesh, spec: Spec) -> Tuple[str, ...]:
    """The axes of more than one rank over which a leaf of ``spec`` is
    replicated (every rank along them holds the same chunk)."""
    return tuple(a for a in mesh.axis_names
                 if mesh.shape[a] > 1 and a not in spec)


# ---- the collectives of a sharded forward, differentiable ----------------

class _Gather(torch.autograd.Function):
    """Gather along ``axis`` into ``dim``, cast to ``dtype`` first (the
    compute dtype of a weight the forward casts at use anyway: the cast
    is elementwise, so gathering the cast chunks is casting the gathered
    leaf, in half the bytes for bf16).  Backward: the gradient back in
    the chunk's dtype, then its reduce-scatter (``reduce``: the compute
    after the gather differs along the axis, FSDP over data) or this
    rank's chunk of it (the compute is replicated along the axis)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim, reduce, dtype):
        ctx.mesh, ctx.axis, ctx.dim, ctx.reduce = mesh, axis, dim, reduce
        ctx.src = t.dtype
        return mesh.all_gather(t.to(dtype), axis, dim, "param")

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.mesh, ctx.axis, ctx.dim
        g = g.to(ctx.src)
        if ctx.reduce:
            g = mesh.reduce_scatter(g, axis, dim, "param")
        else:
            g = g.chunk(mesh.shape[axis], dim)[mesh.index(axis)]
        return g.contiguous(), None, None, None, None, None


class _CopyToTP(torch.autograd.Function):
    """The input of a column-parallel region: the identity; backward sums
    the gradient over ``model`` (each rank saw its heads' share)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axis, "tp"), None, None


class _ReduceFromTP(torch.autograd.Function):
    """The output of a row-parallel region: the sum over ``model`` of the
    ranks' partial products; backward the identity."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return mesh.all_reduce(t, axis, "tp")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


# the TP split dim of each leaf the tensor-parallel route splits, by the
# block part it belongs to (column-parallel on heads / d_ff, row-parallel
# on heads / d_ff)
TP_SPLITS = {"attn": {"wq": 1, "wk": 1, "wv": 1, "wo": 0},
             "mlp": {"wi_gate": 1, "wi_up": 1, "wo": 0}}


class Sharded:
    """How one forward uses params sharded by ``rules``: ``use`` gathers a
    leaf as far as its use needs, ``copy`` and ``reduce`` are the
    tensor-parallel pair (module docstring).  ``tp_parts`` names the
    block parts that run tensor-parallel: those whose every split leaf
    has its TP dim on ``model`` (heads and kv heads, or d_ff, divide it).
    ``dtype``: the compute dtype, in which the weight matrices (not the
    norm scales, nor the embedding table the forward indexes in f32) are
    gathered."""

    def __init__(self, rules: MeshRules, specs,
                 dtype: torch.dtype = torch.float32):
        self.rules, self.mesh, self.specs = rules, rules.mesh, specs
        self.dtype = dtype
        self.tp = rules.tp if (rules.tp is not None and
                               rules.axis_size(rules.tp) > 1) else None
        self.tp_parts = set()
        if self.tp is not None and specs["blocks"]:
            block = specs["blocks"][0]
            for part, splits in TP_SPLITS.items():
                if part in block and all(
                        block[part][name][d] == self.tp
                        for name, d in splits.items()):
                    self.tp_parts.add(part)

    def use(self, t: torch.Tensor, spec: Spec, tp_dim: Optional[int] = None,
            cast: bool = False) -> torch.Tensor:
        """``t`` gathered over ``data`` (FSDP) and over any other axis but
        at ``tp_dim`` (the dim a tensor-parallel use keeps split); with
        ``cast`` in the compute dtype where it is gathered."""
        dtype = self.dtype if cast else t.dtype
        for d, a in split_axes(self.mesh, spec):
            if a == self.rules.fsdp:
                t = _Gather.apply(t, self.mesh, a, d, True, dtype)
        for d, a in split_axes(self.mesh, spec):
            if a != self.rules.fsdp and d != tp_dim:
                t = _Gather.apply(t, self.mesh, a, d, False, dtype)
        return t

    def block(self, p: dict, spec: dict) -> dict:
        """A layer's params as its forward uses them: the TP parts' split
        leaves kept split on ``model``, their replicated leaves (the q / k
        norm scales) behind ``copy`` so that their gradient sums over the
        ranks' heads, everything else gathered."""
        out = {}
        for part, v in p.items():
            splits = TP_SPLITS.get(part, {}) if part in self.tp_parts else {}
            if isinstance(v, dict):
                out[part] = {}
                for name, t in v.items():
                    if isinstance(t, dict):    # q_norm / k_norm
                        w = self.use(t["scale"], spec[part][name]["scale"])
                        if part in self.tp_parts:
                            w = self.copy(w)
                        out[part][name] = {"scale": w}
                    else:
                        out[part][name] = self.use(t, spec[part][name],
                                                   splits.get(name), True)
            else:
                out[part] = self.use(v, spec[part])
        return out

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToTP.apply(x, self.mesh, self.tp)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromTP.apply(x, self.mesh, self.tp)


__all__ = ["MeshRules", "Sharded", "Spec", "TP_SPLITS", "chunk_shape",
           "gather_leaf", "gather_tree", "leaf_specs", "param_spec",
           "path_str", "replicated_axes", "shard_leaf", "shard_tree",
           "spec_at", "split_axes", "tree_pspecs"]
