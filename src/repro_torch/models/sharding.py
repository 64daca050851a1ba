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
* the attention block, the decoder's cross-attention and the MLP run
  tensor-parallel over ``model`` where the specs split their heads /
  d_ff: column-parallel ``wq``, ``wk``, ``wv`` (MLA: ``wq``, ``w_uk``,
  ``w_uv``), ``wi_gate``, ``wi_up`` and row-parallel ``wo``, one
  all-reduce of the block's output (``_ReduceFromTP``) and, in the
  backward, one of the gradient of its input (``_CopyToTP``; the
  cross-attention's encoder output too); the experts of a MoE block run
  expert-parallel where the specs split their E axis over ``model``
  (each rank its experts, one all-reduce of the partial output).  A
  leaf of such a part that every rank along ``model`` uses whole but
  that feeds only the rank's heads or experts (the q / k norm scales,
  MLA's ``w_dkv``, ``w_kr`` and ``kv_norm``, the router) sits behind
  ``_CopyToTP`` too: its gradient is a sum over ``model`` of partials.
  The parts are found in every layer: the decoder's, the encoder's and
  the hybrid pattern's shared block;
* a Mamba block runs tensor-parallel over its ``d_inner`` channels
  (Mamba-1) or its heads (Mamba-2) where the specs split ``in_proj``'s
  columns, ``out_proj``'s rows and the per-channel leaves over
  ``model``: ``in_proj`` column-parallel on the spec's own chunk of
  columns, whose output is gathered over ``model`` (its gradient
  reduce-scattered back, ``gather_act``) because a contiguous chunk of
  ``[x | z]`` (Mamba-2: ``[z | x | B | C | dt]``) does not hold matching
  channels; each rank then takes its channels (Mamba-2: its heads' z, x
  and dt, B and C whole), ``out_proj`` row-parallel (the block's one
  ``reduce``).  Mamba-1's ``x_proj`` is row-parallel and its sum is used
  per rank (``all_sum``: forward and backward each one all-reduce), as
  is Mamba-2's sum of squares of its gated norm.  A leaf a rank slices
  to its channels or heads where the spec does not split it (``D``,
  ``dt_bias``, Mamba-2's ``norm_scale`` and its ``conv_w``, whose
  contiguous chunk does not hold ``[x_r | B | C]``) is gathered whole
  behind ``_CopyToTP``;
* any other leaf split over ``model`` (the embedding and head tables on
  vocab, a spec that falls back to the d_model contraction, heads that
  do not divide ``model``) is gathered at use and its compute is
  replicated over ``model``: its gradient is the same on every rank
  along ``model``, so the backward keeps this rank's chunk
  (``_Gather`` with ``reduce=False``).  The JAX package shards the q
  rows over ``model`` instead where heads do not divide it (ROADMAP
  C21);
* sharded decode uses the embedding and head tables vocab-parallel
  instead (``lookup``, ``project``): the rows and the logits move, the
  tables stay split.

The decode state is laid out by ``cache_spec`` (the JAX package's
``launch/specs._cache_pspec``, rule for rule, on the port's per-layer
caches): ``pos`` replicated; a GQA cache (B, S, kv, hd) with its batch
over ``data`` where B divides, its kv heads over ``model`` where they
divide and else S over ``model``, and S over ``data`` where B does not
divide (the shared block's ``shared_cache`` and the decoder's
``cross_kv`` too); MLA's latent ``c`` and rope key ``k_rope`` with S
over ``model``; the Mamba states' channels or heads over ``model``.  A
cache whose S is split is read by the split-S attention of
``models.attention`` (each rank its chunk, the partial softmaxes merged
over the axis).  A Mamba state chunk that the block needs whole
(Mamba-2's conv state, whose contiguous chunk is not the rank's
channels; any state of a block computed replicated) is gathered over
``model`` at the step and the rank keeps its chunk of the new one.

Every collective goes through ``launch.mesh.Mesh`` and is counted there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.tree import leaves, leaves_with_paths, unflatten

from .config import ATTN, DENSE, MOE

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


# ---- decode-state rules ---------------------------------------------------

def _one_axis(axes):
    """A tuple of one axis name as the name; the batch axes of a mesh
    with ``pod`` stay the tuple ``("pod", "data")``, one spec entry, as
    in the JAX package's specs."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def cache_spec(rules: Optional[MeshRules], cfg, path: str, shape) -> Spec:
    """The spec of the decode-state leaf at ``path`` of ``shape``: the JAX
    package's ``_cache_pspec`` with its stacked layer axis dropped (the
    port keeps one cache per layer; ``caches/<layer>/<j>`` takes its
    block kind from the layer, ``shared_cache/...`` and ``cross_kv/...``
    are attention caches).  ``pos`` is replicated."""
    shape = tuple(shape)
    if rules is None or path.endswith("pos"):
        return (None,) * len(shape)
    bax, tp, F = _one_axis(rules.batch_axes), rules.tp, rules.fsdp
    b_ok = (len(shape) > 0
            and shape[0] % max(rules.axis_size(bax), 1) == 0)
    b = bax if b_ok else None
    kind = None
    parts = path.split("/")
    if parts[0] == "caches" and len(parts) > 1:
        kind = (list(cfg.pattern) * cfg.n_periods)[int(parts[1])]
    elif parts[0] in ("shared_cache", "cross_kv"):
        kind = ATTN
    if kind in (DENSE, MOE, ATTN):
        if cfg.attn_type == "mla" and parts[0] == "caches":
            return rules.fit(shape, [b, tp, None])        # (B, S, r | rd)
        kv_ok = shape[2] % rules.axis_size(tp) == 0       # (B, S, kv, hd)
        if b_ok:
            return rules.fit(shape, [b, None if kv_ok else tp,
                                     tp if kv_ok else None, None])
        return rules.fit(shape, [None, F, tp if kv_ok else None, None])
    # Mamba states
    if len(shape) == 4:                        # mamba2 h (B, nh, hd, n)
        return rules.fit(shape, [b, tp, None, None])
    if parts[-1] == "0" or shape[-1] > cfg.ssm_state:
        return rules.fit(shape, [b, None, tp])  # conv state (B, K-1, C)
    return rules.fit(shape, [b, tp, None])      # mamba1 h (B, di, n)


def decode_state_specs(rules: Optional[MeshRules], cfg, state):
    """A tree of specs matching the tensors of a decode ``state`` of full
    shapes (``lm.abstract_decode_state``), each by ``cache_spec``; other
    entries (``max_seq``) kept as they are."""
    return unflatten(state, [
        cache_spec(rules, cfg, path_str(p), t.shape)
        if isinstance(t, torch.Tensor) else t
        for p, t in leaves_with_paths(state)])


def batch_rows(rules: Optional[MeshRules], batch: int) -> slice:
    """The rows of a batch of ``batch`` that this rank computes: its chunk
    over the batch axes (``data``, with ``pod`` ``("pod", "data")``, pod
    major) where the batch divides (``decode_token_specs``), else all of
    them (the compute replicated over them)."""
    if rules is None:
        return slice(0, batch)
    bax = rules.batch_axes
    n = rules.axis_size(bax)
    if n <= 1 or batch % n:
        return slice(0, batch)
    i = axis_index(rules.mesh, bax)
    return slice(i * (batch // n), (i + 1) * (batch // n))


def gather_rows(rules: Optional[MeshRules], t: torch.Tensor,
                batch: int) -> torch.Tensor:
    """All ``batch`` rows of ``t`` (dim 0) on every rank, from each rank's
    ``batch_rows``: one counted gather over each batch axis of more than
    one rank (kind ``"token"``; ``data`` first, then ``pod``) where the
    batch is split, else ``t``."""
    if batch_rows(rules, batch) == slice(0, batch):
        return t
    for a in reversed(rules.batch_axes):
        if rules.axis_size(a) > 1:
            t = rules.mesh.all_gather(t, a, 0, "token")
    return t


def axis_extent(mesh, axis) -> int:
    """The ranks along a spec entry: an axis name, or a tuple of them
    (their product)."""
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def axis_index(mesh, axis) -> int:
    """This rank's coordinate along a spec entry (for a tuple of axes the
    row-major index over them, the first major)."""
    if isinstance(axis, tuple):
        i = 0
        for a in axis:
            i = i * mesh.shape[a] + mesh.index(a)
        return i
    return mesh.index(axis)


def split_axes(mesh, spec: Spec):
    """``[(dim, axis), ...]`` of the dims ``spec`` splits over an axis (or
    a tuple of axes) of more than one rank."""
    return [(d, a) for d, a in enumerate(spec)
            if a is not None and axis_extent(mesh, a) > 1]


def chunk_shape(mesh, shape, spec: Spec) -> list:
    """The shape of a rank's chunk of a leaf of ``shape``."""
    out = list(shape)
    for d, a in split_axes(mesh, spec):
        out[d] //= axis_extent(mesh, a)
    return out


def shard_leaf(mesh, t: torch.Tensor, spec: Spec) -> torch.Tensor:
    """This rank's chunk of the full leaf ``t``: along each split dim the
    chunk at the rank's coordinate on that axis (a contiguous copy)."""
    for d, a in split_axes(mesh, spec):
        t = t.chunk(axis_extent(mesh, a), d)[axis_index(mesh, a)]
    return t.clone(memory_format=torch.contiguous_format)


def gather_leaf(mesh, t: torch.Tensor, spec: Spec,
                kind: str = "param") -> torch.Tensor:
    """The full leaf from every rank's chunk ``t`` (collective: every rank
    calls it for the same leaves in the same order; a dim split over a
    tuple of axes is gathered over its last axis first)."""
    for d, a in split_axes(mesh, spec):
        for ax in (reversed(a) if isinstance(a, tuple) else (a,)):
            if mesh.shape[ax] > 1:
                t = mesh.all_gather(t, ax, d, kind)
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
    used = {x for a in spec if a is not None
            for x in (a if isinstance(a, tuple) else (a,))}
    return tuple(a for a in mesh.axis_names
                 if mesh.shape[a] > 1 and a not in used)


# ---- the collectives of a sharded forward, differentiable ----------------

class _Gather(torch.autograd.Function):
    """Gather along ``axis`` into ``dim``, cast to ``dtype`` first (the
    compute dtype of a weight the forward casts at use anyway: the cast
    is elementwise, so gathering the cast chunks is casting the gathered
    leaf, in half the bytes for bf16).  Backward: the gradient back in
    the chunk's dtype, then its reduce-scatter (``reduce``: the compute
    after the gather differs along the axis, FSDP over data) or this
    rank's chunk of it (the compute is replicated along the axis).  Both
    counted as ``kind`` (a leaf's ``"param"``, an activation's ``"tp"``)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim, reduce, dtype, kind="param"):
        ctx.mesh, ctx.axis, ctx.dim, ctx.reduce = mesh, axis, dim, reduce
        ctx.src, ctx.kind = t.dtype, kind
        return mesh.all_gather(t.to(dtype), axis, dim, kind)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.mesh, ctx.axis, ctx.dim
        g = g.to(ctx.src)
        if ctx.reduce:
            g = mesh.reduce_scatter(g, axis, dim, ctx.kind)
        else:
            g = g.chunk(mesh.shape[axis], dim)[mesh.index(axis)]
        return g.contiguous(), None, None, None, None, None, None


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
# on heads / d_ff; the experts of a MoE block on E; a Mamba block's
# in_proj columns, out_proj rows and, for Mamba-1, every per-channel
# matrix on d_inner, for Mamba-2 A_log on heads); an MLA block's attention
# takes the "mla" row, a Mamba block the row of its kind (``part_row``)
TP_SPLITS = {"attn": {"wq": 1, "wk": 1, "wv": 1, "wo": 0},
             "mla": {"wq": 1, "w_uk": 1, "w_uv": 1, "wo": 0},
             "cross": {"wq": 1, "wk": 1, "wv": 1, "wo": 0},
             "mlp": {"wi_gate": 1, "wi_up": 1, "wo": 0},
             "moe": {"wi_gate": 0, "wi_up": 0, "wo": 0},
             "mamba1": {"in_proj": 1, "conv_w": 0, "x_proj": 0,
                        "dt_proj": 1, "A_log": 0, "out_proj": 0},
             "mamba2": {"in_proj": 1, "A_log": 0, "out_proj": 0}}
# the leaves of a tensor-parallel Mamba block that each rank slices to its
# channels / heads along a dim: kept split where the spec splits that dim
# over model (the chunk is the rank's), else gathered whole behind
# ``copy``; None: always gathered whole (Mamba-2's conv_w, whose chunk is
# not the rank's [x_r | B | C])
TP_SLICED = {"mamba1": {"D": 0, "dt_bias": 0},
             "mamba2": {"D": 0, "dt_bias": 0, "norm_scale": 0,
                        "conv_w": None}}
# leaves a forward uses in f32 whatever its compute dtype: never gathered
# in the compute dtype
UNCAST = ("scale", "bias", "A_log", "D", "dt_bias", "norm_scale")


def part_row(part: str, names) -> str:
    """The ``TP_SPLITS`` row's name of a block part whose leaves are
    ``names``."""
    if part == "attn" and "w_uk" in names:
        return "mla"
    if part == "mamba":
        return "mamba1" if "x_proj" in names else "mamba2"
    return part


def model_blocks(specs) -> list:
    """Every layer's dict of a params (or specs) tree: the decoder's
    blocks, the hybrid pattern's shared block, the encoder's blocks."""
    out = list(specs["blocks"])
    if "shared_attn" in specs:
        out.append(specs["shared_attn"])
    if "encoder" in specs:
        out.extend(specs["encoder"]["blocks"])
    return out


class Sharded:
    """How one forward uses params sharded by ``rules``: ``use`` gathers a
    leaf as far as its use needs, ``copy`` and ``reduce`` are the
    tensor-parallel pair (module docstring).  ``tp_parts`` names the
    block parts that run tensor- or expert-parallel: those whose every
    split leaf of their ``TP_SPLITS`` row has its TP dim on ``model``
    (heads and kv heads, d_ff, E or d_inner divide it), looked for in
    every layer (``model_blocks``).  ``dtype``: the compute dtype, in
    which the weight matrices (not the norm scales, the Mamba leaves
    used in f32, nor the embedding table the forward indexes in f32) are
    gathered."""

    def __init__(self, rules: MeshRules, specs,
                 dtype: torch.dtype = torch.float32):
        self.rules, self.mesh, self.specs = rules, rules.mesh, specs
        self.dtype = dtype
        self.tp = rules.tp if (rules.tp is not None and
                               rules.axis_size(rules.tp) > 1) else None
        self.tp_parts, self.splits, self.sliced = set(), {}, {}
        if self.tp is not None:
            for block in model_blocks(specs):
                for part, v in block.items():
                    row = part_row(part, v)
                    splits = TP_SPLITS.get(row, {})
                    if splits and part not in self.splits and all(
                            v[name][d] == self.tp
                            for name, d in splits.items()):
                        self.tp_parts.add(part)
                        self.splits[part] = splits
                        self.sliced[part] = TP_SLICED.get(row, {})

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

    def leaf_use(self, path, spec: Optional[Spec] = None
                 ) -> Tuple[Optional[int], bool, bool]:
        """``(tp_dim, cast, copy)`` of the block leaf at ``path`` (its keys
        in the layer's dict) of ``spec``: in a tensor-parallel part a leaf
        of its ``TP_SPLITS`` row stays split at its TP dim; a Mamba leaf
        of ``TP_SLICED`` stays split where ``spec`` splits its dim over
        ``model``, else it is gathered whole and put behind ``copy``; a
        leaf that feeds only the rank's heads or experts (a norm scale or
        bias of the part, MLA's ``w_dkv`` / ``w_kr``, the router) is
        gathered whole, uncast, and put behind ``copy``; a sub-MLP of the
        part (the shared experts, Arctic's dense residual) is gathered and
        computed whole on every rank.  Matrices are gathered in the
        compute dtype, the ``UNCAST`` leaves in f32."""
        part, name = path[0], path[1]
        cast = path[-1] not in UNCAST
        if part not in self.tp_parts:
            return None, cast, False
        if len(path) == 2 and name in self.splits[part]:
            return self.splits[part][name], cast, False
        if len(path) == 2 and name in self.sliced[part]:
            d = self.sliced[part][name]
            if d is not None and spec is not None and spec[d] == self.tp:
                return d, cast, False
            return None, cast, True
        if len(path) == 2 or path[-1] in ("scale", "bias"):
            return None, False, True
        return None, True, False

    def block(self, p: dict, spec: dict) -> dict:
        """A layer's params as its forward uses them (``leaf_use``)."""
        out = []
        for path, t in leaves_with_paths(p):
            sp = spec_at(spec, path)
            tp_dim, cast, copy = self.leaf_use(path, sp)
            w = self.use(t, sp, tp_dim, cast)
            out.append(self.copy(w) if copy else w)
        return unflatten(p, out)

    def table_axes(self, spec: Spec):
        """The (vocab, d_model) axes a table's spec splits (None where it
        does not); its d_model only ever over the FSDP axis."""
        axes = [a if a is not None and self.mesh.shape[a] > 1 else None
                for a in spec]
        if axes[1] not in (None, self.rules.fsdp):
            raise ValueError(f"a table split as {spec}")
        return axes

    def lookup(self, table: torch.Tensor, spec: Spec,
               tokens: torch.Tensor) -> torch.Tensor:
        """The table's rows at ``tokens`` (every rank the same tokens), f32,
        from this rank's chunk, the table not gathered: the rows outside
        the chunk's vocab range zeroed and summed over its vocab axis
        (one non-zero term: exact), their d_model chunks gathered over
        FSDP (kind ``"param"`` both).  Sharded decode's embedding."""
        v_ax, d_ax = self.table_axes(spec)
        if v_ax is None:
            rows = table[tokens]
        else:
            n = table.shape[0]
            idx = tokens - self.mesh.index(v_ax) * n
            inside = (idx >= 0) & (idx < n)
            rows = table[idx.clamp(0, n - 1)] * inside[..., None]
            rows = self.mesh.all_reduce(rows, v_ax, "param")
        if d_ax is not None:
            rows = self.mesh.all_gather(rows, d_ax, rows.ndim - 1, "param")
        return rows

    def project(self, x: torch.Tensor, table: torch.Tensor, spec: Spec,
                rows: slice, batch: int) -> torch.Tensor:
        """``unembed``: f32 logits over the full vocab of this rank's rows
        ``x`` (``rows`` of a batch of ``batch``), the product in x's dtype,
        from this rank's chunk of the table, the table not gathered:
        where its d_model is split over FSDP, the partial products of the
        rank's d chunk over every row (the rows gathered over that axis
        where the batch is split there), summed in f32 over the axis
        (reduce-scattered back to the rows, or all-reduced); then the
        vocab chunks gathered (kind ``"param"`` all).  Sharded decode's
        head."""
        v_ax, d_ax = self.table_axes(spec)
        w = table.to(x.dtype)
        if d_ax is None:
            logits = (x @ w.T).float()
        else:
            split = rows != slice(0, batch)
            if split:
                x = self.mesh.all_gather(x, d_ax, 0, "param")
            d = table.shape[1]
            j = self.mesh.index(d_ax)
            logits = (x[..., j * d:(j + 1) * d] @ w.T).float()
            logits = (self.mesh.reduce_scatter(logits, d_ax, 0, "param")
                      if split else
                      self.mesh.all_reduce(logits, d_ax, "param"))
        if v_ax is not None:
            logits = self.mesh.all_gather(logits, v_ax, logits.ndim - 1,
                                          "param")
        return logits

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToTP.apply(x, self.mesh, self.tp)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromTP.apply(x, self.mesh, self.tp)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ``model`` of the ranks' partials ``x``, where each
        rank uses the sum for its own channels: one all-reduce forward,
        one of the gradient backward (``copy`` after ``reduce``)."""
        return self.copy(self.reduce(x))

    def gather_act(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' chunks of an activation ``x`` gathered over ``model``
        along ``dim`` (kind ``"tp"``), its gradient reduce-scattered back:
        every rank uses other parts of the whole."""
        return _Gather.apply(x, self.mesh, self.tp, dim % x.ndim, True,
                             x.dtype, "tp")

    def index(self) -> int:
        """This rank's coordinate along the tensor-parallel axis."""
        return self.mesh.index(self.tp)

    def size(self) -> int:
        """The ranks along the tensor-parallel axis."""
        return self.mesh.shape[self.tp]

    def own(self, t: torch.Tensor, n: int, dim: int) -> torch.Tensor:
        """This rank's contiguous chunk of the ``n`` channels (or heads)
        of ``t`` along ``dim``; ``t`` itself where it holds the chunk
        already (a leaf the spec split there).  Any other width raises."""
        c = n // self.size()
        if t.shape[dim] == c:
            return t
        if t.shape[dim] != n:
            raise ValueError(f"own: {tuple(t.shape)} along dim {dim} holds "
                             f"neither the {n} channels nor a chunk of {c}")
        return t.narrow(dim, self.index() * c, c)


__all__ = ["MeshRules", "Sharded", "Spec", "TP_SLICED", "TP_SPLITS",
           "UNCAST", "axis_extent", "axis_index", "batch_rows",
           "cache_spec", "chunk_shape",
           "decode_state_specs", "gather_leaf", "gather_rows", "gather_tree",
           "leaf_specs", "model_blocks", "param_spec", "part_row",
           "path_str", "replicated_axes", "shard_leaf",
           "shard_tree", "spec_at", "split_axes", "tree_pspecs"]
