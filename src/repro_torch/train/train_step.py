"""The LM training steps (the counterpart of ``repro/train/train_step.py``).

Eager PyTorch, SPMD over ``torch.distributed`` where a mesh is given
(``launch.mesh``: one process a rank, every rank the same calls).  Three
steps, each ``step(params, opt, batch) -> (params, opt, metrics)``:

* ``make_train_step(cfg, acfg, tcfg)``: one device.  The global batch is
  split into ``microbatches``; ``loss_fn`` runs forward and backward on
  each (the gradients sum in the params' ``.grad``, in place, as the JAX
  scan sums them); the sum is scaled by ``1 / microbatches`` and AdamW
  runs in place.
* ``make_train_step(..., rules=)``: FSDP + TP over the ``(data, model)``
  mesh, what the JAX package's GSPMD step does with its specs.  Each rank
  holds its shards of the params and of AdamW's m and v
  (``init_train_state(rules=)``) and takes its rows of each microbatch
  (the microbatch split over ``data``).  The sharded forward
  (``models.sharding.Sharded``) gathers each leaf at use and
  reduce-scatters its gradient, so a leaf split over ``data`` ends the
  backward with its summed gradient; the leaves replicated over
  ``data`` (the norm scales) are summed in one bucket per step, with the
  loss.
* ``make_defer_train_step(cfg, acfg, tcfg, rules)``: the paper's s-step
  schedule applied to LM data parallelism.  Params are replicated over
  ``data`` and TP-sharded over ``model`` (``defer_rules``).  The global
  batch is split over ``data`` in rank order; each rank runs its
  ``microbatches`` local microbatches in rounds of ``defer_s``, adds up
  a round's gradients locally (in one flat bucket, the params' ``.grad``
  are views into it), applies ``error_feedback_compress`` to them when
  ``compress_int8`` is set (the residual starts at zero each step, as in
  the JAX package, ROADMAP C19; the 256-entry blocks are the JAX
  package's, those of the full leaf stacked over layers, whatever the
  chunk a rank holds and the per-layer leaves it keeps), and makes ONE
  sync of gradient and loss over ``data`` a round, the bucket in one
  all-reduce where the JAX package reduces leaf by leaf (C20):
  ``microbatches / defer_s``
  syncs a step where the classical schedule (``defer_s = 1``) makes one
  a microbatch.  The sum is scaled by ``1 / (microbatches * n_data)``;
  then AdamW.

AdamW's clipping norm over sharded grads is one reduction over the mesh
of the ranks' squared partial norms, a leaf replicated over an axis
counted once (by the rank at coordinate 0 on that axis).
``step_collectives`` gives the collectives a step makes, by axis and
kind, from the config and the mesh (``decode_collectives`` those of a
sharded decode step); every call is counted in
``launch.mesh.COLLECTIVES``.  Every config runs through both sharded
steps: MLA's attention tensor-parallel on heads, the experts
expert-parallel on E, a Mamba block on its channels or heads, the
shared block and the encoder's layers as dense blocks, the decoder's
cross-attention on heads (under ``defer_rules`` too: its params are
replicated over ``data`` only).

On a mesh with ``pod`` (``launch.mesh.make_mesh(pod=)``, the JAX
production mesh's ``(pod, data, model)``) the batch splits over
``("pod", "data")``, params are replicated over ``pod`` (as the JAX
trainer's), and both steps sum each gradient bucket over ``pod`` after
its ``data`` sync (``_pod_sum``, counted as ``("pod", "grad")``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models import ModelConfig, init_params, loss_fn
from repro_torch.launch.mesh import MESH_AXIS
from repro_torch.models.lm import (abstract_params, decode_state_layout,
                                   param_specs)
from repro_torch.models.sharding import (MeshRules, Sharded, axis_extent,
                                         axis_index, batch_rows,
                                         chunk_shape, leaf_specs,
                                         replicated_axes, shard_tree,
                                         spec_at, split_axes)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import (BLOCK, block_scale, compress_one,
                                           quantize)
from repro_torch.tree import leaves, leaves_with_paths, unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    defer_s: int = 1            # sync gradients every defer_s microbatches
    compress_int8: bool = False


def _microbatches(batch: dict, nm: int) -> list:
    """``nm`` microbatches of equal size, each a dict of (B / nm, ...)
    slices along the batch axis: dim 0 of every entry but M-RoPE's
    (3, B, S) ``positions``, which split on dim 1 (as the JAX
    ``_microbatch`` splits them)."""
    B = batch["tokens"].shape[0]
    if B % nm:
        raise ValueError(f"global batch {B} is not a multiple of "
                         f"{nm} microbatches")
    n = B // nm

    def rows(k, v, i):
        if k == "positions" and v.ndim == 3:
            return v[:, i * n:(i + 1) * n]
        return v[i * n:(i + 1) * n]

    return [{k: rows(k, v, i) for k, v in batch.items()}
            for i in range(nm)]


def _accumulate(params, cfg: ModelConfig, mbs: list, rules=None):
    """The sum of ``loss_fn`` over the microbatches ``mbs`` (a 0-dim
    tensor) and of their gradients, in the leaves' ``.grad`` (which may
    be views into a bucket, added to in place) or zeros where a leaf got
    none.  ``requires_grad`` is on for the params only during the
    backward; ``.grad`` is cleared again on the way out."""
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    try:
        loss = None
        for mb in mbs:
            mb_loss = loss_fn(params, cfg, mb, rules=rules)
            mb_loss.backward()
            loss = mb_loss.detach() if loss is None else \
                loss + mb_loss.detach()
        grads = [torch.zeros_like(t) if t.grad is None else t.grad
                 for t in flat]
    finally:
        for t in flat:
            t.requires_grad_(False)
            t.grad = None
    return loss, grads


def loss_and_grads(params, cfg: ModelConfig, batch: dict,
                   microbatches: int = 1):
    """``(loss, grads)``: ``loss_fn``'s mean over ``microbatches`` equal
    slices of ``batch`` (a 0-dim tensor) and the gradient of every params
    leaf, in leaf order, summed over the microbatches in the leaves'
    ``.grad`` and scaled by ``1 / microbatches`` (the JAX package's
    ``value_and_grad`` and ``_grad_accum_scan``)."""
    for t in leaves(params):
        t.grad = None
    loss, grads = _accumulate(params, cfg,
                              _microbatches(batch, microbatches))
    if microbatches > 1:
        torch._foreach_mul_(grads, 1.0 / microbatches)
        loss = loss * (1.0 / microbatches)
    return loss, grads


def make_train_step(cfg: ModelConfig, acfg: AdamWConfig,
                    tcfg: TrainConfig, rules: Optional[MeshRules] = None):
    """``step(params, opt, batch) -> (params, opt, metrics)`` with metrics
    ``loss`` (the mean over microbatches), ``lr`` and ``grad_norm``
    (0-dim f32 tensors).  params and the AdamW state are updated in
    place and returned.  The batch (``tokens``, ``labels``: the global
    batch) may lie on the host; it is moved to the params' device.  With
    ``rules`` the step is the FSDP + TP one (module docstring): params
    and state are this rank's shards (``init_train_state(rules=)``), and
    metrics also hold ``sync_s`` (seconds in the step's syncs,
    ``_SyncTimer``)."""
    if tcfg.compress_int8 or tcfg.defer_s != 1:
        raise ValueError("defer_s and compress_int8 belong to the "
                         "deferred step: make_defer_train_step")
    nm = tcfg.microbatches
    if nm < 1:
        raise ValueError(f"microbatches must be >= 1, got {nm}")

    def step(params, opt, batch):
        dev = leaves(params)[0].device
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        loss, grads = loss_and_grads(params, cfg, batch, nm)
        params, opt, om = adamw_update(acfg, params,
                                       unflatten(params, grads), opt)
        return params, opt, {"loss": loss, **om}

    if rules is None:
        return step
    return _ShardedStep(cfg, acfg, tcfg, rules)


def defer_rules(rules: MeshRules) -> MeshRules:
    """The rules of the deferred step's params: replicated over ``data``
    (no FSDP), TP-sharded over ``model``."""
    return dataclasses.replace(rules, fsdp=None)


def make_defer_train_step(cfg: ModelConfig, acfg: AdamWConfig,
                          tcfg: TrainConfig, rules: MeshRules):
    """The s-step deferred-sync train step (module docstring).  params and
    the AdamW state are this rank's shards under ``defer_rules(rules)``
    (``init_train_state(rules=defer_rules(rules))``); the batch is the
    global batch.  metrics: ``loss``, ``lr``, ``grad_norm`` and
    ``sync_s`` (seconds in the step's syncs, ``_SyncTimer``)."""
    if rules is None:
        raise ValueError("the deferred step needs a mesh: rules=MeshRules"
                         "(launch.mesh.make_mesh(data, model))")
    nm, s = tcfg.microbatches, tcfg.defer_s
    if nm < 1 or s < 1 or nm % s:
        raise ValueError(f"defer_s ({s}) must divide microbatches ({nm})")
    return _DeferStep(cfg, acfg, tcfg, rules)


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     acfg: AdamWConfig, device=None,
                     rules: Optional[MeshRules] = None):
    """Random f32 params from ``gen`` on ``device`` (the card unless
    ``device="cpu"``) and their zero AdamW state; with ``rules`` this
    rank's shards of both (every rank draws the full params from the
    same seed and keeps its chunk)."""
    params = init_params(gen, cfg, device=device)
    if rules is not None:
        params = shard_tree(rules, params, param_specs(rules, cfg))
    return params, adamw_init(params)


# =========================================================================
# the sharded steps
# =========================================================================

def _rows(batch: dict, n: int, i: int) -> dict:
    """Chunk ``i`` of ``n`` of every entry along the batch axis."""
    return _microbatches(batch, n)[i]


def _local_batch(batch: dict, dev, nm: int, n_data: int) -> dict:
    """The batch on ``dev``, checked to split into ``nm`` microbatches
    on each of ``n_data`` ranks along the batch axes."""
    B = batch["tokens"].shape[0]
    if B % (nm * n_data):
        raise ValueError(f"global batch {B} does not split into {nm} "
                         f"microbatches on each of {n_data} data ranks")
    return {k: v.to(dev, non_blocking=True) for k, v in batch.items()}


class _SyncTimer:
    """Seconds a step spends in its gradient syncs.  On the card, CUDA
    events around each sync on the current stream, read once the step's
    update is queued (the host is never held back to time a sync); on
    the CPU, where gloo blocks, the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.events: list = []
        self.host_s = 0.0

    def __call__(self, fn) -> None:
        if not self.cuda:
            t0 = time.perf_counter()
            fn()
            self.host_s += time.perf_counter() - t0
            return
        stream = torch.cuda.current_stream(self.device)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record(stream)
        fn()
        ev[1].record(stream)
        self.events.append(ev)

    def seconds(self) -> float:
        """The total; on the card it waits for the last sync's end."""
        if self.events:
            self.events[-1][1].synchronize()
        return self.host_s + sum(a.elapsed_time(b)
                                 for a, b in self.events) / 1e3


class _Bucket:
    """One flat f32 buffer holding every params leaf's gradient (a view
    each, set as the leaf's ``.grad`` so that the backward adds into it)
    and one slot for the loss: the leaves marked ``first`` at the front,
    then the loss, then the rest, so that ``head`` is one contiguous
    tensor to sync."""

    def __init__(self, params, first: List[bool]):
        flat = leaves(params)
        order = ([i for i, f in enumerate(first) if f] + [None]
                 + [i for i, f in enumerate(first) if not f])
        self.at: List[Tuple[int, torch.Size]] = [None] * len(flat)
        off = 0
        for i in order:
            if i is None:
                self.loss_at, off = off, off + 1
            else:
                self.at[i] = (off, flat[i].shape)
                off += flat[i].numel()
        self.buf = torch.zeros(off, dtype=torch.float32,
                               device=flat[0].device)
        self.views = self.views_of(self.buf)
        self.loss = self.buf[self.loss_at]
        self.head = self.buf[:self.loss_at + 1]

    def views_of(self, buf: torch.Tensor) -> list:
        """The leaves' views in ``buf``, a buffer of this layout."""
        return [buf[o:o + shape.numel()].view(shape)
                for o, shape in self.at]

    def accumulate(self, params, cfg, mbs, rules) -> None:
        """Add the microbatches' gradients and loss sum into the bucket."""
        for t, v in zip(leaves(params), self.views):
            t.grad = v
        loss, _ = _accumulate(params, cfg, mbs, rules)
        self.loss.add_(loss.float())


def _sq_norm(mesh, grads, specs) -> torch.Tensor:
    """This rank's share of the squared gradient norm: a leaf counts on
    the ranks at coordinate 0 of every axis it is replicated over."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g, spec in zip(grads, specs):
        if all(mesh.index(a) == 0 for a in replicated_axes(mesh, spec)):
            total = total + torch.sum(torch.square(g.float()))
    return total


def _adamw(acfg, params, grads, opt, mesh, specs):
    """AdamW on sharded leaves, the clipping norm reduced over the mesh."""
    sq = mesh.all_reduce(_sq_norm(mesh, grads, specs), MESH_AXIS, "metric")
    return adamw_update(acfg, params, unflatten(params, grads), opt,
                        gnorm=torch.sqrt(sq))


def _batch_split(rules: MeshRules) -> Tuple[int, int]:
    """``(ranks, index)`` of this rank along the batch axes (``data``, or
    ``("pod", "data")``): the microbatches split into that many row
    chunks, this rank's at ``index``."""
    bax = rules.batch_axes
    return axis_extent(rules.mesh, bax), axis_index(rules.mesh, bax)


def _pod_sum(mesh, buf: torch.Tensor, timer) -> None:
    """On a mesh with ``pod``, the sum of a gradient bucket over it, in
    place: params are replicated over ``pod``, so every leaf's gradient
    is a sum over the pods of their partials."""
    if "pod" in mesh.axis_names:
        timer(lambda: mesh.all_reduce(buf, "pod", "grad", inplace=True))


class _ShardedStep:
    """The FSDP + TP step (``make_train_step(rules=)``)."""

    def __init__(self, cfg, acfg, tcfg, rules):
        self.cfg, self.acfg, self.nm, self.rules = (
            cfg, acfg, tcfg.microbatches, rules)
        self.mesh = rules.mesh

    def __call__(self, params, opt, batch):
        mesh, nm = self.mesh, self.nm
        n_data, d = _batch_split(self.rules)
        batch = _local_batch(batch, leaves(params)[0].device, nm, n_data)
        mbs = [_rows(mb, n_data, d) for mb in _microbatches(batch, nm)]
        specs = leaf_specs(param_specs(self.rules, self.cfg), params)
        # the leaves not split over data: their gradients are partial
        # sums of this rank's rows, summed over data in the bucket
        bucket = _Bucket(params, [
            self.rules.fsdp not in [a for _, a in split_axes(mesh, s)]
            for s in specs])
        bucket.accumulate(params, self.cfg, mbs, self.rules)
        timer = _SyncTimer(bucket.buf.device)
        timer(lambda: mesh.all_reduce(bucket.head, "data", "grad",
                                      inplace=True))
        _pod_sum(mesh, bucket.buf, timer)
        bucket.buf.mul_(1.0 / (nm * n_data))
        loss = bucket.loss.clone()
        params, opt, om = _adamw(self.acfg, params, bucket.views, opt,
                                 mesh, specs)
        return params, opt, {"loss": loss, **om,
                             "sync_s": timer.seconds()}


def _full_blocks(shape, dim: Optional[int], n: int, j: int, device,
                 offset: int = 0, total: Optional[int] = None):
    """The int8 block (of ``BLOCK`` elements) of every element of chunk
    ``j`` of ``n`` along ``dim`` of a leaf (``dim`` None: the whole leaf
    of ``shape``), in the chunk's flat order, and the block count.  The
    blocks are those of a flat array in which the full leaf starts at
    element ``offset`` and which holds ``total`` elements (by default the
    full leaf alone)."""
    if dim is None:
        idx = torch.arange(math.prod(shape), device=device)
        full = idx.numel()
    else:
        c = shape[dim]
        outer, inner = math.prod(shape[:dim]), math.prod(shape[dim + 1:])
        row = n * c * inner
        idx = (torch.arange(outer, device=device)[:, None] * row
               + j * c * inner
               + torch.arange(c * inner, device=device)[None, :]
               ).reshape(-1)
        full = outer * row
    total = full if total is None else total
    return (offset + idx) // BLOCK, -(-total // BLOCK)


class _DeferStep:
    """The s-step deferred-sync step (``make_defer_train_step``)."""

    def __init__(self, cfg, acfg, tcfg, rules):
        self.cfg, self.acfg, self.tcfg = cfg, acfg, tcfg
        self.rules = defer_rules(rules)
        self.mesh = rules.mesh

    @staticmethod
    def int8_groups(mesh, params, specs, period: int = 1) -> dict:
        """The leaves whose int8 blocks are not their own chunk's blocks
        (``params`` this rank's chunks, ``specs`` theirs), by the flat
        array whose blocks they take: ``{key: {"leaves": [(leaf index,
        (dim, n, axis) or None, offset)], "total": elements, "model":
        bool}}``.  The JAX package quantizes each logically full leaf,
        stacked over layers: a layer's leaf whose full size is not a
        multiple of BLOCK (a norm scale) shares blocks with its
        neighbours, so the layers of one name at one position of the
        pattern (``period`` its length) are one array, the layer of
        period p at offset p x its size, and the encoder's layers of one
        name another; a leaf split over ``model`` whose chunks cut its
        blocks takes the full leaf's.  Where a group holds a split leaf
        (``model``), its block maxima are reduced over ``model``."""
        groups: dict = {}
        for i, ((path, t), spec) in enumerate(zip(leaves_with_paths(params),
                                                  specs)):
            # params of the deferred step are split over model only
            split = next(((dim, mesh.shape[a], a)
                          for dim, a in split_axes(mesh, spec)), None)
            size = t.numel() * (split[1] if split else 1)
            if path[0] == "blocks" and size % BLOCK:
                p, pos = divmod(path[1], period)
                key, offset = ("stack", pos) + tuple(path[2:]), p * size
            elif path[:2] == ("encoder", "blocks") and size % BLOCK:
                key = ("encoder",) + tuple(path[3:])
                offset = path[2] * size
            elif split and (t.shape[split[0]]
                            * math.prod(t.shape[split[0] + 1:]) % BLOCK):
                key, offset = ("leaf", i), 0
            else:
                continue
            g = groups.setdefault(key, {"leaves": [], "total": 0,
                                        "model": False})
            g["leaves"].append((i, split, offset))
            g["total"] += size
            g["model"] |= split is not None
        return groups

    def _compress(self, views, resid, groups) -> None:
        """``error_feedback_compress`` on the round's local gradient, in
        place, in the JAX package's blocks: a leaf of ``groups``
        (``int8_groups``) takes its group's block maxima, reduced over
        ``model`` where the group holds a split leaf; every other leaf
        is its own array of blocks."""
        at, maxes = {}, {}
        for key, grp in groups.items():
            m = torch.zeros(-(-grp["total"] // BLOCK), dtype=torch.float32,
                            device=views[0].device)
            for i, split, offset in grp["leaves"]:
                tot = views[i].reshape(-1) + resid[i].reshape(-1)
                dim, n, a = split or (None, 1, None)
                j = self.mesh.index(a) if a else 0
                ids, _ = _full_blocks(tuple(views[i].shape), dim, n, j,
                                      tot.device, offset, grp["total"])
                m.scatter_reduce_(0, ids, tot.abs(), "amax")
                at[i] = (tot, ids, key)
            maxes[key] = m
        shared = [k for k, grp in groups.items() if grp["model"]]
        if shared:
            sizes = [maxes[k].numel() for k in shared]
            full = self.mesh.all_reduce(torch.cat([maxes[k] for k in shared]),
                                        "model", "grad", op="max")
            maxes.update(zip(shared, torch.split(full, sizes)))
        for i, (g, r) in enumerate(zip(views, resid)):
            if i in at:
                tot, ids, key = at[i]
                scale = block_scale(maxes[key])[ids]
                deq = quantize(tot, scale).float() * scale
                r.copy_((tot - deq).view(r.shape))
                g.copy_(deq.view(g.shape))
            else:
                deq, new_r = compress_one(g, r)
                g.copy_(deq)
                r.copy_(new_r)

    def __call__(self, params, opt, batch):
        mesh, tcfg = self.mesh, self.tcfg
        nm, s = tcfg.microbatches, tcfg.defer_s
        n_data, d = _batch_split(self.rules)
        batch = _local_batch(batch, leaves(params)[0].device, nm, n_data)
        mbs = _microbatches(_rows(batch, n_data, d), nm)
        flat = leaves(params)
        specs = leaf_specs(param_specs(self.rules, self.cfg), params)
        # the leaves whose int8 blocks span layers or model chunks: their
        # scales come from the blocks' maxima over the group, reduced
        # over model (one call a sync) where a chunk cuts them
        groups = (self.int8_groups(mesh, params, specs,
                                   len(self.cfg.pattern))
                  if tcfg.compress_int8 else {})
        rnd = _Bucket(params, [True] * len(flat))
        acc = None if nm == s else torch.zeros_like(rnd.buf)
        resid = ([torch.zeros_like(t, dtype=torch.float32) for t in flat]
                 if tcfg.compress_int8 else None)
        timer = _SyncTimer(rnd.buf.device)
        for r in range(nm // s):
            rnd.buf.zero_()
            rnd.accumulate(params, self.cfg, mbs[r * s:(r + 1) * s],
                           self.rules)
            if resid is not None:
                self._compress(rnd.views, resid, groups)
            # the s-step moment: one sync of s microbatches' gradients
            timer(lambda: mesh.all_reduce(rnd.buf, "data", "grad",
                                          inplace=True))
            _pod_sum(mesh, rnd.buf, timer)
            if acc is not None:
                acc.add_(rnd.buf)
        total = rnd.buf if acc is None else acc
        total.mul_(1.0 / (nm * n_data))
        params, opt, om = _adamw(self.acfg, params, rnd.views_of(total),
                                 opt, mesh, specs)
        return params, opt, {"loss": total[rnd.loss_at].clone(), **om,
                             "sync_s": timer.seconds()}


# =========================================================================
# the collectives a step makes
# =========================================================================

def _use_calls(calls, mesh, fsdp, spec, tp_dim, times, backward) -> None:
    """Add a leaf's gathers at ``times`` uses and, with ``backward``, the
    reduce-scatter of each ``data`` gather's gradient."""
    for d, a in split_axes(mesh, spec):
        if a == fsdp:
            _add(calls, a, "param", times + backward)
        elif d != tp_dim:
            _add(calls, a, "param", times)


def _add(calls, axis, kind, k=1) -> None:
    if k:
        calls[(axis, kind)] = calls.get((axis, kind), 0) + k


# The leaves of a tensor- or expert-parallel part that every model rank
# uses whole but that feed only its heads or experts: their gradients are
# sums of the ranks' partials, one ``tp`` reduction each in the backward
# (``Sharded.copy``).  Written out here, not read from ``Sharded.leaf_use``,
# so that a leaf the forward leaves out of ``copy`` changes the count.  A
# Mamba block's leaves that each rank slices to its channels or heads
# (``MAMBA_SLICED``: the dim, None where the leaf is always taken whole)
# sit behind ``copy`` where the spec does not split that dim over model.
COPIED = {"attn": ("q_norm", "k_norm", "w_dkv", "w_kr", "kv_norm"),
          "moe": ("router",)}
MAMBA_SLICED = {"mamba1": {"D": 0, "dt_bias": 0},
                "mamba2": {"conv_w": None, "D": 0, "dt_bias": 0,
                           "norm_scale": 0}}


def _part_calls(calls, tp, part, sub, bspec, times, backward) -> None:
    """The ``tp`` collectives of one tensor- or expert-parallel part
    (``sub`` its leaves, ``bspec`` their specs) at ``times`` forward
    passes, with ``backward`` its backward's."""
    # the output's reduction, and the input's gradient
    _add(calls, tp, "tp", times + backward)
    copied = [k for k in sub if k in COPIED.get(part, ())]
    if part == "cross":        # the encoder output's gradient
        copied.append("kv_x")
    if part == "mamba":
        row = "mamba1" if "x_proj" in sub else "mamba2"
        # in_proj's activation gathered (reduce-scattered back), and
        # Mamba-1's x_proj / Mamba-2's norm sum of squares summed both ways
        _add(calls, tp, "tp", 2 * (times + backward))
        copied += [k for k, d in MAMBA_SLICED[row].items()
                   if d is None or bspec[k][d] != tp]
    _add(calls, tp, "tp", backward * len(copied))


def _layer_calls(calls, cfg, r, sh, times, backward,
                 encoder: bool = True) -> None:
    """The collectives of every layer's leaves (``Sharded.leaf_use``) and
    tensor-parallel parts (``_part_calls``) at ``times`` forward passes,
    with ``backward`` the gradients' reduce-scatters and the backward's
    ``tp`` reductions: the decoder's layers, the shared block at each of
    its ``n_periods`` applications, and with ``encoder`` the encoder's
    layers."""
    specs, mesh = sh.specs, r.mesh
    full = abstract_params(cfg)
    layers = [(b, s, 1) for b, s in zip(full["blocks"], specs["blocks"])]
    if "shared_attn" in full:
        layers.append((full["shared_attn"], specs["shared_attn"],
                       cfg.n_periods))
    if encoder and "encoder" in full:
        layers += [(b, s, 1) for b, s in zip(full["encoder"]["blocks"],
                                             specs["encoder"]["blocks"])]
    for block, bspec, apps in layers:
        for path, _ in leaves_with_paths(block):
            spec = spec_at(bspec, path)
            tp_dim = sh.leaf_use(path, spec)[0]
            _use_calls(calls, mesh, r.fsdp, spec, tp_dim, apps * times,
                       apps * backward)
        for part, sub in block.items():
            if part in sh.tp_parts:
                _part_calls(calls, sh.tp, part, sub, bspec[part],
                            apps * times, apps * backward)


def step_collectives(cfg: ModelConfig, tcfg: TrainConfig, rules: MeshRules,
                     defer: bool) -> Dict[Tuple[str, str], int]:
    """Calls by ``(axis, kind)`` that one step of the sharded
    (``defer=False``) or the deferred step makes on every rank.  Per
    microbatch, in every layer (the decoder's, the encoder's, the shared
    block's at each application): a gather of each leaf split over an
    axis of more than one rank at each use (over ``model`` only where the
    tensor-parallel route does not keep the leaf split), a reduce-scatter
    of each ``data`` gather in the backward, one ``tp`` reduction of each
    tensor- or expert-parallel part's output (attention, cross-attention,
    MLP, experts, Mamba) and, in the backward, one for each part's input
    (the cross-attention's encoder output too) and each leaf behind
    ``copy`` (the q / k norm scales, MLA's ``w_dkv``, ``w_kr``,
    ``kv_norm``, the router, the Mamba leaves a rank slices where the
    spec leaves them whole); a tensor-parallel Mamba block also gathers
    its ``in_proj`` activation (a reduce-scatter back) and sums its
    ``x_proj`` product (Mamba-1) or its norm's sum of squares (Mamba-2)
    forward and backward; with remat a layer's forward collectives
    twice.  Per step:
    the sharded step's one ``grad`` bucket, the deferred step's
    ``microbatches / defer_s`` syncs (each an all-reduce over ``data``
    and, with int8 on leaves split over model whose chunks cut their
    blocks, a max over ``model``), on a mesh with ``pod`` each also
    summed over ``pod``; one ``metric`` reduction of the clipping
    norm."""
    r = defer_rules(rules) if defer else rules
    specs = param_specs(r, cfg)
    sh = Sharded(r, specs)
    mesh = rules.mesh
    per_mb: Dict[Tuple[str, str], int] = {}
    for key in ("embed", "embed" if cfg.tie_embeddings else "lm_head"):
        _use_calls(per_mb, mesh, r.fsdp, specs[key]["table"], None, 1, 1)
    _layer_calls(per_mb, cfg, r, sh, 2 if cfg.remat == "full" else 1, 1)
    calls = {key: k * tcfg.microbatches for key, k in per_mb.items()}
    pod = int("pod" in mesh.axis_names)
    if defer:
        syncs = tcfg.microbatches // tcfg.defer_s
        _add(calls, "data", "grad", syncs)
        _add(calls, "pod", "grad", pod * syncs)
        full = abstract_params(cfg)
        flat = leaf_specs(specs, full)
        chunks = unflatten(full, [
            torch.empty(chunk_shape(mesh, t.shape, sp), device="meta")
            for t, sp in zip(leaves(full), flat)])
        if tcfg.compress_int8 and any(
                g["model"] for g in
                _DeferStep.int8_groups(mesh, chunks, flat,
                                       len(cfg.pattern)).values()):
            _add(calls, "model", "grad", syncs)
    else:
        _add(calls, "data", "grad")
        _add(calls, "pod", "grad", pod)
    _add(calls, MESH_AXIS, "metric")
    return calls


def decode_collectives(cfg: ModelConfig, rules: MeshRules, batch: int,
                       max_seq: int) -> Dict[Tuple[str, str], int]:
    """Calls by ``(axis, kind)`` that one sharded ``decode_step`` of
    ``batch`` rows over a cache of ``max_seq`` positions makes on every
    rank: the vocab-parallel use of the two tables (``Sharded.lookup``,
    ``Sharded.project``), the gathers at use of every layer's leaves (the
    shared block's at each application), one ``tp`` reduction of each
    tensor- or expert-parallel part's output (a Mamba block's also its
    activation gather and its sum), and for each attention cache
    (``caches``, ``shared_cache``, ``cross_kv``) whose S is split one
    ``seq`` merge (for MLA whose heads are split over the same axis also
    the queries' ``seq`` gather and two ``param`` gathers, ``w_uk`` and
    ``w_uv``); for each Mamba state chunk the block takes whole
    (``lm.mamba_state_whole``) one ``tp`` gather.  The serving steps add
    their ``"token"`` gather (``sharding.gather_rows``)."""
    from repro_torch.models import MAMBA1, MAMBA2
    from repro_torch.models.lm import layer_kinds, mamba_state_whole
    specs = param_specs(rules, cfg)
    sh = Sharded(rules, specs)
    mesh = rules.mesh
    calls: Dict[Tuple[str, str], int] = {}
    split_rows = batch_rows(rules, batch) != slice(0, batch)
    for head in (False, True):
        key = ("embed" if cfg.tie_embeddings or not head else "lm_head")
        v_ax, d_ax = sh.table_axes(specs[key]["table"])
        if v_ax is not None:      # the rows' sum / the logits' gather
            _add(calls, v_ax, "param")
        if d_ax is not None:      # the rows' d gather / the partial logits'
            # reduction, after the rows' gather where the batch is split
            _add(calls, d_ax, "param", 1 + (head and split_rows))
    for spec in specs["final_norm"].values():
        _use_calls(calls, mesh, rules.fsdp, spec, None, 1, 0)
    _layer_calls(calls, cfg, rules, sh, 1, 0, encoder=False)
    sspecs = decode_state_layout(rules, cfg, batch, max_seq)
    attn = [(cs, cfg.attn_type == "mla") for kind, cs in
            zip(layer_kinds(cfg), sspecs["caches"])
            if kind not in (MAMBA1, MAMBA2)]
    attn += [(cs, cfg.attn_type == "mla")
             for cs in sspecs.get("shared_cache", ())]
    attn += [(cs, False) for cs in sspecs.get("cross_kv", ())]
    for cspec, mla in attn:
        split = [a for d, a in split_axes(mesh, cspec[0]) if d == 1]
        if split:
            every_head = (mla and "attn" in sh.tp_parts
                          and split[0] == sh.tp)
            _add(calls, split[0], "seq", 1 + every_head)
            _add(calls, split[0], "param", 2 * every_head)
    tp_on = "mamba" in sh.tp_parts
    for kind, cspecs in zip(layer_kinds(cfg), sspecs["caches"]):
        if kind in (MAMBA1, MAMBA2):
            for whole, sp in zip(mamba_state_whole(kind, tp_on), cspecs):
                if whole and any(a == rules.tp
                                 for _, a in split_axes(mesh, sp)):
                    _add(calls, rules.tp, "tp")
    return calls


__all__ = ["TrainConfig", "decode_collectives", "defer_rules",
           "init_train_state",
           "loss_and_grads", "make_defer_train_step", "make_train_step",
           "step_collectives"]
