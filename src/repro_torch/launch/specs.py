"""The inputs of every (architecture x shape) cell with their layout on a
mesh: the counterpart of ``repro/launch/specs.py``.

The JAX module returns ``ShapeDtypeStruct`` stand-ins with their
shardings attached.  Here each input is a ``TensorSpec``: a ``meta``
tensor of the full shape and dtype (no memory), its spec beside it (one
entry a dim: an axis name, a tuple of axes, or None; ``models.sharding``)
and the shape of one rank's chunk (``sharding.chunk_shape``).  The specs
come from the port's own rules, the ones its sharded entry points use:
``lm.param_specs`` for params, ``sharding.decode_state_specs`` (whose
``cache_spec`` is the JAX module's ``_cache_pspec``) for the decode
state.  The batch, the decode tokens, M-RoPE's (3, B, S) positions and
the audio frames take the JAX module's rules: their batch dim over the
batch axes (``("pod", "data")`` on a mesh with ``pod``) where it
divides.  AdamW's ``m`` and ``v`` mirror the params' specs; ``step`` is
replicated.

The port keeps one dict per layer where the JAX package stacks layers
over the pattern's periods, so a block leaf here has one dim fewer than
JAX's (ROADMAP C18 on the one param rule that differs); token ids and
positions are int32, as the JAX package's (the port's own decode state
keeps ``pos`` in int64).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.models import lm, sharding
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.sharding import (MeshRules, Spec, _one_axis,
                                         chunk_shape, leaf_specs)
from repro_torch.tree import leaves, map_tree, unflatten


# repro: noqa[CHK-TREE] a spec is one unit on purpose: its meta tensor
#   holds no data, and no tree function (device moves, health) may walk it
@dataclasses.dataclass(frozen=True, eq=False)
class TensorSpec:
    """One input of a cell: ``full`` a meta tensor of the full shape and
    dtype, ``spec`` its layout, ``chunk`` one rank's chunk shape."""

    full: torch.Tensor
    spec: Spec
    chunk: Tuple[int, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.full.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.full.dtype

    @property
    def chunk_bytes(self) -> int:
        n = 1
        for d in self.chunk:
            n *= d
        return n * self.full.element_size()

    def local(self, device="meta") -> torch.Tensor:
        """An uninitialised tensor of one rank's chunk on ``device``."""
        return torch.empty(self.chunk, dtype=self.dtype, device=device)


def _spec(rules: MeshRules, t: torch.Tensor, spec: Spec) -> TensorSpec:
    return TensorSpec(t, tuple(spec),
                      tuple(chunk_shape(rules.mesh, t.shape, spec)))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def param_specs(cfg: ModelConfig, rules: MeshRules):
    """The params of ``cfg`` (``lm.abstract_params``) with their FSDP + TP
    specs (``lm.param_specs``)."""
    full = lm.abstract_params(cfg)
    specs = leaf_specs(lm.param_specs(rules, cfg), full)
    return unflatten(full, [_spec(rules, t, s)
                            for t, s in zip(leaves(full), specs)])


def opt_specs(cfg: ModelConfig, rules: MeshRules):
    """AdamW's state: ``m`` and ``v`` f32 with the params' specs (ZeRO
    style), ``step`` a replicated int32 scalar."""
    params = param_specs(cfg, rules)

    def moment(p: TensorSpec) -> TensorSpec:
        return TensorSpec(_meta(p.shape, torch.float32), p.spec, p.chunk)

    return {"m": map_tree(moment, params), "v": map_tree(moment, params),
            "step": _spec(rules, _meta((), torch.int32), ())}


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, rules: MeshRules):
    """A training / prefill batch: ``tokens`` (and for training
    ``labels``) (B, S) int32, with M-RoPE ``positions`` (3, B, S) int32,
    with an encoder ``audio_embed`` (B, encoder_seq, d_model) f32; the
    batch dim of each over the batch axes where it divides."""
    B, S = shape.global_batch, shape.seq_len
    bax = _one_axis(rules.batch_axes)

    def entry(shp, dtype, axes):
        return _spec(rules, _meta(shp, dtype), rules.fit(shp, axes))

    batch = {"tokens": entry((B, S), torch.int32, [bax, None])}
    if shape.kind == "train":
        batch["labels"] = entry((B, S), torch.int32, [bax, None])
    if cfg.mrope:
        batch["positions"] = entry((3, B, S), torch.int32, [None, bax, None])
    if cfg.encoder_layers:
        batch["audio_embed"] = entry((B, cfg.encoder_seq, cfg.d_model),
                                     torch.float32, [bax, None, None])
    return batch


def decode_state_specs(cfg: ModelConfig, shape: ShapeConfig,
                       rules: MeshRules):
    """The decode state of ``global_batch`` rows over ``seq_len``
    positions (``lm.abstract_decode_state``, the encoder's ``cross_kv``
    too) with ``cache_spec``'s layout; ``pos`` replicated."""
    B, S = shape.global_batch, shape.seq_len
    full = lm.abstract_decode_state(cfg, B, S, bool(cfg.encoder_layers))
    specs = sharding.decode_state_specs(rules, cfg, full)
    return unflatten(full, [_spec(rules, t, s) for t, s in
                            zip(leaves(full), leaf_specs(specs, full))])


def decode_token_specs(shape: ShapeConfig, rules: MeshRules) -> TensorSpec:
    """A decode step's tokens: (B, 1) int32, B over the batch axes."""
    B = shape.global_batch
    shp = (B, 1)
    return _spec(rules, _meta(shp, torch.int32),
                 rules.fit(shp, [_one_axis(rules.batch_axes), None]))


def local_tree(tree, device="meta"):
    """Every ``TensorSpec`` of ``tree`` as one rank's chunk on
    ``device`` (uninitialised)."""
    return map_tree(lambda s: s.local(device), tree)


def chunk_bytes(tree) -> int:
    """The bytes of one rank's chunks of every ``TensorSpec`` of
    ``tree``."""
    return sum(s.chunk_bytes for s in leaves(tree))


__all__ = ["TensorSpec", "batch_specs", "chunk_bytes",
           "decode_state_specs", "decode_token_specs", "local_tree",
           "opt_specs", "param_specs"]
