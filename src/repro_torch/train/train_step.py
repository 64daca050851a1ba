"""The LM training step (the counterpart of ``make_train_step`` and
``init_train_state`` in ``repro/train/train_step.py``).

One device, eager PyTorch: the step splits the global batch into
``microbatches``, runs ``loss_fn`` forward and backward on each (the
gradients sum in the params' ``.grad``, in place, as the JAX scan sums
them), scales the sum by ``1 / microbatches`` and applies AdamW in
place.  The JAX package's other trainer, the s-step deferred gradient
sync (``make_defer_train_step``, with optional int8 compression), and
sharded params (``rules``) exist only across devices (``shard_map`` over
(pod, data)); they raise naming ROADMAP A11b.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import ModelConfig, init_params, loss_fn
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import leaves, unflatten

UNPORTED_DIST = ("{} exists only across devices and is not ported yet "
                 "(ROADMAP A11b)")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    defer_s: int = 1            # sync gradients every defer_s microbatches
    compress_int8: bool = False


def _microbatches(batch: dict, nm: int) -> list:
    """``nm`` microbatches of equal size, each a dict of (B / nm, ...)
    slices along the batch axis."""
    B = batch["tokens"].shape[0]
    if B % nm:
        raise ValueError(f"global batch {B} is not a multiple of "
                         f"{nm} microbatches")
    return [{k: v[i * (B // nm):(i + 1) * (B // nm)]
             for k, v in batch.items()} for i in range(nm)]


def loss_and_grads(params, cfg: ModelConfig, batch: dict,
                   microbatches: int = 1):
    """``(loss, grads)``: ``loss_fn``'s mean over ``microbatches`` equal
    slices of ``batch`` (a 0-dim tensor) and the gradient of every params
    leaf, in leaf order, summed over the microbatches in the leaves'
    ``.grad`` and scaled by ``1 / microbatches`` (the JAX package's
    ``value_and_grad`` and ``_grad_accum_scan``).  ``requires_grad`` is
    on for the params only during the backward."""
    flat = leaves(params)
    for t in flat:
        t.grad = None
        t.requires_grad_(True)
    try:
        loss = None
        for mb in _microbatches(batch, microbatches):
            mb_loss = loss_fn(params, cfg, mb)
            mb_loss.backward()
            loss = mb_loss.detach() if loss is None else \
                loss + mb_loss.detach()
        grads = [torch.zeros_like(t) if t.grad is None else t.grad
                 for t in flat]
    finally:
        for t in flat:
            t.requires_grad_(False)
            t.grad = None
    if microbatches > 1:
        torch._foreach_mul_(grads, 1.0 / microbatches)
        loss = loss * (1.0 / microbatches)
    return loss, grads


def make_train_step(cfg: ModelConfig, acfg: AdamWConfig,
                    tcfg: TrainConfig, rules=None):
    """``step(params, opt, batch) -> (params, opt, metrics)`` with metrics
    ``loss`` (the mean over microbatches), ``lr`` and ``grad_norm``
    (0-dim f32 tensors).  params and the AdamW state are updated in
    place and returned.  The batch (``tokens``, ``labels``) may lie on
    the host; it is moved to the params' device."""
    if rules is not None:
        raise NotImplementedError(UNPORTED_DIST.format("sharding (rules)"))
    if tcfg.compress_int8 or tcfg.defer_s != 1:
        raise NotImplementedError(UNPORTED_DIST.format(
            "the deferred gradient sync (defer_s, compress_int8)"))
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

    return step


def make_defer_train_step(cfg: ModelConfig, acfg: AdamWConfig,
                          tcfg: TrainConfig, rules=None):
    raise NotImplementedError(UNPORTED_DIST.format(
        "the s-step deferred-allreduce train step"))


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     acfg: AdamWConfig, device=None):
    """Random f32 params from ``gen`` on ``device`` (the card unless
    ``device="cpu"``) and their zero AdamW state."""
    params = init_params(gen, cfg, device=device)
    return params, adamw_init(params)

