"""AdamW with bias correction, decoupled weight decay, global-norm clip
and a linear-warmup + cosine-decay schedule, as plain functions on the
params tree (the counterpart of ``repro/optim/adamw.py``; not
``torch.optim.AdamW``, whose clip, schedule and decay differ).

The update follows the JAX one operation by operation in f32.  It works
in place: the params and the moments ``m`` and ``v`` are updated where
they lie and returned (the JAX step donates them; at Qwen3-1.7B width a
second copy of each would be 8.13 GB).  The step count lives on the
host, so the schedule never waits for the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.tree import leaves, leaves_with_paths, map_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def adamw_init(params) -> dict:
    """Zero f32 moments shaped like the params, and ``step`` 0 (a 0-dim
    int32 tensor on the host)."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


def schedule(cfg: AdamWConfig, step) -> float:
    """The learning rate at ``step`` (1-based after the first update):
    linear warmup to ``lr``, then cosine decay to ``lr * min_lr_ratio``
    at ``total_steps``; in f32 arithmetic, as the JAX package computes
    it."""
    f = np.float32
    s = f(int(step))
    warm = np.minimum(s / f(max(cfg.warmup_steps, 1)), f(1.0))
    frac = np.clip((s - f(cfg.warmup_steps))
                   / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f(0.0), f(1.0))
    cos = f(0.5) * (f(1.0) + np.cos(f(np.pi) * frac))
    return float(f(cfg.lr) * warm * (f(cfg.min_lr_ratio)
                                     + (f(1.0) - f(cfg.min_lr_ratio)) * cos))


def global_norm(tree) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf, in f32 (a 0-dim tensor on
    the leaves' device)."""
    norms = [torch.linalg.vector_norm(x, dtype=torch.float32)
             for x in leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(norms))


def decayed(path, p: torch.Tensor) -> bool:
    """Whether weight decay applies to the leaf at ``path``: every leaf
    under ``params["blocks"]`` or ``params["encoder"]["blocks"]`` and
    every leaf of ndim >= 2 elsewhere.  The JAX rule is ``p.ndim >= 2``
    on its tree, where each block leaf is stacked over ``n_periods``
    (an encoder's over ``encoder_layers``); that makes the block norm
    scales and biases ((n_periods, D), (n_periods, hd)) 2-D, so the JAX
    package decays them, and ``final_norm`` ((D,)), the encoder's too,
    not.  The port keeps one dict per layer, where those leaves are 1-D:
    the path test reproduces the reference's decay exactly (ROADMAP
    C4)."""
    path = tuple(path)
    return (path[:1] == ("blocks",) or path[:2] == ("encoder", "blocks")
            or p.ndim >= 2)


def adamw_update(cfg: AdamWConfig, params, grads, state, gnorm=None):
    """One AdamW step.  Returns ``(params, state, {"lr", "grad_norm"})``;
    params, ``state["m"]`` and ``state["v"]`` are updated in place,
    ``grads`` are read only.  ``gnorm``: the clipping norm, where the
    caller computed it (sharded grads: ``train.train_step``); by default
    ``global_norm(grads)``."""
    step = int(state["step"]) + 1
    lr = schedule(cfg, step)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    f = np.float32
    bc1 = float(f(1.0) - f(cfg.b1) ** f(step))
    bc2 = float(f(1.0) - f(cfg.b2) ** f(step))
    for (path, p), g, m, v in zip(leaves_with_paths(params), leaves(grads),
                                  leaves(state["m"]), leaves(state["v"])):
        g = g.float() * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if decayed(path, p):
            upd.add_(p.float() * cfg.weight_decay)
        p.sub_(upd.mul_(lr).to(p.dtype))
    new_state = {"m": state["m"], "v": state["v"],
                 "step": torch.tensor(step, dtype=torch.int32)}
    return params, new_state, {
        "lr": torch.tensor(lr, dtype=torch.float32), "grad_norm": gnorm}
