"""Carry fitted state from the JAX package into the port.

The JAX side hands over plain data only — numpy arrays and dicts such as
``dataclasses.asdict(estimator.cfg)`` — so this module imports nothing
of ``repro``.  ``fitted_estimator`` returns a ``KernelSVM`` /
``KernelRidge`` that predicts what the JAX estimator with the same
``A``, ``y``, ``alpha`` and config predicts — for the streamed and the
Nystrom representations too (``nystrom_map`` carries a fitted JAX
``NystromMap`` across); ``schedule`` turns a JAX ``FitResult.schedule``
(int32) into the int64 schedule ``fit(..., schedule=)`` replays.
``lm_params``, ``decode_state`` and ``adamw_state`` carry an LM's
params, decode state and AdamW state (numpy pytrees of the JAX
``init_params`` / ``init_decode_state`` / ``adamw_init``) across,
unstacking the per-period layer axis into the port's list of layers
(a hybrid pattern's shared block, which JAX does not stack, is copied
as it is; its decode caches, stacked over the periods, become a list of
one pair a period; an encoder's blocks, stacked over its layers, become
a list of one dict a layer, and the cross-attention keys and values one
pair a decoder layer); ``lm_shards`` gives a rank of a mesh its shards
of those params.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
from repro_torch.core import (KernelConfig, KRRConfig, NystromMap,
                              SVMConfig, as_schedule, lowrank_operator)
from repro_torch.device import as_tensor, resolve_device
from repro_torch.tree import map_tree


def kernel_config(d: Mapping) -> KernelConfig:
    """``KernelConfig`` from ``dataclasses.asdict`` of the JAX one."""
    return KernelConfig(name=d["name"], degree=int(d["degree"]),
                        coef0=float(d["coef0"]), sigma=float(d["sigma"]))


def svm_config(d: Mapping) -> SVMConfig:
    return SVMConfig(C=float(d["C"]), loss=d["loss"],
                     kernel=kernel_config(d["kernel"]))


def krr_config(d: Mapping) -> KRRConfig:
    return KRRConfig(lam=float(d["lam"]), kernel=kernel_config(d["kernel"]))


def solver_options(d: Mapping) -> SolverOptions:
    """``SolverOptions`` from the JAX options' fields; a knob the port
    does not run yet raises unless it is at its default."""
    names = {f.name for f in dataclasses.fields(SolverOptions)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"unknown solver options {unknown}")
    return SolverOptions(**dict(d))


def nystrom_map(landmarks, transform, kernel, device=None) -> NystromMap:
    """A fitted JAX ``NystromMap`` as the port's: its ``landmarks`` (l, n)
    and ``transform`` (l, l) arrays and its kernel (a ``KernelConfig`` or
    ``dataclasses.asdict`` of the JAX one)."""
    dev = resolve_device(device)
    if not isinstance(kernel, KernelConfig):
        kernel = kernel_config(kernel)
    L = as_tensor(landmarks, dev).contiguous()
    T = as_tensor(transform, dev).contiguous()
    if L.ndim != 2 or T.shape != (L.shape[0], L.shape[0]):
        raise ValueError(f"expected landmarks (l, n) and transform (l, l),"
                         f" got {tuple(L.shape)} and {tuple(T.shape)}")
    return NystromMap(landmarks=L, transform=T, kernel=kernel)


def schedule(arr, device=None) -> torch.Tensor:
    """A JAX coordinate schedule as the port's int64 indices."""
    return as_schedule(arr, resolve_device(device))


def fitted_estimator(problem: str, cfg: Mapping, A, y, alpha, *,
                     options: Optional[Mapping] = None,
                     fmap: Optional[NystromMap] = None,
                     predict_batch: int = 1024, device=None):
    """A fitted port estimator from a JAX estimator's state.

    problem: "ksvm" or "krr"; cfg: ``dataclasses.asdict`` of the JAX
    ``SVMConfig`` / ``KRRConfig``; A, y, alpha: arrays of the JAX
    estimator's ``A_``, ``y_``, ``alpha_``; options: the JAX options'
    fields (optional; ``stream`` gives a streamed estimator, A kept on
    the host); fmap: the fitted map (``nystrom_map``), required with
    ``approx="nystrom"``."""
    opts = solver_options(options) if options is not None else None
    if problem == "ksvm":
        c = svm_config(cfg)
        est = KernelSVM(C=c.C, loss=c.loss, kernel=c.kernel, options=opts,
                        predict_batch=predict_batch, device=device)
    elif problem == "krr":
        c = krr_config(cfg)
        est = KernelRidge(lam=c.lam, kernel=c.kernel, options=opts,
                          predict_batch=predict_batch, device=device)
    else:
        raise ValueError(f"problem must be 'ksvm' or 'krr', got "
                         f"{problem!r}")

    def tensor(x, device=est.device):
        return as_tensor(x, device).contiguous()

    A_t = tensor(A, est._data_device)
    y_t, alpha_t = tensor(y), tensor(alpha)
    m = A_t.shape[0]
    if A_t.ndim != 2 or y_t.shape != (m,) or alpha_t.shape != (m,):
        raise ValueError(f"expected A (m, n), y (m,), alpha (m,); got "
                         f"{tuple(A_t.shape)}, {tuple(y_t.shape)}, "
                         f"{tuple(alpha_t.shape)}")
    op = None
    if est.options.approx is not None:
        if fmap is None:
            raise ValueError("approx='nystrom' needs the fitted feature "
                             "map: fmap=convert.nystrom_map(...)")
        op = lowrank_operator(fmap, A_t)
    elif fmap is not None:
        raise ValueError("fmap= is only meaningful with "
                         "options approx='nystrom'")
    est._adopt(A_t, y_t, alpha_t, op)
    return est


def _layers(stacks, cfg):
    """Per-layer slices, in execution order, of a tuple with one pytree
    per pattern position, each stacked over the ``n_periods`` axis."""
    if len(stacks) != len(cfg.pattern):
        raise ValueError(f"expected {len(cfg.pattern)} stacked pattern "
                         f"positions, got {len(stacks)}")
    return [map_tree(lambda a: a[period], stacks[i])
            for period in range(cfg.n_periods)
            for i in range(len(cfg.pattern))]


def lm_params(params: Mapping, cfg, device=None) -> dict:
    """The port's LM params (``models.lm``) from a JAX ``init_params``
    pytree given as numpy arrays (``jax.tree.map(np.asarray, params)``):
    f32 tensors on ``device`` with ``blocks`` unstacked into one dict per
    layer (a MoE layer's experts keep their leading E axis: (n_periods,
    E, d, f) -> (E, d, f)); ``shared_attn`` is one block in JAX too and
    is copied as it is; ``encoder/blocks``, stacked over the
    ``encoder_layers`` axis, is unstacked into one dict per layer."""
    from repro_torch.models import check_supported
    check_supported(cfg)
    dev = resolve_device(device)

    def tensor(a):
        return as_tensor(a, dev).float().contiguous()

    out = {k: map_tree(tensor, v) for k, v in params.items()
           if k not in ("blocks", "encoder")}
    out["blocks"] = map_tree(tensor, _layers(params["blocks"], cfg))
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {
            "blocks": [map_tree(lambda a: tensor(a[i]), enc["blocks"])
                       for i in range(cfg.encoder_layers)],
            "final_norm": map_tree(tensor, enc["final_norm"])}
    return out


def lm_shards(params: Mapping, cfg, rules, device=None) -> dict:
    """This rank's shards under ``rules`` (``models.sharding.MeshRules``)
    of a JAX ``init_params`` pytree given as numpy arrays: ``lm_params``,
    then each leaf cut by its spec (``models.sharding.shard_tree``), on
    every config."""
    from repro_torch.models.lm import param_specs
    from repro_torch.models.sharding import shard_tree
    return shard_tree(rules, lm_params(params, cfg, device),
                      param_specs(rules, cfg))


def decode_state(state: Mapping, cfg, device=None) -> dict:
    """The port's decode state from a JAX ``init_decode_state`` /
    ``decode_step`` state given as numpy arrays: one cache pair per layer
    (GQA's (k, v), MLA's (c, k_rope), Mamba's (conv_state, h)), each in
    the compute dtype but Mamba's h, which stays f32 as in JAX; the
    shared block's caches one pair a period (``shared_cache``); an
    encoder-decoder's ``cross_kv``, (L, B, T, kv, hd) stacked, one (k, v)
    pair a decoder layer; ``pos`` as int64."""
    from repro_torch.models import MAMBA1, MAMBA2, check_supported
    from repro_torch.models.lm import layer_kinds
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = cfg.activation_dtype

    def cast(c, dt):
        # through f32: torch cannot read numpy's bf16 (ml_dtypes) arrays
        return as_tensor(np.asarray(c, np.float32), dev).to(dt)

    caches = []
    for kind, pair in zip(layer_kinds(cfg), _layers(state["caches"], cfg)):
        if kind in (MAMBA1, MAMBA2):
            conv, h = pair
            caches.append((cast(conv, dtype), cast(h, torch.float32)))
        else:
            caches.append(tuple(cast(c, dtype) for c in pair))
    out = {"caches": caches,
           "pos": as_tensor(state["pos"], dev).to(torch.int64)}
    if "shared_cache" in state:
        out["shared_cache"] = [
            tuple(cast(c[period], dtype) for c in state["shared_cache"])
            for period in range(cfg.n_periods)]
    if "cross_kv" in state:
        out["cross_kv"] = [
            tuple(cast(c[layer], dtype) for c in state["cross_kv"])
            for layer in range(cfg.n_layers)]
    return out


def decode_state_shards(state: Mapping, cfg, rules, device=None) -> dict:
    """This rank's chunks under ``rules`` (``models.sharding.MeshRules``)
    of a JAX decode state given as numpy arrays: ``decode_state``, then
    each cache (``caches``, the shared block's ``shared_cache``, an
    encoder-decoder's ``cross_kv``) cut by its ``cache_spec``
    (``shard_leaf``); ``pos`` whole and ``max_seq``, as
    ``init_decode_state(rules=)`` holds them."""
    from repro_torch.models.lm import decode_state_layout
    from repro_torch.models.sharding import shard_leaf
    full = decode_state(state, cfg, device)
    batch, max_seq = _batch_and_seq(full, cfg)
    specs = decode_state_layout(rules, cfg, batch, max_seq)
    out = {"pos": full["pos"], "max_seq": max_seq}
    for key in ("caches", "shared_cache", "cross_kv"):
        if key in full:
            out[key] = [tuple(shard_leaf(rules.mesh, t, sp)
                              for t, sp in zip(c, cs))
                        for c, cs in zip(full[key], specs[key])]
    return out


def _batch_and_seq(full: dict, cfg) -> tuple:
    """The batch and the cache length S of a port decode state: from an
    attention cache (a layer's, or the shared block's), or S = 1 on an
    attention-free config (its states hold no S)."""
    from repro_torch.models.lm import layer_kinds
    from repro_torch.models import MAMBA1, MAMBA2
    for kind, pair in zip(layer_kinds(cfg), full["caches"]):
        if kind not in (MAMBA1, MAMBA2):
            return tuple(pair[0].shape[:2])
    if "shared_cache" in full:
        return tuple(full["shared_cache"][0][0].shape[:2])
    return full["caches"][0][0].shape[0], 1


def adamw_state(opt: Mapping, cfg, device=None) -> dict:
    """The port's AdamW state (``optim.adamw_init``'s form) from a JAX
    ``adamw_init`` / ``adamw_update`` state given as numpy arrays: ``m``
    and ``v`` unstacked like ``lm_params`` (f32 on ``device``), ``step``
    a 0-dim int32 tensor on the host."""
    return {"m": lm_params(opt["m"], cfg, device),
            "v": lm_params(opt["v"], cfg, device),
            "step": torch.tensor(int(np.asarray(opt["step"])),
                                 dtype=torch.int32)}
