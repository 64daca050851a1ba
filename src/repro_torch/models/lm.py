"""Model assembly for dense GQA decoders: init, the training / prefill
forward, the loss and the single-token decode step (the counterpart of
``repro/models/lm.py``).

The JAX package stacks each pattern position's params over the
``n_periods`` repeats and walks them with ``lax.scan``; here
``params["blocks"]`` is a list with one dict per layer, in execution
order (period by period, the pattern inside each period), and a Python
loop walks it.  ``convert.lm_params`` unstacks a JAX pytree into that
form.  With ``cfg.remat == "full"`` each layer of a forward that is
being differentiated runs under ``torch.utils.checkpoint`` (the
counterpart of ``jax.checkpoint`` on the scan body): only the layer
inputs are kept, and the backward recomputes each layer.  Families the
port does not run yet raise ``NotImplementedError`` naming the ROADMAP
item that ports them.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from .attention import (attention_decode, attention_forward,
                        init_attention, init_cache)
from .config import DENSE, MAMBA1, MAMBA2, MOE, ModelConfig
from .layers import (apply_norm, embed, init_embedding, init_mlp,
                     init_norm, make_rope_cache, mlp, unembed)


def check_supported(cfg: ModelConfig, rules=None) -> None:
    """Raise ``NotImplementedError`` for a config outside this slice (dense
    GQA decoders with rmsnorm and plain RoPE), naming its ROADMAP item."""
    if rules is not None:
        raise NotImplementedError("sharded models (MeshRules) are not "
                                  "ported yet (ROADMAP A11b); pass "
                                  "rules=None")
    unported = [
        (cfg.attn_type == "mla", "MLA attention", "A13.3"),
        (MOE in cfg.pattern or cfg.n_experts > 0, "MoE blocks", "A13.4"),
        (MAMBA1 in cfg.pattern or MAMBA2 in cfg.pattern, "Mamba blocks",
         "A13.5"),
        (cfg.shared_attn_every > 0, "the shared attention block", "A13.6"),
        (cfg.encoder_layers > 0 or cfg.cross_attention
         or cfg.embedding_inputs, "the encoder-decoder stack", "A13.7"),
        (cfg.norm != "rmsnorm", f"{cfg.norm} models", "A13.7"),
        (cfg.mrope, "M-RoPE", "A13.8"),
    ]
    for hit, what, item in unported:
        if hit:
            raise NotImplementedError(f"{cfg.name}: {what} are not ported "
                                      f"yet (ROADMAP {item})")
    if cfg.attn_type != "gqa" or not cfg.n_heads:
        raise NotImplementedError(f"{cfg.name}: attn_type "
                                  f"{cfg.attn_type!r} is not ported")


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The block kind of every layer, in execution order."""
    return list(cfg.pattern) * cfg.n_periods


# ---------------------------------------------------------------- init ----

def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str) -> dict:
    dev = gen.device
    p = {"norm1": init_norm(cfg.d_model, dev),
         "attn": init_attention(gen, cfg)}
    if kind == DENSE:
        p["norm2"] = init_norm(cfg.d_model, dev)
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """Random f32 params drawn from ``gen``, on ``device`` (the card unless
    ``device="cpu"``; ``gen`` must live there too)."""
    check_supported(cfg)
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"init_params: the generator is on {gen.device} "
                         f"but the params go to {dev}")
    params = {"embed": init_embedding(gen, cfg.vocab_size, cfg.d_model),
              "final_norm": init_norm(cfg.d_model, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.vocab_size, cfg.d_model)
    params["blocks"] = [_init_block(gen, cfg, kind)
                        for kind in layer_kinds(cfg)]
    return params


def _head(params: dict, cfg: ModelConfig) -> dict:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


# ------------------------------------------------------------- forward ----

def _block_forward(kind: str, p: dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, rope_cache) -> torch.Tensor:
    x = x + attention_forward(p["attn"], cfg,
                              apply_norm(cfg.norm, p["norm1"], x),
                              positions, rope_cache=rope_cache)
    if kind == DENSE:
        x = x + mlp(p["mlp"], apply_norm(cfg.norm, p["norm2"], x), x.dtype)
    return x


def _differentiated(p: dict, x: torch.Tensor) -> bool:
    """Whether autograd records this layer: grad mode is on and x or one
    of the layer's params requires a gradient."""
    if not torch.is_grad_enabled():
        return False
    stack = [p]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif node.requires_grad:
            return True
    return x.requires_grad


def _default_positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int64, device=device).expand(B, S)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            rules=None) -> torch.Tensor:
    """Training / prefill forward: tokens (B, S) -> f32 logits (B, S, V).
    Layers run under activation checkpointing when ``cfg.remat ==
    "full"`` and the forward is being differentiated; the final norm and
    the head stay outside, as in the JAX package."""
    check_supported(cfg, rules)
    dtype = cfg.activation_dtype
    B, S = tokens.shape
    x = embed(params["embed"], tokens, dtype)
    if positions is None:
        positions = _default_positions(B, S, tokens.device)
    rope_cache = make_rope_cache(positions, cfg.head_dim, cfg.rope_theta)
    for kind, p in zip(layer_kinds(cfg), params["blocks"]):
        if cfg.remat == "full" and _differentiated(p, x):
            x = checkpoint(_block_forward, kind, p, cfg, x, positions,
                           rope_cache, use_reentrant=False)
        else:
            x = _block_forward(kind, p, cfg, x, positions, rope_cache)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return unembed(_head(params, cfg), x, dtype)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict,
            rules=None) -> torch.Tensor:
    """Mean next-token cross entropy ``logsumexp(logits) - logits[label]``
    over f32 logits; ``batch`` holds ``tokens`` and ``labels`` (B, S)
    (and optionally ``positions``).  ``cfg.ce_impl``: "gather" takes the
    gold logit by index, "onehot" contracts with a one-hot (the JAX
    package's V-sharding-friendly form; the same value)."""
    logits = forward(params, cfg, batch["tokens"],
                     positions=batch.get("positions"), rules=rules)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    if cfg.ce_impl == "onehot":
        onehot = torch.nn.functional.one_hot(
            labels, logits.shape[-1]).to(logits.dtype)
        gold = torch.einsum("bsv,bsv->bs", logits, onehot)
    else:
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (logz - gold).mean()


# ------------------------------------------------------------- decode -----

def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device=None) -> dict:
    """Decode state: one zeroed (k, v) cache pair per layer, each (batch,
    max_seq, kv, hd) in the compute dtype, and ``pos`` (batch,) int64."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = cfg.activation_dtype
    return {"caches": [init_cache(cfg, batch, max_seq, dtype, dev)
                       for _ in layer_kinds(cfg)],
            "pos": torch.zeros((batch,), dtype=torch.int64, device=dev)}


def decode_step(params: dict, cfg: ModelConfig, state: dict,
                tokens: torch.Tensor, rules=None):
    """One new token per sequence.  tokens: (B, 1) -> (logits (B, V), new
    state).  The input state is not written."""
    check_supported(cfg, rules)
    dtype = cfg.activation_dtype
    pos = state["pos"]
    h = embed(params["embed"], tokens, dtype)
    caches = []
    for kind, p, c in zip(layer_kinds(cfg), params["blocks"],
                          state["caches"]):
        a, c = attention_decode(p["attn"], cfg,
                                apply_norm(cfg.norm, p["norm1"], h), c, pos)
        h = h + a
        if kind == DENSE:
            h = h + mlp(p["mlp"], apply_norm(cfg.norm, p["norm2"], h), dtype)
        caches.append(c)
    h = apply_norm(cfg.norm, params["final_norm"], h)
    logits = unembed(_head(params, cfg), h, dtype)[:, 0]
    return logits, dict(state, caches=caches, pos=pos + 1)
