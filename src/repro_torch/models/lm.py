"""Model assembly for decoders of dense, MoE and Mamba blocks over GQA
or MLA attention, with the hybrid pattern's shared
attention block (Zamba2), M-RoPE (Qwen2-VL) and an encoder in front
(Whisper): init, the training / prefill forward, the loss and the
single-token decode step (the counterpart of ``repro/models/lm.py``).

The JAX package stacks each pattern position's params over the
``n_periods`` repeats and walks them with ``lax.scan``; here
``params["blocks"]`` is a list with one dict per layer, in execution
order (period by period, the pattern inside each period), and a Python
loop walks it.  ``convert.lm_params`` unstacks a JAX pytree into that
form.  With ``cfg.remat == "full"`` each layer of a forward that is
being differentiated runs under ``torch.utils.checkpoint`` (the
counterpart of ``jax.checkpoint`` on the scan body): only the layer
inputs are kept, and the backward recomputes each layer.  A Mamba
block (``models.mamba``) is ``x + mamba(norm1(x))``; its decode state
is (conv_state in the compute dtype, h in f32).  With
``cfg.shared_attn_every`` one shared block (``params["shared_attn"]``:
norm, attention, and norm2 + MLP where ``d_ff``) runs after every
period of ``len(cfg.pattern)`` layers, the same weights every time (its
gradient sums over the applications); each application has its own
attention cache (``state["shared_cache"]``, one per period) and, under
remat, its own checkpoint.

With ``cfg.encoder_layers`` (Whisper) ``params["encoder"]`` holds
``blocks`` (one dense block a layer, no cross-attention) and
``final_norm``; ``encoder_forward`` runs them over the frame embeddings
``audio_embed`` (B, encoder_seq, D) with the default positions (RoPE,
and causal where ``cfg.causal``, as the reference), each layer under
its own checkpoint under remat.  With ``cfg.cross_attention`` every
decoder block adds ``x + cross(norm_x(x), enc_out)`` after its
self-attention; in decode the encoder's keys and values come from the
state's ``cross_kv`` (one pair a layer, ``init_decode_state(
with_encoder=True)``, filled by ``prefill_cross_kv``).  With
``cfg.mrope`` the positions are (3, B, S) (``_default_positions``: the
three streams equal) and no rope cache is built.  The norm kind of
every block, of the shared block and of ``final_norm`` is ``cfg.norm``
("rmsnorm": the kernel; "layernorm": plain, as in the reference).

With ``rules`` (``models.sharding.MeshRules``) ``forward`` and
``loss_fn`` take this rank's shards of the params (``param_spec`` of
each leaf's full shape, ``abstract_params``) and this rank's rows of
the batch: each layer gathers its leaves at use and runs its attention
(GQA or MLA) and MLP tensor-parallel and its experts expert-parallel
where the specs split them (``models.sharding.Sharded``).  Under remat a
layer's gathers and its forward reductions run again in the backward's
recompute (early stop is off, so the whole layer is recomputed on every
rank alike).  ``decode_step`` with ``rules`` takes this rank's chunks of
the decode state (``init_decode_state(rules=)``, laid out by
``models.sharding.cache_spec``) and the global tokens, and computes this
rank's rows (``sharding.batch_rows``), its caches read through the
split-S attention where their S is split (``models.attention``); it uses
the embedding and head tables vocab-parallel (``Sharded.lookup``,
``Sharded.project``), where ``forward`` gathers them at use.  Every
config runs sharded: a Mamba block runs tensor-parallel over its
channels or heads (``models.mamba``), its states the rank's chunks (a
chunk the block needs whole gathered over ``model`` at the step, the
rank's chunk of the new state kept: ``_mamba_state``); the shared block
is gathered at each application (its gradient sums over them, as
unsharded) and reads its period's ``shared_cache`` through the split-S
attention where its S is split; the encoder's blocks run as the
decoder's, on the rank's rows of ``audio_embed``, and the decoder's
cross-attention runs tensor-parallel on heads over the encoder's output
(replicated over ``model``); ``cross_kv`` is laid out as a GQA cache
(``prefill_cross_kv(rules=)`` writes the rank's chunk).  M-RoPE's (3, B,
S) positions are the rank's rows on dim 1.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from .attention import (SeqSplit, attention_decode, attention_forward,
                        gqa_decode, gqa_forward, init_attention, init_cache)
from .config import DENSE, MAMBA1, MAMBA2, ModelConfig
from .layers import (apply_norm, embed, init_embedding, init_mlp,
                     init_norm_for, make_rope_cache, mlp, unembed)
from . import mamba as mb
from .moe import init_moe, moe_apply
from .sharding import (Sharded, batch_rows, chunk_shape,
                       decode_state_specs, shard_leaf, split_axes,
                       tree_pspecs)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config outside the port: an
    attention type other than GQA or MLA (every config of the reference
    runs)."""
    if cfg.is_attention_free:
        return
    if cfg.attn_type not in ("gqa", "mla") or not cfg.n_heads:
        raise NotImplementedError(f"{cfg.name}: attn_type "
                                  f"{cfg.attn_type!r} is not ported")


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The block kind of every layer, in execution order."""
    return list(cfg.pattern) * cfg.n_periods


# ---------------------------------------------------------------- init ----

def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
                cross: bool = False) -> dict:
    """One layer's params; ``cross`` adds the decoder's cross-attention
    (``norm_x``, ``cross``) to an attention block."""
    dev = gen.device
    p = {"norm1": init_norm_for(cfg.norm, cfg.d_model, dev)}
    if kind == MAMBA1:
        p["mamba"] = mb.init_mamba1(gen, cfg)
    elif kind == MAMBA2:
        p["mamba"] = mb.init_mamba2(gen, cfg)
    else:
        p["attn"] = init_attention(gen, cfg)
        if cross:
            p["norm_x"] = init_norm_for(cfg.norm, cfg.d_model, dev)
            p["cross"] = init_attention(gen, cfg, cross=True)
        p["norm2"] = init_norm_for(cfg.norm, cfg.d_model, dev)
        if kind == DENSE:
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff)
        else:
            p["moe"] = init_moe(gen, cfg)
    return p


def _init_shared(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The one shared attention (+ MLP) block of a hybrid pattern."""
    dev = gen.device
    p = {"norm": init_norm_for(cfg.norm, cfg.d_model, dev),
         "attn": init_attention(gen, cfg)}
    if cfg.d_ff:
        p["norm2"] = init_norm_for(cfg.norm, cfg.d_model, dev)
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
              "final_norm": init_norm_for(cfg.norm, cfg.d_model, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.vocab_size, cfg.d_model)
    params["blocks"] = [_init_block(gen, cfg, kind, cfg.cross_attention)
                        for kind in layer_kinds(cfg)]
    if cfg.shared_attn_every:
        params["shared_attn"] = _init_shared(gen, cfg)
    if cfg.encoder_layers:
        params["encoder"] = {
            "blocks": [_init_block(gen, cfg, DENSE)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": init_norm_for(cfg.norm, cfg.d_model, dev)}
    return params


def abstract_params(cfg: ModelConfig) -> dict:
    """The params tree of ``cfg`` at full size as meta tensors (shapes and
    dtypes, no memory): what ``init_params`` would allocate."""
    check_supported(cfg)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def t(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    def norm():
        if cfg.norm == "rmsnorm":
            return {"scale": t(d)}
        return {"scale": t(d), "bias": t(d)}

    def mlp_leaves(f):
        return {"wi_gate": t(d, f), "wi_up": t(d, f), "wo": t(f, d)}

    def attention(cross=False):
        if cfg.attn_type == "mla" and not cross:
            rd, vd, r = cfg.qk_rope_head_dim, cfg.v_head, cfg.kv_lora_rank
            return {"wq": t(d, h, hd + rd), "w_dkv": t(d, r),
                    "w_kr": t(d, rd), "w_uk": t(r, h, hd),
                    "w_uv": t(r, h, vd), "wo": t(h, vd, d),
                    "kv_norm": {"scale": t(r)}}
        attn = {"wq": t(d, h, hd), "wk": t(d, kv, hd), "wv": t(d, kv, hd),
                "wo": t(h, hd, d)}
        if cfg.qk_norm:
            attn["q_norm"] = {"scale": t(hd)}
            attn["k_norm"] = {"scale": t(hd)}
        return attn

    def moe():
        e, f = cfg.n_experts, cfg.moe_ff
        p = {"router": t(d, e), "wi_gate": t(e, d, f), "wi_up": t(e, d, f),
             "wo": t(e, f, d)}
        if cfg.n_shared_experts:
            p["shared"] = mlp_leaves(f * cfg.n_shared_experts)
        if cfg.dense_residual_ff:
            p["dense_residual"] = mlp_leaves(cfg.dense_residual_ff)
        return p

    def mamba(kind):
        di, n, K = cfg.d_inner, cfg.ssm_state, cfg.d_conv
        if kind == MAMBA1:
            r = mb.dt_rank(cfg)
            return {"in_proj": t(d, 2 * di), "conv_w": t(di, K),
                    "x_proj": t(di, r + 2 * n), "dt_proj": t(r, di),
                    "dt_bias": t(di), "A_log": t(di, n), "D": t(di),
                    "out_proj": t(di, d)}
        nh = di // cfg.mamba_headdim
        return {"in_proj": t(d, 2 * di + 2 * n + nh),
                "conv_w": t(di + 2 * n, K), "dt_bias": t(nh),
                "A_log": t(nh), "D": t(nh), "norm_scale": t(di),
                "out_proj": t(di, d)}

    def block(kind, cross=False):
        p = {"norm1": norm()}
        if kind in (MAMBA1, MAMBA2):
            p["mamba"] = mamba(kind)
            return p
        p["attn"] = attention()
        if cross:
            p["norm_x"] = norm()
            p["cross"] = attention(cross=True)
        p["norm2"] = norm()
        if kind == DENSE:
            p["mlp"] = mlp_leaves(cfg.d_ff)
        else:
            p["moe"] = moe()
        return p

    params = {"embed": {"table": t(cfg.vocab_size, d)},
              "final_norm": norm()}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": t(cfg.vocab_size, d)}
    params["blocks"] = [block(kind, cfg.cross_attention)
                        for kind in layer_kinds(cfg)]
    if cfg.shared_attn_every:
        params["shared_attn"] = {"norm": norm(), "attn": attention()}
        if cfg.d_ff:
            params["shared_attn"]["norm2"] = norm()
            params["shared_attn"]["mlp"] = mlp_leaves(cfg.d_ff)
    if cfg.encoder_layers:
        params["encoder"] = {"blocks": [block(DENSE) for _ in
                                        range(cfg.encoder_layers)],
                             "final_norm": norm()}
    return params


@functools.lru_cache(maxsize=16)
def param_specs(rules, cfg: ModelConfig) -> dict:
    """The spec of every params leaf of ``cfg`` under ``rules``."""
    check_supported(cfg)
    return tree_pspecs(rules, abstract_params(cfg))


def _head_key(cfg: ModelConfig) -> str:
    return "embed" if cfg.tie_embeddings else "lm_head"


# ------------------------------------------------------------- forward ----

def _block_forward(kind: str, p: dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, rope_cache,
                   sh: Optional[Sharded] = None,
                   spec: Optional[dict] = None,
                   enc_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer; with ``enc_out`` (B, T, D) a decoder block adds its
    cross-attention over it after the self-attention."""
    tp = _tp_of(sh)
    if sh is not None:
        p = sh.block(p, spec)
    if kind in (MAMBA1, MAMBA2):
        fwd = mb.mamba1_forward if kind == MAMBA1 else mb.mamba2_forward
        return x + fwd(p["mamba"], cfg, apply_norm(cfg.norm, p["norm1"], x),
                       tp=tp("mamba"))
    x = x + attention_forward(p["attn"], cfg,
                              apply_norm(cfg.norm, p["norm1"], x),
                              positions, rope_cache=rope_cache,
                              tp=tp("attn"))
    if cfg.cross_attention and enc_out is not None:
        x = x + gqa_forward(p["cross"], cfg,
                            apply_norm(cfg.norm, p["norm_x"], x), None,
                            tp=tp("cross"), kv_x=enc_out)
    h = apply_norm(cfg.norm, p["norm2"], x)
    if kind == DENSE:
        return x + mlp(p["mlp"], h, x.dtype, tp=tp("mlp"))
    return x + moe_apply(p["moe"], cfg, h, tp=tp("moe"))


def _shared_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, rope_cache,
                    sh: Optional[Sharded] = None,
                    spec: Optional[dict] = None) -> torch.Tensor:
    """One application of the shared attention (+ MLP) block (with ``sh``
    its leaves gathered at this application)."""
    tp = _tp_of(sh)
    if sh is not None:
        p = sh.block(p, spec)
    x = x + attention_forward(p["attn"], cfg,
                              apply_norm(cfg.norm, p["norm"], x),
                              positions, rope_cache=rope_cache,
                              tp=tp("attn"))
    if "mlp" in p:
        x = x + mlp(p["mlp"], apply_norm(cfg.norm, p["norm2"], x), x.dtype,
                    tp=tp("mlp"))
    return x


def _period_ends(cfg: ModelConfig, i: int) -> bool:
    """Whether the shared block runs after layer ``i``: at the end of
    every period of the pattern."""
    return bool(cfg.shared_attn_every) and (i + 1) % len(cfg.pattern) == 0


def _remat(fn, p: dict, x: torch.Tensor, cfg: ModelConfig, *args,
           early_stop: bool = True) -> torch.Tensor:
    """``fn(*args)`` under activation checkpointing where ``cfg.remat ==
    "full"`` and autograd records the call (``p`` and ``x`` are its
    params and input), else directly."""
    if cfg.remat == "full" and _differentiated(p, x):
        return checkpoint(fn, *args, use_reentrant=False,
                          early_stop=early_stop)
    return fn(*args)


def _tp_of(sh: Optional[Sharded]):
    """``part -> sh`` where the part runs tensor- or expert-parallel, else
    None."""
    return lambda part: sh if sh is not None and part in sh.tp_parts \
        else None


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


def _default_positions(cfg: ModelConfig, B: int, S: int,
                       device) -> torch.Tensor:
    """0 .. S - 1 for every row: (B, S), or (3, B, S) with the three
    M-RoPE streams equal."""
    pos = torch.arange(S, dtype=torch.int64, device=device).expand(B, S)
    return pos.expand(3, B, S) if cfg.mrope else pos


def _rope_cache(cfg: ModelConfig, positions: torch.Tensor):
    """(cos, sin) for every layer's GQA rotation, or None (MLA rotates on
    the fly, M-RoPE per section)."""
    if cfg.mrope or cfg.attn_type != "gqa" or not cfg.n_heads:
        return None
    return make_rope_cache(positions, cfg.head_dim, cfg.rope_theta)


def _norm_use(sh: Optional[Sharded], p: dict, spec: Optional[dict]) -> dict:
    """A norm's params (scale, and a layernorm's bias) as used: gathered
    where split (``sh``)."""
    if sh is None:
        return p
    return {k: sh.use(v, spec[k]) for k, v in p.items()}


def encoder_forward(params: dict, cfg: ModelConfig,
                    audio_embed: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over the frame embeddings (B, T, D) (the
    frontend is a stub, as in the reference): its dense blocks at the
    default positions, each under its own checkpoint under remat, then
    its ``final_norm``; (B, T, D) in the compute dtype."""
    return _encode(params, cfg, audio_embed, None, None)


def _encode(params, cfg, audio_embed, sh: Optional[Sharded],
            specs: Optional[dict]) -> torch.Tensor:
    """``encoder_forward``; with ``sh`` on this rank's shards (``specs``
    theirs) and rows of ``audio_embed``, the blocks run as
    ``forward``'s."""
    if audio_embed is None:
        raise ValueError(f"{cfg.name}: the encoder needs audio_embed, the "
                         f"(B, encoder_seq, d_model) frame embeddings")
    x = audio_embed.to(cfg.activation_dtype)
    B, T = x.shape[:2]
    positions = _default_positions(cfg, B, T, x.device)
    rope_cache = _rope_cache(cfg, positions)
    enc = params["encoder"]
    for i, p in enumerate(enc["blocks"]):
        spec = None if specs is None else specs["encoder"]["blocks"][i]
        x = _remat(_block_forward, p, x, cfg, DENSE, p, cfg, x, positions,
                   rope_cache, sh, spec, early_stop=sh is None)
    final = _norm_use(sh, enc["final_norm"],
                      None if specs is None else specs["encoder"]
                      ["final_norm"])
    return apply_norm(cfg.norm, final, x)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            audio_embed: Optional[torch.Tensor] = None,
            rules=None) -> torch.Tensor:
    """Training / prefill forward: tokens (B, S) -> f32 logits (B, S, V).
    ``positions``: (B, S), or (3, B, S) for M-RoPE; by default 0 .. S - 1.
    ``audio_embed``: the encoder's frame embeddings (B, encoder_seq, D),
    needed where ``cfg.encoder_layers``.  Layers run under activation
    checkpointing when ``cfg.remat == "full"`` and the forward is being
    differentiated; the final norm and the head stay outside, as in the
    JAX package.  With ``rules`` the
    params are this rank's shards and tokens, positions and
    ``audio_embed`` this rank's rows (module docstring); the embedding and
    head tables are gathered at use (not vocab-parallel), the head and
    the layers' weight matrices in the compute dtype."""
    check_supported(cfg)
    dtype = cfg.activation_dtype
    B, S = tokens.shape
    sh = specs = None
    if rules is not None:
        specs = param_specs(rules, cfg)
        sh = Sharded(rules, specs, dtype)
    if sh is None:
        x = embed(params["embed"], tokens, dtype)
    else:
        x = embed({"table": sh.use(params["embed"]["table"],
                                   specs["embed"]["table"])}, tokens, dtype)
    if positions is None:
        positions = _default_positions(cfg, B, S, tokens.device)
    enc_out = None
    if cfg.encoder_layers:
        enc_out = _encode(params, cfg, audio_embed, sh, specs)
    rope_cache = _rope_cache(cfg, positions)
    for i, (kind, p) in enumerate(zip(layer_kinds(cfg), params["blocks"])):
        spec = None if specs is None else specs["blocks"][i]
        x = _remat(_block_forward, p, x, cfg, kind, p, cfg, x, positions,
                   rope_cache, sh, spec, enc_out, early_stop=sh is None)
        if _period_ends(cfg, i):
            sp = params["shared_attn"]
            sspec = None if specs is None else specs["shared_attn"]
            x = _remat(_shared_forward, sp, x, cfg, sp, cfg, x, positions,
                       rope_cache, sh, sspec, early_stop=sh is None)
    key = _head_key(cfg)
    if sh is None:
        final, head = params["final_norm"], params[key]
    else:
        final = _norm_use(sh, params["final_norm"], specs["final_norm"])
        head = {"table": sh.use(params[key]["table"], specs[key]["table"],
                                cast=True)}
    x = apply_norm(cfg.norm, final, x)
    return unembed(head, x, dtype)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict,
            rules=None) -> torch.Tensor:
    """Mean next-token cross entropy ``logsumexp(logits) - logits[label]``
    over f32 logits; ``batch`` holds ``tokens`` and ``labels`` (B, S)
    (and optionally ``positions``, (B, S) or (3, B, S), and
    ``audio_embed``, the encoder's frames).  ``cfg.ce_impl``: "gather"
    takes the gold logit by index, "onehot" contracts with a one-hot (the
    JAX package's V-sharding-friendly form; the same value).  With ``rules``
    the mean is over this rank's rows (``forward``)."""
    logits = forward(params, cfg, batch["tokens"],
                     positions=batch.get("positions"),
                     audio_embed=batch.get("audio_embed"), rules=rules)
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
                      device=None, rules=None,
                      with_encoder: bool = False) -> dict:
    """Decode state: one zeroed cache pair per layer (GQA: (k, v), each
    (batch, max_seq, kv, hd); MLA: (c, k_rope), (batch, max_seq,
    kv_lora_rank) and (batch, max_seq, qk_rope_head_dim); in the compute
    dtype; Mamba: (conv_state (batch, d_conv - 1, C) in the compute
    dtype, h in f32: (batch, d_inner, n) for Mamba-1, (batch, nh, hd, n)
    for Mamba-2), with the shared attention block ``shared_cache``, one
    GQA / MLA pair per period (one per application), with
    ``with_encoder`` on an encoder-decoder config ``cross_kv``, one zeroed
    (k, v) pair a decoder layer, each (batch, encoder_seq, kv, hd) in
    the compute dtype (``prefill_cross_kv`` fills them), and ``pos``
    (batch,) int64.  With ``rules`` each cache is this rank's chunk of it
    (``decode_state_specs``), ``pos`` is whole (replicated), and
    ``max_seq`` is kept in the state (a chunk of S does not tell the full
    S)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = cfg.activation_dtype
    if rules is None:
        state = {"caches": [_init_layer_cache(cfg, kind, batch, max_seq,
                                              dtype, dev)
                            for kind in layer_kinds(cfg)],
                 "pos": torch.zeros((batch,), dtype=torch.int64,
                                    device=dev)}
        if cfg.shared_attn_every:
            state["shared_cache"] = [
                init_cache(cfg, batch, max_seq, dtype, dev)
                for _ in range(cfg.n_periods)]
        if cfg.encoder_layers and with_encoder:
            shape = (batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
            state["cross_kv"] = [
                tuple(torch.zeros(shape, dtype=dtype, device=dev)
                      for _ in range(2)) for _ in range(cfg.n_layers)]
        return state
    full = abstract_decode_state(cfg, batch, max_seq, with_encoder)
    specs = decode_state_layout(rules, cfg, batch, max_seq)

    def chunks(pairs, spairs):
        return [tuple(torch.zeros(chunk_shape(rules.mesh, t.shape, sp),
                                  dtype=t.dtype, device=dev)
                      for t, sp in zip(c, cs))
                for c, cs in zip(pairs, spairs)]

    state = {k: chunks(full[k], specs[k]) for k in
             ("caches", "shared_cache", "cross_kv") if k in full}
    state.update(pos=torch.zeros((batch,), dtype=torch.int64, device=dev),
                 max_seq=max_seq)
    return state


def _init_layer_cache(cfg: ModelConfig, kind: str, batch: int,
                      max_seq: int, dtype: torch.dtype, dev):
    if kind == MAMBA1:
        return mb.init_mamba1_state(cfg, batch, dtype, dev)
    if kind == MAMBA2:
        return mb.init_mamba2_state(cfg, batch, dtype, dev)
    return init_cache(cfg, batch, max_seq, dtype, dev)


def prefill_cross_kv(params: dict, cfg: ModelConfig,
                     audio_embed: torch.Tensor, rules=None) -> list:
    """Whisper: the encoder once over ``audio_embed``, then each decoder
    layer's cross-attention keys and values: one (k, v) pair a layer,
    each (B, encoder_seq, kv, hd) in the compute dtype, for the decode
    state's ``cross_kv``.  With ``rules`` the params are this rank's
    shards, ``audio_embed`` the global batch, and each pair this rank's
    chunk of it as ``init_decode_state(rules=)`` lays ``cross_kv`` out
    (``cache_spec``): its rows, its kv heads where they divide ``model``
    (the cross-attention then runs tensor-parallel), else its chunk of
    the frames."""
    check_supported(cfg)
    if rules is None:
        enc_out = encoder_forward(params, cfg, audio_embed)
        dtype = enc_out.dtype
        return [tuple(torch.einsum("btd,dhk->bthk", enc_out,
                                   p["cross"][w].to(dtype))
                      for w in ("wk", "wv")) for p in params["blocks"]]
    B = audio_embed.shape[0]
    specs = param_specs(rules, cfg)
    sh = Sharded(rules, specs, cfg.activation_dtype)
    enc_out = _encode(params, cfg, audio_embed[batch_rows(rules, B)], sh,
                      specs)
    sspecs = decode_state_layout(rules, cfg, B, 1)["cross_kv"]
    out = []
    for p, spec, pair in zip(params["blocks"], specs["blocks"], sspecs):
        p = sh.block(p, spec)
        kv = []
        for w, sp in zip(("wk", "wv"), pair):
            t = torch.einsum("btd,dhk->bthk", enc_out,
                             p["cross"][w].to(enc_out.dtype))
            # the frames' chunk where the spec splits them (the rows and
            # heads are the rank's already)
            kv.append(shard_leaf(rules.mesh, t, (None, sp[1], None, None)))
        out.append(tuple(kv))
    return out


def abstract_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                          with_encoder: bool = False) -> dict:
    """The decode state of ``cfg`` at full size as meta tensors."""
    return init_decode_state(cfg, batch, max_seq, device="meta",
                             with_encoder=with_encoder)


@functools.lru_cache(maxsize=32)
def decode_state_layout(rules, cfg: ModelConfig, batch: int,
                        max_seq: int) -> dict:
    """The spec of every leaf of a decode state of ``batch`` rows and
    ``max_seq`` positions under ``rules`` (``cross_kv``'s too, on an
    encoder-decoder config)."""
    return decode_state_specs(rules, cfg, abstract_decode_state(
        cfg, batch, max_seq, bool(cfg.encoder_layers)))


def _seq_split(mesh, spec, chunk: torch.Tensor) -> Optional[SeqSplit]:
    """The split of a cache chunk's S (dim 1) from its spec, or None."""
    for d, a in split_axes(mesh, spec):
        if d == 1:
            return SeqSplit(mesh, a, mesh.index(a) * chunk.shape[1])
    return None


def mamba_state_whole(kind: str, tp_on: bool) -> tuple:
    """Which leaves of a Mamba state (conv state, h) the block's decode
    takes whole along ``model``: all of them where it computes replicated,
    Mamba-2's conv state always (``models.mamba``)."""
    return (kind == MAMBA2 or not tp_on, not tp_on)


def _model_dims(rules, spec) -> list:
    """The dims ``spec`` splits over the tensor-parallel axis."""
    return [d for d, a in split_axes(rules.mesh, spec) if a == rules.tp]


def _mamba_state(rules, kind: str, tp_on: bool, c, cspecs):
    """The state a Mamba block's decode takes (``mamba_state_whole``):
    each chunk it needs whole gathered over ``model`` (kind ``"tp"``),
    and a function that cuts the block's new state back to this rank's
    chunks."""
    whole = mamba_state_whole(kind, tp_on)
    cut = [w and _model_dims(rules, sp) for w, sp in zip(whole, cspecs)]
    c = tuple(rules.mesh.all_gather(t, rules.tp, dims[0], "tp") if dims
              else t for t, dims in zip(c, cut))

    def back(new):
        n, r = rules.axis_size(rules.tp), rules.mesh.index(rules.tp)
        return tuple(t.chunk(n, dims[0])[r].contiguous() if dims else t
                     for t, dims in zip(new, cut))

    return c, back


def decode_step(params: dict, cfg: ModelConfig, state: dict,
                tokens: torch.Tensor, rules=None):
    """One new token per sequence.  tokens: (B, 1) -> (logits (B, V), new
    state).  The input state is not written; its ``cross_kv`` (where it
    has one) passes into the new state as it is.  With ``rules`` (module
    docstring) ``params`` and the caches of ``state`` are this rank's
    chunks, ``tokens`` the global (B, 1), and the logits (full vocab)
    those of this rank's ``batch_rows``; ``pos`` stays whole.  The
    embedding and head tables are used vocab-parallel, not gathered
    (``Sharded.lookup``, ``Sharded.project``): a step moves the rows and
    the logits, not the tables."""
    check_supported(cfg)
    dtype = cfg.activation_dtype
    B = tokens.shape[0]
    key = _head_key(cfg)
    sh = specs = sspecs = None
    rows = slice(0, B)
    if rules is not None:
        specs = param_specs(rules, cfg)
        sh = Sharded(rules, specs, dtype)
        sspecs = decode_state_layout(rules, cfg, B, state["max_seq"])
        rows = batch_rows(rules, B)
    tp = _tp_of(sh)

    def seq_of(k, i, chunk):
        # the split of a cache chunk's S, from its spec
        return None if sh is None else _seq_split(rules.mesh,
                                                  sspecs[k][i][0], chunk)

    pos = state["pos"][rows]
    if sh is None:
        h = embed(params["embed"], tokens, dtype)
        final = params["final_norm"]
    else:
        h = sh.lookup(params["embed"]["table"], specs["embed"]["table"],
                      tokens)[rows].to(dtype)
        final = _norm_use(sh, params["final_norm"], specs["final_norm"])
    caches, shared = [], []
    for i, (kind, p, c) in enumerate(zip(layer_kinds(cfg), params["blocks"],
                                         state["caches"])):
        if sh is not None:
            p = sh.block(p, specs["blocks"][i])
        if kind in (MAMBA1, MAMBA2):
            dec = mb.mamba1_decode if kind == MAMBA1 else mb.mamba2_decode
            back = None
            if sh is not None:
                c, back = _mamba_state(rules, kind, tp("mamba") is not None,
                                       c, sspecs["caches"][i])
            a, c = dec(p["mamba"], cfg, apply_norm(cfg.norm, p["norm1"], h),
                       c, tp=tp("mamba"))
            h = h + a
            if back is not None:
                c = back(c)
        else:
            # a GQA cache splits its kv heads over model exactly where the
            # attention runs tensor-parallel (both need kv % model == 0)
            a, c = attention_decode(p["attn"], cfg,
                                    apply_norm(cfg.norm, p["norm1"], h), c,
                                    pos, tp=tp("attn"),
                                    seq=seq_of("caches", i, c[0]))
            h = h + a
            if cfg.cross_attention and "cross_kv" in state:
                kv = state["cross_kv"][i]
                a, _ = gqa_decode(p["cross"], cfg,
                                  apply_norm(cfg.norm, p["norm_x"], h), c,
                                  pos, tp=tp("cross"),
                                  seq=seq_of("cross_kv", i, kv[0]),
                                  cross_kv=kv)
                h = h + a
            hn = apply_norm(cfg.norm, p["norm2"], h)
            if kind == DENSE:
                h = h + mlp(p["mlp"], hn, dtype, tp=tp("mlp"))
            else:
                h = h + moe_apply(p["moe"], cfg, hn, tp=tp("moe"))
        caches.append(c)
        if _period_ends(cfg, i):
            k = len(shared)
            c = state["shared_cache"][k]
            sp = params["shared_attn"]
            if sh is not None:
                sp = sh.block(sp, specs["shared_attn"])
            h, c = _shared_decode(sp, cfg, h, c, pos, tp,
                                  seq_of("shared_cache", k, c[0]))
            shared.append(c)
    h = apply_norm(cfg.norm, final, h)
    if sh is None:
        logits = unembed(params[key], h, dtype)
    else:
        logits = sh.project(h, params[key]["table"], specs[key]["table"],
                            rows, B)
    new = dict(state, caches=caches, pos=state["pos"] + 1)
    if cfg.shared_attn_every:
        new["shared_cache"] = shared
    return logits[:, 0], new


def _shared_decode(p: dict, cfg: ModelConfig, h: torch.Tensor, cache,
                   pos: torch.Tensor, tp=None, seq=None):
    """One application of the shared block in a decode step, on its own
    period's cache: (h, the new cache); ``p`` as this application uses
    it, ``tp`` the parts' tensor-parallel route, ``seq`` the cache's
    split of S."""
    tp = tp or (lambda part: None)
    a, cache = attention_decode(p["attn"], cfg,
                                apply_norm(cfg.norm, p["norm"], h), cache,
                                pos, tp=tp("attn"), seq=seq)
    h = h + a
    if "mlp" in p:
        h = h + mlp(p["mlp"], apply_norm(cfg.norm, p["norm2"], h), h.dtype,
                    tp=tp("mlp"))
    return h, cache
