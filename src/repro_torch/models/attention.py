"""Attention blocks: GQA (covers MHA and MQA) with qk-norm (Qwen3), RoPE
or M-RoPE (Qwen2-VL), self- or cross-attention (Whisper's decoder), and
MLA (DeepSeek-V2's compressed-KV attention); full-sequence attention
(training and prefill) and single-token decode against a cache (the
counterpart of ``repro/models/attention.py``).

Softmax and logit math in f32; products in the config's compute dtype.
With ``attn_impl="flash"`` causal full-sequence attention (training and
prefill) goes through ``kernels.ops.sdpa_flash``, differentiable: the
flash forward kernel, and in the backward the dq and dkv kernels;
``"naive"`` is plain PyTorch, as in the JAX package.  With ``tp`` (a
``models.sharding.Sharded``) the full-sequence forward runs
tensor-parallel over ``model``: the projections are this rank's heads
(column-parallel ``wq``, ``wk``, ``wv``), attention runs on them, and
the row-parallel ``wo`` product is summed over the ranks (``tp.reduce``);
the input passes through ``tp.copy``, whose backward sums its gradient.

MLA caches, for each position, the rank-r latent ``c`` (after its
``kv_norm``, an RMSNorm over r) and one rotated rope key of width rd
shared by every head: (B, S, r) and (B, S, rd) where GQA caches (B, S,
kv, hd) twice.  Keys and values are expanded from the latent through
``w_uk`` / ``w_uv`` at every use (the whole cache, or this rank's chunk
of it, at every decode step, as in the JAX package); queries and keys
are [nope | rope] of width hd + rd, so the softmax scale is (hd +
rd)^-0.5.  MLA runs plain attention whatever ``attn_impl`` says, as the
JAX package does.

Cross-attention (``gqa_forward(kv_x=)``) takes its keys and values from
the encoder's output: no rotation of q or k, no mask, and always plain
attention (the flash kernel is causal self-attention only, as in the
JAX package); its decode (``gqa_decode(cross_kv=)``) attends over the
keys and values ``lm.prefill_cross_kv`` computed once, and passes the
self-attention cache through untouched.  M-RoPE rotates each section
of the rotary frequencies by its own position stream ((3, B, S):
temporal, height, width; ``layers.apply_mrope``); decode rotates with
the three streams equal to ``pos``, as the JAX package does.

Decode attention is one function for GQA and MLA, sharded or not:
``chunk_attention`` over a chunk of cache slots gives a partial output
and its log-sum-exp, and where the cache's S is split over an axis
(``SeqSplit``: its ``cache_spec`` puts S over ``model`` for MLA's latent
cache and for a GQA cache whose kv heads do not divide ``model``, over
``data`` for a batch that does not divide ``data``) ``merge_chunks``
gathers them over the axis and merges them (the maximum, then the
rescaled sums, in f32, in chunk order); unsplit, the one chunk is the
whole cache and there is nothing to merge.  ``write_slot`` writes the
new token only into the chunk that holds ``pos`` (``slot_masks``).
Sharded decode (``lm.decode_step(rules=)``) runs GQA and MLA over this
rank's heads where ``tp`` is given (MLA: ``wq``, ``w_uk``, ``w_uv`` split
on heads, ``wo`` row-parallel, the latent computed whole on every rank);
where MLA's heads and its latent cache's S are split over the same axis,
the queries and ``w_uk`` / ``w_uv`` are gathered over it, every head
attends over the rank's chunk, and the rank keeps its heads' merged
outputs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from .config import ModelConfig
from .layers import apply_mrope, apply_rope, dense_init, init_norm, rmsnorm

NEG_INF = -2.0e38


def init_gqa(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": dense_init(gen, d, (h, hd)),
         "wk": dense_init(gen, d, (kv, hd)),
         "wv": dense_init(gen, d, (kv, hd)),
         "wo": dense_init(gen, h * hd, d).reshape(h, hd, d)}
    if cfg.qk_norm:
        p["q_norm"] = init_norm(hd, gen.device)
        p["k_norm"] = init_norm(hd, gen.device)
    return p


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, T, kv, hd) -> (B, T, kv * n_rep, hd), each kv head repeated
    n_rep times in place (``jnp.repeat`` on the head axis)."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _sdpa(q, k, v, mask, dtype):
    """q: (B,S,H,hd) k/v: (B,T,H,hd); mask: (S,T) or (B,S,T) bool or None."""
    hd = q.shape[-1]
    logits = torch.einsum("bshd,bthd->bhst", q, k).float() * hd ** -0.5
    if mask is not None:
        mask = mask[None, None] if mask.ndim == 2 else mask[:, None]
        logits = torch.where(mask, logits,
                             torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _project(x, w, dtype):
    """``einsum("bsd,dhk->bshk")``: (B, S, D) x (D, H, k) -> (B, S, H, k)."""
    return torch.einsum("bsd,dhk->bshk", x, w.to(dtype))


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """A cache whose S is split over ``axis`` of ``mesh``: this rank holds
    the slots ``offset`` .. ``offset`` + its chunk's length."""
    mesh: object
    axis: str
    offset: int


def slot_masks(length: int, offset: int, pos: torch.Tensor):
    """``(at, valid)``, each (B, length) bool, for a chunk of a cache
    holding global slots ``offset`` .. ``offset + length``: the slot each
    row's ``pos`` writes (none for a ``pos`` outside the chunk, at or
    past S_max in particular) and the slots at or before ``pos``."""
    slots = torch.arange(offset, offset + length, device=pos.device)
    return slots[None] == pos[:, None], slots[None] <= pos[:, None]


def write_slot(cache: torch.Tensor, new: torch.Tensor,
               at: torch.Tensor) -> torch.Tensor:
    """The chunk (B, T, ...) with ``new`` (B, 1, ...) written where ``at``
    (B, T) (``slot_masks``): a new tensor."""
    at = at.reshape(*at.shape, *([1] * (cache.ndim - 2)))
    return torch.where(at, new.to(cache.dtype), cache)


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    offset: int, pos: Optional[torch.Tensor], scale: float):
    """Decode attention over one chunk of a cache.  q (B, Sq, H, dk); k
    (B, T, G, dk) and v (B, T, G, dv), the chunk's T slots from global
    slot ``offset``, with H a multiple of G (head h reads k / v head h //
    (H / G), ``_repeat_kv``'s order); pos (B,): the slots at or before it
    are valid (None: every slot, as cross-attention reads its frames).  Returns (o (B, Sq, H, dv) in q's dtype, lse (B, Sq, H)
    f32): the softmax over the chunk's valid slots (logits in f32, the
    probabilities in q's dtype, as ``_sdpa``) and its log-sum-exp,
    ``NEG_INF`` where the chunk holds no valid slot (its softmax is then
    uniform; ``merge_chunks`` gives it weight zero)."""
    B, Sq, H, dk = q.shape
    G = k.shape[2]
    qg = q.reshape(B, Sq, G, H // G, dk)
    logits = torch.einsum("bsgnd,btgd->bgnst", qg, k).float() * scale
    if pos is None:
        valid = torch.ones((B, k.shape[1]), dtype=torch.bool,
                           device=q.device)
    else:
        _, valid = slot_masks(k.shape[1], offset, pos)       # (B, T)
    logits = torch.where(valid[:, None, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bgnst,btgd->bsgnd", probs, v).reshape(B, Sq, H, -1)
    lse = torch.logsumexp(logits, dim=-1)                    # (B, G, n, Sq)
    lse = torch.where(valid.any(-1)[:, None, None, None], lse,
                      torch.full_like(lse, NEG_INF))
    return o, lse.permute(0, 3, 1, 2).reshape(B, Sq, H)


def merge_chunks(seq: Optional[SeqSplit], o: torch.Tensor,
                 lse: torch.Tensor) -> torch.Tensor:
    """The attention over every chunk along ``seq.axis`` from each rank's
    ``chunk_attention`` (o, lse): one gather of [o | lse] in f32 over the
    axis (kind ``"seq"``), then on every rank alike the maximum m of the
    lse, the weights exp(lse - m) (zero for an empty chunk, whose lse is
    ``NEG_INF``) and the weighted sum of the outputs over the summed
    weights, in chunk order; o's dtype out.  ``o`` itself where ``seq``
    is None (an unsplit cache: one chunk)."""
    if seq is None:
        return o
    packed = torch.cat([o.float(), lse[..., None]], dim=-1)
    allp = seq.mesh.all_gather(packed[None], seq.axis, 0, "seq")
    outs, lses = allp[..., :-1], allp[..., -1]
    w = torch.exp(lses - lses.amax(0))
    out = (w[..., None] * outs).sum(0) / w.sum(0)[..., None]
    return out.to(o.dtype)


def _rotate_qk(q, k, cfg: ModelConfig, positions, rope_cache=None):
    """q and k rotated at ``positions``: M-RoPE over (3, B, S) streams
    where ``cfg.mrope``, else RoPE over (B, S) (or ``rope_cache``)."""
    if cfg.mrope:
        return (apply_mrope(q, positions, cfg.rope_theta,
                            cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta,
                            cfg.mrope_sections))
    return (apply_rope(q, positions, cfg.rope_theta, cache=rope_cache),
            apply_rope(k, positions, cfg.rope_theta, cache=rope_cache))


def gqa_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: Optional[torch.Tensor], rope_cache=None,
                tp=None, kv_x: Optional[torch.Tensor] = None,
                causal: Optional[bool] = None) -> torch.Tensor:
    """Full-sequence attention (training and prefill): x (B, S, D) ->
    (B, S, D), causal unless ``causal`` (by default ``cfg.causal``) is
    False; over this rank's heads with ``tp`` (module docstring).  With
    ``kv_x`` (B, T, D) cross-attention: keys and values from ``kv_x``,
    neither rotated nor masked, through plain attention."""
    dtype = x.dtype
    cross = kv_x is not None
    if tp is not None:
        x = tp.copy(x)
        if cross:
            kv_x = tp.copy(kv_x)
    src = kv_x if cross else x
    q = _project(x, p["wq"], dtype)
    k = _project(src, p["wk"], dtype)
    v = _project(src, p["wv"], dtype)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if not cross:
        q, k = _rotate_qk(q, k, cfg, positions, rope_cache)
    k = _repeat_kv(k, cfg.n_heads // cfg.n_kv_heads)
    v = _repeat_kv(v, cfg.n_heads // cfg.n_kv_heads)
    use_causal = (cfg.causal if causal is None else causal) and not cross
    if cfg.attn_impl == "flash" and use_causal:
        out = ops.sdpa_flash(q, k, v, causal=True)
    else:
        mask = None
        if use_causal:
            S, T = q.shape[1], k.shape[1]
            mask = torch.ones((S, T), dtype=torch.bool,
                              device=x.device).tril()
        out = _sdpa(q, k, v, mask, dtype)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dtype))
    return out if tp is None else tp.reduce(out)


def gqa_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
               cache: Tuple[torch.Tensor, torch.Tensor], pos: torch.Tensor,
               tp=None, seq: Optional[SeqSplit] = None,
               cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One-token decode.  x: (B, 1, D); cache: (k, v), each (B, S_max, kv,
    hd); pos: (B,) the position each row writes.  Returns (out, new
    cache); the caches are new tensors (the inputs are not written), and
    a ``pos`` at or past S_max writes nothing, as the JAX one-hot does.
    With ``tp`` over this rank's heads (the cache holds its kv heads);
    with ``seq`` the cache is this rank's chunk of S (module
    docstring).  With ``cross_kv`` (k, v), each (B, T, kv, hd): plain
    attention of the unrotated query over them (with ``seq`` over this
    rank's chunk of the T frames, merged over its axis), the cache
    returned as it came."""
    dtype = x.dtype
    if tp is not None:
        x = tp.copy(x)
    q = _project(x, p["wq"], dtype)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
    if cross_kv is not None:
        if seq is None:
            n_rep = cfg.n_heads // cfg.n_kv_heads
            k, v = (_repeat_kv(t.to(dtype), n_rep) for t in cross_kv)
            o = _sdpa(q, k, v, None, dtype)
        else:
            k, v = (t.to(dtype) for t in cross_kv)
            o = merge_chunks(seq, *chunk_attention(
                q, k, v, seq.offset, None, q.shape[-1] ** -0.5))
        out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(dtype))
        return (out if tp is None else tp.reduce(out)), cache
    k_new = _project(x, p["wk"], dtype)
    v_new = _project(x, p["wv"], dtype)
    if cfg.qk_norm:
        k_new = rmsnorm(p["k_norm"], k_new)
    if cfg.mrope:       # the three streams equal: (t, t, t)
        positions = pos[None, :, None].expand(3, -1, 1)
    else:
        positions = pos[:, None]
    q, k_new = _rotate_qk(q, k_new, cfg, positions)

    offset = 0 if seq is None else seq.offset
    at, _ = slot_masks(cache[0].shape[1], offset, pos)      # (B, S)
    ck = write_slot(cache[0], k_new, at)
    cv = write_slot(cache[1], v_new, at)
    o, lse = chunk_attention(q, ck.to(dtype), cv.to(dtype), offset, pos,
                             q.shape[-1] ** -0.5)
    out = merge_chunks(seq, o, lse)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dtype))
    return (out if tp is None else tp.reduce(out)), (ck, cv)


def init_gqa_cache(cfg: ModelConfig, batch: int, seq: int,
                   dtype: torch.dtype, device):
    shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


# =====================================================================
# MLA (DeepSeek-V2): a compressed cache of width kv_lora_rank + rope dim
# =====================================================================

def init_mla(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    hd, rd, vd = cfg.head_dim, cfg.qk_rope_head_dim, cfg.v_head
    r = cfg.kv_lora_rank
    return {"wq": dense_init(gen, d, (h, hd + rd)),    # q: nope + rope
            "w_dkv": dense_init(gen, d, r),            # down-proj (cached)
            "w_kr": dense_init(gen, d, rd),            # shared rope key
            "w_uk": dense_init(gen, r, (h, hd)),       # up-proj k_nope
            "w_uv": dense_init(gen, r, (h, vd)),       # up-proj v
            "wo": dense_init(gen, h * vd, d).reshape(h, vd, d),
            "kv_norm": init_norm(r, gen.device)}


def _mla_latent(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """The cached pair of x (B, T, D): the normed latent c (B, T, r) and
    the rope key rotated at ``positions`` (B, T), (B, T, rd)."""
    c = rmsnorm(p["kv_norm"], x @ p["w_dkv"].to(x.dtype))
    k_rope = x @ p["w_kr"].to(x.dtype)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c, k_rope


def _mla_qkv(p: dict, cfg: ModelConfig, x, c, k_rope, positions, dtype):
    """q (B, S, H, hd + rd) from x at ``positions``; k (B, T, H, hd + rd)
    and v (B, T, H, vd) expanded from the latent c and the rope key."""
    hd, rd = cfg.head_dim, cfg.qk_rope_head_dim
    q = _project(x, p["wq"], dtype)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_nope = torch.einsum("btr,rhk->bthk", c, p["w_uk"].to(dtype))
    v = torch.einsum("btr,rhk->bthk", c, p["w_uv"].to(dtype))
    q_full = torch.cat([q_nope, q_rope], -1)
    k_rope_b = k_rope[:, :, None, :].expand(*k_nope.shape[:3], rd)
    return q_full, torch.cat([k_nope, k_rope_b], -1), v


def mla_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, tp=None) -> torch.Tensor:
    """Full-sequence causal MLA: x (B, S, D) -> (B, S, D); over this
    rank's heads with ``tp`` (the latent computed whole)."""
    dtype = x.dtype
    if tp is not None:
        x = tp.copy(x)
    c, k_rope = _mla_latent(p, cfg, x, positions)
    q, k, v = _mla_qkv(p, cfg, x, c, k_rope, positions, dtype)
    S = x.shape[1]
    mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    out = _sdpa(q, k, v, mask, dtype)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dtype))
    return out if tp is None else tp.reduce(out)


def mla_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
               cache: Tuple[torch.Tensor, torch.Tensor], pos: torch.Tensor,
               tp=None, seq: Optional[SeqSplit] = None):
    """One-token MLA decode.  x: (B, 1, D); cache: (c, k_rope), (B, S_max,
    r) and (B, S_max, rd); pos: (B,).  Returns (out, new cache), new
    tensors, written at ``pos`` as ``gqa_decode`` writes.  With ``tp``
    over this rank's heads; with ``seq`` the cache is this rank's chunk
    of S (module docstring)."""
    dtype = x.dtype
    if tp is not None:
        x = tp.copy(x)
    c_new, kr_new = _mla_latent(p, cfg, x, pos[:, None])
    offset = 0 if seq is None else seq.offset
    at, _ = slot_masks(cache[0].shape[1], offset, pos)
    cc = write_slot(cache[0], c_new, at)
    ckr = write_slot(cache[1], kr_new, at)
    # heads and slots split over one axis: every head over the rank's chunk
    every_head = seq is not None and tp is not None and seq.axis == tp.tp
    if every_head:
        p = dict(p, **{n: seq.mesh.all_gather(p[n].to(dtype), seq.axis, 1,
                                              "param")
                       for n in ("w_uk", "w_uv")})
    q, k, v = _mla_qkv(p, cfg, x, cc.to(dtype), ckr.to(dtype), pos[:, None],
                       dtype)
    if every_head:
        q = seq.mesh.all_gather(q, seq.axis, 2, "seq")
    o, lse = chunk_attention(q, k, v, offset, pos, q.shape[-1] ** -0.5)
    out = merge_chunks(seq, o, lse)
    if every_head:
        out = out.chunk(seq.mesh.shape[seq.axis], 2)[tp.index()]
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dtype))
    return (out if tp is None else tp.reduce(out)), (cc, ckr)


def init_mla_cache(cfg: ModelConfig, batch: int, seq: int,
                   dtype: torch.dtype, device):
    return (torch.zeros((batch, seq, cfg.kv_lora_rank), dtype=dtype,
                        device=device),
            torch.zeros((batch, seq, cfg.qk_rope_head_dim), dtype=dtype,
                        device=device))


# dispatchers ---------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   cross: bool = False) -> dict:
    """A block's attention params; cross-attention is always GQA."""
    if cfg.attn_type == "mla" and not cross:
        return init_mla(gen, cfg)
    return init_gqa(gen, cfg)


def attention_forward(p, cfg, x, positions, rope_cache=None, tp=None):
    if cfg.attn_type == "mla":
        return mla_forward(p, cfg, x, positions, tp=tp)
    return gqa_forward(p, cfg, x, positions, rope_cache=rope_cache, tp=tp)


def attention_decode(p, cfg, x, cache, pos, tp=None, seq=None):
    if cfg.attn_type == "mla":
        return mla_decode(p, cfg, x, cache, pos, tp=tp, seq=seq)
    return gqa_decode(p, cfg, x, cache, pos, tp=tp, seq=seq)


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype: torch.dtype,
               device):
    if cfg.attn_type == "mla":
        return init_mla_cache(cfg, batch, seq, dtype, device)
    return init_gqa_cache(cfg, batch, seq, dtype, device)
