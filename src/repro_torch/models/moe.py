"""Mixture-of-Experts FFN: shared experts and routed top-k experts, with
an optional parallel dense-residual MLP (Snowflake Arctic); the
counterpart of ``repro/models/moe.py``.

The experts' weights are stacked on a leading E axis.  Two dispatches,
picked by ``cfg.moe_impl``:

* ``moe_forward`` ("dense"): every expert computes on every token and a
  (B, S, E) combine tensor of renormalised top-k gate weights zeroes the
  pairs that were not routed.
* ``moe_forward_capacity`` ("capacity", GShard-style and grouped by
  sequence): each expert takes at most C = int(S k / E *
  capacity_factor) tokens of each row, clamped to [1, S], by gate
  weight; the tokens past an expert's capacity drop that expert.  The
  expert outputs, scaled by their gate weights, are added back to their
  token positions with an accumulating index_put, so a token that
  several experts picked gets every pick.  At decode (S = 1) C is 1 and
  nothing drops.

With ``tp`` (a ``models.sharding.Sharded`` whose ``tp_parts`` hold
"moe") the experts run expert-parallel over ``model``: this rank's
chunk of the stacked weights is its expert range [e0, e1).  Routing,
top-k, the capacity C (from the global E) and each expert's top-C pick
run over all E experts on every rank alike; the gather, the three
expert products and the scatter-add run over the rank's experts only,
and the partial outputs are summed over ``model`` in one reduction.  The
input reaches the routed part through ``tp.copy`` (the router is behind
it too, ``Sharded.block``: both gradients are sums of the ranks'
partials); the shared experts and the dense residual are computed whole
on every rank from the gathered leaves and added after the reduction.

The router logits are computed in the compute dtype and cast to f32 for
the softmax; the combine weights and the scatter are in the compute
dtype, as in the JAX package.  The expert products are batched einsums
(the reference computes them outside any Pallas kernel too).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dense_init, init_mlp, mlp


def _stacked_init(gen: torch.Generator, e: int, d_in: int,
                  d_out: int) -> torch.Tensor:
    """E matrices (d_in, d_out) stacked on a leading axis, each drawn as
    ``dense_init(gen, d_in, d_out)`` draws one (truncated normal, fan-in
    d_in)."""
    w = torch.empty((e, d_in, d_out), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(d_in ** -0.5)


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.moe_ff, cfg.n_experts
    p = {"router": dense_init(gen, d, e),
         "wi_gate": _stacked_init(gen, e, d, f),
         "wi_up": _stacked_init(gen, e, d, f),
         "wo": _stacked_init(gen, e, f, d)}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d, f * cfg.n_shared_experts)
    if cfg.dense_residual_ff:
        p["dense_residual"] = init_mlp(gen, d, cfg.dense_residual_ff)
    return p


def _route(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """f32 gates (B, S, E) and the renormalised top-k (weights, expert
    ids), each (B, S, k)."""
    logits = (x @ p["router"].to(x.dtype)).float()
    gates = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.topk(gates, cfg.top_k, dim=-1)
    return gates, top_w / top_w.sum(-1, keepdim=True), top_idx


def _routed(top_w: torch.Tensor, top_idx: torch.Tensor, e: int):
    """(B, S, E) f32: each token's weight for every expert, 0 where the
    expert was not routed."""
    return (F.one_hot(top_idx, e).float() * top_w[..., None]).sum(-2)


def _residual_branches(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       out: torch.Tensor) -> torch.Tensor:
    if cfg.n_shared_experts:
        out = out + mlp(p["shared"], x, x.dtype)
    if cfg.dense_residual_ff:
        out = out + mlp(p["dense_residual"], x, x.dtype)
    return out


def _expert_range(p: dict, tp) -> tuple:
    """[e0, e1): the experts whose weights this rank holds."""
    n = p["wi_gate"].shape[0]
    e0 = 0 if tp is None else tp.index() * n
    return e0, e0 + n


def _routed_dense(p: dict, cfg: ModelConfig, x: torch.Tensor, e0: int,
                  e1: int) -> torch.Tensor:
    dtype = x.dtype
    _, top_w, top_idx = _route(p, cfg, x)
    combine = _routed(top_w, top_idx, cfg.n_experts)[..., e0:e1].to(dtype)
    gate_h = torch.einsum("bsd,edf->ebsf", x, p["wi_gate"].to(dtype))
    up_h = torch.einsum("bsd,edf->ebsf", x, p["wi_up"].to(dtype))
    h = F.silu(gate_h) * up_h
    expert_out = torch.einsum("ebsf,efd->ebsd", h, p["wo"].to(dtype))
    return torch.einsum("ebsd,bse->bsd", expert_out, combine)


def capacity(cfg: ModelConfig, seq: int) -> int:
    """Tokens an expert takes from each row of ``seq`` tokens: the JAX
    package's ``int(S * k / E * capacity_factor)`` in Python floats,
    clamped to [1, S]."""
    cap = int(seq * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return min(max(cap, 1), seq)


def _routed_capacity(p: dict, cfg: ModelConfig, x: torch.Tensor, e0: int,
                     e1: int) -> torch.Tensor:
    dtype = x.dtype
    B, S, D = x.shape
    e, cap = e1 - e0, capacity(cfg, S)
    _, top_w, top_idx = _route(p, cfg, x)
    routed = _routed(top_w, top_idx, cfg.n_experts)[..., e0:e1]
    priority = torch.where(routed > 0, routed,
                           torch.full_like(routed, float("-inf")))
    pri_w, tok_idx = torch.topk(priority.transpose(1, 2), cap, dim=-1)
    w = torch.where(torch.isfinite(pri_w), pri_w,
                    torch.zeros_like(pri_w)).to(dtype)        # (B, e, C)

    gidx = tok_idx.reshape(B, e * cap)
    gathered = torch.gather(x, 1, gidx[..., None].expand(B, e * cap, D))
    gathered = gathered.reshape(B, e, cap, D)
    gate_h = torch.einsum("becd,edf->becf", gathered,
                          p["wi_gate"].to(dtype))
    up_h = torch.einsum("becd,edf->becf", gathered, p["wi_up"].to(dtype))
    h = F.silu(gate_h) * up_h
    eo = torch.einsum("becf,efd->becd", h, p["wo"].to(dtype))
    eo = eo * w[..., None]
    rows = torch.arange(B, device=x.device)[:, None].expand(B, e * cap)
    out = torch.zeros((B, S, D), dtype=dtype, device=x.device)
    return out.index_put((rows, gidx), eo.reshape(B, e * cap, D),
                         accumulate=True)


def _moe(routed_fn, p: dict, cfg: ModelConfig, x: torch.Tensor,
         tp) -> torch.Tensor:
    e0, e1 = _expert_range(p, tp)
    if tp is None:
        return _residual_branches(p, cfg, x, routed_fn(p, cfg, x, e0, e1))
    out = tp.reduce(routed_fn(p, cfg, tp.copy(x), e0, e1))
    return _residual_branches(p, cfg, x, out)


def moe_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                tp=None) -> torch.Tensor:
    """The dense dispatch: x (B, S, D) -> (B, S, D); over this rank's
    experts with ``tp`` (module docstring)."""
    return _moe(_routed_dense, p, cfg, x, tp)


def moe_forward_capacity(p: dict, cfg: ModelConfig, x: torch.Tensor,
                         tp=None) -> torch.Tensor:
    """The grouped capacity dispatch: x (B, S, D) -> (B, S, D).  Each
    expert picks its top-C tokens of each row by gate weight; a slot
    left without a routed token picks an arbitrary one at weight 0.
    Over this rank's experts with ``tp`` (module docstring)."""
    return _moe(_routed_capacity, p, cfg, x, tp)


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
              tp=None) -> torch.Tensor:
    if cfg.moe_impl == "capacity":
        return moe_forward_capacity(p, cfg, x, tp)
    return moe_forward(p, cfg, x, tp)


def aux_load_balance_loss(p: dict, cfg: ModelConfig,
                          x: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance auxiliary, E * sum_e (share of top-k picks
    of e) * (mean gate of e), all in f32.  Standalone: the training loss
    does not add it (nor does the JAX package's)."""
    logits = x.float() @ p["router"].float()
    gates = torch.softmax(logits, dim=-1)
    _, top_idx = torch.topk(gates, cfg.top_k, dim=-1)
    frac = F.one_hot(top_idx, cfg.n_experts).float().mean(dim=(0, 1, 2))
    prob = gates.mean(dim=(0, 1))
    return cfg.n_experts * (frac * prob).sum()
