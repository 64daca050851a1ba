"""The port's MoE family (``repro_torch.models.moe``, MLA in
``models.attention``, MoE blocks in ``models.lm``) against the JAX
package on reduced DeepSeek-V2-Lite (MLA + MoE, shared experts) and
Arctic (GQA + MoE + dense residual): the same JAX params carried across
by ``convert.lm_params``, the same numpy inputs.

Bounds, as in tests/test_torch_lm.py: f32 1e-4 (the two packages sum the
same f32 products in another order, ~1e-6 measured); bf16 5e-2, the JAX
model tests' own bound.  The capacity dispatch must drop the tokens JAX
drops, so it is held against JAX's capacity output (never against the
dense one) at capacity factors 1.0 and 1.25, where tokens drop.

bf16 through a whole MoE model.  Routing is discontinuous: a token
whose k-th and (k+1)-th gates are within a bf16 rounding of each other,
or whose priority sits at an expert's capacity boundary, is routed by
the rounding of the layers before it, and then its output moves by a
whole gate-weighted expert output (~0.2-0.5 in the logits).  The two
packages round their bf16 products differently (XLA's CPU backend
computes bf16 dots in f32 and fuses casts away), so such tokens occur
for some weights and tokens; the port disagrees with itself the same way
between naive and flash attention.  The bf16 LM forward is therefore
held elementwise at 5e-2 on every position before its row's first
routing difference, where the routing decisions come from each package
itself (JAX's recomputed inside its traced forward, the port's from its
MoE inputs), and each top-k difference must sit at a near-tie of the
port's gates.  The MoE and MLA modules alone, on the same bf16 inputs,
are held elementwise everywhere.

The decode and serving parity is in tests/test_torch_moe_decode.py, the
gradients and training in tests/test_torch_moe_train.py, the CLIs in
tests/test_torch_moe_cli.py.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm as j_lm
from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import moe as j_moe
import repro_torch.models.lm as t_lm
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import forward
from repro_torch.models import attention as t_attn
from repro_torch.models import moe as t_moe
from repro_torch.tree import map_tree

ARCHS = ["deepseek_v2_lite_16b", "arctic_480b"]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_get_config(arch, reduced=True), **kw),
            dataclasses.replace(get_config(arch, reduced=True), **kw))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _params(jcfg, cfg, seed=0):
    jp = j_init_params(jax.random.key(seed), jcfg)
    return jp, convert.lm_params(_np(jp), cfg, device="cpu")


def _tensors(tree):
    return map_tree(lambda a: torch.from_numpy(np.array(a, np.float32)),
                    _np(tree))


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _x(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _moe_pair(arch, dtype, seed=0, **kw):
    jcfg, cfg = _cfgs(arch, dtype=dtype, **kw)
    jp = j_moe.init_moe(jax.random.key(seed), jcfg)
    return jcfg, cfg, jp, _tensors(jp)


# ------------------------------------------------------------- the MoE ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_jax(arch, dtype):
    """The dense dispatch, shared experts and Arctic's dense residual."""
    jcfg, cfg, jp, p = _moe_pair(arch, dtype)
    xj, xt = _x((2, 16, cfg.d_model), 3, dtype)
    got = t_moe.moe_forward(p, cfg, xt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    _close(got.float().numpy(), j_moe.moe_forward(jp, jcfg, xj), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [1.0, 1.25, None],
                         ids=["cf1.0", "cf1.25", "cf-no-drop"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_capacity_matches_jax(arch, factor, dtype):
    """The grouped capacity dispatch drops the tokens JAX drops (held
    against JAX's capacity output; at factors 1.0 and 1.25 tokens drop,
    so it differs from the dense dispatch); with factor E / k (capacity
    S) nothing drops and it equals the dense dispatch."""
    base = get_config(arch, reduced=True)
    cf = base.n_experts / base.top_k if factor is None else factor
    jcfg, cfg, jp, p = _moe_pair(arch, dtype, capacity_factor=cf,
                                 moe_impl="capacity")
    xj, xt = _x((2, 32, cfg.d_model), 4, dtype)
    got = t_moe.moe_forward_capacity(p, cfg, xt)
    _close(got.float().numpy(), j_moe.moe_forward_capacity(jp, jcfg, xj),
           TOL[dtype])
    _close(t_moe.moe_apply(p, cfg, xt).float().numpy(),
           got.float().numpy(), 0)
    dense = t_moe.moe_forward(p, cfg, xt).float()
    if factor is None:
        _close(got.float().numpy(), dense.numpy(), TOL[dtype])
    elif dtype == "float32":
        assert float((got - dense).abs().max()) > 1e-2   # tokens dropped


@pytest.mark.parametrize("impl", ["dense", "capacity"])
def test_two_experts_picking_one_token_both_add(impl):
    """Top-2 routing where every token goes to experts 0 and 1: each
    output row is the sum of both experts' gate-weighted outputs (an
    index_put without accumulation would keep only one of them)."""
    _, cfg = _cfgs("arctic_480b", dtype="float32", moe_impl=impl,
                   capacity_factor=4.0, dense_residual_ff=0)
    p = t_moe.init_moe(torch.Generator().manual_seed(0), cfg)
    p["router"] = torch.zeros_like(p["router"])
    p["router"][:, 0] = 1.0
    p["router"][:, 1] = 0.5
    x = torch.rand((2, 8, cfg.d_model), generator=torch.Generator()
                   .manual_seed(1)) + 0.1    # positive: experts 0, 1 lead
    gates = torch.softmax(x @ p["router"], -1)
    w = gates[..., :2] / gates[..., :2].sum(-1, keepdim=True)
    want = 0
    for j in range(2):
        h = (torch.nn.functional.silu(x @ p["wi_gate"][j])
             * (x @ p["wi_up"][j])) @ p["wo"][j]
        want = want + w[..., j:j + 1] * h
    got = t_moe.moe_apply(p, cfg, x)
    _close(got.numpy(), want.numpy(), 1e-5)


@pytest.mark.parametrize("S,k,e,cf", [(1024, 6, 64, 1.25), (1, 6, 64, 1.25),
                                      (32, 2, 8, 1.0), (7, 2, 128, 1.25),
                                      (4096, 2, 128, 1.25), (5, 2, 8, 4.0)])
def test_capacity_is_the_jax_formula(S, k, e, cf):
    """int(S k / E cf) in Python floats, clamped to [1, S]; 1 at decode."""
    _, cfg = _cfgs("arctic_480b", top_k=k, n_experts=e, capacity_factor=cf)
    assert t_moe.capacity(cfg, S) == min(max(int(S * k / e * cf), 1), S)
    if S == 1:
        assert t_moe.capacity(cfg, S) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_load_balance_loss_matches_jax(arch):
    jcfg, cfg, jp, p = _moe_pair(arch, "bfloat16")
    xj, xt = _x((2, 16, cfg.d_model), 5, "float32")
    got = t_moe.aux_load_balance_loss(p, cfg, xt)
    assert got.dtype == torch.float32 and got.ndim == 0
    _close(float(got), float(j_moe.aux_load_balance_loss(jp, jcfg, xj)),
           1e-5)


# ------------------------------------------------------------- MLA -------

def _mla_pair(dtype, seed=0):
    jcfg, cfg = _cfgs("deepseek_v2_lite_16b", dtype=dtype)
    jp = j_attn.init_mla(jax.random.key(seed), jcfg)
    return jcfg, cfg, jp, _tensors(jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_forward_matches_jax(dtype):
    jcfg, cfg, jp, p = _mla_pair(dtype)
    xj, xt = _x((2, 24, cfg.d_model), 6, dtype)
    pos = np.broadcast_to(np.arange(24), (2, 24))
    got = t_attn.mla_forward(p, cfg, xt, torch.from_numpy(pos.copy()))
    assert got.dtype == xt.dtype
    _close(got.float().numpy(),
           j_attn.mla_forward(jp, jcfg, xj, jnp.asarray(pos)), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_and_cache_match_jax(dtype):
    """Decode steps from the same zero cache at per-row positions: each
    output and the cache pair (c (B, S, r), k_rope (B, S, rd)) after."""
    jcfg, cfg, jp, p = _mla_pair(dtype)
    B, S = 2, 6
    jc = j_attn.init_mla_cache(jcfg, B, S + 2, getattr(jnp, dtype))
    tc = t_attn.init_mla_cache(cfg, B, S + 2, getattr(torch, dtype), "cpu")
    assert tc[0].shape == (B, S + 2, cfg.kv_lora_rank)
    assert tc[1].shape == (B, S + 2, cfg.qk_rope_head_dim)
    for t in range(S):
        xj, xt = _x((B, 1, cfg.d_model), 10 + t, dtype)
        pos = np.array([t, t + 1])
        jo, jc = j_attn.mla_decode(jp, jcfg, xj, jc, jnp.asarray(pos))
        to, tc = t_attn.mla_decode(p, cfg, xt, tc, torch.from_numpy(pos))
        _close(to.float().numpy(), jo, TOL[dtype])
    for got, want in zip(tc, jc):
        _close(got.float().numpy(), want, TOL[dtype])


# ------------------------------------------------------------- the LM ----

@pytest.mark.parametrize("impl", ["dense", "capacity"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_f32_matches_jax(arch, impl):
    jcfg, cfg = _cfgs(arch, dtype="float32", moe_impl=impl)
    jp, p = _params(jcfg, cfg)
    toks = _tokens(cfg, (2, 32))
    got = forward(p, cfg, torch.from_numpy(toks))
    assert got.shape == (2, 32, cfg.vocab_size) and got.dtype == torch.float32
    _close(got.numpy(), j_forward(jp, jcfg, jnp.asarray(toks, jnp.int32)),
           1e-4)


def _j_decisions(p, cfg, x):
    """(B, S, E) bool, the experts that take each token, by the JAX MoE's
    own expressions (traced inside its forward)."""
    e, k = cfg.n_experts, cfg.top_k
    logits = jnp.einsum("bsd,de->bse", x, p["router"].astype(x.dtype))
    gates = jax.nn.softmax(logits.astype(jnp.float32), -1)
    top_w, top_idx = jax.lax.top_k(gates, k)
    top_w = top_w / jnp.sum(top_w, -1, keepdims=True)
    routed = jnp.sum(jax.nn.one_hot(top_idx, e) * top_w[..., None], -2)
    if cfg.moe_impl != "capacity":
        return routed > 0
    S = x.shape[1]
    cap = min(max(int(S * k / e * cfg.capacity_factor), 1), S)
    priority = jnp.where(routed > 0, routed, -jnp.inf).transpose(0, 2, 1)
    pri_w, tok_idx = jax.lax.top_k(priority, cap)
    kept = jax.vmap(jax.vmap(lambda idx, w: jnp.zeros(S, bool).at[idx].set(
        jnp.isfinite(w))))(tok_idx, pri_w)
    return kept.transpose(0, 2, 1)


def _t_decisions(p, cfg, x):
    """The port's (B, S, E) decisions and each token's top-k gate margin
    (the k-th gate less the (k+1)-th)."""
    gates, top_w, top_idx = t_moe._route(p, cfg, x)
    routed = t_moe._routed(top_w, top_idx, cfg.n_experts)
    g = gates.sort(-1, descending=True).values
    margin = g[..., cfg.top_k - 1] - g[..., cfg.top_k]
    if cfg.moe_impl != "capacity":
        return routed > 0, margin
    pri = torch.where(routed > 0, routed, torch.full_like(
        routed, float("-inf"))).transpose(1, 2)
    w, idx = pri.topk(t_moe.capacity(cfg, x.shape[1]), -1)
    kept = torch.zeros_like(pri, dtype=torch.bool).scatter_(
        -1, idx, torch.isfinite(w))
    return kept.transpose(1, 2), margin


@pytest.mark.parametrize("impl", ["dense", "capacity"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_matches_jax_up_to_routing(arch, impl):
    """bf16 logits at 5e-2 on every position before its row's first
    routing difference (module docstring); a top-k difference only at a
    near-tie (gate margin within the bf16 bound)."""
    jcfg, cfg = _cfgs(arch, moe_impl=impl)
    jp, p = _params(jcfg, cfg)
    toks = _tokens(cfg, (2, 32))
    j_seen, t_seen = [], []
    j_apply, t_apply = j_lm.moe_apply, t_lm.moe_apply

    def j_recording(pp, c, x, rules=None):
        jax.debug.callback(lambda d: j_seen.append(np.asarray(d)),
                           _j_decisions(pp, c, x))
        return j_apply(pp, c, x, rules=rules)

    def t_recording(pp, c, x, tp=None):
        t_seen.append(_t_decisions(pp, c, x))
        return t_apply(pp, c, x, tp=tp)

    with mock.patch.object(j_lm, "moe_apply", j_recording), \
            mock.patch.object(t_lm, "moe_apply", t_recording):
        want = np.asarray(j_forward(jp, jcfg, jnp.asarray(toks, jnp.int32)),
                          np.float32)
        got = forward(p, cfg, torch.from_numpy(toks)).numpy()
    assert len(j_seen) == len(t_seen) == cfg.n_layers
    B, S = toks.shape
    first = np.full(B, S)
    for (t_dec, margin), j_dec in zip(t_seen, j_seen):
        differs = (t_dec.numpy() != j_dec).any(-1)
        for b in range(B):
            hits = np.nonzero(differs[b])[0]
            if len(hits):
                first[b] = min(first[b], hits[0])
            if impl == "dense":
                assert all(float(margin[b, s]) <= 5e-2 for s in hits)
    assert first.sum() >= B * S // 4, first     # most positions are held
    for b in range(B):
        _close(got[b, :first[b]], want[b, :first[b]], 5e-2)
