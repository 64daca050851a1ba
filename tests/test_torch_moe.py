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
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.models import attention as j_attn
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_decode_state as j_init_decode_state
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.models import moe as j_moe
from repro.train import greedy_generate as j_greedy_generate
from repro.train.serving import Request as JRequest
from repro.train.serving import ServingEngine as JServingEngine
import repro_torch.models.lm as t_lm
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_params)
from repro_torch.models import attention as t_attn
from repro_torch.models import moe as t_moe
from repro_torch.models.lm import abstract_params
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import decayed
from repro_torch.train import (Request, ServingEngine, greedy_generate,
                               loss_and_grads)
from repro_torch.tree import leaves, leaves_with_paths, map_tree

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

    def t_recording(pp, c, x):
        t_seen.append(_t_decisions(pp, c, x))
        return t_apply(pp, c, x)

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


@pytest.mark.parametrize("impl", ["dense", "capacity"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_caches_match_jax(arch, impl):
    """Teacher-forced decode from the same zero state: each step's logits,
    the final caches (MLA's (c, k_rope) for DeepSeek) and positions."""
    jcfg, cfg = _cfgs(arch, dtype="float32", moe_impl=impl)
    jp, p = _params(jcfg, cfg)
    B, S = 2, 8
    toks = _tokens(cfg, (B, S), seed=2)
    jstate = j_init_decode_state(jcfg, B, S + 2)
    state = convert.decode_state(jax.tree.map(np.asarray, jstate), cfg,
                                 device="cpu")
    for t in range(S):
        jl, jstate = j_decode_step(jp, jcfg, jstate,
                                   jnp.asarray(toks[:, t:t + 1], jnp.int32))
        tl, state = decode_step(p, cfg, state,
                                torch.from_numpy(toks[:, t:t + 1]))
        _close(tl.numpy(), jl, 1e-4)
    want = convert.decode_state(jax.tree.map(np.asarray, jstate), cfg,
                                device="cpu")
    assert torch.equal(state["pos"], want["pos"])
    assert len(state["caches"]) == cfg.n_layers
    for pair, wpair in zip(state["caches"], want["caches"]):
        for got, w in zip(pair, wpair):
            assert got.shape == w.shape
            _close(got.numpy(), w.numpy(), 1e-4)
    if cfg.attn_type == "mla":
        assert state["caches"][0][0].shape == (B, S + 2, cfg.kv_lora_rank)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch, dtype):
    """The port's form of tests/test_models_smoke.py::
    test_decode_matches_prefill, dense dispatch as that test pins it
    (capacity drops at prefill but never at decode)."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype,
                              moe_impl="dense")
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(cfg, (B, S), seed=3))
    ref = forward(p, cfg, toks)
    state = init_decode_state(cfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        logits, state = decode_step(p, cfg, state, toks[:, t:t + 1])
        outs.append(logits)
    _close(torch.stack(outs, 1).numpy(), ref.numpy(), TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_jax(arch):
    jcfg, cfg = _cfgs(arch, dtype="float32")
    jp, p = _params(jcfg, cfg)
    prompt = _tokens(cfg, (2, 5), seed=4)
    want, _ = j_greedy_generate(jp, jcfg, j_init_decode_state(jcfg, 2, 32),
                                jnp.asarray(prompt, jnp.int32), 6)
    got, state = greedy_generate(p, cfg, init_decode_state(cfg, 2, 32,
                                                           device="cpu"),
                                 torch.from_numpy(prompt), 6)
    assert got.tolist() == np.asarray(want).tolist()
    assert state["pos"].tolist() == [10, 10]


def _drive(engine_cls, request_cls, params, cfg):
    eng = engine_cls(params, cfg, n_slots=2, max_seq=32)
    reqs = [request_cls(rid=i, prompt=[3 + i, 7, 11, 2 * i + 1][:3 + i % 2],
                        max_new_tokens=5) for i in range(5)]
    for r in reqs[:3]:
        eng.submit(r)
    steps = 0
    while (eng.pending or any(eng.slots)) and steps < 200:
        eng.step()
        steps += 1
        if steps == 4:                        # arrivals mid-flight
            eng.submit(reqs[3])
            eng.submit(reqs[4])
    return reqs, steps


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_engine_matches_jax(arch):
    """The same requests, arrivals and slots: the same tokens and steps
    (slot reuse zeroes a slot of either cache kind)."""
    jcfg, cfg = _cfgs(arch, dtype="float32")
    jp, p = _params(jcfg, cfg)
    want, j_steps = _drive(JServingEngine, JRequest, jp, jcfg)
    got, steps = _drive(ServingEngine, Request, p, cfg)
    assert steps == j_steps
    assert all(r.done and len(r.generated) == 5 for r in got)
    assert [r.generated for r in got] == [r.generated for r in want]


def test_serving_engine_slot_reset_zeroes_the_mla_cache_pair():
    """An admission zeroes its slot's c and k_rope in every layer and its
    position, and leaves the other slot's cache as it was."""
    cfg = dataclasses.replace(get_config("deepseek_v2_lite_16b",
                                         reduced=True), dtype="float32")
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = ServingEngine(p, cfg, n_slots=2, max_seq=16)
    eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=2))
    eng.submit(Request(rid=1, prompt=[4, 5, 6, 7], max_new_tokens=8))
    for _ in range(3):
        eng.step()
    assert all(bool(c[i].abs().sum() > 0) for pair in eng.state["caches"]
               for c in pair for i in range(2))
    other = [tuple(c[1].clone() for c in pair)
             for pair in eng.state["caches"]]
    eng._reset_slot_state(0)
    for pair, kept in zip(eng.state["caches"], other):
        c, k_rope = pair
        assert c.shape[-1] == cfg.kv_lora_rank
        assert k_rope.shape[-1] == cfg.qk_rope_head_dim
        assert not bool(c[0].any()) and not bool(k_rope[0].any())
        assert torch.equal(c[1], kept[0]) and torch.equal(k_rope[1], kept[1])
    assert int(eng.state["pos"][0]) == 0 and int(eng.state["pos"][1]) == 3


@pytest.mark.parametrize("impl", ["dense", "capacity"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, impl):
    """loss_fn's value and the gradient of every leaf (router, stacked
    experts, shared experts, dense residual, MLA's projections and
    kv_norm) against jax.value_and_grad, f32; a leaf JAX leaves at zero
    (an expert no token reached) is zero here too."""
    jcfg, cfg = _cfgs(arch, dtype="float32", moe_impl=impl)
    jp, p = _params(jcfg, cfg)
    jb = JTokenPipeline(jcfg.vocab_size, 32, 2, seed=1).batch(0)
    b = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    j_loss, j_grads = jax.value_and_grad(j_loss_fn)(jp, jcfg, jb)
    want = leaves(convert.lm_params(_np(j_grads), cfg, device="cpu"))
    loss, grads = loss_and_grads(p, cfg, b)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    paths = [path for path, _ in leaves_with_paths(p)]
    assert len(grads) == len(want) == len(paths)
    for path, g, w in zip(paths, grads, want):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=str(path))
    moe_paths = [i for i, path in enumerate(paths) if "moe" in path]
    assert any("router" in paths[i] and bool(grads[i].abs().max() > 0)
               for i in moe_paths)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_match_jax(arch):
    """Random init from a torch.Generator and the meta-tensor tree: the
    JAX layout layer by layer (experts (E, d, f) per layer), f32; the
    count is param_count plus the norm scales."""
    jcfg, cfg = _cfgs(arch)
    _, carried = _params(jcfg, cfg)
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        assert tree.dtype == torch.float32
        return tuple(tree.shape)

    assert shapes(p) == shapes(carried) == shapes(abstract_params(cfg))
    moe = p["blocks"][0]["moe"]
    assert moe["wi_gate"].shape == (cfg.n_experts, cfg.d_model, cfg.moe_ff)
    n_norm = cfg.n_layers * 2 * cfg.d_model + cfg.d_model
    if cfg.attn_type == "mla":
        n_norm += cfg.n_layers * cfg.kv_lora_rank
    assert sum(t.numel() for t in leaves(p)) == cfg.param_count() + n_norm


@pytest.mark.parametrize("arch", ARCHS)
def test_new_leaves_decay_as_jax_stacked_tree(arch):
    """AdamW's decay rule on the MoE / MLA leaves: every leaf under blocks
    (router, experts, shared and residual MLPs, MLA's projections and
    kv_norm) is decayed, as the JAX package's layer-stacked ndim >= 2
    rule decays them, and final_norm is not; a zero-gradient update is
    decay alone and equals JAX's."""
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.optim import adamw_init as j_adamw_init
    from repro.optim import adamw_update as j_adamw_update
    jcfg, cfg = _cfgs(arch, dtype="float32")
    jp, p = _params(jcfg, cfg)
    for path, t in leaves_with_paths(p):
        assert decayed(path, t) == (path[0] != "final_norm"), path
    acfg = AdamWConfig(lr=0.5, warmup_steps=0, total_steps=10)
    p, _, _ = adamw_update(acfg, p, map_tree(torch.zeros_like, p),
                           adamw_init(p))
    jp, _, _ = j_adamw_update(JAdamWConfig(lr=0.5, warmup_steps=0,
                                           total_steps=10), jp,
                              jax.tree.map(jnp.zeros_like, jp),
                              j_adamw_init(jp))
    want = convert.lm_params(_np(jp), cfg, device="cpu")
    for (path, a), b in zip(leaves_with_paths(p), leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=str(path))


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "arctic-480b"])
def test_serve_cli_on_cpu(arch, capsys):
    serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "4", "--new-tokens",
                    "3"])
    out = capsys.readouterr().out
    assert "ok" in out.splitlines()[-1] and "req1" in out


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "arctic-480b"])
def test_train_cli_on_cpu_loss_decreases(arch):
    losses = train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--steps", "12", "--batch", "4", "--seq",
                             "32"])
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
