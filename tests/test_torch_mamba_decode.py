"""The port's SSM family served (``models.lm.decode_step`` with the
Mamba states and the shared block's caches, ``greedy_generate``,
``ServingEngine``) against the JAX package on reduced Falcon-Mamba-7B
and Zamba2-1.2B (both ``ssm_impl``s), and the shared block alone on a
dense decoder (split from tests/test_torch_mamba_lm.py, whose docstring
gives the bounds: f32 logits and states 1e-4, bf16 5e-2, greedy and
serving tokens equal in f32).  The JAX forward and decode step are
jitted once for the module and reused across the cases.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_decode_state as j_init_decode_state
from repro.models import init_params as j_init_params
from repro.train import greedy_generate as j_greedy_generate
from repro.train.serving import Request as JRequest
from repro.train.serving import ServingEngine as JServingEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_params)
from repro_torch.train import Request, ServingEngine, greedy_generate

CASES = [("falcon_mamba_7b", "scan"), ("zamba2_1p2b", "ssd"),
         ("zamba2_1p2b", "scan")]
IDS = ["falcon", "zamba2-ssd", "zamba2-scan"]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


J_FWD = jax.jit(j_forward, static_argnums=(1,))
J_DEC = jax.jit(j_decode_step, static_argnums=(1,))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' tensors are small: one intra-op thread is
    faster than many, and keeps this file from oversubscribing the cores
    that parallel test workers share; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_get_config(arch, reduced=True), **kw),
            dataclasses.replace(get_config(arch, reduced=True), **kw))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _params(jcfg, cfg, seed=0):
    jp = j_init_params(jax.random.key(seed), jcfg)
    return jp, convert.lm_params(_np(jp), cfg, device="cpu")


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=str(what))


# ------------------------------------------------------------ decode -----

@pytest.mark.parametrize("arch,impl", CASES, ids=IDS)
def test_decode_steps_and_states_match_jax(arch, impl):
    """Teacher-forced decode from the same zero state: each step's logits
    and every state leaf after the last (conv states in the compute
    dtype, h in f32, one shared cache a period) and the positions."""
    jcfg, cfg = _cfgs(arch, dtype="float32", ssm_impl=impl)
    jp, p = _params(jcfg, cfg)
    B, S = 2, 8
    toks = _tokens(cfg, (B, S), seed=2)
    jstate = j_init_decode_state(jcfg, B, S + 2)
    state = convert.decode_state(jax.tree.map(np.asarray, jstate), cfg,
                                 device="cpu")
    for t in range(S):
        jl, jstate = J_DEC(jp, jcfg, jstate,
                           jnp.asarray(toks[:, t:t + 1], jnp.int32))
        tl, state = decode_step(p, cfg, state,
                                torch.from_numpy(toks[:, t:t + 1]))
        _close(tl.numpy(), jl, 1e-4, t)
    want = convert.decode_state(jax.tree.map(np.asarray, jstate), cfg,
                                device="cpu")
    assert torch.equal(state["pos"], want["pos"])
    assert len(state["caches"]) == cfg.n_layers
    assert set(state) == set(want)
    for key in ("caches", "shared_cache"):
        for i, (pair, wpair) in enumerate(zip(state.get(key, []),
                                              want.get(key, []))):
            for got, w in zip(pair, wpair):
                assert got.shape == w.shape and got.dtype == w.dtype
                _close(got.numpy(), w.numpy(), 1e-4, (key, i))
    conv, h = state["caches"][0]
    assert conv.shape[1] == cfg.d_conv - 1 and h.dtype == torch.float32
    if cfg.shared_attn_every:
        assert len(state["shared_cache"]) == cfg.n_periods
        assert all(bool(k.abs().sum() > 0)
                   for k, _ in state["shared_cache"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,impl", CASES, ids=IDS)
def test_decode_matches_prefill(arch, impl, dtype):
    """Teacher-forced decode logits equal the prefill's, position by
    position, past one 64-step chunk."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype,
                              ssm_impl=impl, attn_impl="flash")
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    B, S = 2, 70
    toks = torch.from_numpy(_tokens(cfg, (B, S), seed=3))
    ref = forward(p, cfg, toks)
    state = init_decode_state(cfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        logits, state = decode_step(p, cfg, state, toks[:, t:t + 1])
        outs.append(logits)
    _close(torch.stack(outs, 1).numpy(), ref.numpy(), TOL[dtype])


def test_convert_decode_state_keeps_h_in_f32():
    """A bf16 model's JAX decode state carried across: conv states and
    shared caches in bf16, every Mamba h in f32 with its JAX values."""
    jcfg, cfg = _cfgs("zamba2_1p2b")
    jp = j_init_params(jax.random.key(0), jcfg)
    jstate = j_init_decode_state(jcfg, 2, 8)
    for t in range(3):
        _, jstate = J_DEC(jp, jcfg, jstate, jnp.full((2, 1), 5 + t,
                                                     jnp.int32))
    jnp_state = jax.tree.map(np.asarray, jstate)
    state = convert.decode_state(jnp_state, cfg, device="cpu")
    for i, (conv, h) in enumerate(state["caches"]):
        assert conv.dtype == torch.bfloat16 and h.dtype == torch.float32
        want = jnp_state["caches"][i % 2][1][i // 2]
        assert want.dtype == np.float32
        np.testing.assert_array_equal(h.numpy(), want)
    assert len(state["shared_cache"]) == cfg.n_periods
    assert all(c.dtype == torch.bfloat16 for pair in state["shared_cache"]
               for c in pair)


# ----------------------------------------------------------- serving -----

@pytest.mark.parametrize("arch,impl", CASES, ids=IDS)
def test_greedy_generate_matches_jax(arch, impl):
    jcfg, cfg = _cfgs(arch, dtype="float32", ssm_impl=impl)
    jp, p = _params(jcfg, cfg)
    prompt = _tokens(cfg, (2, 5), seed=4)
    want, _ = j_greedy_generate(jp, jcfg, j_init_decode_state(jcfg, 2, 32),
                                jnp.asarray(prompt, jnp.int32), 6)
    got, state = greedy_generate(p, cfg, init_decode_state(cfg, 2, 32,
                                                           device="cpu"),
                                 torch.from_numpy(prompt), 6)
    assert got.tolist() == np.asarray(want).tolist()
    assert state["pos"].tolist() == [10, 10]


def _requests(request_cls):
    return [request_cls(rid=i, prompt=[3 + i, 7, 11, 2 * i + 1][:3 + i % 2],
                        max_new_tokens=5) for i in range(6)]


def _drive(engine_cls, request_cls, params, cfg):
    """6 requests on 2 slots, 3 at first and 3 arriving mid-flight: every
    slot is reused."""
    eng = engine_cls(params, cfg, n_slots=2, max_seq=32)
    reqs = _requests(request_cls)
    for r in reqs[:3]:
        eng.submit(r)
    steps = 0
    while (eng.pending or any(eng.slots)) and steps < 300:
        eng.step()
        steps += 1
        if steps == 4:
            for r in reqs[3:]:
                eng.submit(r)
    return reqs, steps


@pytest.mark.parametrize("arch,impl", CASES, ids=IDS)
def test_serving_engine_matches_jax_and_each_request_alone(arch, impl):
    """The same requests, arrivals and slots as the JAX engine: the same
    tokens and steps; and each request's tokens equal it decoded alone
    (a reused slot starts from a zero Mamba state and zero caches)."""
    jcfg, cfg = _cfgs(arch, dtype="float32", ssm_impl=impl)
    jp, p = _params(jcfg, cfg)
    want, j_steps = _drive(JServingEngine, JRequest, jp, jcfg)
    got, steps = _drive(ServingEngine, Request, p, cfg)
    assert steps == j_steps
    assert all(r.done and len(r.generated) == 5 for r in got)
    assert [r.generated for r in got] == [r.generated for r in want]
    for r in got:
        alone, _ = greedy_generate(p, cfg, init_decode_state(
            cfg, 1, 32, device="cpu"), torch.tensor([r.prompt]), 5)
        assert r.generated == alone[0].tolist(), r.rid


def test_serving_engine_slot_reset_zeroes_every_state_leaf():
    """An admission zeroes its slot's conv state and h in every layer and
    its row of every shared cache, and leaves the other slot's as they
    were."""
    cfg = dataclasses.replace(get_config("zamba2_1p2b", reduced=True),
                              dtype="float32")
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = ServingEngine(p, cfg, n_slots=2, max_seq=16)
    eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=2))
    eng.submit(Request(rid=1, prompt=[4, 5, 6, 7], max_new_tokens=8))
    for _ in range(3):
        eng.step()
    every = [c for key in ("caches", "shared_cache")
             for pair in eng.state[key] for c in pair]
    assert all(bool(c[i].abs().sum() > 0) for c in every for i in range(2))
    kept = [c[1].clone() for c in every]
    eng._reset_slot_state(0)
    every = [c for key in ("caches", "shared_cache")
             for pair in eng.state[key] for c in pair]
    for c, k in zip(every, kept):
        assert not bool(c[0].any()) and torch.equal(c[1], k)
    assert int(eng.state["pos"][0]) == 0 and int(eng.state["pos"][1]) == 3


# ---------------------------------------------- the shared block alone ---

def test_shared_block_on_a_dense_decoder_matches_jax():
    """Reduced Qwen3 with shared_attn_every=2 (the shared block after
    every layer, its period): the f32 forward and teacher-forced decode
    against JAX."""
    kw = dict(dtype="float32", shared_attn_every=2)
    jcfg, cfg = (dataclasses.replace(j_get_config("qwen3_1p7b", True), **kw),
                 dataclasses.replace(get_config("qwen3_1p7b", True), **kw))
    jp, p = _params(jcfg, cfg)
    toks = _tokens(cfg, (2, 12), seed=5)
    _close(forward(p, cfg, torch.from_numpy(toks)).numpy(),
           J_FWD(jp, jcfg, jnp.asarray(toks, jnp.int32)), 1e-4)
    jstate = j_init_decode_state(jcfg, 2, 12)
    state = init_decode_state(cfg, 2, 12, device="cpu")
    assert len(state["shared_cache"]) == cfg.n_periods
    for t in range(12):
        jl, jstate = J_DEC(jp, jcfg, jstate,
                           jnp.asarray(toks[:, t:t + 1], jnp.int32))
        tl, state = decode_step(p, cfg, state,
                                torch.from_numpy(toks[:, t:t + 1]))
        _close(tl.numpy(), jl, 1e-4, t)
