"""The port's MoE family served: decode steps and caches (MLA's (c,
k_rope) pair) against the JAX package, decode against prefill, greedy
generation and the continuous-batching engine on reduced DeepSeek-V2-Lite
and Arctic (split from tests/test_torch_moe.py, whose docstring gives the
bounds: f32 1e-4, bf16 5e-2)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import decode_step as j_decode_step
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


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


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
