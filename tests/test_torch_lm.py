"""The port's LM (``repro_torch.models``, ``repro_torch.train``) against
the JAX package's on reduced Qwen3-1.7B and Yi-6B: the same JAX params
carried across by ``convert.lm_params``, the same numpy tokens.

Bounds: f32 logits 1e-4 (the two packages sum the same f32 products in
another order, ~1e-6 measured at these widths); bf16 logits 5e-2, the
JAX model tests' own bound (tests/test_flash_attention.py,
tests/test_models_smoke.py); greedy tokens and serving tokens equal in
f32.  The other families are held to JAX in files of their own: the MoE
family, DeepSeek-V2-Lite and Arctic, in tests/test_torch_moe*.py
(sharded: tests/test_torch_dist_moe.py, and sharded decode
tests/test_torch_dist_decode.py); the SSM family, Falcon-Mamba and
Zamba2 with its shared attention block, in tests/test_torch_mamba*.py;
Whisper's encoder-decoder stack in tests/test_torch_encdec.py and
Qwen2-VL's M-RoPE in tests/test_torch_mrope.py (every config through
every entry point: tests/test_torch_encdec_cli.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
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
from repro_torch.launch import serve
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_params)
from repro_torch.train import Request, ServingEngine, greedy_generate

ARCHS_RUN = ["qwen3_1p7b", "yi_6b"]


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_get_config(arch, reduced=True), **kw),
            dataclasses.replace(get_config(arch, reduced=True), **kw))


def _params(jcfg, cfg, seed=0):
    jp = j_init_params(jax.random.key(seed), jcfg)
    return jp, convert.lm_params(jax.tree.map(np.asarray, jp), cfg,
                                 device="cpu")


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_configs_match_the_jax_package(arch):
    """The ten architecture files carry the JAX package's numbers, full
    and reduced, and the same analytic parameter count."""
    for reduced in (False, True):
        j, t = j_get_config(arch, reduced), get_config(arch, reduced)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count() == t.param_count()
        assert j.active_param_count() == t.active_param_count()


@pytest.mark.parametrize("arch", ARCHS_RUN)
@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_forward_f32_matches_jax(arch, impl):
    jcfg, cfg = _cfgs(arch, dtype="float32", attn_impl=impl)
    jp, p = _params(jcfg, cfg)
    toks = _tokens(cfg, (2, 32))
    want = j_forward(jp, jcfg, jnp.asarray(toks, jnp.int32))
    got = forward(p, cfg, torch.from_numpy(toks))
    assert got.shape == (2, 32, cfg.vocab_size) and got.dtype == torch.float32
    _close(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("arch", ARCHS_RUN)
@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_forward_bf16_matches_jax(arch, impl):
    jcfg, cfg = _cfgs(arch, attn_impl=impl)
    jp, p = _params(jcfg, cfg)
    toks = _tokens(cfg, (2, 32))
    want = j_forward(jp, jcfg, jnp.asarray(toks, jnp.int32))
    got = forward(p, cfg, torch.from_numpy(toks))
    _close(got.numpy(), want, 5e-2)


@pytest.mark.parametrize("arch", ARCHS_RUN)
def test_decode_steps_and_caches_match_jax(arch):
    """Teacher-forced decode from the same zero state: each step's logits,
    the final caches and positions."""
    jcfg, cfg = _cfgs(arch, dtype="float32")
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
    for (k, v), (wk, wv) in zip(state["caches"], want["caches"]):
        _close(k.numpy(), wk.numpy(), 1e-4)
        _close(v.numpy(), wv.numpy(), 1e-4)


@pytest.mark.parametrize("arch", ARCHS_RUN)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-2)])
def test_decode_matches_prefill(arch, dtype, tol):
    """The port's form of tests/test_models_smoke.py::
    test_decode_matches_prefill: teacher-forced decode logits equal the
    flash prefill's, position by position."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype,
                              attn_impl="flash")
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(cfg, (B, S), seed=3))
    ref = forward(p, cfg, toks)
    state = init_decode_state(cfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        logits, state = decode_step(p, cfg, state, toks[:, t:t + 1])
        outs.append(logits)
    _close(torch.stack(outs, 1).numpy(), ref.numpy(), tol)


def test_greedy_generate_matches_jax():
    jcfg, cfg = _cfgs("qwen3_1p7b", dtype="float32")
    jp, p = _params(jcfg, cfg)
    prompt = _tokens(cfg, (2, 5), seed=4)
    want, _ = j_greedy_generate(jp, jcfg, j_init_decode_state(jcfg, 2, 32),
                                jnp.asarray(prompt, jnp.int32), 6)
    got, state = greedy_generate(p, cfg, init_decode_state(cfg, 2, 32,
                                                           device="cpu"),
                                 torch.from_numpy(prompt), 6)
    assert got.tolist() == np.asarray(want).tolist()
    assert state["pos"].tolist() == [10, 10]


def test_temperature_sampling_needs_a_generator():
    cfg = get_config("qwen3_1p7b", reduced=True)
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompt = torch.tensor([[1, 2, 3]])
    with pytest.raises(ValueError, match="Generator"):
        greedy_generate(p, cfg, init_decode_state(cfg, 1, 16, device="cpu"),
                        prompt, 4, temperature=1.0)
    outs = [greedy_generate(p, cfg, init_decode_state(cfg, 1, 16,
                                                      device="cpu"),
                            prompt, 4, temperature=1.0,
                            generator=torch.Generator().manual_seed(5))[0]
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])        # the generator decides
    assert bool(((outs[0] >= 0) & (outs[0] < cfg.vocab_size)).all())


def _drive(engine_cls, request_cls, params, cfg, n_slots, late):
    eng = engine_cls(params, cfg, n_slots=n_slots, max_seq=32)
    reqs = [request_cls(rid=i, prompt=[3 + i, 7, 11, 2 * i + 1][:3 + i % 2],
                        max_new_tokens=5) for i in range(5)]
    for r in reqs[:3]:
        eng.submit(r)
    steps = 0
    while (eng.pending or any(eng.slots)) and steps < 200:
        eng.step()
        steps += 1
        if steps == late:                     # arrivals mid-flight
            eng.submit(reqs[3])
            eng.submit(reqs[4])
    return reqs, steps


def test_serving_engine_matches_jax():
    """The same requests, arrivals and slots: the same tokens, the same
    number of steps (slot admission, prompt cursor and retirement)."""
    jcfg, cfg = _cfgs("qwen3_1p7b", dtype="float32")
    jp, p = _params(jcfg, cfg)
    want, j_steps = _drive(JServingEngine, JRequest, jp, jcfg, 2, 4)
    got, steps = _drive(ServingEngine, Request, p, cfg, 2, 4)
    assert steps == j_steps
    assert all(r.done and len(r.generated) == 5 for r in got)
    assert [r.generated for r in got] == [r.generated for r in want]


def test_serving_engine_matches_isolated_greedy():
    """Slot isolation and slot reuse: a request through a busy engine
    equals the same request decoded alone."""
    cfg = dataclasses.replace(get_config("qwen3_1p7b", reduced=True),
                              dtype="float32")
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompt = [5, 9, 2, 14]
    ref, _ = greedy_generate(p, cfg, init_decode_state(cfg, 1, 32,
                                                       device="cpu"),
                             torch.tensor([prompt]), 6)
    eng = ServingEngine(p, cfg, n_slots=2, max_seq=32)
    eng.submit(Request(rid=0, prompt=[1, 2], max_new_tokens=3))
    eng.submit(Request(rid=1, prompt=[8, 8, 8], max_new_tokens=8))
    target = Request(rid=2, prompt=prompt, max_new_tokens=6)
    eng.submit(target)                        # takes slot 0 after rid 0
    assert eng.run_until_done() < 10000
    assert target.generated == ref[0].tolist()


def test_layers_match_jax():
    """The norms, the MLP, RoPE and the embeddings of ``models.layers``
    against the JAX ``models/layers.py``, f32."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for kind in ("rmsnorm", "layernorm"):
        pj = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
        pt = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
        _close(tl.apply_norm(kind, pt, xt).numpy(),
               jl.apply_norm(kind, pj, xj), 1e-5)
    w = {n: rng.standard_normal(s).astype(np.float32) * 0.1
         for n, s in (("wi_gate", (64, 96)), ("wi_up", (64, 96)),
                      ("wo", (96, 64)))}
    _close(tl.mlp({k: torch.from_numpy(v) for k, v in w.items()}, xt,
                  torch.float32).numpy(),
           jl.mlp({k: jnp.asarray(v) for k, v in w.items()}, xj,
                  jnp.float32), 1e-5)
    h = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]])
    _close(tl.apply_rope(torch.from_numpy(h), torch.from_numpy(pos),
                         1e6).numpy(),
           jl.apply_rope(jnp.asarray(h), jnp.asarray(pos), 1e6), 1e-5)
    table = rng.standard_normal((50, 64)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 5))
    _close(tl.embed({"table": torch.from_numpy(table)},
                    torch.from_numpy(toks), torch.bfloat16).float().numpy(),
           jl.embed({"table": jnp.asarray(table)}, jnp.asarray(toks),
                    jnp.bfloat16), 0)
    _close(tl.unembed({"table": torch.from_numpy(table)}, xt,
                      torch.float32).numpy(),
           jl.unembed({"table": jnp.asarray(table)}, xj, jnp.float32), 1e-5)


@pytest.mark.parametrize("arch", ["granite_20b", "llama3_405b"])
def test_other_dense_configs_run(arch):
    """MQA (granite, kv = 1) and Llama-3's rope theta: f32 flash forward
    against JAX at the reduced widths."""
    jcfg, cfg = _cfgs(arch, dtype="float32", attn_impl="flash")
    jp, p = _params(jcfg, cfg)
    toks = _tokens(cfg, (2, 16), seed=6)
    _close(forward(p, cfg, torch.from_numpy(toks)).numpy(),
           j_forward(jp, jcfg, jnp.asarray(toks, jnp.int32)), 1e-4)


def test_init_params_shapes_match_jax():
    """Random init from a torch.Generator: the JAX layout, layer by layer,
    f32, on the requested device; the generator must live there."""
    jcfg, cfg = _cfgs("qwen3_1p7b")
    _, carried = _params(jcfg, cfg)
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        assert tree.dtype == torch.float32
        return tuple(tree.shape)

    assert shapes(p) == shapes(carried)
    if not torch.cuda.is_available():               # defaults to the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_params(torch.Generator(), cfg)


def test_serve_cli_on_cpu(capsys):
    serve.main(["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "4", "--new-tokens", "3",
                "--attn-impl", "flash"])
    out = capsys.readouterr().out
    assert "ok" in out.splitlines()[-1]
    assert "prefill" in out and "req1" in out
