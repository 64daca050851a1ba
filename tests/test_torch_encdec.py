"""The port's encoder-decoder stack (Whisper-tiny: the encoder, the
decoder's cross-attention, ``prefill_cross_kv`` and the decode state's
``cross_kv``) against the JAX package at reduced widths: cross-attention
forward and decode, the encoder, the whole model in f32 and bf16, the
loss and every gradient leaf, decode against JAX and against the
prefill, the engine against the JAX engine with slots reused, AdamW's
decay of the new leaves, the slot reset of ``cross_kv``, flash through
the plain versions against JAX's interpret-mode flash, and both
packages refusing flash at the published 1500 frames.  The same JAX
params carried across by ``convert.lm_params``, the same numpy tokens
and frames.

Bounds: f32 logits 1e-5 (this stack's bound; ~5e-7
measured at these widths), every other f32 output 1e-4 as
tests/test_torch_lm.py holds the dense LM, every gradient leaf 1e-4 of
max(1, the leaf's largest entry); bf16 logits 5e-2, the JAX model
tests' own bound; greedy and serving tokens equal in f32.  The JAX
functions are jitted once for the module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_procs as tdm

from repro.configs import get_config as j_get_config
from repro.models import abstract_params as j_abstract_params
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_decode_state as j_init_decode_state
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.models import prefill_cross_kv as j_prefill_cross_kv
from repro.models.attention import gqa_decode as j_gqa_decode
from repro.models.attention import gqa_forward as j_gqa_forward
from repro.models.lm import encoder_forward as j_encoder_forward
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.train.serving import Request as JRequest
from repro.train.serving import ServingEngine as JServingEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import (abstract_params, decode_step,
                                encoder_forward, forward, init_decode_state,
                                init_params, prefill_cross_kv)
from repro_torch.models.attention import gqa_decode, gqa_forward
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import decayed
from repro_torch.train import (Request, ServingEngine, greedy_generate,
                               loss_and_grads)
from repro_torch.tree import leaves, leaves_with_paths, map_tree

ARCH = "whisper_tiny"
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
B, S = 2, 16

J_FWD = jax.jit(j_forward, static_argnums=(1,))
J_DEC = jax.jit(j_decode_step, static_argnums=(1,))
J_LOSS_GRAD = jax.jit(jax.value_and_grad(j_loss_fn), static_argnums=(1,))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' tensors are small: one intra-op thread is
    faster than many, and keeps this file from oversubscribing the cores
    that parallel test workers share; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return (dataclasses.replace(j_get_config(ARCH, reduced=True), **kw),
            dataclasses.replace(get_config(ARCH, reduced=True), **kw))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _params(jcfg, cfg, seed=0):
    jp = j_init_params(jax.random.key(seed), jcfg)
    return jp, convert.lm_params(_np(jp), cfg, device="cpu")


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _frames(cfg, batch=B, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=str(what))


def _close_leaf(got, want, tol, what=""):
    """max |got - want| within ``tol`` of max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    assert tree.dtype == torch.float32
    return tuple(tree.shape)


# ------------------------------------------------------------ params -----

def test_abstract_params_match_jax():
    """The full-size meta tree: the leaf count of JAX's abstract_params,
    each decoder block (cross-attention and layernorm biases included)
    and each encoder block JAX's stacked leaf without its layer axis;
    at the reduced size init_params has the carried JAX tree's
    layout."""
    jfull, full = j_get_config(ARCH), get_config(ARCH)
    jabs = j_abstract_params(jfull)
    tabs = abstract_params(full)
    want_n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(jabs))
    assert sum(t.numel() for t in leaves(tabs)) == want_n == 41_166_720
    stacked = jax.tree.map(lambda s: tuple(s.shape[1:]), jabs["blocks"][0])
    assert all(_shapes(b) == stacked for b in tabs["blocks"])
    enc = jax.tree.map(lambda s: tuple(s.shape[1:]),
                       jabs["encoder"]["blocks"])
    assert len(tabs["encoder"]["blocks"]) == full.encoder_layers
    assert all(_shapes(b) == enc for b in tabs["encoder"]["blocks"])
    assert "cross" in stacked and "cross" not in enc
    jcfg, cfg = _cfgs()
    _, carried = _params(jcfg, cfg)
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert _shapes(p) == _shapes(carried) == _shapes(abstract_params(cfg))
    assert set(p["final_norm"]) == {"scale", "bias"}


# --------------------------------------------------- cross-attention -----

def test_cross_attention_forward_and_decode_match_jax():
    """gqa_forward(kv_x=) over encoder states (no rotation, no mask) and
    gqa_decode(cross_kv=) (the self cache passed through untouched)
    against JAX, f32."""
    jcfg, cfg = _cfgs(dtype="float32")
    jp, p = _params(jcfg, cfg)
    jc, c = jp["blocks"][0]["cross"], p["blocks"][0]["cross"]
    jc = jax.tree.map(lambda a: a[0], jc)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 24, cfg.d_model)).astype(np.float32)
    want = j_gqa_forward(jc, jcfg, jnp.asarray(x), None,
                         kv_x=jnp.asarray(enc))
    got = gqa_forward(c, cfg, torch.from_numpy(x), None,
                      kv_x=torch.from_numpy(enc))
    _close(got.numpy(), want, 1e-4)
    kv = rng.standard_normal((2, B, 24, cfg.n_kv_heads,
                              cfg.head_dim)).astype(np.float32)
    cache = tuple(np.ones((B, 8, cfg.n_kv_heads, cfg.head_dim), np.float32)
                  for _ in range(2))
    pos = np.array([3, 5])
    jo, jcache = j_gqa_decode(jc, jcfg, jnp.asarray(x[:, :1]),
                              tuple(map(jnp.asarray, cache)),
                              jnp.asarray(pos),
                              cross_kv=tuple(map(jnp.asarray, kv)))
    tcache = tuple(map(torch.from_numpy, cache))
    o, new = gqa_decode(c, cfg, torch.from_numpy(x[:, :1]), tcache,
                        torch.from_numpy(pos),
                        cross_kv=tuple(map(torch.from_numpy, kv)))
    _close(o.numpy(), jo, 1e-4)
    assert all(a is b for a, b in zip(new, tcache))


def test_encoder_and_prefill_cross_kv_match_jax():
    """encoder_forward (causal RoPE dense blocks over the frames, then its
    final layernorm) and prefill_cross_kv (one (k, v) pair a decoder
    layer) against JAX, f32."""
    jcfg, cfg = _cfgs(dtype="float32")
    jp, p = _params(jcfg, cfg)
    a = _frames(cfg)
    _close(encoder_forward(p, cfg, torch.from_numpy(a)).numpy(),
           j_encoder_forward(jp, jcfg, jnp.asarray(a)), 1e-4)
    jk, jv = j_prefill_cross_kv(jp, jcfg, jnp.asarray(a))
    kv = prefill_cross_kv(p, cfg, torch.from_numpy(a))
    assert len(kv) == cfg.n_layers
    for i, (k, v) in enumerate(kv):
        assert k.shape == (B, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
        _close(k.numpy(), jk[i], 1e-4, ("k", i))
        _close(v.numpy(), jv[i], 1e-4, ("v", i))
    with pytest.raises(ValueError, match="audio_embed"):
        encoder_forward(p, cfg, None)


# ------------------------------------------------------------ forward ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype):
    jcfg, cfg = _cfgs(dtype=dtype)
    jp, p = _params(jcfg, cfg)
    toks, a = _tokens(cfg, (B, S)), _frames(cfg)
    want = J_FWD(jp, jcfg, jnp.asarray(toks, jnp.int32),
                 audio_embed=jnp.asarray(a))
    got = forward(p, cfg, torch.from_numpy(toks),
                  audio_embed=torch.from_numpy(a))
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == torch.float32
    _close(got.numpy(), want, TOL[dtype])


def test_loss_and_every_gradient_match_jax():
    """loss_fn and the gradient of every leaf (the encoder's, the cross
    attention's, the layernorm biases', the tied embedding's) against
    jax.value_and_grad, f32, with remat as the config has it; the
    frames get no gradient (they are data)."""
    jcfg, cfg = _cfgs(dtype="float32")
    jp, p = _params(jcfg, cfg)
    toks = _tokens(cfg, (B, S + 1), seed=4)
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "labels": jnp.asarray(toks[:, 1:], jnp.int32),
          "audio_embed": jnp.asarray(_frames(cfg, seed=5))}
    b = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    j_loss, j_grads = J_LOSS_GRAD(jp, jcfg, jb)
    want = leaves(convert.lm_params(_np(j_grads), cfg, device="cpu"))
    loss, grads = loss_and_grads(p, cfg, b)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    paths = [path for path, _ in leaves_with_paths(p)]
    assert len(grads) == len(want) == len(paths)
    for path, g, w in zip(paths, grads, want):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        _close_leaf(g.numpy(), w.numpy(), 1e-4, path)
    names = {"/".join(map(str, path)) for path in paths}
    assert {"encoder/blocks/0/attn/wq", "blocks/1/cross/wk",
            "blocks/0/norm_x/bias", "encoder/final_norm/bias"} <= names


# ------------------------------------------------------------- decode ----

def test_decode_with_cross_kv_matches_jax_and_the_prefill():
    """init_decode_state(with_encoder=True) holds one zero (k, v) pair a
    layer; filled by prefill_cross_kv, teacher-forced decode steps match
    JAX's, step by step, and the prefill's logits; convert.decode_state
    carries JAX's stacked cross_kv across as one pair a layer."""
    jcfg, cfg = _cfgs(dtype="float32")
    jp, p = _params(jcfg, cfg)
    toks, a = _tokens(cfg, (B, S), seed=6), _frames(cfg, seed=7)
    state = init_decode_state(cfg, B, S, device="cpu", with_encoder=True)
    assert len(state["cross_kv"]) == cfg.n_layers
    assert all(c.shape == (B, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
               and not bool(c.any()) for pair in state["cross_kv"]
               for c in pair)
    assert "cross_kv" not in init_decode_state(cfg, B, S, device="cpu")
    jstate = j_init_decode_state(jcfg, B, S, with_encoder=True)
    jstate["cross_kv"] = j_prefill_cross_kv(jp, jcfg, jnp.asarray(a))
    state["cross_kv"] = prefill_cross_kv(p, cfg, torch.from_numpy(a))
    carried = convert.decode_state(_np(jstate), cfg, device="cpu")
    for got, want in zip(carried["cross_kv"], state["cross_kv"]):
        for g, w in zip(got, want):
            _close(g.numpy(), w.numpy(), 1e-4)
    outs = []
    for t in range(S):
        tok = toks[:, t:t + 1]
        jl, jstate = J_DEC(jp, jcfg, jstate, jnp.asarray(tok, jnp.int32))
        tl, state = decode_step(p, cfg, state, torch.from_numpy(tok))
        _close(tl.numpy(), jl, 1e-4, t)
        outs.append(tl)
    for got, want in zip(state["caches"],
                         convert.decode_state(_np(jstate), cfg,
                                              device="cpu")["caches"]):
        for g, w in zip(got, want):
            _close(g.numpy(), w.numpy(), 1e-4)
    ref = forward(p, cfg, torch.from_numpy(toks),
                  audio_embed=torch.from_numpy(a))
    _close(torch.stack(outs, 1).numpy(), ref.numpy(), 1e-4)


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
    return reqs, steps, eng


def test_serving_engine_matches_jax_and_each_request_alone():
    """The same requests, arrivals and slots as the JAX engine, whose
    state carries zero cross_kv (nothing fills it: ROADMAP C): the same
    tokens and steps; each request equals it decoded alone on a state
    with zero cross_kv."""
    jcfg, cfg = _cfgs(dtype="float32")
    jp, p = _params(jcfg, cfg)
    want, j_steps, j_eng = _drive(JServingEngine, JRequest, jp, jcfg)
    got, steps, eng = _drive(ServingEngine, Request, p, cfg)
    assert "cross_kv" in eng.state and "cross_kv" in j_eng.state
    assert steps == j_steps
    assert all(r.done and len(r.generated) == 5 for r in got)
    assert [r.generated for r in got] == [r.generated for r in want]
    for r in got:
        alone, _ = greedy_generate(p, cfg, init_decode_state(
            cfg, 1, 32, device="cpu", with_encoder=True),
            torch.tensor([r.prompt]), 5)
        assert r.generated == alone[0].tolist(), r.rid


def test_serving_engine_slot_reset_zeroes_cross_kv():
    """An admission zeroes its slot's row of every cache and of every
    cross_kv pair, and leaves the other slot's as they were."""
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              dtype="float32")
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = ServingEngine(p, cfg, n_slots=2, max_seq=16)
    eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=2))
    eng.submit(Request(rid=1, prompt=[4, 5, 6, 7], max_new_tokens=8))
    for _ in range(3):
        eng.step()
    eng.state["cross_kv"] = prefill_cross_kv(
        p, cfg, torch.from_numpy(_frames(cfg, seed=8)))
    every = [c for key in ("caches", "cross_kv")
             for pair in eng.state[key] for c in pair]
    assert all(bool(c[i].abs().sum() > 0) for c in every for i in range(2))
    kept = [c[1].clone() for c in every]
    eng._reset_slot_state(0)
    every = [c for key in ("caches", "cross_kv")
             for pair in eng.state[key] for c in pair]
    for c, k in zip(every, kept):
        assert not bool(c[0].any()) and torch.equal(c[1], k)


# ----------------------------------------------------------- training ----

def test_new_leaves_decay_as_jax_stacked_tree():
    """AdamW's decay rule on every leaf against ``p.ndim >= 2`` on JAX's
    stacked tree: the decoder's and the encoder's per-layer layernorm
    scales and biases and the cross-attention (stacked: decayed), the
    encoder's final_norm and the model's ((D,): not); a zero-gradient
    update is decay alone and equals JAX's."""
    jcfg, cfg = _cfgs(dtype="float32")
    jp, p = _params(jcfg, cfg)
    jflags = {}

    def flag(path, leaf):
        key = tuple(getattr(k, "key", getattr(k, "idx", None))
                    for k in path)
        jflags[key] = leaf.ndim >= 2

    jax.tree_util.tree_map_with_path(flag, jp)
    for path, t in leaves_with_paths(p):
        if path[0] == "blocks":          # JAX: ("blocks", 0, ...) stacked
            key = ("blocks", 0) + tuple(path[2:])
        elif path[:2] == ("encoder", "blocks"):
            key = ("encoder", "blocks") + tuple(path[3:])
        else:
            key = tuple(path)
        assert decayed(path, t) == jflags[key], path
    assert not decayed(("encoder", "final_norm", "bias"),
                       p["encoder"]["final_norm"]["bias"])
    assert decayed(("encoder", "blocks", 1, "norm1", "bias"),
                   p["encoder"]["blocks"][1]["norm1"]["bias"])
    acfg = AdamWConfig(lr=0.5, warmup_steps=0, total_steps=10)
    p, _, _ = adamw_update(acfg, p, map_tree(torch.zeros_like, p),
                           adamw_init(p))
    jacfg = JAdamWConfig(lr=0.5, warmup_steps=0, total_steps=10)
    jp, _, _ = jax.jit(lambda p, g, o: j_adamw_update(jacfg, p, g, o))(
        jp, jax.tree.map(jnp.zeros_like, jp), j_adamw_init(jp))
    want = convert.lm_params(_np(jp), cfg, device="cpu")
    for (path, a), b in zip(leaves_with_paths(p), leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=str(path))


# -------------------------------------------------------------- flash ----

def test_flash_through_the_plain_versions_matches_jax_interpret_flash():
    """attn_impl="flash": the decoder's and the encoder's causal self
    attention through the flash route (its plain versions on the CPU)
    against JAX's interpret-mode Pallas flash; cross-attention plain in
    both.  f32 logits 1e-5."""
    jcfg, cfg = _cfgs(dtype="float32", attn_impl="flash")
    jp, p = _params(jcfg, cfg)
    toks, a = _tokens(cfg, (B, S), seed=9), _frames(cfg, seed=10)
    want = J_FWD(jp, jcfg, jnp.asarray(toks, jnp.int32),
                 audio_embed=jnp.asarray(a))
    got = forward(p, cfg, torch.from_numpy(toks),
                  audio_embed=torch.from_numpy(a))
    _close(got.numpy(), want, TOL["float32"])


def test_both_packages_refuse_flash_at_1500_frames():
    """The published 1500 frames are no multiple of flash's 256-row
    blocks: JAX asserts, the port raises ValueError (on the plain route
    too); neither pads."""
    kw = dict(dtype="float32", attn_impl="flash", encoder_seq=1500)
    jcfg, cfg = _cfgs(**kw)
    jp, p = _params(jcfg, cfg)
    toks, a = _tokens(cfg, (1, 8)), _frames(cfg, batch=1)
    with pytest.raises(AssertionError):
        j_forward(jp, jcfg, jnp.asarray(toks, jnp.int32),
                  audio_embed=jnp.asarray(a))
    with pytest.raises(ValueError, match="S = 1500"):
        forward(p, cfg, torch.from_numpy(toks),
                audio_embed=torch.from_numpy(a))


# ----------------------------------------------------------- sharding ----

def test_convert_shards_raise_naming_a11f():
    """Once these raised naming ROADMAP A11f: on every rank of a (2, 2)
    mesh ``convert.lm_shards`` cuts each leaf by its spec and
    ``convert.decode_state_shards`` of a JAX decode state (random and ``cross_kv``)
    is, leaf for leaf, ``init_decode_state(rules=)``'s chunks with the
    state's values."""
    jcfg, cfg = _cfgs()
    jp = _np(j_init_params(jax.random.key(0), jcfg))
    rng = np.random.default_rng(0)
    jstate = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), _np(j_init_decode_state(jcfg, 2, 8, with_encoder=True)))
    jstate["pos"] = np.asarray([3, 5], np.int32)
    tdm.check_convert_shards(jp, jstate, cfg)
