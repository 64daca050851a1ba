"""The port's M-RoPE (Qwen2-VL: ``layers.apply_mrope``, the (3, B, S)
position streams through ``forward``, ``loss_fn``, ``decode_step`` and
the microbatched train step) against the JAX package at reduced widths,
with three distinct streams laid out as the vision frontend lays them
out: a text prefix (t = h = w), a patch grid (t constant, h its row, w
its column) and text resuming past the largest position.  The same JAX
params carried across by ``convert.lm_params``, the same numpy tokens
and positions.

Bounds as tests/test_torch_lm.py and tests/test_torch_train.py hold the
dense LM: apply_mrope and f32 logits 1e-5 (~1e-6 measured), decode
logits 1e-4, the loss and every gradient leaf 1e-4 (of max(1, the
leaf's largest entry)), bf16 logits 5e-2; two train steps as
tests/test_torch_mamba_lm.py holds them.  The JAX functions are jitted
once for the module.
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
from repro.models.layers import apply_mrope as j_apply_mrope
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import (abstract_params, decode_step, forward,
                                init_decode_state)
from repro_torch.models.layers import apply_mrope
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import TrainConfig, loss_and_grads, make_train_step
from repro_torch.train.train_step import _microbatches
from repro_torch.tree import leaves, leaves_with_paths

ARCH = "qwen2_vl_72b"
TOL = {"float32": 1e-5, "bfloat16": 5e-2}

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


def vision_positions(B, S, prefix=4, grid=3):
    """(3, B, S) int64 streams: ``prefix`` text tokens (t = h = w = i), a
    ``grid`` x ``grid`` patch grid (t at the prefix, h its row and w its
    column, both from the prefix), then text from the largest position
    + 1; row b starts b later."""
    t, h, w = [], [], []
    for i in range(prefix):
        t.append(i), h.append(i), w.append(i)
    for r in range(grid):
        for c in range(grid):
            t.append(prefix), h.append(prefix + r), w.append(prefix + c)
    nxt = max(t + h + w) + 1
    while len(t) < S:
        t.append(nxt), h.append(nxt), w.append(nxt)
        nxt += 1
    one = np.array([t[:S], h[:S], w[:S]], np.int64)
    return np.stack([one + b for b in range(B)], axis=1)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=str(what))


def _close_leaf(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


# ------------------------------------------------------------- layers ----

@pytest.mark.parametrize("hd,sections", [(32, (4, 6, 6)),
                                         (128, (16, 24, 24))])
def test_apply_mrope_matches_jax(hd, sections):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 20, 3, hd)).astype(np.float32)
    pos = vision_positions(2, 20)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                      sections)
    want = j_apply_mrope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 1e6,
                         sections)
    _close(got.numpy(), want, TOL["float32"])
    with pytest.raises(ValueError, match="sections"):
        apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                    (4, 4, 4))


def test_abstract_params_match_jax():
    """The full-size meta tree has the JAX abstract_params count (72.7 B
    at 80 layers) and every layer JAX's stacked leaf without its layer
    axis."""
    jfull, full = j_get_config(ARCH), get_config(ARCH)
    jabs = j_abstract_params(jfull)
    tabs = abstract_params(full)
    want_n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(jabs))
    assert sum(t.numel() for t in leaves(tabs)) == want_n
    stacked = jax.tree.map(lambda s: tuple(s.shape[1:]), jabs["blocks"][0])
    assert len(tabs["blocks"]) == full.n_layers
    assert jax.tree.map(lambda t: tuple(t.shape), tabs["blocks"][0]) \
        == stacked


# ------------------------------------------------------------ forward ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_distinct_streams_matches_jax(dtype):
    """Three distinct streams: the logits match JAX's and differ from the
    aligned streams' past the prefix (M-RoPE acts), and equal them on
    the text prefix, where the streams agree."""
    jcfg, cfg = _cfgs(dtype=dtype)
    jp, p = _params(jcfg, cfg)
    toks, pos = _tokens(cfg, (2, 24)), vision_positions(2, 24)
    want = J_FWD(jp, jcfg, jnp.asarray(toks, jnp.int32),
                 positions=jnp.asarray(pos, jnp.int32))
    got = forward(p, cfg, torch.from_numpy(toks),
                  positions=torch.from_numpy(pos))
    assert got.shape == (2, 24, cfg.vocab_size)
    _close(got.numpy(), want, TOL[dtype])
    aligned = forward(p, cfg, torch.from_numpy(toks),
                      positions=torch.from_numpy(np.broadcast_to(
                          pos[0], pos.shape).copy()))
    assert torch.equal(aligned[0, :4], got[0, :4])
    assert float((aligned[:, 5:] - got[:, 5:]).abs().max()) > 1e-2


def test_loss_and_every_gradient_match_jax():
    """loss_fn with batch["positions"] (3, B, S) and the gradient of every
    leaf against jax.value_and_grad, f32, with remat."""
    jcfg, cfg = _cfgs(dtype="float32")
    jp, p = _params(jcfg, cfg)
    toks = _tokens(cfg, (2, 25), seed=2)
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "labels": jnp.asarray(toks[:, 1:], jnp.int32),
          "positions": jnp.asarray(vision_positions(2, 24), jnp.int32)}
    b = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    j_loss, j_grads = J_LOSS_GRAD(jp, jcfg, jb)
    want = leaves(convert.lm_params(_np(j_grads), cfg, device="cpu"))
    loss, grads = loss_and_grads(p, cfg, b)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    paths = [path for path, _ in leaves_with_paths(p)]
    assert len(grads) == len(want) == len(paths)
    for path, g, w in zip(paths, grads, want):
        assert bool(torch.isfinite(g).all())
        _close_leaf(g.numpy(), w.numpy(), 1e-4, path)


# ------------------------------------------------------------- decode ----

def test_decode_matches_jax_and_the_aligned_prefill():
    """Decode rotates with (t, t, t) from ``pos``: each step matches JAX's
    decode step, and the steps match a prefill with aligned streams (the
    default positions, (3, B, S) all equal)."""
    jcfg, cfg = _cfgs(dtype="float32")
    jp, p = _params(jcfg, cfg)
    toks = _tokens(cfg, (2, 16), seed=3)
    jstate = j_init_decode_state(jcfg, 2, 16)
    state = init_decode_state(cfg, 2, 16, device="cpu")
    outs = []
    for t in range(16):
        tok = toks[:, t:t + 1]
        jl, jstate = J_DEC(jp, jcfg, jstate, jnp.asarray(tok, jnp.int32))
        tl, state = decode_step(p, cfg, state, torch.from_numpy(tok))
        _close(tl.numpy(), jl, 1e-4, t)
        outs.append(tl)
    ref = forward(p, cfg, torch.from_numpy(toks))
    pos = np.broadcast_to(np.arange(16), (3, 2, 16)).copy()
    same = forward(p, cfg, torch.from_numpy(toks),
                   positions=torch.from_numpy(pos))
    assert torch.equal(ref, same)
    _close(torch.stack(outs, 1).numpy(), ref.numpy(), 1e-4)


# ----------------------------------------------------------- training ----

def test_microbatches_split_mrope_positions_on_the_batch_axis():
    """(3, B, S) positions split on dim 1, every other entry on dim 0."""
    pos = torch.from_numpy(vision_positions(4, 8))
    toks = torch.arange(32).reshape(4, 8)
    mbs = _microbatches({"tokens": toks, "labels": toks,
                         "positions": pos}, 2)
    for i, mb in enumerate(mbs):
        assert mb["positions"].shape == (3, 2, 8)
        assert torch.equal(mb["positions"], pos[:, 2 * i:2 * i + 2])
        assert torch.equal(mb["tokens"], toks[2 * i:2 * i + 2])
    plain = _microbatches({"tokens": toks, "positions": toks}, 2)
    assert torch.equal(plain[1]["positions"], toks[2:])


def test_two_microbatch_train_steps_match_jax():
    """make_train_step with 2 microbatches on batches carrying distinct
    (3, B, S) positions against the JAX make_train_step (which splits
    them on the batch axis), f32 with remat: loss, grad_norm and lr
    1e-5 relative; params within 2 sum(lr) and all but 1e-3 of the
    entries within 1e-6."""
    jcfg, cfg = _cfgs(dtype="float32", remat="full")
    jp, p = _params(jcfg, cfg)
    jacfg = JAdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    acfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jo, o = j_adamw_init(jp), adamw_init(p)
    j_step = j_make_train_step(jcfg, jacfg, JTrainConfig(microbatches=2))
    step = make_train_step(cfg, acfg, TrainConfig(microbatches=2))
    lrs = 0.0
    for s in range(2):
        toks = _tokens(cfg, (4, 17), seed=10 + s)
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32),
                 "positions": vision_positions(4, 16).astype(np.int32)}
        jp, jo, jm = j_step(jp, jo, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        jp = jax.tree.map(np.array, jp)          # JAX donates its inputs
        jo = jax.tree.map(np.array, jo)
        p, o, m = step(p, o, {k: torch.from_numpy(v.astype(np.int64))
                              for k, v in batch.items()})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
        lrs += float(m["lr"])
    got = torch.cat([t.flatten() for t in leaves(p)])
    want = torch.cat([t.flatten() for t in leaves(
        convert.lm_params(_np(jp), cfg, device="cpu"))])
    diff = (got - want).abs()
    assert float(diff.max()) <= 2 * lrs
    assert float((diff > 1e-6).float().mean()) <= 1e-3


# ----------------------------------------------------------- sharding ----

def test_convert_shards_raise_naming_a11f():
    """Once these raised naming ROADMAP A11f: on every rank of a (2, 2)
    mesh ``convert.lm_shards`` cuts each leaf by its spec and
    ``convert.decode_state_shards`` of a JAX decode state (random)
    is, leaf for leaf, ``init_decode_state(rules=)``'s chunks with the
    state's values."""
    jcfg, cfg = _cfgs()
    jp = _np(j_init_params(jax.random.key(0), jcfg))
    rng = np.random.default_rng(0)
    jstate = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), _np(j_init_decode_state(jcfg, 2, 8)))
    jstate["pos"] = np.asarray([3, 5], np.int32)
    tdm.check_convert_shards(jp, jstate, cfg)
