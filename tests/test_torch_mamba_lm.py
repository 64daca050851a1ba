"""The port's SSM family (``repro_torch.models`` with ``models.mamba``)
against the JAX package on reduced Falcon-Mamba-7B (pure Mamba-1) and
Zamba2-1.2B (Mamba-2 with the shared attention block, in both
``ssm_impl``s), trained: the params tree, the forward, the loss and
every gradient leaf, AdamW's decay rule on the new leaves, two training
steps; the sharded entry points raising.  The same JAX params carried
across by ``convert.lm_params``, the same numpy tokens and JAX batches.
Decode and serving are in tests/test_torch_mamba_decode.py.

Bounds, as tests/test_torch_lm.py and tests/test_torch_train.py hold
the dense LM: f32 logits and loss 1e-4, every gradient leaf 1e-4 of
max(1, the leaf's largest entry) (an entry of a shared or embedding
leaf is a sum over every position and application); bf16 logits 5e-2;
two train steps as tests/test_torch_train.py holds three.  The JAX
forward and loss gradient are jitted once for the module (the scans
compile slowly) and reused across the cases.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_procs as tdm

from repro.configs import get_config as j_get_config
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.models import abstract_params as j_abstract_params
from repro.models import forward as j_forward
from repro.models import init_decode_state as j_init_decode_state
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import abstract_params, forward, init_params
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import decayed
from repro_torch.train import TrainConfig, loss_and_grads, make_train_step
from repro_torch.tree import leaves, leaves_with_paths, map_tree


CASES = [("falcon_mamba_7b", "scan"), ("zamba2_1p2b", "ssd"),
         ("zamba2_1p2b", "scan")]
IDS = ["falcon", "zamba2-ssd", "zamba2-scan"]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


J_FWD = jax.jit(j_forward, static_argnums=(1,))
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

@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_1p2b"])
def test_abstract_params_match_jax(arch):
    """The full-size meta tree against JAX's abstract_params, leaf by leaf
    (each stacked JAX leaf is n_periods of the port's layer leaves; the
    shared block is one block on both sides), and the leaf count; at
    the reduced size init_params has the carried JAX tree's layout."""
    jfull, full = j_get_config(arch), get_config(arch)
    jabs = j_abstract_params(jfull)
    tabs = abstract_params(full)
    want_n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(jabs))
    assert sum(t.numel() for t in leaves(tabs)) == want_n
    assert want_n == {"falcon_mamba_7b": 7_005_802_496,
                      "zamba2_1p2b": 1_170_313_344}[arch]
    assert want_n != full.param_count()          # norms, dt_rank terms
    for i in range(len(full.pattern)):
        want = jax.tree.map(lambda s: tuple(s.shape[1:]), jabs["blocks"][i])
        for period in range(full.n_periods):
            assert _shapes(tabs["blocks"][period * len(full.pattern) + i]
                           ) == want, (i, period)
    for key in set(jabs) - {"blocks"}:
        assert _shapes(tabs[key]) == jax.tree.map(
            lambda s: tuple(s.shape), jabs[key]), key
    jcfg, cfg = _cfgs(arch)
    _, carried = _params(jcfg, cfg)
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert _shapes(p) == _shapes(carried) == _shapes(abstract_params(cfg))
    assert ("shared_attn" in p) == bool(cfg.shared_attn_every)


# ----------------------------------------------------------- forward -----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,impl", CASES, ids=IDS)
def test_forward_matches_jax(arch, impl, dtype):
    jcfg, cfg = _cfgs(arch, dtype=dtype, ssm_impl=impl)
    jp, p = _params(jcfg, cfg)
    toks = _tokens(cfg, (2, 100))                # past one 64-step chunk
    want = J_FWD(jp, jcfg, jnp.asarray(toks, jnp.int32))
    got = forward(p, cfg, torch.from_numpy(toks))
    assert got.shape == (2, 100, cfg.vocab_size) and got.dtype == torch.float32
    _close(got.numpy(), want, TOL[dtype])


@pytest.mark.parametrize("arch,impl", CASES, ids=IDS)
def test_loss_and_every_gradient_match_jax(arch, impl):
    """loss_fn and the gradient of every leaf (the Mamba leaves, the
    shared block's, summed over its applications, the embedding) against
    jax.value_and_grad, f32, with remat as the config has it."""
    jcfg, cfg = _cfgs(arch, dtype="float32", ssm_impl=impl)
    jp, p = _params(jcfg, cfg)
    jb = JTokenPipeline(jcfg.vocab_size, 80, 2, seed=1).batch(0)
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
    assert any("mamba/A_log" in n for n in names)
    if cfg.shared_attn_every:
        assert "shared_attn/attn/wq" in names


def test_remat_gives_the_same_gradients_as_none():
    """Checkpointing every layer and every application of the shared
    block changes no gradient."""
    cfg = dataclasses.replace(get_config("zamba2_1p2b", reduced=True),
                              dtype="float32")
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (2, 24), seed=2))
    b = {"tokens": toks, "labels": toks.roll(-1, 1)}
    _, g_full = loss_and_grads(p, dataclasses.replace(cfg, remat="full"), b)
    _, g_none = loss_and_grads(p, dataclasses.replace(cfg, remat="none"), b)
    for a, c in zip(g_full, g_none):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


# ---------------------------------------------------------- training -----

@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_1p2b"])
def test_new_leaves_decay_as_jax_stacked_tree(arch):
    """AdamW's decay rule: every leaf under blocks (the Mamba dt_bias, D,
    A_log and norm_scale included, 2-D in JAX's stacked tree) is decayed;
    the shared block's norm scales (1-D in JAX: not stacked) and
    final_norm are not, its weight matrices are; a zero-gradient update
    is decay alone and equals JAX's."""
    jcfg, cfg = _cfgs(arch, dtype="float32")
    jp, p = _params(jcfg, cfg)
    for path, t in leaves_with_paths(p):
        want = path[0] == "blocks" or t.ndim >= 2
        assert decayed(path, t) == want, path
        if path[0] == "shared_attn":
            assert decayed(path, t) == (path[-1] != "scale"), path
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


@pytest.mark.parametrize("arch,nm", [("falcon_mamba_7b", 1),
                                     ("zamba2_1p2b", 2)])
def test_two_train_steps_match_jax(arch, nm):
    """make_train_step against the JAX make_train_step on the same JAX
    batches and params, f32, with remat: loss, grad_norm and lr 1e-5
    relative; params within 2 sum(lr) and all but 1e-3 of the entries
    within 1e-6 (tests/test_torch_train.py's bounds)."""
    jcfg, cfg = _cfgs(arch, dtype="float32", remat="full")
    jp, p = _params(jcfg, cfg)
    jacfg = JAdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    acfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jo, o = j_adamw_init(jp), adamw_init(p)
    j_step = j_make_train_step(jcfg, jacfg, JTrainConfig(microbatches=nm))
    step = make_train_step(cfg, acfg, TrainConfig(microbatches=nm))
    pipe = JTokenPipeline(jcfg.vocab_size, 32, 4, seed=0)
    lrs = 0.0
    for s in range(2):
        jb = pipe.batch(s)
        jp, jo, jm = j_step(jp, jo, jb)
        jp = jax.tree.map(np.array, jp)          # JAX donates its inputs
        jo = jax.tree.map(np.array, jo)
        p, o, m = step(p, o, {k: torch.from_numpy(np.array(v))
                              for k, v in jb.items()})
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

@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_1p2b"])
def test_convert_shards_raise_naming_a11e(arch):
    """Once these raised naming ROADMAP A11e: on every rank of a (2, 2)
    mesh ``convert.lm_shards`` cuts each leaf by its spec and
    ``convert.decode_state_shards`` of a JAX decode state (random, the
    shared block's ``shared_cache`` included) is, leaf for leaf,
    ``init_decode_state(rules=)``'s chunks with the state's values."""
    jcfg, cfg = _cfgs(arch)
    jp = _np(j_init_params(jax.random.key(0), jcfg))
    rng = np.random.default_rng(0)
    jstate = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), _np(j_init_decode_state(jcfg, 2, 8)))
    jstate["pos"] = np.asarray([3, 5], np.int32)
    tdm.check_convert_shards(jp, jstate, cfg)
