"""The port's LM training (``models.loss_fn`` with layer remat, ``optim``,
``train.make_train_step``, ``data.tokens``, ``train.checkpoint``,
``launch.train``, ``convert.adamw_state``) against the JAX package on
reduced Qwen3-1.7B: JAX params carried across by ``convert.lm_params``,
the same JAX batches, on the CPU (the JAX flash path in interpret mode,
the port's through its plain versions behind the same autograd
Functions the card runs).

Bounds.  f32 loss and every gradient 1e-4 (the two packages sum the same
f32 products in another order: ~1e-6 relative measured).  bf16 5e-2, the
JAX model tests' bound (tests/test_flash_attention.py,
tests/test_models_smoke.py), elementwise and per leaf in relative
Frobenius norm.  AdamW on the same gradients: 1e-6 relative, f32
rounding of one update.  Three train steps: loss, grad_norm and lr 1e-5
relative; params within 2 sum(lr) of the JAX ones (the most AdamW's
sign-like early steps move an entry whose near-zero gradient rounds to
the other sign in the other package) and all but 1e-3 of the entries
within 1e-6 (measured: 8e-6 at most, 3e-5 of the entries above 1e-6).

The training CLI's own run is in tests/test_torch_train_cli.py.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim.adamw import global_norm as j_global_norm
from repro.optim.adamw import schedule as j_schedule
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import train as train_cli
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               global_norm, schedule)
from repro_torch.train import (CheckpointManager, TrainConfig, available_steps,
                               init_train_state, load_checkpoint,
                               loss_and_grads, make_defer_train_step,
                               make_train_step, save_checkpoint)
from repro_torch.tree import leaves, leaves_with_paths, map_tree

ARCH = "qwen3_1p7b"


def _cfgs(**kw):
    return (dataclasses.replace(j_get_config(ARCH, reduced=True), **kw),
            dataclasses.replace(get_config(ARCH, reduced=True), **kw))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _params(jcfg, cfg, seed=0):
    jp = j_init_params(jax.random.key(seed), jcfg)
    return jp, convert.lm_params(_np(jp), cfg, device="cpu")


def _batch(jcfg, B=2, S=32, step=0, seed=1):
    jb = JTokenPipeline(jcfg.vocab_size, S, B, seed=seed).batch(step)
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("ce", ["gather", "onehot"])
@pytest.mark.parametrize("impl", ["naive", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype, impl, ce):
    """loss_fn's value and the gradient of every parameter leaf against
    jax.value_and_grad(loss_fn), through the flash Function (plain
    backward here) or plain attention; every gradient is finite and
    non-zero."""
    jcfg, cfg = _cfgs(dtype=dtype, attn_impl=impl, ce_impl=ce)
    jp, p = _params(jcfg, cfg)
    jb, b = _batch(jcfg)
    j_loss, j_grads = jax.value_and_grad(j_loss_fn)(jp, jcfg, jb)
    want = leaves(convert.lm_params(_np(j_grads), cfg, device="cpu"))
    loss, grads = loss_and_grads(p, cfg, b)
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=tol)
    assert len(grads) == len(want)
    for (path, _), g, w in zip(leaves_with_paths(p), grads, want):
        assert g is not None and g.dtype == torch.float32, path
        assert bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0), \
            path
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=tol, atol=tol,
                                   err_msg=str(path))
        assert _rel_fro(g, w) <= tol, path


def test_remat_full_gives_the_same_gradients_as_none():
    """Recomputing each layer in the backward changes nothing: the same
    loss and bit-identical gradients."""
    _, cfg = _cfgs(dtype="float32", attn_impl="flash")
    _, p = _params(*_cfgs(dtype="float32", attn_impl="flash"))
    _, b = _batch(j_get_config(ARCH, reduced=True))
    l_full, g_full = loss_and_grads(
        p, dataclasses.replace(cfg, remat="full"), b)
    l_none, g_none = loss_and_grads(
        p, dataclasses.replace(cfg, remat="none"), b)
    assert torch.equal(l_full, l_none)
    for a, c in zip(g_full, g_none):
        assert torch.equal(a, c)


def _grads_like(params, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return map_tree(lambda a: (scale * rng.standard_normal(a.shape))
                    .astype(np.float32), params)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0],
                         ids=["unclipped", "clipped"])
def test_adamw_update_matches_jax(grad_scale):
    """Three updates with the same gradients (below and above the clip)
    from a converted tree: params, m, v, step, lr and grad_norm."""
    jcfg, cfg = _cfgs(dtype="float32")
    jp, p = _params(jcfg, cfg)
    jacfg = JAdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    acfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    jo, o = j_adamw_init(jp), adamw_init(p)
    for s in range(3):
        g_np = _grads_like(_np(jp), seed=s, scale=grad_scale)
        jp, jo, jm = j_adamw_update(jacfg, jp, jax.tree.map(jnp.asarray,
                                                              g_np), jo)
        g = convert.lm_params(g_np, cfg, device="cpu")
        p, o, m = adamw_update(acfg, p, g, o)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(o["step"]) == int(jo["step"]) == 3
    j_state = convert.adamw_state(_np(jo), cfg, device="cpu")
    for got, want in ((p, convert.lm_params(_np(jp), cfg, device="cpu")),
                      (o["m"], j_state["m"]), (o["v"], j_state["v"])):
        for (path, a), b in zip(leaves_with_paths(got), leaves(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=str(path))


def test_block_norm_scales_are_decayed_and_final_norm_is_not():
    """With zero gradients an update is decay alone: every leaf under
    blocks (the norm scales too, 2-D in the JAX stacked tree) shrinks by
    lr * weight_decay, final_norm stays; as in the JAX package."""
    jcfg, cfg = _cfgs(dtype="float32")
    jp, p = _params(jcfg, cfg)
    acfg = AdamWConfig(lr=0.5, warmup_steps=0, total_steps=10)
    jacfg = JAdamWConfig(lr=0.5, warmup_steps=0, total_steps=10)
    zeros = map_tree(torch.zeros_like, p)
    before = map_tree(torch.clone, p)
    p, _, m = adamw_update(acfg, p, zeros, adamw_init(p))
    jp, _, _ = j_adamw_update(jacfg, jp, jax.tree.map(jnp.zeros_like, jp),
                              j_adamw_init(jp))
    keep = 1 - float(m["lr"]) * acfg.weight_decay
    for blk_p, blk_b in zip(p["blocks"], before["blocks"]):
        for name in ("norm1", "norm2"):
            torch.testing.assert_close(blk_p[name]["scale"],
                                       blk_b[name]["scale"] * keep)
        for name in ("q_norm", "k_norm"):
            torch.testing.assert_close(blk_p["attn"][name]["scale"],
                                       blk_b["attn"][name]["scale"] * keep)
    assert torch.equal(p["final_norm"]["scale"],
                       before["final_norm"]["scale"])
    want = convert.lm_params(_np(jp), cfg, device="cpu")
    for (path, a), b in zip(leaves_with_paths(p), leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=str(path))


@pytest.mark.parametrize("step", [0, 1, 5, 50, 99, 100, 101, 2500, 9999,
                                  10000, 12000])
def test_schedule_matches_jax(step):
    acfg = AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=10000)
    jacfg = JAdamWConfig(lr=3e-4, warmup_steps=100, total_steps=10000)
    want = float(j_schedule(jacfg, jnp.asarray(step, jnp.int32)))
    np.testing.assert_allclose(schedule(acfg, step), want, rtol=1e-6)


def test_global_norm_matches_jax():
    jcfg, cfg = _cfgs(dtype="float32")
    jp, p = _params(jcfg, cfg)
    np.testing.assert_allclose(float(global_norm(p)),
                               float(j_global_norm(jp)), rtol=1e-6)


@pytest.mark.parametrize("nm,impl,remat", [(1, "naive", "none"),
                                           (2, "flash", "full")])
def test_three_train_steps_match_jax(nm, impl, remat):
    """make_train_step against the JAX make_train_step, the same JAX
    batches and params, microbatches 1 and 2."""
    kw = dict(dtype="float32", attn_impl=impl, remat=remat)
    jcfg, cfg = _cfgs(**kw)
    jp, p = _params(jcfg, cfg)
    jacfg = JAdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    acfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jo, o = j_adamw_init(jp), adamw_init(p)
    j_step = j_make_train_step(jcfg, jacfg, JTrainConfig(microbatches=nm))
    step = make_train_step(cfg, acfg, TrainConfig(microbatches=nm))
    pipe = JTokenPipeline(jcfg.vocab_size, 32, 4, seed=0)
    lrs = 0.0
    for s in range(3):
        jb = pipe.batch(s)
        jp, jo, jm = j_step(jp, jo, jb)
        p, o, m = step(p, o, {k: torch.from_numpy(np.array(v))
                              for k, v in jb.items()})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
        lrs += float(m["lr"])
    assert not any(t.requires_grad for t in leaves(p))
    got = torch.cat([t.flatten() for t in leaves(p)])
    want = torch.cat([t.flatten() for t in leaves(
        convert.lm_params(_np(jp), cfg, device="cpu"))])
    diff = (got - want).abs()
    assert float(diff.max()) <= 2 * lrs
    assert float((diff > 1e-6).float().mean()) <= 1e-3


def test_unported_distributed_trainers_raise_naming_a11():
    """The distributed trainers are ported (A11b): the deferred step's
    knobs and a mesh are refused where they cannot run, as in the JAX
    package."""
    _, cfg = _cfgs()
    acfg = AdamWConfig()
    with pytest.raises(ValueError, match="make_defer_train_step"):
        make_train_step(cfg, acfg, TrainConfig(compress_int8=True))
    with pytest.raises(ValueError, match="make_defer_train_step"):
        make_train_step(cfg, acfg, TrainConfig(defer_s=2))
    with pytest.raises(ValueError, match="needs a mesh"):
        make_defer_train_step(cfg, acfg, TrainConfig(defer_s=2), None)
    with pytest.raises(ValueError, match="multi-rank mesh"):
        train_cli.main(["--reduced", "--device", "cpu", "--steps", "1",
                        "--defer-s", "2"])
    with pytest.raises(ValueError, match="initialised default process"):
        train_cli.main(["--reduced", "--device", "cpu", "--steps", "1",
                        "--mesh", "2x1"])


def test_microbatches_must_divide_the_batch():
    _, cfg = _cfgs(dtype="float32")
    params, opt = init_train_state(torch.Generator().manual_seed(0), cfg,
                                   AdamWConfig(), device="cpu")
    step = make_train_step(cfg, AdamWConfig(), TrainConfig(microbatches=3))
    with pytest.raises(ValueError, match="multiple"):
        step(params, opt, TokenPipeline(cfg.vocab_size, 8, 4).batch(0))


def test_token_pipeline_is_deterministic_and_shaped():
    pipe = TokenPipeline(vocab_size=512, seq_len=64, global_batch=16,
                         seed=3)
    a, b = pipe.batch(5), pipe.batch(5)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["tokens"], pipe.batch(6)["tokens"])
    assert not torch.equal(a["tokens"], TokenPipeline(
        512, 64, 16, seed=4).batch(5)["tokens"])
    assert a["tokens"].shape == (16, 64) and a["tokens"].dtype == torch.int64
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 512


def test_token_pipeline_copy_rows_repeat_their_first_half():
    """In rows of the copy pattern, token half + i repeats token i for
    i < half = (S + 1) // 2 (as in the JAX pipeline, the copy is taken
    from the draw before it is written, so with odd S + 1 the last
    copied token repeats the draw's token half, which the copy
    overwrote); about half the rows are such rows, and the unigram draw
    is Zipfian (token 0 the most frequent)."""
    S, B = 64, 256
    pipe = TokenPipeline(vocab_size=512, seq_len=S, global_batch=B, seed=0)
    bt = pipe.batch(0)
    full = torch.cat([bt["tokens"], bt["labels"][:, -1:]], 1)   # S + 1
    half = (S + 1) // 2
    copy = (full[:, half:2 * half] == full[:, :half]).all(1)
    assert 0.3 < float(copy.float().mean()) < 0.7
    counts = torch.bincount(full.flatten(), minlength=512)
    assert int(counts.argmax()) == 0 and counts[0] > 4 * counts[20]


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones(3, dtype=torch.bfloat16) / 3,
                  torch.tensor(7, dtype=torch.int32)]}


def test_checkpoint_round_trip(tmp_path):
    t = _tree()
    path = save_checkpoint(str(tmp_path), 5, t, extra={"arch": ARCH})
    assert os.path.basename(path) == "step_00000005"
    got, meta = load_checkpoint(str(tmp_path), template=t)
    assert meta["step"] == 5 and meta["extra"] == {"arch": ARCH}
    assert meta["paths"] == ["a", "b/0", "b/1"]
    for a, b in zip(leaves(got), leaves(t)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    flat, _ = load_checkpoint(str(tmp_path))
    assert len(flat) == 3 and torch.equal(flat[0], t["a"])


def test_partial_checkpoint_is_invisible_to_restore(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t)
    os.makedirs(tmp_path / "step_00000009.tmp")           # a preempted write
    with open(tmp_path / "step_00000009.tmp" / "meta.json", "w") as f:
        json.dump({"step": 9}, f)
    assert available_steps(str(tmp_path)) == [3]
    _, meta = CheckpointManager(str(tmp_path)).restore_latest(template=t)
    assert meta["step"] == 3


def test_manager_keeps_the_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2, save_every=10)
    t = _tree()
    assert not mgr.should_save(0) and not mgr.should_save(15)
    for s in (10, 20, 30, 40):
        assert mgr.should_save(s)
        mgr.save_async(s, t)
    mgr.wait()
    assert available_steps(str(tmp_path)) == [30, 40]
    _, meta = mgr.restore_latest(template=t)
    assert meta["step"] == 40
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(t) == (
        None, None)


def test_preemption_resume_bit_exact(tmp_path):
    """6 steps straight against 3 steps, a checkpoint, a 'preemption', a
    restore and 3 more: bit-identical params and optimizer state (the
    index-derived pipeline and the checkpointed AdamW state)."""
    _, cfg = _cfgs(dtype="float32", attn_impl="flash")
    acfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=8,
                         global_batch=4, seed=0)
    step_fn = make_train_step(cfg, acfg, TrainConfig(microbatches=2))

    def train(params, opt, s0, s1):
        for s in range(s0, s1):
            params, opt, _ = step_fn(params, opt, pipe.batch(s))
        return params, opt

    def fresh():
        return init_train_state(torch.Generator().manual_seed(0), cfg, acfg,
                                device="cpu")

    ref_p, ref_o = train(*fresh(), 0, 6)
    p, o = train(*fresh(), 0, 3)
    save_checkpoint(str(tmp_path), 3, {"params": p, "opt": o})
    del p, o                                     # the preemption
    template = dict(zip(("params", "opt"), fresh()))
    restored, meta = load_checkpoint(str(tmp_path), template=template)
    assert meta["step"] == 3 and int(restored["opt"]["step"]) == 3
    p2, o2 = train(restored["params"], restored["opt"], meta["step"], 6)
    for a, b in zip(leaves({"p": ref_p, "o": ref_o}),
                    leaves({"p": p2, "o": o2})):
        assert torch.equal(a, b)


def test_convert_adamw_state():
    jcfg, cfg = _cfgs(dtype="float32")
    jp, _ = _params(jcfg, cfg)
    g = jax.tree.map(lambda a: jnp.full(a.shape, 0.01, jnp.float32), jp)
    _, jo, _ = j_adamw_update(JAdamWConfig(), jp, g, j_adamw_init(jp))
    o = convert.adamw_state(_np(jo), cfg, device="cpu")
    assert o["step"].dtype == torch.int32 and int(o["step"]) == 1
    assert len(o["m"]["blocks"]) == cfg.n_layers
    for key in ("m", "v"):
        want = _np(jo[key])
        for layer in range(cfg.n_layers):
            np.testing.assert_array_equal(
                o[key]["blocks"][layer]["attn"]["wq"].numpy(),
                want["blocks"][0]["attn"]["wq"][layer])
        np.testing.assert_array_equal(o[key]["embed"]["table"].numpy(),
                                      want["embed"]["table"])
