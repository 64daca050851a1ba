"""The port's MoE family trained: loss_fn and every gradient leaf
against jax.value_and_grad, the init layout, AdamW's decay rule on the
new leaves, on reduced DeepSeek-V2-Lite and Arctic (split from
tests/test_torch_moe.py, whose docstring gives the bounds)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.models.lm import abstract_params
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import decayed
from repro_torch.train import loss_and_grads
from repro_torch.tree import leaves, leaves_with_paths, map_tree

ARCHS = ["deepseek_v2_lite_16b", "arctic_480b"]


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_get_config(arch, reduced=True), **kw),
            dataclasses.replace(get_config(arch, reduced=True), **kw))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _params(jcfg, cfg, seed=0):
    jp = j_init_params(jax.random.key(seed), jcfg)
    return jp, convert.lm_params(_np(jp), cfg, device="cpu")


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
