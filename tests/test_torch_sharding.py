"""The port's sharding rules (``models/sharding.py``) against the JAX
package's, without processes: ``param_spec`` called with JAX's paths and
shapes equals JAX's on every leaf of all ten configs on ``AbstractMesh``
(1, 1), (2, 2), (4, 2) and (16, 16); the port's ``tree_pspecs`` on its
own per-layer leaves (``abstract_params``) equals JAX's ``param_spec`` on
the stacked leaf's per-layer shape, and JAX's own spec of the stacked
leaf wherever the stacking does not change the rule.  It changes one
rule (ROADMAP C18): the plain-MLP ``wo`` rule tests ``len(shape) == 2``;
JAX's stacked leaf is 3-D, falls through to the table's ``(T, None, F)``
and so shards the stacked layer axis over ``model``, where the port's
2-D leaf takes ``(T, F)``, what the rule meant.

The decode-state layout: ``cache_spec`` called with JAX's paths and the
per-layer shapes equals JAX's ``launch/specs._cache_pspec`` with its
stacked layer axis dropped, on every leaf of the JAX ``init_decode_state``
of all ten configs (Mamba states, Zamba2's shared cache and Whisper's
cross-attention K / V included) on ``AbstractMesh`` (1, 1), (2, 2), (4,
1), (1, 4) and (2, 1), at B in {1, 4}, S in {1056, 33}.

Also: the tensor-parallel route's choice of block parts (MLA and the
experts included), the collective model of a step on the identity mesh,
that a step carries no state into the next, and the chunks a sharded
decode state holds."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS
from repro.configs import get_config as jax_config
from repro.models import abstract_params as jax_abstract
from repro.models.sharding import MeshRules as JRules
from repro.models.sharding import param_spec as jax_spec
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models.lm import abstract_params, param_specs
from repro_torch.models.sharding import (MeshRules, Sharded, leaf_specs,
                                         param_spec, shard_tree, tree_pspecs)
from repro_torch.tree import leaves_with_paths

MESHES = [(1, 1), (2, 2), (4, 2), (16, 16)]
# the dense GQA configs
PORTED = ("llama3_405b", "granite_20b", "yi_6b", "qwen3_1p7b")


@functools.lru_cache(maxsize=None)
def _jax_leaves(arch):
    """``[(path, shape)]`` of JAX's abstract params, the path built as
    JAX's ``tree_pspecs`` builds it."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jax_abstract(jax_config(arch)))
    return [("/".join(str(getattr(k, "key", k)) for k in path),
             tuple(leaf.shape)) for path, leaf in flat]


def _rules(mesh):
    return (JRules(AbstractMesh(mesh, ("data", "model"))),
            MeshRules(Mesh(mesh)))


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_equals_jax_on_every_leaf(arch, mesh):
    jr, tr = _rules(mesh)
    for path, shape in _jax_leaves(arch):
        want = tuple(jax_spec(jr, path, shape))
        assert param_spec(tr, path, shape) == want, (path, shape)
        # and on the per-layer shape a port leaf would have
        if path.startswith("blocks/") and len(shape) > 1:
            assert (param_spec(tr, path, shape[1:])
                    == tuple(jax_spec(jr, path, shape[1:]))), path


def _port_to_jax_path(path):
    """The JAX path of a port leaf: ``blocks/<layer>/...`` is the stacked
    leaf ``blocks/[0]/...`` (one pattern position: dense models)."""
    if path[0] == "blocks":
        return "/".join(["blocks", "[0]", *map(str, path[2:])])
    return "/".join(map(str, path))


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", PORTED)
def test_tree_pspecs_on_the_ports_leaves(arch, mesh):
    jr, tr = _rules(mesh)
    jleaves = dict(_jax_leaves(arch))
    cfg = get_config(arch)
    got = tree_pspecs(tr, abstract_params(cfg))
    full = abstract_params(cfg)
    for spec, (path, t) in zip(leaf_specs(got, full),
                               leaves_with_paths(full)):
        jpath = _port_to_jax_path(path)
        jshape = jleaves[jpath]
        stacked = path[0] == "blocks"
        shape = jshape[1:] if stacked else jshape
        assert tuple(t.shape) == shape, path
        assert spec == tuple(jax_spec(jr, jpath, shape)), path
        jstacked = tuple(jax_spec(jr, jpath, jshape))
        if stacked and path[-2:] == ("mlp", "wo"):
            # JAX's stacked (L, f, d) leaf falls through to (T, None, F):
            # the layer axis goes to model, f is not split; where L does
            # not divide model, the attention wo's head fallback takes it
            # to (None, T, F)
            axes = (("model", None, "data") if jshape[0] % mesh[1] == 0
                    else (None, "model", "data"))
            assert jstacked == tuple(JRules.fit(jr, jshape, axes)), path
            assert spec == tuple(JRules.fit(jr, shape, ("model", "data")))
        elif stacked:
            assert jstacked[0] is None and spec == jstacked[1:], path
        else:
            assert spec == jstacked, path
    assert param_specs(tr, cfg) == got


def test_leaf_specs_follow_paths_not_order():
    """A tree ordered otherwise (``convert.lm_params`` keeps JAX's sorted
    keys) gets each leaf's own spec."""
    cfg = get_config("qwen3_1p7b", reduced=True)
    full = abstract_params(cfg)
    specs = tree_pspecs(MeshRules(Mesh((2, 2))), full)
    flipped = {k: full[k] for k in reversed(list(full))}
    flipped["blocks"] = [{k: b[k] for k in sorted(b)} for b in
                         full["blocks"]]
    for s, (path, t) in zip(leaf_specs(specs, flipped),
                            leaves_with_paths(flipped)):
        assert isinstance(s, tuple) and len(s) == t.ndim
        assert s == param_spec(MeshRules(Mesh((2, 2))),
                               "/".join(map(str, path)), tuple(t.shape))


CACHE_MESHES = [(1, 1), (2, 2), (4, 1), (1, 4), (2, 1)]


@functools.lru_cache(maxsize=None)
def _jax_state_leaves(arch, batch, seq):
    """``[(path, leaf)]`` of JAX's abstract decode state, the path built as
    ``launch/specs.decode_state_specs`` builds it."""
    from repro.models import init_decode_state as jax_init_state
    cfg = jax_config(arch)
    state = jax.eval_shape(lambda: jax_init_state(
        cfg, batch, seq, with_encoder=bool(cfg.encoder_layers)))
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), leaf) for path, leaf in flat]


def _norm_spec(spec, ndim):
    """A JAX spec as the port writes one: one entry a dim, a tuple of one
    axis as its name."""
    out = [a[0] if isinstance(a, tuple) and len(a) == 1 else a
           for a in tuple(spec)]
    return tuple(out + [None] * (ndim - len(out)))


@pytest.mark.parametrize("seq", [1056, 33])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("mesh", CACHE_MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_equals_jax_on_every_leaf(arch, mesh, batch, seq):
    from repro.launch.specs import _cache_pspec
    from repro_torch.models.sharding import cache_spec
    jr, tr = _rules(mesh)
    jcfg, cfg = jax_config(arch), get_config(arch)
    leaves = _jax_state_leaves(arch, batch, seq)
    assert any(p.startswith("caches/") for p, _ in leaves)
    for path, leaf in leaves:
        want = _norm_spec(_cache_pspec(jr, jcfg, path, leaf), leaf.ndim)
        if path.endswith("pos"):
            assert cache_spec(tr, cfg, path, leaf.shape) == want, path
            continue
        # the stacked layer axis is never split; the port's leaf lacks it
        assert want[0] is None, path
        assert cache_spec(tr, cfg, path, leaf.shape[1:]) == want[1:], path


@pytest.mark.parametrize("arch", ["qwen3_1p7b", "deepseek_v2_lite_16b"])
@pytest.mark.parametrize("mesh,batch", [((2, 2), 4), ((2, 2), 1),
                                        ((1, 4), 4), ((4, 1), 2)])
def test_sharded_decode_state_holds_the_chunks(arch, mesh, batch):
    """``init_decode_state(rules=)`` holds each cache's chunk of its
    ``cache_spec`` (S, batch or kv heads cut), ``pos`` whole, and the
    full ``max_seq``; the collective model of a decode step counts a
    ``seq`` merge for every layer whose cache S is split."""
    from repro_torch.models.lm import (abstract_decode_state,
                                       init_decode_state)
    from repro_torch.models.sharding import chunk_shape, decode_state_specs
    from repro_torch.train.train_step import decode_collectives
    cfg = get_config(arch, reduced=True)
    rules = MeshRules(Mesh(mesh))
    seq = 64
    state = init_decode_state(cfg, batch, seq, device="cpu", rules=rules)
    full = abstract_decode_state(cfg, batch, seq)
    specs = decode_state_specs(rules, cfg, full)
    assert state["max_seq"] == seq and state["pos"].shape == (batch,)
    split_s = 0
    for pair, fpair, spair in zip(state["caches"], full["caches"],
                                  specs["caches"]):
        for t, f, sp in zip(pair, fpair, spair):
            assert list(t.shape) == chunk_shape(rules.mesh, f.shape, sp)
        split_s += sp[1] is not None and mesh[("data", "model").index(
            sp[1])] > 1
    calls = decode_collectives(cfg, rules, batch, seq)
    merges = sum(k for (a, kind), k in calls.items() if kind == "seq")
    per = 2 if arch.startswith("deepseek") and mesh[1] > 1 else 1
    assert merges == split_s * per


@pytest.mark.parametrize("arch,mesh,parts", [
    ("deepseek_v2_lite_16b", (2, 2), {"attn", "moe"}),
    ("deepseek_v2_lite_16b", (1, 4), {"attn", "moe"}),
    ("deepseek_v2_lite_16b", (4, 1), set()),
    ("arctic_480b", (1, 2), {"attn", "moe"}),
    ("arctic_480b", (1, 4), {"moe"}),         # kv 2 does not divide 4
])
def test_mla_and_expert_parallel_parts(arch, mesh, parts):
    """MLA's attention runs tensor-parallel where wq, w_uk, w_uv and wo
    split their heads over ``model``, the experts expert-parallel where
    their E divides it; MLA's latent leaves, the norm scales and the
    router sit behind ``copy``, the shared experts are gathered."""
    cfg = get_config(arch, reduced=True)
    rules = MeshRules(Mesh(mesh))
    sh = Sharded(rules, param_specs(rules, cfg))
    assert sh.tp_parts == parts
    if "attn" in parts and arch.startswith("deepseek"):
        assert sh.leaf_use(("attn", "w_uk")) == (1, True, False)
        assert sh.leaf_use(("attn", "w_dkv")) == (None, False, True)
        assert sh.leaf_use(("attn", "kv_norm", "scale")) == (None, False,
                                                             True)
    if "moe" in parts:
        assert sh.leaf_use(("moe", "wo")) == (0, True, False)
        assert sh.leaf_use(("moe", "router")) == (None, False, True)
        sub = "shared" if arch.startswith("deepseek") else "dense_residual"
        assert sh.leaf_use(("moe", sub, "wi_gate")) == (None, True, False)


class _ShapeMesh(Mesh):
    """A (2, 2) mesh of one process whose collectives give the shapes the
    real ones give (a gather repeats this rank's chunk, a reduce-scatter
    keeps its first chunk, a reduction is the identity), counted as the
    real ones are: a sharded entry point runs here end to end."""

    def all_gather(self, t, axis, dim, kind="param"):
        self._count(axis, kind, t.numel() * self.shape[axis])
        return torch.cat([t] * self.shape[axis], dim)

    def reduce_scatter(self, t, axis, dim, kind="param"):
        self._count(axis, kind, t.numel())
        return t.chunk(self.shape[axis], dim)[0].contiguous()


@pytest.mark.parametrize("call", ["forward", "loss_fn", "decode_step",
                                  "param_specs", "init_decode_state"])
@pytest.mark.parametrize("arch,item", [
    ("falcon_mamba_7b", "A11e"), ("zamba2_1p2b", "A11e"),
    ("whisper_tiny", "A11f"), ("qwen2_vl_72b", "A11f")])
def test_unported_families_raise_under_rules_too(arch, item, call):
    """The SSM family (Mamba blocks, the shared attention block; ROADMAP
    A11e), the encoder-decoder stack (Whisper) and M-RoPE (Qwen2-VL;
    A11f) once raised under ``rules``: each entry point now runs on a
    (2, 2) mesh of this rank's shards, and every tensor it takes or
    returns has the shape ``chunk_shape`` gives its spec (the logits this
    rank's rows)."""
    from repro_torch.models import lm
    from repro_torch.models.sharding import batch_rows, chunk_shape
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    rules = MeshRules(_ShapeMesh((2, 2)))
    B, S = 2, 4
    rows = batch_rows(rules, B)
    specs = lm.param_specs(rules, cfg)
    full = lm.init_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    params = shard_tree(rules, full, specs)
    toks = torch.zeros((B, S), dtype=torch.long)
    extra = {}
    if cfg.encoder_layers:
        extra["audio_embed"] = torch.zeros((1, cfg.encoder_seq,
                                            cfg.d_model))
    if call == "param_specs":
        for t, f, sp in zip(leaves(params), leaves(full),
                            leaf_specs(specs, full)):
            assert list(t.shape) == chunk_shape(rules.mesh, f.shape, sp)
        return
    state = lm.init_decode_state(cfg, B, 8, device="cpu", rules=rules,
                                 with_encoder=bool(cfg.encoder_layers))
    layout = lm.decode_state_layout(rules, cfg, B, 8)
    whole = lm.abstract_decode_state(cfg, B, 8,
                                     bool(cfg.encoder_layers))

    def check_state(st):
        for key in ("caches", "shared_cache", "cross_kv"):
            assert (key in st) == (key in whole)
            for pair, spair, fpair in zip(st.get(key, ()), layout.get(
                    key, ()), whole.get(key, ())):
                for t, sp, f in zip(pair, spair, fpair):
                    assert list(t.shape) == chunk_shape(rules.mesh,
                                                        f.shape, sp)
                    assert t.dtype == f.dtype

    if call == "init_decode_state":
        check_state(state)
        return
    with torch.no_grad():
        if call == "forward":
            out = lm.forward(params, cfg, toks[rows], rules=rules, **extra)
            assert out.shape == (rows.stop - rows.start, S, cfg.vocab_size)
        elif call == "loss_fn":
            out = lm.loss_fn(params, cfg, {"tokens": toks[rows],
                                           "labels": toks[rows], **extra},
                             rules=rules)
            assert out.shape == () and torch.isfinite(out)
        else:
            out, new = lm.decode_step(params, cfg, state, toks[:, :1],
                                      rules=rules)
            assert out.shape == (rows.stop - rows.start, cfg.vocab_size)
            check_state(new)


@pytest.mark.parametrize("heads,kv,mesh,parts", [
    (4, 2, (2, 2), {"attn", "mlp"}),
    (4, 2, (4, 1), set()),               # no model axis to split over
    (4, 2, (1, 4), {"mlp"}),              # kv 2 does not divide 4
    (3, 1, (1, 2), {"mlp"}),              # the d_model-contraction fallback
])
def test_tensor_parallel_parts(heads, kv, mesh, parts):
    """The attention block runs tensor-parallel only where wq, wk, wv and
    wo all split their heads over ``model``; elsewhere it gathers them
    (replicated compute, ROADMAP C21)."""
    cfg = dataclasses.replace(get_config("qwen3_1p7b", reduced=True),
                              n_heads=heads, n_kv_heads=kv)
    rules = MeshRules(Mesh(mesh))
    assert Sharded(rules, param_specs(rules, cfg)).tp_parts == parts


def test_abstract_params_match_init_params():
    from repro_torch.models import init_params
    cfg = get_config("qwen3_1p7b", reduced=True)
    real = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    for (p, a), (q, b) in zip(leaves_with_paths(abstract_params(cfg)),
                              leaves_with_paths(real)):
        assert p == q and a.shape == b.shape and a.dtype == b.dtype


def test_identity_mesh_step_collectives():
    """On one rank a step makes only its per-step reductions: the sharded
    step one bucket, the deferred step nm / s syncs, and the norm."""
    from repro_torch.train.train_step import TrainConfig, step_collectives
    cfg = get_config("qwen3_1p7b", reduced=True)
    rules = MeshRules(Mesh((1, 1)))
    assert step_collectives(cfg, TrainConfig(microbatches=4), rules,
                            False) == {("data", "grad"): 1,
                                       ("mesh", "metric"): 1}
    assert step_collectives(cfg, TrainConfig(microbatches=4, defer_s=2,
                                             compress_int8=True),
                            rules, True) == {("data", "grad"): 2,
                                             ("mesh", "metric"): 1}


@pytest.mark.parametrize("kind", ["defer-int8", "defer", "sharded"])
def test_steps_carry_no_state_from_step_to_step(kind):
    """A step's result depends on its params, AdamW state and batch only:
    the second step of a stepper that took the first equals, bit for bit,
    a fresh stepper's step from copies of the same state, so no int8
    residual, accumulator, bucket or stale ``.grad`` outlives a step (the
    residual starts at zero every step, ROADMAP C19)."""
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.train_step import (TrainConfig,
                                              make_defer_train_step,
                                              make_train_step)
    from repro_torch.tree import leaves, map_tree
    cfg = dataclasses.replace(get_config("qwen3_1p7b", reduced=True),
                              dtype="float32")
    rules = MeshRules(Mesh((1, 1)))
    acfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)

    def stepper():
        if kind == "sharded":
            return make_train_step(cfg, acfg, TrainConfig(microbatches=2),
                                   rules)
        return make_defer_train_step(cfg, acfg, TrainConfig(
            microbatches=2, defer_s=1, compress_int8=kind == "defer-int8"),
            rules)

    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 9)))
        batches.append({"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    params = init_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    step = stepper()
    params, opt, _ = step(params, adamw_init(params), batches[0])
    fresh = map_tree(torch.clone, (params, opt))
    a = step(params, opt, batches[1])
    b = stepper()(*fresh, batches[1])
    assert all(torch.equal(x, y)
               for x, y in zip(leaves(a[:2]), leaves(b[:2])))
    assert float(a[2]["loss"]) == float(b[2]["loss"])


def test_mesh_rules_fit_drops_what_does_not_divide():
    rules = MeshRules(Mesh((4, 2)))
    assert rules.fit((6, 8), ("model", "data")) == ("model", "data")
    assert rules.fit((6, 6), ("data", "model")) == (None, "model")
    assert rules.fit((3, 5, 8), ("data",)) == (None, None, "data")
    assert rules.axis_size(("data", "model")) == 8
    assert rules.axis_size("pod") == 0 and rules.batch_axes == ("data",)
    np.testing.assert_equal(rules.fit((8,), ("pod",)), (None,))


@pytest.mark.parametrize("coords", [(0, 0), (0, 1)])
def test_own_takes_the_ranks_chunk_and_refuses_other_widths(coords):
    """``Sharded.own``: a tensor of all ``n`` channels gives the rank's
    contiguous chunk, the chunk itself passes through, and any other
    width raises rather than passing through."""
    cfg = get_config("falcon_mamba_7b", reduced=True)
    rules = MeshRules(Mesh((1, 2), coords))
    sh = Sharded(rules, param_specs(rules, cfg))
    t = torch.arange(24.0).reshape(2, 12)
    j = coords[1]
    assert torch.equal(sh.own(t, 12, 1), t[:, 6 * j:6 * (j + 1)])
    assert sh.own(t[:, :6], 12, 1).shape == (2, 6)
    with pytest.raises(ValueError, match="neither"):
        sh.own(t[:, :4], 12, 1)
