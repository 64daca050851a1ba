"""The port's ``launch/specs`` against the JAX package's ``launch/specs``
built on ``jax.sharding.AbstractMesh``, for all ten configs x the four
shapes x both production meshes ((data, model) = (16, 16) and (pod,
data, model) = (2, 16, 16)): params, AdamW state, batch, decode state
and decode tokens, by shape, dtype and spec.

The JAX package stacks a layer's leaves over the pattern's periods
(``blocks/<position>``, the encoder's over its layers, a decode state's
caches over the periods, ``shared_cache`` over the periods and
``cross_kv`` over the layers); the port keeps one entry a layer.  A
stacked JAX leaf is compared without its layer axis, which its spec
never splits, and every port leaf's spec equals JAX's ``param_spec`` on
the per-layer shape.  Where a JAX rule reads the rank of the leaf, the
stacked leaf takes another row than the layer it holds (ROADMAP C18 and
C36; ``STACKED`` lists them): the plain MLP's ``wo`` ((f, d) -> ``(T,
F)`` per layer; the stacked (L, f, d) falls through to the table's
``(T, None, F)`` where L divides ``model``), Mamba-2's 1-D per-head
``A_log`` and ``D`` (the stacked (L, nh) right-aligns their Mamba-1 rows
onto the layer axis), and a MoE block's shared experts and dense
residual, which take the experts' ``(E, d, f)`` rows (``in_moe``): per
layer right-aligned onto (d, f), stacked onto (L, d, f).
The decode state's ``pos`` is int64 in the port (int32 in JAX)."""
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS
from repro.configs import get_config as jax_config
from repro.launch import specs as JS
from repro.models.config import SHAPES as JSHAPES
from repro.models.sharding import MeshRules as JRules
from repro.models.sharding import param_spec as jax_param_spec
from repro_torch.configs import get_config
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import SHAPES
from repro_torch.models.sharding import MeshRules
from repro_torch.tree import leaves_with_paths

MESHES = {"16x16": False, "2x16x16": True}
# the leaves whose stacked JAX spec differs from its per-layer one, on
# both production meshes (module docstring; ROADMAP C18, C36)
_SUB_MLP = {"wi_gate", "wi_up", "wo"}
STACKED = {"yi_6b": {("mlp", "wo")}, "qwen2_vl_72b": {("mlp", "wo")},
           "zamba2_1p2b": {("mamba", "A_log"), ("mamba", "D")},
           "deepseek_v2_lite_16b": {("shared", k) for k in _SUB_MLP},
           "arctic_480b": {("dense_residual", k) for k in _SUB_MLP}}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jrules(multi_pod: bool) -> JRules:
    if multi_pod:
        return JRules(AbstractMesh((2, 16, 16), ("pod", "data", "model")))
    return JRules(AbstractMesh((16, 16), ("data", "model")))


def _norm(spec, ndim):
    """A JAX spec as the port writes one: one entry a dim, a tuple of one
    axis as its name, a tuple of two kept."""
    out = [a[0] if isinstance(a, tuple) and len(a) == 1 else a
           for a in tuple(spec)]
    return tuple(out + [None] * (ndim - len(out)))


def _flat(tree) -> dict:
    """``{path: ShapeDtypeStruct}`` of a JAX tree, its path as JAX's
    ``tree_pspecs`` writes it."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


@functools.lru_cache(maxsize=None)
def _jax(arch: str, multi_pod: bool):
    cfg, jr = jax_config(arch), _jrules(multi_pod)
    out = {"params": _flat(JS.param_specs(cfg, jr)),
           "opt": _flat(JS.opt_specs(cfg, jr))}
    for name, shape in JSHAPES.items():
        out[("batch", name)] = _flat(JS.batch_specs(cfg, shape, jr))
        if shape.kind == "decode":
            out[("state", name)] = _flat(
                JS.decode_state_specs(cfg, shape, jr))
            out[("tokens", name)] = JS.decode_token_specs(shape, jr)
    return out


def _rules(multi_pod: bool) -> MeshRules:
    return MeshRules(make_production_mesh(multi_pod=multi_pod))


def _jax_param_path(cfg, path) -> tuple:
    """The JAX path of a port params leaf and whether JAX stacks it."""
    if path[0] == "blocks":
        return ("/".join(["blocks", str(path[1] % len(cfg.pattern)),
                          *map(str, path[2:])]), True)
    if path[:2] == ("encoder", "blocks"):
        return "/".join(["encoder", "blocks", *map(str, path[3:])]), True
    return "/".join(map(str, path)), False


def _check_param_tree(cfg, jr, got, want, prefix=""):
    """Every port leaf of a params-shaped tree against its JAX leaf."""
    seen, differ = set(), set()
    for path, s in leaves_with_paths(got):
        jpath, stacked = _jax_param_path(cfg, path)
        w = want[prefix + jpath]
        seen.add(prefix + jpath)
        wshape = tuple(w.shape[1:] if stacked else w.shape)
        assert s.shape == wshape and s.dtype == torch.float32, path
        assert str(w.dtype) == "float32", path
        wspec = _norm(w.sharding.spec, len(w.shape))
        if stacked:
            # only a STACKED row may put the layer axis on the mesh
            assert wspec[0] is None or any(
                path[-2:] in rows for rows in STACKED.values()), path
            wspec = wspec[1:]
        assert s.spec == tuple(jax_param_spec(jr, jpath, s.shape)), path
        if s.spec != wspec:
            differ.add(path[-2:])
        assert len(s.chunk) == len(s.shape)
    assert seen == {k for k in want if k.startswith(prefix)
                    and not k.endswith("step")}
    return differ


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_opt_equal_jax(arch, mesh):
    multi_pod = MESHES[mesh]
    cfg, jr = get_config(arch), _jrules(multi_pod)
    rules = _rules(multi_pod)
    want = _jax(arch, multi_pod)
    differ = _check_param_tree(cfg, jr, S.param_specs(cfg, rules),
                               want["params"])
    assert differ == STACKED.get(arch, set()), differ
    opt = S.opt_specs(cfg, rules)
    for key in ("m", "v"):
        d = _check_param_tree(cfg, jr, opt[key], want["opt"], key + "/")
        assert d == differ
    step, wstep = opt["step"], want["opt"]["step"]
    assert (step.shape, step.spec, step.dtype) == ((), (), torch.int32)
    assert tuple(wstep.shape) == () and str(wstep.dtype) == "int32"
    assert tuple(wstep.sharding.spec) == ()


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_state_and_tokens_equal_jax(arch, mesh):
    multi_pod = MESHES[mesh]
    cfg, rules = get_config(arch), _rules(multi_pod)
    want = _jax(arch, multi_pod)
    for name, shape in SHAPES.items():
        got = S.batch_specs(cfg, shape, rules)
        wb = want[("batch", name)]
        assert set(got) == set(wb), name
        for k, s in got.items():
            w = wb[k]
            assert s.shape == tuple(w.shape), (name, k)
            assert str(s.dtype).replace("torch.", "") == str(w.dtype)
            assert s.spec == _norm(w.sharding.spec, len(w.shape)), (name, k)
        if shape.kind != "decode":
            continue
        tok, wt = S.decode_token_specs(shape, rules), want[("tokens", name)]
        assert tok.shape == tuple(wt.shape) and tok.dtype == torch.int32
        assert tok.spec == _norm(wt.sharding.spec, 2)
        _check_state(cfg, S.decode_state_specs(cfg, shape, rules),
                     want[("state", name)], name)


def _check_state(cfg, got, want, name):
    """Every port decode-state leaf against its stacked JAX leaf."""
    seen = set()
    for path, s in leaves_with_paths(got):
        if path == ("pos",):
            w = want["pos"]
            assert s.shape == tuple(w.shape) and s.spec == _norm(
                w.sharding.spec, 1)
            assert s.dtype == torch.int64 and str(w.dtype) == "int32"
            seen.add("pos")
            continue
        if path[0] == "caches":
            jpath = f"caches/{path[1] % len(cfg.pattern)}/{path[2]}"
        else:                      # shared_cache / cross_kv: (entry, pair)
            jpath = f"{path[0]}/{path[2]}"
        w = want[jpath]
        seen.add(jpath)
        assert s.shape == tuple(w.shape[1:]), (name, path)
        assert str(s.dtype).replace("torch.", "") == str(w.dtype), path
        wspec = _norm(w.sharding.spec, len(w.shape))
        assert wspec[0] is None and s.spec == wspec[1:], (name, path)
    assert seen == set(want), (name, set(want) - seen)
