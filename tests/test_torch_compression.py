"""The port's int8 error-feedback compression (``optim/compression.py``)
against the JAX package's on seeded numpy inputs: ``q``, ``scale``, the
round trip and the residual bit for bit (the port follows JAX's f32
operations one for one; ``torch.round`` and ``jnp.round`` both round half
to even), at sizes that are and are not multiples of the 256-element
block.  Also the reference's own two properties (``tests/test_optim.py``),
the deferred step's quantization of a leaf split over ``model``, whose
blocks are the full leaf's (``train_step._full_blocks``), against JAX's
compression of the full leaf, and its quantization of the per-layer
leaves in the blocks of JAX's stacked tree."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jc
from repro_torch.optim import (BLOCK, compress_int8, decompress_int8,
                               error_feedback_compress, init_residual)
from repro_torch.optim.compression import block_scale, quantize
from repro_torch.train.train_step import _full_blocks

SHAPES = [(1,), (255,), (256,), (1000,), (4099,), (3, 100), (2, 8, 32)]


def _x(shape, seed=0):
    """Values over six orders of magnitude, with exact zeros and entries
    that land on half steps (ties for the rounding)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape)
         * rng.choice([1e-4, 1e-2, 1.0, 30.0], size=shape))
    flat = x.reshape(-1)
    flat[::7] = 0.0
    flat[3::11] = 0.5 * flat[0] if flat.size > 3 else 0.0
    return x.astype(np.float32)


def _equal(t, a):
    return np.array_equal(t.numpy(), np.asarray(a))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_compress_int8_equals_jax_bit_for_bit(shape):
    x = _x(shape)
    q, scale, meta = compress_int8(torch.from_numpy(x))
    jq, js, jmeta = jc.compress_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and _equal(q, jq) and _equal(scale, js)
    assert meta == (tuple(jmeta[0]), jmeta[1])
    assert _equal(decompress_int8(q, scale, meta),
                  jc.decompress_int8(jq, js, jmeta))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_error_feedback_equals_jax_bit_for_bit(shape):
    g = {"a": _x(shape, 1), "b": [_x((17,), 2)]}
    r = {"a": 1e-3 * _x(shape, 3), "b": [1e-3 * _x((17,), 4)]}
    deq, res = error_feedback_compress(
        {"a": torch.from_numpy(g["a"]), "b": [torch.from_numpy(g["b"][0])]},
        {"a": torch.from_numpy(r["a"]), "b": [torch.from_numpy(r["b"][0])]})
    jdeq, jres = jc.error_feedback_compress(
        {"a": jnp.asarray(g["a"]), "b": [jnp.asarray(g["b"][0])]},
        {"a": jnp.asarray(r["a"]), "b": [jnp.asarray(r["b"][0])]})
    assert _equal(deq["a"], jdeq["a"]) and _equal(res["a"], jres["a"])
    assert _equal(deq["b"][0], jdeq["b"][0])
    assert _equal(res["b"][0], jres["b"][0])


def test_init_residual_is_zero_f32_like_the_params():
    p = {"w": torch.ones((3, 4), dtype=torch.bfloat16), "b": [torch.ones(2)]}
    r = init_residual(p)
    assert r["w"].dtype == torch.float32 and r["w"].shape == (3, 4)
    assert not r["w"].any() and r["b"][0].shape == (2,)


def test_int8_roundtrip_error_bound():
    """The reference's property: the error is within half a step."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    q, s, meta = compress_int8(x)
    y = decompress_int8(q, s, meta)
    assert q.dtype == torch.int8
    assert float((x - y).abs().max()) <= float(s.max()) * 0.51


def test_error_feedback_recovers_mean():
    """The reference's property: with error feedback the accumulated
    quantized sum converges to the true sum."""
    g = {"w": 0.01 * torch.ones(64)}
    r = init_residual(g)
    total = torch.zeros(64)
    for _ in range(100):
        deq, r = error_feedback_compress(g, r)
        total = total + deq["w"]
    np.testing.assert_allclose(total.numpy(), 1.0, atol=0.02)


@pytest.mark.parametrize("shape,dim,n", [
    ((128, 4, 32), 1, 2),       # chunks of 64 elements a row: blocks cut
    ((4, 32, 128), 0, 2),       # whole blocks a chunk
    ((512, 128), 0, 4),
    ((128, 256), 1, 2),
    ((3, 100), 1, 4),            # a padded last block
], ids=str)
def test_chunk_blocks_are_the_full_leafs(shape, dim, n):
    """What the deferred step does on a leaf split over ``model``: each
    rank's block maxima by the full leaf's block index, the maximum over
    the ranks (emulated here), and each rank's chunk quantized with the
    full block's scale; put back together, ``q`` and the dequantized leaf
    equal JAX's compression of the full leaf bit for bit."""
    x = _x(shape, 5)
    full = torch.from_numpy(x)
    chunks = full.chunk(n, dim)
    nb = None
    maxes, ids_of = [], []
    for j, c in enumerate(chunks):
        ids, nb = _full_blocks(tuple(c.shape), dim, n, j, "cpu")
        m = torch.zeros(nb).scatter_reduce_(0, ids, c.reshape(-1).abs(),
                                            "amax")
        maxes.append(m)
        ids_of.append(ids)
    assert nb == -(-full.numel() // BLOCK)
    scale = block_scale(torch.stack(maxes).amax(0))
    qs, deqs = [], []
    for c, ids in zip(chunks, ids_of):
        q = quantize(c.reshape(-1), scale[ids])
        qs.append(q.view(c.shape))
        deqs.append((q.float() * scale[ids]).view(c.shape))
    jq, js, jmeta = jc.compress_int8(jnp.asarray(x))
    jflat = np.asarray(jq).reshape(-1)[:full.numel()].reshape(shape)
    assert np.array_equal(torch.cat(qs, dim).numpy(), jflat)
    assert np.array_equal(scale.numpy(), np.asarray(js)[:, 0])
    assert _equal(torch.cat(deqs, dim), jc.decompress_int8(jq, js, jmeta))


@pytest.mark.parametrize("arch", ["qwen3_1p7b", "yi_6b", "zamba2_1p2b",
                                  "whisper_tiny"])
def test_deferred_step_quantizes_in_jax_stacked_blocks(arch):
    """The deferred step's int8 on the port's per-layer leaves equals JAX's
    ``error_feedback_compress`` on its stacked tree bit for bit: the
    layers' leaves of one name whose size is not a multiple of the block
    (the norm scales, Mamba-2's per-head leaves) share blocks across the
    layers of their stacked array (``_DeferStep.int8_groups``): one
    array for each position of the pattern (Zamba2's two), one for the
    encoder's layers (Whisper)."""
    import dataclasses

    import jax

    from repro.configs import get_config as jax_config
    from repro.models import abstract_params as jax_abstract
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.lm import param_specs
    from repro_torch.models.sharding import MeshRules, leaf_specs
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import TrainConfig, _DeferStep
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    shapes = jax_abstract(jax_config(arch, reduced=True))
    seeds = iter(range(1000))
    g, r = (jax.tree.map(lambda a: _x(a.shape, next(seeds)) * scale,
                         shapes) for scale in (1.0, 1e-3))
    jdeq, jres = jc.error_feedback_compress(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, r))
    step = _DeferStep(cfg, AdamWConfig(),
                      TrainConfig(microbatches=1, compress_int8=True),
                      MeshRules(Mesh((1, 1))))
    params = convert.lm_params(g, cfg, device="cpu")
    views = leaves(params)
    resid = leaves(convert.lm_params(r, cfg, device="cpu"))
    groups = step.int8_groups(step.mesh, params, leaf_specs(
        param_specs(step.rules, cfg), params), len(cfg.pattern))
    assert any(key[0] == "stack" for key in groups)
    step._compress(views, resid, groups)
    for got, want in ((views, jdeq), (resid, jres)):
        want = leaves(convert.lm_params(jax.tree.map(np.asarray, want),
                                        cfg, device="cpu"))
        assert all(np.array_equal(a.numpy(), b.numpy())
                   for a, b in zip(got, want))
