"""The port's flash attention forward (the plain version on the CPU, and
the ``sdpa_flash`` layout wrapper) against the JAX package's Pallas
``flash_fwd`` in interpret mode, ``ops.sdpa_flash`` and the oracle, on
the same numpy inputs: ``o`` and the log-sum-exp ``lse``.  The CUDA
kernel against its plain version is in tests/test_torch_gpu.py.

Tolerances are the reference's own (tests/test_flash_attention.py): f32
2e-4 relative / 2e-5 absolute, bf16 3e-2.  ``flash_route`` (which kernel
a call takes on the card) is a pure function of dtype and head dims, and
the plain version with p rounded to bf16 (what the tensor-core forward
computes) is held against the Pallas forward and its derived bound.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels.flash_attention import flash_fwd as j_flash_fwd
from repro.kernels.ref import flash_attention_ref as j_ref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (check_shapes,
                                                 flash_fwd_cuda,
                                                 flash_fwd_plain,
                                                 flash_route)
from repro_torch.kernels.ref import (JAX_BF16_TOL, flash_attention_ref,
                                     flash_fwd_bf16_tolerance)

SHAPES = [(2, 128, 128, 32, 32), (1, 256, 256, 64, 64), (3, 64, 64, 16, 8)]


def _qkv(BH, S, T, hd, hdv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BH, S, hd)).astype(np.float32),
            rng.standard_normal((BH, T, hd)).astype(np.float32),
            rng.standard_normal((BH, T, hdv)).astype(np.float32))


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_fwd_matches_pallas(causal, shape):
    q, k, v = _qkv(*shape)
    o_j, lse_j = j_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, bq=64, bk=64, interpret=True)
    before = flash_fwd_cuda.launches
    o, lse = ops.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal)
    assert flash_fwd_cuda.launches == before    # the CPU ran the plain one
    assert o.shape == shape[:2] + shape[4:] and lse.shape == shape[:2]
    _close(o, o_j, 2e-4, 2e-5)
    _close(lse, lse_j, 2e-4, 2e-5)
    _close(o, j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal), 2e-4, 2e-5)


def test_flash_fwd_bf16():
    q, k, v = _qkv(2, 128, 128, 32, 32, seed=1)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    o_j, lse_j = j_flash_fwd(jq, jk, jv, causal=True, bq=64, bk=64,
                             interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    o, lse = flash_fwd_plain(tq, tk, tv, causal=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _close(o, o_j, 3e-2, 3e-2)
    _close(lse, lse_j, 3e-2, 3e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_oracle_matches_jax_oracle(causal):
    q, k, v = _qkv(3, 64, 64, 16, 8, seed=2)
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    want = j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 causal=causal)
    _close(got, want, 2e-4, 2e-5)


@pytest.mark.parametrize("shape", [(2, 64, 4, 32, 32), (1, 256, 2, 16, 8)])
def test_sdpa_flash_layout_matches_jax(shape):
    """(B, S, H, hd) in and (B, S, H, hdv) out, as the model calls it."""
    B, S, H, hd, hdv = shape
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, H, hdv)).astype(np.float32)
    want = j_ops.sdpa_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, interpret=True)
    got = ops.sdpa_flash(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=True)
    assert got.shape == (B, S, H, hdv)
    _close(got, want, 2e-4, 2e-5)


@pytest.mark.parametrize("shape,match", [
    ((1, 300, 300, 32, 32), "multiple"),      # S > 256 and not a multiple
    ((1, 64, 512 + 64, 32, 32), "multiple"),  # the same rule on T
    ((1, 64, 64, 160, 32), "exceed"),         # hd above 128
    ((1, 64, 64, 32, 129), "exceed"),         # hdv above 128
])
def test_shapes_the_tpu_kernel_refuses_are_refused(shape, match):
    q, k, v = (torch.from_numpy(a) for a in _qkv(*shape))
    with pytest.raises(ValueError, match=match):
        check_shapes(q, k, v)
    with pytest.raises(ValueError, match=match):
        flash_fwd_plain(q, k, v)


def test_ragged_shapes_the_tpu_kernel_takes_are_taken():
    """S, T <= 256 need not be multiples of anything (one block)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 17, 40, 24, 16))
    o, lse = flash_fwd_plain(q, k, v, causal=False)
    _close(o, j_ref(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                    causal=False), 2e-4, 2e-5)


def test_kernel_wrapper_refuses_host_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 64, 16, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_fwd_cuda(q, k, v)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16], ids=["bf16", "f32",
                                                        "f16"])
@pytest.mark.parametrize("hd,hdv", [(128, 128), (64, 64), (32, 32),
                                    (16, 16), (24, 24), (128, 64),
                                    (64, 128), (96, 96)])
def test_flash_route(dtype, hd, hdv):
    """The tensor-core kernels take bf16 with hd = hdv in {64, 128}; every
    other call takes the FP32-FMA kernels."""
    want = ("wgmma" if dtype == torch.bfloat16 and hd == hdv
            and hd in (64, 128) else "fma")
    assert flash_route(dtype, hd, hdv) == want


def _bf16_errors(shape, causal, block, seed):
    """|o - o_pallas| of the f32-p and the bf16-p plain versions, the
    Pallas forward in interpret mode at ``block`` rows, same bf16 inputs."""
    q, k, v = _qkv(*shape, seed=seed)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    o_j, _ = j_flash_fwd(jq, jk, jv, causal=causal, bq=block, bk=block,
                         interpret=True)
    o_j = np.asarray(o_j.astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    return [np.abs(flash_fwd_plain(tq, tk, tv, causal, round_p=r)[0]
                   .float().numpy() - o_j) for r in (False, True)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 128, 128, 64, 64),
                                   (2, 256, 256, 128, 128)])
def test_round_p_plain_matches_pallas_bf16(causal, shape):
    """p rounded to bf16 before PV (flash_attention.py:68) brings the plain
    version at least as close to the Pallas forward as f32 p: over one k
    block, where the kernel's running max is the row max, in the largest
    and the mean error; over 64-row blocks in the mean error."""
    f32p, bf16p = _bf16_errors(shape, causal, shape[1], seed=5)
    assert bf16p.max() <= f32p.max() and bf16p.mean() <= f32p.mean()
    assert bf16p.max() <= JAX_BF16_TOL
    f32p, bf16p = _bf16_errors(shape, causal, 64, seed=6)
    assert bf16p.mean() <= f32p.mean() and bf16p.max() <= JAX_BF16_TOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 256, 256, 128, 128),
                                   (3, 100, 40, 64, 64)])
def test_round_p_within_derived_bf16_bound(causal, shape):
    """The derived bound that holds the tensor-core forward against the
    f32-p plain version on the card covers the bf16 rounding of p: the
    bf16-p plain version stays within it, and it is no looser than the
    JAX package's bf16 bound."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(*shape, seed=7))
    o, lse = flash_fwd_plain(q, k, v, causal)
    o_r, lse_r = flash_fwd_plain(q, k, v, causal, round_p=True)
    tol = flash_fwd_bf16_tolerance(q, k, v, o, causal)
    assert bool(((o_r.float() - o.float()).abs() <= tol).all())
    assert bool((tol <= JAX_BF16_TOL * (1 + o.float().abs())).all())
    torch.testing.assert_close(lse_r, lse, rtol=0, atol=0)
