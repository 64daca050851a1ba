"""The port's RMSNorm (``kernels.ops.rmsnorm`` and ``models.layers.rmsnorm``,
the plain version on the CPU) against the JAX package's Pallas kernel in
interpret mode and its model rmsnorm, on the same numpy inputs.  The CUDA
kernel against its plain version is in tests/test_torch_gpu.py.

Tolerances are the reference's own (tests/test_pallas_rmsnorm.py): f32
1e-5, bf16 2e-2.  bf16 inputs are made in f32 with numpy and rounded to
bf16 on both sides (round to nearest even in both: the same values).
The backward (the ``RMSNorm`` Function's analytic dx and dscale against
``jax.grad`` of the JAX model's rmsnorm): dx at the same bounds (in bf16
one rounding of an f32 result on each side), dscale, f32 in both dtypes
(a sum over rows in another order), 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import rmsnorm_pallas
from repro.models.layers import rmsnorm as j_rmsnorm
from repro_torch.kernels import ops
from repro_torch.kernels.ref import rmsnorm_ref
from repro_torch.kernels.rmsnorm import (RMSNorm, rmsnorm_cuda,
                                         rmsnorm_plain)
from repro_torch.models.layers import rmsnorm

SHAPES = [(4, 16, 128), (2, 128), (3, 7, 384), (1, 1, 256), (37, 2048)]
DTYPES = [("f32", jnp.float32, torch.float32, 1e-5),
          ("bf16", jnp.bfloat16, torch.bfloat16, 2e-2)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape[-1]).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES,
                         ids=[d[0] for d in DTYPES])
def test_rmsnorm_matches_pallas_and_model_rmsnorm(shape, name, jdt, tdt, tol):
    x, scale = _inputs(shape)
    xj = jnp.asarray(x).astype(jdt)
    want_kernel = rmsnorm_pallas(xj, jnp.asarray(scale), interpret=True,
                                 block_rows=8)
    want_model = j_rmsnorm({"scale": jnp.asarray(scale)}, xj)
    xt = torch.from_numpy(x).to(tdt)
    st = torch.from_numpy(scale)
    before = rmsnorm_cuda.launches
    for got in (ops.rmsnorm(xt, st), rmsnorm({"scale": st}, xt)):
        assert got.dtype == tdt and got.shape == xt.shape
        for want in (want_kernel, want_model):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=tol, atol=tol)
    assert rmsnorm_cuda.launches == before      # the CPU ran the plain one


def test_unit_rms_invariant():
    """With a unit scale every output row has RMS 1 (the JAX property)."""
    x, _ = _inputs((40, 384), seed=3)
    got = ops.rmsnorm(torch.from_numpy(x), torch.ones(384))
    rms = got.pow(2).mean(-1).sqrt()
    np.testing.assert_allclose(rms.numpy(), 1.0, atol=1e-3)


def test_non_contiguous_input_matches_pallas():
    """The model normalises views (q and k heads); the dispatch takes any
    layout, and the plain version and the oracle agree with the kernel."""
    x, _ = _inputs((6, 128, 3), seed=5)
    _, scale = _inputs((1, 128), seed=6)
    xj = jnp.asarray(x).transpose(0, 2, 1)
    want = rmsnorm_pallas(xj, jnp.asarray(scale), interpret=True,
                          block_rows=8)
    xt = torch.from_numpy(x).transpose(1, 2)
    st = torch.from_numpy(scale)
    for got in (ops.rmsnorm(xt, st), rmsnorm_plain(xt, st),
                rmsnorm_ref(xt, st)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_kernel_wrapper_refuses_host_tensors():
    """The CUDA wrapper never runs on the CPU: it raises, and the dispatch
    takes the plain version only because the tensor lies on the CPU."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        rmsnorm_cuda(torch.ones(2, 8), torch.ones(8))


@pytest.mark.parametrize("shape", [(4, 16, 128), (37, 2048), (3, 7, 384)])
@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES,
                         ids=[d[0] for d in DTYPES])
def test_rmsnorm_backward_matches_jax_grad(shape, name, jdt, tdt, tol):
    """dx and dscale of sum(rmsnorm(x) * dy) through the Function (its
    forward is the plain version here, its backward the analytic f32
    formula) and through ``ops.rmsnorm`` / ``models.layers.rmsnorm``,
    against jax.grad of the JAX model's rmsnorm."""
    x, scale = _inputs(shape, seed=7)
    dy = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    xj, dyj = jnp.asarray(x).astype(jdt), jnp.asarray(dy).astype(jdt)

    def j_loss(xj, s):
        y = j_rmsnorm({"scale": s}, xj)
        return jnp.sum(y.astype(jnp.float32) * dyj.astype(jnp.float32))

    dx_j, ds_j = jax.grad(j_loss, argnums=(0, 1))(xj, jnp.asarray(scale))
    for fn in (RMSNorm.apply, ops.rmsnorm,
               lambda x, s, eps: rmsnorm({"scale": s}, x, eps)):
        xt = torch.from_numpy(x).to(tdt).requires_grad_()
        st = torch.from_numpy(scale).requires_grad_()
        y = fn(xt, st, 1e-6)
        (y.float() * torch.from_numpy(dy).to(tdt).float()).sum().backward()
        assert xt.grad.dtype == tdt and st.grad.dtype == torch.float32
        np.testing.assert_allclose(xt.grad.float().numpy(),
                                   np.asarray(dx_j, np.float32), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(st.grad.numpy(), np.asarray(ds_j),
                                   rtol=1e-4, atol=1e-4)


def test_rmsnorm_backward_of_a_view_and_of_scale_only():
    """The model normalises strided views; a gradient asked for scale
    alone leaves x without one."""
    x, _ = _inputs((6, 128, 3), seed=9)
    _, scale = _inputs((1, 128), seed=10)
    xt = torch.from_numpy(x).transpose(1, 2)
    st = torch.from_numpy(scale).requires_grad_()
    RMSNorm.apply(xt, st, 1e-6).sum().backward()
    st_ref = st.detach().clone().requires_grad_()
    rmsnorm_ref(xt, st_ref).sum().backward()
    np.testing.assert_allclose(st.grad.numpy(), st_ref.grad.numpy(),
                               rtol=1e-5, atol=1e-5)
