"""The port's flash attention backward on the CPU (``flash_bwd_plain`` and
the ``FlashAttention`` autograd Function, whose backward on a CPU tensor
is the plain version) against the JAX package's Pallas ``flash_bwd`` in
interpret mode, ``jax.grad`` through its ``flash_attention`` and torch
autograd through the oracle, on the same numpy inputs.  The CUDA kernels
against their plain version are in tests/test_torch_gpu.py.

Tolerances.  f32: 2e-4 relative / 2e-5 absolute, tighter than the JAX
gradient test's 2e-3 / 2e-4 (tests/test_flash_attention.py:68): both
sides sum the same f32 products in another order (~1e-6 measured).
bf16 from the same saved o and lse: 1e-2 / 1e-3, one bf16 ulp (both
widen the same bf16 inputs, compute in f32 and round dq, dk, dv once).
bf16 gradients through each package's own forward: the JAX bf16 bound
3e-2 (the Pallas forward rounds p to bf16 before PV, so o, lse and
delta differ by a bf16 rounding).  The plain backward with p and ds
rounded to bf16 in the dk and dv products (what the tensor-core dkv
kernel computes, ROADMAP C5): within the derived bound that holds that
kernel on the card, and within the JAX bf16 bound of the Pallas kernels;
the same for dq with ds rounded to bf16 (``round_dq``, what the
tensor-core dq kernel computes, ROADMAP C7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import flash_bwd as j_flash_bwd
from repro.kernels.flash_attention import flash_fwd as j_flash_fwd
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (TMA_ALIGN, FlashAttention,
                                                 _tma_ready,
                                                 flash_attention,
                                                 flash_bwd_cuda,
                                                 flash_bwd_plain,
                                                 flash_delta)
from repro_torch.kernels.ref import (JAX_BF16_TOL, flash_attention_ref,
                                     flash_dkv_bf16_tolerance,
                                     flash_dq_bf16_tolerance)

# (BH, S, T, hd, hdv): the JAX gradient tests' shapes (hd != hdv as in
# test_grads_mla_vdim) and a three-block causal case
SHAPES = [(2, 128, 128, 32, 32), (2, 64, 64, 48, 32), (3, 64, 64, 16, 8),
          (1, 192, 192, 32, 16)]


def _inputs(BH, S, T, hd, hdv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BH, S, hd)).astype(np.float32),
            rng.standard_normal((BH, T, hd)).astype(np.float32),
            rng.standard_normal((BH, T, hdv)).astype(np.float32),
            rng.standard_normal((BH, S, hdv)).astype(np.float32))


def _j(*arrs, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrs]


def _t(*arrs, dtype=torch.float32):
    return [torch.from_numpy(np.array(a, np.float32)).to(dtype)
            for a in arrs]


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_bwd_plain_matches_pallas(causal, shape):
    """dq, dk, dv from the JAX forward's o and lse, the JAX kernels at
    32-row blocks (several blocks, causal skipping) vs the plain
    version; ``ops.flash_bwd`` on CPU tensors runs the plain version."""
    q, k, v, do = _inputs(*shape)
    jq, jk, jv, jdo = _j(q, k, v, do)
    o, lse = j_flash_fwd(jq, jk, jv, causal=causal, bq=32, bk=32,
                         interpret=True)
    want = j_flash_bwd(jq, jk, jv, o, lse, jdo, causal=causal, bq=32,
                       bk=32, interpret=True)
    tq, tk, tv, tdo, to, tlse = _t(q, k, v, do, o, lse)
    before = (flash_bwd_cuda.launches_dq, flash_bwd_cuda.launches_dkv)
    got = ops.flash_bwd(tq, tk, tv, tdo, tlse, flash_delta(to, tdo),
                        causal=causal)
    assert (flash_bwd_cuda.launches_dq,
            flash_bwd_cuda.launches_dkv) == before
    for name, a, b, ref in zip(("dq", "dk", "dv"), got, want, (tq, tk, tv)):
        assert a.shape == ref.shape and a.dtype == torch.float32
        _close(a, b, 2e-4, 2e-5, name)


def test_flash_bwd_plain_bf16_matches_pallas():
    q, k, v, do = _inputs(2, 128, 128, 32, 32, seed=1)
    jq, jk, jv, jdo = _j(q, k, v, do, dtype=jnp.bfloat16)
    o, lse = j_flash_fwd(jq, jk, jv, causal=True, bq=64, bk=64,
                         interpret=True)
    want = j_flash_bwd(jq, jk, jv, o, lse, jdo, causal=True, bq=64, bk=64,
                       interpret=True)
    # both packages round the f32 inputs to bf16 to nearest even
    tq, tk, tv, tdo, to = _t(q, k, v, do, o, dtype=torch.bfloat16)
    tlse = torch.from_numpy(np.array(lse))
    got = flash_bwd_plain(tq, tk, tv, tdo, tlse, flash_delta(to, tdo))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        _close(a, b, 1e-2, 1e-3, name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_function_grads_match_jax_grad(causal, shape):
    """Gradients of sum(o * do) through the port's Function against
    jax.grad through the JAX custom_vjp (Pallas forward and backward in
    interpret mode) and against torch autograd through the oracle."""
    q, k, v, do = _inputs(*shape, seed=2)

    def j_loss(q, k, v):
        return jnp.sum(j_flash(q, k, v, causal, None, 32, 32, True)
                       * jnp.asarray(do))

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*_j(q, k, v))
    grads = []
    for fn in (flash_attention, flash_attention_ref):
        leaves = [t.requires_grad_() for t in _t(q, k, v)]
        (fn(*leaves, causal=causal) * torch.from_numpy(do)).sum().backward()
        grads.append([t.grad for t in leaves])
    for name, a, b, c in zip("qkv", grads[0], grads[1], want):
        _close(a, c, 2e-4, 2e-5, f"d{name} vs jax.grad")
        _close(a, b.numpy(), 2e-4, 2e-5, f"d{name} vs oracle autograd")


def test_function_grads_bf16_match_jax_grad():
    q, k, v, do = _inputs(2, 128, 128, 32, 32, seed=3)
    jq, jk, jv = _j(q, k, v, dtype=jnp.bfloat16)
    jdo = jnp.asarray(do).astype(jnp.bfloat16)

    def j_loss(q, k, v):
        o = j_flash(q, k, v, True, None, 64, 64, True)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32))

    want = jax.grad(j_loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).requires_grad_() for a in (jq, jk, jv)]
    tdo = torch.from_numpy(np.asarray(jdo, np.float32))
    (flash_attention(*leaves).float() * tdo).sum().backward()
    for name, t, b in zip("qkv", leaves, want):
        assert t.grad.dtype == torch.bfloat16
        _close(t.grad, b, 3e-2, 3e-2, f"d{name}")


def test_lse_is_returned_and_not_differentiable():
    q, k, v, _ = _inputs(1, 64, 64, 16, 16, seed=4)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    o, lse = FlashAttention.apply(tq, tk, tv, True, None)
    assert o.requires_grad and not lse.requires_grad
    o_ref, lse_ref = flash_attention_ref(tq, tk, tv, True, with_lse=True)
    _close(lse.detach(), lse_ref.detach().numpy(), 2e-4, 2e-5)


def test_bad_backward_operands_are_refused():
    q, k, v, do = _t(*_inputs(1, 64, 64, 32, 32, seed=5))
    lse = torch.zeros((1, 64))
    with pytest.raises(ValueError, match="do"):
        flash_bwd_plain(q, k, v, do[:, :32], lse, lse)
    with pytest.raises(ValueError, match="lse"):
        flash_bwd_plain(q, k, v, do, lse.double(), lse)
    with pytest.raises(ValueError, match="delta"):
        flash_bwd_plain(q, k, v, do, lse, lse[:, :8])
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_bwd_cuda(q, k, v, do, lse, lse)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 256, 256, 128, 128),
                                   (2, 100, 40, 64, 64),
                                   (2, 40, 100, 128, 128)])
def test_dkv_round_p_within_derived_bf16_bound(causal, shape):
    """dk and dv with p and ds rounded to bf16 stay within the derived
    bound against the f32 plain version, which is no looser than the JAX
    bf16 bound; dq is the f32 one on both."""
    q, k, v, do = _t(*_inputs(*shape, seed=8), dtype=torch.bfloat16)
    o, lse = flash_attention_ref(q, k, v, causal, with_lse=True)
    delta = flash_delta(o, do)
    dq, dk, dv = flash_bwd_plain(q, k, v, do, lse, delta, causal)
    dq_r, dk_r, dv_r = flash_bwd_plain(q, k, v, do, lse, delta, causal,
                                       round_p=True)
    assert torch.equal(dq_r, dq)
    tols = flash_dkv_bf16_tolerance(q, k, v, do, lse, delta, dk, dv, causal)
    for name, a, b, tol in (("dk", dk_r, dk, tols[0]),
                            ("dv", dv_r, dv, tols[1])):
        assert bool(((a.float() - b.float()).abs() <= tol).all()), name
        assert bool((tol <= JAX_BF16_TOL * (1 + b.float().abs())).all())


def test_dkv_round_p_matches_pallas_bf16():
    """The bf16-p/ds plain dk and dv against the Pallas backward in
    interpret mode on the same bf16 inputs, o and lse: the JAX bound."""
    q, k, v, do = _inputs(2, 128, 128, 64, 64, seed=9)
    jq, jk, jv, jdo = _j(q, k, v, do, dtype=jnp.bfloat16)
    o, lse = j_flash_fwd(jq, jk, jv, causal=True, bq=64, bk=64,
                         interpret=True)
    want = j_flash_bwd(jq, jk, jv, o, lse, jdo, causal=True, bq=64, bk=64,
                       interpret=True)
    tq, tk, tv, tdo, to = _t(q, k, v, do, o, dtype=torch.bfloat16)
    got = flash_bwd_plain(tq, tk, tv, tdo, torch.from_numpy(np.array(lse)),
                          flash_delta(to, tdo), round_p=True)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, JAX_BF16_TOL, JAX_BF16_TOL, name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 256, 256, 128, 128),
                                   (2, 100, 40, 64, 64),
                                   (2, 40, 100, 128, 128)])
def test_dq_round_dq_within_derived_bf16_bound(causal, shape):
    """dq with ds rounded to bf16 stays within the derived bound against
    the f32-ds plain version, which is no looser than the JAX bf16 bound;
    dk and dv do not move."""
    q, k, v, do = _t(*_inputs(*shape, seed=10), dtype=torch.bfloat16)
    o, lse = flash_attention_ref(q, k, v, causal, with_lse=True)
    delta = flash_delta(o, do)
    dq, dk, dv = flash_bwd_plain(q, k, v, do, lse, delta, causal)
    dq_r, dk_r, dv_r = flash_bwd_plain(q, k, v, do, lse, delta, causal,
                                       round_dq=True)
    assert torch.equal(dk_r, dk) and torch.equal(dv_r, dv)
    assert not torch.equal(dq_r, dq)
    tol = flash_dq_bf16_tolerance(q, k, v, do, lse, delta, dq, causal)
    assert bool(((dq_r.float() - dq.float()).abs() <= tol).all())
    assert bool((tol <= JAX_BF16_TOL * (1 + dq.float().abs())).all())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 128, 128, 128, 128),
                                   (2, 17, 17, 128, 128),
                                   (2, 100, 40, 64, 64)])
def test_dq_bound_covers_another_order_of_the_score_sums(causal, shape):
    """The tensor-core dq sums q k^T and do v^T in another order than the
    plain version, and at the first causal rows ds is a cancellation
    residue of dp - delta: a dq that takes s and dp from f64 sums rounded
    to f32, exp2 of the log2-domain argument and ds rounded to bf16 (what
    the kernel computes, in another order) stays within the derived bound,
    whose score-sum term that residue needs."""
    q, k, v, do = _t(*_inputs(*shape, seed=13), dtype=torch.bfloat16)
    BH, S, T, hd, _ = shape
    scale, log2e = hd ** -0.5, 1.4426950408889634
    o, lse = flash_attention_ref(q, k, v, causal, with_lse=True)
    delta = flash_delta(o, do)
    dq = flash_bwd_plain(q, k, v, do, lse, delta, causal)[0]
    s = torch.einsum("bqd,bkd->bqk", q.double(), k.double()).float()
    dp = torch.einsum("bqd,bkd->bqk", do.double(), v.double()).float()
    p = torch.exp2(s * (scale * log2e) - lse[..., None] * log2e)
    if causal:
        p = p * torch.ones(S, T).tril()
    ds = (p * (dp - delta[..., None]) * scale).to(torch.bfloat16)
    dq_other = torch.einsum("bqk,bkd->bqd", ds.double(),
                            k.double()).to(torch.bfloat16)
    tol = flash_dq_bf16_tolerance(q, k, v, do, lse, delta, dq, causal)
    assert bool(((dq_other.float() - dq.float()).abs() <= tol).all())


def test_dq_round_dq_matches_pallas_bf16():
    """The bf16-ds plain dq (with the bf16 p and ds of the tensor-core dkv)
    against the Pallas backward in interpret mode on the same bf16 inputs,
    o and lse: the JAX bound."""
    q, k, v, do = _inputs(2, 128, 128, 64, 64, seed=11)
    jq, jk, jv, jdo = _j(q, k, v, do, dtype=jnp.bfloat16)
    o, lse = j_flash_fwd(jq, jk, jv, causal=True, bq=64, bk=64,
                         interpret=True)
    want = j_flash_bwd(jq, jk, jv, o, lse, jdo, causal=True, bq=64, bk=64,
                       interpret=True)
    tq, tk, tv, tdo, to = _t(q, k, v, do, o, dtype=torch.bfloat16)
    got = flash_bwd_plain(tq, tk, tv, tdo, torch.from_numpy(np.array(lse)),
                          flash_delta(to, tdo), round_p=True, round_dq=True)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, JAX_BF16_TOL, JAX_BF16_TOL, name)


@pytest.mark.parametrize("offset", [0, 1, 8])
def test_tma_ready_copies_only_an_unaligned_operand(offset):
    """A contiguous bf16 view that starts ``offset`` elements into a buffer
    comes back as a fresh aligned tensor with the same values when it is
    off a TMA boundary, and as itself when it is on one."""
    flat = torch.arange(2 * 64 * 64 + offset, dtype=torch.float32).to(
        torch.bfloat16)
    assert flat.data_ptr() % TMA_ALIGN == 0
    view = flat[offset:].view(2, 64, 64)
    got = _tma_ready(view)
    assert got.data_ptr() % TMA_ALIGN == 0 and torch.equal(got, view)
    if view.data_ptr() % TMA_ALIGN:
        assert got.data_ptr() != view.data_ptr()
    else:
        assert got is view


def test_function_takes_an_unaligned_bf16_view():
    """The Function's tensor-core route (bf16, hd = hdv = 64) takes a view
    that starts 2 bytes into its buffer, and gives the same bits forward and
    backward as an aligned copy (on the CPU through the plain versions)."""
    q, k, v, do = _t(*_inputs(1, 64, 64, 64, 64, seed=12),
                     dtype=torch.bfloat16)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype)
    q_off = flat[1:].view(q.shape)
    q_off.copy_(q)
    outs = []
    for qq in (q_off, q.clone()):
        leaves = [qq.detach().requires_grad_(), k.clone().requires_grad_(),
                  v.clone().requires_grad_()]
        assert leaves[0].data_ptr() == qq.data_ptr()
        o = flash_attention(*leaves)
        o.backward(do)
        outs.append([o.detach()] + [t.grad for t in leaves])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
